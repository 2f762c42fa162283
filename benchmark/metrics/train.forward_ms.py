"""The train step's forward (render and loss), StepTimer's CUDA events from
its start to its forward mark, mean over the traced steps."""


def read(t):
    if not t.step_split:
        return None
    return sum(s["forward"] for s in t.step_split) / len(t.step_split)
