"""The train step from its forward mark to its end (backward, Adam and the
densification statistics), StepTimer's CUDA events, mean over the traced
steps."""


def read(t):
    if not t.step_split:
        return None
    return sum(s["backward"] + s["optimizer"]
               for s in t.step_split) / len(t.step_split)
