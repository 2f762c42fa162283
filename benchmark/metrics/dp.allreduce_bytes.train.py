"""The bytes the data-parallel all_reduces reduce a train step on rank 0:
what the program's `dp.allreduce_bytes` counter counted inside each
`train.step`, mean over the traced steps.

None where the program keeps no such record (a program without the
counter, or a window that ran none)."""


def read(t):
    try:
        from relightable3dgaussian_tpu_torch.utils import trace
    except ImportError:
        return None
    value = trace.unit_mean_count("train.step", "dp.allreduce_bytes")
    return value or None
