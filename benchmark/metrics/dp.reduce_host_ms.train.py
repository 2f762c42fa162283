"""The data-parallel combination's host time a train step on rank 0: the
whole of the program's `dp.reduce` span
(`parallel/data_parallel.py::reduce_step`: the statistics' sums and the
gradients' mean; under NCCL each collective's wait blocks the host, so
the span holds the wait for the slowest rank), mean over the traced
steps.

None where the program keeps no such record (a program without the
span, or a window that ran none)."""


def read(t):
    try:
        from relightable3dgaussian_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.unit_mean_ms("train.step", "dp.reduce", own=False)
