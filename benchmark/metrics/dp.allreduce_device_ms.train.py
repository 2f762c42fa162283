"""The data-parallel all_reduce's device time a train step on rank 0: the
NCCL kernels by name (`nccl`), mean over the traced steps. An NCCL
kernel runs from its launch until every rank's part has arrived, so it
holds the wait for the slowest rank's launch besides the exchange."""


def read(t):
    if t.kind != "train" or not t.units:
        return None
    s = t.device_s_matching("nccl")
    return 1e3 * s / t.units if s > 0 else None
