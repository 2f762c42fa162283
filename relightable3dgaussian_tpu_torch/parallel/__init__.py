"""Multi-GPU training and evaluation over torch.distributed: camera-batch
data parallelism (`data_parallel`) and the point- and ray-sharded stage-2
eval shading and visibility trace (`point_sharded`). The JAX package's
`make_mesh` is `make_group` here, with `spawn` to start one process a
rank, or `PeerRanks` to start ranks 1..N-1 beside a caller that is rank
0."""
from .data_parallel import (PeerRanks, check_replicas,  # noqa: F401
                            combine_stat_contribs, make_dp_train_step,
                            make_dp_train_step_stage2, make_group, replicate,
                            shard_views, spawn)
