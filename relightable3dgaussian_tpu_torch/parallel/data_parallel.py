"""Multi-GPU training: camera-batch data parallelism over torch.distributed
(port of relightable3dgaussian_tpu/parallel/data_parallel.py).

The reference is single-GPU, one camera a step (train.py:115-119). Here, as
in the JAX package, the scaling axis is a batch of cameras, one a rank:
every rank holds the whole model, renders and differentiates its own view,
and the ranks combine what they computed. The combination is the JAX
package's:
  * each view's densification contributions are taken BEFORE the
    gradients are averaged (the reference accumulates per-view gradient
    norms, not the norm of summed gradients); blend weights, gradient norms
    and visibility counts are summed over the ranks, screen radii take the
    max, exactly as consecutive single-rank steps accumulate them;
  * gradients (and in stage 2 the env map's) are averaged over the ranks,
    so one rank is the single-camera step, and every rank takes the same
    Adam step from the same sums: the replicas stay bitwise equal;
  * the loss terms are averaged over the ranks.

A group is one process a rank over an explicit device list (`make_group`;
`spawn` starts the processes). Its backend follows the device layout and is
printed: NCCL where every rank has a card of its own, gloo on the CPU or
where ranks share a card (NCCL refuses two ranks on one GPU; gloo's
all_reduce and broadcast take CUDA tensors). Under NCCL the rank's card is
bound when the group starts (`device_id`), so its communicator is made
there, with every rank present, and not at the first collective: a
communicator made lazily waits for a missing rank with no timeout. Group
set-up and every collective have a timeout (COLLECTIVE_TIMEOUT_S unless the
caller gives one; under NCCL a collective's wait blocks the host,
TORCH_NCCL_BLOCKING_WAIT), and a rank that fails or ends makes `spawn`
(or `PeerRanks`) fail at once; a rank that stays alive but never reaches
the first collective is bounded by their `timeout_s` alone under NCCL.
Every operand of a collective lies on
the rank's own device, is contiguous and of a type NCCL reduces
(`NCCL_DTYPES`; checked under NCCL). A group of one rank starts no process
group and runs no collective, so one rank reduces to
`train.stage1.train_step` / `train.stage2.train_step` exactly.
The JAX package's seeded-weights path (a TPU scatter workaround) is not
ported: the weights come from the forward.
"""
from __future__ import annotations

import _thread
import dataclasses
import datetime
import hashlib
import multiprocessing
import os
import queue as queue_lib
import socket
import sys
import threading
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from ..models import gaussians as G
from ..models.render import ViewInputs
from ..ops.config import RasterConfig
from ..train import stage1, stage2
from ..train.config import OptimizationConfig
from ..utils import trace

# Seconds a rank waits in group set-up or in one collective before it fails
# (spawn's default, read when it is called).
COLLECTIVE_TIMEOUT_S = 1800.0
# The element types NCCL reduces and broadcasts (no bool).
NCCL_DTYPES = (torch.uint8, torch.int8, torch.int32, torch.int64,
               torch.float16, torch.bfloat16, torch.float32, torch.float64)


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place in a group of ranks: the device of every rank
    (one entry a rank; a device may repeat), this rank, and the collective
    backend (None for a group of one rank, which runs no collective)."""
    devices: tuple[torch.device, ...]
    rank: int
    backend: str | None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", 0)
    return d


def choose_backend(devices: Sequence[torch.device | str]) -> str:
    """NCCL where every rank has a card of its own; gloo on the CPU or where
    ranks share a card."""
    devices = [_device(d) for d in devices]
    types = {d.type for d in devices}
    if types == {"cuda"} and len(set(devices)) == len(devices):
        return "nccl"
    if types in ({"cuda"}, {"cpu"}):
        return "gloo"
    raise ValueError(f"ranks on {sorted(map(str, devices))}: expected all on "
                     "the CPU or all on CUDA devices")


def make_group(devices: Sequence[torch.device | str], rank: int = 0,
               init_method: str | None = None,
               timeout_s: float = COLLECTIVE_TIMEOUT_S) -> Group:
    """Join the group of ranks over `devices` as `rank` (`init_method`:
    the rendezvous address, `tcp://127.0.0.1:<port>`). A group of one rank
    starts no process group. This rank's card becomes the current one."""
    devices = tuple(_device(d) for d in devices)
    if not 0 <= rank < len(devices):
        raise ValueError(f"rank {rank} of {len(devices)} devices")
    if devices[rank].type == "cuda":
        torch.cuda.set_device(devices[rank])
    elif len(devices) > 1:
        # Ranks on the CPU share its cores: each takes its share of threads
        # (as torchrun does), or their thread pools contend for every core.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
    if len(devices) == 1:
        return Group(devices, 0, None)
    backend = choose_backend(devices)
    if backend == "nccl":
        # A collective's wait blocks the host and raises past the timeout
        # (torch's ProcessGroupNCCL). It does not end a rank whose peer
        # never reaches the group's first collective: on four NVIDIA H100
        # 80GB HBM3 at 700 W (torch 2.11, NCCL 2.28) such a rank still
        # waited 100 s past a 10 s timeout, with or without this; spawn's
        # timeout_s bounds it.
        os.environ.setdefault("TORCH_NCCL_BLOCKING_WAIT", "1")
    dist.init_process_group(
        backend, init_method=init_method, world_size=len(devices), rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=devices[rank] if backend == "nccl" else None)
    if rank == 0:
        print(f"[parallel] {len(devices)} ranks on "
              f"{', '.join(map(str, devices))}: {backend} backend",
              flush=True)
    return Group(devices, rank, backend)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, devices, rank, init_method, timeout_s, results, args):
    """A spawned rank: join the group, run fn(group, *args), report."""
    try:
        group = make_group(devices, rank, init_method, timeout_s)
        value = fn(group, *args)
        results.put((rank, True, value))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, devices: Sequence[torch.device | str], *args,
          timeout_s: float | None = None,
          collective_timeout_s: float | None = None) -> list:
    """Run `fn(group, *args)` on one new process a device entry (started by
    the spawn method, so no CUDA state is forked) and return each rank's
    result, rank 0 first. `fn`, `args` and the results are pickled: `fn`
    must be a module-level function. Where a rank raises or dies, or the
    ranks are not done within `timeout_s` (None: no limit; each collective
    still has `collective_timeout_s`, None: COLLECTIVE_TIMEOUT_S), the other
    ranks are terminated and RuntimeError (TimeoutError) is raised with the
    failed rank's traceback."""
    if collective_timeout_s is None:
        collective_timeout_s = COLLECTIVE_TIMEOUT_S
    devices = [_device(d) for d in devices]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}", args=(
        fn, devices, r, init_method, collective_timeout_s, results, args))
        for r in range(len(devices))]
    for p in procs:
        p.start()
    done: dict[int, Any] = {}
    failed: dict[int, str] = {}
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while len(done) < len(procs) and not failed:
            try:
                rank, ok, value = results.get(timeout=0.2)
                (done if ok else failed)[rank] = value
                continue
            except queue_lib.Empty:
                pass
            for r, p in enumerate(procs):
                if p.exitcode not in (None, 0) and r not in failed:
                    failed[r] = f"rank {r} exited with code {p.exitcode}"
            if all(p.exitcode is not None for p in procs) and not failed:
                try:        # results still in the pipe after the exits
                    rank, ok, value = results.get(timeout=5.0)
                    (done if ok else failed)[rank] = value
                except queue_lib.Empty:
                    missing = sorted(set(range(len(procs))) - set(done))
                    failed[missing[0]] = (f"ranks {missing} exited without "
                                          "a result")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{len(procs)} ranks of {fn.__name__} not "
                                   f"done within {timeout_s} s")
    finally:
        for p in procs:
            if p.is_alive() and (failed or len(done) < len(procs)):
                p.terminate()
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
    if failed:
        rank = min(failed)
        raise RuntimeError(f"rank {rank} of {len(procs)} failed:\n"
                           f"{failed[rank]}")
    return [done[r] for r in range(len(procs))]


# Seconds the caller, as rank 0 of `PeerRanks`, has to leave its work once a
# peer has failed or the deadline has passed, before its process ends.
PEER_GRACE_S = 10.0


class PeerRanks:
    """Ranks 1..N-1 of a group over `devices` started beside the caller,
    which joins it as rank 0 in its own process (so that what it measures
    of its card, and its profiler, see rank 0's work):

        peers = PeerRanks(fn, devices, *args, timeout_s=600)
        with peers as group:
            ...                   # rank 0's part (fn(group, *args) there)
        peers.results             # the results of ranks 1..N-1, in order

    Each peer runs fn(group, *args) as `spawn`'s ranks do (a new process
    by the spawn method; fn, args and results pickled). A watchdog thread
    follows the peers; where one fails or dies, or the deadline passes
    (`timeout_s` from the start; None: none while the caller is inside
    the block), it terminates them and interrupts the caller
    (KeyboardInterrupt in the main thread, which leaving the block turns
    into RuntimeError, or TimeoutError, with the failed rank's
    traceback). A caller blocked where no interrupt reaches it (group
    set-up, a collective's wait) is given PEER_GRACE_S more; then the
    error is printed to standard error and the process ends with exit
    code 1. Collectives time out after `collective_timeout_s` (None:
    `timeout_s`, else COLLECTIVE_TIMEOUT_S). On leaving without an error,
    the caller waits for every peer's result, within the deadline (None:
    `collective_timeout_s` from then); the group is then destroyed, and
    the caller's thread count is given back. The peers are daemonic: they
    end with the caller's process."""

    def __init__(self, fn: Callable, devices: Sequence[torch.device | str],
                 *args, timeout_s: float | None,
                 collective_timeout_s: float | None = None,
                 grace_s: float = PEER_GRACE_S):
        self.fn, self.args = fn, args
        self.devices = [_device(d) for d in devices]
        self.timeout_s, self.grace_s = timeout_s, grace_s
        self.collective_timeout_s = (
            collective_timeout_s if collective_timeout_s is not None
            else timeout_s if timeout_s is not None else COLLECTIVE_TIMEOUT_S)
        self.results: list = []
        self._error: BaseException | None = None
        self._lock = threading.Lock()
        self._inside = self._ending = False
        self._left = threading.Event()
        self._stop = threading.Event()

    def __enter__(self) -> Group:
        ctx = multiprocessing.get_context("spawn")
        self._queue = ctx.Queue()
        init_method = f"tcp://127.0.0.1:{_free_port()}"
        n = len(self.devices)
        self._procs = {r: ctx.Process(
            target=_rank_main, name=f"rank{r}", daemon=True, args=(
                self.fn, self.devices, r, init_method,
                self.collective_timeout_s, self._queue, self.args))
            for r in range(1, n)}
        self._done: dict[int, Any] = {}
        self._deadline = (None if self.timeout_s is None
                          else time.monotonic() + self.timeout_s)
        # make_group gives a rank on the CPU its share of the threads:
        # given back on leaving
        self._threads = torch.get_num_threads()
        for p in self._procs.values():
            p.start()
        self._inside = True
        self._watchdog = threading.Thread(target=self._watch, daemon=True,
                                          name="peer-ranks-watchdog")
        self._watchdog.start()
        try:
            return make_group(self.devices, 0, init_method,
                              self.collective_timeout_s)
        except BaseException as e:
            self.__exit__(type(e), e, e.__traceback__)
            raise

    def _fail(self, error: BaseException) -> None:
        """Record the first error, end the peers and interrupt the caller
        (where it is still inside the block)."""
        with self._lock:
            if self._error is not None:
                return
            self._error = error
            self._terminate()
            if self._inside:
                _thread.interrupt_main()

    def _terminate(self) -> None:
        self._ending = True
        for p in self._procs.values():
            if p.is_alive():
                p.terminate()

    def _watch(self) -> None:
        """Gather the peers' results and follow their exits until they are
        all in or ended; `_fail` on a failure, or where the deadline passes
        before the caller is done; after a failure, wait `grace_s` for the
        caller to leave the block before ending the process."""
        n = len(self._procs)
        while self._error is None and not self._stop.is_set():
            if self._ending or len(self._done) == n:
                self._stop.wait(0.2)
            else:
                try:
                    rank, ok, value = self._queue.get(timeout=0.2)
                    if ok:
                        self._done[rank] = value
                    else:
                        self._fail(RuntimeError(
                            f"rank {rank} of {n + 1} failed:\n{value}"))
                    continue
                except queue_lib.Empty:
                    pass
                for r, p in self._procs.items():
                    if self._ending:           # the caller ended them
                        break
                    if p.exitcode not in (None, 0) and r not in self._done:
                        self._fail(RuntimeError(f"rank {r} of {n + 1} exited "
                                                f"with code {p.exitcode}"))
                        break
            deadline = self._deadline
            if self._error is None and deadline is not None and \
                    time.monotonic() > deadline:
                self._fail(TimeoutError(
                    f"{n + 1} ranks of {self.fn.__name__} not done within "
                    f"{self.timeout_s or self.collective_timeout_s} s"))
        if self._error is not None and not self._left.wait(self.grace_s):
            print(f"[parallel] rank 0 did not leave its work within "
                  f"{self.grace_s} s of: {self._error}", file=sys.stderr,
                  flush=True)
            os._exit(1)

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            with self._lock:
                self._inside = False
                if exc_type is not None and self._error is None:
                    self._terminate()       # rank 0 failed: end the peers
                if self._deadline is None:
                    self._deadline = (time.monotonic()
                                      + self.collective_timeout_s)
            while self._error is None and not self._ending and \
                    len(self._done) < len(self._procs):
                time.sleep(0.05)
            if self._error is None and not self._ending:
                self.results = [self._done[r] for r in sorted(self._done)]
        except KeyboardInterrupt:
            if self._error is None:
                raise
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            left = (self._deadline or 0.0) - time.monotonic()
            for p in self._procs.values():    # the peers leave their groups
                p.join(max(0.0, min(30.0, left)))
            self._terminate()
            for p in self._procs.values():
                p.join(30)
                if p.is_alive():
                    p.kill()
                    p.join(5)
            self._stop.set()
            self._left.set()
            self._watchdog.join(5)
            self._queue.close()
            torch.set_num_threads(self._threads)
        if self._error is not None:
            raise self._error from (exc if exc_type is not KeyboardInterrupt
                                    else None)
        return False


# ---------------------------------------------------------------------------
# collectives (none for a group of one rank)
# ---------------------------------------------------------------------------

def _check_operand(tensor: torch.Tensor, group: Group) -> None:
    """Under NCCL, raise unless `tensor` is a contiguous tensor of a type
    NCCL takes on this rank's card (NCCL would fail or hang on it)."""
    if group.backend == "nccl" and (
            tensor.device != group.device or not tensor.is_contiguous()
            or tensor.dtype not in NCCL_DTYPES):
        raise ValueError(
            f"rank {group.rank} on {group.device}: a {tensor.dtype} operand "
            f"on {tensor.device} (contiguous: {tensor.is_contiguous()}); "
            "NCCL takes contiguous tensors of NCCL_DTYPES on the rank's card")


def all_reduce_(tensor: torch.Tensor, group: Group | None,
                op: str = "sum") -> torch.Tensor:
    """In place over the ranks of `group` ("sum" or "max")."""
    if group is not None and group.size > 1:
        _check_operand(tensor, group)
        trace.count("dp.allreduce_bytes",
                    tensor.numel() * tensor.element_size())
        dist.all_reduce(tensor, op={"sum": dist.ReduceOp.SUM,
                                    "max": dist.ReduceOp.MAX}[op])
    return tensor


def mean_(tensors: Sequence[torch.Tensor], group: Group | None) -> None:
    """Average each tensor over the ranks, in place, in one collective."""
    if group is None or group.size == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, group).div_(group.size)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def broadcast_(tensors: Sequence[torch.Tensor], group: Group | None) -> None:
    """Rank 0's values of `tensors`, in place on every rank; every rank must
    hold tensors of rank 0's shapes (checked first)."""
    if group is None or group.size == 1:
        return
    shapes = [[tuple(t.shape) for t in tensors]]
    dist.broadcast_object_list(shapes, src=0)
    mine = [tuple(t.shape) for t in tensors]
    if shapes[0] != mine:
        raise ValueError(f"rank {group.rank} holds tensors of shapes {mine}, "
                         f"rank 0 of {shapes[0]}")
    for t in tensors:
        # NCCL moves only CUDA tensors: Adam's step counts live on the CPU.
        buf = t.to(group.device).contiguous()
        _check_operand(buf, group)
        dist.broadcast(buf, src=0)
        if buf is not t:
            t.copy_(buf)


def combine_stat_contribs(contribs: G.StatContribs,
                          group: Group | None) -> G.StatContribs:
    """Sum the weights, gradient norms and visibility counts over the ranks
    and take the max of the radii."""
    if group is None or group.size == 1:
        return contribs
    sums = torch.stack([contribs.weights, contribs.xyz_grad_norm,
                        contribs.normal_grad_norm, contribs.denom])
    all_reduce_(sums, group)
    return G.StatContribs(weights=sums[0], xyz_grad_norm=sums[1],
                          normal_grad_norm=sums[2], denom=sums[3],
                          radii=all_reduce_(contribs.radii.clone(), group,
                                            "max"))


def mean_metrics(metrics: dict[str, Any], group: Group | None) -> dict:
    """The metrics' tensors averaged over the ranks (one collective)."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    if group is None or group.size == 1 or not keys:
        return metrics
    # A metric may live on the CPU (a host-side count); NCCL reduces only
    # on the card.
    values = torch.stack([metrics[k].detach().float().reshape(()).to(
        group.device) for k in keys])
    all_reduce_(values, group).div_(group.size)
    return {**metrics, **dict(zip(keys, values.unbind()))}


def reduce_step(group: Group | None, grads: Sequence[torch.Tensor],
                contribs: G.StatContribs) -> G.StatContribs:
    """The combination between a rank's backward and its optimizer step:
    the per-view stat contributions combined, then `grads` averaged in
    place. Returns the combined contributions. Span `dp.reduce`: under
    NCCL each collective's wait blocks the host, so the span holds the
    wait for the slowest rank."""
    with trace.span("dp.reduce"):
        contribs = combine_stat_contribs(contribs, group)
        mean_(grads, group)
        return contribs


# ---------------------------------------------------------------------------
# replicas and camera batches
# ---------------------------------------------------------------------------

def replica_tensors(model: G.GaussianModel,
                    optimizer: torch.optim.Optimizer | None = None, env=None,
                    env_optimizer: torch.optim.Optimizer | None = None
                    ) -> list[torch.Tensor]:
    """A replica's state: the model's parameters and densification
    statistics, the env map and each optimizer's state tensors."""
    tensors = [getattr(model, k).data for k in model.fields]
    tensors += [getattr(model, k) for k in G.STATS]
    if env is not None:
        tensors.append(env.env.data)
    for opt in (optimizer, env_optimizer):
        if opt is None:
            continue
        for group_params in opt.param_groups:
            for p in group_params["params"]:
                state = opt.state.get(p, {})
                tensors += [state[k] for k in sorted(state)
                            if isinstance(state[k], torch.Tensor)]
    return tensors


def replicate(group: Group | None, model: G.GaussianModel,
              optimizer: torch.optim.Optimizer | None = None, env=None,
              env_optimizer: torch.optim.Optimizer | None = None) -> None:
    """Rank 0's replica (`replica_tensors`), in place on every rank."""
    broadcast_(replica_tensors(model, optimizer, env, env_optimizer), group)


def replica_digest(*replica) -> str:
    """sha256 of the bytes of `replica_tensors(*replica)`."""
    h = hashlib.sha256()
    for t in replica_tensors(*replica):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def check_replicas(group: Group | None, *replica) -> list[str]:
    """Every rank's `replica_digest(*replica)`, rank 0 first; RuntimeError
    where one differs from rank 0's (the replicas must stay bitwise
    equal)."""
    digest = replica_digest(*replica)
    if group is None or group.size == 1:
        return [digest]
    digests: list[Any] = [None] * group.size
    dist.all_gather_object(digests, digest)
    apart = [r for r, d in enumerate(digests) if d != digests[0]]
    if apart:
        raise RuntimeError(f"replicas of ranks {apart} apart from rank 0's")
    return digests


def shard_views(views: Sequence[ViewInputs],
                group: Group | None) -> ViewInputs:
    """This rank's camera of a batch of `group.size` views."""
    size = 1 if group is None else group.size
    if len(views) != size:
        raise ValueError(f"a batch of {len(views)} views for {size} ranks")
    return views[0 if group is None else group.rank]


def make_dp_train_step(group: Group, *, cfg: RasterConfig,
                       opt: OptimizationConfig, spatial_lr_scale: float):
    """The data-parallel stage-1 step: step(model, optimizer, views,
    iteration, timer=None) → metrics, `views` one a rank (this rank renders
    `shard_views(views, group)`), the model and optimizer updated in
    place."""
    def step(model, optimizer, views, iteration, timer=None):
        return stage1.train_step(
            model, optimizer, shard_views(views, group), iteration, cfg=cfg,
            opt=opt, spatial_lr_scale=spatial_lr_scale, timer=timer,
            group=group)

    return step


def make_dp_train_step_stage2(group: Group, *, cfg: RasterConfig,
                              opt: OptimizationConfig,
                              spatial_lr_scale: float):
    """The data-parallel stage-2 step: step(model, optimizer, env,
    env_optimizer, vis, views, iteration, timer=None) → metrics, with the
    env map's gradients averaged as the model's."""
    def step(model, optimizer, env, env_optimizer, vis, views, iteration,
             timer=None):
        return stage2.train_step(
            model, optimizer, env, env_optimizer, vis,
            shard_views(views, group), iteration, cfg=cfg, opt=opt,
            spatial_lr_scale=spatial_lr_scale, timer=timer, group=group)

    return step
