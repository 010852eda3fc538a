"""Multi-process (one process per card) wiring of the trainers.

Counterpart of `avtubes/core/distributed.py` and of the job of
`avtubes/core/mesh.py`.  A JAX process with one chip is one rank here with
one card: `make_data_mesh`'s divisor rule becomes one device per rank,
`cuda:LOCAL_RANK`.  Parameters are replicated (each rank holds its own
copy, kept equal by averaging the gradients over the ranks after every
backward, `all_reduce_mean_`), each rank feeds its slice of the global
batch, BatchNorm statistics are the global batch's (`models/norm.py`) and
the global negative pool gathers the audio features of every rank
(`parallel/__init__.py`).

Activation is read from the environment, so a single-process run pays
nothing:

    torchrun --nproc_per_node N -m avtubes_torch.cli.train_hardway ...
        (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)
    AVTUBES_COORDINATOR=host0:1234 AVTUBES_NUM_PROCESSES=2 \\
    AVTUBES_PROCESS_ID=0 python -m avtubes_torch.cli.train_hardway ...
        (the JAX package's trio, as tcp://host0:1234)
    AVTUBES_DISTRIBUTED=1 with torchrun's variables (env://)

The backend follows the device asked for: NCCL for `cuda` (the rank's card
is `cuda:LOCAL_RANK`), gloo for `cpu`.  This is a mapping, not a fallback:
a CUDA run never takes gloo, and a CUDA run without a card raises.  Every
`init_process_group` takes an explicit timeout.

`host_local_state` has no counterpart: the parameters of a rank are local
tensors, which the primary evaluates and saves without a collective.

Two ways to split a batch over the ranks.  The flagship trainer's
`--batch_size` is per rank, as in the JAX package's multi-process path: each
rank reads `ids[rank::world]` (`data_shard`) and runs the agreed number of
steps (`agreed_steps_per_epoch`).  The 1-frame, 3D tube, consistency and
flow-pretrain trainers keep the JAX package's single-process data mesh
instead: `--batch_size` is the GLOBAL batch, which `make_data_mesh` shards in
contiguous blocks, so rank r holds rows `rows_of(B)` = [r·B/n, (r+1)·B/n) of
every global batch, read by the rows loader (`data/pipeline.py::BatchLoader`
with `rows=`), whose agreement on decode failures runs on a gloo group of its
own (`loader_all_gather`).  A world that does not divide B is refused
(`check_world_divides`): a process group cannot drop ranks as the mesh drops
devices.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from avtubes_torch.core.device import resolve_device

#: how long a collective may wait for the other ranks before the group
#: aborts (NCCL's watchdog, gloo's timeout)
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)
#: how long the other ranks wait at a `barrier` while the primary alone
#: evaluates or writes: a full evaluation can take longer than a collective
#: may, so this wait runs on a gloo group of its own (`monitored_barrier`)
BARRIER_TIMEOUT = datetime.timedelta(hours=2)

# the gloo group `barrier` waits on; created with the default group
_host_group: dist.ProcessGroup | None = None
# the gloo group of the rows loader's agreement (`loader_all_gather`), which
# runs on the loader's thread: never the group that the main thread's
# `barrier` or collectives use, so the two never interleave on one group
_loader_group: dist.ProcessGroup | None = None


def _announced() -> tuple[str, int, int, int] | None:
    """(init method, world size, rank, local rank) the environment asks
    for, or None for a single-process run."""
    coordinator = os.environ.get("AVTUBES_COORDINATOR")
    if coordinator:
        rank = int(os.environ["AVTUBES_PROCESS_ID"])
        return (f"tcp://{coordinator}", int(os.environ["AVTUBES_NUM_PROCESSES"]), rank,
                int(os.environ.get("LOCAL_RANK", "0")))
    if os.environ.get("AVTUBES_DISTRIBUTED") == "1" or (
            "RANK" in os.environ and "WORLD_SIZE" in os.environ):
        return ("env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
                int(os.environ.get("LOCAL_RANK", "0")))
    return None


def announced_world_size() -> int:
    """The number of processes the environment announces (1 without):
    AVTUBES_NUM_PROCESSES with a coordinator, else WORLD_SIZE."""
    if os.environ.get("AVTUBES_COORDINATOR"):
        return int(os.environ["AVTUBES_NUM_PROCESSES"])
    return int(os.environ.get("WORLD_SIZE", "1"))


def backend_for(device: str | torch.device) -> str:
    """'nccl' for a CUDA device (raising where there is no card), 'gloo'
    for the CPU."""
    dev = resolve_device(device)
    return "nccl" if dev.type == "cuda" else "gloo"


def maybe_initialize(device: str | torch.device = "cuda",
                     timeout: datetime.timedelta = COLLECTIVE_TIMEOUT) -> bool:
    """Initialize the default process group from the environment, if it
    asks for one, on the backend `device` maps to; on a card the rank's
    device becomes `cuda:LOCAL_RANK`.  Returns True when running with more
    than one process.  Safe to call more than once."""
    global _host_group, _loader_group
    if dist.is_initialized():
        return world_size() > 1
    spec = _announced()
    if spec is None:
        return False
    init_method, world, rank, local_rank = spec
    backend = backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank, timeout=timeout)
    # every rank makes the groups in this same order
    _host_group = (dist.group.WORLD if backend == "gloo"
                   else dist.new_group(backend="gloo", timeout=BARRIER_TIMEOUT))
    _loader_group = dist.new_group(backend="gloo", timeout=timeout)
    return world > 1


def shutdown() -> None:
    """Destroy the process groups `maybe_initialize` made (no-op without)."""
    global _host_group, _loader_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = _loader_group = None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns side effects (evaluation, metric logs,
    checkpoints, qualitative dumps).  Always True single-process."""
    return rank() == 0


def local_device(device: str | torch.device) -> torch.device:
    """The rank's own device: `cuda:LOCAL_RANK` (the current device that
    `maybe_initialize` set) for a CUDA run, the device itself otherwise."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def data_shard() -> tuple[int, int] | None:
    """(rank, world size) for slicing the dataset ids, or None when
    single-process."""
    return (rank(), world_size()) if world_size() > 1 else None


def _largest_divisor(batch_size: int, world: int) -> int:
    """The most devices `make_data_mesh` would take for `batch_size`: the
    largest divisor of it that is <= world."""
    n = max(1, world)
    while n > 1 and batch_size % n:
        n -= 1
    return n


def _exit_unless_divides(batch_size: int, world: int) -> None:
    if batch_size % world:
        raise SystemExit(
            f"--batch_size {batch_size} is this trainer's GLOBAL batch and {world} "
            f"processes do not divide it; run {_largest_divisor(batch_size, world)} "
            f"processes (the largest divisor of {batch_size} that is <= {world}, the "
            "devices the JAX package's make_data_mesh would use) or change --batch_size")


def check_world_divides(batch_size: int) -> None:
    """Refuse, with `SystemExit` naming the divisor, a world (as the
    environment announces it, before any rendezvous) that does not divide
    the global `batch_size` of a trainer that splits each batch in rows."""
    _exit_unless_divides(batch_size, max(announced_world_size(), world_size()))


def rows_of(global_b: int) -> slice:
    """This rank's contiguous rows [r·B/n, (r+1)·B/n) of a global batch of
    `global_b` rows (every row without a group); `SystemExit` where the
    world does not divide it."""
    world = world_size()
    _exit_unless_divides(global_b, world)
    per = global_b // world
    return slice(rank() * per, (rank() + 1) * per)


def loader_all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's CPU tensor `t` (the same shape on each), concatenated in
    rank order along axis 0, on the rows loader's own gloo group; `t`
    itself without a group."""
    if not dist.is_initialized() or world_size() == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t.contiguous(), group=_loader_group)
    return torch.cat(parts)


def check_group_matches_environment() -> None:
    """Raise when the environment announces more than one process but no
    process group is up (`maybe_initialize` was not called): each process
    would train alone on the whole dataset."""
    if announced_world_size() > 1 and not dist.is_initialized():
        raise RuntimeError(
            f"the environment announces {announced_world_size()} processes but no "
            "process group is initialized; call avtubes_torch.core.distributed."
            "maybe_initialize() first (the CLIs do)")


def barrier(tag: str, timeout: datetime.timedelta = BARRIER_TIMEOUT) -> None:
    """Cross-process sync point (no-op single-process), on the gloo group:
    keeps the other ranks waiting while the primary runs a local-only stage
    (evaluation) or writes artifacts, for up to `timeout`.  `tag` names the
    point in the error of a rank that does not arrive."""
    if world_size() > 1:
        try:
            dist.monitored_barrier(group=_host_group, timeout=timeout)
        except RuntimeError as e:
            raise RuntimeError(f"barrier {tag!r}: {e}") from e


def preempted_anywhere(flag: bool, device: torch.device) -> bool:
    """The preemption consensus: True on every rank if any rank's `flag`
    is set (an all_reduce(MAX) of the flag).  `flag` itself without a
    process group."""
    if not dist.is_initialized():
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def all_reduce_mean_(tensors: list[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place, in ONE
    all_reduce of one flat float32 buffer (no-op without a group).  The
    tensors may have any shapes and floating dtypes."""
    if not dist.is_initialized() or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    offset = 0
    for t in tensors:
        n = t.numel()
        t.detach().copy_(flat[offset:offset + n].view_as(t))
        offset += n


def gather_rows_to_primary(x: torch.Tensor) -> torch.Tensor | None:
    """Every rank's `x` (the same shape on each) concatenated in rank order
    along axis 0 on the primary, None on the others (one `gather`); `x`
    itself without a group."""
    if not dist.is_initialized():
        return x
    parts = [torch.empty_like(x) for _ in range(world_size())] if is_primary() else None
    dist.gather(x.contiguous(), parts, dst=0)
    return torch.cat(parts) if is_primary() else None


class _AllGatherRows(torch.autograd.Function):
    """Concatenate every rank's rows, in rank order; the backward sums the
    gradient of the whole over the ranks and hands each rank its own rows,
    so a row's owner receives the gradient every rank's loss sends it."""

    @staticmethod
    def forward(ctx, x):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        ctx.rows = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        start = dist.get_rank() * ctx.rows
        return grad[start:start + ctx.rows]


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) on each rank -> (world * B, ...), rank r's rows at
    [r * B, (r + 1) * B); differentiable (the identity without a group)."""
    return _AllGatherRows.apply(x) if dist.is_initialized() else x


def agreed_steps_per_epoch(n_total_ids: int, batch_size: int, group: int = 1) -> int:
    """The per-epoch step count EVERY rank must run.

    Each step is collective (the gradient all-reduce, the BatchNorm
    statistics, the negative-pool all-gather): if one rank ran fewer steps
    than its peers (a shorter `ids[rank::world]` slice, or decode failures
    skipped by its loader), the peers would block inside the collective.
    So the count is agreed a priori from the split size (the same on every
    rank, no communication): the smallest slice's full-batch count, floored
    to a multiple of `group`.  Loaders that come up short against it
    recycle their slice (`fixed_count_batches`)."""
    min_shard = n_total_ids // max(1, world_size())  # ids[r::n]: every slice has >= this
    steps = max(1, min_shard // max(1, batch_size))
    if group > 1:
        steps = max(group, steps - steps % group)
    return steps


def fixed_count_batches(loader, epoch: int, n_batches: int):
    """Yield EXACTLY n_batches batches from loader.epoch(epoch), recycling
    the local slice when decode failures leave it short (every rank runs
    the same number of steps: `agreed_steps_per_epoch`)."""
    got = 0
    while got < n_batches:
        before = got
        for batch in loader.epoch(epoch):
            yield batch
            got += 1
            if got >= n_batches:
                return
        if got == before:
            raise RuntimeError(
                "local dataset shard yielded zero batches — cannot satisfy "
                f"the agreed {n_batches} steps/epoch")
