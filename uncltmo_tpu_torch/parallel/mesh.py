"""Data parallelism over processes, one rank a card.

Port of `uncltmo_tpu/parallel/mesh.py`, keeping its names.  The JAX package
runs one SPMD program over a mesh of devices: the batch is sharded over the
'data' axis, and XLA computes every reduction of the train step over the
*global* batch and inserts the collectives itself.  PyTorch runs one
process a card (`torch.distributed`), each on its own rows of the batch, so
the port writes the collectives where the step needs them:

* the gradients: `all_reduce_mean_` of the D list and of the G list (the
  step takes `torch.autograd.grad`, which DDP's hooks never see);
* the terms that couple the batch -- the relativistic D loss (every real
  logit against every fake one), the naturalness ranking of infoNCE2 and of
  the pseudo label, batch norm's statistics, `batchMax` -- through
  differentiable collectives (`all_gather_batch`, `gather_rows`,
  `all_reduce_sum`) whose backward is their forward's adjoint.

The rule that makes a rank's step the one-process step on the global
batch: each rank differentiates a loss whose mean over the ranks is the
one-process loss, every collective carries its exact adjoint, and the
gradients are averaged.  A term that every rank computes alike from
gathered tensors gets N times its share through the gather's backward (an
all-reduce of the N equal upstream gradients), and the mean divides by N
once; a per-sample mean over the rank's own rows is already its share of
the global mean.

Backends: NCCL where each rank has a card of its own, gloo where ranks
share a card or run on the CPU (NCCL refuses two ranks on one device).
Only `all_reduce` and `broadcast` are used, the two collectives gloo
offers on CUDA tensors.  Without a process group every helper is the
identity of one process.
"""
from __future__ import annotations

import datetime
import hashlib
import os
import socket
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

# the seconds a collective waits for a peer before the run fails: a dead
# rank ends the run instead of hanging it (long enough for rank 0's
# evaluation at a 1/4-epoch summary, while the others wait at a barrier)
DEFAULT_TIMEOUT_S = 1800.0


def get_mesh(n_devices: Optional[int] = None, devices=None
             ) -> List[torch.device]:
    """The first `n_devices` of `devices` (every visible card when None).

    Raises when fewer are visible: a smaller mesh would trip a confusing
    divisibility error downstream or quietly run at reduced parallelism."""
    devs = [torch.device(d) for d in devices] if devices is not None else [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devs)} devices are available")
        devs = devs[:n_devices]
    return devs


def _visible_cards(device) -> Optional[int]:
    """The cards a CUDA run can take; None on the CPU, where the ranks are
    gloo processes and any count is there."""
    return (torch.cuda.device_count() if torch.device(device).type == "cuda"
            else None)


def _check_data_parallel(n: int, batch_size: int,
                         visible: Optional[int]) -> int:
    """The JAX trainer's checks of a count above one
    (`uncltmo_tpu/training/trainer.py:49-66`), word for word."""
    if n > 1:
        if visible is not None and n > visible:
            raise ValueError(
                f"data_parallel={n} requested but only "
                f"{visible} devices are visible")
        if batch_size % n != 0:
            raise ValueError(
                f"batch_size={batch_size} is not divisible by "
                f"data_parallel={n}; choose a divisible batch")
    return n


def resolve_data_parallel(requested: int, batch_size: int, device) -> int:
    """The rank count that the training CLIs start, by the JAX trainer's
    rules: 0 takes every visible card when the batch divides over them,
    else one; a count above one must be visible and must divide the
    batch.  On the CPU 0 means one."""
    visible = _visible_cards(device)
    n = int(requested)
    if n == 0:
        n = visible if (visible and visible > 1
                        and batch_size % visible == 0) else 1
    return _check_data_parallel(n, batch_size, visible)


def trainer_data_parallel(requested: int, batch_size: int, device) -> int:
    """The rank count of a `GanTrainer`, which is one rank of its process
    group: the group's size, which 0 takes and a count must equal; one
    outside a group.  Outside a group a count above one gets the JAX
    checks, then is refused with how to start the ranks.  Inside one the
    launcher (the CLI, torchrun, `launch`) has placed the ranks, a card
    each or gloo ranks sharing the cards, so only the batch is checked."""
    world = rank_world()[1]
    n = int(requested) or world
    _check_data_parallel(n, batch_size,
                         _visible_cards(device) if world == 1 else None)
    if n != world:
        raise ValueError(
            f"data_parallel={n} runs as {n} processes, one a card, but "
            f"this process group has {world}: start the run with the "
            f"training CLI's --data_parallel {n} or with torchrun")
    return n


def rank_world() -> tuple:
    """(rank, world size) of this process; (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def rank_device(device, rank: int, world: int) -> torch.device:
    """The card of a rank: its own where there are enough cards, else the
    cards shared in turn.  A rank never falls back to the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("data parallel on cuda: no CUDA device is visible")
    return torch.device("cuda", _local_rank(rank) % n)


def backend_for(device, world: int) -> str:
    """NCCL where every rank has a card of its own, else gloo."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> torch.device:
    """Join the process group and return this rank's device.

    `coordinator_address` ('host:port' or 'tcp://host:port'),
    `num_processes` and `process_id` name the group; what is left None is
    read from torchrun's environment (MASTER_ADDR / MASTER_PORT,
    WORLD_SIZE, RANK).  One process is a no-op, as in the JAX package.
    The backend follows `backend_for`; a failed start raises."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
        process_id = int(os.environ.get("RANK", 0))
    init_method = "env://"
    if coordinator_address:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    if num_processes <= 1:
        return torch.device(device)
    rank = int(process_id)
    dev = rank_device(device, rank, num_processes)
    backend = backend_for(device, num_processes)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(device_id=dev) if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=rank, timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S),
        **kw)
    return dev


def launched_by_torchrun() -> bool:
    return int(os.environ.get("WORLD_SIZE", 1)) > 1 and "RANK" in os.environ


def _entry(rank: int, fn: Callable, world: int, port: int, device,
           args: tuple) -> None:
    dev = initialize_distributed(f"localhost:{port}", world, rank, device)
    try:
        fn(dev, *args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, device, *args) -> None:
    """Run fn(rank_device, *args) in `world` spawned processes joined in one
    group on a free localhost port; raises when any of them fails (the
    others are then terminated).  `fn` and `args` must pickle."""
    import torch.multiprocessing as mp
    mp.spawn(_entry, args=(fn, world, free_port(), str(device), args),
             nprocs=world, join=True)


def barrier() -> None:
    if rank_world()[1] > 1:
        dist.barrier()


def broadcast_object(obj, src: int = 0):
    """`obj` of rank `src` on every rank (the identity on one process)."""
    if rank_world()[1] == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


# ------------------------------------------------------------ the batch
def shard_batch(batch: Dict, rank: int, world: int) -> Dict:
    """The rank's rows of a global batch dict (arrays or tensors with the
    batch first): rows [rank * B/N, (rank + 1) * B/N).  A sample is a whole
    clip, so the video generator's recurrence never crosses ranks."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % world:
            raise ValueError(f"shard_batch: {k} has {b} rows, not "
                             f"divisible by {world} ranks")
        n = b // world
        out[k] = v[rank * n:(rank + 1) * n]
    return out


# ------------------------------------------------------- plain collectives
def _comm_device(t: torch.Tensor) -> torch.device:
    """Where a buffer goes for a collective: NCCL takes the rank's card
    only, gloo the tensor's device."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _coalesced(tensors: Sequence[torch.Tensor], collective: Callable) -> None:
    """Run `collective(buffer)` on one flat buffer per dtype holding every
    tensor, then copy the result back into each, in place."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        dev = _comm_device(group[0])
        buf = torch.cat([t.detach().reshape(-1).to(dev) for t in group])
        collective(buf)
        i = 0
        for t in group:
            n = t.numel()
            t.data.copy_(buf[i:i + n].view_as(t))
            i += n


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average a list of float32 tensors (gradients) over the ranks, in
    place, in one all-reduce."""
    world = rank_world()[1]
    if world == 1 or not tensors:
        return

    def mean(buf):
        dist.all_reduce(buf)
        buf.div_(world)

    _coalesced(tensors, mean)


def replicate_tree(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Broadcast rank `src`'s values of `tensors` to every rank, in place
    (the JAX package replicates its state tree over the mesh)."""
    tensors = list(tensors)
    if rank_world()[1] == 1 or not tensors:
        return
    _coalesced(tensors, lambda buf: dist.broadcast(buf, src))


def state_tensors(state) -> List[torch.Tensor]:
    """Every tensor of a `TrainState` in a fixed order: both modules'
    parameters and buffers, then both Adam states (moments and step
    counts)."""
    out: List[torch.Tensor] = []
    for module in (state.gen, state.disc):
        out += list(module.state_dict().values())
    for opt, module in ((state.opt_G, state.gen), (state.opt_D, state.disc)):
        for p in module.parameters():
            st = opt.state.get(p, {})
            out += [st[k] for k in sorted(st) if torch.is_tensor(st[k])]
    return out


def state_digest(state) -> str:
    """sha256 of every tensor of a `TrainState` (`state_tensors`), with the
    step: equal on every rank exactly when the ranks hold the same state.
    The tensors cross to the host as one buffer per device and dtype."""
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in state_tensors(state):
        groups.setdefault((str(t.device), str(t.dtype)), []).append(
            t.detach().reshape(-1))
    h = hashlib.sha256(str(state.step).encode())
    for key in sorted(groups):
        h.update(key[1].encode())
        h.update(torch.cat(groups[key]).cpu().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


# ------------------------------------------------ differentiable collectives
class _GatherRows(torch.autograd.Function):
    """Rows `rows` (global indices, a tensor on x's device) of the batch
    laid out rank after rank, on every rank: an all-reduce of a zero buffer
    in which each rank fills the rows it holds.  Backward: the all-reduce
    of the upstream gradients, of which each rank keeps its own rows (the
    adjoint).  The indices stay on the device: no host sync."""

    @staticmethod
    def forward(ctx, x, rows, rank):
        b = x.shape[0]
        local = rows - rank * b
        own = (local >= 0) & (local < b)
        local = local.clamp(0, b - 1)
        keep = own.reshape((-1,) + (1,) * (x.dim() - 1))
        buf = torch.where(keep, x[local].float(), 0.0)
        dist.all_reduce(buf)
        ctx.save_for_backward(local, keep)
        ctx.shape, ctx.dtype = x.shape, x.dtype
        return buf.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        local, keep = ctx.saved_tensors
        g = grad.float().contiguous()
        dist.all_reduce(g)
        dx = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        dx.index_add_(0, local, torch.where(keep, g, 0.0))
        return dx.to(ctx.dtype), None, None


def gather_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(len(rows), ...) rows of the global batch (a tensor of global
    indices, the same on every rank), differentiable; x[rows] on one
    process."""
    rank, world = rank_world()
    if world == 1:
        return x[rows]
    return _GatherRows.apply(x, rows.to(x.device), rank)


def all_gather_batch(*xs: torch.Tensor):
    """The global batch of each of `xs` (equal leading sizes, rank after
    rank), differentiable, in one collective, in float32 on the wire; the
    tensors themselves on one process."""
    rank, world = rank_world()
    if world == 1:
        return xs if len(xs) > 1 else xs[0]
    b = xs[0].shape[0]
    flat = [x.reshape(b, -1).float() for x in xs]
    sizes = [f.shape[1] for f in flat]
    rows = torch.arange(world * b, device=xs[0].device)
    full = _GatherRows.apply(torch.cat(flat, 1), rows, rank)
    out = tuple(part.reshape((world * b,) + tuple(x.shape[1:])).to(x.dtype)
                for part, x in zip(full.split(sizes, 1), xs))
    return out if len(out) > 1 else out[0]


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks, on every rank; its adjoint is itself."""

    @staticmethod
    def forward(ctx, x):
        y = x.float().clone()
        dist.all_reduce(y)
        ctx.dtype = x.dtype
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        g = grad.float().clone()
        dist.all_reduce(g)
        return g.to(ctx.dtype)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum over the ranks (x itself on one process)."""
    if rank_world()[1] == 1:
        return x
    return _AllReduceSum.apply(x)


def global_max(x: torch.Tensor) -> torch.Tensor:
    """x.max() over every rank's x, with torch's gradient of a full max:
    1/count to each entry equal to the max, on whichever rank it lies."""
    if rank_world()[1] == 1:
        return x.max()
    with torch.no_grad():
        m = x.max().float()
        dist.all_reduce(m, op=dist.ReduceOp.MAX)
        tie = x == m.to(x.dtype)
        count = tie.sum().float()
    s = all_reduce_sum(torch.stack([(x * tie).sum().float(), count]))
    # the value is the max exactly; the gradient reaches the ties as 1/count
    return (m + (s[0] - s[0].detach()) / s[1]).to(x.dtype)


def reduce_logs(logs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A step's logs over the ranks in two collectives: `fake/min` and
    `fake/max` by min and max, `gradG/*` as they are (computed from the
    all-reduced gradients, equal on every rank), every other entry the mean
    over the ranks (a loss or a rate over equal shards)."""
    world = rank_world()[1]
    if world == 1:
        return logs
    means = [k for k in logs if not k.startswith(("gradG/", "fake/min",
                                                  "fake/max"))]
    out = dict(logs)
    if means:
        buf = torch.stack([logs[k].float() for k in means])
        dist.all_reduce(buf)
        buf = buf / world
        out.update({k: buf[i] for i, k in enumerate(means)})
    if "fake/max" in logs:
        ext = torch.stack([logs["fake/max"].float(),
                           -logs["fake/min"].float()])
        dist.all_reduce(ext, op=dist.ReduceOp.MAX)
        out["fake/max"], out["fake/min"] = ext[0], -ext[1]
    return out
