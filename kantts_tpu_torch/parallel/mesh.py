"""Data parallelism over ``torch.distributed`` (counterpart of
``kantts_tpu/parallel/mesh.py``).

The JAX package replicates the training state over a ``data`` mesh axis,
shards each batch over it, and lets GSPMD insert the gradient all-reduce, so
that every loss is taken over the global batch. Here each process (rank)
holds one card, a full copy of the models and one shard of the batch:

- ``distributed_init`` joins the process group from torchrun's environment
  (NCCL on the card, gloo on the CPU) and is a no-op without it;
- ``replicate`` broadcasts rank 0's parameters and buffers once, after the
  build, the resume and the warm start;
- the steps reduce each loss's normalisers with ``global_sum`` (every loss is
  a rank's share of the global-batch loss: its local sum over the global
  count), the PNCA band width with ``global_max``, and then the gradients
  with ``all_reduce_grads``, one collective per optimizer, before the clip;
- the loaders pad every shard to the global batch's lengths
  (``lengths_max``), since the model's losses depend on the padded length;
- ``is_primary`` gates what a run writes (checkpoints, ``config.yaml``,
  ``stdout.log``, evaluation artifacts) on rank 0.

The models are not wrapped in ``DistributedDataParallel``: the GAN step
freezes the discriminators by toggling ``requires_grad``, so the gradients
are reduced explicitly. Without a process group every function here returns
at once and launches nothing; under torchrun at world size 1 the group exists
and the collectives run. Collectives are issued on the current stream and
never read a value back to the host.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple, TypeVar, Union

import torch
import torch.distributed as dist
from torch import nn

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)
_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

T = TypeVar("T")


def is_distributed() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def distributed_init(device: Union[str, torch.device] = "cuda",
                     backend: Optional[str] = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the process group that torchrun's environment describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). Without
    that environment, or when the group exists already, it does nothing.

    The backend is NCCL for a CUDA ``device`` and gloo for the CPU unless
    ``backend`` names one; on the card each rank takes ``cuda:LOCAL_RANK``.
    A failed rendezvous raises after ``timeout``, as does a dead peer in a
    later collective: a run never goes on alone at world size 1."""
    if is_distributed() or "WORLD_SIZE" not in os.environ:
        return
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE is set but {', '.join(missing)} is not: "
                           "launch through torchrun")
    world, rank_ = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(local_device(device))
    dist.init_process_group(
        backend,
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=rank_, world_size=world, timeout=timeout)
    if dist.get_world_size() != world or dist.get_rank() != rank_:
        raise RuntimeError(f"process group is rank {dist.get_rank()} of "
                           f"{dist.get_world_size()}, expected {rank_} of {world}")


def describe() -> str:
    """This process's place in the group, for the run's log."""
    if not is_distributed():
        return "one process"
    return f"rank {rank()} of {world_size()} over {dist.get_backend()}"


def destroy() -> None:
    """Leave the process group, if there is one."""
    if is_distributed():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_primary() -> bool:
    """The rank-0 gate for what a run writes."""
    return rank() == 0


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def primary_first(fn: Callable[[], T]) -> T:
    """Run ``fn`` on rank 0, then, after a barrier, on the other ranks: what
    rank 0 writes (the split of a metafile), they read."""
    out = fn() if is_primary() else None
    barrier()
    return out if is_primary() else fn()


def lengths_max() -> Optional[Callable[[Sequence[int]], Tuple[int, ...]]]:
    """What a loader takes a batch's padded lengths to the largest over the
    ranks with (``data.dataset.DataLoader(lengths_max=)``); None without a
    process group. The model's MAS attention normalises over padded text
    positions too, so a shard's loss depends on the length it is padded to:
    padded as the global batch is, it is the global batch's share. The
    lengths go over a gloo group of their own, made here in the same order
    on every rank, so that agreeing on them reads nothing back from a card."""
    if not is_distributed():
        return None
    group = dist.new_group(backend="gloo")

    def agree(values: Sequence[int]) -> Tuple[int, ...]:
        t = torch.tensor(list(values), dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return tuple(t.tolist())

    return agree


def local_device(device: Union[str, torch.device]) -> torch.device:
    """The card of this rank for a CUDA ``device``: ``cuda:LOCAL_RANK`` under
    torchrun, ``device`` as it is outside; the CPU stays the CPU."""
    device = torch.device(device)
    if device.type != "cuda" or "LOCAL_RANK" not in os.environ:
        return device
    return torch.device("cuda", int(os.environ["LOCAL_RANK"]))


def rank_seed(seed: int) -> int:
    """The seed of this rank's own draws (dropout, scheduled sampling), made
    from (seed, rank): rank 0 keeps ``seed``, so a run at world size 1 draws
    as a plain one does, and the other ranks draw masks of their own, as one
    draw over the global batch would."""
    return (seed + 0x9E3779B1 * rank()) % (2 ** 63)


class CollectiveTimer:
    """Time spent in this module's collectives. On the card each collective is
    bracketed by two CUDA events, read only when ``take_seconds`` is called
    (after the trainer's log sync), so timing adds no host sync; on the CPU
    the collectives block and the host clock times them."""

    def __init__(self):
        self._record: List[Union[float, Tuple[torch.cuda.Event, torch.cuda.Event]]] = []

    def run(self, device: torch.device, fn: Callable[[], None]) -> None:
        if device.type != "cuda":
            t0 = time.perf_counter()
            fn()
            self._record.append(time.perf_counter() - t0)
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        self._record.append((start, end))

    def take_intervals(self) -> List[float]:
        """The seconds of each collective since the last take, in order;
        clears the record."""
        out = []
        for r in self._record:
            if isinstance(r, float):
                out.append(r)
            else:
                r[1].synchronize()
                out.append(r[0].elapsed_time(r[1]) / 1e3)
        self._record = []
        return out

    def take_seconds(self) -> float:
        """The seconds since the last take; clears the record."""
        return sum(self.take_intervals())


def _collective(tensors: Sequence[torch.Tensor], fn: Callable[[torch.Tensor], None],
                timer: Optional[CollectiveTimer]) -> None:
    """``fn`` (an in-place collective) on one flat buffer per dtype of
    ``tensors``, then the result copied back into them; ``timer`` times the
    whole, the flattening and the copy included."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)

    def run(group):
        flat = torch.cat([t.reshape(-1) for t in group])
        fn(flat)
        torch._foreach_copy_(group, [v.view_as(t) for v, t in
                                     zip(flat.split([t.numel() for t in group]), group)])

    for group in by_dtype.values():
        if timer is not None:
            timer.run(group[0].device, lambda: run(group))
        else:
            run(group)


def replicate(modules: Iterable[nn.Module]) -> None:
    """Broadcast every parameter and buffer of ``modules`` (the spectral-norm
    vectors ``weight_u`` included) from rank 0 to every rank."""
    if not is_distributed():
        return
    tensors = [t.data for m in modules for t in (*m.parameters(), *m.buffers())]
    _collective(tensors, lambda flat: dist.broadcast(flat, 0), None)


def optimizer_params(optimizer: torch.optim.Optimizer) -> List[nn.Parameter]:
    return [p for group in optimizer.param_groups for p in group["params"]]


def all_reduce_grads(params: Iterable[nn.Parameter],
                     timer: Optional[CollectiveTimer] = None) -> None:
    """Sum the gradients of ``params`` over the ranks in one collective over a
    flat buffer (one per dtype); parameters without a gradient are skipped,
    which every rank does alike because every rank runs the same graph."""
    if not is_distributed():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        _collective(grads, lambda flat: dist.all_reduce(flat), timer)


def global_sum(*scalars: torch.Tensor, timer: Optional[CollectiveTimer] = None
               ) -> Tuple[torch.Tensor, ...]:
    """Each 0-d tensor summed over the ranks, in one collective over a stacked
    float64 vector (exact for counts below 2**53), each returned in its own
    dtype and without gradient."""
    if not is_distributed():
        return scalars
    vec = torch.stack([s.detach().to(torch.float64) for s in scalars])
    if timer is not None:
        timer.run(vec.device, lambda: dist.all_reduce(vec))
    else:
        dist.all_reduce(vec)
    return tuple(v.to(s.dtype) for v, s in zip(vec.unbind(), scalars))


def global_max(x: torch.Tensor, timer: Optional[CollectiveTimer] = None
               ) -> torch.Tensor:
    """A 0-d tensor's largest value over the ranks, without gradient."""
    if not is_distributed():
        return x
    out = x.detach().clone()
    if timer is not None:
        timer.run(out.device, lambda: dist.all_reduce(out, op=dist.ReduceOp.MAX))
    else:
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out
