"""Tensor and sequence parallelism over ``torch.distributed`` (counterpart of
``kantts_tpu/parallel/tp.py``).

The JAX package shards the attention and FFN kernels of SAM-BERT over the
``model`` axis of a ("data", "model") mesh with GSPMD specs, and lets XLA
insert the reductions and reshard where a layout needs it. Here the ranks
form the same grid (``make_mesh_2d``: rank = data_index * n_model +
model_index) and the sharding is explicit, Megatron's pattern:

- a **column-parallel** layer (``_COL_LAYERS``: ``w_qkv``, ``w_x_qkv``,
  ``w_h_kv``, ``w_1``) holds a slice of its output features and bias; its
  input passes ``copy_to_model`` (identity forward, the gradient summed over
  the model group in backward);
- a **row-parallel** layer (``_ROW_LAYERS``: ``fc``, ``fc_x``, ``fc_h``,
  ``w_2``) holds the matching slice of its input features; its partial
  product passes ``reduce_from_model`` (summed over the model group forward,
  identity backward; under bf16 in float32, rounded once after the sum:
  ``sambert/common.py::reduced_partials``), then its whole bias is added
  once;
- both only inside ``_TP_SCOPES`` (``slf_attn``, ``pnca_attn``, ``pos_ffn``,
  ``fsmn``), leaf for leaf as ``_tp_spec`` picks them; everything else is
  replicated, and the data-parallel collectives go over the data group.

GSPMD may split ``w_qkv``'s columns contiguously because XLA reshards
before the heads are split; an explicit split may not (rank 0 would hold all
of q and half of k). So each of a fused projection's chunks (q, k, v; or
k, v) is split by head: rank r holds heads [r H/n, (r+1) H/n) of each, and
an attention module runs its own heads. A module whose head count (or inner
width) does not divide by n stays replicated; ``_tp_spec`` falls back to
``P()`` where the dims do not divide, which it does for the same modules
except an attention whose heads do not divide while its widths do (GSPMD
can split inside a head; this port keeps that module whole).

Checkpoints hold the gathered, unsharded state (``gather_state_dict``,
``gather_optimizer_state``), so they load into a plain run, and a plain one
loads into a sharded model through ``shard_state_dict`` /
``shard_optimizer_state``. The gradient clip takes the norm of the logical
parameters (``make_clip``). Adam's moments are sharded with their
parameters, so its update stays local.

A crash cannot gather: a rank that failed alone cannot join a collective,
and a rank still inside one never reaches its handler. So each rank of the
first model group writes its own slice with no collective (``local_slice``,
to ``slice_path``), and rank 0 joins the slice files into the whole
checkpoint (``join_slice_files``), or leaves them when one is missing. A
slice carries the run's number (``TensorParallel.run``, drawn once per
``shard_module``), so a slice that an earlier run left at the same step is
never joined with this run's. ``join_slices`` is the one join of per-rank
pieces: ``gather_state_dict`` and ``gather_optimizer_state`` are the
``all_gather`` of the live shards into the same pieces, then that join.

Sequence parallelism (``sequence_parallel_apply``): one utterance's
generator forward with its mel split along time over a group. Where XLA
partitions every conv and exchanges halos at each of the generator's 104
convs, each rank here runs the generator once on its slice widened by the
receptive field (``time_sharded``), trims, and the pieces meet in one
``all_gather``.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from kantts_tpu_torch.parallel.mesh import (  # noqa: F401 - the JAX names
    CollectiveTimer,
    Grid,
    is_distributed,
    make_mesh_2d,
)

MODEL_AXIS = "model"

_COL_LAYERS = {"w_qkv", "w_x_qkv", "w_h_kv", "w_1"}
_ROW_LAYERS = {"fc", "fc_x", "fc_h", "w_2"}
_TP_SCOPES = {"slf_attn", "pnca_attn", "pos_ffn", "fsmn"}


class ModelParallel:
    """A sharded module's model group: its size, this rank's index in it, and
    the timer of its collectives (``mesh.CollectiveTimer``, or None)."""

    def __init__(self, group: Optional[dist.ProcessGroup], size: int, index: int,
                 timer: Optional[CollectiveTimer] = None):
        self.group, self.size, self.index, self.timer = group, size, index, timer

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the model group in place; -> ``x``."""
        if self.timer is not None:
            self.timer.run(x.device, lambda: dist.all_reduce(x, group=self.group))
        else:
            dist.all_reduce(x, group=self.group)
        return x


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mp.all_reduce(grad.clone()), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mp):
        return mp.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mp: Optional[ModelParallel]) -> torch.Tensor:
    """The input of a column-parallel layer (``x`` itself without ``mp``)."""
    return x if mp is None else _CopyToModel.apply(x, mp)


def reduce_from_model(x: torch.Tensor, mp: Optional[ModelParallel]) -> torch.Tensor:
    """The partial products of row-parallel layers summed over the model
    group (``x`` itself without ``mp``)."""
    return x if mp is None else _ReduceFromModel.apply(x, mp)


# ------------------------------------------------------------------ the plan


@dataclass(frozen=True)
class Shard:
    """How one state-dict entry is split: along ``dim``, each of its
    ``chunks`` equal parts (3 for q/k/v, 2 for k/v) contiguously."""
    kind: str  # "col" or "row"
    dim: int
    chunks: int = 1


def _units(model: nn.Module, n_model: int):
    """(name, module) of each module that shards: one that names its layers
    (``TP_COL``/``TP_ROW``), lies inside a ``_TP_SCOPES`` scope, and whose
    heads or inner channels divide by ``n_model``."""
    for name, module in model.named_modules():
        if not hasattr(module, "TP_COL"):
            continue
        if not _TP_SCOPES & set(name.split(".")):
            continue
        if module.tp_units() % n_model == 0:
            yield name, module


def tp_plan(model: nn.Module, n_model: int) -> Dict[str, Shard]:
    """The state-dict entries of ``model`` that shard over ``n_model`` ranks
    (the counterpart of ``tp_shardings``): a column layer's weight and bias
    along their output features, a row layer's weight along its input
    features; a row layer's bias stays whole."""
    plan = {}
    for name, module in _units(model, n_model):
        for layer, chunks in module.TP_COL.items():
            assert layer in _COL_LAYERS, layer
            sub = getattr(module, layer)
            plan[f"{name}.{layer}.weight"] = Shard("col", 0, chunks)
            if sub.bias is not None:
                plan[f"{name}.{layer}.bias"] = Shard("col", 0, chunks)
        for layer in module.TP_ROW:
            assert layer in _ROW_LAYERS, layer
            plan[f"{name}.{layer}.weight"] = Shard("row", 1)
    return plan


def split(t: torch.Tensor, shard: Shard, n: int, index: int) -> torch.Tensor:
    """Rank ``index``'s slice of the whole tensor ``t``."""
    return torch.cat([c.chunk(n, shard.dim)[index]
                      for c in t.chunk(shard.chunks, shard.dim)], shard.dim).contiguous()


def join(pieces: List[torch.Tensor], shard: Shard) -> torch.Tensor:
    """The whole tensor from every rank's slice, in rank order."""
    parts = [p.chunk(shard.chunks, shard.dim) for p in pieces]
    return torch.cat([torch.cat([p[c] for p in parts], shard.dim)
                      for c in range(shard.chunks)], shard.dim)


class TensorParallel:
    """What ``shard_module`` leaves on a model (``model.tensor_parallel``):
    the grid, the plan, the model group's handle, and the run's number, on
    which the model group agreed (``_run_number``)."""

    def __init__(self, grid: Grid, plan: Dict[str, Shard], mp: ModelParallel, run: int):
        self.grid, self.plan, self.mp, self.run = grid, plan, mp, run


def _run_number(group: Optional[dist.ProcessGroup], device: torch.device) -> int:
    """A number that every rank of ``group`` returns and another run does
    not draw: the largest of each rank's random draw (one all-reduce)."""
    t = torch.tensor([int.from_bytes(os.urandom(7), "little")], dtype=torch.int64,
                     device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


def is_sharded(model: nn.Module) -> bool:
    return getattr(model, "tensor_parallel", None) is not None


def _state_shards(optimizer: Optional[torch.optim.Optimizer], param: nn.Parameter):
    """The optimizer's state tensors of ``param`` shaped like it (Adam's
    moments; not its step count)."""
    if optimizer is None:
        return {}
    state = optimizer.state.get(param, {})
    return {k: v for k, v in state.items()
            if torch.is_tensor(v) and v.shape == param.shape}


def shard_module(model: nn.Module, grid: Grid,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 timer: Optional[CollectiveTimer] = None) -> Dict[str, Shard]:
    """Shard ``model`` in place over ``grid``'s model group (the counterpart of
    ``shard_state``), after the build, the resume, the warm start and the
    broadcast: each planned parameter keeps its identity (the optimizer's
    references stay valid) and takes this rank's slice, as do its optimizer
    moments; each sharded attention keeps its own heads. -> the plan."""
    n, index = grid.n_model, grid.model_index
    mp = ModelParallel(grid.model_group, n, index, timer)
    units = list(_units(model, n))
    plan = tp_plan(model, n)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for key, shard in plan.items():
            p = params[key]
            for k, v in _state_shards(optimizer, p).items():
                optimizer.state[p][k] = split(v, shard, n, index)
            p.data = split(p.data, shard, n, index)
    for _, module in units:
        module.tp = mp
        if hasattr(module, "n_head"):
            module.n_head //= n
    run = _run_number(grid.model_group, next(model.parameters()).device)
    model.tensor_parallel = TensorParallel(grid, plan, mp, run)
    logging.info("tensor parallel: %d entries of %d sharded %d-way (%s)", len(plan),
                 len(params), n, grid.describe())
    return plan


def _gather(t: torch.Tensor, shard: Shard, mp: ModelParallel) -> torch.Tensor:
    pieces = [torch.empty_like(t) for _ in range(mp.size)]
    dist.all_gather(pieces, t.contiguous(), group=mp.group)
    return join(pieces, shard)


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The unsharded state dict of a sharded ``model``, on every rank (a
    collective of the model group); a plain model's own. The sharded entries
    are new tensors, the rest the live ones."""
    if not is_sharded(model):
        return model.state_dict()
    return join_slices(_gathered_slices(model))[0]


def gather_training_state(model: nn.Module, optimizer: torch.optim.Optimizer
                          ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """``gather_state_dict`` and ``gather_optimizer_state`` in one gather:
    what a checkpoint holds."""
    if not is_sharded(model):
        return model.state_dict(), optimizer.state_dict()
    return join_slices(_gathered_slices(model, optimizer))


def gather_grads(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The gradients of ``model``'s parameters, whole (the sharded ones
    gathered over the model group, the rest cloned): what a check holds
    against the unsharded model's."""
    tp = getattr(model, "tensor_parallel", None)
    return {k: (_gather(p.grad, tp.plan[k], tp.mp) if tp is not None and k in tp.plan
                else p.grad.clone())
            for k, p in model.named_parameters() if p.grad is not None}


def shard_state_dict(state: Dict[str, torch.Tensor], model: nn.Module
                     ) -> Dict[str, torch.Tensor]:
    """This rank's slices of a whole state dict, for a sharded ``model``'s
    ``load_state_dict`` (the inverse of ``gather_state_dict``)."""
    if not is_sharded(model):
        return state
    tp = model.tensor_parallel
    return {k: (split(v, tp.plan[k], tp.mp.size, tp.mp.index) if k in tp.plan else v)
            for k, v in state.items()}


def _sharded_params(optimizer: torch.optim.Optimizer, model: nn.Module):
    """{index in the optimizer's state dict: (parameter, shard)} of the
    sharded parameters."""
    tp = model.tensor_parallel
    by_id = {id(p): tp.plan[k] for k, p in model.named_parameters() if k in tp.plan}
    order = [p for group in optimizer.param_groups for p in group["params"]]
    return {i: (p, by_id[id(p)]) for i, p in enumerate(order) if id(p) in by_id}


def gather_optimizer_state(optimizer: torch.optim.Optimizer, model: nn.Module
                           ) -> Dict:
    """``optimizer.state_dict()`` with the moments of ``model``'s sharded
    parameters gathered whole (a collective of the model group)."""
    return gather_training_state(model, optimizer)[1]


def shard_optimizer_state(sd: Dict, optimizer: torch.optim.Optimizer,
                          model: nn.Module) -> Dict:
    """This rank's slices of a whole optimizer state dict (the inverse of
    ``gather_optimizer_state``)."""
    if not is_sharded(model):
        return sd
    mp = model.tensor_parallel.mp
    sharded = _sharded_params(optimizer, model)
    state = {}
    for i, entry in sd["state"].items():
        if i not in sharded:
            state[i] = entry
            continue
        p, shard = sharded[i]
        full = join([p] * mp.size, shard).shape
        state[i] = {k: (split(v, shard, mp.size, mp.index)
                        if torch.is_tensor(v) and v.shape == full else v)
                    for k, v in entry.items()}
    return {**sd, "state": state}


# ------------------------------------------------------------- crash slices


def slice_path(path: str, index: int, size: int) -> str:
    """Where rank ``index`` of a model group of ``size`` writes its slice of
    the whole checkpoint ``path``: ``checkpoint-7.ckpt`` ->
    ``checkpoint-7.rank1-of-2.ckpt``."""
    root, ext = os.path.splitext(path)
    return f"{root}.rank{index}-of-{size}{ext}"


def local_slice(model: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None
                ) -> Dict:
    """This rank's share of a sharded model's training state, taken with no
    collective: its model and optimizer (or None) state dicts (live
    tensors), the plan as tuples, the parameter name of each sharded
    optimizer entry, its index in the model group and the run's number."""
    tp = model.tensor_parallel
    names = {id(p): k for k, p in model.named_parameters()}
    return dict(model=model.state_dict(),
                optimizer=None if optimizer is None else optimizer.state_dict(),
                plan={k: (s.kind, s.dim, s.chunks) for k, s in tp.plan.items()},
                optimizer_plan={} if optimizer is None else {
                    i: names[id(p)] for i, (p, _) in _sharded_params(optimizer, model).items()},
                index=tp.mp.index, run=tp.run)


def _sharded_keys(piece: Dict) -> Dict[tuple, Shard]:
    """Where each sharded tensor of a ``local_slice`` lies, and its split:
    ``("model", key)`` for each planned entry, ``("optimizer", i, name)``
    for each optimizer state tensor shaped like its sharded parameter
    (Adam's moments; not its step count)."""
    plan = {k: Shard(*v) for k, v in piece["plan"].items()}
    keys = {("model", k): s for k, s in plan.items()}
    state = {} if piece["optimizer"] is None else piece["optimizer"]["state"]
    for i, key in piece["optimizer_plan"].items():
        shape = piece["model"][key].shape
        keys.update({("optimizer", i, k): plan[key] for k, v in state.get(i, {}).items()
                     if torch.is_tensor(v) and v.shape == shape})
    return keys


def _at(piece: Dict, key: tuple) -> torch.Tensor:
    if key[0] == "model":
        return piece["model"][key[1]]
    return piece["optimizer"]["state"][key[1]][key[2]]


def _with(piece: Dict, tensors: Dict[tuple, torch.Tensor]) -> Dict:
    """``piece`` with the tensors at ``tensors``' keys replaced (new dicts
    down to them; everything else shared)."""
    model, opt = dict(piece["model"]), piece["optimizer"]
    state = None if opt is None else {i: dict(e) for i, e in opt["state"].items()}
    for key, t in tensors.items():
        if key[0] == "model":
            model[key[1]] = t
        else:
            state[key[1]][key[2]] = t
    return dict(piece, model=model, optimizer=None if opt is None else {**opt, "state": state})


def join_slices(slices: List[Dict]) -> Tuple[Dict[str, torch.Tensor], Optional[Dict]]:
    """The whole model and optimizer state dicts from every rank's
    ``local_slice``, in any order: each sharded tensor joined from the
    ranks' pieces, the rest as the first rank holds them."""
    slices = sorted(slices, key=lambda s: s["index"])
    whole = _with(slices[0], {key: join([_at(s, key) for s in slices], shard)
                              for key, shard in _sharded_keys(slices[0]).items()})
    return whole["model"], whole["optimizer"]


def _gathered_slices(model: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None
                     ) -> List[Dict]:
    """Every rank's ``local_slice`` of the model group, its sharded tensors
    brought here by one ``all_gather`` each (a collective of the group)."""
    mine = local_slice(model, optimizer)
    mp = model.tensor_parallel.mp
    pieces = {}
    for key in _sharded_keys(mine):
        t = _at(mine, key)
        pieces[key] = [torch.empty_like(t) for _ in range(mp.size)]
        dist.all_gather(pieces[key], t.contiguous(), group=mp.group)
    return [dict(_with(mine, {k: p[r] for k, p in pieces.items()}), index=r)
            for r in range(mp.size)]


def _agrees(piece: Dict, steps, config, run) -> bool:
    return all(want is None or piece.get(k) == want
               for k, want in (("steps", steps), ("config", config), ("run", run)))


def join_slice_files(path: str, size: int, timeout: float = 0.0,
                     steps: Optional[int] = None, config: Optional[Dict] = None,
                     run: Optional[int] = None) -> Optional[Dict]:
    """The whole checkpoint payload of ``path`` from its ``size`` slice
    files, waiting up to ``timeout`` seconds for each to appear and hold
    ``steps``, ``config`` and ``run`` where they are given (each lands
    whole: ``write_checkpoint`` renames it into place; a file that does not
    agree is read again once it is replaced, so a slice of another run or
    step is never joined). -> the payload (``model``, ``config``,
    ``optimizer``, ``scheduler``, ``steps``), or None with a log line naming
    the ranks whose slice is missing or does not agree."""
    paths = [slice_path(path, r, size) for r in range(size)]
    slices: List[Optional[Dict]] = [None] * size
    read: List[Optional[tuple]] = [None] * size  # the file each rank's slice was read from
    deadline = time.monotonic() + timeout
    while True:
        for r, p in enumerate(paths):
            try:
                st = os.stat(p)
            except FileNotFoundError:
                continue
            if slices[r] is None and read[r] != (st.st_ino, st.st_size, st.st_mtime_ns):
                read[r] = (st.st_ino, st.st_size, st.st_mtime_ns)
                piece = torch.load(p, map_location="cpu", weights_only=True)
                slices[r] = piece if _agrees(piece, steps, config, run) else None
        if all(s is not None for s in slices) or time.monotonic() >= deadline:
            break
        time.sleep(0.05)
    bad = [f"rank {r} ({'no slice' if read[r] is None else 'a slice of another run or step'})"
           for r in range(size) if slices[r] is None]
    if bad:
        logging.error("cannot join %s: %s; the slices present are left as they are",
                      os.path.basename(path), "; ".join(bad))
        return None
    model, optimizer = join_slices(slices)
    first = slices[0]
    return {"model": model, "config": first["config"], "optimizer": optimizer,
            "scheduler": first["scheduler"], "steps": first["steps"]}


def make_clip(model: nn.Module, max_norm: float) -> Callable[[], torch.Tensor]:
    """The global-norm clip of ``train/optim.py`` over the logical parameters
    of ``model`` once sharded (it may be made before): the squared norms of
    the sharded gradients summed over the model group, the replicated ones
    counted once. -> clip() -> the norm before clipping, as a device scalar;
    no host sync."""
    def squares(grads):
        return torch.stack(torch._foreach_norm(grads)).square().sum()

    def clip() -> torch.Tensor:
        tp = model.tensor_parallel
        named = [(k, p.grad) for k, p in model.named_parameters() if p.grad is not None]
        sharded = squares([g for k, g in named if k in tp.plan])
        norm = (squares([g for k, g in named if k not in tp.plan])
                + tp.mp.all_reduce(sharded)).sqrt()
        scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
        torch._foreach_mul_([g for _, g in named], scale)
        return norm

    return clip


# ------------------------------------------------------ sequence parallelism


def time_sharded(mel: torch.Tensor, n: int, index: int, context: int,
                 causal: bool = True) -> Tuple[torch.Tensor, int, int]:
    """Rank ``index`` of ``n``'s share of a (B, T, C) mel along time: the
    frames [s, e) of its ceil(T / n) chunk, widened by ``context`` frames on
    the left (and, for a non-causal generator, the right) as far as the
    utterance goes. -> (window, s - window start, e - s). The windows hold
    real frames only: implicit padding at a window's edge differs from the
    utterance's frames for up to the receptive field, which ``context``
    covers."""
    T = int(mel.shape[1])
    chunk = -(-T // n)
    s, e = min(index * chunk, T), min((index + 1) * chunk, T)
    a = max(0, s - context)
    b = e if causal else min(T, e + context)
    return mel[:, a:b], s - a, e - s


def _context(generator: nn.Module) -> int:
    from kantts_tpu_torch.infer.streaming import generator_receptive_field

    # the causal bound covers each side of the non-causal stack: every conv
    # reaches no further to either side than its causal twin reaches back;
    # NSF's strided source convs add at most 2 frames, padded to 4 as in
    # infer/chunked.py
    return generator_receptive_field(generator) + (4 if generator.nsf_params else 0)


@torch.no_grad()
def sequence_parallel_apply(generator: nn.Module, mel: torch.Tensor,
                            group: Optional[dist.ProcessGroup] = None,
                            rng: Optional[torch.Generator] = None,
                            excitation: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """One utterance's generator forward, mel (1, T, C) split along time over
    ``group`` (the world by default) -> wav (1, T * hop, 1) on every rank,
    equal to ``generator(mel)``. Each rank runs the generator once on its
    ``time_sharded`` window, keeps the samples of its own frames, and one
    ``all_gather`` joins them. An NSF generator takes its source from the
    whole utterance, as ``infer/chunked.py`` does: ``excitation`` (1, T * hop,
    1), or drawn from ``rng`` on the group's first rank and broadcast.
    Without a process group it is the plain call."""
    if generator.out_channels != 1:
        raise ValueError("sequence-parallel vocoding takes a fullband generator "
                         "(PQMF multi-band is whole-utterance only)")
    if not is_distributed():
        return generator(mel, excitation=excitation, generator=rng)
    n, index = dist.get_world_size(group), dist.get_rank(group)
    hop = int(torch.tensor(generator.upsample_scales).prod())
    T = int(mel.shape[1])
    if generator.nsf_params is not None and excitation is None:
        first = 0 if group is None else dist.get_global_rank(group, 0)
        excitation = (generator(mel, excitation_only=True, generator=rng)
                      if index == 0 else mel.new_empty((1, T * hop, 1)))
        dist.broadcast(excitation, first, group=group)
    window, lead, length = time_sharded(mel, n, index, _context(generator),
                                        generator.causal)
    chunk = -(-T // n)
    piece = mel.new_zeros((1, chunk * hop, 1))
    if length > 0:
        a = index * chunk - lead  # the window's first frame
        exc = (excitation[:, a * hop:(a + int(window.shape[1])) * hop]
               if excitation is not None else None)
        y = generator(window, excitation=exc)
        piece[:, :length * hop] = y[:, lead * hop:(lead + length) * hop]
    pieces = [torch.empty_like(piece) for _ in range(n)]
    dist.all_gather(pieces, piece, group=group)
    return torch.cat(pieces, dim=1)[:, :T * hop]
