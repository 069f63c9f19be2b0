"""Pipeline parallelism, the GPipe schedule, over ``torch.distributed``
(counterpart of ``kantts_tpu/parallel/pp.py``).

The JAX package stacks a stack's identical layers on a leading axis, shards
them over a ``pipe`` mesh axis and runs the microbatch schedule in one
``shard_map`` program, handing activations on with ``ppermute``. Here each
rank of a pipe group (``make_pipe_mesh``) is a stage that applies its L / S
consecutive layers of the stack (``stack_layer_params``) to each of M
microbatches in turn: stage s takes microbatch m from stage s - 1 with a
blocking ``recv`` and hands its output to stage s + 1 with ``send``, so
stage s works on microbatch t - s at tick t, as in the JAX schedule. The
last stage's output is broadcast to every stage.

The hand-offs are ``torch.autograd.Function``s: the backward of a receive
sends its gradient upstream, the backward of a send receives the gradient
from downstream, so the same call trains. Autograd runs the microbatches'
backwards from the last to the first on every stage (its ready queue takes
the latest node first), so the gradients' sends and receives pair up in
order. The broadcast's backward takes the last stage's own gradient: every
stage is expected to compute the same loss from the replicated output.

A gloo group moves host tensors only in ``send``/``recv``; holding CUDA
tensors (two ranks sharing a card), the hand-offs stage through host
buffers, and the first logs that it does. NCCL sends device tensors.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.utils._pytree import tree_map

PIPE_AXIS = "pipe"


@dataclass
class PipeGroup:
    """The pipe group: its global ranks in stage order and this rank's stage."""
    group: Optional[dist.ProcessGroup]
    ranks: List[int]
    stage: int

    @property
    def n_stages(self) -> int:
        return len(self.ranks)

    def staged(self, x: torch.Tensor) -> bool:
        """Whether a hand-off of ``x`` goes through host memory."""
        return x.is_cuda and dist.get_backend(self.group) == "gloo"


def make_pipe_mesh(n_pipe: int) -> PipeGroup:
    """A pipe group over ranks [0, n_pipe) of the world, stage = rank. Every
    rank calls it (``new_group``'s rule); a rank outside gets stage -1."""
    ranks = list(range(n_pipe))
    if n_pipe > dist.get_world_size():
        raise ValueError(f"{n_pipe} stages need {n_pipe} ranks, "
                         f"the world has {dist.get_world_size()}")
    group = dist.new_group(ranks)
    me = dist.get_rank()
    return PipeGroup(group, ranks, ranks.index(me) if me in ranks else -1)


def stack_layer_params(params: Mapping[str, torch.Tensor], prefix: str,
                       n_layer: int) -> Dict[str, torch.Tensor]:
    """``params[f"{prefix}{i}.{name}"]`` for i in [0, n_layer) stacked on a
    new leading axis, under ``name``: the layout ``pipeline_apply`` folds
    over the stages. The layers must be alike (the FFT stacks' are:
    ``fft.0`` .. ``fft.{N-1}``, one shape). Stacking is differentiable, so
    the gradients reach ``params``."""
    first = f"{prefix}0."
    names = [k[len(first):] for k in params if k.startswith(first)]
    return {name: torch.stack([params[f"{prefix}{i}.{name}"] for i in range(n_layer)])
            for name in names}


_logged_staging = False


def _send(x: torch.Tensor, pipe: PipeGroup, stage: int, tag: int) -> None:
    global _logged_staging
    dst = pipe.ranks[stage]
    if pipe.staged(x):
        if not _logged_staging:
            logging.info("pipeline hand-offs stage through host memory: a gloo "
                         "group holding CUDA tensors")
            _logged_staging = True
        x = x.cpu()
    dist.send(x.contiguous(), dst, group=pipe.group, tag=tag)


def _recv(like: torch.Tensor, pipe: PipeGroup, stage: int, tag: int) -> torch.Tensor:
    src = pipe.ranks[stage]
    if pipe.staged(like):
        buf = torch.empty(like.shape, dtype=like.dtype)
        dist.recv(buf, src, group=pipe.group, tag=tag)
        return buf.to(like.device)
    buf = torch.empty_like(like)
    dist.recv(buf, src, group=pipe.group, tag=tag)
    return buf


class _Send(torch.autograd.Function):
    """Hand ``x`` to the next stage; -> a token that ties the send into the
    graph. Backward: the gradient of ``x`` from the next stage."""

    @staticmethod
    def forward(ctx, x, pipe, tag):
        ctx.pipe, ctx.tag, ctx.like = pipe, tag, torch.empty_like(x)
        _send(x, pipe, pipe.stage + 1, tag)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        return _recv(ctx.like, ctx.pipe, ctx.pipe.stage + 1, ctx.tag), None, None


class _Recv(torch.autograd.Function):
    """Take an activation shaped like ``like`` from the previous stage
    (``anchor`` only puts the receive in the graph). Backward: send its
    gradient back."""

    @staticmethod
    def forward(ctx, anchor, like, pipe, tag):
        ctx.pipe, ctx.tag = pipe, tag
        return _recv(like, pipe, pipe.stage - 1, tag)

    @staticmethod
    def backward(ctx, grad):
        _send(grad, ctx.pipe, ctx.pipe.stage - 1, ctx.tag)
        return None, None, None, None


class _Broadcast(torch.autograd.Function):
    """The last stage's output on every stage. Backward: the last stage
    keeps its own gradient; a token (an earlier stage's sends) gets zeros,
    which starts its send's backward."""

    @staticmethod
    def forward(ctx, out, pipe, *tokens):
        ctx.pipe, ctx.n_tokens = pipe, len(tokens)
        buf = out.clone() if pipe.stage == pipe.n_stages - 1 else torch.empty_like(out)
        dist.broadcast(buf, pipe.ranks[-1], group=pipe.group)
        return buf

    @staticmethod
    def backward(ctx, grad):
        last = ctx.pipe.stage == ctx.pipe.n_stages - 1
        tokens = [grad.new_zeros(()) for _ in range(ctx.n_tokens)]
        return (grad if last else None), None, *tokens


def pipeline_apply(layer_fn: Callable[[Dict[str, torch.Tensor], torch.Tensor, Any],
                                      torch.Tensor],
                   stacked_params: Mapping[str, torch.Tensor], h: torch.Tensor,
                   n_microbatches: int, pipe: PipeGroup, extras: Any = None
                   ) -> torch.Tensor:
    """GPipe application of L stacked layers, returning on every stage what
    applying them in sequence returns.

    ``layer_fn(layer_params, h, extras) -> h`` is one layer's forward, shape
    kept; ``stacked_params`` values are (L, ...); ``h`` is (B, ...) with B
    divisible by ``n_microbatches``; ``extras`` is a pytree of per-item side
    inputs (leading axis B, such as masks) that each stage slices per
    microbatch itself. Every stage passes the same ``h`` and ``extras`` (only
    the first reads ``h``) and takes part until the end."""
    S = pipe.n_stages
    L = int(next(iter(stacked_params.values())).shape[0])
    if L % S:
        raise ValueError(f"{L} layers do not fold onto {S} pipeline stages")
    B, M = int(h.shape[0]), int(n_microbatches)
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    lps, mb, s = L // S, B // M, pipe.stage
    mine = {k: v[s * lps:(s + 1) * lps] for k, v in stacked_params.items()}
    differentiable = torch.is_grad_enabled() and (
        h.requires_grad or any(v.requires_grad for v in mine.values()))
    anchor = h.new_zeros((), requires_grad=True) if differentiable else None
    like = h[:mb]
    outs, tokens = [], []
    for m in range(M):
        ex = tree_map(lambda e: e[m * mb:(m + 1) * mb], extras)
        if s == 0:
            x = h[m * mb:(m + 1) * mb]
        elif differentiable:
            x = _Recv.apply(anchor, like, pipe, m)
        else:
            x = _recv(like, pipe, s - 1, m)
        for i in range(lps):
            x = layer_fn({k: v[i] for k, v in mine.items()}, x, ex)
        if s == S - 1:
            outs.append(x)
        elif differentiable:
            tokens.append(_Send.apply(x, pipe, m))
        else:
            _send(x, pipe, s + 1, m)
    out = torch.cat(outs) if outs else torch.empty_like(h)
    if differentiable:
        return _Broadcast.apply(out, pipe, *tokens)
    dist.broadcast(out, pipe.ranks[-1], group=pipe.group)
    return out


def sambert_encoder_pipeline(encoder: nn.Module, x: torch.Tensor,
                             mask: Optional[torch.Tensor], pipe: PipeGroup,
                             n_microbatches: int) -> torch.Tensor:
    """The pipelined forward of a ``SelfAttentionEncoder`` (its FFT blocks
    over ``pipe``), without dropout, equal to the module's forward in eval
    mode: scale, sinusoidal positions, the N FFT blocks, the final float32
    LayerNorm. The blocks must be alike (the encoder's input width its
    ``d_model``). x (B, T, d_model), mask (B, T) True at padding."""
    from kantts_tpu_torch.models.sambert.positions import add_sinusoidal_position

    n_layer = len(encoder.fft)
    template = encoder.fft[0]
    h = add_sinusoidal_position(x * math.sqrt(encoder.d_model), encoder.max_len)
    stacked = stack_layer_params(dict(encoder.fft.named_parameters()), "", n_layer)

    def layer_fn(params, hc, m):
        return torch.func.functional_call(template, params, (hc, m))[0]

    was = template.training
    template.eval()
    try:
        h = pipeline_apply(layer_fn, stacked, h, n_microbatches, pipe, extras=mask)
    finally:
        template.train(was)
    return encoder.ln(h.float())
