"""Optimizer construction from the KAN-TTS config (counterpart of
``kantts_tpu/train/optim.py``).

The config names a ``torch.optim`` class with its params and a schedule by
name. The update is the one the JAX package's optax chain makes:

- Adam's ``weight_decay`` is L2 added to the gradient (``torch.optim.Adam``);
- AdamW's is decoupled decay (``torch.optim.AdamW``; its default decay is
  not used: a config without ``weight_decay`` has none);
- SGD takes ``momentum`` and ``nesterov``;
- the gradient is clipped to a global norm before the update, as optax's
  ``clip_by_global_norm`` does: scaled by max_norm / norm when the norm is
  at least max_norm, with no epsilon added to the norm.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch.optim.lr_scheduler import LambdaLR

from kantts_tpu_torch.train.schedulers import scheduler_builder

Clip = Callable[[], torch.Tensor]


def global_grad_norm(params: Iterable[torch.nn.Parameter]) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient, as a device scalar."""
    grads = [p.grad for p in params if p.grad is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm(params: Iterable[torch.nn.Parameter],
                        max_norm: float) -> torch.Tensor:
    """Scale every gradient in place so that the global norm is at most
    ``max_norm``; returns the norm before clipping. No host sync."""
    params = [p for p in params if p.grad is not None]
    norm = global_grad_norm(params)
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_([p.grad for p in params], scale)
    return norm


def optimizer_builder(params: Iterable[torch.nn.Parameter],
                      opt_config: Dict[str, Any],
                      sched_config: Optional[Dict[str, Any]],
                      grad_norm: Optional[float] = None
                      ) -> Tuple[torch.optim.Optimizer, LambdaLR, Optional[Clip]]:
    """-> (optimizer, its LambdaLR scheduler, clip). ``clip()`` clips the
    gradients of ``params`` and returns their norm before clipping; it is
    None without a positive ``grad_norm``. Call clip, ``optimizer.step()``,
    then ``scheduler.step()``."""
    params = list(params)
    opt_type = opt_config.get("type", "Adam")
    p = dict(opt_config.get("params", {}))
    base_lr = p.get("lr", 1e-3)
    wd = p.get("weight_decay", 0.0)
    if opt_type in ("Adam", "AdamW"):
        cls = torch.optim.Adam if opt_type == "Adam" else torch.optim.AdamW
        optimizer = cls(params, lr=base_lr, betas=tuple(p.get("betas", (0.9, 0.999))),
                        eps=p.get("eps", 1e-8), weight_decay=wd)
    elif opt_type == "SGD":
        optimizer = torch.optim.SGD(params, lr=base_lr,
                                    momentum=p.get("momentum", 0.0),
                                    nesterov=p.get("nesterov", False),
                                    weight_decay=wd)
    else:
        raise ValueError(f"Unsupported optimizer: {opt_type}")

    if sched_config:
        factor = scheduler_builder(sched_config["type"], base_lr,
                                   sched_config.get("params", {}))
    else:
        factor = scheduler_builder("ConstantLR", base_lr, {})
    scheduler = LambdaLR(optimizer, factor)

    clip = None
    if grad_norm is not None and grad_norm > 0:
        def clip() -> torch.Tensor:
            return clip_by_global_norm(params, grad_norm)
    return optimizer, scheduler, clip
