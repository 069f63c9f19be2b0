"""Learning-rate schedules (counterpart of ``kantts_tpu/train/schedulers.py``)
as factors for ``torch.optim.lr_scheduler.LambdaLR``.

Each builder returns ``factor(k)``, the multiple of the base rate that
update ``k`` uses, counting updates from 0: LambdaLR applies ``factor(0)``
to the first ``optimizer.step()`` and ``factor(k)`` after k calls of
``scheduler.step()``, which is the count optax passes to its schedules.
"""

from __future__ import annotations

import bisect
from typing import Any, Callable, Dict, Sequence

Factor = Callable[[int], float]


def noam_lr(warmup_steps: int) -> Factor:
    """warmup^0.5 * min(k^-0.5, k * warmup^-1.5), with k clamped to >= 1."""

    def factor(count: int) -> float:
        step = max(count, 1)
        return warmup_steps ** 0.5 * min(step ** -0.5, step * warmup_steps ** -1.5)

    return factor


def find_lr(base_lr: float, max_steps: int, max_lr: float = 10.0) -> Factor:
    """Exponential sweep from ``base_lr`` to ``max_lr`` over ``max_steps``."""

    def factor(count: int) -> float:
        return (max_lr / base_lr) ** (count / (max_steps - 1))

    return factor


def multistep_lr(milestones: Sequence[int], gamma: float = 0.1) -> Factor:
    ms = sorted(milestones)

    def factor(count: int) -> float:
        return gamma ** bisect.bisect_right(ms, count)

    return factor


def step_lr(step_size: int, gamma: float = 0.1) -> Factor:
    def factor(count: int) -> float:
        return gamma ** (count // step_size)

    return factor


def exponential_lr(gamma: float) -> Factor:
    def factor(count: int) -> float:
        return gamma ** count

    return factor


def constant_lr() -> Factor:
    def factor(count: int) -> float:
        return 1.0

    return factor


_SCHEDULERS = {
    "NoamLR": lambda base_lr, p: noam_lr(p["warmup_steps"]),
    "FindLR": lambda base_lr, p: find_lr(base_lr, p["max_steps"],
                                         p.get("max_lr", 10.0)),
    "MultiStepLR": lambda base_lr, p: multistep_lr(p["milestones"],
                                                   p.get("gamma", 0.1)),
    "StepLR": lambda base_lr, p: step_lr(p["step_size"], p.get("gamma", 0.1)),
    "ExponentialLR": lambda base_lr, p: exponential_lr(p["gamma"]),
    "ConstantLR": lambda base_lr, p: constant_lr(),
}


def scheduler_builder(name: str, base_lr: float, params: Dict[str, Any]) -> Factor:
    if name not in _SCHEDULERS:
        raise ValueError(f"Unknown scheduler: {name}")
    return _SCHEDULERS[name](base_lr, params or {})
