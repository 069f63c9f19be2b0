"""Weight bridge from the JAX package: JAX param trees -> state dicts of the
port.

``kantts_tpu/utils/torch_convert.py`` maps a KAN-TTS state dict onto JAX
params, moving every number by a transpose or a reshape. Its inverse is
derived here from the converter itself, so the two cannot disagree: a probe
state dict whose entries are their own flat indices (unique over the whole
dict) goes through the converter, and each JAX leaf then says which torch
entry every one of its numbers came from.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from kantts_tpu.utils.torch_convert import (
    convert_hifigan_generator,
    convert_sambert,
)
from kantts_tpu_torch.models.hifigan.generator import Generator
from kantts_tpu_torch.models.sambert.sambert import KanTtsSAMBERT


def _leaves(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _leaves(v, path)
        else:
            yield path, v


def _invert(convert: Callable, template: Dict[str, torch.Tensor],
            params_np: Mapping, cfg: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    sizes = [t.numel() for t in template.values()]
    starts = np.cumsum([0] + sizes)
    probe = {k: np.arange(s, s + n, dtype=np.float64).reshape(tuple(t.shape))
             for (k, t), s, n in zip(template.items(), starts, sizes)}
    index = dict(_leaves(convert(probe, cfg)))
    params = dict(_leaves(params_np))
    if index.keys() != params.keys():
        raise KeyError("param tree does not match the config: missing "
                       f"{sorted(index.keys() - params.keys())}, unexpected "
                       f"{sorted(params.keys() - index.keys())}")
    flat = np.zeros(int(starts[-1]), dtype=np.float32)
    filled = np.zeros(int(starts[-1]), dtype=bool)
    for path, idx in index.items():
        value = np.asarray(params[path], dtype=np.float32)
        if value.shape != idx.shape:
            raise ValueError(f"{path}: shape {value.shape}, expected {idx.shape}")
        pos = idx.astype(np.int64).ravel()
        flat[pos] = value.ravel()
        filled[pos] = True
    if not filled.all():
        raise ValueError("the converter leaves some state-dict entries unset")
    return {k: torch.from_numpy(flat[s:s + n].reshape(tuple(t.shape)).copy())
            for (k, t), s, n in zip(template.items(), starts, sizes)}


def sambert_state_dict_from_jax(params_np: Mapping, cfg: Dict[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """JAX KanTtsSAMBERT params (numpy leaves) -> a state dict that
    ``KanTtsSAMBERT(cfg)`` loads with ``strict=True``. ``cfg`` is the model's
    params dict."""
    with torch.device("meta"):
        template = KanTtsSAMBERT(cfg).state_dict()
    return _invert(convert_sambert, template, params_np, cfg)


def hifigan_state_dict_from_jax(params_np: Mapping, cfg: Dict[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """JAX Generator params (numpy leaves) -> a state dict that
    ``Generator(**cfg)`` loads with ``strict=True``. ``cfg`` is the
    generator's params dict."""
    with torch.device("meta"):
        template = Generator(**cfg).state_dict()
    return _invert(convert_hifigan_generator, template, params_np, cfg)
