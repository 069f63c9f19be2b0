"""Weight bridge from the JAX package: JAX param trees -> state dicts of the
port.

``utils/torch_convert.py`` (a copy of the JAX package's) maps a KAN-TTS state dict onto JAX
params, moving every number by a transpose or a reshape. Its inverse is
derived here from the converter itself, so the two cannot disagree: a probe
state dict whose entries are their own flat indices (unique over the whole
dict) goes through the converter, and each JAX leaf then says which torch
entry every one of its numbers came from.

The discriminators' converters know weight norm only. A spectral-normed conv
is shown to them as a weight-normed one (``weight_orig`` as ``weight_v``
with a dummy gain, whose JAX leaf is then dropped), and its power-iteration
vector ``weight_u`` is copied from the JAX ``spectral`` collection, which
has the same shape.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from kantts_tpu_torch.models.hifigan.discriminators import (
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    MultiSpecDiscriminator,
)
from kantts_tpu_torch.models.hifigan.generator import Generator
from kantts_tpu_torch.models.sambert.sambert import KanTtsSAMBERT, KanTtsTextsyBERT
from kantts_tpu_torch.utils.torch_convert import (
    _wnconv_raw,
    convert_hifigan_generator,
    convert_mpd,
    convert_msd,
    convert_sambert,
    convert_sybert,
)


def _leaves(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _leaves(v, path)
        else:
            yield path, v


def _invert(convert: Callable, template: Mapping[str, torch.Tensor],
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


def sybert_state_dict_from_jax(params_np: Mapping, cfg: Dict[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """JAX KanTtsTextsyBERT params (numpy leaves) -> a state dict that
    ``KanTtsTextsyBERT(cfg)`` loads with ``strict=True``. ``cfg`` is the
    model's params dict."""
    with torch.device("meta"):
        template = KanTtsTextsyBERT(cfg).state_dict()
    return _invert(convert_sybert, template, params_np, cfg)


def hifigan_state_dict_from_jax(params_np: Mapping, cfg: Dict[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """JAX Generator params (numpy leaves) -> a state dict that
    ``Generator(**cfg)`` loads with ``strict=True``. ``cfg`` is the
    generator's params dict."""
    with torch.device("meta"):
        template = Generator(**cfg).state_dict()
    return _invert(convert_hifigan_generator, template, params_np, cfg)


def _jax_path(prefix: str) -> str:
    """``discriminators.0.convs.3.0`` -> ``discriminators_0/convs_3``;
    ``discriminators.0.conv_post`` -> ``discriminators_0/conv_post``."""
    parts = prefix.split(".")
    if len(parts) >= 3 and parts[-3] == "convs" and parts[-1] == "0":
        parts = parts[:-1]  # the conv inside its (conv, activation) pair
    names, i = [], 0
    while i < len(parts):
        if i + 1 < len(parts) and parts[i + 1].isdigit():
            names.append(f"{parts[i]}_{parts[i + 1]}")
            i += 2
        else:
            names.append(parts[i])
            i += 1
    return "/".join(names)


def _leaf(tree: Mapping, path: str) -> Any:
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _disc_state_dict_from_jax(module, convert: Callable, params_np: Mapping,
                              spectral: Optional[Mapping]
                              ) -> Dict[str, torch.Tensor]:
    full = module.state_dict()
    spectral_prefixes = [k[:-len(".weight_u")] for k in full
                         if k.endswith(".weight_u")]
    template = {k: t for k, t in full.items() if not k.endswith(".weight_u")}

    def as_weight_norm(sd, cfg):
        sd = dict(sd)
        for prefix in spectral_prefixes:
            v = sd.pop(f"{prefix}.weight_orig")
            sd[f"{prefix}.weight_v"] = v
            sd[f"{prefix}.weight_g"] = np.zeros((v.shape[0],) + (1,) * (v.ndim - 1))
        tree = convert(sd)
        for prefix in spectral_prefixes:
            del _leaf(tree, _jax_path(prefix))["kernel_g"]
        return tree

    out = _invert(as_weight_norm, template, params_np, {})
    if spectral_prefixes and not spectral:
        raise KeyError("spectral-normed convs need the JAX 'spectral' collection")
    for prefix in spectral_prefixes:
        u = np.asarray(_leaf(spectral, _jax_path(prefix))["u"], dtype=np.float32)
        out[f"{prefix}.weight_u"] = torch.from_numpy(u.copy())
    return {k: out[k] for k in full}


def mpd_state_dict_from_jax(params_np: Mapping, cfg: Dict[str, Any],
                            spectral: Optional[Mapping] = None
                            ) -> Dict[str, torch.Tensor]:
    """JAX MultiPeriodDiscriminator params (and its ``spectral`` collection,
    with ``use_spectral_norm``) -> a state dict that
    ``MultiPeriodDiscriminator(**cfg)`` loads with ``strict=True``."""
    with torch.device("meta"):
        module = MultiPeriodDiscriminator(**cfg)
    periods = [d.period for d in module.discriminators]
    n_downs = len(module.discriminators[0].convs)
    return _disc_state_dict_from_jax(
        module, lambda sd: convert_mpd(sd, periods, n_downs), params_np, spectral)


def msd_state_dict_from_jax(params_np: Mapping, cfg: Dict[str, Any],
                            spectral: Optional[Mapping] = None
                            ) -> Dict[str, torch.Tensor]:
    """JAX MultiScaleDiscriminator params (and, with
    ``follow_official_norm``, its ``spectral`` collection) -> a state dict
    that ``MultiScaleDiscriminator(**cfg)`` loads with ``strict=True``."""
    with torch.device("meta"):
        module = MultiScaleDiscriminator(**cfg)
    scales = len(module.discriminators)
    n_downs = len(module.discriminators[0].convs) - 2
    return _disc_state_dict_from_jax(
        module, lambda sd: convert_msd(sd, scales, n_downs, module.dwt),
        params_np, spectral)


def _convert_mspecd(sd: Mapping[str, np.ndarray], n_resolutions: int,
                    n_convs: int) -> Dict[str, Any]:
    """The forward map of a weight-normed MultiSpecDiscriminator: torch
    ``discriminators.{i}.convs.{j}.0`` and ``discriminators.{i}.conv_post``
    -> JAX ``discriminators_{i}/convs_{j}`` and ``discriminators_{i}/conv_post``."""
    tree: Dict[str, Any] = {}
    for i in range(n_resolutions):
        for j in range(n_convs):
            _wnconv_raw(tree, f"discriminators_{i}/convs_{j}", sd,
                        f"discriminators.{i}.convs.{j}.0", ndim=4)
        _wnconv_raw(tree, f"discriminators_{i}/conv_post", sd,
                    f"discriminators.{i}.conv_post", ndim=4)
    return tree


def mspecd_state_dict_from_jax(params_np: Mapping, cfg: Dict[str, Any],
                               spectral: Optional[Mapping] = None
                               ) -> Dict[str, torch.Tensor]:
    """JAX MultiSpecDiscriminator params (and, with ``use_spectral_norm``,
    its ``spectral`` collection) -> a state dict that
    ``MultiSpecDiscriminator(**cfg)`` loads with ``strict=True``. The JAX
    package has no converter for this discriminator, so the names are the
    port's: its module tree in the pattern of the MPD and MSD state dicts,
    which ``_convert_mspecd`` maps onto the JAX module tree."""
    with torch.device("meta"):
        module = MultiSpecDiscriminator(**cfg)
    n_resolutions = len(module.discriminators)
    n_convs = len(module.discriminators[0].convs)
    return _disc_state_dict_from_jax(
        module, lambda sd: _convert_mspecd(sd, n_resolutions, n_convs),
        params_np, spectral)
