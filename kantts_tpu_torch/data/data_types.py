"""File-type loader registry (a copy of ``kantts_tpu/data/data_types.py``):
registered loaders for txt/wav/npy/bin payloads, kept for API
completeness; the data path reads npy and wav directly."""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def load_txt(path: str) -> list[str]:
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f]


def load_wav(path: str) -> np.ndarray:
    from kantts_tpu_torch.utils.audio import read_wav

    return read_wav(path)[1]


def load_npy(path: str) -> np.ndarray:
    return np.load(path)


def load_bin(path: str, dtype=np.float32) -> np.ndarray:
    return np.fromfile(path, dtype=dtype)


DATA_TYPE_DICT: Dict[str, Callable] = {
    "txt": load_txt,
    "wav": load_wav,
    "npy": load_npy,
    "bin": load_bin,
}


def get_loader(ext: str) -> Callable:
    if ext not in DATA_TYPE_DICT:
        raise KeyError(f"no loader registered for .{ext}")
    return DATA_TYPE_DICT[ext]
