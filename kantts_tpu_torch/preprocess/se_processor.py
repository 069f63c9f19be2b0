"""Speaker embeddings: Kaldi fbank -> D-TDNN x-vector -> a 192-d embedding
per utterance and the corpus mean ``se/se.npy`` (counterpart of
``kantts_tpu/preprocess/se_processor.py``).

``kaldi_fbank`` is a copy (numpy, torchaudio.compliance.kaldi.fbank's
defaults: 25 ms povey windows, 10 ms shift, snip edges, DC removal, 0.97
pre-emphasis, HTK mel from 20 Hz). ``DTDNN`` is the network of
``dtdnn_embed`` there as a ``torch.nn.Module`` in inference mode: the FCM
head (a 2-D ResNet over frequency and time), the strided TDNN, three dense
blocks of (12, 24, 16) SE-gated layers with dilations (1, 2, 3) and their
transit layers, statistics pooling (mean and unbiased std) and the dense
layer. KAN-TTS runs it only with external pretrained weights (``se.model``,
a torch state dict), so the module takes every width from the shapes of the
state dict it is given, and its parameter names are that checkpoint's keys:
``load_se_model`` loads one straight into it.
"""

from __future__ import annotations

import logging
import os
from glob import glob
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kantts_tpu_torch.utils.audio import read_wav
from kantts_tpu_torch.utils.device import resolve_device

DENSE_BLOCKS = ((12, 1), (24, 2), (16, 3))  # (layers, dilation) of each block
SEG_LEN = 100  # frames of a segment of the SE gate's max pooling

# ----------------------------------------------------------------- fbank


def _povey_window(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))) ** 0.85


def kaldi_fbank(wav: np.ndarray, sample_rate: int = 16000,
                num_mel_bins: int = 80, frame_length_ms: float = 25.0,
                frame_shift_ms: float = 10.0, preemph: float = 0.97,
                low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Log mel filterbank, Kaldi conventions. Returns (frames, num_mel_bins)."""
    frame_len = int(sample_rate * frame_length_ms / 1000)
    frame_shift = int(sample_rate * frame_shift_ms / 1000)
    if len(wav) < frame_len:
        return np.zeros((0, num_mel_bins), dtype=np.float32)
    n_frames = 1 + (len(wav) - frame_len) // frame_shift
    idx = (np.arange(n_frames)[:, None] * frame_shift
           + np.arange(frame_len)[None, :])
    frames = wav[idx].astype(np.float64)

    frames = frames - frames.mean(axis=1, keepdims=True)  # remove DC
    pre = np.empty_like(frames)
    pre[:, 1:] = frames[:, 1:] - preemph * frames[:, :-1]
    pre[:, 0] = frames[:, 0] - preemph * frames[:, 0]
    pre *= _povey_window(frame_len)[None, :]

    n_fft = 1
    while n_fft < frame_len:
        n_fft *= 2
    spec = np.fft.rfft(pre, n=n_fft, axis=1)
    power = (spec.real ** 2 + spec.imag ** 2)

    # HTK mel triangular banks without area normalization (Kaldi style)
    if high_freq <= 0:
        high_freq = sample_rate / 2 + high_freq
    mel = lambda f: 1127.0 * np.log(1.0 + f / 700.0)  # noqa: E731
    mel_lo, mel_hi = mel(low_freq), mel(high_freq)
    centers = np.linspace(mel_lo, mel_hi, num_mel_bins + 2)
    fft_freqs = np.arange(n_fft // 2 + 1) * sample_rate / n_fft
    fft_mels = mel(fft_freqs)
    weights = np.zeros((num_mel_bins, n_fft // 2 + 1))
    for b in range(num_mel_bins):
        left, center, right = centers[b], centers[b + 1], centers[b + 2]
        up = (fft_mels - left) / (center - left)
        down = (right - fft_mels) / (right - center)
        weights[b] = np.clip(np.minimum(up, down), 0.0, None)

    fbank = power @ weights.T
    return np.log(np.maximum(fbank, np.finfo(np.float64).eps)).astype(np.float32)


# -------------------------------------------------------------- D-TDNN net


class BatchNormEval(nn.Module):
    """Inference-mode BatchNorm over axis 1 with the state-dict keys
    ``running_mean``, ``running_var`` and, when affine, ``weight`` and
    ``bias``."""

    def __init__(self, channels: int, affine: bool, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.weight = nn.Parameter(torch.ones(channels)) if affine else None
        self.bias = nn.Parameter(torch.zeros(channels)) if affine else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, self.eps)


class _Node(nn.Module):
    """A named container, so that module paths spell the checkpoint keys."""

    def __init__(self, **children: nn.Module):
        super().__init__()
        for name, child in children.items():
            self.add_module(name, child)


def _bn(sd, prefix: str) -> BatchNormEval:
    return BatchNormEval(sd[f"{prefix}.running_mean"].shape[0],
                         f"{prefix}.weight" in sd)


def _conv(sd, prefix: str, **kwargs) -> nn.Module:
    """The Conv1d/Conv2d of ``prefix``'s weight shape, with a bias when the
    state dict has one."""
    w = sd[f"{prefix}.weight"]
    cls = nn.Conv2d if w.ndim == 4 else nn.Conv1d
    return cls(w.shape[1], w.shape[0], tuple(w.shape[2:]),
               bias=f"{prefix}.bias" in sd, **kwargs)


def _nonlinear(sd, prefix: str) -> _Node:
    return _Node(batchnorm=_bn(sd, f"{prefix}.batchnorm"))


class _BasicBlock(nn.Module):
    def __init__(self, sd, prefix: str, stride: int):
        super().__init__()
        self.conv1 = _conv(sd, f"{prefix}.conv1", stride=(stride, 1), padding=1)
        self.bn1 = _bn(sd, f"{prefix}.bn1")
        self.conv2 = _conv(sd, f"{prefix}.conv2", padding=1)
        self.bn2 = _bn(sd, f"{prefix}.bn2")
        self.shortcut = (nn.Sequential(
            _conv(sd, f"{prefix}.shortcut.0", stride=(stride, 1)),
            _bn(sd, f"{prefix}.shortcut.1"))
            if f"{prefix}.shortcut.0.weight" in sd else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + (x if self.shortcut is None else self.shortcut(x)))


class _SEDenseLayer(nn.Module):
    """BN-ReLU-1x1 bottleneck, BN-ReLU, then the SE-gated dilated TDNN conv
    whose gate sees the utterance mean plus the segment maxima."""

    def __init__(self, sd, prefix: str, dilation: int):
        super().__init__()
        self.nonlinear1 = _nonlinear(sd, f"{prefix}.nonlinear1")
        self.linear1 = _conv(sd, f"{prefix}.linear1")
        self.nonlinear2 = _nonlinear(sd, f"{prefix}.nonlinear2")
        k = sd[f"{prefix}.se.linear_stem.weight"].shape[-1]
        self.se = _Node(
            linear_stem=_conv(sd, f"{prefix}.se.linear_stem",
                              padding=(k - 1) // 2 * dilation, dilation=dilation),
            linear1=_conv(sd, f"{prefix}.se.linear1"),
            linear2=_conv(sd, f"{prefix}.se.linear2"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.linear1(F.relu(self.nonlinear1.batchnorm(x)))
        h = F.relu(self.nonlinear2.batchnorm(h))
        y = self.se.linear_stem(h)
        s = h.mean(-1, keepdim=True) + seg_pooling(h)
        s = torch.sigmoid(self.se.linear2(F.relu(self.se.linear1(s))))
        return y * s


def seg_pooling(x: torch.Tensor, seg_len: int = SEG_LEN) -> torch.Tensor:
    """Max over segments of ``seg_len`` frames (the last padded with -inf),
    repeated back to the frame rate: (B, C, T) -> (B, C, T)."""
    T = x.shape[-1]
    n_seg = -(-T // seg_len)
    xp = F.pad(x, (0, n_seg * seg_len - T), value=float("-inf"))
    seg_max = xp.reshape(*x.shape[:-1], n_seg, seg_len).amax(-1, keepdim=True)
    return seg_max.expand(*x.shape[:-1], n_seg, seg_len).reshape(xp.shape)[..., :T]


class DTDNN(nn.Module):
    """D-TDNN speaker embedder, built from (and loaded with) a state dict
    whose keys are those of KAN-TTS's ``se.model``."""

    def __init__(self, state_dict: Dict[str, torch.Tensor]):
        super().__init__()
        sd = state_dict
        self.head = _Node(
            conv1=_conv(sd, "head.conv1", padding=1), bn1=_bn(sd, "head.bn1"),
            layer1=nn.Sequential(*(_BasicBlock(sd, f"head.layer1.{i}", s)
                                   for i, s in enumerate((2, 1)))),
            layer2=nn.Sequential(*(_BasicBlock(sd, f"head.layer2.{i}", s)
                                   for i, s in enumerate((2, 1)))),
            conv2=_conv(sd, "head.conv2", stride=(2, 1), padding=1),
            bn2=_bn(sd, "head.bn2"))
        blocks = {}
        for bi, (n_layers, dilation) in enumerate(DENSE_BLOCKS, start=1):
            blocks[f"block{bi}"] = _Node(**{
                f"tdnnd{li}": _SEDenseLayer(sd, f"xvector.block{bi}.tdnnd{li}", dilation)
                for li in range(1, n_layers + 1)})
            blocks[f"transit{bi}"] = _Node(
                nonlinear=_nonlinear(sd, f"xvector.transit{bi}.nonlinear"),
                linear=_conv(sd, f"xvector.transit{bi}.linear"))
        self.xvector = _Node(
            tdnn=_Node(linear=_conv(sd, "xvector.tdnn.linear", stride=2, padding=2),
                       nonlinear=_nonlinear(sd, "xvector.tdnn.nonlinear")),
            **blocks,
            dense=_Node(linear=_conv(sd, "xvector.dense.linear"),
                        nonlinear=_nonlinear(sd, "xvector.dense.nonlinear")))
        self.bn = _bn(sd, "bn")
        missing, _ = self.load_state_dict(sd, strict=False)
        if missing:
            raise KeyError(f"the D-TDNN state dict lacks {missing}")
        self.eval()

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        """feat (B, T, n_mels), mean-normalised fbank -> (B, embedding)."""
        head, xv = self.head, self.xvector
        x = F.relu(head.bn1(head.conv1(feat.transpose(1, 2)[:, None])))
        x = head.layer2(head.layer1(x))
        x = F.relu(head.bn2(head.conv2(x)))
        x = x.reshape(x.shape[0], -1, x.shape[-1])
        x = F.relu(xv.tdnn.nonlinear.batchnorm(xv.tdnn.linear(x)))
        for bi in range(1, len(DENSE_BLOCKS) + 1):
            for layer in getattr(xv, f"block{bi}").children():
                x = torch.cat([x, layer(x)], dim=1)
            transit = getattr(xv, f"transit{bi}")
            x = transit.linear(F.relu(transit.nonlinear.batchnorm(x)))
        x = F.relu(self.bn(x))
        stats = torch.cat([x.mean(-1), x.std(-1, unbiased=True)], dim=-1)[:, :, None]
        return xv.dense.nonlinear.batchnorm(xv.dense.linear(stats))[:, :, 0]


def load_se_model(path: str, device="cpu") -> DTDNN:
    """A ``se.model`` torch state dict -> the D-TDNN on ``device``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    return DTDNN(state).to(device)


class SpeakerEmbeddingProcessor:
    """Writes ``se/<utt>.npy`` (1, embedding) for every wav of at least
    0.3 s, and their mean ``se/se.npy``; the D-TDNN runs on ``device``
    (reference se_processor.py:18-87)."""

    def __init__(self, sample_rate: int = 16000, device="cuda"):
        self.sample_rate = sample_rate
        self.device = resolve_device(device)
        self.min_wav_length = sample_rate * 30 * 10 / 1000

    def process(self, src_voice_dir: str, se_model: str) -> None:
        logging.info("[SpeakerEmbeddingProcessor] started")
        model = load_se_model(se_model, self.device)

        wav_dir = os.path.join(src_voice_dir, "wav")
        se_dir = os.path.join(src_voice_dir, "se")
        os.makedirs(se_dir, exist_ok=True)

        se_list = []
        for wav_file in sorted(glob(os.path.join(wav_dir, "*.wav"))):
            basename = os.path.splitext(os.path.basename(wav_file))[0]
            sr, wav = read_wav(wav_file)
            if sr != 16000:
                raise ValueError(f"{wav_file}: the SE extractor expects 16 kHz, "
                                 f"got {sr}")
            if len(wav) < self.min_wav_length:
                continue
            feat = kaldi_fbank(wav, sr, num_mel_bins=80)
            feat = feat - feat.mean(axis=0, keepdims=True)
            with torch.no_grad():
                emb = model(torch.from_numpy(feat[None]).to(self.device)).cpu().numpy()
            np.save(os.path.join(se_dir, basename + ".npy"), emb)
            se_list.append(emb)

        se_average = np.mean(np.concatenate(se_list, axis=0), axis=0,
                             keepdims=True)
        np.save(os.path.join(se_dir, "se.npy"), se_average)
        logging.info("[SpeakerEmbeddingProcessor] done")
