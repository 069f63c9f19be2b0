"""Datasets, collate and loading for vocoder, acoustic-model and
Textsy-BERT training (a copy of ``kantts_tpu/data/dataset.py``: the same
metafile split, crops, buckets, masks and batches for a seed).

Input lengths round up to ``input_bucket`` and mel lengths to
``frame_bucket`` (a multiple of outputs_per_step), as in the JAX package;
masked loss reductions divide by valid counts, so padding is invisible to
training. Arrays are numpy; the DataLoader is a seeded shuffling iterator
with per-process sharding. NSF configs append frame-level f0 and uv to the
mel, as the JAX package does. An FP voice reads ``am_fprm_*.lst`` (the
fillers removed) and the ``fpadd`` metafile beside it (the fillers kept,
tagged ``emotion_disgust``): each item's FP labels come from the latter
(``get_fp_label``), and the collate builds the insertion plan.
"""

from __future__ import annotations

import glob
import math
import os
import queue
import random
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.stats import betabinom

from kantts_tpu_torch.models.sambert.fp import build_fp_insertion_plan
from kantts_tpu_torch.text.emotion_types import EMOTION_TYPES
from kantts_tpu_torch.text.ling_unit import KanTtsLinguisticUnit, get_fpdict
from kantts_tpu_torch.utils.audio import read_wav

DATASET_RANDOM_SEED = 1234


@lru_cache(maxsize=256)
def beta_binomial_prior_distribution(phoneme_count: int, mel_count: int,
                                     scaling: float = 1.0) -> np.ndarray:
    """(mel_count, phoneme_count) beta-binomial MAS prior: row i - 1 is
    ``betabinom(P, scaling * i, scaling * (M + 1 - i)).pmf(arange(P))``, all
    rows in one broadcast call, which gives the values of the JAX package's
    loop of M calls."""
    P, M = phoneme_count, mel_count
    i = np.arange(1, M + 1, dtype=np.float64)[:, None]
    return betabinom.pmf(np.arange(P)[None, :], P, scaling * i, scaling * (M + 1 - i))


class Padder:
    """Static-shape padding helpers."""

    @staticmethod
    def pad_durations(duration: np.ndarray, max_in_len: int, max_out_len: int
                      ) -> np.ndarray:
        """Stash the mel padding on the EOS slot so durations sum to the
        padded output length."""
        framenum = int(np.sum(duration))
        symbolnum = duration.shape[0]
        if framenum < max_out_len:
            pad_frames = max_out_len - framenum
            duration = np.concatenate([
                duration, [pad_frames], np.zeros(max_in_len - symbolnum - 1,
                                                 dtype=duration.dtype),
            ])
        elif symbolnum < max_in_len:
            duration = np.concatenate([
                duration, np.zeros(max_in_len - symbolnum, dtype=duration.dtype)
            ])
        return duration

    @staticmethod
    def round_up(x: int, multiple: int) -> int:
        r = x % multiple
        return x if r == 0 else x + multiple - r

    @staticmethod
    def stack_1d(xs: Sequence[np.ndarray], length: int, pad) -> np.ndarray:
        out = np.full((len(xs), length), pad, dtype=np.asarray(xs[0]).dtype)
        for i, x in enumerate(xs):
            out[i, : len(x)] = x
        return out

    @staticmethod
    def stack_2d(xs: Sequence[np.ndarray], length: int, pad) -> np.ndarray:
        out = np.full((len(xs), length, xs[0].shape[1]), pad, dtype=np.float32)
        for i, x in enumerate(xs):
            out[i, : x.shape[0]] = x
        return out


def _split_metafile(lines: List[str], split_ratio: float) -> Tuple[List[str], List[str]]:
    rng = random.Random(DATASET_RANDOM_SEED)
    lines = list(lines)
    rng.shuffle(lines)
    num_train = int(len(lines) * split_ratio) - 1
    return lines[:num_train], lines[num_train:]


def load_wav(path: str, expected_sr: Optional[int] = None) -> np.ndarray:
    """PCM/float wav -> float32 in [-1, 1]; raises on another sample rate."""
    sr, data = read_wav(path)
    if expected_sr is not None and sr != expected_sr:
        raise ValueError(f"{path}: sample rate {sr} != expected {expected_sr} "
                         "(resample offline in preprocess)")
    return data


# ------------------------------------------------------------------- vocoder


def _f0_stats(frame_f0_file: str) -> Tuple[float, float]:
    """The corpus's f0 mean and std, from ``f0/f0_mean.txt`` and
    ``f0/f0_std.txt`` beside ``frame_f0/``."""
    f0_dir = os.path.join(os.path.dirname(os.path.dirname(frame_f0_file)), "f0")
    return (np.loadtxt(os.path.join(f0_dir, "f0_mean.txt")),
            np.loadtxt(os.path.join(f0_dir, "f0_std.txt")))


class VocDataset:
    """(wav, mel) random-crop pairs; crops are fixed ``batch_max_steps``
    windows. For an NSF generator the mel carries f0 (denormalised with the
    corpus's mean and std) and uv as its last two channels."""

    def __init__(self, metafile, root_dir, config):
        self.config = config
        audio = config["audio_config"]
        self.sampling_rate = audio["sampling_rate"]
        self.n_fft = audio["n_fft"]
        self.hop_length = audio["hop_length"]
        self.batch_max_steps = config["batch_max_steps"]
        self.batch_max_frames = self.batch_max_steps // self.hop_length
        gen_params = config["Model"]["Generator"]["params"]
        self.nsf_enable = gen_params.get("nsf_params", None) is not None

        metafile = metafile if isinstance(metafile, list) else [metafile]
        root_dir = root_dir if isinstance(root_dir, list) else [root_dir]
        self.meta: List[Tuple[str, ...]] = []
        for meta, data_dir in zip(metafile, root_dir):
            if not os.path.exists(meta):
                raise ValueError(f"[VocDataset] meta file not found: {meta}")
            self.meta.extend(self._load_meta(meta, data_dir))
        if not self.meta:  # metafile-less fallback: pair wav/ with mel/
            for data_dir in root_dir:
                self.meta.extend(self.load_meta_from_dir(
                    os.path.join(data_dir, "wav"), os.path.join(data_dir, "mel")))

        self.allow_cache = config.get("allow_cache", False)
        self.caches: List[Tuple] = [() for _ in self.meta] if self.allow_cache else []

    @staticmethod
    def load_meta_from_dir(wav_dir, mel_dir):
        items = []
        for wav_file in sorted(glob.glob(os.path.join(wav_dir, "*.wav"))):
            index = os.path.splitext(os.path.basename(wav_file))[0]
            mel_file = os.path.join(mel_dir, index + ".npy")
            if os.path.exists(mel_file):
                base = os.path.dirname(wav_dir)
                items.append((
                    wav_file, mel_file,
                    os.path.join(base, "frame_f0", index + ".npy"),
                    os.path.join(base, "frame_uv", index + ".npy"),
                ))
        return items

    @staticmethod
    def gen_metafile(wav_dir, out_dir, split_ratio=0.98):
        wav_files = sorted(glob.glob(os.path.join(wav_dir, "*.wav")))
        train, valid = _split_metafile(wav_files, split_ratio)
        mel_dir = os.path.join(out_dir, "mel")
        for name, files in [("train.lst", train), ("valid.lst", valid)]:
            with open(os.path.join(out_dir, name), "w") as f:
                for wav_file in files:
                    index = os.path.splitext(os.path.basename(wav_file))[0]
                    if os.path.exists(os.path.join(mel_dir, index + ".npy")):
                        f.write(index + "\n")

    def _load_meta(self, metafile, data_dir):
        with open(metafile) as f:
            names = [line.strip() for line in f if line.strip()]
        return [(os.path.join(data_dir, "wav", name + ".wav"),
                 os.path.join(data_dir, "mel", name + ".npy"),
                 os.path.join(data_dir, "frame_f0", name + ".npy"),
                 os.path.join(data_dir, "frame_uv", name + ".npy"))
                for name in names]

    def __len__(self):
        return len(self.meta)

    def __getitem__(self, idx):
        if self.allow_cache and len(self.caches[idx]):
            return self.caches[idx]
        wav_file, mel_file, frame_f0_file, frame_uv_file = self.meta[idx]
        wav = load_wav(wav_file, self.sampling_rate)
        mel = np.load(mel_file)
        if self.nsf_enable:
            # stored frame f0 is mean/std-normalised; the source wants Hz
            f0_mean, f0_std = _f0_stats(frame_f0_file)
            f0 = np.load(frame_f0_file).reshape(-1, 1) * f0_std + f0_mean
            uv = np.load(frame_uv_file).reshape(-1, 1)
            mel = np.concatenate([mel, f0, uv], axis=1)
        if mel.shape[0] <= self.batch_max_frames:
            extra = self.batch_max_frames - mel.shape[0] + 1
            mel = np.concatenate([mel, np.zeros((extra, mel.shape[1]))], axis=0)
            wav_cache = np.zeros(mel.shape[0] * self.hop_length, dtype=np.float32)
            wav_cache[: len(wav)] = wav
            wav = wav_cache
        else:
            wav = np.pad(wav, (0, self.n_fft), mode="reflect")
            wav = wav[: len(mel) * self.hop_length]
        assert len(mel) * self.hop_length == len(wav)

        item = (wav.astype(np.float32), mel.astype(np.float32))
        if self.allow_cache:
            self.caches[idx] = item
        return item

    def collate_fn(self, batch, rng: Optional[np.random.RandomState] = None):
        """Random fixed-size crops -> (wav (B,T,1), mel (B,frames,C))."""
        rng = rng or np.random
        wavs, mels = zip(*batch)
        starts = [rng.randint(0, len(m) - self.batch_max_frames) for m in mels]
        wav_batch = np.stack([
            w[s * self.hop_length : s * self.hop_length + self.batch_max_steps]
            for w, s in zip(wavs, starts)
        ])[..., None]
        mel_batch = np.stack([
            m[s : s + self.batch_max_frames] for m, s in zip(mels, starts)
        ])
        return wav_batch.astype(np.float32), mel_batch.astype(np.float32)


def get_voc_datasets(config, root_dir, split_ratio=0.98):
    root_dir = root_dir if isinstance(root_dir, list) else [root_dir]
    train_meta, valid_meta = [], []
    for d in root_dir:
        tm, vm = os.path.join(d, "train.lst"), os.path.join(d, "valid.lst")
        if not (os.path.exists(tm) and os.path.exists(vm)):
            VocDataset.gen_metafile(os.path.join(d, "wav"), d, split_ratio)
        train_meta.append(tm)
        valid_meta.append(vm)
    return (VocDataset(train_meta, root_dir, config),
            VocDataset(valid_meta, root_dir, config))


# -------------------------------------------------------------- FP labeling


def get_fp_label(aug_ling_txt: str) -> np.ndarray:
    """Per-token FP class labels (one per token of the fillers-removed
    sequence, EOS included) from the emotion tags of the fpadd metafile."""
    tokens = aug_ling_txt.split(" ")
    emo = [t.strip("{}").split("$")[4] for t in tokens]
    syl = [t.strip("{}").split("$")[0] for t in tokens]
    emo.append(EMOTION_TYPES[0])
    syl.append("EOS")

    if emo[0] != EMOTION_TYPES[3]:
        emo[0] = EMOTION_TYPES[0]
        emo[1] = EMOTION_TYPES[0]
    for i in range(len(emo) - 2, 1, -1):
        if emo[i] != EMOTION_TYPES[3] and emo[i - 1] != EMOTION_TYPES[3]:
            emo[i] = EMOTION_TYPES[0]
        elif emo[i] != EMOTION_TYPES[3] and emo[i - 1] == EMOTION_TYPES[3]:
            emo[i] = EMOTION_TYPES[3]
            if syl[i - 2] == "ga":
                emo[i + 1] = EMOTION_TYPES[1]
            elif syl[i - 2] == "ge" and syl[i - 1] == "en_c":
                emo[i + 1] = EMOTION_TYPES[2]
            else:
                emo[i + 1] = EMOTION_TYPES[4]

    label = []
    for e in emo:
        if e == EMOTION_TYPES[0]:
            label.append(0)
        elif e == EMOTION_TYPES[1]:
            label.append(1)
        elif e == EMOTION_TYPES[2]:
            label.append(2)
        elif e == EMOTION_TYPES[3]:
            continue
        elif e == EMOTION_TYPES[4]:
            label.append(3)
    return np.asarray(label)


# -------------------------------------------------------------------- AM


class AMDataset:
    """(ling, mel, dur, f0, energy, prior, se, fp_label) items with bucketed
    collate.
    With ``NSF`` the mel carries frame f0 and uv as its last two channels;
    the ``global`` norm type maps f0 from the corpus's mean and std onto
    [nsf_f0_global_minimum, nsf_f0_global_maximum] -> [0, 1]. With ``SE``
    every item carries its corpus's speaker embedding ``se/se.npy``, which
    the collate repeats over the item's tokens in place of speaker ids. A
    byte voice has one linguistic track. An FP voice's durations, pitch and
    energy are of the spliced sequence; the collate pads them to the plan's
    length, which covers both the spliced lengths and the longest duration
    array plus its EOS stash slot."""

    def __init__(self, config, metafile, root_dir, allow_cache=False,
                 input_bucket: int = 16, frame_bucket: int = 96):
        self.config = config
        params = config["Model"]["KanTtsSAMBERT"]["params"]
        self.nsf_enable = params.get("NSF", False)
        self.nsf_norm_type = params.get("nsf_norm_type", "mean_std")
        self.nsf_f0_global_minimum = params.get("nsf_f0_global_minimum", 30.0)
        self.nsf_f0_global_maximum = params.get("nsf_f0_global_maximum", 730.0)
        self.mas_enable = params.get("MAS", False)
        self.se_enable = params.get("SE", False)
        self.fp_enable = params.get("FP", False)
        self.r = params["outputs_per_step"]
        self.input_bucket = input_bucket
        self.frame_bucket = Padder.round_up(frame_bucket, self.r)

        metafile = metafile if isinstance(metafile, list) else [metafile]
        root_dir = root_dir if isinstance(root_dir, list) else [root_dir]
        self.with_duration = True
        self.meta = []
        for meta, data_dir in zip(metafile, root_dir):
            if not os.path.exists(meta):
                raise ValueError(f"[AMDataset] meta file not found: {meta}")
            self.meta.extend(self._load_meta(meta, data_dir))

        self.ling_unit = KanTtsLinguisticUnit(config)
        if self.fp_enable:
            fpd = get_fpdict(config)
            self.fp_dict_lings = np.stack([fpd[1], fpd[2], fpd[3]]).astype(np.int32)
        self.allow_cache = allow_cache
        self.caches = [() for _ in self.meta] if allow_cache else []

    def _load_meta(self, metafile, data_dir):
        with open(metafile) as f:
            lines = [line.strip() for line in f if line.strip()]
        aug_ling = {}
        if self.fp_enable:
            with open(metafile.replace("fprm", "fpadd")) as f:
                for line in f:
                    index, txt = line.split("\t")
                    aug_ling[index] = txt
        dur_dir = os.path.join(data_dir, "duration")
        self.with_duration = (not self.mas_enable) and os.path.exists(dur_dir)
        items = []
        for line in lines:
            index, ling_txt = line.split("\t")
            items.append((
                ling_txt,
                os.path.join(data_dir, "mel", index + ".npy"),
                os.path.join(dur_dir, index + ".npy") if self.with_duration else None,
                os.path.join(data_dir, "f0", index + ".npy"),
                os.path.join(data_dir, "energy", index + ".npy"),
                os.path.join(data_dir, "frame_f0", index + ".npy"),
                os.path.join(data_dir, "frame_uv", index + ".npy"),
                os.path.join(data_dir, "se", "se.npy"),
                aug_ling.get(index),
            ))
        return items

    def __len__(self):
        return len(self.meta)

    def __getitem__(self, idx):
        if self.allow_cache and len(self.caches[idx]):
            return self.caches[idx]
        (ling_txt, mel_file, dur_file, f0_file, energy_file, frame_f0_file,
         frame_uv_file, se_path, aug_ling_txt) = self.meta[idx]
        ling_data = self.ling_unit.encode_symbol_sequence(ling_txt)
        mel = np.load(mel_file)
        dur = np.load(dur_file) if dur_file is not None else None
        attn_prior = None
        if not self.with_duration:
            attn_prior = beta_binomial_prior_distribution(len(ling_data[0]),
                                                          mel.shape[0])
        if self.nsf_enable:
            frame_f0 = np.load(frame_f0_file).reshape(-1, 1)
            if self.nsf_norm_type == "global":
                f0_mean, f0_std = _f0_stats(frame_f0_file)
                frame_f0 = (frame_f0 * f0_std + f0_mean - self.nsf_f0_global_minimum) / (
                    self.nsf_f0_global_maximum - self.nsf_f0_global_minimum)
            frame_uv = np.load(frame_uv_file).reshape(-1, 1)
            mel = np.concatenate([mel, frame_f0, frame_uv], axis=1)
        se = np.load(se_path) if self.se_enable else None
        fp_label = (get_fp_label(aug_ling_txt)
                    if self.fp_enable and aug_ling_txt is not None else None)
        item = (ling_data, mel, dur, np.load(f0_file), np.load(energy_file),
                attn_prior, se, fp_label)
        if self.allow_cache:
            self.caches[idx] = item
        return item

    @staticmethod
    def gen_metafile(raw_meta_file, out_dir, train_meta_file, valid_meta_file,
                     badlist=None, split_ratio=0.98, se_enable=False):
        """Split ``raw_meta_file`` into the train and valid metafiles, keeping
        the lines whose mel (and, where the corpus has them, duration and
        speaker embedding) exist and whose utterance is not in ``badlist``."""
        with open(raw_meta_file) as f:
            lines = f.readlines()
        train, valid = _split_metafile(lines, split_ratio)
        mel_dir = os.path.join(out_dir, "mel")
        duration_dir = os.path.join(out_dir, "duration")
        for path, subset in [(train_meta_file, train), (valid_meta_file, valid)]:
            with open(path, "w") as f:
                for line in subset:
                    index = line.split("\t")[0]
                    if badlist is not None and index in badlist:
                        continue
                    if not os.path.exists(os.path.join(mel_dir, index + ".npy")):
                        continue
                    if os.path.exists(duration_dir) and not os.path.exists(
                            os.path.join(duration_dir, index + ".npy")):
                        continue
                    if se_enable and not os.path.exists(
                            os.path.join(out_dir, "se", "se.npy")):
                        continue
                    f.write(line)

    def padded_lengths(self, batch) -> Tuple[int, int, int]:
        """The lengths ``collate_fn`` pads ``batch`` to: the input (with EOS)
        and the mel frames, each rounded up to its bucket, and an FP batch's
        spliced length (0 without FP)."""
        L_in = Padder.round_up(max(len(x[0][0]) for x in batch), self.input_bucket)
        L_mel = Padder.round_up(max(len(x[1]) for x in batch), self.frame_bucket)
        L_fp = 0
        if self.fp_enable:
            max_dur = max((len(x[2]) for x in batch if x[2] is not None), default=0)
            inter_max = max(len(x[0][0]) - 1 + 3 * int((x[7][: len(x[0][0]) - 1] > 0).sum())
                            for x in batch)
            L_fp = Padder.round_up(max(inter_max, max_dur + 1, 1), self.input_bucket)
        return L_in, L_mel, L_fp

    def collate_fn(self, batch, lengths: Optional[Sequence[int]] = None
                   ) -> Dict[str, Any]:
        """-> the batch, padded to ``padded_lengths(batch)`` or to
        ``lengths`` (in a data-parallel run the largest of every rank's, so
        that every shard is padded as the global batch is)."""
        lu = self.ling_unit
        n_ling = 1 if lu.using_byte() else 4
        lfeat_types = lu.lfeat_type_list
        L_in, L_mel, L_fp = lengths or self.padded_lengths(batch)

        def track(i):
            return Padder.stack_1d([x[0][i] for x in batch], L_in,
                                   lu.pad_id(lfeat_types[i])).astype(np.int32)

        data: Dict[str, Any] = {
            "input_lings": np.stack([track(i) for i in range(n_ling)], axis=2),
            "input_emotions": track(n_ling),
            "input_speakers": (Padder.stack_2d(
                [np.repeat(x[6][None, :], len(x[0][0]), axis=0) for x in batch],
                L_in, 0.0) if self.se_enable else track(n_ling + 1)),
            # EOS is appended to every track; it carries no duration
            "valid_input_lengths": np.asarray([len(x[0][0]) - 1 for x in batch],
                                              dtype=np.int32),
            "valid_output_lengths": np.asarray([len(x[1]) for x in batch],
                                               dtype=np.int32),
        }
        data["mel_targets"] = Padder.stack_2d([x[1] for x in batch], L_mel, 0.0)

        # FP: the host-built insertion plan (models/sambert/fp.py); its length
        # L covers the spliced sequences and the duration arrays with their
        # EOS stash slot, and pads durations, pitch and energy
        L_feats = L_in
        if self.fp_enable:
            fp_label = Padder.stack_1d([x[7] for x in batch], L_in, 0).astype(np.int32)
            src_idx, f_class, f_phase, inter_lengths, L_feats = build_fp_insertion_plan(
                fp_label, data["valid_input_lengths"], out_len=L_fp,
                bucket=self.input_bucket)
            data["fp_label"] = fp_label
            data["fp_plan"] = (src_idx, f_class, f_phase, inter_lengths)

        if self.with_duration:
            data["durations"] = np.stack([
                Padder.pad_durations(x[2], L_feats, L_mel) for x in batch
            ]).astype(np.float32)
            feats_len = L_feats
        else:
            data["durations"] = None
            feats_len = L_mel
        data["pitch_contours"] = Padder.stack_1d(
            [x[3] for x in batch], feats_len, 0.0).astype(np.float32)
        data["energy_contours"] = Padder.stack_1d(
            [x[4] for x in batch], feats_len, 0.0).astype(np.float32)

        if self.with_duration:
            data["attn_priors"] = None
        else:
            priors = np.zeros((len(batch), L_mel, L_in), dtype=np.float32)
            for i, x in enumerate(batch):
                p = x[5]
                priors[i, : p.shape[0], : p.shape[1]] = p
            data["attn_priors"] = priors
        return data


def get_am_datasets(metafile, root_dir, config, allow_cache=False,
                    split_ratio=0.98, se_enable=False, **dataset_kwargs):
    """An FP voice reads ``am_fprm_{train,valid}.lst``, which the FP
    preprocessing writes (with their ``am_fpadd_*`` twins)."""
    root_dir = root_dir if isinstance(root_dir, list) else [root_dir]
    metafile = metafile if isinstance(metafile, list) else [metafile]
    fp_enable = config["Model"]["KanTtsSAMBERT"]["params"].get("FP", False)
    train_fn = "am_fprm_train.lst" if fp_enable else "am_train.lst"
    valid_fn = "am_fprm_valid.lst" if fp_enable else "am_valid.lst"
    train_meta, valid_meta = [], []
    for raw_metafile, data_dir in zip(metafile, root_dir):
        tm = os.path.join(data_dir, train_fn)
        vm = os.path.join(data_dir, valid_fn)
        if not (os.path.exists(tm) and os.path.exists(vm)):
            AMDataset.gen_metafile(raw_metafile, data_dir, tm, vm,
                                   split_ratio=split_ratio, se_enable=se_enable)
        train_meta.append(tm)
        valid_meta.append(vm)
    return (AMDataset(config, train_meta, root_dir, allow_cache, **dataset_kwargs),
            AMDataset(config, valid_meta, root_dir, allow_cache, **dataset_kwargs))


# ---------------------------------------------------------------- sybert


class MaskingActor:
    """BERT-style masking: each position is picked with ``mask_ratio``; of
    the picked, floor(80%) become the mask symbol and floor(10%) a random
    symbol, the rest stay. Draws come from ``rng``."""

    def __init__(self, mask_ratio: float = 0.15, rng: Optional[np.random.RandomState] = None):
        self.mask_ratio = mask_ratio
        self.rng = rng or np.random.RandomState()

    def get_random_mask(self, length: int) -> np.ndarray:
        return (self.rng.uniform(0, 1, length) < self.mask_ratio).astype(np.float64)

    def input_bert_masking(self, seq: np.ndarray, nb_category: int,
                           mask_symbol_id: int, mask: np.ndarray,
                           p2=0.8, p3=0.1) -> np.ndarray:
        out = seq.copy()
        mask_id = np.where(mask == 1)[0]
        order = self.rng.permutation(len(mask_id))
        n2 = int(math.floor(len(mask_id) * p2))
        n3 = int(math.floor(len(mask_id) * p3))
        if n2 > 0:
            out[mask_id[order[:n2]]] = mask_symbol_id
        if n3 > 0:
            out[mask_id[order[n2 : n2 + n3]]] = self.rng.randint(0, nb_category)
        return out


class BERTTextDataset:
    """Textsy-BERT's items: the encoded linguistic tracks of each metafile
    line. The masks are drawn in ``collate_fn``, which the DataLoader runs on
    one thread in sampler order (its coordinator thread with workers), so
    the draws are the same with and without workers; drawn in
    ``__getitem__`` they would follow the order in which pool threads
    finish."""

    def __init__(self, config, metafile, root_dir, allow_cache=False,
                 input_bucket: int = 16):
        self.config = config
        self.input_bucket = input_bucket
        metafile = metafile if isinstance(metafile, list) else [metafile]
        root_dir = root_dir if isinstance(root_dir, list) else [root_dir]
        self.meta: List[str] = []
        for meta, data_dir in zip(metafile, root_dir):
            if not os.path.exists(meta):
                raise ValueError(f"[BERTTextDataset] meta file not found: {meta}")
            with open(meta) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self.meta.append(line.split("\t")[1])

        self.ling_unit = KanTtsLinguisticUnit(config)
        self.masking_actor = MaskingActor(
            config["Model"]["KanTtsTextsyBERT"]["params"]["mask_ratio"])
        self.allow_cache = allow_cache
        self.caches = [() for _ in self.meta] if allow_cache else []

    def __len__(self):
        return len(self.meta)

    def __getitem__(self, idx):
        if self.allow_cache and len(self.caches[idx]):
            return self.caches[idx][0]
        ling_data = self.ling_unit.encode_symbol_sequence(self.meta[idx])
        if self.allow_cache:
            self.caches[idx] = (ling_data,)
        return ling_data

    def bert_masking(self, ling_data):
        length = len(ling_data[0])
        mask = self.masking_actor.get_random_mask(length)
        mask[-1] = 0  # never mask EOS
        sy_masked = self.masking_actor.input_bert_masking(
            ling_data[0], self.ling_unit.get_unit_size()["sy"],
            self.ling_unit.mask_id("sy"), mask)
        return mask, sy_masked

    @staticmethod
    def gen_metafile(raw_meta_file, out_dir, split_ratio=0.98):
        with open(raw_meta_file) as f:
            lines = f.readlines()
        train, valid = _split_metafile(lines, split_ratio)
        with open(os.path.join(out_dir, "bert_train.lst"), "w") as f:
            f.writelines(train)
        with open(os.path.join(out_dir, "bert_valid.lst"), "w") as f:
            f.writelines(valid)

    def padded_lengths(self, batch) -> Tuple[int]:
        """The length ``collate_fn`` pads ``batch`` to (with EOS, rounded up
        to the bucket)."""
        return (Padder.round_up(max(len(x[0]) for x in batch), self.input_bucket),)

    def collate_fn(self, batch, lengths: Optional[Sequence[int]] = None
                   ) -> Dict[str, Any]:
        """-> the masked batch, padded to ``padded_lengths(batch)`` or to
        ``lengths`` (see ``AMDataset.collate_fn``)."""
        items = []
        for ling_data in batch:
            mask, sy_masked = self.bert_masking(ling_data)
            items.append((ling_data, sy_masked, mask))
        lu = self.ling_unit
        types = lu.lfeat_type_list
        L_in, = lengths or self.padded_lengths(batch)
        targets_sy = Padder.stack_1d([x[0][0] for x in items], L_in,
                                     lu.pad_id(types[0])).astype(np.int32)
        inputs_sy = Padder.stack_1d([x[1] for x in items], L_in,
                                    lu.pad_id(types[0])).astype(np.int32)
        tracks = [inputs_sy] + [
            Padder.stack_1d([x[0][i] for x in items], L_in,
                            lu.pad_id(types[i])).astype(np.int32)
            for i in range(1, 4)]
        return {
            "input_lings": np.stack(tracks, axis=2),
            "valid_input_lengths": np.asarray([len(x[0][0]) - 1 for x in items],
                                              dtype=np.int32),
            "targets": targets_sy,
            "loss_masks": Padder.stack_1d([x[2] for x in items], L_in,
                                          0.0).astype(np.float32),
        }


def get_bert_text_datasets(metafile, root_dir, config, allow_cache=False,
                           split_ratio=0.98):
    root_dir = root_dir if isinstance(root_dir, list) else [root_dir]
    metafile = metafile if isinstance(metafile, list) else [metafile]
    train_meta, valid_meta = [], []
    for raw_metafile, data_dir in zip(metafile, root_dir):
        tm = os.path.join(data_dir, "bert_train.lst")
        vm = os.path.join(data_dir, "bert_valid.lst")
        if not (os.path.exists(tm) and os.path.exists(vm)):
            BERTTextDataset.gen_metafile(raw_metafile, data_dir, split_ratio)
        train_meta.append(tm)
        valid_meta.append(vm)
    return (BERTTextDataset(config, train_meta, root_dir, allow_cache),
            BERTTextDataset(config, valid_meta, root_dir, allow_cache))


# ----------------------------------------------------------------- loading


class DistributedSampler:
    """Per-process index sharding with per-epoch reshuffle."""

    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = DATASET_RANDOM_SEED):
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = math.ceil(dataset_len / num_replicas)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            indices = rng.permutation(self.dataset_len).tolist()
        else:
            indices = list(range(self.dataset_len))
        # pad to even division, then take this rank's strided slice
        indices += indices[: self.num_samples * self.num_replicas - len(indices)]
        return iter(indices[self.rank :: self.num_replicas])

    def __len__(self):
        return self.num_samples


class _LoaderError:
    """Carries a producer-side exception across the prefetch queue."""

    def __init__(self, exc: BaseException):
        self.exc = exc


_END = object()


class DataLoader:
    """Batching iterator: sampler -> dataset[i] -> collate_fn; drop_last by
    default.

    With ``num_workers > 0``, item loads fan out over a thread pool and a
    coordinator thread keeps up to ``prefetch`` collated batches queued ahead
    of the consumer. Batches are byte-identical to the synchronous path:
    items load in parallel, but collate_fn runs on the single coordinator
    thread in sampler order (so stateful collates, e.g. the vocoder crop RNG,
    stay deterministic).

    ``lengths_max`` (data parallelism) takes the dataset's
    ``padded_lengths`` of a batch to the largest over the ranks (a
    collective), and the batch is padded to those, as the global batch is.
    The collate then runs on the consumer's thread, so that every rank issues
    those collectives in its program's order.
    """

    def __init__(self, dataset, batch_size: int, sampler: Optional[DistributedSampler] = None,
                 shuffle: bool = True, drop_last: bool = True,
                 collate_fn=None, seed: int = DATASET_RANDOM_SEED,
                 num_workers: int = 0, prefetch: int = 4,
                 lengths_max: Optional[Callable[[Sequence[int]], Sequence[int]]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or DistributedSampler(
            len(dataset), shuffle=shuffle, seed=seed)
        self.drop_last = drop_last
        self.collate_fn = collate_fn or dataset.collate_fn
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.lengths_max = lengths_max

    def _collate(self, items):
        if self.lengths_max is None:
            return self.collate_fn(items)
        return self.collate_fn(
            items, self.lengths_max(self.dataset.padded_lengths(items)))

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else math.ceil(
            n / self.batch_size)

    def _batch_indices(self) -> List[List[int]]:
        indices = list(self.sampler)
        batches = [indices[i : i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if batches and self.drop_last and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self):
        if self.num_workers <= 0:
            for idx_batch in self._batch_indices():
                yield self._collate([self.dataset[i] for i in idx_batch])
            return
        if self.lengths_max is None:
            yield from self._prefetch_iter(self.collate_fn)
            return
        for items in self._prefetch_iter(list):
            yield self._collate(items)

    def _prefetch_iter(self, collate):
        batches = self._batch_indices()
        out: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                    pending: deque = deque()
                    bi = 0
                    while (bi < len(batches) or pending) and not stop.is_set():
                        while bi < len(batches) and len(pending) <= self.prefetch:
                            pending.append([ex.submit(self.dataset.__getitem__, i)
                                            for i in batches[bi]])
                            bi += 1
                        futs = pending.popleft()
                        batch = collate([f.result() for f in futs])
                        while not stop.is_set():
                            try:
                                out.put(batch, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                    for futs in pending:  # consumer bailed early
                        for f in futs:
                            f.cancel()
                out.put(_END)
            except BaseException as e:  # surface on the consumer side
                out.put(_LoaderError(e))

        thread = threading.Thread(target=producer, daemon=True,
                                  name="kantts-data-prefetch")
        thread.start()
        try:
            while True:
                item = out.get()
                if item is _END:
                    break
                if isinstance(item, _LoaderError):
                    raise item.exc
                yield item
        finally:
            stop.set()
            # unblock a producer stuck on a full queue
            try:
                while True:
                    out.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=5.0)
