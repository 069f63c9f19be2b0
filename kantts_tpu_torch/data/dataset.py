"""Datasets, collate and loading for vocoder and acoustic-model training (a
copy of the parts of ``kantts_tpu/data/dataset.py`` that the port trains
with: the same metafile split, crops, buckets and batches for a seed).

Input lengths round up to ``input_bucket`` and mel lengths to
``frame_bucket`` (a multiple of outputs_per_step), as in the JAX package;
masked loss reductions divide by valid counts, so padding is invisible to
training. Arrays are numpy; the DataLoader is a seeded shuffling iterator
with per-process sharding. The JAX package's FP, SE, NSF and byte-input
branches and its Textsy-BERT dataset are not copied: the port's models
refuse those configs.
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
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.stats import betabinom

from kantts_tpu_torch.text.ling_unit import KanTtsLinguisticUnit
from kantts_tpu_torch.utils.audio import read_wav

DATASET_RANDOM_SEED = 1234


@lru_cache(maxsize=256)
def beta_binomial_prior_distribution(phoneme_count: int, mel_count: int,
                                     scaling: float = 1.0) -> np.ndarray:
    """(mel_count, phoneme_count) beta-binomial MAS prior."""
    P, M = phoneme_count, mel_count
    x = np.arange(0, P)
    rows = []
    for i in range(1, M + 1):
        a, b = scaling * i, scaling * (M + 1 - i)
        rows.append(betabinom(P, a, b).pmf(x))
    return np.asarray(rows)


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


class VocDataset:
    """(wav, mel) random-crop pairs; crops are fixed ``batch_max_steps``
    windows."""

    def __init__(self, metafile, root_dir, config):
        self.config = config
        audio = config["audio_config"]
        self.sampling_rate = audio["sampling_rate"]
        self.n_fft = audio["n_fft"]
        self.hop_length = audio["hop_length"]
        self.batch_max_steps = config["batch_max_steps"]
        self.batch_max_frames = self.batch_max_steps // self.hop_length

        metafile = metafile if isinstance(metafile, list) else [metafile]
        root_dir = root_dir if isinstance(root_dir, list) else [root_dir]
        self.meta: List[Tuple[str, str]] = []
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
                items.append((wav_file, mel_file))
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
                 os.path.join(data_dir, "mel", name + ".npy")) for name in names]

    def __len__(self):
        return len(self.meta)

    def __getitem__(self, idx):
        if self.allow_cache and len(self.caches[idx]):
            return self.caches[idx]
        wav_file, mel_file = self.meta[idx]
        wav = load_wav(wav_file, self.sampling_rate)
        mel = np.load(mel_file)
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


# -------------------------------------------------------------------- AM


class AMDataset:
    """(ling, mel, dur, f0, energy, prior) items with bucketed collate."""

    def __init__(self, config, metafile, root_dir, allow_cache=False,
                 input_bucket: int = 16, frame_bucket: int = 96):
        self.config = config
        params = config["Model"]["KanTtsSAMBERT"]["params"]
        self.mas_enable = params.get("MAS", False)
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
        self.allow_cache = allow_cache
        self.caches = [() for _ in self.meta] if allow_cache else []

    def _load_meta(self, metafile, data_dir):
        with open(metafile) as f:
            lines = [line.strip() for line in f if line.strip()]
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
            ))
        return items

    def __len__(self):
        return len(self.meta)

    def __getitem__(self, idx):
        if self.allow_cache and len(self.caches[idx]):
            return self.caches[idx]
        ling_txt, mel_file, dur_file, f0_file, energy_file = self.meta[idx]
        ling_data = self.ling_unit.encode_symbol_sequence(ling_txt)
        mel = np.load(mel_file)
        dur = np.load(dur_file) if dur_file is not None else None
        attn_prior = None
        if not self.with_duration:
            attn_prior = beta_binomial_prior_distribution(len(ling_data[0]),
                                                          mel.shape[0])
        item = (ling_data, mel, dur, np.load(f0_file), np.load(energy_file),
                attn_prior)
        if self.allow_cache:
            self.caches[idx] = item
        return item

    @staticmethod
    def gen_metafile(raw_meta_file, out_dir, train_meta_file, valid_meta_file,
                     split_ratio=0.98):
        with open(raw_meta_file) as f:
            lines = f.readlines()
        train, valid = _split_metafile(lines, split_ratio)
        mel_dir = os.path.join(out_dir, "mel")
        duration_dir = os.path.join(out_dir, "duration")
        for path, subset in [(train_meta_file, train), (valid_meta_file, valid)]:
            with open(path, "w") as f:
                for line in subset:
                    index = line.split("\t")[0]
                    if not os.path.exists(os.path.join(mel_dir, index + ".npy")):
                        continue
                    if os.path.exists(duration_dir) and not os.path.exists(
                            os.path.join(duration_dir, index + ".npy")):
                        continue
                    f.write(line)

    def collate_fn(self, batch) -> Dict[str, Any]:
        lu = self.ling_unit
        n_ling = 4
        lfeat_types = lu.lfeat_type_list
        max_in = max(len(x[0][0]) for x in batch)
        L_in = Padder.round_up(max_in, self.input_bucket)

        def track(i):
            return Padder.stack_1d([x[0][i] for x in batch], L_in,
                                   lu.pad_id(lfeat_types[i])).astype(np.int32)

        data: Dict[str, Any] = {
            "input_lings": np.stack([track(i) for i in range(n_ling)], axis=2),
            "input_emotions": track(n_ling),
            "input_speakers": track(n_ling + 1),
            # EOS is appended to every track; it carries no duration
            "valid_input_lengths": np.asarray([len(x[0][0]) - 1 for x in batch],
                                              dtype=np.int32),
            "valid_output_lengths": np.asarray([len(x[1]) for x in batch],
                                               dtype=np.int32),
        }
        max_out = int(data["valid_output_lengths"].max())
        L_mel = Padder.round_up(max_out, self.frame_bucket)
        data["mel_targets"] = Padder.stack_2d([x[1] for x in batch], L_mel, 0.0)

        if self.with_duration:
            data["durations"] = np.stack([
                Padder.pad_durations(x[2], L_in, L_mel) for x in batch
            ]).astype(np.float32)
            feats_len = L_in
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
                    split_ratio=0.98, **dataset_kwargs):
    root_dir = root_dir if isinstance(root_dir, list) else [root_dir]
    metafile = metafile if isinstance(metafile, list) else [metafile]
    train_meta, valid_meta = [], []
    for raw_metafile, data_dir in zip(metafile, root_dir):
        tm = os.path.join(data_dir, "am_train.lst")
        vm = os.path.join(data_dir, "am_valid.lst")
        if not (os.path.exists(tm) and os.path.exists(vm)):
            AMDataset.gen_metafile(raw_metafile, data_dir, tm, vm,
                                   split_ratio=split_ratio)
        train_meta.append(tm)
        valid_meta.append(vm)
    return (AMDataset(config, train_meta, root_dir, allow_cache, **dataset_kwargs),
            AMDataset(config, valid_meta, root_dir, allow_cache, **dataset_kwargs))


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
    """

    def __init__(self, dataset, batch_size: int, sampler: Optional[DistributedSampler] = None,
                 shuffle: bool = True, drop_last: bool = True,
                 collate_fn=None, seed: int = DATASET_RANDOM_SEED,
                 num_workers: int = 0, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or DistributedSampler(
            len(dataset), shuffle=shuffle, seed=seed)
        self.drop_last = drop_last
        self.collate_fn = collate_fn or dataset.collate_fn
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)

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
                yield self.collate_fn([self.dataset[i] for i in idx_batch])
            return
        yield from self._prefetch_iter()

    def _prefetch_iter(self):
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
                        batch = self.collate_fn([f.result() for f in futs])
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
