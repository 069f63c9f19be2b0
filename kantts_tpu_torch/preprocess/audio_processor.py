"""Offline audio feature pipeline: wav -> mel/f0/energy/duration features
(counterpart of ``kantts_tpu/preprocess/audio_processor.py``).

The stage order of KAN-TTS's audio processor: amplitude normalisation ->
interval durations -> silence trim -> mel extraction and corpus mean/std ->
syllable-duration calibration -> the pitch ensemble -> energy, and its
output layout (wav/ mel/ f0/ frame_f0/ frame_uv/ energy/ frame_energy/
raw_duration/ duration/ badlist.txt), which the datasets read.

The mel and energy STFTs run on ``device`` (the card by default, as the
JAX package runs them on its accelerator); f0 runs the native trackers in a
host thread pool (the ctypes calls release the GIL). ``stage_seconds``
records each stage's wall seconds.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import Dict, Iterator, Optional

import numpy as np

from kantts_tpu_torch.dsp.mel import MelSpectrogramExtractor
from kantts_tpu_torch.preprocess.audio_utils import (
    align_length,
    average_by_duration,
    compute_mean_std,
    encode_16bits,
    f0_norm_mean_std,
    get_energy,
    get_pitch,
    norm_mean_std,
    parse_interval_file,
    trim_silence,
    trim_silence_with_interval,
    volume_normalize,
)
from kantts_tpu_torch.utils.audio import read_wav, save_wav
from kantts_tpu_torch.utils.device import resolve_device

DEFAULT_AUDIO_CONFIG = {
    "wav_normalize": True,
    "trim_silence": True,
    "trim_silence_threshold_db": 60,
    "preemphasize": False,
    "sampling_rate": 16000,
    "hop_length": 200,
    "win_length": 1000,
    "n_fft": 2048,
    "n_mels": 80,
    "fmin": 0.0,
    "fmax": 8000.0,
    "phone_level_feature": True,
    "norm_type": "mean_std",
    "max_norm": 1.0,
    "symmetric": False,
    "min_level_db": -100.0,
    "ref_level_db": 20,
    "num_workers": 16,
}


class AudioProcessor:
    def __init__(self, config: Optional[dict] = None, device="cuda"):
        self.device = resolve_device(device)
        if not isinstance(config, dict):
            logging.warning("[AudioProcessor] no config dict; using defaults")
            config = DEFAULT_AUDIO_CONFIG
        self.config = {**DEFAULT_AUDIO_CONFIG, **config}
        for key, value in self.config.items():
            setattr(self, key, value)
        self.min_wav_length = int(self.sampling_rate * 0.5)

        self.badcase_list = []
        self.pcm_dict: Dict[str, np.ndarray] = {}
        self.mel_dict: Dict[str, np.ndarray] = {}
        self.f0_dict: Dict[str, np.ndarray] = {}
        self.uv_dict: Dict[str, np.ndarray] = {}
        self.f0uv_dict: Dict[str, np.ndarray] = {}
        self.energy_dict: Dict[str, np.ndarray] = {}
        self.dur_dict: Dict[str, np.ndarray] = {}
        self.stage_seconds: Dict[str, float] = {}

        self._mel_extractor = MelSpectrogramExtractor(
            self.sampling_rate, self.n_fft, self.hop_length, self.win_length,
            self.n_mels, self.max_norm, self.min_level_db, self.ref_level_db,
            self.fmin, self.fmax, self.symmetric, self.device,
        )

    # ----------------------------------------------------------------- amp

    def amp_normalize(self, src_wav_dir: str, out_wav_dir: str) -> bool:
        if self.wav_normalize:
            logging.info("[AudioProcessor] Amplitude normalization started")
            ok = volume_normalize(src_wav_dir, out_wav_dir, self.num_workers)
            logging.info("[AudioProcessor] Amplitude normalization finished")
            return ok
        if not os.path.exists(out_wav_dir):
            os.symlink(os.path.abspath(src_wav_dir), out_wav_dir,
                       target_is_directory=True)
        return True

    # ----------------------------------------------------------------- pcm

    def get_pcm_dict(self, src_wav_dir: str) -> Dict[str, np.ndarray]:
        if self.pcm_dict:
            return self.pcm_dict
        wav_list = sorted(glob(os.path.join(src_wav_dir, "*.wav")))
        logging.info("[AudioProcessor] Loading %d wavs", len(wav_list))

        def load(path):
            sr, data = read_wav(path)
            if sr != self.sampling_rate:
                raise ValueError(f"{path}: rate {sr} != {self.sampling_rate}")
            return data

        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            for path, pcm in zip(wav_list, ex.map(load, wav_list)):
                name = os.path.splitext(os.path.basename(path))[0]
                if len(pcm) < self.min_wav_length:
                    logging.warning("[AudioProcessor] %s too short, skip", name)
                    self.badcase_list.append(name)
                    continue
                self.pcm_dict[name] = pcm
        return self.pcm_dict

    # ---------------------------------------------------------------- trim

    def trim_silence_wav(self, src_wav_dir: str,
                         out_wav_dir: Optional[str] = None) -> bool:
        out_wav_dir = out_wav_dir or src_wav_dir
        os.makedirs(out_wav_dir, exist_ok=True)
        pcm_dict = self.get_pcm_dict(src_wav_dir)
        for name in list(pcm_dict):
            trimmed = trim_silence(pcm_dict[name],
                                   self.trim_silence_threshold_db,
                                   self.hop_length, self.win_length)
            if len(trimmed) < self.min_wav_length:
                logging.warning("[AudioProcessor] %s too short, skip", name)
                self.badcase_list.append(name)
                self.pcm_dict.pop(name)
                continue
            self.pcm_dict[name] = trimmed
            save_wav(trimmed, os.path.join(out_wav_dir, name + ".wav"),
                     self.sampling_rate)
        return True

    def trim_silence_wav_with_interval(self, src_wav_dir: str, dur_dir: str,
                                       out_wav_dir: Optional[str] = None) -> bool:
        out_wav_dir = out_wav_dir or src_wav_dir
        os.makedirs(out_wav_dir, exist_ok=True)
        pcm_dict = self.get_pcm_dict(src_wav_dir)
        for name in list(pcm_dict):
            trimmed = trim_silence_with_interval(
                pcm_dict[name], self.dur_dict.get(name), self.hop_length
            )
            if trimmed is None:
                continue
            if len(trimmed) < self.min_wav_length:
                logging.warning("[AudioProcessor] %s too short, skip", name)
                self.badcase_list.append(name)
                self.pcm_dict.pop(name)
                continue
            self.pcm_dict[name] = trimmed
            save_wav(trimmed, os.path.join(out_wav_dir, name + ".wav"),
                     self.sampling_rate)
        return True

    # ----------------------------------------------------------------- mel

    def mel_extract(self, src_wav_dir: str, out_feature_dir: str) -> bool:
        os.makedirs(out_feature_dir, exist_ok=True)
        pcm_dict = self.get_pcm_dict(src_wav_dir)
        logging.info("[AudioProcessor] Melspec extraction started")
        for name, pcm in pcm_dict.items():
            self.mel_dict[name] = np.asarray(
                self._mel_extractor(pcm.astype(np.float32))
            )
        mel_mean, mel_std = compute_mean_std(
            list(self.mel_dict.values()), dims=self.n_mels
        )
        np.savetxt(os.path.join(out_feature_dir, "mel_mean.txt"), mel_mean,
                   fmt="%.6f")
        np.savetxt(os.path.join(out_feature_dir, "mel_std.txt"), mel_std,
                   fmt="%.6f")
        for name, mel in self.mel_dict.items():
            np.save(os.path.join(out_feature_dir, name + ".npy"),
                    norm_mean_std(mel, mel_mean, mel_std))
        logging.info("[AudioProcessor] Melspec extraction finished")
        return True

    # ------------------------------------------------------------ duration

    def duration_generate(self, src_interval_dir: str,
                          out_feature_dir: str) -> bool:
        os.makedirs(out_feature_dir, exist_ok=True)
        interval_list = sorted(glob(os.path.join(src_interval_dir, "*.interval")))
        logging.info("[AudioProcessor] Duration generation started")
        for path in interval_list:
            name = os.path.splitext(os.path.basename(path))[0]
            result = parse_interval_file(path, self.sampling_rate,
                                         self.hop_length)
            if result is None:
                logging.warning("[AudioProcessor] duration failed for %s", name)
                self.badcase_list.append(name)
                continue
            durs, phones = result
            if self.mel_dict:
                mel = self.mel_dict.get(name)
                if mel is None:
                    continue
                diff = int(np.sum(durs)) - mel.shape[0]
                durs[-1] -= diff
                if durs[-1] < 0:
                    logging.error("[AudioProcessor] dur align failed for %s", name)
                    self.badcase_list.append(name)
                    continue
            self.dur_dict[name] = durs
            np.save(os.path.join(out_feature_dir, name + ".npy"), durs)
            with open(os.path.join(out_feature_dir, name + ".phone"), "w") as f:
                f.write("\n".join(phones))
        return True

    def calibrate_syllable_duration(self, raw_dur_dir: str, raw_metafile: str,
                                    out_cali_duration_dir: str) -> None:
        """Map interval phones onto metafile symbols (silences absorbed,
        breaks matched to 'sp') — reference audio_processor.py:95-197."""
        os.makedirs(out_cali_duration_dir, exist_ok=True)
        with open(raw_metafile) as f:
            lines = [line.strip() for line in f if line.strip()]

        for line in lines:
            index, symbol_str = line.split("\t")
            symbols = [s.strip("{").strip("}").split("$")[0]
                       for s in symbol_str.strip().split(" ")]
            dur_file = os.path.join(raw_dur_dir, index + ".npy")
            phone_file = os.path.join(raw_dur_dir, index + ".phone")
            if not (os.path.exists(dur_file) and os.path.exists(phone_file)):
                logging.warning("[AudioProcessor] missing dur/phone: %s", index)
                continue
            with open(phone_file) as f:
                phones = [p.strip() for p in f.readlines()]
            dur = np.load(dur_file)

            cali = []
            d_i = s_i = 0
            while d_i < len(dur) and s_i < len(symbols):
                if phones[d_i] == "sil":
                    d_i += 1
                    continue
                if phones[d_i] == "sp" and symbols[s_i][0] != "#":
                    d_i += 1
                    continue
                if symbols[s_i] in ("ga", "go", "ge"):
                    cali.append(0)
                    s_i += 1
                    continue
                if symbols[s_i][0] == "#":
                    if phones[d_i] != "sp":
                        cali.append(0)
                        s_i += 1
                        continue
                    cali.append(dur[d_i])
                    d_i += 1
                    s_i += 1
                    continue
                cali.append(dur[d_i])
                d_i += 1
                s_i += 1
            cali.append(0)  # trailing #4
            if len(cali) != len(symbols):
                logging.error("[Duration Calibrating] %d != %d symbols (%s)",
                              len(cali), len(symbols), index)
                continue

            durs = np.array(cali)
            if self.mel_dict:
                mel = self.mel_dict.get(index)
                if mel is None:
                    continue
                diff = int(np.sum(durs)) - mel.shape[0]
                durs[-2] -= diff
                if durs[-2] < 0:
                    logging.error("[AudioProcessor] calibration failed %s", index)
                    self.badcase_list.append(index)
                    continue
            self.dur_dict[index] = durs
            np.save(os.path.join(out_cali_duration_dir, index + ".npy"), durs)

    # --------------------------------------------------------------- pitch

    def pitch_extract(self, src_wav_dir: str, out_f0_dir: str,
                      out_frame_f0_dir: str, out_frame_uv_dir: str) -> bool:
        for d in (out_f0_dir, out_frame_f0_dir, out_frame_uv_dir):
            os.makedirs(d, exist_ok=True)
        pcm_dict = self.get_pcm_dict(src_wav_dir)
        logging.info("[AudioProcessor] Pitch extraction started")

        def extract(item):
            name, pcm = item
            return name, get_pitch(encode_16bits(pcm), self.sampling_rate,
                                   self.hop_length)

        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            for name, result in ex.map(extract, pcm_dict.items()):
                if result is None:
                    logging.warning("[AudioProcessor] pitch failed for %s", name)
                    self.badcase_list.append(name)
                    continue
                f0, uv, f0uv = result
                if self.mel_dict:
                    mel = self.mel_dict.get(name)
                    f0 = align_length(f0, mel, name)
                    uv = align_length(uv, mel, name)
                    f0uv = align_length(f0uv, mel, name)
                if f0 is None or uv is None or f0uv is None:
                    self.badcase_list.append(name)
                    continue
                self.f0_dict[name] = f0
                self.uv_dict[name] = uv
                self.f0uv_dict[name] = f0uv

        f0_mean, f0_std = compute_mean_std(list(self.f0uv_dict.values()), dims=1)
        np.savetxt(os.path.join(out_f0_dir, "f0_mean.txt"), f0_mean, fmt="%.6f")
        np.savetxt(os.path.join(out_f0_dir, "f0_std.txt"), f0_std, fmt="%.6f")

        for name in self.f0uv_dict:
            self.f0uv_dict[name] = f0_norm_mean_std(self.f0uv_dict[name],
                                                    f0_mean, f0_std)
        for name in self.f0_dict:
            self.f0_dict[name] = f0_norm_mean_std(self.f0_dict[name],
                                                  f0_mean, f0_std)
            np.save(os.path.join(out_frame_f0_dir, name + ".npy"),
                    self.f0_dict[name].reshape(-1))
        for name in self.uv_dict:
            np.save(os.path.join(out_frame_uv_dir, name + ".npy"),
                    self.uv_dict[name].reshape(-1))

        if self.phone_level_feature and self.dur_dict:
            for name in self.f0uv_dict:
                avg = average_by_duration(self.f0uv_dict.get(name),
                                          self.dur_dict.get(name))
                if avg is None:
                    self.badcase_list.append(name)
                else:
                    self.f0uv_dict[name] = avg

        for name in self.f0uv_dict:
            np.save(os.path.join(out_f0_dir, name + ".npy"),
                    self.f0uv_dict[name].reshape(-1))
        logging.info("[AudioProcessor] Pitch extraction finished")
        return True

    # -------------------------------------------------------------- energy

    def energy_extract(self, src_wav_dir: str, out_energy_dir: str,
                       out_frame_energy_dir: str) -> bool:
        os.makedirs(out_energy_dir, exist_ok=True)
        os.makedirs(out_frame_energy_dir, exist_ok=True)
        pcm_dict = self.get_pcm_dict(src_wav_dir)
        logging.info("[AudioProcessor] Energy extraction started")

        for name, pcm in pcm_dict.items():
            energy = get_energy(pcm, self.hop_length, self.win_length,
                                self.n_fft, self.device)
            if self.mel_dict:
                energy = align_length(energy, self.mel_dict.get(name), name)
            if energy is None:
                self.badcase_list.append(name)
                continue
            self.energy_dict[name] = energy

        e_mean, e_std = compute_mean_std(list(self.energy_dict.values()), dims=1)
        np.savetxt(os.path.join(out_energy_dir, "energy_mean.txt"), e_mean,
                   fmt="%.6f")
        np.savetxt(os.path.join(out_energy_dir, "energy_std.txt"), e_std,
                   fmt="%.6f")

        for name in self.energy_dict:
            self.energy_dict[name] = f0_norm_mean_std(self.energy_dict[name],
                                                      e_mean, e_std)
            np.save(os.path.join(out_frame_energy_dir, name + ".npy"),
                    self.energy_dict[name].reshape(-1))

        if self.phone_level_feature and self.dur_dict:
            for name in self.energy_dict:
                avg = average_by_duration(self.energy_dict.get(name),
                                          self.dur_dict.get(name))
                if avg is None:
                    self.badcase_list.append(name)
                else:
                    self.energy_dict[name] = avg

        for name in self.energy_dict:
            np.save(os.path.join(out_energy_dir, name + ".npy"),
                    self.energy_dict[name].reshape(-1))
        logging.info("[AudioProcessor] Energy extraction finished")
        return True

    # -------------------------------------------------------------- pipeline

    @contextlib.contextmanager
    def _stage(self, name: str) -> Iterator[None]:
        """Record the block's wall seconds as ``stage_seconds[name]``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stage_seconds[name] = time.perf_counter() - t0

    def process(self, src_voice_dir: str, out_data_dir: str,
                aux_metafile: Optional[str] = None) -> bool:
        raw_wav_dir = os.path.join(src_voice_dir, "wav")
        src_interval_dir = os.path.join(src_voice_dir, "interval")

        out = lambda sub: os.path.join(out_data_dir, sub)  # noqa: E731
        os.makedirs(out_data_dir, exist_ok=True)
        with_duration = os.path.exists(src_interval_dir)
        train_wav_dir = out("wav")

        with self._stage("amp_normalize"):
            if not self.amp_normalize(raw_wav_dir, train_wav_dir):
                return False
        if with_duration:
            with self._stage("duration"):
                if not self.duration_generate(src_interval_dir,
                                              out("raw_duration")):
                    return False
        if self.trim_silence:
            with self._stage("trim"):
                if with_duration:
                    if not self.trim_silence_wav_with_interval(
                        train_wav_dir, out("raw_duration")
                    ):
                        return False
                elif not self.trim_silence_wav(train_wav_dir):
                    return False
        with self._stage("mel"):
            if not self.mel_extract(train_wav_dir, out("mel")):
                return False
        if aux_metafile is not None and with_duration:
            with self._stage("calibration"):
                self.calibrate_syllable_duration(out("raw_duration"),
                                                 aux_metafile, out("duration"))
        with self._stage("pitch"):
            if not self.pitch_extract(train_wav_dir, out("f0"), out("frame_f0"),
                                      out("frame_uv")):
                return False
        with self._stage("energy"):
            if not self.energy_extract(train_wav_dir, out("energy"),
                                       out("frame_energy")):
                return False

        with open(os.path.join(out_data_dir, "badlist.txt"), "w") as f:
            f.write("\n".join(self.badcase_list))
        logging.info("[AudioProcessor] All features extracted successfully!")
        return True
