"""Offline batched vocoding: a closed loop with one batch in flight, as
``infer_hifigan --batch B`` runs.

Each call takes the next B utterances in arrival order, pads them with
the program's ``bucket_pad`` to a multiple of the mix's frame bucket,
copies them to the card, runs the program's ``vocode`` and copies the
waveform back to the host. A call's time runs from the hand-over of its
mels to its waveform on the host.

The check: the calls drawn from the seed before the window, and the
first call of the longest bucket, are kept; once the window has closed
and the program is freed, the plain reference vocodes each of their
utterances alone, unpadded (the generator is causal, so padding after
an utterance does not reach it), from the same weights and, for NSF,
the same source draws. ``wav_gap`` is the worst utterance's largest
sample difference over its reference's peak.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from h100bench import devtrace
from h100bench.devtrace import Laps
from h100bench.harness import set_tf32
from h100bench.reference import hifigan as ref
from h100bench.traffic_gen import utterances
from h100bench.weights import seeded_weights

# The program: what the timed path calls.
from kantts_tpu_torch.bin.infer_hifigan import binarize, bucket_pad, vocode
from kantts_tpu_torch.models.builder import vocoder_dtype
from kantts_tpu_torch.models.hifigan.generator import Generator
from kantts_tpu_torch.models.hifigan.layers import fold_weight_norm


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.params = cfg["hifigan"]["Model"]["Generator"]["params"]
        self.hop = ref.hop(self.params)
        if self.hop != cfg["audio_config"]["hop_length"]:
            raise ValueError("the generator's upsampling is not the audio hop")
        self.sr = cfg["audio_config"]["sampling_rate"]
        self.batch, self.bucket = mix["batch"], mix["frame_bucket"]
        self.nsf = self.params.get("nsf_params") is not None
        self.call = self.program_call
        self.wrap: Callable = lambda call: call  # the tests break the call here
        self.calls: List[dict] = []
        self.kept: Dict[int, dict] = {}

    def use_control(self) -> None:
        self.call = self.control_call

    # set-up
    def setup(self) -> None:
        lap = Laps()
        self.timed: Callable[[List[np.ndarray]], np.ndarray] = self.wrap(self.call)
        self.weights = seeded_weights(ref.param_shapes(self.params), self.seed,
                                      self.device)
        with torch.device(self.device):
            model = Generator(**self.params, dtype=vocoder_dtype(self.cfg["hifigan"]))
        model.load_state_dict(self.weights, strict=True)
        self.model = fold_weight_norm(model).eval()
        lap("weights")
        self.utts = utterances(self.mix, self.sr / self.hop, self.params["in_channels"],
                               self.nsf, self.seed)
        if self.nsf:
            self.utts.bank = binarize(self.utts.bank)
        lap("traffic")
        for L in sorted({self.padded(f) for f in self.utts.frames}):  # one call of each shape the traffic sends
            self.timed([self.utts.bank[:L]] * self.batch)
        self.sync()
        lap("warm_up")
        self.phases = lap.phases
        rng = np.random.default_rng([self.seed % 2 ** 63, 2])
        check = self.mix["check"]
        self.check_calls = set(rng.choice(check["first_calls"], check["calls"],
                                          replace=False).tolist())

    def padded(self, frames: int) -> int:
        return int(math.ceil(frames / self.bucket) * self.bucket)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # the timed path
    def program_call(self, mels: List[np.ndarray]) -> np.ndarray:
        with torch.profiler.record_function("h100bench.bucket_pad"):
            x = bucket_pad(mels, self.bucket, self.batch)
        with torch.profiler.record_function("h100bench.to_device"):
            x = torch.from_numpy(x).to(self.device)
        with torch.inference_mode():
            with torch.profiler.record_function("h100bench.vocode"):
                y = vocode(self.model, None, x)
            with torch.profiler.record_function("h100bench.to_host"):
                return y.float().cpu().numpy()[:, :, 0]

    def control_call(self, mels: List[np.ndarray]) -> np.ndarray:
        """The reference in the program's place, in TF32: the control."""
        L = self.padded(max(m.shape[0] for m in mels))
        out = np.zeros((self.batch, L * self.hop), np.float32)
        set_tf32(True)
        try:
            with torch.inference_mode():
                wavs = ref.vocode_utterances(
                    [torch.from_numpy(m).to(self.device) for m in mels],
                    self.weights, self.params, (self.batch, L))
            for i, w in enumerate(wavs):
                out[i, :w.shape[0]] = w.cpu().numpy()
        finally:
            set_tf32(self.cfg["tf32"])
        return out

    # the window
    def window(self, seconds: float) -> Dict[str, float]:
        longest, longest_call = 0, None
        pos = 0
        self.t_start = time.perf_counter()
        while time.perf_counter() - self.t_start < seconds:
            mels = self.utts.take(pos, self.batch)
            t0 = time.perf_counter()
            wav = self.timed(mels)
            ms = (time.perf_counter() - t0) * 1e3
            frames = [m.shape[0] for m in mels]
            i = len(self.calls)
            self.calls.append({"ms": ms, "frames": frames,
                               "L": self.padded(max(frames))})
            if max(frames) > longest:
                if longest_call not in self.check_calls:
                    self.kept.pop(longest_call, None)
                longest, longest_call = max(frames), i
                self.kept[i] = {"pos": pos, "wav": wav}
            elif i in self.check_calls:
                self.kept[i] = {"pos": pos, "wav": wav}
            pos += self.batch
        self.window_s = time.perf_counter() - self.t_start
        self.next_pos = pos
        audio_s = sum(sum(c["frames"]) for c in self.calls) * self.hop / self.sr
        ms = [c["ms"] for c in self.calls]
        p95 = (statistics.quantiles(ms, n=100, method="inclusive")[94]
               if len(ms) > 1 else ms[0])
        # audio over wall: rtf_report's x_realtime, over the whole window
        return {"audio_s_per_s": audio_s / self.window_s, "vocode_p95_ms": p95}

    def profile(self, seconds: float) -> devtrace.Traced:
        """Trace about ``seconds`` of further calls (at least 5), the same
        calls in each window."""
        n = max(5, int(seconds * len(self.calls) / self.window_s))
        start = self.next_pos

        def run() -> None:
            for i in range(n):
                with torch.profiler.record_function(devtrace.CALL_SPAN):
                    self.timed(self.utts.take(start + i * self.batch, self.batch))

        def hooks():
            if not self.nsf:
                return lambda: None
            return devtrace.hook_span([self.model.source_module, *self.model.source_downs],
                                      "h100bench.nsf_source")
        return devtrace.profile_twice(run, self.sync, hooks)

    def release(self) -> None:
        self.model = None

    def cleanup(self) -> None:
        pass

    # the check
    def check(self) -> Dict[str, List[float]]:
        """-> {"wav_gap": the gap of each utterance compared}."""
        gaps = []
        for k in self.kept.values():
            mels = self.utts.take(k["pos"], self.batch)
            L = self.padded(max(m.shape[0] for m in mels))
            with torch.inference_mode():
                refs = ref.vocode_utterances(
                    [torch.from_numpy(m).to(self.device) for m in mels],
                    self.weights, self.params, (self.batch, L))
            for mel, want, got in zip(mels, refs, k["wav"]):
                want = want.double().cpu().numpy()
                got = np.asarray(got[:mel.shape[0] * self.hop], np.float64)
                gaps.append(float(np.max(np.abs(got - want))
                                  / max(np.max(np.abs(want)), 1e-12)))
        return {"wav_gap": gaps}

    def attempted(self) -> int:
        return sum(len(c["frames"]) for c in self.calls)
