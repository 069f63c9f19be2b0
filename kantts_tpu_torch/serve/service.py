"""Online TTS serving with dynamic micro-batching (counterpart of
``kantts_tpu/serve/service.py``).

Concurrent requests are coalesced by a single coordinator thread into
batched calls of the acoustic model and the vocoder, so that traffic pays
batch economics instead of B=1 per request.

Design:
- ONE coordinator thread owns the batched device work; requests enqueue
  utterances and block on an event.
- The coordinator drains the queue up to ``max_batch`` utterances, waiting
  at most ``max_wait_ms`` after the first arrival: latency-bounded,
  throughput-opportunistic.
- Batched calls have fixed shapes: symbol lengths pad to ``input_bucket``
  multiples, the batch dim pads to ``max_batch`` (repeat-last for the
  acoustic model, zero mels for the vocoder), mel frames pad to
  ``frame_bucket`` multiples. Per-item PNCA band widths keep batch
  composition from changing an utterance's audio, and on the card the fixed
  shapes keep cuBLAS and cuDNN on the same kernels whatever the traffic.
- Grad mode is per thread: the coordinator runs under
  ``torch.inference_mode`` and so does each streamed vocoder window.

Text requests run the same front-end as the CLI (default: the in-tree
hanzi+pinyin front-end), and multi-sentence requests are joined with 0.28 s
gaps and a 0.05 s tail, as ``text_to_wav`` does.

NSF voices: the acoustic model's f0 and uv are denormalised on the host
between the stages (``nsf_denorm``), and the vocoder's source draws from a
generator seeded 0 at every batch, as the JAX service passes every batch
the key 0. The noise so depends on the batch's shape, so an NSF utterance
alone and the same utterance batched differ by the noise; streaming
refuses NSF, since the source's phase is a cumsum over the whole utterance.
"""

from __future__ import annotations

import collections
import importlib
import logging
import queue
import threading
import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from kantts_tpu_torch.bin.infer_hifigan import (
    INT8_NOT_PORTED,
    bucket_pad,
    load_vocoder,
    vocode,
)
from kantts_tpu_torch.bin.infer_sambert import (
    am_synthesis_batch,
    load_am,
    load_se,
    nsf_denormaliser,
)
from kantts_tpu_torch.models.builder import build_pqmf
from kantts_tpu_torch.utils.device import resolve_device


def resolve_frontend(frontend: Optional[str]):
    """None or "lexicon" -> the in-tree hanzi+pinyin front-end (tone-numbered
    pinyin passes through unchanged); "lexicon:PATH" -> the same, overlaid
    with a user lexicon; "pinyin" -> the bare pinyin front-end; otherwise a
    module path exposing ``text_to_symbols(texts, speaker, lang)``."""
    if frontend is None or frontend == "lexicon":
        from kantts_tpu_torch.text.lexicon_frontend import make_frontend

        return make_frontend()
    if frontend == "pinyin":
        from kantts_tpu_torch.text import pinyin_frontend

        return pinyin_frontend
    if frontend.startswith("lexicon:"):
        from kantts_tpu_torch.text.lexicon_frontend import make_frontend

        return make_frontend(frontend[len("lexicon:"):])
    return importlib.import_module(frontend)


class _Utterance:
    __slots__ = ("symbols", "mel_only", "mel", "wav", "error")

    def __init__(self, symbols: str, mel_only: bool = False):
        self.symbols = symbols
        self.mel_only = mel_only  # streaming: vocoding happens chunk-wise
        self.mel: Optional[np.ndarray] = None
        self.wav: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class _Request:
    __slots__ = ("utts", "remaining", "event", "lock")

    def __init__(self, utts: List[_Utterance]):
        self.utts = utts
        self.remaining = len(utts)
        self.event = threading.Event()
        self.lock = threading.Lock()

    def utterance_done(self):
        with self.lock:
            self.remaining -= 1
            if self.remaining == 0:
                self.event.set()


_SHUTDOWN = object()


class TTSService:
    """Dynamic-batching text-to-speech service over one device.

    Construct either from live models (tests, embedding) or from trained
    checkpoints (``from_checkpoints``, the deployment path). The models move
    to ``device``: "cuda" (the default, which raises without a card) or
    "cpu". ``synthesize`` is thread-safe and blocking; run it from as many
    request threads as the traffic needs (e.g. serve/server.py's
    ThreadingHTTPServer handlers). ``pqmf`` synthesises a multi-band
    vocoder's full band; ``nsf_denorm``, a (T, C) -> (T, C) function on the
    host, denormalises an NSF acoustic model's f0 and uv before vocoding;
    ``se`` is an SE acoustic model's speaker embedding (``load_se``).
    """

    def __init__(self, am_model, ling_unit, generator, sample_rate: int,
                 frontend=None, speaker: str = "F7", lang: str = "PinYin",
                 max_batch: int = 8, max_wait_ms: float = 20.0,
                 input_bucket: int = 32, frame_bucket: int = 100,
                 frames_per_symbol: int = 24, gap_seconds: float = 0.28,
                 tail_seconds: float = 0.05, pqmf=None, nsf_denorm=None,
                 se: Optional[np.ndarray] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.am_model = am_model.to(self.device).eval()
        self.ling_unit = ling_unit
        self.generator = generator.to(self.device).eval()
        self.pqmf = pqmf.to(self.device) if pqmf is not None else None
        self.nsf_denorm = nsf_denorm  # (T, C) mel -> mel, on the host
        self.se = se
        self.sample_rate = int(sample_rate)
        self.frontend = (frontend if frontend is None or hasattr(
            frontend, "text_to_symbols") else resolve_frontend(frontend))
        self.speaker = speaker
        self.lang = lang
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.input_bucket = int(input_bucket)
        self.frame_bucket = int(frame_bucket)
        self.frames_per_symbol = int(frames_per_symbol)
        self.gap_seconds = float(gap_seconds)
        self.tail_seconds = float(tail_seconds)

        self._queue: "queue.Queue" = queue.Queue()
        # serializes {closed-check + enqueue} against close()'s
        # {set closed + sentinel}: without it a request could slip its items
        # in AFTER the shutdown sentinel and wait forever
        self._submit_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "utterances": 0, "batches": 0,
                      "errors": 0, "audio_seconds": 0.0}
        self._latencies = collections.deque(maxlen=512)  # rolling window
        self._closed = False
        self._thread = threading.Thread(target=self._coordinator,
                                        name="kantts-serve-batcher",
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ API

    @classmethod
    def from_checkpoints(cls, am_ckpt: str, voc_ckpt: str,
                         frontend: Optional[str] = None,
                         se_file: Optional[str] = None, int8: bool = False,
                         device: Union[str, torch.device] = "cuda", **kwargs):
        """Load both stages the way the inference CLIs do (the port's
        checkpoints carry their config; weight norm folded for serving; an
        NSF acoustic model's denormaliser, a multi-band vocoder's PQMF, an SE
        acoustic model's speaker embedding from ``se_file``, which any other
        acoustic model ignores). ``int8`` raises ``NotImplementedError``."""
        device = resolve_device(device)
        if int8:
            raise NotImplementedError(INT8_NOT_PORTED)
        am_model, ling_unit = load_am(am_ckpt, device)
        generator, voc_cfg = load_vocoder(voc_ckpt, device)
        return cls(am_model, ling_unit, generator,
                   voc_cfg["audio_config"]["sampling_rate"],
                   pqmf=build_pqmf(voc_cfg), frontend=frontend,
                   nsf_denorm=nsf_denormaliser(am_model.config, am_ckpt),
                   se=load_se(am_model, se_file), device=device, **kwargs)

    def synthesize(self, text: str, timeout: Optional[float] = None,
                   speaker: Optional[str] = None,
                   lang: Optional[str] = None) -> Tuple[int, np.ndarray]:
        """Raw text -> (sample_rate, float32 waveform). Blocks until the
        coordinator has synthesized every sentence; sentence wavs are joined
        with silence gaps. ``speaker``/``lang`` override the service
        defaults per request; an unknown speaker fails validation with a
        clean error."""
        return self.synthesize_symbols(
            self._text_to_seqs(text, speaker, lang), timeout=timeout)

    def _text_to_seqs(self, text: str, speaker: Optional[str],
                      lang: Optional[str]) -> List[str]:
        fe = self.frontend if self.frontend is not None else resolve_frontend(None)
        seqs = fe.text_to_symbols([text], speaker=speaker or self.speaker,
                                  lang=lang or self.lang)[0]
        return [seqs] if isinstance(seqs, str) else list(seqs)

    def synthesize_symbols(self, symbol_seqs: List[str],
                           timeout: Optional[float] = None
                           ) -> Tuple[int, np.ndarray]:
        """Pre-encoded symbol sequences (the metafile format) -> waveform."""
        self._validate(symbol_seqs)
        t0 = time.monotonic()
        req = _Request([_Utterance(s) for s in symbol_seqs])
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("TTSService is closed")
            for utt in req.utts:
                self._queue.put((req, utt))
        if not req.event.wait(timeout):
            raise TimeoutError(f"synthesis timed out after {timeout}s")
        self._latencies.append(time.monotonic() - t0)
        errors = [u.error for u in req.utts if u.error is not None]
        if errors:
            raise errors[0]

        sr = self.sample_rate
        pieces = []
        for i, utt in enumerate(req.utts):
            pieces.append(utt.wav)
            if i != len(req.utts) - 1:
                pieces.append(np.zeros(int(self.gap_seconds * sr),
                                       dtype=np.float32))
        pieces.append(np.zeros(int(self.tail_seconds * sr), dtype=np.float32))
        wav = np.concatenate(pieces)
        with self._stats_lock:
            self.stats["requests"] += 1
            self.stats["audio_seconds"] += len(wav) / sr
        return sr, wav

    def stream(self, text: str, chunk_seconds: float = 0.3,
               timeout: Optional[float] = None,
               speaker: Optional[str] = None, lang: Optional[str] = None):
        """Raw text -> iterator of (chunk_samples, 1) float32 waveform
        chunks (exact fixed-latency streaming, infer/streaming.py). The
        acoustic forward still rides the coordinator: a streamed request's
        mel can batch with concurrent traffic, and sentence i streams while
        sentence i+1 is being synthesized. Causal single-band non-NSF
        generators only."""
        if self.pqmf is not None:
            raise ValueError("streaming supports single-band generators "
                             "(PQMF multiband is whole-utterance only)")
        if not self.generator.causal:
            raise ValueError("streaming requires a causal generator config")
        if self.nsf_denorm is not None or self.generator.nsf_params is not None:
            raise ValueError("streaming does not support NSF checkpoints "
                             "(the harmonic source phase is a whole-"
                             "utterance cumsum)")
        seqs = self._text_to_seqs(text, speaker, lang)
        self._validate(seqs)

        from kantts_tpu_torch.infer.streaming import stream_synthesis

        hop = int(np.prod(self.generator.upsample_scales))
        chunk_frames = max(1, int(round(
            chunk_seconds * self.sample_rate / hop)))
        # one request per sentence so each becomes streamable the moment
        # its own mel is ready
        reqs = []
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("TTSService is closed")
            for s in seqs:
                req = _Request([_Utterance(s, mel_only=True)])
                self._queue.put((req, req.utts[0]))
                reqs.append(req)

        def chunks():
            sr = self.sample_rate
            total = 0.0
            for i, req in enumerate(reqs):
                if not req.event.wait(timeout):
                    raise TimeoutError(
                        f"synthesis timed out after {timeout}s")
                utt = req.utts[0]
                if utt.error is not None:
                    raise utt.error
                for chunk in stream_synthesis(self.generator, utt.mel,
                                              chunk_frames=chunk_frames):
                    total += chunk.shape[0] / sr
                    yield chunk
                pad = (self.gap_seconds if i != len(reqs) - 1
                       else self.tail_seconds)
                total += pad
                yield np.zeros((int(pad * sr), 1), dtype=np.float32)
            with self._stats_lock:
                self.stats["requests"] += 1
                self.stats["audio_seconds"] += total

        return chunks()

    def _validate(self, symbol_seqs: List[str]):
        """Caller-thread validation: a malformed utterance rejects THIS
        request with a clean error instead of poisoning a whole coordinator
        batch. Unknown symbols raise here (the encode is paid a second time
        on the request thread, so that it does not fail on the coordinator
        thread); lengths beyond the model's position tables (config
        ``max_len``) are refused."""
        if self._closed:
            raise RuntimeError("TTSService is closed")
        if not symbol_seqs:
            raise ValueError("empty request")
        max_syms = int(self.am_model.config.get("max_len", 800))
        for seq in symbol_seqs:
            n = len(self.ling_unit.encode_symbol_sequence(seq)[0]) - 1
            if n < 1:
                raise ValueError("empty utterance in request")
            if n > max_syms:
                raise ValueError(
                    f"utterance has {n} symbols, over the model's max_len "
                    f"{max_syms}; split the text into shorter sentences")

    def stats_snapshot(self) -> dict:
        """Counters plus rolling latency percentiles over the last 512
        requests (served by GET /healthz)."""
        with self._stats_lock:
            snap = dict(self.stats)
            lats = list(self._latencies)
        if lats:
            snap["latency_p50_ms"] = round(
                float(np.percentile(lats, 50)) * 1e3, 1)
            snap["latency_p95_ms"] = round(
                float(np.percentile(lats, 95)) * 1e3, 1)
        return snap

    def warmup(self, text: str, timeout: Optional[float] = None) -> float:
        """Synthesize ``text`` once and discard the audio, so that the first
        live request does not pay CUDA context creation and the convolution
        heuristics. Returns the wall seconds spent."""
        t0 = time.monotonic()
        self.synthesize(text, timeout=timeout)
        dt = time.monotonic() - t0
        with self._stats_lock:  # warmup is not traffic
            self.stats["requests"] -= 1
            if self._latencies:  # nor is its cold start a latency sample
                self._latencies.pop()
        return dt

    def close(self):
        """Stop the coordinator; pending requests finish first (they are
        ahead of the sentinel in the queue)."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(_SHUTDOWN)
        self._thread.join(timeout=60.0)

    # ---------------------------------------------------------- coordinator

    def _coordinator(self):
        with torch.inference_mode():
            while True:
                item = self._queue.get()
                if item is _SHUTDOWN:
                    return
                group = [item]
                deadline = time.monotonic() + self.max_wait_s
                while len(group) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    try:
                        if remaining > 0:
                            nxt = self._queue.get(timeout=remaining)
                        else:  # window closed: take only what is queued
                            nxt = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is _SHUTDOWN:
                        self._run_batch(group)
                        return
                    group.append(nxt)
                self._run_batch(group)

    def _run_batch(self, group):
        utts = [utt for _, utt in group]
        try:
            mels = self._acoustic_batch([u.symbols for u in utts])
            for utt, mel in zip(utts, mels):
                utt.mel = mel
            # streaming (mel_only) utterances are vocoded chunk-wise by the
            # caller; vocoding them here would delay the first chunk by a
            # whole-utterance vocode
            need_wav = [u for u in utts if not u.mel_only]
            if need_wav:
                wavs = self._vocode_batch([u.mel for u in need_wav])
                for utt, wav in zip(need_wav, wavs):
                    utt.wav = wav
        except Exception as e:  # a CUDA error or an OOM: to every waiter
            logging.exception("serve batch failed")
            with self._stats_lock:
                self.stats["errors"] += 1
            for utt in utts:
                utt.error = e
        finally:
            with self._stats_lock:
                self.stats["batches"] += 1
                self.stats["utterances"] += len(utts)
            for req, utt in group:
                req.utterance_done()

    def _acoustic_batch(self, symbol_seqs: List[str]) -> List[np.ndarray]:
        results = am_synthesis_batch(
            symbol_seqs, self.am_model, self.ling_unit,
            input_bucket=self.input_bucket,
            frames_per_symbol=self.frames_per_symbol,
            batch_pad_to=self.max_batch, se=self.se)
        mels = [post for _, post, _, _, _ in results]
        if self.nsf_denorm is not None:
            mels = [self.nsf_denorm(m) for m in mels]
        return mels

    def _vocode_batch(self, mels: List[np.ndarray]) -> List[np.ndarray]:
        mel_in = bucket_pad(mels, self.frame_bucket, self.max_batch)
        y = vocode(self.generator, self.pqmf,
                   torch.from_numpy(mel_in).to(self.device)).float().cpu().numpy()
        hop = y.shape[1] // mel_in.shape[1]
        return [y[i, :m.shape[0] * hop, 0] for i, m in enumerate(mels)]
