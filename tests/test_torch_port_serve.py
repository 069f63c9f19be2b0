"""The port's dynamic-batching TTS service and its HTTP front, at TINY widths
on the CPU: one request against the JAX package's offline path at the same
buckets, concurrent requests against sequential ones, streaming against
whole requests, and the service's own contract (validation on the caller
thread, no autograd on the coordinator, a failed batch reaching its waiters,
a draining close, the server CLI's SIGTERM drain).

Tolerances: against JAX 2e-4, as the slice test (the 12-step-deep float32
decode); the port against itself 1e-5.
"""

import copy
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kantts_tpu.bin.infer_sambert import am_synthesis_batch as j_am_synthesis_batch
from kantts_tpu_torch.bin import serve_tts, stream_tts
from kantts_tpu_torch.models.builder import (
    build_sambert,
    hifigan_model_builder,
    load_checkpoint,
    save_checkpoint,
)
from kantts_tpu_torch.serve import TTSService, make_http_server, wav_bytes
from kantts_tpu_torch.serve.server import parse_wav_bytes
from test_torch_port_slice import ROOT, _symbols, slice_models  # noqa: F401

MAX_BATCH = 4
TEXTS = ["ni3 hao3 , shi4 jie4 .", "wo3 men5 qu4 bei3 jing1 kan4 kan4 .",
         "zhong1 guo2", "xie4 xie5"]
TWO_SENTENCES = "ni3 hao3。 shi4 jie4"


def _vocoder(slice_models):
    return load_checkpoint(str(slice_models["ckpt_dir"] / "voc.pt"),
                           torch.device("cpu"))[0]


@pytest.fixture(scope="module")
def service(slice_models):
    svc = TTSService(slice_models["am"], slice_models["ling_unit"],
                     _vocoder(slice_models), 16000, frontend="pinyin",
                     max_batch=MAX_BATCH, max_wait_ms=100.0, device="cpu")
    yield svc
    svc.close()


def test_synthesize_symbols_matches_jax_offline(slice_models, service):
    """The JAX package's offline path at the service's buckets: the acoustic
    batch padded to max_batch, the vocoder on the bucket-padded mel, the
    gaps and the tail."""
    m = slice_models
    symbols = _symbols()
    sr, wav = service.synthesize_symbols(symbols)
    outs = j_am_synthesis_batch(symbols, m["j_am"], m["j_am_vars"], m["ling_unit"],
                                batch_pad_to=MAX_BATCH)
    pieces = []
    for i, (_, mel, _, _, _) in enumerate(outs):
        L = int(np.ceil(mel.shape[0] / 100) * 100)
        y = np.asarray(m["j_voc"].apply(m["j_voc_vars"], jnp.asarray(
            np.pad(mel, [(0, L - mel.shape[0]), (0, 0)])[None])))
        pieces.append(y[0, :mel.shape[0] * 16, 0])
        if i != len(outs) - 1:
            pieces.append(np.zeros(int(0.28 * sr), dtype=np.float32))
    pieces.append(np.zeros(int(0.05 * sr), dtype=np.float32))
    want = np.concatenate(pieces)
    assert sr == 16000 and wav.shape == want.shape
    np.testing.assert_allclose(wav, want, atol=2e-4, rtol=0)


def test_concurrent_requests_batch_and_match_sequential(service):
    sequential = {t: service.synthesize(t)[1] for t in TEXTS}
    before = service.stats_snapshot()
    results, errors = {}, []

    def worker(text):
        try:
            results[text] = service.synthesize(text, timeout=120)[1]
        except Exception as e:  # surface in the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in TEXTS]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=180)
    assert not errors and not any(th.is_alive() for th in threads)
    for t in TEXTS:
        np.testing.assert_allclose(results[t], sequential[t], atol=1e-5, rtol=0)
    after = service.stats_snapshot()
    assert after["utterances"] - before["utterances"] == len(TEXTS)
    assert after["batches"] - before["batches"] < len(TEXTS)
    assert after["requests"] - before["requests"] == len(TEXTS)
    assert 0 < after["latency_p50_ms"] <= after["latency_p95_ms"]


def test_stream_matches_synthesize(service):
    sr, whole = service.synthesize(TWO_SENTENCES)
    chunks = list(service.stream(TWO_SENTENCES, chunk_seconds=0.01))
    assert len(chunks) > 3 and all(c.ndim == 2 and c.shape[1] == 1 for c in chunks)
    streamed = np.concatenate(chunks)[:, 0]
    assert streamed.shape == whole.shape
    np.testing.assert_allclose(streamed, whole, atol=1e-5, rtol=0)


def _post(port, path, body, ctype="application/json"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": ctype})
    return urllib.request.urlopen(req, timeout=120)


def test_http_roundtrip(service):
    httpd = make_http_server(service, "127.0.0.1", 0)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        sr, want = service.synthesize(TEXTS[0])
        with _post(port, "/tts", json.dumps({"text": TEXTS[0]}).encode()) as resp:
            assert resp.headers["Content-Type"] == "audio/wav"
            body = resp.read()
        assert body == wav_bytes(want, sr)
        assert parse_wav_bytes(body)[0] == sr
        with _post(port, "/tts", TEXTS[0].encode(), "text/plain") as resp:
            assert resp.read() == body

        with _post(port, "/tts/stream", json.dumps({"text": TEXTS[0]}).encode()) as resp:
            assert resp.headers["X-Audio-Format"] == "pcm_s16le"
            assert int(resp.headers["X-Sample-Rate"]) == sr
            pcm = np.frombuffer(resp.read(), dtype="<i2")
        whole = np.frombuffer(body[44:], dtype="<i2")
        assert pcm.shape == whole.shape
        assert np.abs(pcm.astype(np.int32) - whole).max() <= 1

        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["ok"] and health["requests"] >= 2 and health["batches"] >= 1

        for path, bad in (("/tts", b'{"nope": 1}'), ("/tts", b'"just a string"'),
                          ("/tts/stream", b'{"text": "blorp9 zzz"}')):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(port, path, bad)
            assert exc.value.code == 400, (path, bad)
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(port, "/nowhere", b"{}")
        assert exc.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)


def test_validation_rejects_on_caller_thread(service):
    batches = service.stats_snapshot()["batches"]
    with pytest.raises(ValueError, match="empty"):
        service.synthesize_symbols([])
    with pytest.raises(KeyError, match="unknown"):
        service.synthesize_symbols(["{not_a_symbol$tone9$x$y$z$w}"])
    sym = "{n_c$tone3$s_begin$word_begin$emotion_neutral$F7}"
    too_long = " ".join([sym] * (service.am_model.config["max_len"] + 1))
    with pytest.raises(ValueError, match="max_len"):
        service.synthesize_symbols([too_long])
    with pytest.raises(KeyError, match="speaker"):
        service.synthesize(TEXTS[2], speaker="F99")
    assert service.stats_snapshot()["batches"] == batches  # nothing reached a batch
    assert len(service.synthesize(TEXTS[2])[1]) > 0


def test_coordinator_runs_without_autograd(service):
    """Grad mode is per thread: the coordinator's forwards run in inference
    mode though the calling thread has grad enabled."""
    seen = []

    def record(module, args, out):
        seen.append((threading.current_thread().name, torch.is_grad_enabled(),
                     torch.is_inference_mode_enabled(), out.requires_grad))

    hooks = [service.generator.register_forward_hook(record),
             service.am_model.mel_postnet.register_forward_hook(record)]
    try:
        assert torch.is_grad_enabled()
        service.synthesize(TEXTS[3])
        list(service.stream(TEXTS[3], chunk_seconds=0.05))
    finally:
        for h in hooks:
            h.remove()
    assert len(seen) >= 3
    assert all(not grad and inference and not req_grad
               for _, grad, inference, req_grad in seen), seen
    assert {name for name, *_ in seen} == {"kantts-serve-batcher",
                                           threading.current_thread().name}


def test_failed_batch_reaches_its_waiters(service, monkeypatch):
    """An exception inside a batch (a CUDA error or an OOM on the card)
    fails every request of that batch, whole or streamed, leaves the
    coordinator alive, and the next request is served."""
    acoustic = service._acoustic_batch
    calls = []

    def failing(seqs):
        calls.append(len(seqs))
        if len(calls) <= 2:
            raise RuntimeError("CUDA error: injected")
        return acoustic(seqs)

    monkeypatch.setattr(service, "_acoustic_batch", failing)
    errors = service.stats_snapshot()["errors"]
    with pytest.raises(RuntimeError, match="injected"):
        service.synthesize(TWO_SENTENCES, timeout=60)
    assert calls == [2]  # both sentences were in the failed batch
    with pytest.raises(RuntimeError, match="injected"):
        list(service.stream(TEXTS[3], timeout=60))
    assert service.stats_snapshot()["errors"] == errors + 2
    assert service._thread.is_alive()
    assert len(service.synthesize(TEXTS[3], timeout=60)[1]) > 0


def test_close_drains_pending_requests(slice_models):
    svc = TTSService(slice_models["am"], slice_models["ling_unit"],
                     _vocoder(slice_models), 16000, frontend="pinyin",
                     max_batch=2, max_wait_ms=1.0, device="cpu")
    results, errors = [], []

    def worker(text):
        try:
            results.append(svc.synthesize(text, timeout=120)[1])
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in TEXTS[2:] * 2]
    for th in threads:
        th.start()
    while svc._queue.qsize() + svc.stats_snapshot()["utterances"] < len(threads):
        time.sleep(0.01)  # every request is queued or served
    svc.close()
    for th in threads:
        th.join(timeout=60)
    assert not errors and len(results) == len(threads)
    assert not svc._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        svc.synthesize(TEXTS[2])


def _nsf_checkpoints(slice_models, tmp_path):
    """The slice's acoustic model as an NSF one (its last two mel channels
    read as f0 and uv) with mvn.npy two directories above it, and a small
    NSF vocoder on the other 78 channels. -> (AM checkpoint, vocoder's)."""
    payload = torch.load(str(slice_models["ckpt_dir"] / "am.pt"), map_location="cpu",
                         weights_only=True)
    nsf = copy.deepcopy(payload["config"])
    nsf["Model"]["KanTtsSAMBERT"]["params"]["NSF"] = True
    am_ckpt = tmp_path / "am" / "ckpt" / "nsf_am.pt"
    am_ckpt.parent.mkdir(parents=True)
    torch.save(dict(payload, config=nsf), str(am_ckpt))
    np.save(tmp_path / "am" / "mvn.npy", np.array([[170.0], [40.0]], np.float32))
    voc_cfg = copy.deepcopy(load_checkpoint(str(slice_models["ckpt_dir"] / "voc.pt"),
                                            torch.device("cpu"))[1])
    voc_cfg["Model"]["Generator"]["params"].update(
        in_channels=78, nsf_params={"nb_harmonics": 7, "sampling_rate": 16000})
    voc_ckpt = str(tmp_path / "nsf_voc.pt")
    save_checkpoint(voc_ckpt, hifigan_model_builder(voc_cfg, seed=2), voc_cfg)
    return str(am_ckpt), voc_ckpt


def test_from_checkpoints_refusals(slice_models, tmp_path):
    """``se_file`` is ignored on a non-SE acoustic model (as in the JAX
    package: the file is not even read) and used on an SE one, whose
    service answers with the embedding it was given; int8 is refused; an
    NSF pair cannot stream."""
    d = slice_models["ckpt_dir"]
    am, voc = str(d / "am.pt"), str(d / "voc.pt")
    svc = TTSService.from_checkpoints(am, voc, se_file=str(tmp_path / "absent.npy"),
                                      device="cpu")
    svc.close()
    assert svc.se is None
    payload = torch.load(am, map_location="cpu", weights_only=True)
    se_cfg = copy.deepcopy(payload["config"])
    se_cfg["Model"]["KanTtsSAMBERT"]["params"]["SE"] = True
    se_am = str(tmp_path / "se_am.pt")
    save_checkpoint(se_am, build_sambert(se_cfg, seed=0), se_cfg)
    se = np.random.RandomState(0).randn(
        se_cfg["Model"]["KanTtsSAMBERT"]["params"]["speaker_units"]).astype(np.float32)
    np.save(tmp_path / "se.npy", se)
    svc = TTSService.from_checkpoints(se_am, voc, se_file=str(tmp_path / "se.npy"),
                                      frontend="pinyin", device="cpu")
    try:
        np.testing.assert_array_equal(svc.se, se)
        sr, wav = svc.synthesize(TEXTS[0])
        assert sr == 16000 and wav.size > 0 and np.isfinite(wav).all()
    finally:
        svc.close()
    with pytest.raises(NotImplementedError, match="item 11"):
        TTSService.from_checkpoints(am, voc, int8=True, device="cpu")
    svc = TTSService.from_checkpoints(*_nsf_checkpoints(slice_models, tmp_path),
                                      frontend="pinyin", device="cpu")
    try:
        assert svc.nsf_denorm is not None and svc.generator.nsf_params is not None
        with pytest.raises(ValueError, match="NSF"):
            svc.stream(TEXTS[0])
    finally:
        svc.close()


def test_nsf_service_serves(slice_models, tmp_path, monkeypatch):
    """An NSF pair behind the service: the acoustic model's f0 and uv are
    denormalised between the stages (the vocoder gets f0 >= 30 Hz and a
    binary uv), and each response has the length, rate and finiteness
    of its sentences. The noise depends on the batch's shape, so an NSF
    response is not compared with another run's."""
    svc = TTSService.from_checkpoints(*_nsf_checkpoints(slice_models, tmp_path),
                                      frontend="pinyin", max_batch=MAX_BATCH,
                                      max_wait_ms=100.0, device="cpu")
    seen = []
    vocode = svc._vocode_batch

    def spy(mels):
        seen.extend(mels)
        return vocode(mels)

    monkeypatch.setattr(svc, "_vocode_batch", spy)
    try:
        results = [None] * 3
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, svc.synthesize(TEXTS[i], timeout=120))) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
            assert not t.is_alive()
    finally:
        svc.close()
    assert len(seen) == 3
    for mel in seen:
        assert (mel[:, -2] >= 30).all() and set(np.unique(mel[:, -1])) <= {0.0, 1.0}
    frames = sorted(m.shape[0] for m in seen)
    for sr, wav in results:
        assert sr == 16000 and np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    # each text is one sentence: its mel's samples, then the 0.05 s tail
    assert sorted(len(w) - 800 for _, w in results) == [n * 16 for n in frames]


def test_coordinator_bookkeeping_under_thread_stress(slice_models, monkeypatch):
    """24 client threads (more than this box's cores) with a switch interval
    of 1 us, against models replaced by fast fakes that encode each
    sentence's identity: every request gets its own sentences back in
    order, no batch exceeds max_batch, and no count is lost."""
    svc = TTSService(slice_models["am"], slice_models["ling_unit"],
                     _vocoder(slice_models), 16000, frontend="pinyin",
                     max_batch=3, max_wait_ms=0.5, device="cpu")
    sizes = []

    def acoustic(seqs):
        sizes.append(len(seqs))
        return [np.full((2, 80), float(seq.split("$")[0][2:]), np.float32)
                for seq in seqs]

    monkeypatch.setattr(svc, "_acoustic_batch", acoustic)
    monkeypatch.setattr(svc, "_vocode_batch", lambda mels: [m[:, 0] for m in mels])
    sym = "{n_c$tone3$s_begin$word_begin$emotion_neutral$F7}"
    monkeypatch.setattr(svc, "_validate", lambda seqs: None)
    failures = []

    def client(k):
        try:
            for r in range(4):
                ids = [100 * k + 10 * r + j for j in range(1 + (k + r) % 3)]
                seqs = [sym.replace("n_c", f"x{i}", 1) for i in ids]
                wav = svc.synthesize_symbols(seqs, timeout=60)[1]
                got = [int(v) for v in wav if v != 0][::2]
                if got != ids:
                    failures.append((ids, got))
        except Exception as e:  # surface in the main thread
            failures.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(1, 25)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        svc.close()
    assert not any(th.is_alive() for th in threads)
    assert not failures, failures[:3]
    n_utts = sum(1 + (k + r) % 3 for k in range(1, 25) for r in range(4))
    snap = svc.stats_snapshot()
    assert snap["requests"] == 96 and snap["utterances"] == n_utts == sum(sizes)
    assert snap["batches"] == len(sizes) and max(sizes) <= 3 and snap["errors"] == 0


@pytest.mark.parametrize("entry", ["service", "serve_tts_cli", "stream_tts",
                                   "stream_tts_cli"])
def test_serving_entry_points_need_the_card(entry, slice_models, tmp_path,
                                            monkeypatch):
    """Given no device, the server, the service and stream_tts run on the
    card: without one they raise before they read or write a file."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = slice_models["ckpt_dir"]
    am, voc, out = str(d / "am.pt"), str(d / "voc.pt"), str(tmp_path / "out")
    calls = {
        "service": lambda: TTSService.from_checkpoints(am, voc),
        "serve_tts_cli": lambda: serve_tts.main(["--am_ckpt", am, "--voc_ckpt", voc]),
        "stream_tts": lambda: stream_tts.stream_tts(out, am, voc, "none.txt"),
        "stream_tts_cli": lambda: stream_tts.main(
            ["--txt", "none.txt", "--am_ckpt", am, "--voc_ckpt", voc,
             "--output_dir", out]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device; pass --device cpu"):
        calls[entry]()
    assert not os.path.exists(out)


def test_stream_tts_cli_matches_service(slice_models, service, tmp_path):
    d = slice_models["ckpt_dir"]
    text = tmp_path / "text.txt"
    text.write_text(TWO_SENTENCES + "\n", encoding="utf-8")
    stream_tts.main(["--txt", str(text), "--am_ckpt", str(d / "am.pt"),
                     "--voc_ckpt", str(d / "voc.pt"), "--output_dir",
                     str(tmp_path / "out"), "--frontend", "pinyin",
                     "--device", "cpu"])
    with open(tmp_path / "out" / "streaming_report.json") as f:
        report = json.load(f)
    assert [r["utt"] for r in report] == ["0_0", "0_1"]
    assert all(r["first_chunk_latency_s"] > 0 and r["device"] == "cpu" for r in report)
    # each sentence alone (B=1) against its row of a batched service call
    from scipy.io import wavfile

    for r, seq in zip(report, service._text_to_seqs(TWO_SENTENCES, None, None)):
        _, pcm = wavfile.read(tmp_path / "out" / f"{r['utt']}.wav")
        want = service.synthesize_symbols([seq])[1][:-int(0.05 * 16000)]
        assert pcm.shape == want.shape
        assert r["audio_seconds"] == pytest.approx(len(want) / 16000)
        np.testing.assert_allclose(pcm / 32767.0, want, atol=2 / 32767.0, rtol=0)


def test_serve_tts_cli_drains_on_sigterm(slice_models):
    """The server CLI in a subprocess on the CPU: warm up, bind port 0,
    answer one request, exit 0 on SIGTERM."""
    d = slice_models["ckpt_dir"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "kantts_tpu_torch.bin.serve_tts", "--am_ckpt",
         str(d / "am.pt"), "--voc_ckpt", str(d / "voc.pt"), "--port", "0",
         "--max_batch", "2", "--warmup_text", "ni3 hao3", "--device", "cpu"],
        cwd=ROOT, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    try:
        port = None
        for line in proc.stderr:
            if "serving on http://" in line:
                port = int(line.split("serving on http://")[1].split(" ")[0]
                           .rsplit(":", 1)[1])
                break
        assert port, "the server did not start"
        with _post(port, "/tts", b'{"text": "xie4 xie5"}') as resp:
            assert parse_wav_bytes(resp.read())[0] == 16000
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
