"""Synthetic training corpora made with numpy from a seed. The repository
holds no recorded corpus: these let training run end to end without one.

``write_am_corpus``: a SAM-BERT corpus in the layout that
``data.dataset.AMDataset`` reads: ``raw_metafile.txt`` of symbol
sequences, and per utterance ``mel/``, ``f0/`` and ``energy/`` arrays. Each
phone has its own random mel template, held over a random number of frames
with a little noise, so that the text-to-mel alignment is there to be
learnt; pitch and energy are constant over each phone. Without
``durations`` (``write_mas_corpus``) there is no ``duration/`` directory,
so the dataset runs in MAS mode, and pitch and energy are frame-level; with
it, ``duration/`` holds each phone's frames and pitch and energy are
phone-level. ``nsf`` adds the NSF features: ``frame_f0/`` (normalised,
constant over each phone), ``frame_uv/`` (0 or 1 per phone), and the
corpus statistics ``f0/f0_mean.txt`` and ``f0/f0_std.txt``. ``byte`` writes
the symbols of a byte voice (one byte token per phone, the phone's own byte
``BYTES[p]``); ``se_units`` adds the corpus's speaker embedding
``se/se.npy``, a seeded N(0, 1) vector of that size, for an SE voice.

``write_fp_corpus``: a filled-pause (FP) corpus with durations, in the
layout that the FP preprocessing leaves: ``fpadd_metafile.txt`` (the
filler syllables kept and tagged ``emotion_disgust``, their ``#3`` break
untagged, as ``preprocess/fp_processor.py`` tags them), ``fprm_metafile.txt``
(the fillers removed), both split into ``am_fp{add,rm}_{train,valid}.lst``,
and durations, pitch and energy over the fpadd tokens, whose audio holds
the fillers.

``write_text_corpus``: a Textsy-BERT corpus, ``raw_metafile.txt`` of
symbol sequences alone (``data.dataset.BERTTextDataset`` reads no audio).

``write_voc_corpus``: a vocoder corpus in the layout that
``data.dataset.VocDataset`` reads: ``wav/*.wav`` of harmonic tones and
their ``mel/*.npy``, made by the port's ``MelSpectrogramExtractor`` at the
values of ``kantts_tpu/configs/audio_config_{16k,24k}.yaml``. ``nsf`` adds
one unvoiced stretch per tone (the tone muted, the noise kept) and the
exact NSF features: ``frame_f0/`` is the tone's f0 at each frame's centre
sample, normalised by the corpus's mean and std over voiced frames
(``f0/f0_mean.txt``, ``f0/f0_std.txt``), ``frame_uv/`` is 0 on frames
whose centre falls in the stretch and 1 elsewhere.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import yaml

from kantts_tpu_torch.dsp.mel import MelSpectrogramExtractor
from kantts_tpu_torch.utils.audio import save_wav

PHONES = ("n_c", "i_c", "h_c", "ao_c", "sh_c", "in_c", "j_c", "ie_c", "b_c",
          "a_c", "d_c", "e_c", "g_c", "ai_c", "m_c", "en_c")
TONES = ("tone1", "tone2", "tone3", "tone4", "tone5")
BYTES = tuple(range(97, 97 + len(PHONES)))  # 'a'..'p': a byte per phone


def write_mas_corpus(root: str, n_utts: int, symbols: Tuple[int, int],
                     frames: Tuple[int, int], n_mels: int = 80, seed: int = 0
                     ) -> None:
    """``write_am_corpus`` without durations: a MAS corpus."""
    write_am_corpus(root, n_utts, symbols, frames, n_mels, seed)


def write_am_corpus(root: str, n_utts: int, symbols: Tuple[int, int],
                    frames: Tuple[int, int], n_mels: int = 80, seed: int = 0,
                    durations: bool = False, nsf: bool = False,
                    sampling_rate: int = 16000, byte: bool = False,
                    se_units: int = 0) -> None:
    """Write ``n_utts`` utterances under ``root``, each with a symbol count
    and a frame count drawn uniformly from the inclusive ranges ``symbols``
    and ``frames``; ``audio_config.yaml`` carries the feature values of
    ``sampling_rate``."""
    rng = np.random.RandomState(seed)
    subs = ["mel", "f0", "energy"] + (["duration"] if durations else []) + (
        ["frame_f0", "frame_uv"] if nsf else [])
    for sub in subs:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    templates = rng.randn(len(PHONES), n_mels).astype(np.float32)
    lines = []
    for i in range(n_utts):
        n_sym = rng.randint(symbols[0], symbols[1] + 1)
        n_frames = rng.randint(frames[0], frames[1] + 1)
        if n_frames < n_sym:
            raise ValueError(f"{n_frames} frames cannot hold {n_sym} symbols")
        ids = rng.randint(0, len(PHONES), n_sym)
        durs = 1 + rng.multinomial(n_frames - n_sym, np.full(n_sym, 1.0 / n_sym))
        mel = (np.repeat(templates[ids], durs, axis=0)
               + 0.1 * rng.randn(n_frames, n_mels)).astype(np.float32)
        utt = f"utt{i:04d}"
        np.save(os.path.join(root, "mel", f"{utt}.npy"), mel)
        for sub in ("f0", "energy"):
            per_phone = (rng.rand(n_sym) + 0.5).astype(np.float32)
            np.save(os.path.join(root, sub, f"{utt}.npy"),
                    per_phone if durations else np.repeat(per_phone, durs))
        if durations:
            np.save(os.path.join(root, "duration", f"{utt}.npy"), durs)
        tokens = []
        for j, p in enumerate(ids):
            flag = "s_begin" if j % 2 == 0 else "s_end"
            ws = "word_begin" if j % 2 == 0 else "word_end"
            tone = TONES[rng.randint(len(TONES))]
            tokens.append(f"{{{BYTES[p]}$emotion_neutral$F7}}" if byte else
                          f"{{{PHONES[p]}${tone}${flag}${ws}$emotion_neutral$F7}}")
        lines.append(f"{utt}\t{' '.join(tokens)}")
        if nsf:
            uv = (rng.rand(n_sym) < 0.8).astype(np.float32)
            np.save(os.path.join(root, "frame_f0", f"{utt}.npy"),
                    np.repeat(rng.randn(n_sym).astype(np.float32), durs))
            np.save(os.path.join(root, "frame_uv", f"{utt}.npy"), np.repeat(uv, durs))
    if nsf:
        _write_f0_stats(root, 150.0, 40.0)
    if se_units:
        os.makedirs(os.path.join(root, "se"), exist_ok=True)
        np.save(os.path.join(root, "se", "se.npy"),
                rng.randn(se_units).astype(np.float32))
    with open(os.path.join(root, "raw_metafile.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    audio = AUDIO[sampling_rate]
    with open(os.path.join(root, "audio_config.yaml"), "w", encoding="utf-8") as f:
        yaml.safe_dump({"audio_config": {
            "sampling_rate": sampling_rate, "hop_length": audio["hop_length"],
            "win_length": audio["win_length"], "n_fft": audio["n_fft"],
            "n_mels": n_mels}}, f)


def _write_f0_stats(root: str, mean: float, std: float) -> None:
    os.makedirs(os.path.join(root, "f0"), exist_ok=True)
    np.savetxt(os.path.join(root, "f0", "f0_mean.txt"), [mean])
    np.savetxt(os.path.join(root, "f0", "f0_std.txt"), [std])


def write_text_corpus(root: str, n_utts: int, symbols: Tuple[int, int],
                      seed: int = 0) -> None:
    """Write ``raw_metafile.txt`` of ``n_utts`` symbol sequences under
    ``root``, each of a length drawn from the inclusive range ``symbols``,
    and an empty ``audio_config.yaml``."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    lines = []
    for i in range(n_utts):
        n_sym = rng.randint(symbols[0], symbols[1] + 1)
        tokens = [f"{{{PHONES[rng.randint(len(PHONES))]}${TONES[rng.randint(len(TONES))]}$"
                  f"{'s_begin' if j % 2 == 0 else 's_end'}$"
                  f"{'word_begin' if j % 2 == 0 else 'word_end'}$emotion_neutral$F7}}"
                  for j in range(n_sym)]
        lines.append(f"utt{i:04d}\t{' '.join(tokens)}\n")
    with open(os.path.join(root, "raw_metafile.txt"), "w", encoding="utf-8") as f:
        f.writelines(lines)
    with open(os.path.join(root, "audio_config.yaml"), "w", encoding="utf-8") as f:
        yaml.safe_dump({"audio_config": {}}, f)


FILLERS = (("ga", "a_c"), ("ge", "en_c"), ("ge", "e_c"))


def write_fp_corpus(root: str, n_utts: int, symbols: Tuple[int, int],
                    frames: Tuple[int, int], n_mels: int = 80, seed: int = 0,
                    sampling_rate: int = 8000) -> None:
    """Write ``n_utts`` utterances under ``root``: symbol and frame counts
    drawn from the inclusive ranges (the frames cover the fillers too).
    Utterance i has a filler at the start (i % 3 == 0), in the middle
    (1) or at the end (2), and every second one another in the middle;
    the three filler syllable pairs take turns."""
    from kantts_tpu_torch.data.dataset import AMDataset

    rng = np.random.RandomState(seed)
    for sub in ("mel", "f0", "energy", "duration"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    templates = rng.randn(len(PHONES) + 3, n_mels).astype(np.float32)
    fpadd, fprm = [], []
    for i in range(n_utts):
        n_sym = rng.randint(symbols[0], symbols[1] + 1)
        ids = rng.randint(0, len(PHONES), n_sym)
        base = [f"{{{PHONES[p]}${TONES[rng.randint(len(TONES))]}$"
                f"{'s_begin' if j % 2 == 0 else 's_end'}$"
                f"{'word_begin' if j % 2 == 0 else 'word_end'}$emotion_neutral$F7}}"
                for j, p in enumerate(ids)]
        places = [(0, n_sym // 2, n_sym)[i % 3]] + (
            [rng.randint(1, n_sym)] if i % 2 else [])
        tokens, units = [], []
        for j in range(n_sym + 1):
            for _ in range(places.count(j)):
                k = rng.randint(len(FILLERS))
                onset, coda = FILLERS[k]
                tokens += [f"{{{onset}$tone5$s_begin$word_begin$emotion_disgust$F7}}",
                           f"{{{coda}$tone5$s_end$word_end$emotion_disgust$F7}}",
                           "{#3$tone_none$s_none$word_none$emotion_neutral$F7}"]
                units += [len(PHONES) + k] * 3
            if j < n_sym:
                tokens.append(base[j])
                units.append(ids[j])
        n_tok = len(tokens)
        n_frames = max(rng.randint(frames[0], frames[1] + 1), n_tok)
        durs = 1 + rng.multinomial(n_frames - n_tok, np.full(n_tok, 1.0 / n_tok))
        mel = (np.repeat(templates[units], durs, axis=0)
               + 0.1 * rng.randn(n_frames, n_mels)).astype(np.float32)
        utt = f"utt{i:04d}"
        np.save(os.path.join(root, "mel", f"{utt}.npy"), mel)
        np.save(os.path.join(root, "duration", f"{utt}.npy"), durs)
        for sub in ("f0", "energy"):
            np.save(os.path.join(root, sub, f"{utt}.npy"),
                    (rng.rand(n_tok) + 0.5).astype(np.float32))
        fpadd.append(f"{utt}\t{' '.join(tokens)}\n")
        fprm.append(f"{utt}\t{' '.join(base)}\n")
    for name, lines in (("fpadd", fpadd), ("fprm", fprm)):
        meta = os.path.join(root, f"{name}_metafile.txt")
        with open(meta, "w", encoding="utf-8") as f:
            f.writelines(lines)
        AMDataset.gen_metafile(meta, root, os.path.join(root, f"am_{name}_train.lst"),
                               os.path.join(root, f"am_{name}_valid.lst"))
    with open(os.path.join(root, "raw_metafile.txt"), "w", encoding="utf-8") as f:
        f.writelines(fpadd)
    audio = AUDIO[sampling_rate]
    with open(os.path.join(root, "audio_config.yaml"), "w", encoding="utf-8") as f:
        yaml.safe_dump({"audio_config": {
            "sampling_rate": sampling_rate, "hop_length": audio["hop_length"],
            "win_length": audio["win_length"], "n_fft": audio["n_fft"],
            "n_mels": n_mels}}, f)


# the feature values of kantts_tpu/configs/audio_config_8k.yaml
AUDIO_8K = {"sampling_rate": 8000, "n_fft": 2048, "hop_length": 100,
            "win_length": 600, "n_mels": 80, "fmin": 0.0, "fmax": 4000.0,
            "max_norm": 1.0, "min_level_db": -100.0, "ref_level_db": 20,
            "symmetric": False}
# the feature values of kantts_tpu/configs/audio_config_16k.yaml
AUDIO_16K = {"sampling_rate": 16000, "n_fft": 2048, "hop_length": 200,
             "win_length": 1000, "n_mels": 80, "fmin": 0.0, "fmax": 8000.0,
             "max_norm": 1.0, "min_level_db": -100.0, "ref_level_db": 20,
             "symmetric": False}
# the feature values of kantts_tpu/configs/audio_config_24k.yaml
AUDIO_24K = {"sampling_rate": 24000, "n_fft": 1024, "hop_length": 240,
             "win_length": 1024, "n_mels": 80, "fmin": 50.0, "fmax": 8000.0,
             "max_norm": 1.0, "min_level_db": -100.0, "ref_level_db": 20,
             "symmetric": False}
AUDIO = {8000: AUDIO_8K, 16000: AUDIO_16K, 24000: AUDIO_24K}


def write_voc_corpus(root: str, n_utts: int, seconds: Tuple[float, float],
                     seed: int = 0, sampling_rate: int = 16000,
                     nsf: bool = False) -> None:
    """Write ``n_utts`` utterances under ``root``, each of a length drawn
    uniformly from the range ``seconds``: a tone whose f0 glides around a
    random base of 90-260 Hz, with 6 harmonics at amplitudes 1/k, an
    envelope rising and falling over the utterance with a slow tremolo, and
    a little white noise; peak near 0.5. With ``nsf``, the tone is muted
    over a random 10-25% of the utterance. Then ``audio_config.yaml``;
    ``get_voc_datasets`` writes ``train.lst``/``valid.lst`` itself."""
    audio = AUDIO[sampling_rate]
    sr, hop = audio["sampling_rate"], audio["hop_length"]
    rng = np.random.RandomState(seed)
    for sub in ("wav", "mel") + (("frame_f0", "frame_uv") if nsf else ()):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    extract = MelSpectrogramExtractor(
        sr, audio["n_fft"], hop, audio["win_length"], audio["n_mels"],
        audio["max_norm"], audio["min_level_db"], audio["ref_level_db"],
        audio["fmin"], audio["fmax"], audio["symmetric"])
    frame_f0s = {}
    for i in range(n_utts):
        n = int(rng.uniform(*seconds) * sr)
        t = np.arange(n) / sr
        f0 = rng.uniform(90, 260) * (1 + 0.15 * np.sin(2 * np.pi * rng.uniform(0.3, 2)
                                                        * t + rng.uniform(0, 6.3)))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        tone = sum(np.sin(k * phase + rng.uniform(0, 6.3)) / k for k in range(1, 7))
        envelope = (np.sqrt(np.clip(np.sin(np.pi * t / t[-1]), 0.0, None))
                    * (1 + 0.3 * np.sin(2 * np.pi * rng.uniform(2, 6) * t)))
        noise = 0.02 * rng.randn(n)
        voiced = np.ones(n, dtype=bool)
        if nsf:
            gap = int(rng.uniform(0.1, 0.25) * n)
            start = rng.randint(0, n - gap)
            voiced[start:start + gap] = False
        wav = tone * envelope * voiced + noise
        wav = (0.5 * wav / np.abs(wav).max()).astype(np.float32)
        utt = f"utt{i:04d}"
        save_wav(wav, os.path.join(root, "wav", f"{utt}.wav"), sr)
        mel = extract(wav)
        if len(mel) * hop < n:
            raise AssertionError(f"{utt}: {len(mel)} frames for {n} samples")
        np.save(os.path.join(root, "mel", f"{utt}.npy"), mel.astype(np.float32))
        if nsf:
            centres = np.minimum(np.arange(len(mel)) * hop, n - 1)
            frame_f0s[utt] = (f0[centres], voiced[centres].astype(np.float32))
    if nsf:
        voiced_f0 = np.concatenate([f[uv > 0] for f, uv in frame_f0s.values()])
        mean, std = float(voiced_f0.mean()), float(voiced_f0.std())
        _write_f0_stats(root, mean, std)
        for utt, (f0, uv) in frame_f0s.items():
            np.save(os.path.join(root, "frame_f0", f"{utt}.npy"),
                    ((f0 - mean) / std).astype(np.float32))
            np.save(os.path.join(root, "frame_uv", f"{utt}.npy"), uv)
    with open(os.path.join(root, "audio_config.yaml"), "w", encoding="utf-8") as f:
        yaml.safe_dump({"audio_config": dict(audio)}, f)


# the syllables of the synthetic voices: a hanzi and its toneless pinyin
SYLLABLES = (("你", "ni"), ("好", "hao"), ("世", "shi"), ("界", "jie"),
             ("这", "zhe"), ("测", "ce"), ("句", "jv"), ("子", "zi"),
             ("我", "wo"), ("们", "men"), ("公", "gong"), ("散", "san"),
             ("步", "bu"), ("天", "tian"), ("气", "qi"), ("很", "hen"),
             ("北", "bei"), ("京", "jing"), ("欢", "huan"), ("迎", "ying"),
             ("来", "lai"), ("到", "dao"), ("大", "da"), ("家", "jia"),
             ("学", "xve"), ("生", "sheng"), ("人", "ren"), ("国", "guo"),
             ("中", "zhong"), ("文", "wen"), ("音", "yin"), ("和", "he"),
             ("成", "cheng"), ("的", "de"), ("谢", "xie"), ("在", "zai"),
             ("说", "shuo"), ("一", "yi"), ("遍", "bian"), ("个", "ge"),
             ("爱", "ai"), ("妈", "ma"), ("花", "hua"), ("山", "shan"),
             ("水", "shui"), ("风", "feng"), ("星", "xing"), ("春", "chun"),
             ("夏", "xia"), ("秋", "qiu"), ("冬", "dong"), ("请", "qing"))
FILLER_SYLLABLES = (("嗯", "en"), ("啊", "a"), ("呃", "e"))
# onsets of zero-initial syllables: symbols without an interval of their own
ZERO_ONSETS = ("ga", "ge", "go")
# f0 contours of the four tones, as multiples of the speaker's base f0
TONE_CONTOURS = {1: (1.2, 1.2, 1.2), 2: (0.9, 1.0, 1.25), 3: (1.0, 0.8, 1.0),
                 4: (1.3, 1.1, 0.85)}


def _word_segments(rng, pinyins, sy2ph):
    """(phone, frames, tone) of a word's phones: an initial is unvoiced for
    4-8 frames, a final voiced for 8-16; zero-initial onsets take none."""
    segs = []
    for py in pinyins:
        phones, tone = sy2ph[py[:-1]], int(py[-1])
        for j, phone in enumerate(phones):
            if phone in ZERO_ONSETS:
                continue
            initial = len(phones) == 2 and j == 0
            segs.append((phone, rng.randint(4, 9) if initial else rng.randint(8, 17),
                         None if initial else tone))
    return segs


def _interval_text(segs, frame_s: float) -> str:
    total = sum(n for _, n, _ in segs) * frame_s
    lines = ['File type = "ooTextFile short"', '"TextGrid"', "", "0", f"{total:.4f}",
             "<exists>", "1", '"IntervalTier"', '"phones"', "0", f"{total:.4f}",
             str(len(segs))]
    at = 0
    for phone, n, _ in segs:
        lines += [f"{at * frame_s:.4f}", f"{(at + n) * frame_s:.4f}", f'"{phone}"']
        at += n
    return "\n".join(lines) + "\n"


def _voice_wav(rng, segs, sr: int, hop: int, base_f0: float, gain: float):
    """Harmonic finals on their tone's f0 contour, noise initials, near
    silence at ``sil`` and ``sp``; peak ``gain``."""
    n = sum(k for _, k, _ in segs) * hop
    f0 = np.zeros(n)
    amp = np.zeros(n)
    noise_amp = np.full(n, 0.003)
    at = 0
    for phone, k, tone in segs:
        span = slice(at * hop, (at + k) * hop)
        m = k * hop
        ramp = np.minimum(1.0, np.minimum(np.arange(m), np.arange(m)[::-1]) / (0.01 * sr))
        if tone is not None:
            contour = base_f0 * np.array(TONE_CONTOURS.get(tone, (1.0, 1.0, 1.0)))
            f0[span] = np.interp(np.linspace(0, 2, m), [0, 1, 2], contour)
            amp[span] = rng.uniform(0.6, 1.0) * ramp
        elif phone not in ("sil", "sp"):
            noise_amp[span] = rng.uniform(0.1, 0.3) * ramp
        at += k
    phase = 2 * np.pi * np.cumsum(f0) / sr
    tone = sum(np.sin(h * phase + rng.uniform(0, 6.3)) / h for h in range(1, 7))
    wav = amp * tone + noise_amp * rng.randn(n)
    return (gain * wav / np.abs(wav).max()).astype(np.float32)


def write_voice_dir(root: str, n_utts: int, seconds: Tuple[float, float],
                    seed: int = 0, interval: bool = True, mode: str = "prosody",
                    sampling_rate: int = 16000) -> None:
    """Write a raw voice directory, the input of ``bin/process_data.py``:
    ``wav/`` of ``n_utts`` utterances, each of a length drawn from the
    range ``seconds``, and their text. Each utterance is a sentence of 1-3
    syllable words from ``SYLLABLES`` with random tones and breaks (#1 to
    #3); its audio holds near-silent edges of 0.1-0.3 s, a noise burst for
    each initial, a harmonic final on its tone's f0 contour around a base
    of 100-240 Hz, pauses at some #2/#3 breaks, a noise floor, and a peak
    drawn log-uniformly from [0.05, 0.9] so that the corpus spreads in
    loudness. ``mode``:

    - ``"prosody"``: ``prosody/prosody.txt``, a text line with its breaks
      and a tone-numbered pinyin line per utterance;
    - ``"fp"``: the same with one or two filled pauses (``FILLER_SYLLABLES``)
      per utterance, and the FP annotation block after each text line: the
      FP/N label of each syllable, two annotation lines that the parsers
      skip, then the pinyin line;
    - ``"byte"``: ``text/text.txt``, the hanzi sentence with a comma at
      pauses and a full stop at its end (a byte voice has no phones, so it
      takes no ``interval``).

    ``interval`` writes ``interval/<utt>.interval``, TextGrid-style frame
    aligned intervals in the format of ``parse_interval_file``: ``sil`` at
    both edges, ``sp`` at the pauses, and each phone symbol of the metafile
    but the zero-initial onsets ``ZERO_ONSETS``, which calibration gives no
    frames."""
    from kantts_tpu_torch.text.lang_symbols import load_language_resource

    if mode not in ("prosody", "fp", "byte"):
        raise ValueError(f"mode must be prosody, fp or byte, got {mode}")
    if mode == "byte" and interval:
        raise ValueError("a byte voice has no phone intervals: pass interval=False")
    sy2ph = load_language_resource("PinYin")["sy2ph"]
    hop = AUDIO[sampling_rate]["hop_length"]
    rng = np.random.RandomState(seed)
    subs = ["wav", "text" if mode == "byte" else "prosody"] + (
        ["interval"] if interval else [])
    for sub in subs:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    lines = []
    for i in range(n_utts):
        utt = f"utt{i:04d}"
        edges = [rng.randint(8, 25), rng.randint(8, 25)]
        target = int(rng.uniform(*seconds) * sampling_rate / hop) - sum(edges)
        words, frames = [], 0
        while frames < target or not words:
            chars = [SYLLABLES[k] for k in rng.randint(0, len(SYLLABLES),
                                                       rng.randint(1, 4))]
            pinyins = [f"{py}{rng.randint(1, 5)}" for _, py in chars]
            segs = _word_segments(rng, pinyins, sy2ph)
            words.append(["".join(c for c, _ in chars), pinyins, segs, False])
            frames += sum(n for _, n, _ in segs)
        if mode == "fp":
            for _ in range(1 + rng.randint(2)):
                char, py = FILLER_SYLLABLES[rng.randint(len(FILLER_SYLLABLES))]
                pinyins = [f"{py}{rng.randint(1, 5)}"]
                words.insert(rng.randint(len(words) + 1),
                             [char, pinyins, _word_segments(rng, pinyins, sy2ph), True])
        segs, text, bytes_text = [("sil", edges[0], None)], "", ""
        for w, (chars, _, word_segs, _) in enumerate(words):
            segs += word_segs
            text += chars
            bytes_text += chars
            if w == len(words) - 1:
                break
            level = (1, 1, 1, 2, 3)[rng.randint(5)]
            text += f"#{level}"
            if level > 1 and rng.rand() < 0.7:
                segs.append(("sp", rng.randint(8, 21), None))
                bytes_text += "，"
        segs.append(("sil", edges[1], None))
        wav = _voice_wav(rng, segs, sampling_rate, hop, rng.uniform(100, 240),
                         float(np.exp(rng.uniform(np.log(0.05), np.log(0.9)))))
        save_wav(wav, os.path.join(root, "wav", f"{utt}.wav"), sampling_rate)
        if interval:
            with open(os.path.join(root, "interval", f"{utt}.interval"), "w") as f:
                f.write(_interval_text(segs, hop / sampling_rate))
        pinyin_line = "\t" + " ".join(py for _, pys, _, _ in words for py in pys)
        if mode == "byte":
            lines.append(f"{utt}\t{bytes_text}。")
        elif mode == "fp":
            labels = " ".join(("FP" if fp else "N") for _, pys, _, fp in words
                              for _ in pys)
            lines += [f"{utt}\t{text}", labels, labels.replace("FP", "N"),
                      labels.replace("FP", "N"), pinyin_line]
        else:
            lines += [f"{utt}\t{text}", pinyin_line]
    path = (os.path.join(root, "text", "text.txt") if mode == "byte"
            else os.path.join(root, "prosody", "prosody.txt"))
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


# the widths of KAN-TTS's D-TDNN speaker embedder at its defaults
DTDNN_WIDTHS = {"n_mels": 80, "head": 32, "tdnn": 128, "growth": 32,
                "bottleneck": 128, "se_reduction": 2, "embedding": 192}


def dtdnn_state_dict(seed: int = 0, widths=None) -> dict:
    """A seeded D-TDNN state dict with the keys of KAN-TTS's ``se.model``
    (``preprocess/se_processor.py::DTDNN`` reads its widths from the
    shapes): ``widths`` updates ``DTDNN_WIDTHS``. Convolutions are He-scaled
    normals (a quarter of that in the SE gates, whose input is a sum of a
    mean and a maximum, so that the gates do not saturate); BatchNorm
    running means lie in [-0.5, 0.5] and variances in
    [0.5, 2], affine scales in [0.5, 1.5] and shifts in [-0.2, 0.2], so no
    layer is an identity; every BatchNorm carries ``num_batches_tracked``,
    as a trained checkpoint does."""
    import torch

    w = dict(DTDNN_WIDTHS, **(widths or {}))
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(prefix, c_out, c_in, *kernel, bias=False, gain=1.0):
        fan_in = c_in * int(np.prod(kernel))
        sd[f"{prefix}.weight"] = rng.randn(c_out, c_in, *kernel) * (
            gain * np.sqrt(2.0 / fan_in))
        if bias:
            sd[f"{prefix}.bias"] = 0.1 * rng.randn(c_out)

    def bn(prefix, c, affine=True):
        if affine:
            sd[f"{prefix}.weight"] = rng.uniform(0.5, 1.5, c)
            sd[f"{prefix}.bias"] = rng.uniform(-0.2, 0.2, c)
        sd[f"{prefix}.running_mean"] = rng.uniform(-0.5, 0.5, c)
        sd[f"{prefix}.running_var"] = rng.uniform(0.5, 2.0, c)
        sd[f"{prefix}.num_batches_tracked"] = np.array(1000)

    c = w["head"]
    conv("head.conv1", c, 1, 3, 3)
    bn("head.bn1", c)
    for layer in ("layer1", "layer2"):
        for i in range(2):
            p = f"head.{layer}.{i}"
            conv(f"{p}.conv1", c, c, 3, 3)
            bn(f"{p}.bn1", c)
            conv(f"{p}.conv2", c, c, 3, 3)
            bn(f"{p}.bn2", c)
            if i == 0:  # the stride-2 block
                conv(f"{p}.shortcut.0", c, c, 1, 1)
                bn(f"{p}.shortcut.1", c)
    conv("head.conv2", c, c, 3, 3)
    bn("head.bn2", c)
    freq = w["n_mels"]
    for _ in range(3):  # three stride-2 (pad 1, kernel 3) convs over frequency
        freq = (freq - 1) // 2 + 1
    conv("xvector.tdnn.linear", w["tdnn"], c * freq, 5)
    bn("xvector.tdnn.nonlinear.batchnorm", w["tdnn"])
    width, bottleneck = w["tdnn"], w["bottleneck"]
    hidden = bottleneck // w["se_reduction"]
    for bi, n_layers in enumerate((12, 24, 16), start=1):
        for li in range(1, n_layers + 1):
            p = f"xvector.block{bi}.tdnnd{li}"
            bn(f"{p}.nonlinear1.batchnorm", width)
            conv(f"{p}.linear1", bottleneck, width, 1)
            bn(f"{p}.nonlinear2.batchnorm", bottleneck)
            conv(f"{p}.se.linear_stem", w["growth"], bottleneck, 3)
            conv(f"{p}.se.linear1", hidden, bottleneck, 1, bias=True, gain=0.25)
            conv(f"{p}.se.linear2", w["growth"], hidden, 1, bias=True, gain=0.25)
            width += w["growth"]
        bn(f"xvector.transit{bi}.nonlinear.batchnorm", width)
        conv(f"xvector.transit{bi}.linear", width // 2, width, 1)
        width //= 2
    bn("bn", width)
    conv("xvector.dense.linear", w["embedding"], 2 * width, 1)
    bn("xvector.dense.nonlinear.batchnorm", w["embedding"], affine=False)
    return {k: torch.from_numpy(np.asarray(v, dtype=np.int64 if k.endswith(
        "num_batches_tracked") else np.float32)) for k, v in sd.items()}
