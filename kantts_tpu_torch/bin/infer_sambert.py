"""SAM-BERT acoustic inference: symbol sequences -> mel (+dur/f0/energy)
(counterpart of ``kantts_tpu/bin/infer_sambert.py``).

Per line of the sentence file (``utt_id<TAB>symbols``) it writes
``feat/{utt}_mel.npy`` and the duration, f0 and energy text files.
Utterances of a group pad to a common symbol bucket (a multiple of
``input_bucket``) and get a frame budget of ``frames_per_symbol`` per padded
symbol, as in the JAX package; ``--batch`` groups utterances per forward. An
SE voice takes its speaker embedding from ``--se_file`` (a (speaker_units,)
npy), repeated over the symbols; other voices ignore it.

    python -m kantts_tpu_torch.bin.infer_sambert --sentence S --ckpt AM.pt \
        --output_dir OUT [--batch B] [--se_file SE.npy] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import List, Optional, Union

import numpy as np
import torch

from kantts_tpu_torch.models.builder import load_checkpoint
from kantts_tpu_torch.models.sambert.sambert import KanTtsSAMBERT, sambert_infer
from kantts_tpu_torch.text.ling_unit import KanTtsLinguisticUnit
from kantts_tpu_torch.utils.device import resolve_device, synchronize


def denorm_f0(mel: np.ndarray, f0_threshold: float = 30, uv_threshold: float = 0.6,
              norm_type: str = "mean_std", f0_feature=None) -> np.ndarray:
    """Denormalise the f0 and uv channels appended to an NSF mel (T, C), in
    place, and return it: uv -> 0/1 at ``uv_threshold``; f0 * std + mean
    with ``f0_feature`` the (2, 1) [mean; std] array (``mean_std``), or
    f0 * (max - min) + min with ``f0_feature`` = [max, min] (``global``);
    then f0 floored at ``f0_threshold``."""
    f0 = mel[:, -2]
    uv = np.where(mel[:, -1] < uv_threshold, 0.0, 1.0)
    if norm_type == "mean_std":
        f0 = f0 * f0_feature[1:, :].squeeze() + f0_feature[0:1, :].squeeze()
    else:  # global
        f0_max, f0_min = f0_feature
        f0 = f0 * (f0_max - f0_min) + f0_min
    mel[:, -2] = np.maximum(f0, f0_threshold)
    mel[:, -1] = uv
    return mel


def nsf_denormaliser(params: dict, ckpt: str):
    """``params``: a SAM-BERT's params (``model.config``) -> a function that
    denormalises its mel (``denorm_f0`` with the statistics of its norm
    type), or None for a non-NSF model."""
    if not params.get("NSF", False):
        return None
    norm_type = params.get("nsf_norm_type", "mean_std")
    if norm_type == "mean_std":
        f0_feature = np.load(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(ckpt))), "mvn.npy"))
    else:
        f0_feature = [params.get("nsf_f0_global_maximum", 730.0),
                      params.get("nsf_f0_global_minimum", 30.0)]
    return lambda mel: denorm_f0(mel.copy(), norm_type=norm_type,
                                 f0_feature=f0_feature)


def encode_symbol_inputs(ling_unit, symbol_seq: str, max_input_len: int,
                         n_ling: int = 4, se: Optional[np.ndarray] = None):
    """One symbol sequence -> padded int32 arrays (ling (1, L, n_ling), emo
    (1, L), spk (1, L), lengths (1,)): the trailing EOS is dropped and each
    track pads with its own pad id. With ``se`` the speaker input is that
    embedding repeated over all L positions, (1, L, speaker_units) float32."""
    feats = ling_unit.encode_symbol_sequence(symbol_seq)
    n = len(feats[0]) - 1
    if n > max_input_len:
        raise ValueError(f"utterance has {n} symbols > budget {max_input_len}")
    types = ling_unit.lfeat_type_list

    def pad_track(i):
        return np.pad(feats[i][:-1], (0, max_input_len - n),
                      constant_values=ling_unit.pad_id(types[i]))

    ling = np.stack([pad_track(i) for i in range(n_ling)], axis=-1)
    if se is not None:
        spk = np.repeat(se.reshape(1, -1), max_input_len, axis=0).astype(np.float32)
    else:
        spk = pad_track(n_ling + 1).astype(np.int32)
    return (ling[None].astype(np.int32), pad_track(n_ling)[None].astype(np.int32),
            spk[None], np.asarray([n], dtype=np.int32))


def load_se(model: KanTtsSAMBERT, se_file: Optional[str]) -> Optional[np.ndarray]:
    """The speaker embedding an SE voice reads from ``se_file``; None for any
    other voice, which ignores the file, as the JAX package does."""
    if not model.se_enable:
        return None
    if se_file is None:
        raise ValueError("an SE voice needs its speaker embedding: pass se_file")
    return np.load(se_file).astype(np.float32)


def am_synthesis_batch(symbol_seqs: List[str], model: KanTtsSAMBERT,
                       ling_unit, input_bucket: int = 32,
                       frames_per_symbol: int = 24,
                       batch_pad_to: Optional[int] = None,
                       se: Optional[np.ndarray] = None):
    """A group of utterances through one acoustic forward. The batch pads
    to ``batch_pad_to`` by repeating the last item; per-item band widths keep
    each utterance's output what its own B=1 run gives. ``se`` is an SE
    voice's speaker embedding (``load_se``). Returns one (dec_mel,
    postnet_mel, durations, f0, energy) of numpy arrays per input."""
    device = next(model.parameters()).device
    r = model.r
    n_ling = 1 if ling_unit.using_byte() else 4
    ns = [len(ling_unit.encode_symbol_sequence(s)[0]) - 1 for s in symbol_seqs]
    L_in = int(np.ceil(max(max(ns), 1) / input_bucket) * input_bucket)
    parts = [encode_symbol_inputs(ling_unit, s, L_in, n_ling, se)
             for s in symbol_seqs]
    parts += [parts[-1]] * ((batch_pad_to or 0) - len(parts))
    ling, emo, spk, lengths = (
        torch.from_numpy(np.concatenate([p[i] for p in parts])).to(device)
        for i in range(4))
    max_output_len = int(np.ceil(L_in * frames_per_symbol / r) * r)
    res = sambert_infer(model, ling.long(), emo.long(),
                        spk if se is not None else spk.long(), lengths,
                        max_output_len)
    res = {k: v.cpu().numpy() for k, v in res.items()}
    durs = np.floor(np.exp(res["log_duration_predictions"]) - 1 + 0.5
                    ).astype(np.int64)
    outs = []
    for i, n in enumerate(ns):
        valid = int(res["LR_length_rounded"][i])
        if valid == 0:
            logging.warning("predicted zero total duration; emitting %d frames", r)
            valid = r
        outs.append((res["dec_outputs"][i, :valid],
                     res["postnet_outputs"][i, :valid], durs[i, :n],
                     res["pitch_predictions"][i, :n],
                     res["energy_predictions"][i, :n]))
    return outs


def am_synthesis(symbol_seq: str, model: KanTtsSAMBERT, ling_unit,
                 input_bucket: int = 32, frames_per_symbol: int = 24,
                 se: Optional[np.ndarray] = None):
    """One utterance (B=1) through ``am_synthesis_batch``."""
    return am_synthesis_batch([symbol_seq], model, ling_unit,
                              input_bucket=input_bucket,
                              frames_per_symbol=frames_per_symbol, se=se)[0]


def load_am(ckpt: str, device: torch.device):
    """-> (KanTtsSAMBERT in eval mode on ``device``, its linguistic unit)."""
    model, config = load_checkpoint(ckpt, device)
    return model, KanTtsLinguisticUnit(config)


def am_infer(sentence: str, ckpt: str, output_dir: str, batch: int = 1,
             device: Union[str, torch.device] = "cuda",
             se_file: Optional[str] = None) -> dict:
    """Synthesize every line of ``sentence`` on ``device`` ("cuda", the
    default, raises without a card; or "cpu"); returns {"frames", "seconds"}
    over the acoustic forwards (the clock read after a device sync).
    ``se_file``: an SE voice's speaker embedding (``load_se``)."""
    device = resolve_device(device)
    model, ling_unit = load_am(ckpt, device)
    se = load_se(model, se_file)
    denorm = nsf_denormaliser(model.config, ckpt)
    results_dir = os.path.join(output_dir, "feat")
    os.makedirs(results_dir, exist_ok=True)
    with open(sentence, encoding="utf-8") as f:
        utts = [tuple(p[:2]) for p in (line.strip().split("\t") for line in f)
                if len(p) >= 2]

    # longest first, so that a group shares its symbol bucket
    order = sorted(range(len(utts)), key=lambda i: -len(utts[i][1]))
    batch = max(batch, 1)
    frames, seconds = 0, 0.0
    for g0 in range(0, len(order), batch):
        group = order[g0:g0 + batch]
        synchronize(device)
        t0 = time.perf_counter()
        results = am_synthesis_batch([utts[i][1] for i in group], model,
                                     ling_unit, batch_pad_to=batch, se=se)
        synchronize(device)
        elapsed = time.perf_counter() - t0
        n_frames = sum(res[1].shape[0] for res in results)
        logging.info("%d utterance(s): %d frames in %.3fs", len(group),
                     n_frames, elapsed)
        frames += n_frames
        seconds += elapsed
        for i, (_, mel_post, dur, f0, energy) in zip(group, results):
            utt_id = utts[i][0]
            if denorm is not None:
                mel_post = denorm(mel_post)
            np.save(os.path.join(results_dir, f"{utt_id}_mel.npy"), mel_post)
            np.savetxt(os.path.join(results_dir, f"{utt_id}_dur.txt"), dur)
            np.savetxt(os.path.join(results_dir, f"{utt_id}_f0.txt"), f0)
            np.savetxt(os.path.join(results_dir, f"{utt_id}_energy.txt"), energy)
    return {"frames": frames, "seconds": seconds}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--sentence", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--batch", type=int, default=1,
                        help="utterances per acoustic forward")
    parser.add_argument("--se_file", type=str, default=None,
                        help="speaker embedding (.npy) of an SE voice")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    am_infer(args.sentence, args.ckpt, args.output_dir, batch=args.batch,
             device=args.device, se_file=args.se_file)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main()
