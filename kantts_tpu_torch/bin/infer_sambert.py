"""SAM-BERT acoustic inference: symbol sequences -> mel (+dur/f0/energy)
(counterpart of ``kantts_tpu/bin/infer_sambert.py``).

Per line of the sentence file (``utt_id<TAB>symbols``) it writes
``feat/{utt}_mel.npy`` and the duration, f0 and energy text files.
Utterances of a group pad to a common symbol bucket (a multiple of
``input_bucket``) and get a frame budget of ``frames_per_symbol`` per padded
symbol, as in the JAX package; ``--batch`` groups utterances per forward.

    python -m kantts_tpu_torch.bin.infer_sambert --sentence S --ckpt AM.pt \
        --output_dir OUT [--batch B] [--device cuda|cpu]
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


def encode_symbol_inputs(ling_unit, symbol_seq: str, max_input_len: int,
                         n_ling: int = 4):
    """One symbol sequence -> padded int32 arrays (ling (1, L, n_ling), emo
    (1, L), spk (1, L), lengths (1,)): the trailing EOS is dropped and each
    track pads with its own pad id."""
    feats = ling_unit.encode_symbol_sequence(symbol_seq)
    n = len(feats[0]) - 1
    if n > max_input_len:
        raise ValueError(f"utterance has {n} symbols > budget {max_input_len}")
    types = ling_unit.lfeat_type_list

    def pad_track(i):
        return np.pad(feats[i][:-1], (0, max_input_len - n),
                      constant_values=ling_unit.pad_id(types[i]))

    ling = np.stack([pad_track(i) for i in range(n_ling)], axis=-1)
    emo, spk = pad_track(n_ling), pad_track(n_ling + 1)
    return (ling[None].astype(np.int32), emo[None].astype(np.int32),
            spk[None].astype(np.int32), np.asarray([n], dtype=np.int32))


def am_synthesis_batch(symbol_seqs: List[str], model: KanTtsSAMBERT,
                       ling_unit, input_bucket: int = 32,
                       frames_per_symbol: int = 24,
                       batch_pad_to: Optional[int] = None):
    """A group of utterances through one acoustic forward. The batch pads
    to ``batch_pad_to`` by repeating the last item; per-item band widths keep
    each utterance's output what its own B=1 run gives. Returns one
    (dec_mel, postnet_mel, durations, f0, energy) of numpy arrays per input."""
    device = next(model.parameters()).device
    r = model.r
    ns = [len(ling_unit.encode_symbol_sequence(s)[0]) - 1 for s in symbol_seqs]
    L_in = int(np.ceil(max(max(ns), 1) / input_bucket) * input_bucket)
    parts = [encode_symbol_inputs(ling_unit, s, L_in) for s in symbol_seqs]
    parts += [parts[-1]] * ((batch_pad_to or 0) - len(parts))
    ling, emo, spk, lengths = (
        torch.from_numpy(np.concatenate([p[i] for p in parts])).to(device)
        for i in range(4))
    max_output_len = int(np.ceil(L_in * frames_per_symbol / r) * r)
    res = sambert_infer(model, ling.long(), emo.long(), spk.long(), lengths,
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


def load_am(ckpt: str, device: torch.device):
    """-> (KanTtsSAMBERT in eval mode on ``device``, its linguistic unit)."""
    model, config = load_checkpoint(ckpt, device)
    return model, KanTtsLinguisticUnit(config)


def am_infer(sentence: str, ckpt: str, output_dir: str, batch: int = 1,
             device: Union[str, torch.device] = "cuda") -> dict:
    """Synthesize every line of ``sentence`` on ``device`` ("cuda", the
    default, raises without a card; or "cpu"); returns {"frames", "seconds"}
    over the acoustic forwards (the clock read after a device sync)."""
    device = resolve_device(device)
    model, ling_unit = load_am(ckpt, device)
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
                                     ling_unit, batch_pad_to=batch)
        synchronize(device)
        elapsed = time.perf_counter() - t0
        n_frames = sum(res[1].shape[0] for res in results)
        logging.info("%d utterance(s): %d frames in %.3fs", len(group),
                     n_frames, elapsed)
        frames += n_frames
        seconds += elapsed
        for i, (_, mel_post, dur, f0, energy) in zip(group, results):
            utt_id = utts[i][0]
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
    parser.add_argument("--device", type=str, default="cuda",
                        choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    am_infer(args.sentence, args.ckpt, args.output_dir, batch=args.batch,
             device=args.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main()
