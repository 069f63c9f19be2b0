"""Symbol sequences -> padded model inputs (counterpart of
``encode_symbol_inputs`` in ``kantts_tpu/infer/exported.py``). It imports no
model code, so that a serving artifact (``infer/exported.py``) can encode
its inputs without the model classes."""

from __future__ import annotations

from typing import Optional

import numpy as np


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
