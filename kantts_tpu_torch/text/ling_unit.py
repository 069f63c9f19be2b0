"""KanTtsLinguisticUnit — the linguistic symbol codec (a copy of
``kantts_tpu/text/ling_unit.py``), and ``get_fpdict``, the filled-pause
syllable triples of an FP voice.

Encoding contract, as in KAN-TTS:
- Each linguistic feature ("lfeat") type has its own vocab, ending with the
  specials ``_`` (pad), ``~`` (eos), ``@[MASK]`` in that order. Vocab order
  feeds embedding-table ids, so it must match exactly.
- ``encode_symbol_sequence`` takes a metafile symbol string
  ``{sy$tone$syllable_flag$word_segment$emo$spk} ...`` and returns one int32
  numpy array per lfeat type, each with an EOS id appended.
- sy symbols are stored ``@``-prefixed in the vocab (ARPAbet-style
  uniqueness); free text outside curly braces runs through cleaners and is
  encoded char-by-char (the character inventory is empty, so plain text chars
  drop out — only phone symbols survive).
- byte mode: vocab ``@0..@255`` + specials, single ``byte_index`` track.
"""

from __future__ import annotations

import functools
import logging
import re
from typing import Any, Dict, List

import numpy as np

from kantts_tpu_torch.text import cleaners as cleaners_mod
from kantts_tpu_torch.text.emotion_types import EMOTION_TYPES
from kantts_tpu_torch.text.lang_symbols import get_language_symbols

_CURLY_RE = re.compile(r"(.*?)\{(.+?)\}(.*)")

PAD = "_"
EOS = "~"
MASK = "@[MASK]"
SPECIALS = [PAD, EOS, MASK]


@functools.lru_cache(maxsize=4096)
def _clean_text(text: str, cleaner_names: tuple) -> str:
    """Cleaners are pure text->text functions, so results are memoized: the
    sy-track encoder calls this once per phone token on the (mostly empty)
    inter-brace gaps."""
    for name in cleaner_names:
        cleaner = getattr(cleaners_mod, name, None)
        if cleaner is None:
            raise ValueError(f"Unknown cleaner: {name}")
        text = cleaner(text)
    return text


class _Vocab:
    """A single lfeat-type vocabulary."""

    def __init__(self, symbols: List[str]):
        self.symbols = list(symbols)
        self.to_id = {s: i for i, s in enumerate(self.symbols)}
        self.to_symbol = {i: s for i, s in enumerate(self.symbols)}

    def __len__(self) -> int:
        return len(self.symbols)


class KanTtsLinguisticUnit:
    def __init__(self, config: Dict[str, Any]):
        unit_config = config["linguistic_unit"]
        self.unit_config = unit_config
        self.lang_type = unit_config.get("language", "PinYin")
        self._cleaner_names = tuple(
            x.strip() for x in unit_config["cleaners"].split(","))
        self._lfeat_type_list = unit_config["lfeat_type_list"].strip().split(",")
        self.vocabs: Dict[str, _Vocab] = {}
        self._build()

    def _build(self) -> None:
        phones, tones, syllable_flags, word_segments = get_language_symbols(self.lang_type)
        if self.using_byte():
            self.vocabs["byte_index"] = _Vocab(
                [f"@{i}" for i in range(256)] + SPECIALS)
        else:
            self.vocabs["sy"] = _Vocab(["@" + p for p in phones] + SPECIALS)
            self.vocabs["tone"] = _Vocab(tones + SPECIALS)
            self.vocabs["syllable_flag"] = _Vocab(syllable_flags + SPECIALS)
            self.vocabs["word_segment"] = _Vocab(word_segments + SPECIALS)
        if "emo_category" in self._lfeat_type_list:
            self.vocabs["emo_category"] = _Vocab(EMOTION_TYPES + SPECIALS)
        if "speaker_category" in self._lfeat_type_list:
            speakers = self.unit_config["speaker_list"].strip().split(",")
            self.vocabs["speaker_category"] = _Vocab(speakers + SPECIALS)

    def using_byte(self) -> bool:
        return "byte_index" in self._lfeat_type_list

    def get_unit_size(self) -> Dict[str, int]:
        """Vocab sizes keyed by the model-config param names they feed."""
        names = {"sy": "sy", "tone": "tone", "syllable_flag": "syllable_flag",
                 "word_segment": "word_segment", "byte_index": "byte_index",
                 "emo_category": "emotion", "speaker_category": "speaker"}
        return {names[k]: len(v) for k, v in self.vocabs.items()}

    @property
    def lfeat_type_list(self) -> List[str]:
        return list(self._lfeat_type_list)

    def encode_symbol_sequence(self, lfeat_symbol: str) -> List[np.ndarray]:
        """Metafile symbol string -> one int32 array per lfeat type (EOS appended)."""
        tokens = lfeat_symbol.strip().split(" ")
        n_types = len(self._lfeat_type_list)
        per_type: List[List[str]] = [[] for _ in range(n_types)]
        for token in tokens:
            fields = token.strip("{").strip("}").split("$")
            for i in range(n_types):
                per_type[i].append(fields[i])
        return [np.asarray(self.encode_sub_unit(" ".join(per_type[i]), lfeat_type),
                           dtype=np.int32)
                for i, lfeat_type in enumerate(self._lfeat_type_list)]

    def encode_sub_unit(self, symbols: str, lfeat_type: str) -> List[int]:
        if lfeat_type == "sy":
            wrapped = " ".join("{%s}" % s for s in symbols.strip().split(" "))
            return self.encode_text(wrapped)
        if lfeat_type == "byte_index":
            return self._encode_simple(
                ["@" + s for s in symbols.strip().split(" ")], "byte_index")
        if lfeat_type in ("tone", "syllable_flag", "word_segment", "emo_category",
                          "speaker_category"):
            return self._encode_simple(symbols.strip().split(" "), lfeat_type)
        raise ValueError(f"Unknown lfeat type: {lfeat_type}")

    def _encode_simple(self, symbols: List[str], lfeat_type: str) -> List[int]:
        vocab = self.vocabs[lfeat_type]
        seq = []
        for s in symbols:
            if s not in vocab.to_id:
                raise KeyError(f"unknown {lfeat_type} symbol: {s!r} (not in this "
                               "model's vocabulary)")
            seq.append(vocab.to_id[s])
        seq.append(vocab.to_id[EOS])
        return seq

    def encode_text(self, text: str) -> List[int]:
        """Curly-brace aware sy-track encoder: brace contents are phone symbols
        (``@``-prefixed lookup), outside text goes through the cleaners."""
        vocab = self.vocabs["sy"]
        seq: List[int] = []
        while len(text):
            m = _CURLY_RE.match(text)
            if not m:
                seq.extend(self._encode_sy_chars(_clean_text(text, self._cleaner_names)))
                break
            seq.extend(self._encode_sy_chars(_clean_text(m.group(1), self._cleaner_names)))
            seq.extend(self._encode_phones(m.group(2)))
            text = m.group(3)
        seq.append(vocab.to_id[EOS])
        return seq

    def _encode_sy_chars(self, text: str) -> List[int]:
        vocab = self.vocabs["sy"]
        return [vocab.to_id[c] for c in text
                if c in vocab.to_id and c not in (PAD, EOS)]

    def _encode_phones(self, text: str) -> List[int]:
        vocab = self.vocabs["sy"]
        ids = []
        for p in text.split():
            s = "@" + p
            if s in vocab.to_id:
                ids.append(vocab.to_id[s])
            else:  # KAN-TTS drops unknown phones silently; warn to aid debugging
                logging.warning("Dropping unknown phone symbol: %s", p)
        return ids

    def decode_symbol_sequence(self, sequence: List[np.ndarray]) -> List[str]:
        result = []
        for i, lfeat_type in enumerate(self._lfeat_type_list):
            ids = np.asarray(sequence[i]).tolist()
            syms = " ".join(self.decode_id(j, lfeat_type) for j in ids)
            result.append(f"{lfeat_type}:{syms}")
        return result

    def decode_id(self, idx: int, lfeat_type: str) -> str:
        s = self.vocabs[lfeat_type].to_symbol[idx]
        if lfeat_type in ("sy", "byte_index") and len(s) > 1 and s[0] == "@":
            s = s[1:]
        return s

    def pad_id(self, lfeat_type: str) -> int:
        return self.vocabs[lfeat_type].to_id[PAD]

    def eos_id(self, lfeat_type: str) -> int:
        return self.vocabs[lfeat_type].to_id[EOS]

    def mask_id(self, lfeat_type: str) -> int:
        return self.vocabs[lfeat_type].to_id[MASK]


def get_fpdict(config: Dict[str, Any]) -> Dict[int, np.ndarray]:
    """Encoded filled-pause syllable triples ("en"/"a"/"e"), keyed by FP
    class: each is three symbols (onset, coda, #3 break) of the first
    speaker of ``speaker_list``, as a (3, 4) [sy, tone, syllable_flag, ws]
    array."""
    default_sp = config["linguistic_unit"]["speaker_list"].split(",")[0]

    def triple(onset: str, coda: str) -> str:
        return (
            f"{{{onset}$tone5$s_begin$word_begin$emotion_neutral${default_sp}}} "
            f"{{{coda}$tone5$s_end$word_end$emotion_neutral${default_sp}}} "
            f"{{#3$tone_none$s_none$word_none$emotion_neutral${default_sp}}}"
        )

    ling_unit = KanTtsLinguisticUnit(config)
    out = {}
    for label, (onset, coda) in {1: ("ge", "en_c"), 2: ("ga", "a_c"), 3: ("ge", "e_c")}.items():
        lings = ling_unit.encode_symbol_sequence(triple(onset, coda))
        out[label] = np.stack(lings, axis=1)[:3, :4]
    return out
