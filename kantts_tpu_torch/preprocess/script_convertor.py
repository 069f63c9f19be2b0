"""The part of ``kantts_tpu/preprocess/script_convertor.py`` that the pinyin
front-end (``text/pinyin_frontend.py``) needs: the syllable/word/sentence
object model with its metafile emission (word and syllable position flags,
break pseudo-phones) and the Chinese syllable formatters (sy2ph lookup and
tone parse), and the byte-mode metafile writer ``turn_text_into_bytes``
(``TextScriptConvertor.turn_text_into_bytes`` there), the one producer of a
byte voice's symbols. The prosody-annotated text -> Script XML convertor,
the phone set and the English formatter of the JAX package are not copied:
the port has no preprocessing yet.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Tuple

REGEX_QING_SHENG = re.compile(r"([1-5]5)")
REGEX_PRON = re.compile(r"(?P<Pron>[a-z]+)(?P<Tone>[1-6])")
REGEX_NG_BREAK = re.compile(r"^ng(?P<break>\d)")


class Language(Enum):
    Neutral = 0
    EnUS = 1033
    EnGB = 2057
    ZhCN = 2052
    PinYin = 2053
    WuuShanghai = 2054
    Sichuan = 2055
    ZhHK = 3076

    @classmethod
    def parse(cls, s: str) -> "Language":
        try:
            return cls[s]
        except KeyError:
            return cls.Neutral


@dataclass
class Syllable:
    phones: List[str] = field(default_factory=list)
    tone: str = "0"
    language: Language = Language.Neutral

    def phone_count(self) -> int:
        return len(self.phones)

    @staticmethod
    def _phone_meta(phone_name: str, word_pos: str, syll_pos: str,
                    tone_text: str, single_syllable_word: bool = False) -> str:
        # position-flag fixups, as in KAN-TTS's core/Syllable.py
        if word_pos == "word_begin" and syll_pos == "s_end" and single_syllable_word:
            word_pos = "word_end"
        elif word_pos == "word_begin" and syll_pos not in ("s_begin", "s_both"):
            word_pos = "word_middle"
        elif word_pos == "word_end" and syll_pos not in ("s_end", "s_both"):
            word_pos = "word_middle"
        return f"{{{phone_name}$tone{tone_text}${syll_pos}${word_pos}}}"

    def save_metafile(self, word_pos: str, single_syllable_word: bool = False
                      ) -> str:
        n = len(self.phones)
        metas = []
        for idx, phone in enumerate(self.phones):
            if n == 1:
                syll_pos = "s_both"
            elif idx == 0:
                syll_pos = "s_begin"
            elif idx == n - 1:
                syll_pos = "s_end"
            else:
                syll_pos = "s_middle"
            metas.append(self._phone_meta(phone, word_pos, syll_pos, self.tone,
                                          single_syllable_word))
        return " ".join(metas)


@dataclass
class SpokenWord:
    name: str = ""
    break_text: str = "1"
    syllables: List[Syllable] = field(default_factory=list)

    def save_metafile(self) -> str:
        word_phone_cnt = sum(s.phone_count() for s in self.syllables)
        single = len(self.syllables) == 1
        metas = []
        for idx, syll in enumerate(self.syllables):
            if word_phone_cnt == 1:
                word_pos = "word_both"
            elif idx == 0:
                word_pos = "word_begin"
            elif idx == len(self.syllables) - 1:
                word_pos = "word_end"
            else:
                word_pos = "word_middle"
            metas.append(syll.save_metafile(word_pos, single))
        if self.break_text not in ("0", None, ""):
            metas.append(f"{{#{self.break_text}$tone_none$s_none$word_none}}")
        return " ".join(metas)


@dataclass
class ScriptItem:
    """One sentence: its spoken words in order."""

    spoken_words: List[SpokenWord] = field(default_factory=list)

    def save_metafile(self) -> str:
        return " ".join(w.save_metafile() for w in self.spoken_words)


class ChineseSyllableFormatter:
    """Shared sy2ph-lookup formatter; ZhCN/PinYin/Sichuan additionally
    normalize qing-sheng and the 'ng' pseudo syllable (KAN-TTS's
    core/SyllableFormatter.py)."""

    def __init__(self, sy2ph_map: Dict[str, List[str]], language: Language,
                 normalize: bool, expected_counts: Tuple[int, ...]):
        self.sy2ph = sy2ph_map
        self.language = language
        self.normalize = normalize
        self.expected_counts = expected_counts

    def _normalize(self, pron: str) -> str:
        pron = pron.replace("6", "2")
        pron = REGEX_QING_SHENG.sub("5", pron)
        m = REGEX_NG_BREAK.search(pron)
        if m:
            pron = "en" + m.group("break")
        return pron

    def format(self, pron_text: str, syllable_list: List[Syllable]) -> bool:
        if self.normalize:
            pron_text = self._normalize(pron_text)
        m = REGEX_PRON.search(pron_text)
        if not m:
            logging.error("%s: invalid pronunciation: %s",
                          type(self).__name__, pron_text)
            return False
        pron, tone = m.group("Pron"), m.group("Tone")
        phones = self.sy2ph.get(pron)
        if phones is None:
            logging.error("%s: sy2ph map missing key: %s",
                          type(self).__name__, pron)
            return False
        if len(phones) not in self.expected_counts:
            logging.error("%s: invalid phone split for: %s",
                          type(self).__name__, pron)
            return False
        syllable_list.append(Syllable(list(phones), tone, self.language))
        return True


def make_formatter(language: Language, sy2ph: Dict[str, List[str]]):
    """The syllable formatter of a Chinese language, else None."""
    if language in (Language.ZhCN, Language.PinYin, Language.Sichuan):
        counts = (3,) if language == Language.ZhCN else (1, 2)
        return ChineseSyllableFormatter(sy2ph, language, normalize=True,
                                        expected_counts=counts)
    if language in (Language.ZhHK, Language.WuuShanghai):
        return ChineseSyllableFormatter(sy2ph, language, normalize=False,
                                        expected_counts=(1, 2))
    logging.error("Unsupported language: %s", language)
    return None


def turn_text_into_bytes(plain_text_path: str, output_meta_file_path: str,
                         speaker: str) -> None:
    """Write the UTF-8 byte metafile of a ``<id>\t<sentence>`` text file:
    one ``{byte$emotion_neutral$speaker}`` token per byte of the sentence,
    and a final full stop (byte 46) unless it already ends in '!', '.' or
    '?'."""
    meta_lines = []
    with open(plain_text_path, encoding="utf-8") as f:
        for text_line in f:
            sentence_id, sentence = text_line.strip().split("\t")
            seq = [
                f"{{{b}$emotion_neutral${speaker}}}"
                for ch in sentence
                for b in ch.encode("utf-8")
            ]
            if seq and seq[-1][1:].split("$")[0] not in ("33", "46", "63"):
                seq.append(f"{{46$emotion_neutral${speaker}}}")
            meta_lines.append(f"{sentence_id}\t{' '.join(seq)}\n")
    with open(output_meta_file_path, "w", encoding="utf-8") as f:
        f.writelines(meta_lines)
