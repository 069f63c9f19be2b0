"""Text front-end: prosody-annotated text -> Script XML + symbol metafile
(a copy of ``kantts_tpu/preprocess/script_convertor.py``).

KAN-TTS's TextScriptConvertor and its object model (ScriptSentence,
ScriptWord, Syllable, SyllableFormatter) condensed into one module with the
same observable behaviour:

- input: the two-line prosody format (id\\ttext-with-#breaks, then a
  pinyin/pron line); NFKC normalisation and punctuation-to-break rewriting;
  filled-pause (FP) annotation blocks are skipped;
- word/break/POS/mark tokenisation by regex;
- pronunciation matching with multi-character words and erhua handling;
- per-language syllable formatters (ZhCN/PinYin/ZhHK/WuuShanghai/Sichuan
  lookup and tone parse; EnXX stress normalisation, f2t phone mapping,
  the vowel carrying the tone);
- metafile emission with word/syllable position flags and break
  pseudo-phones, emotion/speaker tagging;
- the byte-mode metafile (``turn_text_into_bytes``), the one producer of a
  byte voice's symbols.

Language resources come from ``kantts_tpu_torch/resources/languages/*.json``.
"""

from __future__ import annotations

import logging
import re
import unicodedata
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Tuple

from kantts_tpu_torch.text.lang_symbols import load_language_resource

# ------------------------------------------------------------------ regexes

WORD_PATTERN = r"((?P<Word>\w+)(\(\w+\))?)"
BREAK_PATTERN = r"(?P<Break>(\*?#(?P<BreakLevel>[0-4])))"
MARK_PATTERN = r"(?P<Mark>[、，。！？：“”《》·])"
POS_PATTERN = r"(?P<POS>(\*?\|(?P<POSClass>[1-9])))"
PHRASE_TONE_PATTERN = r"(?P<PhraseTone>(\*?%([L|H])))"

REGEX_ID = re.compile(r"^(?P<ID>.*?)\s")
REGEX_SENTENCE = re.compile(
    r"({}|{}|{}|{}|{})\s*".format(
        WORD_PATTERN, BREAK_PATTERN, MARK_PATTERN, POS_PATTERN,
        PHRASE_TONE_PATTERN
    )
)
REGEX_FOREIGN = re.compile(r"[A-Z@]")
REGEX_NEUTRAL_TONE = re.compile(r"[1-5]5")
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


CHINESE_LANGS = (Language.ZhCN, Language.PinYin, Language.ZhHK,
                 Language.WuuShanghai, Language.Sichuan)
ENGLISH_LANGS = (Language.EnGB, Language.EnUS)


# ------------------------------------------------------------ normalization


def do_character_normalization(line: str) -> str:
    return unicodedata.normalize("NFKC", line)


_PUNCT_TO_SPACE = (
    "。、“”‘’|《》【】—―.!?()[]{}~:;+,\""
)


def do_prosody_text_normalization(line: str) -> str:
    """Punctuation removal + break rewriting (reference core/utils.py:31-89)."""
    tokens = line.split("\t")
    text = tokens[1]
    for ch in _PUNCT_TO_SPACE:
        text = text.replace(ch, " ")
    text = text.replace("-", "").replace("'", "")
    text = text.replace("/", "#2").replace("%", "#3")
    text = re.sub(r"(#\d)[ ]+", r"\1", text)
    text = re.sub(r"[ ]+(#\d)", r"\1", text)
    text = re.sub("[ ]+", "#1", text)
    text = re.sub(r"#\d$", "", text)
    # break between target-language and latin-script runs
    text = re.sub(r"([a-zA-Z])([^a-zA-Z\d\#\s\'\%\/\-])", r"\1#1\2", text)
    text = re.sub(r"([^a-zA-Z\d\#\s\'\%\/\-])([a-zA-Z])", r"\1#1\2", text)
    return tokens[0] + "\t" + text


def is_fp_line(line: str) -> bool:
    categories = {"FP", "I", "N", "Q"}
    return all(e in categories for e in line.strip().split(" "))


def format_prosody(path: str) -> List[str]:
    """NFKC + prosody normalization; FP annotation triples are skipped
    (reference core/utils.py:101-121)."""
    out = []
    with open(path, encoding="utf-8") as f:
        lines = f.readlines()
    idx = 0
    while idx < len(lines):
        line = do_character_normalization(lines[idx])
        if len(line.strip().split("\t")) == 2:
            line = do_prosody_text_normalization(line)
        elif is_fp_line(line):
            idx += 3
            continue
        out.append(line)
        idx += 1
    return out


# ------------------------------------------------------------ object model


@dataclass
class Phone:
    name: str
    is_vowel: bool = False


class PhoneSet:
    """Phone inventory from the language JSON resource."""

    def __init__(self, language: str):
        res = load_language_resource(language)
        self.name_map: Dict[str, Phone] = {
            p["name"]: Phone(p["name"], p.get("cv") == "vowel")
            for p in res["phones"]
        }


class PosSet:
    def __init__(self, language: str):
        res = load_language_resource(language)
        self.id_map = {p.get("id"): p.get("name") for p in res.get("poses", [])}


@dataclass
class Syllable:
    phones: List[str] = field(default_factory=list)
    tone: str = "0"
    language: Language = Language.Neutral

    def phone_count(self) -> int:
        return len(self.phones)

    def pronunciation_text(self) -> str:
        return " ".join(self.phones)

    @staticmethod
    def _phone_meta(phone_name: str, word_pos: str, syll_pos: str,
                    tone_text: str, single_syllable_word: bool = False) -> str:
        # position-flag fixups (reference core/Syllable.py:28-44)
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
    pos: str = "0"
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

    def save_xml(self, parent: ET.Element) -> None:
        word_node = ET.SubElement(parent, "word")
        ET.SubElement(word_node, "name").text = self.name
        if self.syllables and self.syllables[0].language != Language.Neutral:
            ET.SubElement(word_node, "lang").text = self.syllables[0].language.name
        syll_node = ET.SubElement(word_node, "syllable")
        syll_node.set("syllcount", str(len(self.syllables)))
        ET.SubElement(syll_node, "phone").text = " - ".join(
            s.pronunciation_text() for s in self.syllables
        )
        ET.SubElement(syll_node, "tone").text = "".join(
            s.tone for s in self.syllables
        )
        ET.SubElement(word_node, "break").text = self.break_text
        ET.SubElement(word_node, "POS").text = self.pos


@dataclass
class ScriptItem:
    """One sentence: spoken words + written text (host/accompany alignment of
    the reference condensed into ordered lists)."""

    item_id: str = ""
    text: str = ""
    spoken_words: List[SpokenWord] = field(default_factory=list)
    spoken_marks: List[str] = field(default_factory=list)  # "#N" texts

    def save_metafile(self) -> str:
        return " ".join(w.save_metafile() for w in self.spoken_words)

    def save_xml(self, parent: ET.Element) -> None:
        item_node = ET.SubElement(parent, "si")
        item_node.set("id", self.item_id)
        ET.SubElement(item_node, "text").text = self.text
        spoken = ET.SubElement(item_node, "spoken")
        spoken.set("wordcount", str(len(self.spoken_words)))
        for w in self.spoken_words:
            w.save_xml(spoken)


# --------------------------------------------------------------- formatters


class ChineseSyllableFormatter:
    """Shared sy2ph-lookup formatter; ZhCN/PinYin additionally normalize
    qing-sheng and the 'ng' pseudo syllable (reference
    core/SyllableFormatter.py:26-112)."""

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

    def format(self, phoneset: PhoneSet, pron_text: str,
               syllable_list: List[Syllable]) -> bool:
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


class EnXXSyllableFormatter:
    """English syllables: '.'-separated, stress digits -> tone, f2t phone
    mapping, vowel carries the tone (reference SyllableFormatter.py:250-313)."""

    def __init__(self, language: Language,
                 f2t_map: Optional[Dict[str, List[str]]] = None):
        self.language = language
        self.f2t_map = f2t_map or {}

    @staticmethod
    def _normalize(pron: str) -> str:
        pron = pron.replace("#", ".")
        pron = (pron.replace("03", "0").replace("13", "1")
                .replace("23", "2").replace("3", ""))
        return pron.replace("2", "0")

    def format(self, phoneset: PhoneSet, pron_text: str,
               syllable_list: List[Syllable]) -> bool:
        pron_text = self._normalize(pron_text)
        for syl_text in (s.strip() for s in pron_text.split(".")):
            syll = Syllable([], "0", self.language)
            phones = re.split(r"\s+", syl_text)
            for name in phones:
                name = name.lower()
                tone = "0"
                if name and name[-1] in "012":
                    tone = name[-1]
                    name = name[:-1]
                mapped = self.f2t_map.get(name, [name])
                for phone_name in mapped:
                    phone = phoneset.name_map.get(phone_name)
                    if phone is None:
                        logging.error("EnXXSyllableFormatter: phone %s not found",
                                      phone_name)
                        return False
                    syll.phones.append(phone_name)
                    if phone.is_vowel:
                        syll.tone = tone
            syllable_list.append(syll)
        return True


def make_formatter(language: Language, sy2ph: Dict[str, List[str]],
                   f2t: Dict[str, List[str]]):
    if language in (Language.ZhCN, Language.PinYin, Language.Sichuan):
        counts = (3,) if language == Language.ZhCN else (1, 2)
        return ChineseSyllableFormatter(sy2ph, language, normalize=True,
                                        expected_counts=counts)
    if language in (Language.ZhHK, Language.WuuShanghai):
        return ChineseSyllableFormatter(sy2ph, language, normalize=False,
                                        expected_counts=(1, 2))
    if language in ENGLISH_LANGS:
        return EnXXSyllableFormatter(language, f2t)
    logging.error("Unsupported language: %s", language)
    return None


# ---------------------------------------------------------------- convertor


class TextScriptConvertor:
    def __init__(self, target_lang: str, foreign_lang: str,
                 emo_tag_path: Optional[str], speaker: str,
                 resource_lang: Optional[str] = None):
        """resource_lang: JSON resource to load (defaults to target_lang for
        Chinese targets)."""
        self.target_lang = Language.parse(target_lang)
        self.foreign_lang = Language.parse(foreign_lang)
        self.speaker = speaker

        res_lang = resource_lang or target_lang
        res = load_language_resource(res_lang)
        self.phoneset = PhoneSet(res_lang)
        self.posset = PosSet(res_lang)
        sy2ph = dict(res.get("sy2ph", {}))
        f2t = dict(res.get("f2t", {}))

        self.emo_dict = {}
        if emo_tag_path:
            with open(emo_tag_path) as f:
                for line in f:
                    parts = line.strip().split()
                    if len(parts) == 2:
                        self.emo_dict[parts[0]] = parts[1]

        self.target_formatter = make_formatter(self.target_lang, sy2ph, f2t)
        self.foreign_formatter = make_formatter(self.foreign_lang, sy2ph, f2t)

    # ----------------------------------------------------------- sentences

    def parse_sentence(self, sentence: str, line_num: int) -> Optional[ScriptItem]:
        sentence = sentence.strip()
        m = REGEX_ID.search(sentence)
        if m is None:
            logging.error("parse_sentence: line %s needs an ID", line_num)
            return None
        item = ScriptItem(item_id=m.group("ID"))
        position = m.end()

        text_parts: List[str] = []
        prev_word: Optional[SpokenWord] = None
        have_word = False
        last_break = False

        for tok in REGEX_SENTENCE.finditer(sentence[position:]):
            if tok.group("Word") is not None:
                prev_word = SpokenWord(name=tok.group("Word"))
                text_parts.append(tok.group("Word"))
                have_word = True
                last_break = False
            elif tok.group("Break") is not None:
                break_text = tok.group("BreakLevel") or "1"
                if have_word and prev_word is not None:
                    prev_word.break_text = break_text
                    item.spoken_words.append(prev_word)
                if break_text != "1":
                    item.spoken_marks.append("#" + break_text)
                last_break = True
                have_word = False
            elif tok.group("PhraseTone") is not None:
                pass
            elif tok.group("POS") is not None:
                if have_word and prev_word is not None:
                    prev_word.pos = tok.group("POSClass")
            elif tok.group("Mark") is not None:
                text_parts.append(tok.group("Mark"))

        if not last_break and prev_word is not None:
            prev_word.break_text = "4"
            item.spoken_words.append(prev_word)

        item.text = "".join(text_parts)
        return item

    # ------------------------------------------------------ pronunciations

    def _format_syllable(self, pron: str, syllable_list: List[Syllable]) -> bool:
        is_foreign = REGEX_FOREIGN.search(pron) is not None
        formatter = (self.foreign_formatter
                     if (self.foreign_formatter is not None and is_foreign)
                     else self.target_formatter)
        if formatter is None:
            return False
        return formatter.format(self.phoneset, pron, syllable_list)

    @staticmethod
    def _get_word_prons(pron_text: str) -> List[str]:
        """'/'-separated word groups; foreign groups stay whole, Chinese
        groups split into per-char syllables (reference :219-228)."""
        res = []
        for pron in pron_text.split("/"):
            if REGEX_FOREIGN.search(pron):
                res.append(pron.strip())
            else:
                res.extend(pron.strip().split(" "))
        return res

    @staticmethod
    def _is_erhua(pron: str) -> bool:
        pron = REGEX_NEUTRAL_TONE.sub("5", pron)[:-1]
        return pron.endswith("r") and pron != "er"

    def parse_pronunciation(self, item: ScriptItem, pronunciation: str,
                            line_num: int) -> bool:
        word_prons = self._get_word_prons(pronunciation)
        word_idx = 0
        pron_idx = 0

        while pron_idx < len(word_prons):
            syllables: List[Syllable] = []
            pron = word_prons[pron_idx].strip()
            if not self._format_syllable(pron, syllables):
                logging.error("parse_pronunciation: line %s bad pron %s",
                              line_num, pron)
                return False
            language = syllables[0].language

            if word_idx >= len(item.spoken_words):
                logging.error("parse_pronunciation: line %s word idx overflow",
                              line_num)
                return False
            word = item.spoken_words[word_idx]

            if language in ENGLISH_LANGS:
                word.syllables.extend(syllables)
                word_idx += 1
                pron_idx += 1
            elif language in CHINESE_LANGS:
                char_count = len(word.name)
                if (language in (Language.ZhCN, Language.PinYin, Language.Sichuan)
                        and self._is_erhua(pron) and "儿" in word.name):
                    word.name = word.name.replace("儿", "")
                    char_count -= 1
                # gather one syllable per remaining character
                i = 1
                while i < char_count:
                    pron_idx += 1
                    if pron_idx >= len(word_prons):
                        logging.error(
                            "parse_pronunciation: line %s word/pron mismatch",
                            line_num)
                        return False
                    pron = word_prons[pron_idx].strip()
                    if not self._format_syllable(pron, syllables):
                        logging.error("parse_pronunciation: line %s bad pron %s",
                                      line_num, pron)
                        return False
                    if (language in (Language.ZhCN, Language.PinYin,
                                     Language.Sichuan)
                            and self._is_erhua(pron) and "儿" in word.name):
                        word.name = word.name.replace("儿", "")
                        char_count -= 1
                    i += 1
                word.syllables.extend(syllables)
                word_idx += 1
                pron_idx += 1
            else:
                logging.error("parse_pronunciation: line %s unsupported lang",
                              line_num)
                return False

        if word_idx != len(item.spoken_words):
            logging.error("parse_pronunciation: line %s leftover words",
                          line_num)
            return False
        return True

    # -------------------------------------------------------------- pipeline

    def process(self, text_script_path: str, output_xml_path: str,
                output_metafile: str) -> None:
        items: List[ScriptItem] = []
        lines = format_prosody(text_script_path)
        item: Optional[ScriptItem] = None
        for line_num, line in enumerate(lines):
            if line_num % 2 == 0:
                item = self.parse_sentence(line.strip(), line_num)
            elif item is not None:
                if self.parse_pronunciation(item, line.strip(), line_num):
                    items.append(item)

        # Script XML
        root = ET.Element("script")
        root.set("xmlns", "http://schemas.alibaba-inc.com/tts")
        for it in items:
            it.save_xml(root)
        ET.ElementTree(root).write(output_xml_path, encoding="utf-8",
                                   xml_declaration=True)
        logging.info("Saved script to: %s", output_xml_path)

        # metafile with emotion/speaker tags
        with open(output_metafile, "w", encoding="utf-8") as f:
            for it in items:
                emo = self.emo_dict.get(it.item_id, "emotion_neutral")
                tagged = [
                    tok[:-1] + "$" + emo + "$" + self.speaker + "}"
                    for tok in it.save_metafile().split(" ")
                ]
                f.write(it.item_id + "\t" + " ".join(tagged) + "\n")
        logging.info("Saved metafile to: %s", output_metafile)

    @staticmethod
    def turn_text_into_bytes(plain_text_path: str, output_meta_file_path: str,
                             speaker: str) -> None:
        turn_text_into_bytes(plain_text_path, output_meta_file_path, speaker)


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
