"""In-tree raw-text front-end for tone-numbered PinYin input (a copy of
``kantts_tpu/text/pinyin_frontend.py``).

KAN-TTS synthesizes raw text through the closed-source ``ttsfrd`` engine,
which cannot be ported. This module shrinks that boundary: plain
tone-numbered pinyin (``ni3 hao3 ma5``) — the standard annotation-light form
of Mandarin input — synthesizes with NO external plugin, using the shipped
language resources (sy2ph phone maps from KAN-TTS's PinYin.xml) and default
prosody.

Input conventions per line:
- whitespace-separated tokens; each token is one prosodic word of one or
  more tone-numbered pinyin syllables (``ni3hao3 shi4jie4``); tones 1-5
  (0 or missing = neutral 5); ``v`` spells u-with-umlaut (``nv3 lv4``);
  erhua syllables are in the map directly (``huar1``);
- explicit break marks ``#1``-``#4`` override the defaults;
- ``，`` ``,`` ``、`` ``；`` ``;`` ``：`` ``:`` insert a ``#3`` phrase break;
- ``。`` ``.`` ``！`` ``!`` ``？`` ``?`` end a sub-sentence (each sub-sentence
  becomes its own synthesis chunk, matching the reference's sentence split).

Defaults: ``#1`` between words, ``#4`` sentence-final — the neutral prosody
the reference front-end produces for unannotated text.
"""

from __future__ import annotations

import logging
import re
from functools import lru_cache
from typing import List

from kantts_tpu_torch.preprocess.script_convertor import (
    Language,
    PhoneSet,
    ScriptItem,
    SpokenWord,
    Syllable,
    make_formatter,
)
from kantts_tpu_torch.text.lang_symbols import load_language_resource

_SYL = r"[a-zv]+[0-5]?"
_TOKEN = re.compile(
    r"(?P<break>#[0-4])|(?P<word>(?:{})+)|(?P<phrase>[，,、；;：:])|"
    r"(?P<stop>[。.！!？?])|(?P<space>\s+)".format(_SYL)
)
_ONE_SYL = re.compile(_SYL)


@lru_cache(maxsize=8)
def _resources(lang: str):
    res = load_language_resource(lang)
    phoneset = PhoneSet(lang)
    formatter = make_formatter(Language.parse(lang), dict(res["sy2ph"]),
                               dict(res.get("f2t", {})))
    return phoneset, formatter


def pinyin_to_syllables(word_text: str, lang: str = "PinYin"
                        ) -> List[Syllable]:
    """One prosodic word of concatenated pinyin -> Syllable list.
    Raises ValueError on unknown syllables (typo-level feedback)."""
    phoneset, formatter = _resources(lang)
    syllables: List[Syllable] = []
    for m in _ONE_SYL.finditer(word_text):
        pron = m.group(0)
        if not pron[-1].isdigit():
            pron += "5"  # missing tone = neutral
        elif pron.endswith("0"):
            pron = pron[:-1] + "5"
        # the reference's py2phone map spells u-umlaut as "v" (qv/jv/xv/
        # yv/...); standard pinyin writes it "u" after j/q/x/y (after those
        # initials "u" IS u-umlaut). Fold to the v-keyed spelling when the
        # u-form is not in the map, so standard input like qu4/yuan2/xue2
        # works.
        if (pron[0] in "jqxy" and "u" in pron
                and pron.rstrip("0123456789") not in getattr(
                    formatter, "sy2ph", {})):
            pron = pron.replace("u", "v", 1)
        if not formatter.format(phoneset, pron, syllables):
            raise ValueError(f"unknown pinyin syllable: {m.group(0)!r} "
                             f"(word {word_text!r})")
    return syllables


def line_to_items(line: str, lang: str = "PinYin") -> List[ScriptItem]:
    """One input line -> ScriptItems (one per sub-sentence)."""
    items: List[ScriptItem] = []
    item = ScriptItem()
    pending: SpokenWord | None = None

    def flush_word(break_text: str):
        nonlocal pending
        if pending is not None:
            pending.break_text = break_text
            item.spoken_words.append(pending)
            pending = None
        elif item.spoken_words:
            # punctuation right after an already-flushed word: upgrade its
            # break if the new one is stronger
            prev = item.spoken_words[-1]
            if break_text > prev.break_text:
                prev.break_text = break_text

    def end_sentence():
        nonlocal item
        flush_word("4")
        if item.spoken_words:
            items.append(item)
        item = ScriptItem()

    pos = 0
    for m in _TOKEN.finditer(line.strip().lower()):
        if m.start() != pos:
            bad = line.strip()[pos : m.start()]
            raise ValueError(f"unparseable input near {bad!r}")
        pos = m.end()
        if m.group("word"):
            flush_word("1")
            word = SpokenWord(name=m.group("word"))
            word.syllables = pinyin_to_syllables(m.group("word"), lang)
            pending = word
        elif m.group("break"):
            flush_word(m.group("break")[1])
        elif m.group("phrase"):
            flush_word("3")
        elif m.group("stop"):
            end_sentence()
    if pos != len(line.strip()):
        raise ValueError(f"unparseable input near {line.strip()[pos:]!r}")
    end_sentence()
    return items


def text_to_symbols(texts: List[str], speaker: str = "F7",
                    lang: str = "PinYin") -> List[List[str]]:
    """The text_to_wav front-end hook: raw pinyin lines -> per-line lists of
    sub-sentence symbol sequences (the training metafile format, emotion
    tagged neutral like the reference's default)."""
    out: List[List[str]] = []
    for line in texts:
        seqs = []
        for item in line_to_items(line, lang):
            tagged = [
                tok[:-1] + "$emotion_neutral$" + speaker + "}"
                for tok in item.save_metafile().split(" ")
            ]
            seqs.append(" ".join(tagged))
        if not seqs:
            logging.warning("pinyin_frontend: empty line skipped: %r", line)
        out.append(seqs)
    return out
