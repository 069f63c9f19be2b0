"""Hanzi front-end: raw Chinese text -> symbol sequences, with zero user
data required (a copy of ``kantts_tpu/text/lexicon_frontend.py``).

KAN-TTS synthesizes arbitrary hanzi via the closed-source ``ttsfrd`` engine,
which has no portable source and no offline replacement (no pypinyin; jieba
ships no readings). This module replaces that boundary with an IN-TREE core
lexicon (resources/lexicon/zh_core.tsv: the most common characters' default
readings plus multi-character polyphone disambiguations, authored the same
way as resources/languages/*.json) -- raw hanzi synthesizes end-to-end with
no plugin and no user file. A user TSV overlays the built-in (user entries
win): ``text_to_wav --frontend lexicon:my.tsv``.

Lexicon format (UTF-8, one entry per line)::

    word<TAB>ni3 hao3
    word<TAB>shi4jie4      # spaces inside the pinyin are optional
    # comments and blank lines are ignored

Multi-character entries double as segmentation hints: segmentation prefers
jieba where it is installed (every multi-char lexicon word is registered via
``jieba.add_word`` so user vocabulary wins), with a deterministic greedy
longest-match fallback when jieba is unavailable. Each segment must resolve
through the lexicon -- as a whole word or character-by-character; anything
else raises with the exact missing characters, so coverage gaps surface as
actionable errors rather than silent drops.

Standard Mandarin tone sandhi is applied within each prosodic word (the
reference's ttsfrd front-end does the same internally): third-tone runs
surface as 2(+)3, BU4 is bu2 before tone 4, and YI1 is yi2 before tone 4 /
yi4 before tones 1-3 when mid-word.

Non-hanzi syntax is shared with the pinyin front-end
(text/pinyin_frontend.py): ``#1``-``#4`` breaks, phrase punctuation -> #3,
sentence stops, and inline tone-numbered pinyin all pass through, so mixed
hanzi/pinyin input works.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, List, Optional

from kantts_tpu_torch.text import pinyin_frontend

_HANZI_RANGE = "\u3400-\u4dbf\u4e00-\u9fff\uf900-\ufaff"
_HANZI = re.compile("[" + _HANZI_RANGE + "]+")
_COMMENT = re.compile(r"\s+#.*$")
_SYL_TONE = re.compile(r"([a-zv]+)([0-5])")

BUILTIN_LEXICON = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "resources", "lexicon", "zh_core.tsv")


def load_lexicon(path: str) -> Dict[str, str]:
    """TSV -> {hanzi word: concatenated tone-numbered pinyin}."""
    lexicon: Dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = re.split(r"\t|\s{2,}", line, maxsplit=1)
            if len(parts) != 2:
                # single-space separated "word pinyin..." form
                parts = line.split(None, 1)
            if len(parts) != 2:
                raise ValueError(
                    f"{path}:{lineno}: expected 'hanzi<TAB>pinyin', got {raw!r}")
            word, pinyin = parts[0].strip(), _COMMENT.sub("", parts[1]).strip()
            pinyin = pinyin.replace(" ", "").lower()
            if not word or not pinyin:
                raise ValueError(f"{path}:{lineno}: empty field in {raw!r}")
            if word in lexicon and lexicon[word] != pinyin:
                logging.warning("lexicon %s:%d: %r redefined %r -> %r",
                                path, lineno, word, lexicon[word], pinyin)
            lexicon[word] = pinyin
    if not lexicon:
        raise ValueError(f"lexicon {path} contains no entries")
    return lexicon


def _jieba_tokenizer(lexicon: Dict[str, str]):
    """A dedicated jieba Tokenizer seeded with the user lexicon, or None."""
    try:
        import jieba
    except ImportError:
        return None
    tok = jieba.Tokenizer()
    for word in lexicon:
        if len(word) > 1:
            # high freq so user vocabulary beats jieba's default dictionary
            tok.add_word(word, freq=10_000_000)
    return tok


def _greedy_segments(text: str, lexicon: Dict[str, str]) -> List[str]:
    """Deterministic longest-match segmentation over the lexicon keys."""
    max_len = max(len(w) for w in lexicon)
    out, i = [], 0
    while i < len(text):
        for ln in range(min(max_len, len(text) - i), 0, -1):
            if text[i : i + ln] in lexicon:
                out.append(text[i : i + ln])
                i += ln
                break
        else:
            out.append(text[i])  # unknown char: surfaces in _segment_to_pinyin
            i += 1
    return out


def apply_tone_sandhi(pinyin: str) -> str:
    """Standard Mandarin sandhi WITHIN one prosodic word's concatenated
    tone-numbered pinyin: third-tone runs surface as 2..2,3; 不 (bu4) is
    bu2 before a tone-4 syllable; 一 (yi1) is yi2 before tone 4 and yi4
    before tones 1-3 when another syllable follows (word-final/ordinal 一
    keeps yi1). Neutral tones break third-tone runs."""
    parts = _SYL_TONE.findall(pinyin)
    if "".join(s + t for s, t in parts) != pinyin:
        return pinyin  # not fully tone-numbered; leave untouched
    tones = [t for _, t in parts]
    out = []
    for i, (syl, tone) in enumerate(parts):
        nxt = tones[i + 1] if i + 1 < len(parts) else None
        if syl == "bu" and tone == "4" and nxt == "4":
            tone = "2"
        elif syl == "yi" and tone == "1" and nxt is not None:
            tone = "2" if nxt == "4" else ("4" if nxt in "123" else tone)
        elif tone == "3" and nxt == "3":
            tone = "2"
        out.append(syl + tone)
    return "".join(out)


class LexiconFrontend:
    """Callable front-end: the built-in core lexicon, optionally overlaid
    with a user lexicon file (user entries win)."""

    def __init__(self, lexicon_path: Optional[str] = None,
                 use_builtin: bool = True):
        self.lexicon: Dict[str, str] = {}
        if use_builtin:
            self.lexicon.update(load_lexicon(BUILTIN_LEXICON))
        if lexicon_path:
            self.lexicon.update(load_lexicon(lexicon_path))
        if not self.lexicon:
            raise ValueError("no lexicon: pass a path or use_builtin=True")
        self._jieba = _jieba_tokenizer(self.lexicon)

    def _segment(self, hanzi: str) -> List[str]:
        if self._jieba is not None:
            # HMM off: never invent out-of-lexicon multi-char words
            return [s for s in self._jieba.cut(hanzi, HMM=False) if s.strip()]
        return _greedy_segments(hanzi, self.lexicon)

    def _segment_to_pinyin(self, segment: str) -> str:
        if segment in self.lexicon:
            return self.lexicon[segment]
        missing = [c for c in segment if c not in self.lexicon]
        if missing:
            raise ValueError(
                f"lexicon has no reading for {''.join(missing)!r} "
                f"(in segment {segment!r}); add entries to the lexicon TSV")
        return "".join(self.lexicon[c] for c in segment)

    def hanzi_to_pinyin_line(self, line: str) -> str:
        """Replace each hanzi run with space-separated pinyin words (one per
        segment), leaving the pinyin front-end's syntax untouched."""

        def repl(m: re.Match) -> str:
            words = [apply_tone_sandhi(self._segment_to_pinyin(s))
                     for s in self._segment(m.group(0))]
            return " " + " ".join(words) + " "

        return _HANZI.sub(repl, line).strip()

    def text_to_symbols(self, texts: List[str], speaker: str = "F7",
                        lang: str = "PinYin") -> List[List[str]]:
        pinyin_lines = [self.hanzi_to_pinyin_line(line) for line in texts]
        return pinyin_frontend.text_to_symbols(pinyin_lines, speaker=speaker,
                                               lang=lang)


def make_frontend(lexicon_path: Optional[str] = None) -> LexiconFrontend:
    """Built-in core lexicon, overlaid with ``lexicon_path`` if given."""
    return LexiconFrontend(lexicon_path or None)
