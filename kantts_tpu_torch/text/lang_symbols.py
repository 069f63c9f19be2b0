"""Per-language symbol inventories, loaded from the package's JSON resources
(a copy of ``kantts_tpu/text/lang_symbols.py``; ``resources/languages/``
holds copies of the JAX package's files).

As in KAN-TTS, phones come from the language PhoneSet plus the four break
pseudo-phones ``#1..#4``; tones come from the tonelist (``tone<N>``, blank
line -> ``tone_none``); syllable flags and word segments are fixed
five-element lists.
"""

from __future__ import annotations

import json
import logging
import os
from functools import lru_cache
from typing import Dict, List, Tuple

SYLLABLE_FLAGS: List[str] = [
    "s_begin",
    "s_end",
    "s_none",
    "s_both",
    "s_middle",
]

WORD_SEGMENTS: List[str] = [
    "word_begin",
    "word_end",
    "word_middle",
    "word_both",
    "word_none",
]

SUPPORTED_LANGUAGES = ["PinYin", "ZhHK", "WuuShanghai", "Sichuan"]

RESOURCE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "resources", "languages"
)


@lru_cache(maxsize=None)
def load_language_resource(language: str) -> Dict:
    if language not in SUPPORTED_LANGUAGES:
        logging.error("Language %s not supported. Using PinYin as default", language)
        language = "PinYin"
    path = os.path.join(RESOURCE_DIR, f"{language}.json")
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def get_phone_list(language: str) -> List[str]:
    """Phone names in resource order, plus break pseudo-phones #1..#4."""
    res = load_language_resource(language)
    phones = [p["name"] for p in res["phones"]]
    phones.extend(f"#{i}" for i in range(1, 5))
    return phones


def get_tone_list(language: str) -> List[str]:
    """tonelist entries as ``tone<N>``; a blank entry maps to ``tone_none``."""
    res = load_language_resource(language)
    tones = []
    for t in res["tones"]:
        tones.append(f"tone{t}" if t != "" else "tone_none")
    return tones


def get_language_symbols(language: str) -> Tuple[List[str], List[str], List[str], List[str]]:
    return (
        get_phone_list(language),
        get_tone_list(language),
        list(SYLLABLE_FLAGS),
        list(WORD_SEGMENTS),
    )
