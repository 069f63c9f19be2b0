"""English number normalization (dependency-free; a copy of
``kantts_tpu/text/numbers.py``).

KAN-TTS's own version uses the ``inflect`` package. That package isn't available here, so number-to-words
is implemented directly; outputs match inflect's wording for the cardinal and
ordinal ranges TTS text actually contains.
"""

from __future__ import annotations

import re

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"([0-9]+)(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10 ** 12, "trillion"),
    (10 ** 9, "billion"),
    (10 ** 6, "million"),
    (10 ** 3, "thousand"),
    (10 ** 2, "hundred"),
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits_to_words(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    if ones == 0:
        return _TENS[tens]
    return f"{_TENS[tens]}-{_ONES[ones]}"


def number_to_words(n: int, andword: str = "and") -> str:
    """Cardinal number to English words, inflect-style (e.g. 'one hundred and five')."""
    if n < 0:
        return "minus " + number_to_words(-n, andword)
    if n < 100:
        return _two_digits_to_words(n)
    for scale, name in _SCALES:
        if n >= scale:
            head = number_to_words(n // scale, andword)
            rest = n % scale
            if rest == 0:
                return f"{head} {name}"
            if rest < 100 and andword:
                return f"{head} {name} {andword} {number_to_words(rest, andword)}"
            return f"{head} {name} {number_to_words(rest, andword)}"
    return _two_digits_to_words(n)  # unreachable


def number_to_words_grouped(n: int) -> str:
    """Year-style reading in 2-digit groups, e.g. 1984 -> 'nineteen eighty-four'."""
    s = str(n)
    if len(s) % 2 == 1:
        s = "0" + s
    words = []
    for i in range(0, len(s), 2):
        group = int(s[i:i + 2])
        if group == 0:
            words.append("hundred" if i else "oh oh")
        elif group < 10 and i > 0:
            words.append("oh " + _ONES[group])
        else:
            words.append(_two_digits_to_words(group))
    return " ".join(words)


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n, andword="")
    parts = words.rsplit(" ", 1)
    last = parts[-1]
    if "-" in last:
        head, tail = last.rsplit("-", 1)
        last = head + "-" + _ordinalize_word(tail)
    else:
        last = _ordinalize_word(last)
    parts[-1] = last
    return " ".join(parts)


def _ordinalize_word(word: str) -> str:
    if word in _ORDINAL_IRREGULAR:
        return _ORDINAL_IRREGULAR[word]
    if word.endswith("y"):
        return word[:-1] + "ieth"
    if word in ("hundred", "thousand", "million", "billion", "trillion"):
        return word + "th"
    return word + "th"


def _remove_commas(m: re.Match) -> str:
    return m.group(1).replace(",", "")


def _expand_decimal_point(m: re.Match) -> str:
    return m.group(1).replace(".", " point ")


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_ordinal(m: re.Match) -> str:
    return ordinal_to_words(int(m.group(1)))


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return number_to_words_grouped(num)
    return number_to_words(num, andword="")


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
