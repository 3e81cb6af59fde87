"""English number normalization, dependency-free (the port's own copy of
`emotivoice_tpu/frontend/numbers_en.py`; same output for the same input).

Counterpart of reference `text/numbers.py:69-75` (`normalize_numbers`),
which is dead code there (only reachable through the dead `text/cleaners.py`)
and depends on the `inflect` package. Here it is a live, opt-in frontend
feature: `g2p_cn_en(..., english_numbers=True)` expands digits to English
words instead of the reference's always-Chinese policy (reference
`frontend.py:25` applies `tn_chinese` unconditionally, which reads "42" as
Chinese even in pure-English text).

Handles: commas in numbers, $/£ currency, ordinals (1st/2nd/3rd/4th...),
decimals, and plain cardinals up to the trillions. Years like 1984 read as
"nineteen eighty four".
"""

from __future__ import annotations

import re

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

_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}

RE_COMMA = re.compile(r"([0-9][0-9,]+[0-9])")
RE_POUNDS = re.compile(r"£([0-9.,]*[0-9]+)")
RE_DOLLARS = re.compile(r"\$([0-9.,]*[0-9]+)")
RE_DECIMAL = re.compile(r"([0-9]+\.[0-9]+)")
RE_ORDINAL = re.compile(r"([0-9]+)(st|nd|rd|th)")
RE_NUMBER = re.compile(r"[0-9]+")


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, ones = divmod(n, 10)
        return _TENS[tens] + ("" if not ones else " " + _ONES[ones])
    for scale, name in _SCALES:
        if n >= scale:
            major, rest = divmod(n, scale)
            words = number_to_words(major) + " " + name
            if rest:
                words += " " + number_to_words(rest)
            return words
    return _ONES[0]  # unreachable


def _year_to_words(n: int) -> str:
    # 1100-1999 / 2010-2099 read in pairs: "nineteen eighty four"
    if 1100 <= n < 2000 or 2010 <= n < 3000:
        hi, lo = divmod(n, 100)
        if lo == 0:
            return number_to_words(hi) + " hundred"
        if lo < 10:
            return number_to_words(hi) + " oh " + _ONES[lo]
        return number_to_words(hi) + " " + number_to_words(lo)
    return number_to_words(n)


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    if last in _ORDINAL_SPECIAL:
        last = _ORDINAL_SPECIAL[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return (head + " " if head else "") + last


def _expand_money(amount: str, unit: str, cent_unit: str) -> str:
    parts = amount.split(".")
    dollars = int(parts[0]) if parts[0] else 0
    cents = int((parts[1] + "0")[:2]) if len(parts) > 1 and parts[1] else 0
    out = []
    if dollars or not cents:
        out.append(
            number_to_words(dollars)
            + " "
            + (unit if dollars == 1 else unit + "s")
        )
    if cents:
        # Irregular plural: 'penny' -> 'pence' (the reference's inflect-based
        # expander yields 'pence' for £ amounts).
        cent_plural = "pence" if cent_unit == "penny" else cent_unit + "s"
        out.append(
            number_to_words(cents)
            + " "
            + (cent_unit if cents == 1 else cent_plural)
        )
    return " ".join(out)


def _expand_decimal(m: re.Match) -> str:
    whole, frac = m.group(1).split(".")
    digits = " ".join(_ONES[int(d)] for d in frac)
    return number_to_words(int(whole)) + " point " + digits


def normalize_numbers(text: str) -> str:
    """Expand every number-ish pattern in ``text`` to English words."""
    text = RE_COMMA.sub(lambda m: m.group(1).replace(",", ""), text)
    text = RE_POUNDS.sub(lambda m: _expand_money(m.group(1), "pound", "penny"), text)
    text = RE_DOLLARS.sub(lambda m: _expand_money(m.group(1), "dollar", "cent"), text)
    text = RE_DECIMAL.sub(_expand_decimal, text)
    text = RE_ORDINAL.sub(lambda m: ordinal_to_words(int(m.group(1))), text)
    text = RE_NUMBER.sub(lambda m: _year_to_words(int(m.group(0))), text)
    return text
