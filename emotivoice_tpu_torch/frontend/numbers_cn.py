"""Arabic-numeral -> Chinese-numeral normalization (the port's own copy of
`emotivoice_tpu/frontend/numbers_cn.py`; same output for the same input).

Own implementation of the behavior the reference gets from the cn2an package
(`cn2an/an2cn.py:13-208`, used by `frontend_cn.py:90-94`): integer part read
with positional units (十百千 / 万 / 亿) and zero-compression, decimal part
read digit-by-digit after 点. All four reference modes are supported:
``low`` (小写, the G2P path's default), ``up`` (大写 financial numerals),
``rmb`` (人民币大写: 元/角/分/整), ``direct`` (digit-by-digit).
"""

from __future__ import annotations

DIGITS = "零一二三四五六七八九"
DIGITS_UP = "零壹贰叁肆伍陆柒捌玖"
SMALL_UNITS = ["", "十", "百", "千"]
SMALL_UNITS_UP = ["", "拾", "佰", "仟"]
GROUP_UNITS = ["", "万", "亿", "万亿"]


def _tables(mode: str):
    if mode == "up":
        return DIGITS_UP, SMALL_UNITS_UP
    return DIGITS, SMALL_UNITS


def _four_digits_to_cn(chunk: str, mode: str = "low") -> str:
    """Convert an up-to-4-digit chunk, keeping internal zeros compressed."""
    digits, small_units = _tables(mode)
    out = []
    n = len(chunk)
    pending_zero = False
    for i, ch in enumerate(chunk):
        d = int(ch)
        unit = small_units[n - 1 - i]
        if d == 0:
            if any(int(c) for c in chunk[i + 1 :]):
                pending_zero = True
            continue
        if pending_zero:
            out.append("零")
            pending_zero = False
        out.append(digits[d] + unit)
    return "".join(out)


def int_to_cn(s: str, mode: str = "low") -> str:
    s = s.lstrip("0") or "0"
    if s == "0":
        return "零"
    chunks = []
    while s:
        chunks.append(s[-4:])
        s = s[:-4]
    # chunks[0] = least significant group of 4 digits
    parts = []
    for gi in range(len(chunks) - 1, -1, -1):
        chunk = chunks[gi].rjust(4, "0") if gi != len(chunks) - 1 else chunks[gi]
        cn = _four_digits_to_cn(chunk, mode)
        if not cn:
            continue
        # If a more significant group exists and this chunk has leading zeros,
        # a 零 separator is needed.
        if parts and len(chunks[gi].lstrip("0")) < 4 and not cn.startswith("零"):
            parts.append("零")
        parts.append(cn + GROUP_UNITS[gi])
    out = "".join(parts)
    # 一十X -> 十X at the very front (10..19 convention); up mode keeps 壹拾
    # (reference strips only "一十", an2cn.py:178-179).
    if out.startswith("一十"):
        out = out[1:]
    return out


def decimal_to_cn(s: str, mode: str = "low") -> str:
    digits, _ = _tables(mode)
    return "".join(digits[int(c)] for c in s if c.isdigit())


def _rmb(int_part: str, dec_part: str) -> str:
    """人民币大写 (reference an2cn.py:63-105): 元 + 角/分 + 整."""
    int_cn = int_to_cn(int_part or "0", "up")
    dec = (dec_part or "")[:2].ljust(2, "0") if dec_part else ""
    if not dec or dec == "00":
        return int_cn + "元整"
    d1, d2 = int(dec[0]), int(dec[1])
    out = "" if int_cn == "零" and d1 else int_cn + "元"
    if d1 and d2:
        return out + DIGITS_UP[d1] + "角" + DIGITS_UP[d2] + "分"
    if d1:
        return out + DIGITS_UP[d1] + "角"
    if d2:
        if int_cn == "零":
            return DIGITS_UP[d2] + "分"
        return out + "零" + DIGITS_UP[d2] + "分"
    return int_cn + "元整"


def an2cn(number: str, mode: str = "low") -> str:
    """'123.45' -> '一百二十三点四五'. Non-numeric input returned unchanged.

    mode: 'low' (default, the G2P path), 'up' (financial numerals), 'rmb'
    (元/角/分/整), 'direct' (digit-by-digit) — reference an2cn.py:20-115.
    """
    if mode not in ("low", "up", "rmb", "direct"):
        raise ValueError(f"mode must be low/up/rmb/direct, got {mode!r}")
    number = str(number).strip()
    if not number:
        return number
    neg = number.startswith("-")
    if neg:
        number = number[1:]
    if number.count(".") > 1 or not number.replace(".", "").isdigit():
        return ("负" if neg else "") + number
    sign = "负" if neg else ""
    if mode == "direct":
        return sign + "".join(
            "点" if c == "." else DIGITS[int(c)] for c in number
        )
    int_part, _, dec_part = number.partition(".")
    if mode == "rmb":
        return sign + _rmb(int_part, dec_part)
    cn = int_to_cn(int_part or "0", mode)
    dec = decimal_to_cn(dec_part, mode)
    return sign + cn + ("点" + dec if dec else "")
