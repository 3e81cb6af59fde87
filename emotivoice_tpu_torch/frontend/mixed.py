"""Mixed Chinese/English G2P router (the port's own copy of
`emotivoice_tpu/frontend/mixed.py`; same output for the same input).

Behavioral parity target: reference `frontend.py:22-64` (`g2p_cn_en`):
  - if the text contains any Chinese, digits are normalized to Chinese first
  - split on CJK-vs-other boundaries; route segments to the CN / EN G2P
  - `cn_eng_sp` / `eng_cn_sp` boundary tokens at language switches
  - trailing silence token stripped; `<sos/eos>` wrap
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from emotivoice_tpu_torch.frontend.cn import RE_DIGITS, g2p_cn, normalize_numbers
from emotivoice_tpu_torch.frontend.en import get_eng_phoneme

RE_CHINESE = re.compile(r"[一-龥]")
# Same split as reference frontend.py:21: non-CJK runs vs CJK(+punct) runs.
RE_SEGMENT = re.compile(
    r"([^一-龥]+|[ 。，？！；：“”"
    r"‘’《》〈〉【】『』—"
    r"…、（）一-龥]+)",
    re.I,
)


def contains_chinese(text: str) -> bool:
    return RE_CHINESE.search(text) is not None


def g2p_cn_en(
    text: str,
    lexicon: Optional[Dict[str, List[str]]] = None,
    english_numbers: bool = False,
) -> str:
    # Reference policy (frontend.py:25): digits always become Chinese
    # numerals. ``english_numbers=True`` expands them to English words
    # instead when the text contains no Chinese (opt-in improvement).
    if english_numbers and not contains_chinese(text):
        from emotivoice_tpu_torch.frontend.numbers_en import (
            normalize_numbers as normalize_numbers_en,
        )

        text = normalize_numbers_en(text)
    text = normalize_numbers(text)
    parts = [p for p in RE_SEGMENT.split(text) if p]
    out: List[str] = ["<sos/eos>"]
    chartype = ""
    has_cn = contains_chinese(text)

    for part in parts:
        if part in (" ", ""):
            continue
        if (RE_DIGITS.match(part) and (has_cn or chartype == "")) or contains_chinese(part):
            if chartype == "en":
                out.append("eng_cn_sp")
            phoneme = g2p_cn(part).split()[1:-1]
            chartype = "cn"
        elif RE_SEGMENT.match(part):
            if chartype == "cn" and out and "sp" not in out[-1]:
                out.append("cn_eng_sp")
            phoneme = get_eng_phoneme(part, lexicon, pad_sos_eos=False).split()
            if not phoneme:
                continue
            chartype = "en"
        else:
            continue
        out.extend(phoneme)

    out = " ".join(out).split()
    if out and "sp" in out[-1]:
        out.pop()
    out.append("<sos/eos>")
    return " ".join(out)
