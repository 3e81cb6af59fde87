"""Chinese G2P: hanzi -> EmotiVoice phoneme strings (the port's own copy of
`emotivoice_tpu/frontend/cn.py`; same output for the same input).

Behavioral parity target: reference `frontend_cn.py:23-121`:
  - jieba word segmentation, pypinyin TONE3 (neutral tone = 5)
  - syllable split into initial (shengmu) + final-with-tone (yunmu), with the
    EmotiVoice conventions: zi/ci/si/ri -> `ii`, zhi/chi/shi -> `iii`,
    y-/w- rewrites to i/u/v finals, j/q/x + u -> v, ui/iu/un/ue expanded to
    uei/iou/uen/ve, erhua `r` suffix carried onto the final, tone digit
    appended to the final
  - prosody tokens: `sp0` between syllables of a word, `sp1` between words,
    `sp3` at punctuation; `<sos/eos>` sentence delimiters
  - digits normalized to Chinese numerals first

The hanzi->pinyin dictionary comes from pypinyin when installed; otherwise
text must be supplied as pinyin syllables (`pinyin_to_phonemes`) — the
DataBaker-style recipes use corpus pinyin labels and need no dictionary.
"""

from __future__ import annotations

import re
import string
from typing import List, Optional, Sequence

from emotivoice_tpu_torch.frontend.numbers_cn import an2cn

try:  # pragma: no cover - optional dependency
    import jieba

    _HAS_JIEBA = True
except ImportError:  # pragma: no cover
    _HAS_JIEBA = False

try:  # pragma: no cover - optional dependency
    from pypinyin import Style, pinyin as _pypinyin

    _HAS_PYPINYIN = True
    # The reference loads the cc_cedict phrase-pinyin dictionary before any
    # G2P (frontend_cn.py:20-21) — it overrides pypinyin's default polyphone
    # choices for thousands of multi-character words, so skipping it changes
    # pronunciations. Load it whenever available; it is optional packaging
    # on top of pypinyin.
    try:
        from pypinyin_dict.phrase_pinyin_data import cc_cedict

        cc_cedict.load()
    except ImportError:
        pass
except ImportError:  # pragma: no cover
    _HAS_PYPINYIN = False

RE_SYLLABIC_NASAL = re.compile(r"^(n|ng|m)$")
RE_DIGITS = re.compile(r"(\d[\d\.]*)")
CN_PUNCT = (
    "。，？！；：“”‘’《》"
    "〈〉【】『』—…、（）"
)

_Y_TO_I = {"ya", "yan", "yang", "yao", "ye", "yong", "you"}
_Y_BARE = {"yi", "yin", "ying"}
_Y_TO_V = {"yu", "yv", "yuan", "yvan", "yue", "yve", "yun", "yvn"}
_FINAL_REWRITE = {"ui": "uei", "iu": "iou", "un": "uen", "ue": "ve"}


def split_pinyin(syllable_tone: str) -> List[str]:
    """'zhong1' -> ['zh', 'ong1']; 'er2' -> ['', 'er2'] etc.

    Returns [initial, final+tone]; the initial may be ''.
    """
    tone = syllable_tone[-1]
    if tone not in "12345":
        tone = "5"
        py = syllable_tone
    else:
        py = syllable_tone[:-1]
    py = py.strip()

    if RE_SYLLABIC_NASAL.match(py):
        py = "e" + py  # syllabic n/ng/m read as en/eng/em

    erhua = ""
    if py.endswith("r") and py not in ("er", "r"):
        erhua = "r"
        py = py[:-1]

    if py in ("zi", "ci", "si", "ri"):
        initial, final = py[:1], "ii"
    elif py in ("zhi", "chi", "shi"):
        initial, final = py[:2], "iii"
    elif py in _Y_TO_I:
        initial, final = "", "i" + py[1:]
    elif py in _Y_BARE:
        initial, final = "", py[1:]
    elif py in _Y_TO_V:
        initial, final = "", "v" + py[2:]
    elif py == "wu":
        initial, final = "", "u"
    elif py.startswith("w"):
        initial, final = "", "u" + py[1:]
    elif len(py) >= 2 and py[0] in "jqx" and py[1] == "u":
        initial, final = py[0], "v" + py[2:]
    else:
        m = re.search("[aeiouv]", py)
        if m is None:
            initial, final = py, ""
        else:
            initial, final = py[: m.start()], py[m.start():]
        final = _FINAL_REWRITE.get(final, final)
    final = final + erhua + tone
    return [p for p in (initial, final) if p]


def normalize_numbers(text: str) -> str:
    """Replace Arabic digit runs with Chinese numerals
    (reference `tn_chinese`, frontend_cn.py:96-104)."""
    parts = RE_DIGITS.split(text)
    out = []
    for part in parts:
        if RE_DIGITS.match(part):
            out.append(an2cn(part))
        else:
            out.append(part)
    return "".join(out)


def _is_punct(s: str) -> bool:
    return any(ch in CN_PUNCT for ch in s) or (s in string.punctuation)


def pinyin_to_phonemes(
    syllables: Sequence[str], word_boundaries: bool = False
) -> List[str]:
    """TONE3 pinyin syllables -> flat phoneme list with sp0 separators."""
    phonemes: List[str] = []
    for i, syl in enumerate(syllables):
        if i > 0:
            phonemes.append("sp0")
        phonemes.extend(split_pinyin(syl))
    return phonemes


def word_to_pinyin(word: str) -> Optional[List[str]]:
    """hanzi word -> TONE3 syllables via pypinyin (None if unavailable)."""
    if not _HAS_PYPINYIN:
        return None
    res = _pypinyin(word, style=Style.TONE3, neutral_tone_with_five=True)
    return [r[0] for r in res]


def segment_words(text: str) -> List[str]:
    if _HAS_JIEBA:
        return list(jieba.cut(text))
    return list(text)  # per-character fallback


def g2p_cn(text: str) -> str:
    """Full Chinese G2P (reference `g2p_cn`, frontend_cn.py:106-121).

    Requires pypinyin for the hanzi->pinyin dictionary; raises a clear error
    otherwise (use `pinyin_to_phonemes` for pinyin-labelled corpora).
    """
    out = ["<sos/eos>"]
    for seg in segment_words(text):
        if seg == " ":
            continue
        seg = normalize_numbers(seg)
        syls = word_to_pinyin(seg)
        if syls is None:
            raise RuntimeError(
                "pypinyin is required for hanzi input; install it or supply "
                "pinyin syllables via pinyin_to_phonemes()"
            )
        if any(_is_punct(s) for s in syls):
            if out and out[-1] in ("sp1",):
                out.pop()
            out.append("sp3")
        else:
            out.extend(pinyin_to_phonemes(syls))
            out.append("sp1")
    out.append("<sos/eos>")
    return " ".join(out)
