"""English G2P: text -> bracketed-ARPAbet phoneme strings (the port's own
copy of `emotivoice_tpu/frontend/en.py`; same output for the same input).

Behavioral parity target: reference `frontend_en.py:27-78`:
  - lexicon lookup first (librispeech-lexicon format: `WORD PH PH PH`)
  - fallback G2P for OOV words
  - phones wrapped in brackets (`[AH0]`), `engsp1` between words, `engsp4`
    at punctuation, trailing silence stripped, optional `<sos/eos>` wrap.

The reference's fallback is the g2p_en package (a neural LTS model); when it
is not installed we use a self-contained rule-based letter-to-sound engine
(`rule_g2p`) — ordered longest-match grapheme rules with contextual
conditions (magic-e, vowel digraphs, consonant digraphs). Supply a lexicon
file for best quality; the embedded mini-lexicon covers frequent irregular
words.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

try:  # pragma: no cover - optional dependency
    from g2p_en import G2p as _NeuralG2p

    _neural_g2p = None  # lazily constructed

    def _get_neural():
        global _neural_g2p
        if _neural_g2p is None:
            _neural_g2p = _NeuralG2p()
        return _neural_g2p

    _HAS_G2P_EN = True
except ImportError:  # pragma: no cover
    _HAS_G2P_EN = False


def read_lexicon(path: str) -> Dict[str, List[str]]:
    """librispeech-lexicon format loader (reference frontend_en.py:27-36)."""
    lex: Dict[str, List[str]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = re.split(r"\s+", line.strip())
            if len(parts) < 2:
                continue
            word = parts[0].lower()
            if word not in lex:
                lex[word] = parts[1:]
    return lex


# Frequent words with irregular spellings (fallback-only safety net).
MINI_LEXICON: Dict[str, str] = {
    "the": "DH AH0", "a": "AH0", "an": "AE1 N", "and": "AE1 N D",
    "of": "AH1 V", "to": "T UW1", "in": "IH0 N", "is": "IH1 Z",
    "you": "Y UW1", "that": "DH AE1 T", "it": "IH1 T", "he": "HH IY1",
    "was": "W AA1 Z", "for": "F AO1 R", "on": "AA1 N", "are": "AA1 R",
    "as": "AE1 Z", "with": "W IH1 DH", "his": "HH IH1 Z", "they": "DH EY1",
    "i": "AY1", "at": "AE1 T", "be": "B IY1", "this": "DH IH1 S",
    "have": "HH AE1 V", "from": "F R AH1 M", "or": "AO1 R",
    "one": "W AH1 N", "had": "HH AE1 D", "by": "B AY1", "but": "B AH1 T",
    "not": "N AA1 T", "what": "W AH1 T", "all": "AO1 L",
    "were": "W ER1", "we": "W IY1", "when": "W EH1 N", "your": "Y AO1 R",
    "can": "K AE1 N", "said": "S EH1 D", "there": "DH EH1 R",
    "do": "D UW1", "who": "HH UW1", "she": "SH IY1", "her": "HH ER1",
    "would": "W UH1 D", "could": "K UH1 D", "should": "SH UH1 D",
    "their": "DH EH1 R", "two": "T UW1", "been": "B IH1 N",
    "once": "W AH1 N S", "does": "D AH1 Z", "done": "D AH1 N",
    "some": "S AH1 M", "come": "K AH1 M", "love": "L AH1 V",
    "give": "G IH1 V", "live": "L IH1 V", "have": "HH AE1 V",
    "eye": "AY1", "eyes": "AY1 Z", "says": "S EH1 Z", "very": "V EH1 R IY0",
    "people": "P IY1 P AH0 L", "water": "W AO1 T ER0",
    "new": "N UW1", "year": "Y IH1 R", "happy": "HH AE1 P IY0",
    "hello": "HH AH0 L OW1", "world": "W ER1 L D",
    "voice": "V OY1 S", "speech": "S P IY1 CH",
    "beautiful": "B Y UW1 T AH0 F AH0 L", "friend": "F R EH1 N D",
    "again": "AH0 G EH1 N", "against": "AH0 G EH1 N S T",
    "through": "TH R UW1", "thought": "TH AO1 T", "though": "DH OW1",
    "enough": "IH0 N AH1 F", "because": "B IH0 K AO1 Z",
    "laugh": "L AE1 F", "heart": "HH AA1 R T", "great": "G R EY1 T",
    "any": "EH1 N IY0", "many": "M EH1 N IY0", "only": "OW1 N L IY0",
    "oh": "OW1", "ok": "OW2 K EY1", "okay": "OW2 K EY1",
}

# Ordered longest-match-first grapheme -> ARPAbet rules. '0'/'1' stress is
# assigned afterwards. Context: '$' end-of-word in pattern position.
_DIGRAPH_RULES = [
    ("tion", "SH AH N"), ("sion", "ZH AH N"), ("ture", "CH ER"),
    ("ought", "AO T"), ("augh", "AO"), ("eigh", "EY"), ("igh", "AY"),
    ("tch", "CH"), ("dge", "JH"), ("ck", "K"), ("wh", "W"), ("ph", "F"),
    ("sh", "SH"), ("ch", "CH"), ("th", "TH"), ("ng", "NG"), ("qu", "K W"),
    ("wr", "R"), ("kn", "N"), ("gn", "N"), ("mb$", "M"),
    ("oo", "UW"), ("ee", "IY"), ("ea", "IY"), ("ai", "EY"), ("ay", "EY"),
    ("oa", "OW"), ("ow", "OW"), ("ou", "AW"), ("oi", "OY"), ("oy", "OY"),
    ("au", "AO"), ("aw", "AO"), ("ew", "UW"), ("ue", "UW"), ("ui", "UW"),
    ("ar", "AA R"), ("er", "ER"), ("ir", "ER"), ("ur", "ER"), ("or", "AO R"),
    ("ey$", "IY"), ("y$", "IY"), ("ie$", "AY"), ("ed$", "D"), ("es$", "Z"),
    ("le$", "AH L"),
]
_SINGLE = {
    "a": "AE", "b": "B", "c": "K", "d": "D", "e": "EH", "f": "F", "g": "G",
    "h": "HH", "i": "IH", "j": "JH", "k": "K", "l": "L", "m": "M", "n": "N",
    "o": "AA", "p": "P", "r": "R", "s": "S", "t": "T", "u": "AH", "v": "V",
    "w": "W", "x": "K S", "y": "Y", "z": "Z",
}
_LONG_VOWEL = {"a": "EY", "e": "IY", "i": "AY", "o": "OW", "u": "Y UW"}
_VOWELS_ARPA = {"AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH",
                "IY", "OW", "OY", "UH", "UW"}


def _apply_magic_e(word: str) -> Dict[int, str]:
    """Positions where vowel-consonant-e makes the vowel long."""
    longs = {}
    m = re.search(r"([aeiou])([bcdfgklmnprstvz])e$", word)
    if m:
        longs[m.start(1)] = _LONG_VOWEL.get(m.group(1), _SINGLE[m.group(1)])
    return longs


def rule_g2p(word: str) -> List[str]:
    """Rule-based letter-to-sound for OOV words. Returns bare ARPAbet phones
    with stress digits on vowels."""
    w = word.lower()
    w = re.sub(r"[^a-z']", "", w)
    if not w:
        return []
    longs = _apply_magic_e(w)
    # Strip final silent e when magic-e applied.
    if longs and w.endswith("e"):
        w_proc = w[:-1]
    else:
        w_proc = w

    phones: List[str] = []
    i = 0
    while i < len(w_proc):
        if w_proc[i] == "'":
            i += 1
            continue
        if i in longs:
            phones.extend(longs[i].split())
            i += 1
            continue
        matched = False
        for pat, ph in _DIGRAPH_RULES:
            end_anchor = pat.endswith("$")
            p = pat[:-1] if end_anchor else pat
            if w_proc.startswith(p, i) and (
                not end_anchor or i + len(p) == len(w_proc)
            ):
                # soft c/g before e/i/y handled below; skip 'c'/'g' in pats
                phones.extend(ph.split())
                i += len(p)
                matched = True
                break
        if matched:
            continue
        ch = w_proc[i]
        nxt = w_proc[i + 1] if i + 1 < len(w_proc) else ""
        if ch == "c" and nxt in "eiy":
            phones.append("S")
        elif ch == "g" and nxt in "eiy" and len(w_proc) > 2:
            phones.append("JH")
        elif ch == "s" and i == len(w_proc) - 1 and i > 0 and phones and (
            phones[-1] in _VOWELS_ARPA or phones[-1] in {"B", "D", "G", "V",
                                                          "M", "N", "NG", "L", "R", "Z"}
        ):
            phones.append("Z")
        else:
            phones.extend(_SINGLE.get(ch, "").split())
        i += 1

    # Assign stress: primary on the first vowel, 0 elsewhere.
    out = []
    stressed = False
    for p in phones:
        if p in _VOWELS_ARPA:
            out.append(p + ("0" if stressed else "1"))
            stressed = True
        else:
            out.append(p)
    return out


def fallback_g2p(word: str) -> List[str]:
    """Mini-lexicon, then g2p_en if installed, then rule LTS."""
    lw = word.lower().strip()
    if lw in MINI_LEXICON:
        return MINI_LEXICON[lw].split()
    if _HAS_G2P_EN:  # pragma: no cover
        return [p for p in _get_neural()(word) if p.strip()]
    return rule_g2p(word)


def get_eng_phoneme(
    text: str,
    lexicon: Optional[Dict[str, List[str]]] = None,
    pad_sos_eos: bool = True,
) -> str:
    """Reference `get_eng_phoneme` (frontend_en.py:38-78): bracketed phones,
    engsp1 word gaps, engsp4 punctuation gaps, trailing gap stripped."""
    filters = {",", " ", "'"}
    phones: List[str] = []
    words = [w for w in re.split(r"([,;.\-\?\!\s+])", text) if w not in ("", " ")]

    for w in words:
        lw = w.lower()
        if lexicon and lw in lexicon:
            for ph in lexicon[lw]:
                if ph not in filters:
                    phones.append(f"[{ph}]")
            if phones and "sp" not in phones[-1]:
                phones.append("engsp1")
        elif re.search(r"[a-zA-Z]", w):
            phs = fallback_g2p(w)
            if not phs:
                continue
            for ph in phs:
                if ph not in filters:
                    phones.append(f"[{ph}]")
            if phones and "sp" not in phones[-1]:
                phones.append("engsp1")
        elif w in ",;.-?!":
            if phones:
                if phones[-1] == "engsp1":
                    phones.pop()
                phones.append("engsp4")
        else:
            continue

    if phones and "engsp" in phones[-1]:
        phones.pop()
    if pad_sos_eos:
        phones = ["<sos/eos>"] + phones + ["<sos/eos>"]
    return " ".join(phones)
