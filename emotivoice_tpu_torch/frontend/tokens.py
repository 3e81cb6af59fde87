"""Phoneme token inventory (the port's own copy of
`emotivoice_tpu/frontend/tokens.py`; same ids for the same tokens).

The reference model's token-id mapping is the line number of a 502-line
corpus-derived `tokenlist` file (reference `inference_am_vocoder_joint.py:76-77`,
structure: pad `_`, `<sos/eos>`, 69 bracketed ARPAbet phones, an
asciibetically sorted block of pinyin initials/finals-with-tone + silence
tokens, a tail of late-added extras, and `uncasedN` reserved slots).

That file is corpus data (it contains only the phoneme variants observed in
Youdao's corpus, e.g. `air1/2/4/5` but no `air3`), so it cannot be derived
from first principles. Therefore:

  - `TokenVocab.from_file(path)` loads any tokenlist (required for parity
    with reference checkpoints — point it at the original file shipped with
    the checkpoint download);
  - `default_inventory()` builds a self-contained superset inventory
    (every final x tone x erhua combination, stable sorted order) for
    training new models from scratch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

PAD = "_"
SOS_EOS = "<sos/eos>"

ARPABET_VOWELS = [
    "AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH", "IY", "OW",
    "OY", "UH", "UW",
]
ARPABET_CONSONANTS = [
    "B", "CH", "D", "DH", "F", "G", "HH", "JH", "K", "L", "M", "N", "NG",
    "P", "R", "S", "SH", "T", "TH", "V", "W", "Y", "Z", "ZH",
]

PINYIN_INITIALS = [
    "b", "c", "ch", "d", "f", "g", "h", "j", "k", "l", "m", "n", "p", "q",
    "r", "s", "sh", "t", "x", "y", "z", "zh",
]
PINYIN_FINALS = [
    "a", "ai", "an", "ang", "ao", "e", "ei", "en", "eng", "er", "i", "ia",
    "ian", "iang", "iao", "ie", "ii", "iii", "in", "ing", "iong", "iou",
    "o", "ong", "ou", "u", "ua", "uai", "uan", "uang", "ue", "uei", "uen",
    "ueng", "uo", "v", "van", "ve", "vn",
]
SILENCES = ["sp0", "sp1", "sp2", "sp3", "sp4", "engsp0", "engsp1", "engsp2",
            "engsp3", "engsp4", "spn"]
BOUNDARY = ["cn_eng_sp", "eng_cn_sp"]
EXTRAS = ["[LAUGH]", "?", ".", "!", "rr"]


def arpabet_tokens() -> List[str]:
    toks = []
    for v in ARPABET_VOWELS:
        for stress in "012":
            toks.append(f"[{v}{stress}]")
    for c in ARPABET_CONSONANTS:
        toks.append(f"[{c}]")
    return sorted(toks)


def default_inventory(n_uncased: int = 100) -> List[str]:
    """Self-contained superset token inventory (stable ordering)."""
    middle = set(PINYIN_INITIALS)
    for f in PINYIN_FINALS:
        for tone in "12345":
            middle.add(f + tone)
            middle.add(f + "r" + tone)  # erhua
            middle.add(f + "rr" + tone)  # double-r erhua (observed in corpus)
    middle.update(SILENCES)
    middle.update(BOUNDARY)
    toks = [PAD, SOS_EOS] + arpabet_tokens() + sorted(middle) + EXTRAS
    toks += [f"uncased{i}" for i in range(n_uncased)]
    return toks


@dataclasses.dataclass
class TokenVocab:
    tokens: List[str]
    token2id: Dict[str, int]

    @classmethod
    def from_tokens(cls, tokens: Sequence[str]) -> "TokenVocab":
        return cls(list(tokens), {t: i for i, t in enumerate(tokens)})

    @classmethod
    def from_file(cls, path: str) -> "TokenVocab":
        with open(path, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f]
        # Reference uses rstrip() then keeps line order (config.py:29-31).
        tokens = [t.strip() for t in tokens]
        return cls.from_tokens(tokens)

    @classmethod
    def default(cls) -> "TokenVocab":
        return cls.from_tokens(default_inventory())

    def __len__(self) -> int:
        return len(self.tokens)

    def encode(self, phonemes: Sequence[str], strict: bool = False) -> List[int]:
        """Phoneme strings -> ids; unknown tokens are dropped (the reference
        looks up `token2id[t]` and would raise; strict=True mirrors that)."""
        out = []
        for t in phonemes:
            if t in self.token2id:
                out.append(self.token2id[t])
            elif strict:
                raise KeyError(f"unknown phoneme token: {t!r}")
        return out

    def decode(self, ids: Sequence[int]) -> List[str]:
        return [self.tokens[i] for i in ids]


def load_label_list(path: str) -> List[str]:
    """Generic newline-separated label file loader (speakers, emotions...),
    mirroring reference `get_labels_length` (config/joint/config.py:18-30)."""
    with open(path, encoding="utf-8") as f:
        return [line.strip() for line in f]
