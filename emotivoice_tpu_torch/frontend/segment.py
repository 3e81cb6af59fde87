"""Sentence segmentation for long-form synthesis (the port's own copy of
`emotivoice_tpu/frontend/segment.py`; same output for the same input).

The reference bounds synthesis length only by its 5000-frame positional
table (reference `modules/encoder.py:206`, ~80 s of mel) and lists "Support
longer text" as future work (reference `ROADMAP.md:12-14`). The answer here
is frontend chunking: split text into sentences, batch the chunks through
the static-bucket engine in one device dispatch, and stitch the waveforms,
so a long input never outgrows the largest bucket.
"""

from __future__ import annotations

from typing import List

# Sentence-final punctuation (CN + EN). Kept attached to the sentence so the
# G2P emits its terminal silence token (sp3 / engsp4).
_SENT_END = "。！？!?…"
# Soft break points used when a single sentence exceeds max_chars.
_SOFT_BREAK = "，،,;；:："


def split_sentences(text: str, max_chars: int = 120) -> List[str]:
    """Split ``text`` into synthesis chunks of at most ~max_chars.

    Sentence-final punctuation ends a chunk; consecutive short sentences are
    merged up to ``max_chars``; an over-long sentence is split at soft
    punctuation, then hard-wrapped as a last resort. Returns non-empty,
    stripped chunks; ``[""]``-free (empty input -> empty list).
    """
    text = text.strip()
    if not text:
        return []

    sentences: List[str] = []
    buf: List[str] = []
    for ch in text:
        buf.append(ch)
        if ch in _SENT_END:
            sentences.append("".join(buf).strip())
            buf = []
    tail = "".join(buf).strip()
    if tail:
        sentences.append(tail)

    def _hard_split(s: str) -> List[str]:
        if len(s) <= max_chars:
            return [s]
        # prefer the soft break closest to max_chars from the left
        cut = -1
        for i, ch in enumerate(s[:max_chars]):
            if ch in _SOFT_BREAK or ch == " ":
                cut = i
        if cut <= 0:
            cut = max_chars - 1
        head, rest = s[: cut + 1].strip(), s[cut + 1 :].strip()
        out = [head] if head else []
        if rest:
            out.extend(_hard_split(rest))
        return out

    pieces: List[str] = []
    for s in sentences:
        pieces.extend(_hard_split(s))

    # greedy merge of short neighbours
    chunks: List[str] = []
    cur = ""
    for p in pieces:
        if not cur:
            cur = p
        elif len(cur) + len(p) + 1 <= max_chars:
            joiner = "" if (cur and cur[-1] in _SENT_END + _SOFT_BREAK) else " "
            # CJK text has no spaces between sentences
            if cur and _is_cjk(cur[-1]):
                joiner = ""
            cur = cur + joiner + p
        else:
            chunks.append(cur)
            cur = p
    if cur:
        chunks.append(cur)
    return [c for c in chunks if c]


def _is_cjk(ch: str) -> bool:
    return "一" <= ch <= "龥" or ch in _SENT_END + "，；：、"
