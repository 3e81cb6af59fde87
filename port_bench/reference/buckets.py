"""Frozen copy of the serving engine's bucket rule, for the reference to work
out which (rows, text, mel) bucket a request is served in.

A batch is padded to the batch ladder's rows, its text to the text ladder
above its longest line, and its mel to the mel ladder above text bucket x 8
frames a token (x alpha where alpha > 1). A row whose frames reach the mel
bucket is served again at the next mel bucket up, until it fits or the
ladder ends.
"""

from __future__ import annotations

from typing import Sequence, Tuple

TEXT = (16, 32, 48, 64, 96, 128, 192, 256)
MEL = (128, 192, 256, 384, 512, 768, 1024, 1536, 2048)
BATCH = (1, 2, 4, 8, 16, 32)
FRAMES_PER_TOKEN = 8.0


def bucket(x: int, ladder: Sequence[int]) -> int:
    for b in ladder:
        if x <= b:
            return b
    return ladder[-1]


def first_bucket(longest: int, alpha: float = 1.0) -> Tuple[int, int]:
    """(text bucket, mel bucket) of a batch whose longest line has
    `longest` tokens."""
    t_text = bucket(longest, TEXT)
    return t_text, bucket(int(t_text * FRAMES_PER_TOKEN * max(alpha, 1.0)), MEL)


def next_mel(max_frames: int) -> int:
    return bucket(max_frames + 1, MEL)


def rows(n: int) -> int:
    return bucket(n, BATCH)
