"""The one traffic generator: a mix's parameters (a data file under
`port_bench/traffic/`) and the seed in, the requests and their schedule out.

Every seed gets the same set of sizes and gaps in another order: token
counts are the mix's length distribution at fixed quantiles, and an open
loop's gaps are the exponential distribution's at fixed quantiles, each
shuffled by the seed. So the work and the arrivals of a run do not depend on
the seed, only their order does. Token ids, speakers and the style and
content embeddings are drawn from the seed.

Mix parameters:
  loop: "closed" (`batch` lines a call, one call outstanding, in corpus
        order; `lines` lines in blocks of `block_batches` calls, each block
        the same calls in another order (`corpus_lengths`), read again from
        the start when the window outlasts them) or "open" (Poisson
        arrivals at `rate_per_s`, each request handed at its due time to a
        micro-batcher of `max_batch` and `max_wait_ms`)
  tokens: {"dist": "lognormal", "median", "sigma", "min", "max"}
  alpha: duration scale of every request
  check_every, check_sample: one request in `check_every` (and each one
        longer than all before it) keeps its outputs for the check, which
        samples at most `check_sample` of them
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List

import numpy as np

LOOPS = ("closed", "open")


@dataclasses.dataclass
class Requests:
    """The inputs of a run, one row per request."""

    tokens: List[np.ndarray]  # token ids of each request
    speaker: np.ndarray  # (n,)
    style: np.ndarray  # (n, bert_embedding) f32
    content: np.ndarray  # (n, bert_embedding) f32
    alpha: float
    due: np.ndarray  # (n,) seconds after the window opens; closed loop: all 0

    def __len__(self) -> int:
        return len(self.tokens)


def check_mix(mix: Dict) -> None:
    if mix.get("loop") not in LOOPS:
        raise ValueError(f"traffic loop must be one of {LOOPS}, got {mix.get('loop')!r}")
    tok = mix["tokens"]
    if tok.get("dist") != "lognormal":
        raise ValueError(f"unknown length distribution {tok.get('dist')!r}")
    if not 1 <= tok["min"] <= tok["max"]:
        raise ValueError("tokens: need 1 <= min <= max")
    if mix["loop"] == "open" and not mix["rate_per_s"] > 0:
        raise ValueError("an open loop needs rate_per_s > 0")


def lengths(tok: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """n token counts: the lognormal's quantiles (i + 0.5) / n, clipped, in
    the seed's order."""
    z = [statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    x = np.rint(tok["median"] * np.exp(tok["sigma"] * np.asarray(z)))
    return rng.permutation(np.clip(x, tok["min"], tok["max"]).astype(np.int64))


def corpus_lengths(mix: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """A closed loop's token counts: blocks of `block_batches` batches, each
    block the same batches (the lognormal's quantiles over one block, put
    into batches once, seed-free), in the seed's order and with each batch's
    lines in the seed's order. So every window holds the same mix of
    buckets but for its last, partial block."""
    b = int(mix["batch"])
    per = int(mix["block_batches"]) * b
    base = lengths(mix["tokens"], per, np.random.default_rng(0)).reshape(-1, b)
    blocks = []
    for _ in range(-(-n // per)):
        block = base[rng.permutation(len(base))]
        blocks.append(np.stack([row[rng.permutation(b)] for row in block]).ravel())
    return np.concatenate(blocks)[:n]


def gaps(rate: float, n: int, rng: np.random.Generator) -> np.ndarray:
    """n exponential gaps of mean 1 / rate at quantiles (i + 0.5) / n, in the
    seed's order."""
    q = (np.arange(n) + 0.5) / n
    return rng.permutation(-np.log1p(-q) / rate)


def count(mix: Dict, seconds: float) -> int:
    """Requests a run makes: the closed loop's corpus, or the open loop's
    arrivals in the window."""
    if mix["loop"] == "closed":
        return int(mix["lines"])
    return max(1, int(round(mix["rate_per_s"] * seconds)))


def generate(mix: Dict, cfg: Dict, seed: int, seconds: float) -> Requests:
    check_mix(mix)
    rng = np.random.default_rng(int(seed))
    n = count(mix, seconds)
    a = cfg["am"]
    n_tok = (corpus_lengths(mix, n, rng) if mix["loop"] == "closed"
             else lengths(mix["tokens"], n, rng))
    flat = rng.integers(1, a["n_vocab"], size=int(n_tok.sum()))
    tokens = np.split(flat, np.cumsum(n_tok)[:-1])
    speaker = rng.integers(0, a["n_speaker"], size=n)
    emb = rng.standard_normal((2, n, a["bert_embedding"]), dtype=np.float32)
    due = np.zeros(n)
    if mix["loop"] == "open":
        due = np.cumsum(gaps(mix["rate_per_s"], n, rng))  # the last request due at ~seconds
    return Requests(tokens, speaker, emb[0], emb[1], float(mix["alpha"]), due)


def flagged(n_tokens: np.ndarray, every: int, seed: int) -> np.ndarray:
    """Requests whose outputs the run keeps for the check: one in `every`,
    drawn from the seed, and each request longer than all before it (so the
    longest of any prefix is among them)."""
    rng = np.random.default_rng([int(seed), 1])
    pick = rng.random(len(n_tokens)) < 1.0 / every
    running = np.maximum.accumulate(n_tokens)
    record = np.concatenate([[True], n_tokens[1:] > running[:-1]])
    return pick | record


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics (numpy's)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
