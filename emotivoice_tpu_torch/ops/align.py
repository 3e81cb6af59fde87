"""Alignment ops on the device: beta-binomial prior, monotonic alignment
search (Viterbi), averaging over the path, and the CTC forward-sum loss
(counterpart of `emotivoice_tpu/ops/align.py`; the reference runs the first
three on the host with scipy and numba, `modules/alignment.py:59-172`).

`viterbi_decode` carries a (B, T_text) column through the frames in a
Python loop, a few small launches per frame: it is bound by launches, not by
the card (PERF.md). The back-pointer pass reads a choice table computed for
all frames at once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emotivoice_tpu_torch.utils.masks import NEG_INF, sequence_mask


def _algdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(gamma(b) / gamma(a + b)) for b >= 8 (scipy's `algdiv`, assuming
    a <= b), as the JAX package's betaln computes it."""
    c0, c1, c2 = 0.833333333333333e-01, -0.277777777760991e-02, 0.793650666825390e-03
    c3, c4, c5 = -0.595202931351870e-03, 0.837308034031215e-03, -0.165322962780713e-02
    h = a / b
    c = h / (1 + h)
    x = h / (1 + h)
    d = b + (a - 0.5)
    x2 = x * x
    s3 = 1.0 + (x + x2)
    s5 = 1.0 + (x + x2 * s3)
    s7 = 1.0 + (x + x2 * s5)
    s9 = 1.0 + (x + x2 * s7)
    s11 = 1.0 + (x + x2 * s9)
    t = (1.0 / b) ** 2
    w = ((((c5 * s11 * t + c4 * s9) * t + c3 * s7) * t + c2 * s5) * t + c1 * s3) * t + c0
    w = w * (c / b)
    u = d * torch.log1p(a / b)
    v = a * (torch.log(b) - 1.0)
    return torch.where(u <= v, (w - v) - u, (w - u) - v)


def betaln(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log B(a, b): lgamma(a) + lgamma(b) - lgamma(a+b) below b = 8, the
    asymptotic `algdiv` form above (the JAX package's, from scipy)."""
    a, b = torch.minimum(a, b), torch.maximum(a, b)
    small_b = torch.lgamma(a) + (torch.lgamma(b) - torch.lgamma(a + b))
    large_b = torch.lgamma(a) + _algdiv(a, b)
    return torch.where(b < 8, small_b, large_b)


def beta_binomial_prior(text_lengths: torch.Tensor, feats_lengths: torch.Tensor,
                        max_text: int, max_feats: int, w: float = 1.0) -> torch.Tensor:
    """log BetaBinom(k; N, a=w*t, b=w*(T-t+1)) for frame t (1-based) of T and
    token k of N, (B, max_feats, max_text); NEG_INF outside each item's
    (T, N) block (reference `AlignmentModule._generate_prior`)."""
    dev = text_lengths.device
    n = text_lengths.float()[:, None, None]
    t_total = feats_lengths.float()[:, None, None]
    t = torch.arange(1, max_feats + 1, device=dev, dtype=torch.float32)[None, :, None]
    k = torch.arange(max_text, device=dev, dtype=torch.float32)[None, None, :]
    a = w * t
    b = torch.clamp(w * (t_total - t + 1.0), min=1e-6)  # finite outside the valid frames
    logpmf = (torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0) - torch.lgamma(n - k + 1.0)
              + betaln(k + a, n - k + b) - betaln(a, b))
    valid = (sequence_mask(feats_lengths, max_feats)[:, :, None]
             & sequence_mask(text_lengths, max_text)[:, None, :])
    return torch.where(valid, logpmf, torch.full_like(logpmf, NEG_INF))


@torch.no_grad()
def mas_path(log_p_attn: torch.Tensor, text_lengths: torch.Tensor,
             feats_lengths: torch.Tensor) -> torch.Tensor:
    """Monotonic alignment search over a batch: path (B, T_feats) int64, the
    text index of each frame.

    Forward: Q[:, 0] = lp[0] at token 0, Q[j, i] = max(Q[j-1, i-1],
    Q[j-1, i]) + lp[j, i]. Backward from the last token: frame j takes
    a - 1 when a > 0 and Q[j, a-1] >= Q[j, a], else a (ties keep the
    diagonal); frames at or after each item's last frame, and padded frames,
    are pinned to its last token. The same decisions as the JAX package's
    `_mas_single` (and the reference's numba loop) on the same values."""
    b, t_feats, t_text = log_p_attn.shape
    dev = log_p_attn.device
    text_valid = sequence_mask(text_lengths, t_text)
    # frame-major (T_feats, B, T_text): each frame's column is contiguous
    lp = log_p_attn.float().masked_fill(~text_valid[:, None, :], NEG_INF)
    lp = lp.transpose(0, 1).contiguous()
    q = torch.empty_like(lp)
    q[0] = lp[0].masked_fill(torch.arange(t_text, device=dev)[None, :] != 0, NEG_INF)
    neg = torch.full((b, 1), NEG_INF, device=dev)
    for j in range(1, t_feats):
        shifted = torch.cat([neg, q[j - 1, :, :-1]], dim=1)
        torch.add(torch.maximum(shifted, q[j - 1]), lp[j], out=q[j])
    # step[j, b, i] = 1 where frame j moves from token i to i - 1
    step = torch.zeros(t_feats, b, t_text, dtype=torch.int64, device=dev)
    step[:, :, 1:] = (q[:, :, :-1] >= q[:, :, 1:]).to(torch.int64)
    last = (text_lengths - 1).to(torch.int64)
    pinned = (torch.arange(t_feats, device=dev)[None, :]
              >= (feats_lengths - 1).to(torch.int64)[:, None])
    cols = [last[:, None]]
    for j in range(t_feats - 2, -1, -1):
        a = cols[-1]
        cols.append(torch.where(pinned[:, j:j + 1], last[:, None],
                                a - torch.gather(step[j], 1, a)))
    path = torch.cat(cols[::-1], dim=1)
    frame_valid = sequence_mask(feats_lengths, t_feats)
    return torch.where(frame_valid, path, last[:, None])


def viterbi_decode(log_p_attn: torch.Tensor, text_lengths: torch.Tensor,
                   feats_lengths: torch.Tensor):
    """Batched MAS. Returns (durations (B, T_text) f32, bin_loss scalar,
    path (B, T_feats) int64). bin_loss = -mean over valid frames of
    log_p_attn along the path, averaged over the batch; it carries the
    gradient of log_p_attn, the path does not."""
    b, t_feats, t_text = log_p_attn.shape
    path = mas_path(log_p_attn.detach(), text_lengths, feats_lengths)
    frame_valid = sequence_mask(feats_lengths, t_feats).float()
    onehot = F.one_hot(path, t_text).float() * frame_valid[..., None]
    durations = onehot.sum(dim=1)
    selected = torch.gather(log_p_attn, 2, path[..., None])[..., 0]
    per_item = -(selected * frame_valid).sum(dim=1) / torch.clamp(feats_lengths.float(), min=1.0)
    return durations, per_item.mean(), path


def average_by_path(path: torch.Tensor, xs: torch.Tensor, text_lengths: torch.Tensor,
                    feats_lengths: torch.Tensor, max_text: int) -> torch.Tensor:
    """Token-level means of a frame-level track (B, T_feats) over the
    alignment path (reference `average_by_duration`); 0 for tokens with no
    frame and for padding."""
    frame_valid = sequence_mask(feats_lengths, path.shape[1]).float()
    onehot = F.one_hot(path, max_text).float() * frame_valid[..., None]
    sums = torch.einsum("bft,bf->bt", onehot, xs.float())
    counts = onehot.sum(dim=1)
    avg = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), torch.zeros_like(sums))
    return torch.where(sequence_mask(text_lengths, max_text), avg, torch.zeros_like(avg))


def forward_sum_loss(log_p_attn: torch.Tensor, text_lengths: torch.Tensor,
                     feats_lengths: torch.Tensor, blank_logprob: float = -1.0) -> torch.Tensor:
    """CTC forward-sum alignment loss through `F.ctc_loss`, as the
    reference's `ForwardSumLoss` (loss.py:62-97): a blank column of log-prob
    -1 before the text columns, log-softmax over blank + each item's own
    tokens, targets 1..N per item, reduction "mean" (each item's NLL over
    its N, then the batch mean). The JAX package runs the same 2N+1-state
    recursion as a scan."""
    b, t_feats, t_text = log_p_attn.shape
    dev = log_p_attn.device
    padded = torch.cat(
        [torch.full((b, t_feats, 1), blank_logprob, device=dev, dtype=log_p_attn.dtype),
         log_p_attn], dim=2)
    col_valid = torch.cat([torch.ones(b, 1, dtype=torch.bool, device=dev),
                           sequence_mask(text_lengths, t_text)], dim=1)
    padded = padded.masked_fill(~col_valid[:, None, :], NEG_INF)
    logp = torch.log_softmax(padded.float(), dim=2)
    targets = torch.arange(1, t_text + 1, device=dev).expand(b, t_text)
    return F.ctc_loss(logp.transpose(0, 1), targets, feats_lengths.to(torch.int64),
                      text_lengths.to(torch.int64), blank=0, reduction="mean")
