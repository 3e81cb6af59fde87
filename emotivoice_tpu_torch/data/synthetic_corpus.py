"""Synthetic speech-like mini corpus for training smoke runs (the port's own
copy of `tools/make_synthetic_corpus.py`, written through the port's
`utils/audio_io.write_wav`):

  python -m emotivoice_tpu_torch.data.synthetic_corpus --out DIR
      [--n-train 64] [--n-valid 8] [--n-speakers 4] [--seed 0]

Each phone token has a deterministic acoustic realisation (vowels are
glottal pulse trains shaped by per-vowel formant pairs, fricatives are
band-filtered noise, `sp` is silence) and each speaker a base F0, so the
aligner has durations to find and the predictors consistent targets.

Outputs: DIR/wav/*.wav, DIR/datalist.jsonl, DIR/valid.jsonl,
DIR/tokenlist, DIR/speakers.
"""

import argparse
import json
import os

import numpy as np

from emotivoice_tpu_torch.utils.audio_io import write_wav

SR = 16000

# phone -> (kind, params)
#   vowel: (f1, f2) formants; fric: (band_lo, band_hi); sp: silence
PHONES = {
    "a": ("vowel", (800, 1200)),
    "e": ("vowel", (500, 1800)),
    "i": ("vowel", (300, 2300)),
    "o": ("vowel", (500, 900)),
    "u": ("vowel", (350, 700)),
    "s": ("fric", (4000, 7000)),
    "f": ("fric", (1500, 5000)),
    "x": ("fric", (2500, 6000)),
    "sp": ("sil", None),
}
TOKENS = ["_", "<sos/eos>"] + sorted(PHONES)


def speaker_f0_table(n: int) -> dict:
    """n speakers with base F0 spread log-uniformly over 110..310 Hz (the
    4-speaker default keeps the original r2 smoke-corpus voices)."""
    if n <= 4:
        return dict(list({0: 120.0, 1: 170.0, 2: 230.0, 3: 300.0}.items())[:n])
    lo, hi = 110.0, 310.0
    return {
        i: float(lo * (hi / lo) ** (i / (n - 1))) for i in range(n)
    }


def _resonator(x, fc, bw):
    from scipy.signal import lfilter

    r = np.exp(-np.pi * bw / SR)
    theta = 2 * np.pi * fc / SR
    return lfilter([1 - r * r], [1.0, -2 * r * np.cos(theta), r * r], x)


def _bandnoise(n, lo, hi, rng):
    from scipy.signal import butter, lfilter

    b, a = butter(2, [lo / (SR / 2), hi / (SR / 2)], btype="band")
    return lfilter(b, a, rng.randn(n))


def synth_utterance(phones, base_f0, rng):
    """Phone list -> (wav, per-phone durations in samples)."""
    segs = []
    n_total = sum_d = 0
    f0 = base_f0 * (1 + 0.1 * rng.randn())
    for i, ph in enumerate(phones):
        kind, par = PHONES[ph]
        dur = int(SR * rng.uniform(0.06, 0.15))
        if kind == "sil":
            seg = np.zeros(dur)
        elif kind == "fric":
            seg = 0.25 * _bandnoise(dur, par[0], par[1], rng)
        else:
            # declining F0 across the sentence + per-phone jitter
            t = np.arange(dur) / SR
            decl = 1.0 - 0.25 * (n_total / (SR * 1.5))
            cur = f0 * max(decl, 0.6) * (1 + 0.03 * rng.randn())
            phase = np.cumsum(np.full(dur, cur)) / SR
            pulses = (np.diff(np.floor(phase), prepend=0.0) > 0).astype(float)
            seg = pulses
            for fc, bw in (par[0], 90), (par[1], 140), (2800, 250):
                seg = _resonator(seg, fc, bw)
            seg = seg / (np.abs(seg).max() + 1e-9) * 0.6
            # amplitude envelope to avoid clicks
            env = np.minimum(np.arange(dur), dur - np.arange(dur) - 1)
            seg = seg * np.clip(env / (0.01 * SR), 0, 1)
        segs.append(seg)
        n_total += dur
    wav = np.concatenate(segs)
    return (0.9 * wav / (np.abs(wav).max() + 1e-9)).astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--n-train", type=int, default=64)
    p.add_argument("--n-valid", type=int, default=8)
    p.add_argument("--n-speakers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    speaker_f0 = speaker_f0_table(args.n_speakers)
    rng = np.random.RandomState(args.seed)
    wav_dir = os.path.join(args.out, "wav")
    os.makedirs(wav_dir, exist_ok=True)

    with open(os.path.join(args.out, "tokenlist"), "w") as f:
        f.write("\n".join(TOKENS) + "\n")
    with open(os.path.join(args.out, "speakers"), "w") as f:
        f.write("\n".join(str(s) for s in sorted(speaker_f0)) + "\n")

    phones_pool = [p_ for p_ in PHONES if p_ != "sp"]
    records = []
    for i in range(args.n_train + args.n_valid):
        n_ph = rng.randint(6, 14)
        phones = []
        for j in range(n_ph):
            phones.append(phones_pool[rng.randint(len(phones_pool))])
            if j and rng.rand() < 0.15:
                phones.append("sp")
        speaker = int(rng.randint(len(speaker_f0)))
        wav = synth_utterance(phones, speaker_f0[speaker], rng)
        key = f"syn{i:04d}"
        path = os.path.join(wav_dir, key + ".wav")
        write_wav(path, wav, SR)
        records.append(
            {
                "key": key,
                "wav_path": path,
                "speaker": str(speaker),
                "text": ["<sos/eos>"] + phones + ["<sos/eos>"],
                "original_text": " ".join(phones),
                "prompt": "neutral",
            }
        )

    def dump(path, recs):
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")

    dump(os.path.join(args.out, "datalist.jsonl"), records[: args.n_train])
    dump(os.path.join(args.out, "valid.jsonl"), records[args.n_train:])
    print(
        f"wrote {args.n_train}+{args.n_valid} utterances, "
        f"{len(TOKENS)} tokens, {len(speaker_f0)} speakers -> {args.out}"
    )


if __name__ == "__main__":
    main()
