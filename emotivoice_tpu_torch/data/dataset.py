"""Training data: jsonl datalist -> feature records -> bucketed batches
(the port's own copy of `emotivoice_tpu/data/dataset.py`; reference
`models/prompt_tts_modified/prompt_dataset.py`): per-utterance wav load and
amplitude trim, log-mel, z-scored frame pitch and energy, token and speaker
ids, and cached prompt / content embeddings.

Features are extracted by the port's `ops/mel`, `ops/pitch` and
`ops/stft` on the device the caller names (the card by default) and cached
to npz, so epochs after the first read the cache. Batches are padded to a
small ladder of (text, mel) buckets, as the JAX package pads them for its
static shapes; the port keeps the ladder so both pipelines give the same
batches.

Datalist format (reference `mfa/step8_make_data_list.py`): one JSON object
per line with keys `key`, `wav_path`, `speaker`, `text` (phoneme list),
`original_text`, `prompt`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from emotivoice_tpu_torch.config import EmotiVoiceConfig
from emotivoice_tpu_torch.frontend.tokens import TokenVocab
from emotivoice_tpu_torch.utils.audio_io import read_wav, trim_silence
from emotivoice_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Utterance:
    key: str
    wav_path: str
    speaker: str
    phonemes: List[str]
    original_text: str
    prompt: str


def read_datalist(path: str) -> List[Utterance]:
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            out.append(
                Utterance(
                    key=d["key"],
                    wav_path=d["wav_path"],
                    speaker=str(d["speaker"]),
                    phonemes=list(d["text"]),
                    original_text=d.get("original_text", ""),
                    prompt=d.get("prompt", ""),
                )
            )
    return out


class FeatureExtractor:
    """mel / pitch / energy of one utterance on `device`, with an npz cache."""

    # Wav lengths are padded up to this many samples before extraction, as
    # the JAX package pads them for its compile cache, so both give the same
    # features: the last ~win/hop frames see zero- instead of reflect-padding.
    length_quantum: int = 8192

    def __init__(self, cfg: EmotiVoiceConfig, cache_dir: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.cache_dir = cache_dir
        self.device = resolve_device(device)
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def _cache_path(self, key: str) -> Optional[str]:
        return os.path.join(self.cache_dir, f"{key}.npz") if self.cache_dir else None

    def __call__(self, key: str, wav: np.ndarray) -> Dict[str, np.ndarray]:
        cp = self._cache_path(key)
        if cp and os.path.exists(cp):
            with np.load(cp) as z:
                return {k: z[k] for k in z.files}
        from emotivoice_tpu_torch.ops.mel import mel_spectrogram
        from emotivoice_tpu_torch.ops.pitch import extract_pitch, normalize_pitch
        from emotivoice_tpu_torch.ops.stft import frame_energy

        a = self.cfg.audio
        q = self.length_quantum
        n_true = 1 + len(wav) // a.hop_length
        padded = -(-len(wav) // q) * q
        w = np.pad(wav, (0, padded - len(wav)))
        wt = torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(self.device)
        with torch.no_grad():
            mel = mel_spectrogram(wt, a.sampling_rate, a.n_fft, a.hop_length, a.win_length,
                                  a.n_mels, a.fmin, a.fmax).cpu().numpy().T  # (T, n_mels)
            if a.pitch_backend == "pyworld":
                from emotivoice_tpu_torch.ops.pitch import extract_pitch_pyworld

                f0 = extract_pitch_pyworld(w, a.sampling_rate, a.hop_length)
            else:
                f0 = extract_pitch(wt, a.sampling_rate, a.hop_length, a.n_fft,
                                   a.pitch_min, a.pitch_max).cpu().numpy()
            pitch = np.asarray(normalize_pitch(f0, a.pitch_stats))
            energy = frame_energy(wt, a.n_fft, a.hop_length, a.win_length).cpu().numpy()
        energy = (energy - a.energy_stats[0]) / a.energy_stats[1]
        n = min(mel.shape[0], len(pitch), len(energy), n_true)
        feats = {
            "mel": mel[:n].astype(np.float32),
            "pitch": pitch[:n].astype(np.float32),
            "energy": energy[:n].astype(np.float32),
        }
        if cp:
            np.savez(cp, **feats)
        return feats


class PromptTTSDataset:
    """Assembles full training records; embedding_fn maps a prompt/content
    string -> 768-d vector (SimBERT pooler; cached like the reference's
    tmp/{style,content}/*.npy, prompt_dataset.py:106-123). Features are
    extracted on `device` (None: the card)."""

    def __init__(
        self,
        datalist_path: str,
        cfg: EmotiVoiceConfig,
        vocab: TokenVocab,
        speaker_list: Sequence[str],
        embedding_fn: Callable[[str], np.ndarray],
        cache_dir: Optional[str] = None,
        trim: bool = True,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.utts = read_datalist(datalist_path)
        self.cfg = cfg
        self.vocab = vocab
        self.speaker2id = {s: i for i, s in enumerate(speaker_list)}
        self.embedding_fn = embedding_fn
        self.features = FeatureExtractor(cfg, cache_dir, device)
        self.emb_cache_dir = cache_dir
        self.trim = trim

    def __len__(self):
        return len(self.utts)

    def _embedding(self, kind: str, key: str, text: str) -> np.ndarray:
        if self.emb_cache_dir:
            p = os.path.join(self.emb_cache_dir, f"{key}.{kind}.npy")
            if os.path.exists(p):
                return np.load(p)
        emb = np.asarray(self.embedding_fn(text), np.float32)
        if self.emb_cache_dir:
            np.save(p, emb)
        return emb

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        u = self.utts[idx]
        sr, wav = read_wav(u.wav_path)
        assert sr == self.cfg.audio.sampling_rate, (sr, u.wav_path)
        if self.trim:
            wav = trim_silence(wav, sr)
        hop = self.cfg.audio.hop_length
        # Truncate to a whole number of frames so wav <-> mel alignment is
        # exact for segment cropping (T_wav = T_mel * hop).
        n_frames = len(wav) // hop
        wav = wav[: n_frames * hop]
        feats = self.features(u.key, wav)
        n_frames = min(n_frames, feats["mel"].shape[0])

        tokens = np.asarray(self.vocab.encode(u.phonemes), np.int32)
        return {
            "key": u.key,
            "tokens": tokens,
            "text_length": np.int32(len(tokens)),
            "speaker": np.int32(self.speaker2id[u.speaker]),
            "style_embedding": self._embedding("style", u.key, u.prompt),
            "content_embedding": self._embedding(
                "content", u.key, u.original_text
            ),
            "mel": feats["mel"][:n_frames],
            "mel_length": np.int32(n_frames),
            "pitch": feats["pitch"][:n_frames],
            "energy": feats["energy"][:n_frames],
            "wav": wav[: n_frames * hop],
        }


def _round_up(x: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if x <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass
class BucketSpec:
    """Static-shape ladder for (text, mel) padding."""

    text_buckets: Sequence[int] = (32, 64, 96, 128, 192)
    mel_buckets: Sequence[int] = (256, 384, 512, 768, 1024, 1536)


def collate(
    items: List[Dict[str, np.ndarray]],
    spec: BucketSpec,
    hop: int = 256,
) -> Dict[str, np.ndarray]:
    """Pad a list of records to the smallest fitting static bucket."""
    b = len(items)
    t_text = _round_up(max(len(i["tokens"]) for i in items), spec.text_buckets)
    t_mel = _round_up(max(int(i["mel_length"]) for i in items), spec.mel_buckets)

    batch = {
        "tokens": np.zeros((b, t_text), np.int32),
        "text_lengths": np.zeros((b,), np.int32),
        "speaker": np.zeros((b,), np.int32),
        "style_embedding": np.stack([i["style_embedding"] for i in items]),
        "content_embedding": np.stack([i["content_embedding"] for i in items]),
        "mel": np.zeros((b, t_mel, items[0]["mel"].shape[1]), np.float32),
        "mel_lengths": np.zeros((b,), np.int32),
        "pitch": np.zeros((b, t_mel), np.float32),
        "energy": np.zeros((b, t_mel), np.float32),
        "wav": np.zeros((b, t_mel * hop), np.float32),
    }
    for i, item in enumerate(items):
        n_text = min(len(item["tokens"]), t_text)
        n_mel = min(int(item["mel_length"]), t_mel)
        batch["tokens"][i, :n_text] = item["tokens"][:n_text]
        batch["text_lengths"][i] = n_text
        batch["speaker"][i] = item["speaker"]
        batch["mel"][i, :n_mel] = item["mel"][:n_mel]
        batch["mel_lengths"][i] = n_mel
        batch["pitch"][i, :n_mel] = item["pitch"][:n_mel]
        batch["energy"][i, :n_mel] = item["energy"][:n_mel]
        batch["wav"][i, : n_mel * hop] = item["wav"][: n_mel * hop]
    return batch


class BucketedLoader:
    """Length-bucketed batch iterator (shuffled, padded to the ladder).

    Groups utterances by their (text, mel) bucket pair, so every emitted
    batch has one of a small set of shapes.
    """

    def __init__(
        self,
        dataset: PromptTTSDataset,
        batch_size: int,
        spec: BucketSpec = BucketSpec(),
        seed: int = 0,
        drop_last: bool = True,
        shuffle: bool = True,
        pad_to_batch: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.spec = spec
        self.rng = np.random.RandomState(seed)
        self.drop_last = drop_last
        self.shuffle = shuffle
        # Pad final partial batches by repeating rows so every emitted batch
        # has exactly batch_size rows (validation then sees the training
        # shapes).
        self.pad_to_batch = pad_to_batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = (
            self.rng.permutation(len(self.dataset))
            if self.shuffle
            else np.arange(len(self.dataset))
        )
        pending: Dict[int, List] = {}
        hop = self.dataset.cfg.audio.hop_length
        for idx in order:
            item = self.dataset[int(idx)]
            tb = _round_up(len(item["tokens"]), self.spec.text_buckets)
            mb = _round_up(int(item["mel_length"]), self.spec.mel_buckets)
            bucket = pending.setdefault(tb * 10000 + mb, [])
            bucket.append(item)
            if len(bucket) == self.batch_size:
                yield collate(bucket, self.spec, hop)
                bucket.clear()
        if not self.drop_last:
            for bucket in pending.values():
                if not bucket:
                    continue
                if self.pad_to_batch:
                    i = 0
                    while len(bucket) < self.batch_size:
                        bucket.append(bucket[i % len(bucket)])
                        i += 1
                yield collate(bucket, self.spec, hop)


class PrefetchLoader:
    """Background-thread batch prefetcher with a bounded queue.

    The reference hides feature-extraction latency behind 8 DataLoader
    worker processes per rank (`train_am_vocoder_joint.py:224-231`); here
    extraction runs on the card or reads the npz cache, so one producer
    thread with a small lookahead keeps the card fed: batches N+1..N+depth
    are assembled while the train step for batch N runs.
    """

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        DONE, ERR = object(), object()
        stop = threading.Event()  # the consumer left early (end of a data-parallel epoch)

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for batch in self.loader:
                    if not put(batch):
                        return
            except BaseException as e:  # propagate to the consumer
                put((ERR, e))
                return
            put(DONE)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is DONE:
                    return
                if isinstance(item, tuple) and len(item) == 2 and item[0] is ERR:
                    raise item[1]
                yield item
        finally:
            stop.set()
