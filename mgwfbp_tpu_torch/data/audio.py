"""AN4 audio pipeline (a copy of ``mgwfbp_tpu/data/audio.py``): log
spectrograms, duration-bucketed CTC batches, greedy decoding, WER and CER.

Labels are the reference's 29-symbol CTC alphabet with the blank at index
0. Every batch is padded to one (max_time, max_label) shape over the train
and val sets together, as the JAX package pads it. Batches are a pure
function of (seed, epoch, rank, batch index): ``load_batch(epoch, b)`` is
the b-th batch that ``__iter__`` yields for that epoch, bit-identical to
the JAX package's iterator.
"""

from __future__ import annotations

import dataclasses
import os
import wave
from typing import Iterator, Optional

import numpy as np

from mgwfbp_tpu_torch.data.sharding import ShardInfo

# blank, apostrophe, A-Z, space = 29 symbols
LABELS = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ "
BLANK_ID = 0
LABEL_TO_ID = {c: i for i, c in enumerate(LABELS)}

SAMPLE_RATE = 16000
WINDOW_SIZE = 0.02  # 320 samples -> 161 rfft bins
WINDOW_STRIDE = 0.01
NUM_FREQ = int(SAMPLE_RATE * WINDOW_SIZE) // 2 + 1  # 161


def text_to_ids(text: str) -> np.ndarray:
    ids = [LABEL_TO_ID[c] for c in text.upper() if c in LABEL_TO_ID and c != "_"]
    return np.asarray(ids, dtype=np.int32)


def ids_to_text(ids) -> str:
    return "".join(LABELS[i] for i in ids if 0 <= i < len(LABELS))


def log_spectrogram(signal: np.ndarray, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """STFT log-magnitude (Hamming window, n_fft 320, hop 160), normalized
    per utterance: (T, 161) float32."""
    n_fft = int(sample_rate * WINDOW_SIZE)
    hop = int(sample_rate * WINDOW_STRIDE)
    if len(signal) < n_fft:
        signal = np.pad(signal, (0, n_fft - len(signal)))
    window = np.hamming(n_fft)
    nframes = 1 + (len(signal) - n_fft) // hop
    frames = np.lib.stride_tricks.as_strided(
        signal,
        shape=(nframes, n_fft),
        strides=(signal.strides[0] * hop, signal.strides[0]),
    )
    spect = np.abs(np.fft.rfft(frames * window, axis=1))
    spect = np.log1p(spect)
    mean, std = spect.mean(), spect.std()
    return ((spect - mean) / (std + 1e-6)).astype(np.float32)


def read_wav(path: str) -> np.ndarray:
    with wave.open(path, "rb") as w:
        data = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
    return data.astype(np.float32) / 32768.0


def load_manifest(path: str) -> list[tuple[str, str]]:
    """Rows of "wav_path,transcript_path". A relative entry resolves
    against the manifest's own directory; an absolute one is kept."""
    base = os.path.dirname(os.path.abspath(path))
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                wav, txt = line.split(",")[:2]
                rows.append(tuple(
                    p if os.path.isabs(p)
                    else os.path.normpath(os.path.join(base, p))
                    for p in (wav, txt)
                ))
    return rows


@dataclasses.dataclass
class Utterance:
    spect: np.ndarray  # (T, 161) float32
    labels: np.ndarray  # (L,) int32

    @property
    def duration(self) -> int:
        return self.spect.shape[0]


class AudioBatchLoader:
    """Duration-bucketed, rank-sharded CTC batches: dicts {x, y,
    input_lengths, label_lengths} padded to (max_time, max_label).
    Utterances are sorted by duration and cut into contiguous batches; each
    epoch shuffles the batch order (seeded by seed and epoch) and deals it
    to the ranks round-robin."""

    def __init__(
        self,
        utterances: list[Utterance],
        batch_size: int,
        shard: ShardInfo = ShardInfo(),
        max_time: Optional[int] = None,
        max_label: Optional[int] = None,
        seed: int = 0,
        shuffle_batches: bool = True,
    ):
        if not utterances:
            raise ValueError("no utterances")
        self.utts = sorted(utterances, key=lambda u: u.duration)
        self.batch_size = batch_size
        self.shard = shard
        self.max_time = max_time or max(u.duration for u in self.utts)
        self.max_label = max_label or max(len(u.labels) for u in self.utts)
        self.seed = seed
        self.shuffle_batches = shuffle_batches
        self.epoch = 0
        self._rebatch()

    def _rebatch(self) -> None:
        bs = self.batch_size
        nb = len(self.utts) // bs
        self._global_batches = [
            list(range(b * bs, (b + 1) * bs)) for b in range(nb)
        ]

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def set_batch_size(self, batch_size: int) -> None:
        """Re-batch the duration-sorted utterances at a new size (batching
        is eager here, so the batches are cut again), at most all of
        them."""
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.batch_size = min(batch_size, len(self.utts))
        self._rebatch()

    @property
    def num_batches(self) -> int:
        return len(self._global_batches) // self.shard.nranks

    def __len__(self) -> int:
        return self.num_batches

    def _rank_order(self, epoch: int) -> np.ndarray:
        """This rank's global batch indices for ``epoch``, in order."""
        order = np.arange(len(self._global_batches))
        if self.shuffle_batches:
            rng = np.random.RandomState(
                (self.seed * 1_000_003 + epoch) % (2**31 - 1)
            )
            rng.shuffle(order)
        return order[self.shard.rank :: self.shard.nranks][: self.num_batches]

    def load_batch(self, epoch: int, b: int) -> dict:
        """Batch ``b`` of ``epoch`` on this rank."""
        members = [self.utts[i]
                   for i in self._global_batches[self._rank_order(epoch)[b]]]
        B = len(members)
        x = np.zeros((B, self.max_time, NUM_FREQ), np.float32)
        y = np.zeros((B, self.max_label), np.int32)
        ilen = np.zeros((B,), np.int32)
        llen = np.zeros((B,), np.int32)
        for j, u in enumerate(members):
            t = min(u.duration, self.max_time)
            n = min(len(u.labels), self.max_label)
            x[j, :t] = u.spect[:t]
            y[j, :n] = u.labels[:n]
            ilen[j] = t
            llen[j] = n
        return {"x": x, "y": y, "input_lengths": ilen, "label_lengths": llen}

    def __iter__(self) -> Iterator[dict]:
        for b in range(self.num_batches):
            yield self.load_batch(self.epoch, b)

    def batches(self, epoch: int, start: int = 0,
                stop: Optional[int] = None) -> Iterator[dict]:
        """Batches ``start`` .. ``stop`` (default: the last) of ``epoch``."""
        self.set_epoch(epoch)
        stop = self.num_batches if stop is None else min(stop, self.num_batches)
        for b in range(start, stop):
            yield self.load_batch(epoch, b)


def load_an4(data_dir: str, split: str = "train") -> Optional[list[Utterance]]:
    """Utterances of an AN4 manifest's wav/txt files, if the manifest is
    there (rows whose files are missing are skipped)."""
    manifest = os.path.join(data_dir, f"an4_{split}_manifest.csv")
    if not os.path.exists(manifest):
        return None
    utts = []
    for wav, txt in load_manifest(manifest):
        if not (os.path.exists(wav) and os.path.exists(txt)):
            continue
        with open(txt) as f:
            transcript = f.read().strip()
        utts.append(
            Utterance(
                spect=log_spectrogram(read_wav(wav)),
                labels=text_to_ids(transcript),
            )
        )
    return utts or None


def synthetic_an4(
    n: int = 64, seed: int = 0, min_time: int = 80, max_time: int = 201,
    max_label: int = 24,
) -> list[Utterance]:
    """Seeded fake utterances with a spread of durations and a frequency
    band painted per label across its time slice, so the CTC loss can
    fall."""
    rng = np.random.RandomState(seed)
    utts = []
    for _ in range(n):
        t = int(rng.randint(min_time, max_time + 1))
        nlab = int(rng.randint(3, max_label + 1))
        labels = rng.randint(1, len(LABELS), size=nlab).astype(np.int32)
        spect = rng.randn(t, NUM_FREQ).astype(np.float32) * 0.5
        slice_len = max(t // nlab, 1)
        for k, lab in enumerate(labels):
            band = (int(lab) * 5) % (NUM_FREQ - 4)
            s = k * slice_len
            spect[s : s + slice_len, band : band + 4] += 2.0
        utts.append(Utterance(spect=spect, labels=labels))
    return utts


def an4_prepare(
    data_dir: str,
    batch_size: int,
    shard: ShardInfo = ShardInfo(),
    seed: int = 0,
    synthetic: Optional[bool] = None,
):
    """The an4 DataBundle: the manifests under ``data_dir`` when present,
    else (unless ``synthetic`` is False) the synthetic twin, 96 train and
    24 val utterances."""
    from mgwfbp_tpu_torch.data import DataBundle

    train = val = None
    if not synthetic:
        train = load_an4(data_dir, "train")
        val = load_an4(data_dir, "val")
    is_synth = train is None or val is None
    if is_synth:
        if synthetic is False:
            raise FileNotFoundError(f"AN4 manifests not found under {data_dir!r}")
        train = synthetic_an4(96, seed=seed)
        val = synthetic_an4(24, seed=seed + 1)
    max_time = max(u.duration for u in train + val)
    max_label = max(len(u.labels) for u in train + val)
    train_loader = AudioBatchLoader(
        train, batch_size, shard, max_time, max_label, seed
    )
    val_loader = AudioBatchLoader(
        val, batch_size, shard, max_time, max_label, seed,
        shuffle_batches=False,
    )
    return DataBundle(
        train=train_loader,
        val=val_loader,
        num_classes=len(LABELS),
        synthetic=is_synth,
        num_batches_per_epoch=len(train_loader),
    )


def greedy_decode(logits: np.ndarray, lengths: np.ndarray) -> list[str]:
    """argmax -> collapse repeats -> drop blanks, per sequence."""
    out = []
    ids = np.asarray(logits).argmax(-1)  # (B, T)
    for row, t in zip(ids, np.asarray(lengths)):
        row = row[: int(t)]
        collapsed = [int(r) for r, prev in zip(row, np.r_[-1, row[:-1]]) if r != prev]
        out.append(ids_to_text([c for c in collapsed if c != BLANK_ID]))
    return out


def _edit_distance(a: list, b: list) -> int:
    dp = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        prev = dp[0]
        dp[0] = i
        for j in range(1, len(b) + 1):
            cur = dp[j]
            dp[j] = min(dp[j] + 1, dp[j - 1] + 1, prev + (a[i - 1] != b[j - 1]))
            prev = cur
    return dp[-1]


def wer(hyp: str, ref: str) -> float:
    rw = ref.split()
    if not rw:
        return 0.0 if not hyp.split() else 1.0
    return _edit_distance(hyp.split(), rw) / len(rw)


def cer(hyp: str, ref: str) -> float:
    if not ref:
        return 0.0 if not hyp else 1.0
    return _edit_distance(list(hyp), list(ref)) / len(ref)
