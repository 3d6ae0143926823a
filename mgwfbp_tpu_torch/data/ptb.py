"""Penn Treebank word-level LM data (a copy of ``mgwfbp_tpu/data/ptb.py``).

The vocabulary is built from the training text (frequency-sorted word ->
id after ``<eos>`` substitution), a split is tokenized to one long id
stream, and ``carry_layout`` lays a stream out for stateful BPTT. Without
the ``ptb.{train,valid}.txt`` files a synthetic twin generates a
Markov-ish id stream with the same vocabulary size. The generators and
layouts are the JAX package's, so the same seed gives the same batches in
both packages.
"""

from __future__ import annotations

import collections
import os
from typing import Optional

import numpy as np

from mgwfbp_tpu_torch.data.loader import ArrayDataset

VOCAB_SIZE = 10000
NUM_STEPS = 35  # reference BPTT window (dl_trainer.py:459)


def build_vocab(path: str) -> dict[str, int]:
    """Frequency-sorted vocab (reference _build_vocab, ptb_reader.py:14-24:
    ids assigned by (-count, word) order, so id 0 = most frequent word;
    the ordering is an arbitrary relabeling for the model, but matching it
    makes tokenized streams comparable token-for-token)."""
    counter: collections.Counter = collections.Counter()
    with open(path) as f:
        for line in f:
            counter.update(line.split() + ["<eos>"])
    pairs = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
    return {w: i for i, (w, _) in enumerate(pairs)}


def tokenize(path: str, vocab: dict[str, int]) -> np.ndarray:
    ids = []
    with open(path) as f:
        for line in f:
            for w in line.split() + ["<eos>"]:
                if w in vocab:
                    ids.append(vocab[w])
    return np.asarray(ids, dtype=np.int32)


def windowed_lm_dataset(stream: np.ndarray, num_steps: int = NUM_STEPS,
                        vocab_size: int = VOCAB_SIZE) -> ArrayDataset:
    """Non-overlapping (input, target) windows: inputs are stream[i:i+T],
    targets stream[i+1:i+T+1] (reference TrainDataset windowing)."""
    n = (len(stream) - 1) // num_steps
    x = stream[: n * num_steps].reshape(n, num_steps)
    y = stream[1 : n * num_steps + 1].reshape(n, num_steps)
    return ArrayDataset(data=x, labels=y, num_classes=vocab_size)


def load_ptb_stream(data_dir: str, split: str = "train") -> Optional[tuple]:
    """(token stream, vocab size) for a PTB split, or None if files absent."""
    train_path = os.path.join(data_dir, "ptb.train.txt")
    split_path = os.path.join(data_dir, f"ptb.{split}.txt")
    if not (os.path.exists(train_path) and os.path.exists(split_path)):
        return None
    vocab = build_vocab(train_path)
    stream = tokenize(split_path, vocab)
    return stream, max(len(vocab), VOCAB_SIZE)


def load_ptb(data_dir: str, split: str = "train",
             num_steps: int = NUM_STEPS) -> Optional[ArrayDataset]:
    out = load_ptb_stream(data_dir, split)
    if out is None:
        return None
    stream, vocab_size = out
    return windowed_lm_dataset(stream, num_steps, vocab_size)


def synthetic_ptb_stream(n_windows: int = 512, num_steps: int = NUM_STEPS,
                         vocab_size: int = VOCAB_SIZE, seed: int = 0) -> np.ndarray:
    """Deterministic pseudo-corpus with local structure (each token biased by
    its predecessor) so perplexity can actually improve during smoke runs."""
    rng = np.random.RandomState(seed)
    total = n_windows * num_steps + 1
    stream = np.empty(total, dtype=np.int32)
    stream[0] = rng.randint(vocab_size)
    noise = rng.randint(0, vocab_size, size=total)
    take_noise = rng.rand(total) < 0.15
    for i in range(1, total):
        stream[i] = noise[i] if take_noise[i] else (stream[i - 1] * 31 + 7) % vocab_size
    return stream


def synthetic_ptb(n_windows: int = 512, num_steps: int = NUM_STEPS,
                  vocab_size: int = VOCAB_SIZE, seed: int = 0) -> ArrayDataset:
    return windowed_lm_dataset(
        synthetic_ptb_stream(n_windows, num_steps, vocab_size, seed),
        num_steps, vocab_size,
    )


def carry_layout(
    stream: np.ndarray,
    num_steps: int,
    batch_size: int,
    rank: int = 0,
    nranks: int = 1,
    vocab_size: int = VOCAB_SIZE,
) -> ArrayDataset:
    """Stateful-BPTT batch layout for one rank.

    The corpus is split into ``batch_size * nranks`` CONTIGUOUS sub-streams;
    rank r owns streams [r*B, (r+1)*B). The local dataset is window-major —
    sample ``w*B + j`` is window w of owned stream j — so a sequential
    drop_last loader of batch_size yields batches whose element j is
    textually contiguous with element j of the previous batch. That is the
    layout the carried LSTM hidden state requires (classic PTB batching);
    sample-wise DistributedSampler sharding would hand the carry
    discontiguous text every step.
    """
    nstreams = batch_size * nranks
    tokens_per_stream = (len(stream) - 1) // nstreams
    wps = tokens_per_stream // num_steps
    if wps == 0:
        raise ValueError(
            f"stream of {len(stream)} tokens too short for "
            f"{nstreams} streams x {num_steps} steps"
        )
    usable = nstreams * wps * num_steps
    x = stream[:usable].reshape(nstreams, wps, num_steps)
    y = stream[1 : usable + 1].reshape(nstreams, wps, num_steps)
    lo, hi = rank * batch_size, (rank + 1) * batch_size
    xl = x[lo:hi].transpose(1, 0, 2).reshape(wps * batch_size, num_steps)
    yl = y[lo:hi].transpose(1, 0, 2).reshape(wps * batch_size, num_steps)
    return ArrayDataset(data=xl, labels=yl, num_classes=vocab_size)
