"""Port vs reference: the AN4 data path, the background prefetch and the
native host augment (mgwfbp_tpu_torch.data.{audio,loader,augment},
mgwfbp_tpu_torch.native vs mgwfbp_tpu).

Everything here is BIT-IDENTICAL to the JAX package:
  * ``log_spectrogram`` of the real wavs under data/an4 and of a seeded
    signal; ``read_wav``; the manifests' relative paths;
  * the loader's batches, on the real utterances of data/an4_memcheck and
    on the synthetic twin, at 1 and 2 ranks, epochs 0-2: ``load_batch(epoch,
    b)`` of the port against the JAX iterator's b-th batch, and the port's
    own iterator;
  * ``greedy_decode``, ``wer`` and ``cer`` on seeded logits and strings;
  * ``PrefetchLoader`` at 0, 1, 2 and 4 workers (and with pinned
    batches), from a resume's start index, and an epoch cut short or ended
    by an exception with no prefetch thread left alive; its thread mode
    over an iterator-only loader;
  * the port's native library (built here with g++ into build/): its two
    kernels against the numpy path and against ``mgwfbp_tpu.native`` on
    the same seeded uint8 batch, and the CIFAR and MNIST loaders' batches
    with and without it.
"""

import glob
import os
import threading
import time

import numpy as np
import pytest

from mgwfbp_tpu import native as jax_native
from mgwfbp_tpu.data import ShardInfo as JaxShardInfo
from mgwfbp_tpu.data import audio as jax_audio
from mgwfbp_tpu.data import data_prepare as jax_data_prepare
from mgwfbp_tpu_torch import native
from mgwfbp_tpu_torch.data import PrefetchLoader, ShardInfo, data_prepare
from mgwfbp_tpu_torch.data import audio
from mgwfbp_tpu_torch.data.augment import FusedCropFlipNormalize
from mgwfbp_tpu_torch.data.loader import ShardedLoader, normalize_images

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEMCHECK = os.path.join(ROOT, "data", "an4_memcheck")
MEAN = np.asarray([0.49, 0.48, 0.45], np.float32)
STD = np.asarray([0.2, 0.2, 0.2], np.float32)


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        and np.array_equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def memcheck_utts():
    """The real utterances of data/an4_memcheck, both packages'."""
    return {split: (audio.load_an4(MEMCHECK, split),
                    jax_audio.load_an4(MEMCHECK, split))
            for split in ("train", "val")}


# -- spectrograms and manifests ------------------------------------------


def test_spectrogram_of_real_and_seeded_signals_bit_identical():
    wavs = sorted(glob.glob(os.path.join(ROOT, "data", "an4", "**", "*.wav"),
                            recursive=True))[:6]
    assert wavs
    sig = np.random.RandomState(0).randn(5000).astype(np.float32) * 0.1
    for s in [audio.read_wav(w) for w in wavs] + [sig, sig[:100]]:
        a, b = audio.log_spectrogram(s), jax_audio.log_spectrogram(s)
        assert a.dtype == b.dtype == np.float32 and a.shape[1] == 161
        assert np.array_equal(a, b)
    assert np.array_equal(audio.read_wav(wavs[0]), jax_audio.read_wav(wavs[0]))


def test_manifests_resolve_relative_paths_as_jax(memcheck_utts):
    for split in ("train", "val"):
        path = os.path.join(MEMCHECK, f"an4_{split}_manifest.csv")
        rows = audio.load_manifest(path)
        assert rows == jax_audio.load_manifest(path) and len(rows) == 45
        assert all(os.path.exists(w) and os.path.exists(t) for w, t in rows)
        got, want = memcheck_utts[split]
        assert len(got) == len(want) == 45
        for u, v in zip(got, want):
            assert np.array_equal(u.spect, v.spect)
            assert np.array_equal(u.labels, v.labels)


# -- the loader ------------------------------------------------------------


@pytest.mark.parametrize("nranks", [1, 2])
@pytest.mark.parametrize("real", [True, False])
def test_loader_batches_bit_identical(memcheck_utts, real, nranks):
    if real:
        utts = memcheck_utts["train"]
    else:
        utts = (audio.synthetic_an4(40, seed=3),
                jax_audio.synthetic_an4(40, seed=3))
    for u, v in zip(*utts):
        assert np.array_equal(u.spect, v.spect)
    for rank in range(nranks):
        got = audio.AudioBatchLoader(utts[0], 4, ShardInfo(rank, nranks),
                                     seed=5)
        want = jax_audio.AudioBatchLoader(utts[1], 4,
                                          JaxShardInfo(rank, nranks), seed=5)
        assert got.num_batches == want.num_batches == (
            len(utts[0]) // 4 // nranks)
        for epoch in (0, 1, 2):
            want.set_epoch(epoch)
            got.set_epoch(epoch)
            wanted = list(want)
            assert len(wanted) == got.num_batches
            for b, w in enumerate(wanted):
                assert _same(got.load_batch(epoch, b), w), (epoch, b)
            assert all(_same(g, w) for g, w in zip(got, wanted))
            tail = list(got.batches(epoch, start=1))
            assert len(tail) == len(wanted) - 1
            assert all(_same(g, w) for g, w in zip(tail, wanted[1:]))


@pytest.mark.parametrize("synthetic", [True, None])
def test_data_prepare_an4_bit_identical(synthetic):
    kw = dict(batch_size=4, seed=2, synthetic=synthetic)
    data_dir = MEMCHECK if synthetic is None else "/nonexistent"
    got = data_prepare("an4", data_dir=data_dir, **kw)
    want = jax_data_prepare("an4", data_dir=data_dir, **kw)
    assert got.synthetic == want.synthetic == bool(synthetic)
    assert got.num_classes == want.num_classes == 29
    assert got.num_batches_per_epoch == want.num_batches_per_epoch
    assert isinstance(got.train, PrefetchLoader)
    for epoch in (0, 3):
        got.train.set_epoch(epoch)
        want.train.set_epoch(epoch)
        pairs = list(zip(got.train, want.train))
        assert len(pairs) == got.num_batches_per_epoch
        assert all(_same(g, w) for g, w in pairs)
    assert all(_same(g, w) for g, w in zip(got.val, want.val))


def test_greedy_decode_wer_cer_bit_identical():
    rs = np.random.RandomState(4)
    logits = rs.randn(5, 30, 29).astype(np.float32)
    logits[:, :, 0] += 1.0  # blanks, so that repeats collapse around them
    lengths = np.array([30, 25, 7, 1, 0])
    got = audio.greedy_decode(logits, lengths)
    assert got == jax_audio.greedy_decode(logits, lengths)
    assert got[-1] == ""
    refs = ["HELLO WORLD", "", "A B C", "ONE TWO THREE FOUR", "X"]
    for hyp in got + refs + ["HELO WORD", "A  B"]:
        for ref in refs:
            assert audio.wer(hyp, ref) == jax_audio.wer(hyp, ref)
            assert audio.cer(hyp, ref) == jax_audio.cer(hyp, ref)
    assert audio.text_to_ids("it's 2 b") .tolist() == \
        jax_audio.text_to_ids("it's 2 b").tolist()


# -- the prefetch ------------------------------------------------------------


def _prefetch_threads() -> list:
    return [t for t in threading.enumerate()
            if t.name.startswith("mgwfbp-prefetch")]


def _wait_no_prefetch_threads(timeout_s: float = 5.0) -> bool:
    end = time.time() + timeout_s
    while _prefetch_threads() and time.time() < end:
        time.sleep(0.02)
    return not _prefetch_threads()


class _IteratorOnly:
    """A loader with no load_batch (the thread mode's kind)."""

    def __init__(self, n: int):
        self.n, self.epoch = n, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __iter__(self):
        for b in range(self.n):
            yield (np.full((2, 3), self.epoch * 100 + b, np.float32),
                   np.arange(2))


def _image_loader(transform=None):
    rs = np.random.RandomState(0)
    from mgwfbp_tpu_torch.data import ArrayDataset

    data = ArrayDataset(rs.randint(0, 256, (64, 8, 8, 3)).astype(np.uint8),
                        rs.randint(0, 10, 64).astype(np.int32), 10)
    return ShardedLoader(data, 4, ShardInfo(1, 2), seed=3,
                         transform=transform or normalize_images(MEAN, STD))


@pytest.mark.parametrize("pin", [False, True])
@pytest.mark.parametrize("workers", [0, 1, 2, 4])
def test_prefetch_bit_identical_at_any_worker_count(memcheck_utts, workers,
                                                    pin):
    for make in (lambda: audio.AudioBatchLoader(
                     memcheck_utts["train"][0], 4, ShardInfo(0, 1), seed=1),
                 lambda: _image_loader(
                     FusedCropFlipNormalize(MEAN, STD, pad=2))):
        bare, pre = make(), PrefetchLoader(make(), workers=workers,
                                           pin_memory=pin)
        for epoch in (0, 1):
            want = [bare.load_batch(epoch, b) for b in range(bare.num_batches)]
            got = list(pre.batches(epoch))
            assert len(got) == len(want) == pre.num_batches
            for g, w in zip(got, want):
                g = {k: np.asarray(v) for k, v in g.items()} if isinstance(
                    g, dict) else tuple(np.asarray(v) for v in g)
                assert (_same(g, w) if isinstance(w, dict) else all(
                    np.array_equal(a, b) and a.dtype == b.dtype
                    for a, b in zip(g, w)))
            # a resume's start index, and a stop short of the end
            got = list(pre.batches(epoch, start=2, stop=5))
            assert len(got) == 3
            for g, w in zip(got, want[2:5]):
                x = g["x"] if isinstance(g, dict) else g[0]
                wx = w["x"] if isinstance(w, dict) else w[0]
                assert np.array_equal(np.asarray(x), wx)
        pre.set_epoch(1)
        assert pre.epoch == 1 and len(pre) == bare.num_batches
    assert _wait_no_prefetch_threads()


def test_prefetch_cut_short_and_raised_leave_no_thread():
    pre = PrefetchLoader(_image_loader(), workers=4, depth=2)
    it = pre.batches(0)
    next(it)
    assert _prefetch_threads()  # the pool is working ahead
    it.close()  # an epoch capped by --num-batches-per-epoch
    assert _wait_no_prefetch_threads()

    class Drain(Exception):
        pass

    with pytest.raises(Drain):  # the SIGTERM drain raises out of the loop
        for i, _ in enumerate(pre.batches(1)):
            if i == 2:
                raise Drain
    assert _wait_no_prefetch_threads()
    # the thread mode over an iterator-only loader, abandoned after one
    thread_mode = PrefetchLoader(_IteratorOnly(50), workers=2, depth=1)
    thread_mode.set_epoch(3)
    it = iter(thread_mode)
    x, _ = next(it)
    assert x[0, 0] == 300
    it.close()
    assert _wait_no_prefetch_threads()
    full = [x[0, 0] for x, _ in thread_mode]
    assert full == [300 + b for b in range(50)]
    assert _wait_no_prefetch_threads()


def test_data_workers_environment(monkeypatch):
    monkeypatch.setenv("MGWFBP_DATA_WORKERS", "0")
    bare = data_prepare("an4", synthetic=True, batch_size=4).train
    assert isinstance(bare, audio.AudioBatchLoader)
    monkeypatch.setenv("MGWFBP_DATA_WORKERS", "3")
    monkeypatch.setenv("MGWFBP_DATA_DEVICE_PUT", "1")
    pre = data_prepare("mnist", synthetic=True, batch_size=4).train
    assert isinstance(pre, PrefetchLoader)
    assert (pre.workers, pre.pin_memory) == (3, True)
    assert pre.dataset is pre.inner.dataset


# -- the native library -------------------------------------------------------


def _numpy_crop_flip(x, ys, xs, flips, pad):
    from mgwfbp_tpu_torch.data.augment import crop_at_offsets

    out = crop_at_offsets(x, ys, xs, pad)
    out[flips] = out[flips, :, ::-1]
    scale = (1.0 / (255.0 * STD)).astype(np.float32)
    shift = (MEAN / STD).astype(np.float32)
    return out.astype(np.float32) * scale - shift


def test_native_library_builds_into_build_and_matches_numpy_and_jax():
    assert native.available(), native.build_error  # g++ is on this machine
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(ROOT, "build",
                                                 "mgwfbp_tpu_torch")
    rs = np.random.RandomState(0)
    x = rs.randint(0, 256, size=(6, 32, 32, 3)).astype(np.uint8)
    ys, xs = rs.randint(0, 9, size=6), rs.randint(0, 9, size=6)
    flips = rs.rand(6) < 0.5
    got = native.fused_crop_flip_normalize(
        x, ys, xs, flips.astype(np.uint8), MEAN, STD, 4)
    assert np.array_equal(got, _numpy_crop_flip(x, ys, xs, flips, 4))
    theirs = jax_native.fused_crop_flip_normalize(
        x, ys, xs, flips.astype(np.uint8), MEAN, STD, 4)
    if theirs is not None:
        assert np.array_equal(got, theirs)
    scale = (1.0 / (255.0 * STD)).astype(np.float32)
    shift = (MEAN / STD).astype(np.float32)
    norm = native.normalize_u8(x, MEAN, STD)
    assert np.array_equal(norm, x.astype(np.float32) * scale - shift)
    theirs = jax_native.normalize_u8(x, MEAN, STD)
    if theirs is not None:
        assert np.array_equal(norm, theirs)
    assert native.normalize_u8(x.astype(np.float32), MEAN, STD) is None


@pytest.mark.parametrize("dataset", ["cifar10", "mnist"])
def test_loaders_with_and_without_native_bit_identical(monkeypatch, dataset):
    assert native.available()
    kw = dict(batch_size=8, seed=1, synthetic=True, shard=ShardInfo(0, 2))
    monkeypatch.setenv("MGWFBP_SYNTH_TRAIN_N", "64")
    monkeypatch.setenv("MGWFBP_SYNTH_VAL_N", "16")
    with_native = data_prepare(dataset, **kw)
    a = [with_native.train.load_batch(1, b) for b in range(3)]
    va = list(with_native.val)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    assert native.get_lib() is None
    without = data_prepare(dataset, **kw)
    b = [without.train.load_batch(1, k) for k in range(3)]
    vb = list(without.val)
    for (xa, ya), (xb, yb) in zip(a + va, b + vb):
        assert xa.dtype == xb.dtype == np.float32
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
