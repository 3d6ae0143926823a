"""The port's dataset fetchers (``mgwfbp_tpu_torch/data/an4_fetch.py``,
``librispeech_fetch.py``) against the JAX package's, on local tarballs the
tests build themselves from a seeded tone generator: a full AN4 archive, a
truncated one, one whose test split is lost, and LibriSpeech archives of
wav entries (44.1 kHz stereo among them) and of flac entries. Each fetcher
writes its tree into the same directory in turn; every file of the port's
tree is byte-equal to the JAX fetcher's (the manifests name the same
absolute paths), and the reports are equal. A download is never made:
``urllib.request.urlopen`` is patched to raise, and both fetchers fail
with the same message. The port's fetchers import no JAX."""

from __future__ import annotations

import io
import os
import shutil
import tarfile
import urllib.request
import wave

import numpy as np
import pytest

from mgwfbp_tpu.data import an4_fetch as jax_an4
from mgwfbp_tpu.data import librispeech_fetch as jax_ls
from mgwfbp_tpu_torch.data import an4_fetch as an4
from mgwfbp_tpu_torch.data import librispeech_fetch as ls


def _tone(seconds: float, rate: int, rng: np.random.RandomState,
          dtype: str = "<i2") -> np.ndarray:
    t = np.arange(int(rate * seconds)) / rate
    freq = rng.uniform(200.0, 800.0)
    noise = rng.randn(len(t)) * 500.0
    return (np.sin(2 * np.pi * freq * t) * 12000 + noise).astype(dtype)


def _tar(entries: list[tuple[str, bytes]]) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as t:
        for name, data in entries:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def _an4_tar(train, test, seed: int = 0) -> bytes:
    """An an4_raw.bigendian.tar.gz twin: etc/ tables, then raw audio."""
    rng = np.random.RandomState(seed)
    entries = []
    for tag, utts in (("train", train), ("test", test)):
        ids = "".join(f"{path}\n" for path, _, _ in utts)
        tr = "".join(f"<s> {text} </s> ({os.path.basename(path)})\n"
                     for path, text, _ in utts)
        entries.append((f"an4/etc/an4_{tag}.fileids", ids.encode()))
        entries.append((f"an4/etc/an4_{tag}.transcription", tr.encode()))
    for path, _, seconds in train + test:
        entries.append((f"an4/wav/{path}.raw",
                        _tone(seconds, 16000, rng, ">i2").tobytes()))
    return _tar(entries)


TRAIN = [
    ("an4_clstk/aaa/utt1", "hello world", 2.0),
    ("an4_clstk/aaa/utt2", "YES", 1.5),
    ("an4_clstk/bbb/utt3", "NO", 0.5),  # pruned: under the min duration
    ("an4_clstk/bbb/utt4", "go home", 3.0),
    ("an4_clstk/bbb/utt5", "LONG ONE", 16.0),  # pruned: over the max
]
TEST = [("an4test_clstk/ccc/utt9", "stop", 2.0),
        ("an4test_clstk/ccc/utt8", "start", 1.2)]


def _tree(root: str) -> dict[str, bytes]:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _same_tree(tmp_path, run_jax, run_port) -> tuple[dict, dict, dict]:
    """Run the JAX fetcher into ``tmp/out``, move its tree aside, run the
    port's into the same path; (tree, JAX report, port report) after
    checking the trees byte for byte."""
    out = str(tmp_path / "out")
    want_report = run_jax(out)
    shutil.move(out, str(tmp_path / "jax"))
    got_report = run_port(out)
    want, got = _tree(str(tmp_path / "jax")), _tree(out)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert got_report == want_report
    return got, want_report, got_report


@pytest.mark.parametrize("cut", [None, 0.55], ids=["full", "truncated"])
def test_an4_tree_is_the_jax_fetchers(tmp_path, cut):
    data = _an4_tar(TRAIN, TEST)
    if cut is not None:
        data = data[: int(len(data) * cut)]
    src = str(tmp_path / "an4_raw.bigendian.tar.gz")
    with open(src, "wb") as f:
        f.write(data)
    tree, report, _ = _same_tree(
        tmp_path, lambda out: jax_an4.fetch_an4(out, source=src),
        lambda out: an4.fetch_an4(out, source=src))
    assert report["truncated_archive"] == (cut is not None)
    wavs = [n for n in tree if n.endswith(".wav")]
    if cut is None:
        assert report["splits"]["train"]["utterances"] == 3
        assert report["splits"]["train"]["duration_pruned"] == 2
        assert report["splits"]["val"]["utterances"] == 2
        assert len(wavs) == len(TRAIN) + len(TEST)
    else:
        missing = sum(s["missing_from_archive"]
                      for s in report["splits"].values())
        assert missing >= 1 and 1 <= len(wavs) < len(TRAIN) + len(TEST)


def test_an4_holds_out_val_as_the_jax_fetcher_does(tmp_path):
    train = [(f"an4_clstk/spk/utt{i}", f"word{i}", 1.0 + 0.1 * i)
             for i in range(12)]
    src = str(tmp_path / "an4.tar.gz")
    with open(src, "wb") as f:
        f.write(_an4_tar(train, []))
    _, report, _ = _same_tree(
        tmp_path, lambda out: jax_an4.fetch_an4(out, source=src),
        lambda out: an4.fetch_an4(out, source=src))
    assert report["val_held_out_from_train"] > 0


def test_an4_pieces_match(tmp_path):
    rng = np.random.RandomState(3)
    raw = _tone(0.25, 16000, rng, ">i2").tobytes()
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    assert an4.raw_to_wav(raw, a) == jax_an4.raw_to_wav(raw, b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    for line in ("<s> HELLO WORLD </s> (utt1)", "<s> yes </s> (x)",
                 "go <sil> home (y)"):
        assert an4.process_transcript(line) == jax_an4.process_transcript(line)


def _ls_tar(utts, tmp_path, kind: str = "wav", seed: int = 0) -> str:
    """A LibriSpeech twin: per-chapter audio (16 kHz mono wav, 44.1 kHz
    stereo wav or fake flac) and the chapter's transcript table."""
    rng = np.random.RandomState(seed)
    entries, chapters = [], {}
    for utt_id, text, seconds in utts:
        spk, chap, _ = utt_id.split("-")
        chapters.setdefault((spk, chap), []).append((utt_id, text))
        stem = f"LibriSpeech/dev-clean/{spk}/{chap}/{utt_id}"
        if kind == "flac":
            entries.append((stem + ".flac", b"fLaC fake"))
            continue
        rate, channels = (16000, 1) if kind == "wav" else (44100, 2)
        pcm = _tone(seconds, rate, rng)
        if channels == 2:
            pcm = np.stack([pcm, pcm // 2], axis=1)
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(pcm.tobytes())
        entries.append((stem + ".wav", buf.getvalue()))
    for (spk, chap), rows in chapters.items():
        table = "".join(f"{u} {t}\n" for u, t in rows)
        entries.append(
            (f"LibriSpeech/dev-clean/{spk}/{chap}/{spk}-{chap}.trans.txt",
             table.encode()))
    src = str(tmp_path / f"ls_{kind}.tar.gz")
    with open(src, "wb") as f:
        f.write(_tar(entries))
    return src


UTTS = [
    ("84-121123-0001", "hello there", 2.0),
    ("84-121123-0002", "general kenobi", 1.5),
    ("84-121550-0000", "too short", 0.5),  # pruned on train
    ("174-50561-0000", "another speaker", 3.0),
]


@pytest.mark.parametrize("kind,split", [("wav", "train"), ("wav", "val"),
                                        ("stereo44k", "train")])
def test_librispeech_tree_is_the_jax_fetchers(tmp_path, kind, split):
    src = _ls_tar(UTTS, tmp_path, kind)
    _, report, _ = _same_tree(
        tmp_path,
        lambda out: jax_ls.fetch_librispeech(out, [src], split=split),
        lambda out: ls.fetch_librispeech(out, [src], split=split))
    assert report["utterances"] == (3 if split == "train" else 4)


def test_librispeech_flac_without_a_decoder_fails_alike(tmp_path):
    src = _ls_tar(UTTS[:1], tmp_path, "flac")
    with pytest.raises(SystemExit) as want:
        jax_ls.fetch_librispeech(str(tmp_path / "a"), [src])
    with pytest.raises(SystemExit) as got:
        ls.fetch_librispeech(str(tmp_path / "b"), [src])
    assert str(got.value) == str(want.value) and "soundfile" in str(got.value)


def _no_network(*args, **kwargs):
    raise OSError("network unreachable")


def test_a_failed_download_fails_as_the_jax_fetchers_do(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(urllib.request, "urlopen", _no_network)
    with pytest.raises(SystemExit) as want:
        jax_an4.fetch_an4(str(tmp_path / "a"))
    with pytest.raises(SystemExit) as got:
        an4.fetch_an4(str(tmp_path / "b"))
    assert str(got.value) == str(want.value)
    assert an4.AN4_URL in str(got.value) and "--source" in str(got.value)
    with pytest.raises(SystemExit) as want:
        jax_ls.main(["--target-dir", str(tmp_path / "c"), "--split", "val"])
    with pytest.raises(SystemExit) as got:
        ls.main(["--target-dir", str(tmp_path / "d"), "--split", "val"])
    assert str(got.value) == str(want.value)
    assert ls.LIBRISPEECH_URLS["val"][0] in str(got.value)


def test_cli_entry_points_match(tmp_path, capsys):
    src = str(tmp_path / "an4.tar.gz")
    with open(src, "wb") as f:
        f.write(_an4_tar(TRAIN, TEST))
    out = str(tmp_path / "cli")
    assert an4.main(["--target-dir", out, "--source", src]) == 0
    got = capsys.readouterr().out
    shutil.rmtree(out)
    assert jax_an4.main(["--target-dir", out, "--source", src]) == 0
    assert got == capsys.readouterr().out


def test_fetchers_import_no_jax():
    import ast

    for mod in (an4, ls):
        tree = ast.parse(open(mod.__file__).read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)]
        assert not [n for n in names
                    if n.split(".")[0] in ("jax", "mgwfbp_tpu")], names
