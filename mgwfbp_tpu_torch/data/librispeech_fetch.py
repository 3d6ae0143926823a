"""LibriSpeech corpus acquisition: download/extract/convert/manifest
(counterpart of ``mgwfbp_tpu/data/librispeech_fetch.py``, whose output
tree it writes byte for byte from the same tarballs).

Parity target: reference audio_data/librispeech.py — wget the openslr
tarballs (train-clean-100/360, train-other-500, dev-*, test-*), sox-convert
each .flac to 16 kHz mono wav, pair each utterance with its line in the
chapter's ``<spk>-<chap>.trans.txt`` (transcript uppercased), and write
duration-sorted manifests (train pruned to [min, max] seconds).

Re-design differences (no external processes, zero-egress friendly):
  * `--source` accepts local tarballs; downloads are attempted only when a
    URL is reachable. Truncated archives are salvaged entry-by-entry
    (shared machinery with an4_fetch).
  * .flac decode needs a decoder library (`soundfile`); where none is
    installed, .flac entries raise an actionable error. Archives whose audio is already .wav (or raw PCM s16) are
    converted with the stdlib alone — the full pipeline is testable and
    usable without FLAC support.

Usage:
  python -m mgwfbp_tpu_torch.data.librispeech_fetch \
      --target-dir data/librispeech --source dev-clean.tar.gz [--split val]
Then train with ``python -m mgwfbp_tpu_torch.train_cli --dnn lstman4
--data-dir data/librispeech`` (the manifest format and loader are shared
with AN4: ``data.audio.load_an4`` reads ``an4_{split}_manifest.csv`` naming
under any data_dir).
"""

from __future__ import annotations

import argparse
import json
import os
import wave
from typing import Optional

import numpy as np

from mgwfbp_tpu_torch.data.an4_fetch import pcm_to_wav, stream_tar_entries

LIBRISPEECH_URLS = {
    "train": [
        "http://www.openslr.org/resources/12/train-clean-100.tar.gz",
    ],
    "val": ["http://www.openslr.org/resources/12/dev-clean.tar.gz"],
}
SAMPLE_RATE = 16000


def preprocess_transcript(phrase: str) -> str:
    """Reference librispeech.py:40-41."""
    return phrase.strip().upper()


def _conform_pcm(pcm: np.ndarray, rate: int) -> np.ndarray:
    """s16 PCM at any rate/channels -> 16 kHz mono s16.

    Downmix by channel mean; nearest-sample resample (sox's -r equivalent
    in spirit; LibriSpeech is natively 16 kHz so the resample path is
    rarely taken)."""
    if pcm.ndim > 1:
        pcm = pcm.mean(axis=1).astype(np.int16)
    if rate != SAMPLE_RATE:
        idx = np.round(
            np.arange(0, len(pcm), rate / SAMPLE_RATE)
        ).astype(np.int64)
        pcm = pcm[np.minimum(idx, len(pcm) - 1)]
    return pcm


def _decode_flac(data: bytes) -> Optional[np.ndarray]:
    """FLAC -> int16 mono PCM at 16 kHz, or None when no decoder exists."""
    try:
        import io

        import soundfile  # optional: used where it is installed
    except ImportError:
        return None
    pcm, rate = soundfile.read(io.BytesIO(data), dtype="int16")
    return _conform_pcm(pcm, rate)


def _audio_to_wav(name: str, data: bytes, wav_path: str) -> float:
    """Archive audio entry -> 16 kHz mono s16 wav; returns duration (s)."""
    if name.endswith(".wav"):
        # Never pass archive wavs through unchecked: a 44.1 kHz / stereo /
        # 24-bit file would silently feed wrong-rate audio into the
        # 16 kHz-mono feature pipeline. Conform what we can
        # (downmix, s16 cast, nearest-sample resample); reject the rest.
        import io

        with wave.open(io.BytesIO(data)) as w:
            rate, channels, width = (
                w.getframerate(), w.getnchannels(), w.getsampwidth()
            )
            frames = w.readframes(w.getnframes())
        if width != 2:
            raise SystemExit(
                f"{name}: {8 * width}-bit wav; this pipeline expects s16 "
                "PCM — pre-convert the archive audio to 16 kHz mono s16"
            )
        pcm = np.frombuffer(frames, dtype="<i2")
        if channels > 1:
            pcm = pcm.reshape(-1, channels)
        return pcm_to_wav(_conform_pcm(pcm, rate), wav_path)
    if name.endswith(".flac"):
        pcm = _decode_flac(data)
        if pcm is None:
            raise SystemExit(
                f"{name}: .flac decoding needs the 'soundfile' library, "
                "which this environment does not ship. Either install it, "
                "or pre-convert the archive's audio to .wav (any tool; "
                "16 kHz mono s16) and re-tar — the rest of the pipeline "
                "is pure Python."
            )
    else:  # raw big-endian s16 (AN4-style) tolerated for symmetry
        pcm = np.frombuffer(data, dtype=">i2").astype("<i2")
    return pcm_to_wav(pcm, wav_path)


def fetch_librispeech(
    target_dir: str,
    sources: list[str],
    split: str = "train",
    min_duration: float = 1.0,
    max_duration: float = 15.0,
) -> dict:
    """Build wav/txt layout + manifest for one split from tarball(s).

    LibriSpeech layout inside each tarball:
      LibriSpeech/<subset>/<speaker>/<chapter>/<spk>-<chap>-<utt>.flac
      LibriSpeech/<subset>/<speaker>/<chapter>/<spk>-<chap>.trans.txt
    Output layout + manifest naming match an4_fetch (data/audio.load_an4
    consumes either corpus identically).
    """
    wav_dir = os.path.join(target_dir, split, "librispeech", "wav")
    txt_dir = os.path.join(target_dir, split, "librispeech", "txt")
    os.makedirs(wav_dir, exist_ok=True)
    os.makedirs(txt_dir, exist_ok=True)
    rows = []
    report = {
        "sources": sources, "split": split, "truncated": [],
        "missing_transcript": 0, "utterances": 0, "duration_pruned": 0,
    }
    for source in sources:
        # two STREAMING passes (constant memory — LibriSpeech tarballs are
        # multi-GB): pass 1 collects the small per-chapter transcript
        # tables, pass 2 converts audio one member at a time
        trans: dict[str, str] = {}
        it = stream_tar_entries(source)
        for name, data in it:
            if name.endswith(".trans.txt"):
                for line in data.decode().splitlines():
                    parts = line.split()
                    if parts:
                        trans[parts[0]] = " ".join(parts[1:])
        truncated = it.truncated
        it = stream_tar_entries(source)
        for name, data in it:
            base = os.path.basename(name)
            stem, ext = os.path.splitext(base)
            if ext not in (".flac", ".wav", ".raw"):
                continue
            if stem not in trans:
                report["missing_transcript"] += 1
                continue
            wav_path = os.path.join(wav_dir, stem + ".wav")
            txt_path = os.path.join(txt_dir, stem + ".txt")
            duration = _audio_to_wav(name, data, wav_path)
            with open(txt_path, "w") as f:
                f.write(preprocess_transcript(trans[stem]))
            rows.append((duration, wav_path, txt_path))
        if truncated or it.truncated:
            report["truncated"].append(os.path.basename(source))
    rows.sort(key=lambda r: r[0])
    if split == "train":
        kept = [r for r in rows if min_duration <= r[0] <= max_duration]
        report["duration_pruned"] = len(rows) - len(kept)
        rows = kept
    manifest = os.path.join(target_dir, f"an4_{split}_manifest.csv")
    with open(manifest, "w") as f:
        for _, wav_path, txt_path in rows:
            f.write(
                f"{os.path.abspath(wav_path)},{os.path.abspath(txt_path)}\n"
            )
    report["utterances"] = len(rows)
    report["manifest"] = manifest
    return report


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--target-dir", default="data/librispeech")
    p.add_argument("--source", action="append", default=None,
                   help="local tarball(s); repeatable. Without it the "
                        "openslr URLs are attempted (needs egress)")
    p.add_argument("--split", default="train", choices=["train", "val"])
    p.add_argument("--min-duration", type=float, default=1.0)
    p.add_argument("--max-duration", type=float, default=15.0)
    args = p.parse_args(argv)
    sources = args.source
    if not sources:
        import urllib.request

        sources = []
        os.makedirs(args.target_dir, exist_ok=True)
        for url in LIBRISPEECH_URLS[args.split]:
            dest = os.path.join(args.target_dir, os.path.basename(url))
            if not os.path.exists(dest):
                try:
                    with urllib.request.urlopen(url, timeout=60) as r, open(
                        dest, "wb"
                    ) as f:
                        f.write(r.read())
                except Exception as e:
                    raise SystemExit(
                        f"cannot download {url} ({e}); pass --source "
                        "/path/to/tarball instead"
                    )
            sources.append(dest)
    report = fetch_librispeech(
        args.target_dir, sources, args.split,
        args.min_duration, args.max_duration,
    )
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
