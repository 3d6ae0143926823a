"""AN4 corpus acquisition: download/extract/convert/manifest, pure Python
(counterpart of ``mgwfbp_tpu/data/an4_fetch.py``, whose output tree it
writes byte for byte from the same tarball).

Parity target: reference audio_data/an4.py:19-87 + utils.py:11-37 —
wget the CMU an4_raw.bigendian tarball, sox-convert each .raw to wav,
pair fileids with transcriptions into per-utterance txt files, and write
duration-sorted (train: duration-pruned) "wav_path,txt_path" manifests.

Re-design differences (no external processes, no egress assumptions):
  * .raw -> .wav conversion is pure Python: AN4 raw files are big-endian
    signed 16-bit mono at 16 kHz (the reference shells out to
    `sox -t raw -r 16000 -b 16 -e signed-integer -B -c 1`); numpy byteswap
    + the stdlib wave module produce the identical PCM payload.
  * durations come from the wav header (the reference shells out to soxi).
  * `--source` accepts a LOCAL tarball, and extraction salvages every
    complete entry from a TRUNCATED archive (a machine without network
    access builds the corpus from a copied tarball; a partial tarball
    still yields a usable real-audio subset — the salvage count is
    reported so nothing is silently dropped). Without `--source` the CMU
    URL is downloaded into the target directory first.

Usage:
  python -m mgwfbp_tpu_torch.data.an4_fetch --target-dir data/an4 \
      [--source /path/to/an4_raw.bigendian.tar.gz]
Then train with ``python -m mgwfbp_tpu_torch.train_cli --dnn lstman4
--data-dir data/an4``.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import tarfile
import wave
from typing import Optional

import numpy as np

AN4_URL = "http://www.speech.cs.cmu.edu/databases/an4/an4_raw.bigendian.tar.gz"
SAMPLE_RATE = 16000


def pcm_to_wav(pcm: np.ndarray, wav_path: str) -> float:
    """int16 mono PCM -> 16 kHz RIFF wav; returns duration (s). The one
    wav-writing contract shared by the AN4 and LibriSpeech fetchers."""
    pcm = np.asarray(pcm, "<i2")
    with wave.open(wav_path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(pcm.tobytes())
    return len(pcm) / SAMPLE_RATE


def raw_to_wav(raw_bytes: bytes, wav_path: str) -> float:
    """Big-endian s16 mono 16 kHz raw -> RIFF wav; returns duration (s).

    Byte-identical samples to the reference's sox invocation (an4.py:40-43):
    both merely byte-swap the PCM payload into little-endian s16.
    """
    return pcm_to_wav(
        np.frombuffer(raw_bytes, dtype=">i2").astype("<i2"), wav_path
    )


def process_transcript(line: str) -> str:
    """Reference transcript normalization (an4.py:63-65): strip the
    trailing "(file-id)", the <s>/</s> sentence markers, uppercase."""
    return line.split("(")[0].strip("<s>").split("<")[0].strip().upper()


def salvage_tar(source: str) -> tuple[dict[str, bytes], bool]:
    """Extract name->bytes from a tar.gz, tolerating gzip/tar truncation.

    Returns (files, truncated). A truncated archive (e.g. an interrupted
    download) yields every entry whose payload decompressed completely.
    """
    import zlib

    with open(source, "rb") as f:
        comp = f.read()
    # incremental decompress keeps every complete chunk even when the
    # stream ends mid-payload; d.eof stays False on a cut stream that
    # happens not to raise
    d = zlib.decompressobj(16 + zlib.MAX_WBITS)
    out = []
    truncated = False
    step = 1 << 16
    try:
        for i in range(0, len(comp), step):
            out.append(d.decompress(comp[i : i + step]))
        out.append(d.flush())
    except Exception:
        truncated = True
    truncated = truncated or not d.eof
    data = b"".join(out)
    files: dict[str, bytes] = {}
    try:
        with tarfile.open(fileobj=io.BytesIO(data), mode="r|") as t:
            for m in t:
                if m.isfile():
                    fobj = t.extractfile(m)
                    if fobj is None:
                        continue
                    payload = fobj.read()
                    if len(payload) < m.size:
                        truncated = True
                        break
                    files[m.name] = payload
    except (tarfile.ReadError, EOFError):
        truncated = True
    return files, truncated


def stream_tar_entries(source: str):
    """Yield (name, bytes) per file member of a tar.gz, one at a time —
    constant memory for arbitrarily large archives (LibriSpeech tarballs
    are multi-GB; buffering them whole would OOM a typical host). Stops
    cleanly at a truncated tail: consume the generator and check
    `.truncated` on the returned iterator object."""

    class _Iter:
        truncated = False

        def __iter__(self):
            try:
                with tarfile.open(source, "r|gz") as t:
                    for m in t:
                        if not m.isfile():
                            continue
                        fobj = t.extractfile(m)
                        if fobj is None:
                            continue
                        payload = fobj.read()
                        if len(payload) < m.size:
                            self.truncated = True
                            return
                        yield m.name, payload
            except (tarfile.ReadError, EOFError, OSError):
                self.truncated = True

    return _Iter()


def _download(url: str, dest: str) -> None:
    import shutil
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r, open(dest, "wb") as f:
        shutil.copyfileobj(r, f, length=1 << 20)  # chunked, constant memory


def fetch_an4(
    target_dir: str,
    source: Optional[str] = None,
    min_duration: float = 1.0,
    max_duration: float = 15.0,
) -> dict:
    """Build the AN4 dataset layout + manifests under target_dir.

    Layout (what data/audio.load_an4 consumes, = the reference's):
      target_dir/{train,val}/an4/wav/<utt>.wav
      target_dir/{train,val}/an4/txt/<utt>.txt
      target_dir/an4_{train,val}_manifest.csv   (duration-sorted;
          train pruned to [min_duration, max_duration] like the reference)
    """
    tarball = source
    if tarball is None:
        tarball = os.path.join(target_dir, "an4_raw.bigendian.tar.gz")
        if not os.path.exists(tarball):
            os.makedirs(target_dir, exist_ok=True)
            try:
                _download(AN4_URL, tarball)
            except Exception as e:
                raise SystemExit(
                    f"cannot download {AN4_URL} ({e}); pass --source "
                    "/path/to/an4_raw.bigendian.tar.gz instead"
                )
    files, truncated = salvage_tar(tarball)
    raws = {n: b for n, b in files.items() if n.endswith(".raw")}
    report = {
        "source": tarball,
        "truncated_archive": truncated,
        "entries": len(files),
        "raw_files": len(raws),
        "splits": {},
    }
    split_rows: dict[str, list] = {}
    for tag, split in (("train", "train"), ("test", "val")):
        ids_name = f"an4/etc/an4_{tag}.fileids"
        tr_name = f"an4/etc/an4_{tag}.transcription"
        if ids_name not in files or tr_name not in files:
            raise SystemExit(
                f"{tarball}: missing {ids_name} / {tr_name} "
                "(archive too truncated to index the corpus)"
            )
        file_ids = files[ids_name].decode().splitlines()
        transcripts = files[tr_name].decode().splitlines()
        if len(file_ids) != len(transcripts):
            raise SystemExit(
                f"{ids_name}: {len(file_ids)} ids vs "
                f"{len(transcripts)} transcripts"
            )
        wav_dir = os.path.join(target_dir, split, "an4", "wav")
        txt_dir = os.path.join(target_dir, split, "an4", "txt")
        os.makedirs(wav_dir, exist_ok=True)
        os.makedirs(txt_dir, exist_ok=True)
        rows = []  # (duration, wav_path, txt_path)
        missing = 0
        for fid, line in zip(file_ids, transcripts):
            fid = fid.strip()
            if not fid:
                continue
            raw_name = f"an4/wav/{fid}.raw"
            if raw_name not in raws:
                missing += 1  # lost to truncation
                continue
            utt = os.path.basename(fid)
            wav_path = os.path.join(wav_dir, f"{utt}.wav")
            txt_path = os.path.join(txt_dir, f"{utt}.txt")
            duration = raw_to_wav(raws[raw_name], wav_path)
            with open(txt_path, "w") as f:
                f.write(process_transcript(line))
            rows.append((duration, wav_path, txt_path))
        # duration sort always; duration pruning on train only (reference
        # an4.py:84-86 passes min/max for train, none for val)
        rows.sort(key=lambda r: r[0])
        if split == "train":
            kept = [
                r for r in rows if min_duration <= r[0] <= max_duration
            ]
            pruned = len(rows) - len(kept)
            rows = kept
        else:
            pruned = 0
        split_rows[split] = rows
        report["splits"][split] = {
            "utterances": len(rows),
            "missing_from_archive": missing,
            "duration_pruned": pruned,
        }
    if not split_rows["val"] and len(split_rows["train"]) >= 10:
        # a truncated archive can lose the whole test split (it sits at the
        # tail of the tar); hold out every 7th train utterance so eval still
        # measures held-out real audio rather than silently going synthetic
        train, val = [], []
        for i, r in enumerate(split_rows["train"]):
            (val if i % 7 == 3 else train).append(r)
        split_rows["train"], split_rows["val"] = train, val
        report["val_held_out_from_train"] = len(val)
        for split in ("train", "val"):
            report["splits"][split]["utterances"] = len(split_rows[split])
    for split, rows in split_rows.items():
        manifest = os.path.join(target_dir, f"an4_{split}_manifest.csv")
        with open(manifest, "w") as f:
            for _, wav_path, txt_path in rows:
                f.write(
                    f"{os.path.abspath(wav_path)},"
                    f"{os.path.abspath(txt_path)}\n"
                )
        report["splits"][split]["manifest"] = manifest
    return report


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--target-dir", default="data/an4")
    p.add_argument("--source", default=None,
                   help="local an4_raw.bigendian.tar.gz (skips download; "
                        "truncated archives are salvaged)")
    p.add_argument("--min-duration", type=float, default=1.0)
    p.add_argument("--max-duration", type=float, default=15.0)
    args = p.parse_args(argv)
    report = fetch_an4(
        args.target_dir, args.source, args.min_duration, args.max_duration
    )
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
