"""Raw ImageNet folder tree -> single-file HDF5 file (CLI; counterpart
of ``mgwfbp_tpu/data/imagenet_hdf5.py``).

Walks ``<raw-dir>/{train,val}/<class>/*`` image folders, maps class names to
indices in sorted class-directory order, resizes every image to S x S x 3
RGB uint8 (PIL's bicubic), and writes one HDF5 file with the datasets
``train_img``, ``train_labels``, ``val_img`` and ``val_labels`` (the layout
``datasets.load_imagenet_hdf5`` reads), with ``imagenet_label_mapping.csv``
(one ``<class> <index>`` row per class) beside it. Images stream into
chunked datasets one at a time, so nothing holds the corpus in memory. The
bytes equal those of the JAX package's ``build_hdf5`` on the same tree.

Usage:
  python -m mgwfbp_tpu_torch.data.imagenet_hdf5 --raw-dir /data/imagenet \\
      --out-dir /data --size 224
  python -m mgwfbp_tpu_torch.train_cli --dnn resnet50 --data-dir /data
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Optional

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def list_images(raw_dir: str, folder: str) -> list[tuple[str, str]]:
    """(path, class_name) pairs under raw_dir/folder/<class>/*, sorted."""
    root = os.path.join(raw_dir, folder)
    out: list[tuple[str, str]] = []
    if not os.path.isdir(root):
        return out
    for cls in sorted(os.listdir(root)):
        cdir = os.path.join(root, cls)
        if not os.path.isdir(cdir):
            continue
        for fn in sorted(os.listdir(cdir)):
            if fn.lower().endswith(IMAGE_EXTS):
                out.append((os.path.join(cdir, fn), cls))
    return out


def load_resized(path: str, size: int) -> np.ndarray:
    """One image -> (size, size, 3) RGB uint8, bicubic."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((size, size), Image.BICUBIC)
        return np.asarray(im, dtype=np.uint8)


def build_hdf5(
    raw_dir: str,
    out_dir: str,
    output: str = "imagenet.hdf5",
    size: int = 224,
) -> dict:
    """Build ``<out_dir>/<output>`` and the class map; returns a report
    (paths, class and image counts, size)."""
    import h5py

    train = list_images(raw_dir, "train")
    val = list_images(raw_dir, "val")
    if not train or not val:
        raise SystemExit(
            f"{raw_dir!r}: expected train/<class>/*.jpg and val/<class>/* "
            "image folders"
        )
    classes = sorted({c for _, c in train} | {c for _, c in val})
    class_map = {c: i for i, c in enumerate(classes)}
    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "imagenet_label_mapping.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f, delimiter=" ")
        for c in classes:
            w.writerow([c, class_map[c]])
    h5path = os.path.join(out_dir, output)
    with h5py.File(h5path, "w") as hf:
        for key, files in (("train", train), ("val", val)):
            img_ds = hf.create_dataset(
                f"{key}_img",
                shape=(len(files), size, size, 3),
                dtype="uint8",
                chunks=(1, size, size, 3),
            )
            labels = np.empty((len(files),), np.int64)
            for i, (path, cls) in enumerate(files):
                img_ds[i] = load_resized(path, size)
                labels[i] = class_map[cls]
            hf.create_dataset(f"{key}_labels", data=labels)
    return {
        "out": h5path,
        "label_map": csv_path,
        "num_classes": len(classes),
        "train_images": len(train),
        "val_images": len(val),
        "size": size,
    }


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--raw-dir", required=True,
                   help="root with train/<class>/* and val/<class>/*")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--output", default="imagenet.hdf5")
    p.add_argument("--size", type=int, default=224)
    args = p.parse_args(argv)
    print(json.dumps(build_hdf5(
        args.raw_dir, args.out_dir, args.output, args.size
    ), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
