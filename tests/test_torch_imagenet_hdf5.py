"""The port's ImageNet HDF5 conversion (``mgwfbp_tpu_torch.data.
imagenet_hdf5.build_hdf5``) against the JAX package's, on a small PIL image
tree (the tree of tests/test_data.py's HDF5 test): the datasets are byte
for byte equal,
the class-map CSV is the same file, and the output reads back through the
port's ``load_imagenet_hdf5``. The CLI (``python -m``) writes the same
bytes."""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

from mgwfbp_tpu.data.imagenet_hdf5 import build_hdf5 as jax_build
from mgwfbp_tpu_torch.data.datasets import load_imagenet_hdf5
from mgwfbp_tpu_torch.data.imagenet_hdf5 import build_hdf5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("train_img", "train_labels", "val_img", "val_labels")


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    from PIL import Image

    raw = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(0)
    for split, per_class in (("train", 3), ("val", 1)):
        for cls in ("n01berry", "n02dog"):
            d = raw / split / cls
            d.mkdir(parents=True)
            for i in range(per_class):
                arr = rng.integers(0, 255, (37, 29, 3), dtype=np.uint8)
                Image.fromarray(arr).save(d / f"img{i}.png")
    return str(raw)


@pytest.fixture(scope="module")
def built(raw_tree, tmp_path_factory):
    port_out = str(tmp_path_factory.mktemp("port"))
    jax_out = str(tmp_path_factory.mktemp("jax"))
    return (build_hdf5(raw_tree, port_out, size=32),
            jax_build(raw_tree, jax_out, size=32))


def _datasets(path: str) -> dict:
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == sorted(KEYS)
        return {k: np.asarray(f[k]) for k in KEYS}


@pytest.mark.parametrize("key", KEYS)
def test_datasets_equal_the_jax_packages_byte_for_byte(built, key):
    port, ref = built
    a, b = _datasets(port["out"])[key], _datasets(ref["out"])[key]
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_report_and_class_map_equal_the_jax_packages(built):
    port, ref = built
    for k in ("num_classes", "train_images", "val_images", "size"):
        assert port[k] == ref[k]
    with open(port["label_map"], "rb") as f, open(ref["label_map"], "rb") as g:
        assert f.read() == g.read()
    assert open(port["label_map"]).read().split() == [
        "n01berry", "0", "n02dog", "1"]


def test_output_reads_back_through_the_ports_loader(built):
    port, _ = built
    out_dir = os.path.dirname(port["out"])
    ds = load_imagenet_hdf5(out_dir, "train")
    assert ds is not None and len(ds) == 6
    assert ds.data.shape == (6, 32, 32, 3) and ds.data.dtype == np.uint8
    assert sorted(set(np.asarray(ds.labels).tolist())) == [0, 1]
    assert ds.num_classes == 2
    val = load_imagenet_hdf5(out_dir, "val")
    assert len(val) == 2


def test_cli_writes_the_same_bytes(raw_tree, built, tmp_path):
    port, _ = built
    out = tmp_path / "cli"
    r = subprocess.run(
        [sys.executable, "-m", "mgwfbp_tpu_torch.data.imagenet_hdf5",
         "--raw-dir", raw_tree, "--out-dir", str(out), "--size", "32"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert '"num_classes": 2' in r.stdout
    got, want = _datasets(str(out / "imagenet.hdf5")), _datasets(port["out"])
    for k in KEYS:
        assert got[k].tobytes() == want[k].tobytes()


def test_a_tree_without_both_splits_is_refused(tmp_path, raw_tree):
    with pytest.raises(SystemExit, match="image folders"):
        build_hdf5(str(tmp_path / "empty"), str(tmp_path / "o"), size=8)
