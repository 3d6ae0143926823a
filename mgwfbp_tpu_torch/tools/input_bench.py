"""Real-data input-path benchmark (the counterpart of the JAX package's
``tools/input_bench.py``): is the host pipeline fast enough to feed the
card?

  1. ``--make-data`` writes the real file formats under ``--data-dir``:
     CIFAR-10 python-pickle batches (``cifar-10-batches-py/data_batch_*``,
     ``test_batch``) and the reference's single-file HDF5 ImageNet
     (``data.datasets.create_hdf5``), with the synthetic twin's content, the
     JAX tool's bytes. Each leg is reported: a leg that cannot run (the
     HDF5 one without ``h5py``) fails with its reason, names the missing
     module, and the other still runs; the command fails only when no leg
     ran.
  2. Then (without ``--make-data``) it times steps driven from the loader
     (``data.data_prepare``, the port's ``TrainStep`` at bfloat16 on the
     card) over (a) the in-memory synthetic set, (b) the real files with
     the production prefetch (``data.loader.PrefetchLoader``) and (c) the
     real files without it (``MGWFBP_DATA_WORKERS=0``), and reports
     samples/s, the real/synthetic throughput ratio and the prefetch's
     ratio. A ratio near 1.0 means the input path keeps up.

    python -m mgwfbp_tpu_torch.tools.input_bench --make-data --data-dir D
    python -m mgwfbp_tpu_torch.tools.input_bench --model resnet20 \\
        --data-dir D --iters 200 [--out input.json]

The model's preset names the dataset and the batch (ResNet-20: CIFAR-10 at
32; ResNet-50: ImageNet at 128, which needs the HDF5 file and ``h5py``).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time


def make_data(data_dir: str, imagenet_n: int = 4096) -> dict:
    """Write the CIFAR-10 pickles and the HDF5 ImageNet; the report names
    each leg's path, or its error."""
    from mgwfbp_tpu_torch.data.datasets import (
        create_hdf5,
        synthetic_images_hard,
    )

    os.makedirs(data_dir, exist_ok=True)
    report: dict = {"legs": {}}
    # CIFAR-10 pickle batches (5 x 10k train + 10k test)
    root = os.path.join(data_dir, "cifar-10-batches-py")
    os.makedirs(root, exist_ok=True)
    train = synthetic_images_hard(50000, (32, 32, 3), 10, seed=0)
    test = synthetic_images_hard(10000, (32, 32, 3), 10, seed=1)
    for i in range(5):
        sel = slice(i * 10000, (i + 1) * 10000)
        with open(os.path.join(root, f"data_batch_{i+1}"), "wb") as f:
            pickle.dump(
                {
                    b"data": train.data[sel]
                    .transpose(0, 3, 1, 2)
                    .reshape(10000, -1),
                    b"labels": train.labels[sel].tolist(),
                },
                f,
            )
    with open(os.path.join(root, "test_batch"), "wb") as f:
        pickle.dump(
            {
                b"data": test.data.transpose(0, 3, 1, 2).reshape(10000, -1),
                b"labels": test.labels.tolist(),
            },
            f,
        )
    report["cifar10"] = root
    report["legs"]["cifar10"] = "ok"
    # single-file HDF5 ImageNet (reference key layout), synthetic content
    path = os.path.join(data_dir, "imagenet.hdf5")
    try:
        import h5py  # noqa: F401 — the leg's one dependency, checked first
    except ModuleNotFoundError as e:
        report["legs"]["imagenet_hdf5"] = (
            f"failed: h5py is not installed ({e}); no {path} written")
    else:
        tr = synthetic_images_hard(imagenet_n, (224, 224, 3), 1000, seed=2)
        va = synthetic_images_hard(max(imagenet_n // 8, 128), (224, 224, 3),
                                   1000, seed=3)
        create_hdf5(tr.data, tr.labels, va.data, va.labels, path)
        report["imagenet_hdf5"] = path
        report["legs"]["imagenet_hdf5"] = "ok"
    report["imagenet_n"] = imagenet_n
    return report


def _time_loader(loader, step, to_batch, iters: int, device) -> float:
    """Seconds per step over ``iters`` steps driven from ``loader`` (new
    epochs as the set runs out); one read back ends the window."""
    from mgwfbp_tpu_torch.profiling import _sync as sync

    loader.set_epoch(0)
    n, m = 0, None
    sync(device)
    t0 = time.perf_counter()
    while n < iters:
        for raw in loader:
            m = step(*to_batch(raw))
            n += 1
            if n >= iters:
                break
        loader.set_epoch(n)  # a new epoch if the set is small
    float(m["loss"])
    return (time.perf_counter() - t0) / n


def run(model_name, data_dir, iters, warmup, device="cuda") -> dict:
    import numpy as np
    import torch

    from mgwfbp_tpu_torch.config import PRESETS
    from mgwfbp_tpu_torch.data import data_prepare
    from mgwfbp_tpu_torch.optim import make_optimizer
    from mgwfbp_tpu_torch.bench import make_model
    from mgwfbp_tpu_torch.train.step import TrainStep
    from mgwfbp_tpu_torch.utils.device import device_kind

    preset = PRESETS.get(model_name, {})
    batch = preset.get("batch_size", 32)
    dataset = preset.get("dataset", "cifar10")

    def to_batch(raw):
        x, y = (raw["x"], raw["y"]) if isinstance(raw, dict) else raw

        def put(a):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a))
            return t.to(device, non_blocking=True)
        # NHWC host images -> NCHW on the card, one micro-step
        return (put(x).movedim(-1, -3).contiguous()[None],
                put(y).to(torch.int64)[None])

    results: dict = {}
    configs = [
        ("synthetic_inmem", dict(synthetic=True), {}),
        ("real_files", dict(synthetic=None), {}),
        ("real_files_no_prefetch", dict(synthetic=None),
         {"MGWFBP_DATA_WORKERS": "0"}),
    ]
    for name, kw, env in configs:
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            try:
                bundle = data_prepare(dataset, data_dir=data_dir,
                                      batch_size=batch, **kw)
            except ModuleNotFoundError as e:
                results[name] = {"error": f"{type(e).__name__}: {e}"}
                continue
            if name != "synthetic_inmem" and bundle.synthetic:
                results[name] = {
                    "error": f"no real {dataset} files under {data_dir}"}
                continue
            model, meta = make_model(model_name, device)
            opt, lr_fn, _ = make_optimizer(
                model.parameters(), 0.1, lr_schedule="const",
                dataset=dataset, num_batches_per_epoch=1)
            step = TrainStep(model, opt, lr_fn, compute_dtype=torch.bfloat16)
            # warm-up (cuDNN's choice, the first batches)
            _time_loader(bundle.train, step, to_batch, warmup, device)
            dt = _time_loader(bundle.train, step, to_batch, iters, device)
            results[name] = {
                "sec_per_iter": round(dt, 6),
                "samples_per_sec": round(batch / dt, 2),
                "prefetch": type(bundle.train).__name__,
            }
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def ratio(a, b):
        if "sec_per_iter" in results.get(a, {}) and (
                "sec_per_iter" in results.get(b, {})):
            return round(results[b]["sec_per_iter"]
                         / results[a]["sec_per_iter"], 4)
        return None

    if (r := ratio("real_files", "synthetic_inmem")) is not None:
        results["real_over_synthetic_throughput"] = r
    if (r := ratio("real_files", "real_files_no_prefetch")) is not None:
        results["prefetch_over_no_prefetch_throughput"] = r
    return {
        "model": model_name,
        "dataset": dataset,
        "batch": batch,
        "iters": iters,
        "device_kind": device_kind(torch.device(device)),
        "data_dir": data_dir,
        "results": results,
    }


def main(argv=None) -> int:
    from mgwfbp_tpu_torch.tools.overlap_report import write_report

    ap = argparse.ArgumentParser(
        prog="python -m mgwfbp_tpu_torch.tools.input_bench",
        description="the real-data input path against the in-memory twin")
    ap.add_argument("--model", default="resnet20")
    ap.add_argument("--data-dir", dest="data_dir", required=True)
    ap.add_argument("--make-data", action="store_true")
    ap.add_argument("--imagenet-n", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    if args.make_data:
        report = make_data(args.data_dir, args.imagenet_n)
        print(json.dumps(report), flush=True)
        failed = {k: v for k, v in report["legs"].items() if v != "ok"}
        for leg, why in failed.items():
            print(f"input_bench: leg {leg} {why}", file=sys.stderr, flush=True)
        return 0 if len(failed) < len(report["legs"]) else 1
    from mgwfbp_tpu_torch.utils.device import (
        resolve_device,
        set_matmul_precision,
    )

    device = resolve_device(args.device)
    set_matmul_precision("bfloat16")
    write_report(run(args.model, args.data_dir, args.iters, args.warmup,
                     device), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
