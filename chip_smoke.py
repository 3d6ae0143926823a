"""Chip smoke for the PyTorch/CUDA port (mgwfbp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Phases, each of which fails the run (non-zero exit, no result line):

  1. build every CUDA kernel of the port from csrc/ (one nvcc per source,
     all started together) and print the build time;
  2. hold each kernel against its plain PyTorch version on the card, at the
     serving shape (through strided views of a fused qkv tensor, as the
     transformer hands them over), at the long-context shapes, at the
     largest D, and on views that take the kernel's misaligned load path,
     with TF32 off; time the kernel (back-to-back calls by CUDA events;
     device time per launch by torch.profiler; the wrapper's host time per
     call on the host clock), the plain version and one PyTorch library
     call computing the same function (a yardstick only; the port never
     calls it);
  3. drive the serving path a user would run: the registered full-width
     transformer (vocab 10000, d_model 256, 4 heads, 4 layers) behind
     ServePlane + TelemetryServer, hot-reloading a checkpoint committed by
     save_replicated_step; POST /predict three requests of 1, 2 and 3
     examples, check each answer (200, served step, shape, finite, equal to
     a dense forward of the same weights), check that the flash kernel was
     launched num_layers times per flush; POST one request with token ids
     outside the vocabulary (answered 200, NaN rows where the ids fall
     outside [-V, V), as the JAX package answers) and check that the next
     answer still equals the dense forward; then commit step 2 and check
     that the next answer reports it and differs.

Output, last lines: a JSON line each for the phase-2 shape table, the
serving forward's breakdown (host time of one flush's run_padded, device
time by kernel from torch.profiler) and the /predict latencies, the card's name and power limit (nvidia-smi), the kernels line
({"kernels": [...]}) and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# tolerances of tests/test_flashattn.py: float32 2e-5; bfloat16 2e-2, compared
# in bfloat16 (the output type) after both versions round to it
F32_TOL = 2e-5
BF16_TOL = 2e-2
# served logits (flash kernel) vs a dense forward of the same weights: the
# two attention orders differ by float32 rounding, which four residual
# layers and a 10000-way head carry into logits of magnitude ~1-10
LOGITS_TOL = 1e-4

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): device memory rate and
# the arithmetic rate for the type the work is done on. The kernel computes
# float32 attention on the tensor cores as 3xTF32 (three TF32 products per
# float32 product, to keep float32 accuracy), so its float32 peak is a third
# of the 495 TFLOP/s TF32 rate; the 67 TFLOP/s of float32 outside the tensor
# cores is no longer the least time the card could take.
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}

F32, BF16 = torch.float32, torch.bfloat16
KERNEL_SHAPES = [
    # (B, T, H, D), causal, dtype, layout: "qkv" = strided views of one
    # fused (B, T, 3 H D) tensor, as the transformer passes them; "shifted"
    # = views one element off 16-byte alignment (the misaligned load path)
    ((8, 35, 4, 64), True, F32, "qkv"),  # the serving shape
    ((8, 35, 4, 64), True, BF16, "qkv"),
    ((1, 128, 4, 64), True, F32, "contiguous"),
    ((1, 128, 4, 64), False, F32, "contiguous"),
    ((1, 1024, 4, 64), True, F32, "contiguous"),
    ((1, 1024, 4, 64), False, F32, "contiguous"),
    ((1, 4096, 4, 64), True, F32, "contiguous"),  # the model's max_len
    ((1, 4096, 4, 64), False, F32, "contiguous"),
    ((2, 256, 4, 256), True, F32, "contiguous"),  # the contract's largest D
    ((2, 65, 4, 64), True, F32, "contiguous"),  # one row past a tile
    ((2, 100, 3, 33), True, F32, "contiguous"),  # odd D: misaligned path
    ((8, 35, 4, 64), True, F32, "shifted"),
    ((1, 1024, 4, 64), True, BF16, "contiguous"),
    ((1, 4096, 4, 64), True, BF16, "contiguous"),
    ((2, 256, 4, 256), True, BF16, "contiguous"),
    ((8, 35, 4, 64), True, BF16, "shifted"),
]
SERVE_SHAPE = KERNEL_SHAPES[0]
REQUEST_SIZES = (1, 2, 3)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def time_ms(fn, target_s: float = 0.25, max_iters: int = 200) -> float:
    """Mean device time of fn() in ms, by CUDA events over a run of calls
    sized to about target_s, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = max(time.perf_counter() - t0, 1e-6)
    iters = int(min(max_iters, max(3, target_s / once)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(shape, causal: bool, dtype) -> tuple[float, str]:
    """Least time (ms) the card could take for one attention forward:
    q, k, v read once and o written once over the memory rate, against
    the two products' multiply-adds (4 D flops per visible (query, key)
    pair) over the peak rate for the inputs' type (PEAK_FLOPS)."""
    b, t, h, d = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * b * t * h * d * itemsize
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4 * d * pairs * b * h
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def phase_build() -> None:
    from mgwfbp_tpu_torch.ops import _build

    t0 = time.perf_counter()
    try:
        results = _build.build()
    except RuntimeError as e:
        fail(str(e))
    total = time.perf_counter() - t0
    for r in results.values():
        regs = [ln.strip() for ln in r.log.splitlines() if "registers" in ln]
        print(f"built {r.name} in {r.seconds:.2f}s -> {r.path}")
        for ln in regs:
            print(f"  ptxas: {ln}")
    print(f"build phase: {total:.2f}s for {len(results)} kernel(s)", flush=True)


def make_inputs(shape, dtype, layout: str, gen: torch.Generator):
    """q, k, v on the card, from the generator, in the given layout."""
    b, t, h, d = shape
    if layout == "qkv":
        qkv = torch.randn((b, t, 3 * h * d), generator=gen).to("cuda", dtype)
        return [x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=-1)]
    if layout == "shifted":
        n = b * t * h * d
        return [
            torch.randn(n + 1, generator=gen).to("cuda", dtype)[1:].view(shape)
            for _ in range(3)
        ]
    return [torch.randn(shape, generator=gen).to("cuda", dtype) for _ in range(3)]


def host_us(fn, calls: int = 100) -> float:
    """The host's time per call of fn, in µs: the enqueue alone, on the
    host clock, with no synchronisation inside the run of calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def device_us(fn, name: str, calls: int = 20):
    """Device time per call of the kernels whose name contains `name` (all
    of the call's kernels for ""), in µs, from torch.profiler over `calls`
    calls; a string saying why where the profiler records no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key
    )
    if total <= 0:
        return "not measured (the profiler recorded no device time)"
    return total / calls


def phase_kernels(gen: torch.Generator) -> list[dict]:
    import torch.nn.functional as F

    from mgwfbp_tpu_torch.ops import flashattn as fa
    from mgwfbp_tpu_torch.parallel.ringattn import local_attention

    rows = []
    for shape, causal, dtype, layout in KERNEL_SHAPES:
        q, k, v = make_inputs(shape, dtype, layout, gen)
        aligned = fa.aligned_path(q, k, v)
        if aligned != (layout != "shifted" and shape[3] % 4 == 0):
            fail(f"{layout} views at {shape} {dtype} chose aligned={aligned}")
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_reference(q, k, v, causal=causal)
        dense = local_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            fail(f"flash kernel produced non-finite values at {shape}")
        err = (got.float() - want.float()).abs().max().item()
        dense_err = (got.float() - dense.float()).abs().max().item()
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        if err > tol or dense_err > tol:
            fail(
                f"flash kernel disagrees at {shape} causal={causal} {dtype} "
                f"{layout}: max |kernel - plain| {err:.3e}, |kernel - dense| "
                f"{dense_err:.3e} > {tol}"
            )
        # the library's kernels fault on views off 16-byte alignment: the
        # yardstick takes aligned copies of them
        qt, kt, vt = (
            (x if aligned else x.clone()).transpose(1, 2) for x in (q, k, v)
        )

        def kernel():
            return fa.flash_attention(q, k, v, causal=causal)

        kernel_ms = time_ms(kernel)
        dev_us = device_us(kernel, "flash_")
        wrapper_us = host_us(kernel)
        plain_ms = time_ms(
            lambda: fa.flash_attention_reference(q, k, v, causal=causal),
            max_iters=20,
        )

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        library_ms = time_ms(library)
        library_dev_us = device_us(library, "")
        bound_ms, bound_by = attention_bound(shape, causal, dtype)
        rows.append({
            "shape": list(shape), "causal": causal,
            "dtype": str(dtype).replace("torch.", ""), "layout": layout,
            "path": "aligned" if aligned else "misaligned",
            "max_abs_err": err, "max_abs_err_vs_dense": dense_err,
            "ms": kernel_ms, "device_us": dev_us, "host_us": wrapper_us,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_us": library_dev_us,
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        dev, lib = (
            f"{x:.2f}" if isinstance(x, float) else x
            for x in (dev_us, library_dev_us)
        )
        print(
            f"flash {shape} causal={causal} {dtype} {layout} "
            f"({rows[-1]['path']} path): err {err:.2e} (dense "
            f"{dense_err:.2e}) kernel {kernel_ms:.4f} ms, device {dev} us "
            f"per launch, wrapper host {wrapper_us:.2f} us per call, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (device {lib} us), bound "
            f"{bound_ms:.5f} ms ({bound_by})", flush=True,
        )
    return rows


def _post(port: int, inputs: list) -> tuple[int, dict, float]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict",
        data=json.dumps({"inputs": inputs}).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            code, body = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return code, json.loads(body.decode()), time.perf_counter() - t0


def phase_serve(gen: torch.Generator) -> tuple[int, list[dict]]:
    from mgwfbp_tpu_torch import models
    from mgwfbp_tpu_torch.checkpoint import save_replicated_step
    from mgwfbp_tpu_torch.convert import params_from_flax, params_to_flax
    from mgwfbp_tpu_torch.models.transformer import TransformerLM, init_weights
    from mgwfbp_tpu_torch.ops import flash_attention
    from mgwfbp_tpu_torch.serving.model import ServingModel
    from mgwfbp_tpu_torch.serving.plane import ServePlane
    from mgwfbp_tpu_torch.telemetry.serve import MetricsAggregator, TelemetryServer

    module, meta = models.create_model("transformer")
    if module.attn_impl != "flash":
        fail("the registered transformer does not serve through flash attention")
    print(
        f"serving {meta.name}: vocab {module.vocab_size}, d_model "
        f"{module.d_model}, heads {module.num_heads}, layers "
        f"{module.num_layers}, d_ff {module.d_ff}, max_len {module.max_len}, "
        f"input {meta.input_shape}", flush=True,
    )
    params1 = params_to_flax(init_weights(module, gen))
    rng = np.random.RandomState(0)
    examples = rng.randint(
        0, meta.num_classes, (sum(REQUEST_SIZES),) + tuple(meta.input_shape)
    ).astype(np.int32)

    def dense_logits(params) -> np.ndarray:
        ref = TransformerLM(vocab_size=meta.num_classes, attn_impl="dense")
        ref.load_state_dict(params_from_flax(params))
        ref.to("cuda").eval()
        with torch.inference_mode():
            return ref(torch.from_numpy(examples).cuda()).float().cpu().numpy()

    want1 = dense_logits(params1)
    latencies = []
    with tempfile.TemporaryDirectory(prefix="mgwfbp_chip_smoke_") as ckpt:
        save_replicated_step(ckpt, 1, params1)
        model = ServingModel(module, meta, device="cuda")
        agg = MetricsAggregator(run={"role": "serve", "dnn": meta.name})
        server = TelemetryServer(agg, 0)
        plane = ServePlane(model, ckpt, emit=agg.observe, server=server)
        try:
            plane.start()
            if plane.poll_now() != 1 and model.served_step() != 1:
                fail("step 1 was not installed")
            batches0 = plane.service.stats()["batches"]
            flash_attention.launches = 0  # the main path's run starts here
            off = 0
            for n in REQUEST_SIZES:
                x = examples[off:off + n]
                code, doc, dt = _post(server.port, x.tolist())
                if code != 200:
                    fail(f"/predict of {n} example(s) answered {code}: {doc}")
                out = np.asarray(doc["outputs"], np.float32)
                if doc.get("served_step") != 1:
                    fail(f"served_step {doc.get('served_step')} != 1")
                if out.shape != (n,) + tuple(meta.input_shape) + (meta.num_classes,):
                    fail(f"/predict output shape {out.shape}")
                if not np.isfinite(out).all():
                    fail("/predict returned non-finite logits")
                err = float(np.abs(out - want1[off:off + n]).max())
                if err > LOGITS_TOL:
                    fail(f"served logits differ from the dense forward by {err:.3e}")
                latencies.append({
                    "examples": n, "ms": dt * 1e3, "served_step": 1,
                    "max_abs_err_vs_dense": err,
                })
                off += n
            launches = flash_attention.launches  # ... and ends here
            flushes = plane.service.stats()["batches"] - batches0
            if launches == 0 or launches != module.num_layers * flushes:
                fail(
                    f"flash kernel launched {launches} times over {flushes} "
                    f"flushes; expected {module.num_layers} per flush"
                )
            print(
                f"/predict: {len(REQUEST_SIZES)} requests, {flushes} flushes, "
                f"{launches} flash launches", flush=True,
            )
            check_out_of_vocabulary(server.port, meta, examples[:1], want1[:1])
            forward_breakdown(model, examples[:1])

            params2 = params_to_flax(init_weights(module, gen))
            save_replicated_step(ckpt, 2, params2)
            if plane.poll_now() != 2 and model.served_step() != 2:
                fail("hot reload did not install step 2")
            code, doc, dt = _post(server.port, examples[:1].tolist())
            if code != 200 or doc.get("served_step") != 2:
                fail(f"after reload /predict answered {code}, step "
                     f"{doc.get('served_step')}")
            out2 = np.asarray(doc["outputs"], np.float32)
            if not np.isfinite(out2).all() or np.array_equal(out2, want1[:1]):
                fail("step 2's answer is non-finite or equals step 1's")
            err2 = float(np.abs(out2 - dense_logits(params2)[:1]).max())
            if err2 > LOGITS_TOL:
                fail(f"step 2's logits differ from its dense forward by {err2:.3e}")
            latencies.append({
                "examples": 1, "ms": dt * 1e3, "served_step": 2,
                "max_abs_err_vs_dense": err2,
            })
            status = agg.status()["serving"]
            if not status or status["step"] != 2:
                fail(f"/status serving section {status}")
        finally:
            plane.close()
            server.close()
    return launches, latencies


def check_out_of_vocabulary(port: int, meta, clean: np.ndarray,
                            want: np.ndarray) -> None:
    """Token ids outside the vocabulary are answered as the JAX package
    answers them (its embedding is jnp.take in mode "fill"): 200, with ids
    in [-V, -1] wrapped to id + V and NaN wherever an id outside [-V, V)
    reaches through attention. The card must take no fault from them: the
    next in-vocabulary answer still equals the dense forward."""
    v = meta.num_classes
    x = np.concatenate([clean, clean])
    x[0, 5] = v
    x[1, 3] = -1
    code, doc, _ = _post(port, x.tolist())
    if code != 200:
        fail(f"out-of-vocabulary /predict answered {code}: {doc}")
    out = np.asarray(doc["outputs"], np.float32)
    if out.shape != x.shape + (v,):
        fail(f"out-of-vocabulary /predict output shape {out.shape}")
    # position 5 onwards sees the NaN row of id V; id -1 is id V - 1
    if not np.isnan(out[0, 5:]).all() or not np.isfinite(out[1]).all():
        fail("out-of-vocabulary answer: NaN rows not where jnp.take puts them")
    wrapped = clean.copy()
    wrapped[0, 3] = v - 1
    code, doc, _ = _post(port, wrapped.tolist())
    if code != 200 or not np.abs(
        np.asarray(doc["outputs"], np.float32) - out[1:]
    ).max() <= LOGITS_TOL:
        fail("id -1 was not answered as id V - 1")
    code, doc, _ = _post(port, clean.tolist())
    err = float(np.abs(np.asarray(doc["outputs"], np.float32) - want).max())
    if code != 200 or not err <= LOGITS_TOL:
        fail(f"after out-of-vocabulary ids /predict answered {code}, "
             f"{err:.3e} from the dense forward")
    print(f"/predict: out-of-vocabulary ids answered 200; the next answer is "
          f"{err:.2e} from the dense forward", flush=True)


def forward_breakdown(model, x: np.ndarray, reps: int = 10) -> None:
    """Where a /predict flush's time goes, apart from HTTP and JSON: the
    host clock around ServingModel.run_padded (tokens to the card, the
    forward of the full slot, logits back), then torch.profiler over a few
    such calls for the device time by kernel. The profiler is a reading,
    not a check: where it records no device time this says so."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        model.run_padded(x)  # synchronous: ends in a device-to-host copy
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"run_padded_ms": sorted(times)[reps // 2], "slot": model.max_batch}
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                model.run_padded(x)
        # device-side events only: a host op's device time repeats its
        # kernels' own
        per = [
            (e.key, e.self_device_time_total / 3e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
        ]
        per = sorted((p for p in per if p[1] > 0), key=lambda p: -p[1])
        out["device_ms_per_call"] = (
            sum(ms for _, ms in per) if per
            else "not measured (the profiler recorded no device time)"
        )
        out["top_kernels_ms"] = [[k[:80], ms] for k, ms in per[:8]]
    except Exception as e:  # noqa: BLE001 — a reading, not a check
        out["device_ms_per_call"] = f"not measured ({type(e).__name__}: {e})"
    print(json.dumps({"forward": out}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import mgwfbp_tpu_torch  # noqa: F401 — fails outside a checkout

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = (smi.stdout.strip().splitlines() or ["nvidia-smi unavailable"])[0]
    print(
        f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
        flush=True,
    )
    gen = torch.Generator().manual_seed(0)
    phase_build()
    rows = phase_kernels(gen)
    launches, latencies = phase_serve(gen)

    serve = rows[0]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "mgwfbp_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "mgwfbp_tpu/ops/flashattn.py:107",
        "launches": launches,
        "max_abs_err": serve["max_abs_err"],
        "ms": serve["ms"],
        "kernel_ms": serve["ms"],
        "device_us": serve["device_us"],
        "host_us": serve["host_us"],
        "plain_ms": serve["plain_ms"],
        "bound_ms": serve["bound_ms"],
        "bound_by": serve["bound_by"],
        "library_ms": serve["library_ms"],
    }]
    print(json.dumps({"flash_attention_shapes": rows}))
    print(json.dumps({"predict_latencies": latencies}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
