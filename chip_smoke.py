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
     that the next answer reports it and differs;
  4. drive the training path a user would run, full-width ResNet-20 at
     the per-worker batch 32 on synthetic CIFAR-10:
     (a) the Trainer at one worker, policy auto, TRAIN_STEPS steps, one
         evaluate and the epoch's commit: the loss of the last 5 steps
         falls below the first 5's, eval is finite, the committed step
         reads back equal to the live parameters; then the step time (CUDA
         events, median of 20) and torch.profiler's busy share;
     (b) the merged all-reduce at one worker over NCCL, policy mgwfbp on a
         tb the hooks measure on the card, on the ici prior (one leaf per
         group) and on MERGING_LINK (which must merge leaves): each of
         REDUCER_STEPS steps launches num_groups all-reduces in group
         order and its reduced gradients equal, bit for bit, a copy taken
         before the reduction; the hooks' arrival order is printed beside
         the reducer's permutation;
     (c) two processes on the one card over gloo, GLOO_STEPS steps of
         mgwfbp on each of GLOO_LINKS: merged gradients equal the
         leaf-by-leaf all_reduce and both ranks' parameters are identical,
         bit for bit, every step.

Output, last lines: a JSON line each for the phase-2 shape table, the
serving forward's breakdown (host time of one flush's run_padded, device
time by kernel from torch.profiler), the /predict latencies and the
training phase ({"train": ...}), the card's name and power limit
(nvidia-smi), the kernels line ({"kernels": [...]}) and, last,
{"ok": true, "device": {...}}.
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


TRAIN_DEVICE = "cuda"  # the training phases' device
TRAIN_STEPS = 40  # phase (a): optimizer steps of the trainer
REDUCER_STEPS = 10  # phase (b)
GLOO_STEPS = 5  # phase (c), on each of GLOO_LINKS
# the reference's 56Gb IB constants at 16 workers: against a backward of
# about 10 ms mgwfbp merges ResNet-20's 65 leaves into a few tens of groups
# of several leaves (the ici prior at 1 or 2 workers leaves them alone)
MERGING_LINK = ("56GbIB", 16)
GLOO_LINKS = (("ici", None), MERGING_LINK)  # None: the world's size


def _step_profile(fn, steps: int = 5) -> dict:
    """torch.profiler over `steps` calls of fn: the card's busy share (sum
    of kernel time over the host's wall time), the kernels and the host
    operators that take most time, per call. A reading, not a check:
    where the profiler records no device time this says so."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    dev = [(e.key, e.self_device_time_total) for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [(e.key, e.self_cpu_time_total, e.count) for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    busy_us = sum(t for _, t in dev)
    out = {
        "busy_share": (
            busy_us / wall_us if busy_us > 0
            else "not measured (the profiler recorded no device time)"
        ),
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_ms_per_step": busy_us / steps / 1e3,
        "top_kernels_ms_per_step": [
            [k[:60], t / steps / 1e3]
            for k, t in sorted(dev, key=lambda r: -r[1])[:6]
        ],
        "top_host_ops_ms_per_step": [
            [k[:60], t / steps / 1e3, n // steps]
            for k, t, n in sorted(host, key=lambda r: -r[1])[:10]
        ],
    }
    return out


def train_phase_trainer(ckpt_root: str) -> dict:
    """(a) The trainer a user runs, at one worker: full-width ResNet-20,
    batch 32, synthetic CIFAR-10, policy auto, TRAIN_STEPS steps, one
    evaluate and the epoch's commit; then the step time and the card's
    busy share on one batch."""
    from mgwfbp_tpu_torch.checkpoint import read_step
    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.convert import flatten_flax, variables_to_flax
    from mgwfbp_tpu_torch.train import Trainer

    cfg = make_config("resnet20", batch_size=32, policy="auto",
                      num_batches_per_epoch=TRAIN_STEPS, logdir=ckpt_root,
                      checkpoint_dir=ckpt_root)
    t0 = time.perf_counter()
    tr = Trainer(cfg, device=TRAIN_DEVICE, synthetic_data=True)
    metrics = tr.fit(1)
    fit_s = time.perf_counter() - t0
    losses = tr.losses
    if len(losses) != TRAIN_STEPS:
        fail(f"the trainer took {len(losses)} steps, not {TRAIN_STEPS}")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not np.isfinite(losses).all() or not last5 < first5:
        fail(f"training loss did not fall: first 5 {first5:.4f}, last 5 "
             f"{last5:.4f} ({losses})")
    ev = metrics["eval"]
    if not np.isfinite([ev["loss"], ev["top1"], ev["top5"]]).all():
        fail(f"evaluate returned non-finite metrics {ev}")
    params, bstats, meta = read_step(tr.ckpt_dir, tr.iteration)
    live_p, live_b = variables_to_flax(tr.model)
    for live, saved in ((live_p, params), (live_b, bstats)):
        live = flatten_flax(live)
        if list(live) != list(saved) or not all(
            np.array_equal(live[k], saved[k]) for k in live
        ):
            fail("the committed step does not read back equal to the live "
                 "parameters")
    # step time: one fixed batch, CUDA events around each step, median of
    # 20 after 5 of warm-up (each step ends in the metrics' host read)
    xb, yb = tr.bundle.train.load_batch(0, 0)
    x, y = tr._to_device(xb[None], yb[None])
    times = []
    for i in range(25):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tr.train_step(x, y)
        end.record()
        torch.cuda.synchronize()
        if i >= 5:
            times.append(start.elapsed_time(end))
    step_ms = float(np.median(times))
    prof = _step_profile(lambda: tr.train_step(x, y))
    busy = prof["busy_share"]
    tr.close()
    out = {
        "steps": TRAIN_STEPS, "batch": 32, "fit_s": fit_s,
        "loss_first5": first5, "loss_last5": last5, "eval": ev,
        "committed_step": int(meta["iteration"]), "step_ms": step_ms,
        "step_ms_min": float(np.min(times)), "images_per_s": 32e3 / step_ms,
        "busy_share": busy, "profile": prof,
    }
    print(f"train (a): {TRAIN_STEPS} steps in {fit_s:.1f}s, loss "
          f"{first5:.4f} -> {last5:.4f}, eval {ev}, step {step_ms:.3f} ms "
          f"({out['images_per_s']:.0f} images/s), busy share {busy}",
          flush=True)
    return out


def _grad_copies(params):
    """Hooks that copy each parameter's gradient as it lands, before any
    reduction writes .grad."""
    copies: dict[int, torch.Tensor] = {}
    hooks = [
        p.register_post_accumulate_grad_hook(
            lambda t, j=j: copies.__setitem__(j, t.grad.detach().clone())
        )
        for j, p in enumerate(params)
    ]
    return copies, hooks


def _held_groups(groups, arrivals) -> int:
    """Groups that were complete before a lower group had launched, so that
    the strict group order held their launch back."""
    pos = {k: i for i, k in enumerate(arrivals)}
    held, launched_at = 0, -1
    for members in groups:
        complete_at = max(pos[k] for k in members)
        launched_at = max(launched_at, complete_at)
        held += launched_at > complete_at
    return held


def _reducer_run(dev, bundle, tb, connection: str, nworkers: int) -> dict:
    """REDUCER_STEPS steps of a fresh model through the merged all-reduce,
    policy mgwfbp on ``tb`` and the named link's alpha-beta constants."""
    from mgwfbp_tpu_torch.convert import flax_leaves
    from mgwfbp_tpu_torch.models import create_model
    from mgwfbp_tpu_torch.models.common import init_weights
    from mgwfbp_tpu_torch.optim import make_optimizer
    from mgwfbp_tpu_torch.parallel.allreduce import make_merged_allreduce
    from mgwfbp_tpu_torch.parallel.costmodel import lookup_alpha_beta
    from mgwfbp_tpu_torch.train import TrainStep

    model, _ = create_model("resnet20")
    init_weights(model, torch.Generator().manual_seed(1)).to(dev)
    params = [t for _, t in flax_leaves(model)]
    reducer = make_merged_allreduce(
        model, policy="mgwfbp", tb=tb,
        cost_model=lookup_alpha_beta(connection, nworkers),
    )
    opt, lr_fn, _ = make_optimizer(model.parameters(), 0.1,
                                   num_batches_per_epoch=REDUCER_STEPS)
    step = TrainStep(model, opt, lr_fn, reducer=reducer)
    copies, hooks = _grad_copies(params)
    checks = {"bitwise": True}
    sync = reducer.synchronize

    def checked_sync():
        out = sync()
        for j, p in enumerate(params):
            if not torch.equal(p.grad, copies[j]):
                checks["bitwise"] = False
        return out

    reducer.synchronize = checked_sync
    launches = []
    for k in range(REDUCER_STEPS):
        xb, yb = bundle.train.load_batch(0, k)
        x = torch.from_numpy(xb).to(dev).movedim(-1, -3).contiguous()
        y = torch.from_numpy(yb.astype(np.int64)).to(dev)
        before = reducer.launches
        m = step(x[None], y[None])
        launches.append(reducer.launches - before)
        if not np.isfinite(m["loss"]):
            fail(f"reducer phase ({connection}): non-finite loss at step {k}")
    for h in hooks:
        h.remove()
    reducer.detach()
    g = reducer.num_groups
    label = f"reducer phase ({connection} at {nworkers} workers)"
    if launches != [g] * REDUCER_STEPS:
        fail(f"{label}: all-reduce launches per step {launches}, expected "
             f"{g} (num_groups) each")
    if reducer.launch_log != list(range(g)):
        fail(f"{label}: groups launched in the order {reducer.launch_log}")
    if not checks["bitwise"]:
        fail(f"{label}: reduced gradients differ from the copies taken "
             "before the reduction")
    groups = [list(gr) for gr in reducer.schedule.groups]
    return {
        "cost_model": f"{connection} at {nworkers} workers",
        "num_groups": g, "groups": groups,
        "largest_group": max(len(gr) for gr in groups),
        "held_by_group_order": _held_groups(groups, reducer.arrivals),
        "predicted_nonoverlap_s": reducer.schedule.predicted_nonoverlap_time,
        "allreduce_launches_per_step": launches,
        "bitwise_equal_to_pre_reduction_copy": True,
        "arrivals": list(reducer.arrivals),
    }


def train_phase_reducer() -> dict:
    """(b) The merged all-reduce at one worker over NCCL: policy mgwfbp on
    a tb the hooks measure on the card, REDUCER_STEPS steps on each of two
    cost models: the ``ici`` prior at one worker (every leaf its own group)
    and the reference's comm-bound MERGING_LINK (groups of many leaves).
    Each step launches num_groups all-reduces, in group order, and its
    reduced gradients equal, bit for bit, the same backward's gradients
    copied before the reduction (the mean over one rank is the identity)."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch.convert import flax_leaves, keystr
    from mgwfbp_tpu_torch.data import data_prepare
    from mgwfbp_tpu_torch.models import create_model
    from mgwfbp_tpu_torch.models.common import init_weights
    from mgwfbp_tpu_torch.parallel.allreduce import arrival_order
    from mgwfbp_tpu_torch.parallel.mesh import init_distributed
    from mgwfbp_tpu_torch.profiling import benchmark_backward
    from mgwfbp_tpu_torch.train import cross_entropy

    dev = torch.device(TRAIN_DEVICE, 0) if TRAIN_DEVICE == "cuda" else (
        torch.device(TRAIN_DEVICE)
    )
    rdv = tempfile.TemporaryDirectory(prefix="mgwfbp_nccl_")
    init_distributed(dev, num_processes=1, process_id=0,
                     init_method=f"file://{os.path.join(rdv.name, 'rdv')}")
    try:
        model, _ = create_model("resnet20")
        init_weights(model, torch.Generator().manual_seed(1)).to(dev)
        bundle = data_prepare("cifar10", batch_size=32, seed=1, synthetic=True)
        leaves = flax_leaves(model)
        names = [keystr(p) for p, _ in leaves]
        perm = arrival_order(len(names), names=names)
        xb, yb = bundle.train.load_batch(0, 0)
        x = torch.from_numpy(xb).to(dev).movedim(-1, -3).contiguous()
        y = torch.from_numpy(yb.astype(np.int64)).to(dev)
        model.train()
        tb = benchmark_backward(
            model, lambda: cross_entropy(model(x), y), [t for _, t in leaves],
            perm,
        )
        runs = [_reducer_run(dev, bundle, tb, "ici", 1),
                _reducer_run(dev, bundle, tb, *MERGING_LINK)]
    finally:
        dist.destroy_process_group()
        rdv.cleanup()
    if runs[1]["num_groups"] >= len(names):
        fail(f"reducer phase: {runs[1]['cost_model']} merged no leaves "
             f"({runs[1]['num_groups']} groups for {len(names)} leaves)")
    names_arr = [names[j] for j in perm]
    measured = [names_arr[k] for k in runs[0].pop("arrivals")]
    runs[1].pop("arrivals")
    stem = [i for i, n in enumerate(names_arr) if n.startswith("['ConvBN_0']")]
    ici, merged = runs
    out = {
        "policy": "mgwfbp", "cost_model": ici["cost_model"],
        "num_groups": ici["num_groups"], "groups": ici["groups"],
        "predicted_nonoverlap_s": ici["predicted_nonoverlap_s"],
        "allreduce_launches_per_step": ici["allreduce_launches_per_step"],
        "bitwise_equal_to_pre_reduction_copy": True,
        "merging": merged,
        "tb": list(tb), "tb_total_s": float(sum(tb)), "tb_source": tb.source,
        "arrival_positions_of_the_stem_in_the_permutation": stem,
        "arrival_positions_of_the_stem_measured": [
            measured.index(names_arr[i]) for i in stem
        ],
        "permutation_order": names_arr,
        "measured_hook_order": measured,
    }
    for r in runs:
        print(f"train (b): {r['cost_model']}: {r['num_groups']} groups "
              f"(largest {r['largest_group']} leaves, "
              f"{r['held_by_group_order']} held back by the group order), "
              f"{r['allreduce_launches_per_step'][0]} all-reduces per step "
              f"over {REDUCER_STEPS} steps, reduced == pre-reduction bit for "
              "bit", flush=True)
    print(f"train (b): tb {sum(tb) * 1e3:.3f} ms ({tb.source}); the stem is "
          f"at arrival positions {stem} of the permutation, "
          f"{out['arrival_positions_of_the_stem_measured']} as measured",
          flush=True)
    return out


def _gloo_rank(rank: int, world: int, rdv: str, out_path: str,
               device: str, tb: list) -> None:
    """(c) One of two processes on the one card over gloo: GLOO_STEPS steps
    of a fresh model on each of GLOO_LINKS."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch.convert import flax_leaves
    from mgwfbp_tpu_torch.data import ShardInfo, data_prepare
    from mgwfbp_tpu_torch.models import create_model
    from mgwfbp_tpu_torch.models.common import init_weights
    from mgwfbp_tpu_torch.optim import make_optimizer
    from mgwfbp_tpu_torch.parallel.allreduce import make_merged_allreduce
    from mgwfbp_tpu_torch.parallel.costmodel import lookup_alpha_beta
    from mgwfbp_tpu_torch.train import TrainStep

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    results = []
    try:
        bundle = data_prepare("cifar10", batch_size=32,
                              shard=ShardInfo(rank, world), seed=2,
                              synthetic=True)
        for connection, nworkers in ((c, world if n is None else n)
                                     for c, n in GLOO_LINKS):
            result = {"rank": rank, "cost_model":
                      f"{connection} at {nworkers} workers", "steps": 0,
                      "merged_equals_leafwise": True,
                      "params_identical": True}
            results.append(result)
            model, _ = create_model("resnet20")
            init_weights(model, torch.Generator().manual_seed(2)).to(dev)
            params = [t for _, t in flax_leaves(model)]
            reducer = make_merged_allreduce(
                model, policy="mgwfbp", tb=tb,
                cost_model=lookup_alpha_beta(connection, nworkers),
            )
            opt, lr_fn, _ = make_optimizer(model.parameters(), 0.1,
                                           num_batches_per_epoch=GLOO_STEPS)
            step = TrainStep(model, opt, lr_fn, reducer=reducer)
            copies, hooks = _grad_copies(params)
            sync = reducer.synchronize

            def checked_sync(sync=sync, params=params, copies=copies,
                             result=result):
                out = sync()
                for j, p in enumerate(params):
                    leafwise = copies[j].clone()
                    dist.all_reduce(leafwise)
                    leafwise.div_(world)
                    if not torch.equal(p.grad, leafwise):
                        result["merged_equals_leafwise"] = False
                return out

            reducer.synchronize = checked_sync
            for k in range(GLOO_STEPS):
                xb, yb = bundle.train.load_batch(0, k)
                x = torch.from_numpy(xb).to(dev).movedim(-1, -3).contiguous()
                y = torch.from_numpy(yb.astype(np.int64)).to(dev)
                step(x[None], y[None])
                flat = torch.cat([p.detach().reshape(-1) for p in params]).cpu()
                gathered = [torch.empty_like(flat) for _ in range(world)]
                dist.all_gather(gathered, flat)
                if not all(torch.equal(t, gathered[0]) for t in gathered):
                    result["params_identical"] = False
                result["steps"] += 1
            result["num_groups"] = reducer.num_groups
            result["num_leaves"] = len(params)
            result["launches"] = reducer.launches
            for h in hooks:
                h.remove()
            reducer.detach()
    finally:
        dist.destroy_process_group()
        with open(out_path, "w") as f:
            json.dump(results, f)


def train_phase_gloo(tb: list) -> dict:
    """(c) Two processes on the one card over gloo (NCCL refuses two ranks
    on one device): GLOO_STEPS steps of mgwfbp on phase (b)'s measured tb
    (the trainer broadcasts rank 0's), on the ``ici`` prior at two workers
    and on MERGING_LINK; both ranks' parameters are bit-identical after
    every step and each step's merged gradients equal, bit for bit, the
    same gradients reduced leaf by leaf."""
    import torch.multiprocessing as mp

    world = 2
    with tempfile.TemporaryDirectory(prefix="mgwfbp_gloo_") as d:
        ctx = mp.get_context("spawn")
        outs = [os.path.join(d, f"rank{r}.json") for r in range(world)]
        procs = [
            ctx.Process(target=_gloo_rank,
                        args=(r, world, os.path.join(d, "rdv"), outs[r],
                              TRAIN_DEVICE, tb))
            for r in range(world)
        ]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(300)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        codes = [p.exitcode for p in procs]
        results = []
        for path in outs:
            if os.path.exists(path):
                with open(path) as f:
                    results.append(json.load(f))
    if codes != [0] * world or len(results) != world:
        fail(f"gloo phase: ranks exited {codes}")
    for rank_results in results:
        if len(rank_results) != len(GLOO_LINKS):
            fail(f"gloo phase: {rank_results}")
        for r in rank_results:
            if r["steps"] != GLOO_STEPS or not r["merged_equals_leafwise"] or (
                not r["params_identical"]
            ):
                fail(f"gloo phase: {r}")
    merged = results[0][1]
    if merged["num_groups"] >= merged["num_leaves"]:
        fail(f"gloo phase: {merged['cost_model']} merged no leaves ({merged})")
    runs = []
    for i, r in enumerate(results[0]):
        print(f"train (c): 2 ranks over gloo, {r['cost_model']}: "
              f"{GLOO_STEPS} steps, {r['num_groups']} groups; merged == "
              "leaf-by-leaf and the ranks' parameters equal, bit for bit, "
              "after every step", flush=True)
        runs.append({"cost_model": r["cost_model"],
                     "num_groups": r["num_groups"],
                     "launches": [rr[i]["launches"] for rr in results]})
    return {"world": world, "steps": GLOO_STEPS,
            "num_groups": runs[0]["num_groups"], "launches": runs[0]["launches"],
            "runs": runs,
            "merged_equals_leafwise_bitwise": True,
            "params_identical_every_step": True}


def phase_train() -> dict:
    with tempfile.TemporaryDirectory(prefix="mgwfbp_train_") as ckpt:
        a = train_phase_trainer(ckpt)
    b = train_phase_reducer()
    c = train_phase_gloo(b["tb"])
    return {
        "model": "resnet20", "step_ms": a["step_ms"],
        "images_per_s": a["images_per_s"], "busy_share": a["busy_share"],
        "num_groups": b["num_groups"], "groups": b["groups"],
        "merging_num_groups": b["merging"]["num_groups"],
        "merging_groups": b["merging"]["groups"],
        "tb_total_s": b["tb_total_s"], "tb_source": b["tb_source"],
        "allreduce_launches_per_step": b["allreduce_launches_per_step"],
        "arrival": {
            k: b[k] for k in (
                "arrival_positions_of_the_stem_in_the_permutation",
                "arrival_positions_of_the_stem_measured",
                "permutation_order", "measured_hook_order",
            )
        },
        "trainer": a, "reducer": {
            k: ({kk: vv for kk, vv in v.items() if kk != "groups"}
                if k == "merging" else v)
            for k, v in b.items()
            if k not in ("permutation_order", "measured_hook_order", "groups",
                         "tb")
        },
        "gloo": c,
    }


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
    train = phase_train()

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
    print(json.dumps({"train": train}))
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
