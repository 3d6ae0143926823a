"""One rank of tests/test_torch_spans.py's two-rank gloo group, and the
harness that starts it (``run_ranks``).

Each rank is a child process (``torch_xstep_worker.run_children``),
started as ``python tests/torch_spans_worker.py RANK WORLD RENDEZVOUS
OUT_DIR``; it imports torch and the port only. For every lowering
(all_reduce, rs_ag, rs_opt_ag with the global-norm clip, rs_fwd_ag, hier
over two slices of one, top-k at density 0.3) it builds the narrow
ResNet-20 step over a threshold schedule, takes one step unarmed, then,
inside ``spans.recording()``, one step observed by the schedule verifier
and the host observer (``verify_observed_step``: the collective rules and
SCH005, SCH006, SCH008), and two more steps under torch.profiler (which
arms the recorder too), and writes what the span recorder holds of the
three (each merge group's ready and done marks, milliseconds after B, in
launch order) and the phase ranges of each profiled step, in order. Each
rank writes ``<out_dir>/rank<r>.json``.

With ``nccl`` as a fifth argument each rank runs on its own CUDA card over
NCCL (``_card_cases``): for every lowering two copies of the step from
one initialisation take the same batches, one never armed and one armed
(inside ``spans.recording()``, with tensors filled with NaN allocated on
the step's stream between the launches and the waits, so that memory a
collective still reads and the allocator has handed back shows), and the
rank writes whether every step's metrics and the final parameters are
equal bit for bit, and the armed copy's marks.
"""

from __future__ import annotations

import datetime
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_xstep_worker as xw  # noqa: E402

OPS = ("all_reduce", "rs_ag", "rs_opt_ag", "rs_fwd_ag", "hier", "topk")
ARMED_STEPS = 3
STEP_RANGE = "worker.step"


def run_ranks(world: int, out_dir: str, timeout_s: float = 240.0,
              backend: str = "gloo") -> list:
    """``world`` ranks of this worker; each rank's {lowering: record}."""
    rdv = os.path.join(out_dir, "rendezvous")
    xw.run_children([[sys.executable, os.path.abspath(__file__), str(r),
                      str(world), rdv, out_dir, backend]
                     for r in range(world)],
                    timeout_s=timeout_s, cwd=out_dir)
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _cases(world: int, rank: int) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mgwfbp_tpu_torch.analysis.schedule_check import verify_observed_step
    from mgwfbp_tpu_torch.models.common import init_weights
    from mgwfbp_tpu_torch.optim import make_optimizer
    from mgwfbp_tpu_torch.parallel import allreduce as ar
    from mgwfbp_tpu_torch.parallel.compression import make_compressor
    from mgwfbp_tpu_torch.parallel.mesh import two_level_groups
    from mgwfbp_tpu_torch.telemetry import spans
    from mgwfbp_tpu_torch.train.step import TrainStep

    levels = two_level_groups(world)
    rs = np.random.RandomState(7 + rank)

    def batch():
        x = torch.from_numpy(rs.randn(1, 4, 3, 32, 32).astype(np.float32))
        y = torch.from_numpy(rs.randint(0, xw.NC, (1, 4)))
        return x, y

    out: dict = {}
    for name in OPS:
        op = "all_reduce" if name == "topk" else name
        model, _ = xw.narrow_resnet()
        init_weights(model, torch.Generator().manual_seed(3))
        opt, lr_fn, _, spec = make_optimizer(
            model.parameters(), 0.05, momentum=0.9, weight_decay=1e-4,
            num_batches_per_epoch=4,
            norm_clip=1.0 if op in ar.SHARDED_OPS else None,
            world_size=world, return_spec=True)
        reducer = ar.make_merged_allreduce(
            model, policy="threshold", threshold=3000, comm_op=op,
            world_size=world,
            optim_spec=spec if op in ar.SHARDED_OPS else None,
            levels=levels if op == "hier" else None,
            compressor=make_compressor("topk", 0.3) if name == "topk"
            else None)
        step = TrainStep(model, opt, lr_fn, reducer=reducer,
                         norm_clip=spec.norm_clip)
        try:
            step(*batch())
            reducer.materialize()
            spans.clear()
            with spans.recording():
                obs = verify_observed_step(lambda: step(*batch()), step,
                                           file=f"<{name}>")
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                for _ in range(ARMED_STEPS - 1):
                    with torch.profiler.record_function(STEP_RANGE):
                        step(*batch())
            readings = spans.recent_steps()
        finally:
            reducer.detach()
        ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                        for e in prof.events()
                        if e.name == STEP_RANGE
                        or e.name.startswith("train_step."))
        out[name] = {
            "groups": reducer.num_groups,
            "launch_sequence": reducer.launch_sequence,
            "findings": [[f.rule_id, f.message] for f in obs.findings],
            "syncs": [s.op for s in obs.syncs],
            "steps": [{"groups": r["groups"], "tail_ms": r["tail_ms"]}
                      for r in readings],
            "phases": [[n for s, e, n in ranges
                        if n != STEP_RANGE and a <= s and e <= b]
                       for a, b, m in ranges if m == STEP_RANGE],
        }
    return out


def _build(name: str, world: int, levels, device):
    """One copy of lowering ``name``'s step, from the shared
    initialisation, on ``device``."""
    import torch

    from mgwfbp_tpu_torch.models.common import init_weights
    from mgwfbp_tpu_torch.optim import make_optimizer
    from mgwfbp_tpu_torch.parallel import allreduce as ar
    from mgwfbp_tpu_torch.parallel.compression import make_compressor
    from mgwfbp_tpu_torch.train.step import TrainStep

    op = "all_reduce" if name == "topk" else name
    model, _ = xw.narrow_resnet()
    init_weights(model, torch.Generator().manual_seed(3))
    model.to(device)
    opt, lr_fn, _, spec = make_optimizer(
        model.parameters(), 0.05, momentum=0.9, weight_decay=1e-4,
        num_batches_per_epoch=4,
        norm_clip=1.0 if op in ar.SHARDED_OPS else None,
        world_size=world, return_spec=True)
    reducer = ar.make_merged_allreduce(
        model, policy="threshold", threshold=3000, comm_op=op,
        world_size=world,
        optim_spec=spec if op in ar.SHARDED_OPS else None,
        levels=levels if op == "hier" else None,
        compressor=make_compressor("topk", 0.3) if name == "topk"
        else None)
    step = TrainStep(model, opt, lr_fn, reducer=reducer,
                     norm_clip=spec.norm_clip)
    return model, reducer, step


def _scribbled(reducer, device) -> None:
    """Before each of ``reducer``'s waits, allocate tensors of every
    group's bucket and shard sizes on the current stream and fill them
    with NaN (held until the wait returns)."""
    import torch

    sizes = []
    for n in reducer.layout.group_sizes:
        sizes += [n, n + reducer.world, n // reducer.world + 1]
    for what in ("synchronize", "reduce_and_update", "reduce_and_defer"):
        real = getattr(reducer, what)

        def wrapped(*a, real=real, **k):
            junk = [torch.full((m,), float("nan"), device=device,
                               dtype=dt)
                    for m in sizes for dt in (torch.float32, torch.bfloat16)]
            out = real(*a, **k)
            del junk
            return out

        setattr(reducer, what, wrapped)


def _card_cases(world: int, rank: int, device=None) -> dict:
    import numpy as np
    import torch

    from mgwfbp_tpu_torch.parallel.mesh import two_level_groups
    from mgwfbp_tpu_torch.telemetry import spans

    device = device or torch.device("cuda", rank)
    levels = two_level_groups(world)
    out: dict = {}
    for name in OPS:
        (m0, r0, s0), (m1, r1, s1) = (_build(name, world, levels, device)
                                      for _ in range(2))
        _scribbled(r1, device)
        rs = np.random.RandomState(7 + rank)
        equal = []
        try:
            spans.clear()
            for _ in range(ARMED_STEPS + 1):
                x = torch.from_numpy(
                    rs.randn(1, 4, 3, 32, 32).astype(np.float32)).to(device)
                y = torch.from_numpy(rs.randint(0, xw.NC, (1, 4))).to(device)
                a = s0(x, y)
                with spans.recording():
                    b = s1(x, y)
                equal.append(all(torch.equal(a[k], b[k]) for k in a))
            r0.materialize()
            r1.materialize()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            readings = spans.recent_steps()
        finally:
            r0.detach()
            r1.detach()
        p0, p1 = m0.state_dict(), m1.state_dict()
        out[name] = {
            "groups": r1.num_groups,
            "launch_sequence": r1.launch_sequence,
            "metrics_equal": equal,
            "params_equal": all(torch.equal(p0[k], p1[k]) for k in p0),
            "steps": [{"cuda": r["cuda"], "groups": r["groups"],
                       "tail_ms": r["tail_ms"]} for r in readings],
        }
    return out


def main(rank: int, world: int, rendezvous: str, out_dir: str,
         backend: str = "gloo") -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=f"file://{rendezvous}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        out = (_card_cases if backend == "nccl" else _cases)(world, rank)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         *sys.argv[5:6])
