"""Helpers shared by the zoo parity tests (tests/test_torch_zoo_*.py).

Weights come from the port's seeded init (``init_weights``) and are carried
to the JAX package with ``convert.variables_to_flax``; inputs are numpy
from a seed, NHWC for JAX and permuted to NCHW for the port. Dropout is
off on both sides where a train-mode case is compared: on the JAX side by
patching ``flax.linen.Dropout.__call__`` to the identity inside the test
(``jax_dropout_off``), on the port's by setting every ``nn.Dropout``'s rate
to 0 (``port_dropout_off``); the two packages draw different masks.

``jax_grads_f64`` runs ``jax.grad`` of the JAX ``make_loss_fn`` in a
subprocess with x64 on, in float64 and in float32 (the JAX package's own
float32 gradients), for a registered model or one block.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

from mgwfbp_tpu_torch import models
from mgwfbp_tpu_torch.convert import flatten_flax, flax_leaves, variables_to_flax
from mgwfbp_tpu_torch.models.common import init_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous()


def nhwc(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


def flax_grad(p: torch.Tensor) -> np.ndarray:
    """A parameter's gradient in Flax layout, float64."""
    g = p.grad
    g = g.permute(2, 3, 1, 0) if g.dim() == 4 else g.t() if g.dim() == 2 else g
    return g.double().numpy()


def port_dropout_off(module: torch.nn.Module) -> torch.nn.Module:
    for m in module.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return module


def jax_dropout_off(monkeypatch) -> None:
    from flax import linen as fnn

    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, *a, **k: x)


def seeded(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    return init_weights(module, torch.Generator().manual_seed(seed))


def port_model(name: str, seed: int = 0, **kw):
    """(module, meta): a registered model at the port's seeded init, with
    dropout off."""
    module, meta = models.create_model(name, **kw)
    return port_dropout_off(seeded(module, seed)), meta


def images(b: int, hwc, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randn(b, *hwc).astype(np.float32)


def labels(b: int, nc: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed + 1).randint(0, nc, b).astype(np.int32)


def np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def assert_grads_close(module, want: dict, rel: float, what: str = "") -> float:
    """Every parameter gradient of ``module`` within ``rel`` times
    max(1, the leaf's largest magnitude) of ``want`` (Flax paths -> arrays);
    returns the largest such relative error."""
    worst = 0.0
    leaves = flax_leaves(module)
    assert [p for p, _ in leaves] == list(flatten_flax(want))
    want = flatten_flax(want)
    for path, p in leaves:
        g, w = flax_grad(p), np.asarray(want[path], np.float64)
        scale = max(1.0, float(np.abs(w).max()))
        err = float(np.abs(g - w).max()) / scale
        worst = max(worst, err)
        assert err <= rel, f"{what} {path}: {err:.3e} > {rel:.1e}"
    return worst


_JAX_F64 = r"""
import importlib, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
from flax import linen as fnn
fnn.Dropout.__call__ = lambda self, x, *a, **k: x
from mgwfbp_tpu.models import ModelMeta, create_model
from mgwfbp_tpu.train.step import make_loss_fn
from mgwfbp_tpu_torch.convert import flatten_flax
z = np.load(sys.argv[1])
spec = str(z["spec"])
def nest(prefix, dt):
    out = {}
    for k in z.files:
        if not k.startswith(prefix):
            continue
        *mods, leaf = k[len(prefix):].split(".")
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = z[k].astype(dt)
    return out
if ":" in spec:  # module:Class(args) of one block, its output's sum with r
    mod, expr = spec.split(":", 1)
    block = eval(expr, vars(importlib.import_module(mod)))
    def loss_of(params, bstats, x):
        y, upd = block.apply({"params": params, "batch_stats": bstats}, x,
                             train=True, mutable=["batch_stats"])
        return (y * z["r"].astype(x.dtype)).sum(), upd["batch_stats"]
    fn = lambda p, b, x, y: jax.grad(loss_of, has_aux=True)(p, b, x)
else:
    model, meta = create_model(spec)
    lf = make_loss_fn(model, meta)
    fn = lambda p, b, x, y: jax.grad(lf, has_aux=True)(
        p, b, {"x": x, "y": y}, jax.random.PRNGKey(0), None)
tree = lambda t: flatten_flax(jax.tree_util.tree_map(np.asarray, t))
out = {}
dtypes = (("f64", np.float64), ("f32", np.float32))[:int(z["passes"])]
for tag, dt in dtypes:
    g, _ = jax.jit(fn)(nest("params/", dt), nest("bstats/", dt),
                       z["x"].astype(dt), z["y"])
    out.update({f"{tag}/{k}": v for k, v in tree(g).items()})
np.savez(sys.argv[2], **out)
"""


def jax_grads_f64(tmp_path, spec: str, params, bstats, x: np.ndarray,
                  y: np.ndarray, r=None,
                  with_f32: bool = True) -> tuple[dict, dict]:
    """({path: float64 grad}, {path: float32 grad} or {}) of the JAX
    package's ``make_loss_fn`` for registered model ``spec`` (dropout off),
    or of ``sum(block(x) * r)`` for ``spec`` = "module:Block(args)", on the
    given weights, in a subprocess with x64 on (each pass compiles anew:
    about 17 s for DenseNet-BC-100)."""
    arrays = {f"params/{k}": v for k, v in flatten_flax(params).items()}
    arrays.update({f"bstats/{k}": v for k, v in flatten_flax(bstats).items()})
    if r is not None:
        arrays["r"] = r
    src, dst = tmp_path / "f64_in.npz", tmp_path / "f64_out.npz"
    np.savez(src, spec=spec, x=x, y=y, passes=2 if with_f32 else 1,
             **arrays)
    res = subprocess.run(
        [sys.executable, "-c", _JAX_F64, str(src), str(dst)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu"),
    )
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(dst) as z:
        out = {k: z[k] for k in z.files}
    return ({k[4:]: v for k, v in out.items() if k.startswith("f64/")},
            {k[4:]: v for k, v in out.items() if k.startswith("f32/")})


def f64_parity(tmp_path, spec: str, module: torch.nn.Module, x: np.ndarray,
               y: np.ndarray, loss_of, r=None,
               f32_rel: float | None = None) -> dict:
    """The port in float64 against float64 ``jax.grad`` within 1e-6 (the
    same function; the loss is float32 in both packages), and the port in
    float32 no further from it than twice the JAX package's own float32
    gradients are, plus 1e-5 (relative to max(1, |leaf|)); with
    ``f32_rel`` the port in float32 within that bound instead, and the JAX
    float32 pass is skipped. ``loss_of(m, x)`` is the port's loss of a
    module on an NCHW input of its dtype."""
    params, bstats = variables_to_flax(module)
    want64, want32 = jax_grads_f64(tmp_path, spec, params, bstats, x, y, r,
                                   with_f32=f32_rel is None)
    state = {k: v.clone() for k, v in module.state_dict().items()}
    errs = {}
    for dtype in (torch.float64, torch.float32):
        module.load_state_dict(state)
        m = module.to(dtype).train()
        m.zero_grad(set_to_none=True)
        loss_of(m, nchw(x).to(dtype)).backward()
        rel = 1e-6 if dtype == torch.float64 else (f32_rel or 1.0)
        errs[dtype] = assert_grads_close(m, want64, rel, str(dtype))
    module.to(torch.float32)
    if f32_rel is not None:
        return {"port_f64": errs[torch.float64],
                "port_f32": errs[torch.float32]}
    jax32 = 0.0
    for path, w in want64.items():
        scale = max(1.0, float(np.abs(w).max()))
        jax32 = max(jax32, float(np.abs(want32[path] - w).max()) / scale)
    assert errs[torch.float32] <= 2 * jax32 + 1e-5, (errs, jax32)
    return {"port_f64": errs[torch.float64], "port_f32": errs[torch.float32],
            "jax_f32": jax32}


def block_parity(jblock, port_block: torch.nn.Module, x: np.ndarray,
                 grad_rel: float = 1e-4, seed: int = 0) -> float:
    """One block in training mode on both sides, from the JAX block's own
    init: the output, the updated batch statistics and the gradients of
    ``sum(output * r)`` for a seeded cotangent r: the output within 2e-5
    of max(1, its largest magnitude), the statistics within rtol 2e-5 /
    atol 1e-5, the gradients within ``grad_rel`` of max(1, |leaf|).
    Returns the largest gradient error."""
    import jax
    from functools import partial

    from mgwfbp_tpu_torch.convert import state_from_flax

    v = jax.jit(partial(jblock.init, train=False))(jax.random.PRNGKey(seed), x)
    params, bstats = np_tree(v["params"]), np_tree(v.get("batch_stats", {}))
    port_block.load_state_dict(state_from_flax(port_block, params, bstats))
    y_shape = jax.eval_shape(partial(jblock.apply, train=False), v, x).shape
    r = np.random.RandomState(seed + 7).randn(*y_shape).astype(np.float32)

    def f(p):
        y, upd = jblock.apply({"params": p, "batch_stats": bstats}, x,
                              train=True, mutable=["batch_stats"])
        return (y * r).sum(), (y, upd.get("batch_stats", {}))

    grads, (y, new_b) = jax.jit(jax.grad(f, has_aux=True))(params)
    port_block.train()
    y_t = port_block(nchw(x))
    (y_t * (nchw(r) if r.ndim == 4 else torch.from_numpy(r))).sum().backward()
    y = np.asarray(y)
    assert nhwc(y_t).shape == y.shape
    scale = max(1.0, float(np.abs(y).max()))
    assert float(np.abs(nhwc(y_t) - y).max()) <= 2e-5 * scale
    got_b = flatten_flax(variables_to_flax(port_block)[1])
    want_b = flatten_flax(np_tree(new_b))
    assert list(got_b) == list(want_b)
    for k, w in want_b.items():
        np.testing.assert_allclose(got_b[k], w, rtol=2e-5, atol=1e-5,
                                   err_msg=k)
    return assert_grads_close(port_block, np_tree(grads), grad_rel)
