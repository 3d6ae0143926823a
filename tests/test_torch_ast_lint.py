"""The port's capture-safety lint (``mgwfbp_tpu_torch.analysis.ast_lint``)
against the JAX package's (``mgwfbp_tpu.analysis.ast_lint``).

Each seeded snippet of the JAX suite (tests/test_analysis.py's lint
tests) and its torch twin (``@torch.compile`` / ``torch.compile(f)`` /
``torch.cuda.make_graphed_callables`` in place of ``@jax.jit`` /
``jax.jit(f)`` / ``lax.scan``, ``torch.`` calls in place of ``jnp.`` ones,
a parameter annotated ``int`` in place of a static argument, the port's
marker prefix in place of the JAX one) give the same (rule id, line)
findings through the JAX lint and the port's lint respectively. Then the
torch scopes the JAX lint has no counterpart for (a CUDA graph's body,
``torch.func`` transforms, ``torch.jit``), the host reads torch adds
(``.tolist()``, ``.cpu()``, ``.numpy()``), the structural exemptions, and
the port tree, which lints clean; the static passes import no torch."""

from __future__ import annotations

import re
import subprocess
import sys

import pytest

from mgwfbp_tpu.analysis import rules as jax_rules
from mgwfbp_tpu.analysis.ast_lint import lint_source as jax_lint
from mgwfbp_tpu_torch.analysis.ast_lint import lint_paths, lint_source

JAX_PREFIX = re.search(r"#\\s\*(\w+):", jax_rules._NOQA.pattern).group(1)


def _set(findings):
    return {(f.rule_id, f.line) for f in findings}


_JAX_TOY = '''
import time
import numpy as np
import jax
import jax.numpy as jnp
from functools import partial

@partial(jax.jit, static_argnums=(1,))
def step(x, cfg, extras={}):
    t = time.time()
    noise = np.random.randn(4)
    if jnp.isnan(x).any():
        return x
    v = float(x)
    s = x.sum().item()
    return x + t + noise[0] + v + s

def helper(y):
    return time.time()  # NOT traced: must not fire

def scanned(carry, x):
    while jnp.abs(carry) > 1:
        carry = carry / 2
    return carry, x

out = jax.lax.scan(scanned, 0.0, None)
'''
_TORCH_TOY = '''
import time
import numpy as np
import torch
import torch.nn.functional as F
from functools import partial

@partial(torch.compile, dynamic=False)
def step(x, cfg: int, extras={}):
    t = time.time()
    noise = np.random.randn(4)
    if torch.isnan(x).any():
        return x
    v = float(x)
    s = x.sum().item()
    return x + t + noise[0] + v + s

def helper(y):
    return time.time()  # NOT traced: must not fire

def scanned(carry, x):
    while torch.abs(carry) > 1:
        carry = carry / 2
    return carry, x

out = torch.cuda.make_graphed_callables(scanned, (torch.zeros(()),))
'''

# name -> (JAX snippet, torch twin); markers are written with the port's
# prefix and the JAX twin gets the JAX one
TWINS = {
    "toy_module": (_JAX_TOY, _TORCH_TOY),
    "noqa_listed": (
        "import jax\nfrom functools import partial\n"
        "@partial(jax.jit)\n"
        "def f(x):\n"
        "    return float(x)  # mgwfbp: noqa[JIT003]\n",
        "import torch\nfrom functools import partial\n"
        "@partial(torch.compile)\n"
        "def f(x):\n"
        "    return float(x)  # mgwfbp: noqa[JIT003]\n"),
    "noqa_wrong_id": (
        "import jax\nfrom functools import partial\n"
        "@partial(jax.jit)\n"
        "def f(x):\n"
        "    return float(x)  # mgwfbp: noqa[JIT001]\n",
        "import torch\nfrom functools import partial\n"
        "@partial(torch.compile)\n"
        "def f(x):\n"
        "    return float(x)  # mgwfbp: noqa[JIT001]\n"),
    "noqa_bare": (
        "import jax\nfrom functools import partial\n"
        "@partial(jax.jit)\n"
        "def f(x):\n"
        "    return float(x)  # mgwfbp: noqa\n",
        "import torch\nfrom functools import partial\n"
        "@partial(torch.compile)\n"
        "def f(x):\n"
        "    return float(x)  # mgwfbp: noqa\n"),
    "clean_module": (
        "import jax, jax.numpy as jnp\n"
        "from functools import partial\n"
        "@partial(jax.jit)\n"
        "def f(x, n=3):\n"
        "    y = jnp.where(x > 0, x, -x)\n"
        "    if n > 2:\n"
        "        y = y * 2\n"
        "    return y\n",
        "import torch\n"
        "from functools import partial\n"
        "@partial(torch.compile)\n"
        "def f(x, n=3):\n"
        "    y = torch.where(x > 0, x, -x)\n"
        "    if n > 2:\n"
        "        y = y * 2\n"
        "    return y\n"),
    "jit006_telemetry": (
        "import jax\n"
        "def step(state, batch):\n"
        "    print('loss')\n"
        "    log.info('iter %d', 1)\n"
        "    self_writer = None\n"
        "    writer.add_scalar('train/loss', 1.0, 2)\n"
        "    telemetry.emit('step', step=1)\n"
        "    return state\n"
        "f = jax.jit(step)\n",
        "import torch\n"
        "def step(state, batch):\n"
        "    print('loss')\n"
        "    log.info('iter %d', 1)\n"
        "    self_writer = None\n"
        "    writer.add_scalar('train/loss', 1.0, 2)\n"
        "    telemetry.emit('step', step=1)\n"
        "    return state\n"
        "f = torch.compile(step)\n"),
    "jit006_spares_legit_calls": (
        "import jax\n"
        "def step(x):\n"
        "    jax.debug.print('x={}', x)\n"
        "    return x\n"
        "f = jax.jit(step)\n"
        "def untraced():\n"
        "    print('fine')\n"
        "    log.info('fine')\n"
        "def traced_other(x):\n"
        "    return sound.emit(x)\n"
        "g = jax.jit(traced_other)\n",
        "import torch\n"
        "def step(x):\n"
        "    torch.cuda.nvtx.mark('x')\n"
        "    return x\n"
        "f = torch.compile(step)\n"
        "def untraced():\n"
        "    print('fine')\n"
        "    log.info('fine')\n"
        "def traced_other(x):\n"
        "    return sound.emit(x)\n"
        "g = torch.jit.script(traced_other)\n"),
    "jit006_self_log_method": (
        "import jax\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    self.log.warning('hot path')\n"
        "    return x\n",
        "import torch\n"
        "@torch.compile\n"
        "def f(x):\n"
        "    self.log.warning('hot path')\n"
        "    return x\n"),
    "static_params_are_not_traced": (
        "import jax\nfrom functools import partial\n"
        "@partial(jax.jit, static_argnums=(1,), static_argnames=('m',))\n"
        "def f(x, n, m=2):\n"
        "    return x * int(n) + float(m) + bool(x)\n",
        "import torch\nfrom functools import partial\n"
        "@partial(torch.compile, dynamic=False)\n"
        "def f(x, n: int, m: int = 2):\n"
        "    return x * int(n) + float(m) + bool(x)\n"),
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_snippets_give_the_jax_findings(name):
    jax_src, torch_src = TWINS[name]
    jax_src = jax_src.replace("mgwfbp:", f"{JAX_PREFIX}:")
    j = _set(jax_lint(jax_src, "t.py"))
    p = _set(lint_source(torch_src, "t.py"))
    assert p == j, (sorted(p), sorted(j))


def test_toy_module_fires_each_seeded_rule():
    by_rule: dict = {}
    for f in lint_source(_TORCH_TOY, "toy.py"):
        by_rule.setdefault(f.rule_id, []).append(f.line)
    assert sorted(by_rule) == ["JIT001", "JIT002", "JIT003", "JIT004",
                               "JIT005"]
    assert len(by_rule["JIT003"]) == 2 and len(by_rule["JIT004"]) == 2
    helper = _TORCH_TOY.splitlines().index(
        "    return time.time()  # NOT traced: must not fire") + 1
    assert helper not in by_rule["JIT001"]


# -- the torch scopes ----------------------------------------------------------


def _rules(src):
    return sorted((f.rule_id, f.line) for f in lint_source(src, "t.py"))


def test_cuda_graph_block_is_captured_code():
    src = (
        "import torch\n"
        "def run(x, g):\n"
        "    y = x.sum().item()\n"          # outside the capture: fine
        "    with torch.cuda.graph(g):\n"
        "        z = x * 2\n"
        "        print(z)\n"
        "        w = float(x)\n"
        "        if torch.isnan(z).any():\n"
        "            z = z * 0\n"
        "    return z.item()\n"             # after the block: fine
    )
    assert _rules(src) == [("JIT003", 7), ("JIT004", 8), ("JIT006", 6)]


@pytest.mark.parametrize("call", [
    "torch.func.grad(loss)", "torch.func.vmap(loss)",
    "torch.func.jacrev(loss)", "torch.func.jacfwd(loss)",
    "torch.vmap(loss)", "vmap(loss)", "torch.jit.script(loss)",
    "torch.jit.trace(loss, (torch.zeros(2),))",
    "torch.cuda.make_graphed_callables((loss, other), ((x,), (x,)))",
])
def test_capturing_calls_make_their_operand_captured(call):
    src = (
        "import time, torch\n"
        "def loss(w):\n"
        "    return w.sum() * time.time()\n"
        f"f = {call}\n"
    )
    assert _rules(src) == [("JIT001", 3)]


def test_functional_call_captures_nothing():
    src = (
        "import time, torch\n"
        "def loss(w):\n"
        "    return w.sum() * time.time()\n"
        "f = torch.func.functional_call(loss, {}, (1,))\n"
    )
    assert _rules(src) == []


@pytest.mark.parametrize("decorator", [
    "@torch.compile", "@torch.compile(mode='reduce-overhead')",
    "@torch.jit.script", "@partial(torch.jit.script)",
    "@functools.partial(torch.compile, fullgraph=True)",
])
def test_capture_decorators(decorator):
    src = (
        "import functools, torch\nfrom functools import partial\n"
        f"{decorator}\n"
        "def f(x, acc=[]):\n"
        "    def inner(y):\n"
        "        return y.tolist()\n"
        "    return inner(x)\n"
    )
    # the mutable default on the decorated function, the nested def's read
    assert _rules(src) == [("JIT003", 6), ("JIT005", 4)]


@pytest.mark.parametrize("read", ["x.tolist()", "x.cpu()", "x.numpy()",
                                  "x.item()", "int(x)", "bool(x)",
                                  "float(torch.sum(y))"])
def test_host_reads(read):
    src = (
        "import torch\n"
        "@torch.compile\n"
        "def f(x, y):\n"
        f"    return {read}\n"
    )
    assert _rules(src) == [("JIT003", 4)]


@pytest.mark.parametrize("test", [
    "x.shape[0] > 1", "x.dim() == 4", "x.dtype == torch.float32",
    "x.device.type == 'cuda'", "torch.zeros(3).shape[0] == 3",
    "torch.ones(2, 2).dim() == 2", "torch.is_floating_point(x)",
])
def test_structural_branches_are_static(test):
    src = (
        "import torch\n"
        "@torch.compile\n"
        "def f(x):\n"
        f"    if {test}:\n"
        "        x = x * 2\n"
        "    return x\n"
    )
    assert _rules(src) == []


def test_python_random_is_frozen_rng():
    src = (
        "import random, torch\n"
        "@torch.compile\n"
        "def f(x):\n"
        "    return x * random.random()\n"
    )
    assert _rules(src) == [("JIT002", 4)]


# -- the port tree, the CLI, the imports ----------------------------------------


def test_port_tree_lints_clean():
    import os

    import mgwfbp_tpu_torch

    assert lint_paths([os.path.dirname(mgwfbp_tpu_torch.__file__)]) == []


def test_lint_paths_reports_missing_target(tmp_path):
    from mgwfbp_tpu_torch.analysis.__main__ import main

    missing = str(tmp_path / "no_such_dir_or_file")
    assert {f.rule_id for f in lint_paths([missing])} == {"JIT000"}
    assert main(["--skip-step", missing]) == 1


def test_static_passes_import_no_torch():
    code = (
        "import sys\n"
        "from mgwfbp_tpu_torch.analysis import ast_lint, race_check, "
        "rules, spmd_check\n"
        "import mgwfbp_tpu_torch.analysis.__main__\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'flax', 'mgwfbp_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True)
