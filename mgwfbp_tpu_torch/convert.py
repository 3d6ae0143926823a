"""Weight carry-over between Flax parameter trees and PyTorch modules.

A Flax tree is a nested dict of arrays keyed by module and leaf name; the
shard-native checkpoint manifest records each leaf by its path (as
``jax.tree_util.keystr`` writes it, ``['Block_0']['qkv']['kernel']``). Here a
leaf is addressed by the dotted form of that path (``Block_0.qkv.kernel``);
``flax_path`` turns either spelling into the dotted one.

Name and layout rules (Flax -> torch):
  * module ``<Type>_<k>`` inside a container -> ``<container>.<i>``
    (``Block_3`` -> ``blocks.3``, ``BasicBlock_3`` or ``Bottleneck_3`` ->
    ``blocks.3``, ``OptimizedLSTMCell_1`` -> ``cells.1``; in a container of
    several types k counts that type only: ``Transition_0`` after six
    ``DenseLayer``s is ``layers.6``); a
    module's ``FLAX_NAMES`` renames its children (``ConvBN_0`` ->
    ``conv1``, ``Conv_0`` -> ``conv``, ``BatchNorm_0`` -> ``bn``); every
    other module keeps its name;
  * ``Dense.kernel`` (in, out) -> ``Linear.weight`` (out, in), transposed
    (a bias-free Dense has no ``bias`` leaf);
  * ``Conv.kernel`` (H, W, I, O) -> ``Conv2d.weight`` (O, I, H, W);
  * ``LayerNorm.scale`` / ``BatchNorm.scale`` -> ``weight``;
  * ``Embed.embedding`` (num, d) -> ``Embedding.weight`` (num, d), as is;
  * ``OptimizedLSTMCell``'s gate leaves ``<gate>.kernel`` (in, H) and
    ``<gate>.bias`` (H,) -> the cell's own parameters ``<gate>_weight``
    (H, in), transposed, and ``<gate>_bias`` (one parameter per leaf);
  * the speech model's ``Lookahead.weight`` (context + 1, H), as is;
  * ``bias`` -> ``bias``;
  * the ``batch_stats`` collection's ``mean`` / ``var`` ->
    ``running_mean`` / ``running_var``.

``params_from_flax``/``torch_key`` map by name alone (the transformer's
layout); ``state_from_flax``/``variables_to_flax`` walk the module, which
every model's layout needs. ``host_leaves`` copies one collection to the
host in Flax layout, the layout change done on the module's device;
``momentum_to_flax``/``momentum_from_flax`` carry ``torch.optim.SGD``'s
per-parameter ``momentum_buffer`` to and from the optax ``trace`` of the
same leaves (zeros for a buffer torch has not made yet: optax starts its
trace at zeros, and a zero buffer gives the same next step as a fresh one).
"""

from __future__ import annotations

import re
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

_BLOCK = re.compile(r"^Block_(\d+)$")
_LSTM_CELL = re.compile(r"^OptimizedLSTMCell_(\d+)$")
_KEYSTR_PART = re.compile(r"\['([^']*)'\]|\.([A-Za-z_]\w*)|\[(\d+)\]")


def flax_path(path: str) -> str:
    """Dotted leaf path from a keystr (``['a']['b']``) or dotted path."""
    if "[" not in path:
        return path.lstrip(".")
    parts = [
        next(g for g in m.groups() if g is not None)
        for m in _KEYSTR_PART.finditer(path)
    ]
    return ".".join(parts)


def keystr(path: str) -> str:
    """The manifest's spelling of a dotted leaf path (``['a']['b']``)."""
    return "".join(f"['{p}']" for p in path.split("."))


def flatten_flax(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """Nested dict -> {dotted path: leaf}, in the order jax.tree_util
    flattens a dict tree (keys sorted at every level). A flat dict of
    dotted paths passes through, re-ordered the same way."""
    out: dict[str, Any] = {}
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(flatten_flax(val, prefix=path + "."))
        else:
            out[path] = val
    if not prefix:
        out = {p: out[p] for p in sorted(out, key=lambda p: p.split("."))}
    return out


def _torch_module_path(flax_modules: list[str]) -> list[str]:
    out = []
    for name in flax_modules:
        m = _BLOCK.match(name)
        cell = _LSTM_CELL.match(name)
        if m:
            out.extend(["blocks", m.group(1)])
        elif cell:
            out.extend(["cells", cell.group(1)])
        else:
            out.append(name)
    return out


def torch_key(path: str) -> str:
    """state_dict key of a dotted Flax leaf path."""
    *mods, leaf = flax_path(path).split(".")
    name = {"kernel": "weight", "scale": "weight", "embedding": "weight",
            "bias": "bias"}.get(leaf)
    if name is None:
        raise KeyError(f"no torch counterpart for Flax leaf {path!r}")
    if len(mods) >= 2 and _LSTM_CELL.match(mods[-2]):
        # an LSTM gate's leaf is a parameter of the cell itself
        return ".".join(_torch_module_path(mods[:-1]) + [f"{mods[-1]}_{name}"])
    return ".".join(_torch_module_path(mods) + [name])


def _to_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.array(leaf, copy=True))


def params_from_flax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax params (nested or flat dotted dict of arrays) -> state_dict."""
    state: dict[str, torch.Tensor] = {}
    for path, leaf in flatten_flax(tree).items():
        t = _to_tensor(leaf)
        if path.rsplit(".", 1)[-1] == "kernel":
            t = t.t()
        state[torch_key(path)] = t.contiguous()
    return state


def _flax_type(mod: nn.Module) -> str:
    """The Flax class name a torch module stands for."""
    if isinstance(mod, nn.Linear):
        return "Dense"
    if isinstance(mod, nn.Conv2d):
        return "Conv"
    return type(mod).__name__


def flax_module_paths(module: nn.Module) -> dict[str, str]:
    """torch submodule path -> dotted Flax module path, for every submodule.

    Containers (``nn.ModuleList``/``nn.Sequential``) are transparent and
    their children are auto-named as Flax names them, ``<Type>_<k>`` with
    k counting the children of that type in the parent, across all its
    containers in registration order (a ``Block`` in ``blocks`` is
    ``Block_<i>``; a list of ``DenseLayer``s and ``Transition``s gives
    ``DenseLayer_0..`` and ``Transition_0..``; a conv is ``Conv_<k>``, a
    linear layer ``Dense_<k>``); any other child keeps its attribute name
    unless its parent's ``FLAX_NAMES`` renames it (``conv1`` ->
    ``ConvBN_0``)."""
    out: dict[str, str] = {}

    def walk(mod: nn.Module, tpath: str, fpath: str) -> None:
        out[tpath] = fpath
        names = getattr(mod, "FLAX_NAMES", {})
        counts: dict[str, int] = {}
        for name, child in mod.named_children():
            tp = f"{tpath}.{name}" if tpath else name
            if isinstance(child, (nn.ModuleList, nn.Sequential)):
                for i, sub in child.named_children():
                    kind = _flax_type(sub)
                    fp = f"{kind}_{counts.get(kind, 0)}"
                    counts[kind] = counts.get(kind, 0) + 1
                    walk(sub, f"{tp}.{i}", f"{fpath}.{fp}" if fpath else fp)
            else:
                fp = names.get(name, name)
                walk(child, tp, f"{fpath}.{fp}" if fpath else fp)

    walk(module, "", "")
    return out


# (Flax collection, Flax leaf) -> (torch attribute, torch -> Flax layout,
# Flax -> torch layout), per module type; conv kernels are (H, W, I, O) in
# Flax and (O, I, H, W) in torch, dense kernels (in, out) and (out, in)
_T = (lambda t: t.t(), lambda t: t.t())
_CONV = (lambda t: t.permute(2, 3, 1, 0), lambda t: t.permute(3, 2, 0, 1))
_ID = (lambda t: t, lambda t: t)


def _leaf_rules(sub: nn.Module) -> dict[tuple[str, str], tuple]:
    from mgwfbp_tpu_torch.models.common import BatchNorm
    from mgwfbp_tpu_torch.models.deepspeech import Lookahead
    from mgwfbp_tpu_torch.models.lstm import GATES, OptimizedLSTMCell

    if isinstance(sub, nn.Linear):
        rules = {("params", "kernel"): ("weight", *_T)}
        if sub.bias is not None:
            rules[("params", "bias")] = ("bias", *_ID)
        return rules
    if isinstance(sub, nn.Conv2d):
        rules = {("params", "kernel"): ("weight", *_CONV)}
        if sub.bias is not None:
            rules[("params", "bias")] = ("bias", *_ID)
        return rules
    if isinstance(sub, nn.LayerNorm):
        return {("params", "scale"): ("weight", *_ID),
                ("params", "bias"): ("bias", *_ID)}
    if isinstance(sub, nn.Embedding):
        return {("params", "embedding"): ("weight", *_ID)}
    if isinstance(sub, OptimizedLSTMCell):
        rules = {}
        for g in GATES:
            rules[("params", f"i{g}.kernel")] = (f"i{g}_weight", *_T)
            rules[("params", f"h{g}.kernel")] = (f"h{g}_weight", *_T)
            rules[("params", f"h{g}.bias")] = (f"h{g}_bias", *_ID)
        return rules
    if isinstance(sub, Lookahead):
        return {("params", "weight"): ("weight", *_ID)}
    if isinstance(sub, BatchNorm):
        return {("params", "scale"): ("weight", *_ID),
                ("params", "bias"): ("bias", *_ID),
                ("batch_stats", "mean"): ("running_mean", *_ID),
                ("batch_stats", "var"): ("running_var", *_ID)}
    if any(True for _ in sub.parameters(recurse=False)):
        raise TypeError(f"no Flax counterpart for module {type(sub).__name__}")
    return {}


def _leaf_map(module: nn.Module) -> dict[tuple[str, str], tuple]:
    """(collection, dotted Flax leaf path) -> (state_dict key, torch ->
    Flax layout, Flax -> torch layout) for every leaf of ``module``."""
    subs = dict(module.named_modules())
    out = {}
    for tpath, fpath in flax_module_paths(module).items():
        for (coll, leaf), (attr, to_flax, to_torch) in _leaf_rules(
            subs[tpath]
        ).items():
            key = f"{tpath}.{attr}" if tpath else attr
            out[(coll, f"{fpath}.{leaf}" if fpath else leaf)] = (
                key, to_flax, to_torch,
            )
    return out


def _nest(flat: Mapping[str, Any]) -> dict[str, Any]:
    tree: dict[str, Any] = {}
    for path, leaf in flat.items():
        *mods, name = path.split(".")
        node = tree
        for part in mods:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree


def flax_leaves(
    module: nn.Module, collection: str = "params"
) -> list[tuple[str, torch.Tensor]]:
    """(dotted Flax path, the module's own tensor) for every leaf of a
    collection, in the order jax flattens the Flax tree (keys sorted at
    every level): the leaf order, and so the leaf indices, of the JAX
    package's gradient pytree."""
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    paths = {
        path: key for (coll, path), (key, _, _) in _leaf_map(module).items()
        if coll == collection
    }
    return [(p, tensors[paths[p]]) for p in flatten_flax(paths)]


def variables_to_flax(module: nn.Module) -> tuple[dict, dict]:
    """(params, batch_stats): the module's parameters and batch statistics
    as nested Flax-form dicts of float32 numpy arrays on the host."""
    state = module.state_dict()
    flat: dict[str, dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for (coll, path), (key, to_flax, _) in _leaf_map(module).items():
        t = to_flax(state[key].detach()).to("cpu", torch.float32)
        # a copy: a CPU module's own storage would change under the caller
        flat[coll][path] = np.array(t.numpy(), copy=True)
    return _nest(flat["params"]), _nest(flat["batch_stats"])


def params_to_flax(module: nn.Module) -> dict[str, Any]:
    """The module's parameters as a nested Flax-form dict of numpy arrays
    (float32 on the host, whatever device the module lives on)."""
    return variables_to_flax(module)[0]


def state_from_flax(
    module: nn.Module,
    params: Mapping[str, Any],
    batch_stats: Optional[Mapping[str, Any]] = None,
) -> dict[str, torch.Tensor]:
    """A state_dict for ``module`` from Flax-form ``params`` (and
    ``batch_stats``), nested or flat dotted dicts of arrays. Every leaf the
    module has must be given and every leaf given must exist: a mismatch
    raises KeyError naming the leaves."""
    rules = _leaf_map(module)
    given = {("params", p): leaf for p, leaf in flatten_flax(params).items()}
    for p, leaf in flatten_flax(batch_stats or {}).items():
        given[("batch_stats", p)] = leaf
    want = set(rules) if batch_stats is not None else {
        k for k in rules if k[0] == "params"
    }
    missing, extra = sorted(want - set(given)), sorted(set(given) - set(rules))
    if missing or extra:
        raise KeyError(
            f"Flax tree does not match {type(module).__name__}: missing "
            f"{missing[:8]}, unexpected {extra[:8]}"
        )
    state = {}
    for k, leaf in given.items():
        key, _, to_torch = rules[k]
        state[key] = to_torch(_to_tensor(leaf)).contiguous()
    return state


def flax_shapes(module: nn.Module,
                collection: str = "params") -> dict[str, tuple]:
    """{dotted Flax path: shape in Flax layout} for every leaf of a
    collection, in Flax's flatten order (no copy: the layout change of a
    view)."""
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    rules = {path: (key, to_flax)
             for (coll, path), (key, to_flax, _) in _leaf_map(module).items()
             if coll == collection}
    return {path: tuple(rules[path][1](tensors[rules[path][0]].detach()).shape)
            for path in flatten_flax(rules)}


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A float32 host copy of ``t`` that nothing else holds (a CPU tensor's
    own storage would change under the caller)."""
    host = torch.empty(t.shape, dtype=torch.float32, device="cpu")
    host.copy_(t)
    return host.numpy()


def host_leaves(module: nn.Module,
                collection: str = "params") -> dict[str, np.ndarray]:
    """{dotted Flax path: float32 host copy in Flax layout} for every leaf of
    a collection, in Flax's flatten order; each layout change is made on
    the module's device before the copy."""
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    rules = {path: (key, to_flax)
             for (coll, path), (key, to_flax, _) in _leaf_map(module).items()
             if coll == collection}
    out = {}
    for path in flatten_flax(rules):
        key, to_flax = rules[path]
        out[path] = _host_copy(to_flax(tensors[key].detach()).contiguous())
    return out


def _param_rules(module: nn.Module) -> dict[str, tuple]:
    """dotted Flax path -> (parameter, torch -> Flax, Flax -> torch), in
    Flax's flatten order."""
    params = dict(module.named_parameters())
    rules = {path: (params[key], to_flax, to_torch)
             for (coll, path), (key, to_flax, to_torch)
             in _leaf_map(module).items() if coll == "params"}
    return {p: rules[p] for p in flatten_flax(rules)}


@torch.no_grad()
def momentum_to_flax(module: nn.Module,
                     optimizer: torch.optim.Optimizer) -> dict[str, np.ndarray]:
    """{dotted Flax path: the parameter's momentum buffer as a float32 host
    copy in Flax layout}, zeros where torch has no buffer yet."""
    out = {}
    for path, (p, to_flax, _) in _param_rules(module).items():
        buf = optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is None:
            out[path] = np.zeros(tuple(to_flax(p.detach()).shape), np.float32)
        else:
            out[path] = _host_copy(to_flax(buf).contiguous())
    return out


@torch.no_grad()
def momentum_from_flax(module: nn.Module, optimizer: torch.optim.Optimizer,
                       trace: Mapping[str, Any]) -> None:
    """Install Flax-layout momentum traces as ``momentum_buffer``s of the
    module's parameters (every parameter must be given)."""
    rules = _param_rules(module)
    missing = sorted(set(rules) - set(trace))
    if missing:
        raise KeyError(f"momentum trace lacks leaves {missing[:8]}")
    for path, (p, _, to_torch) in rules.items():
        buf = to_torch(_to_tensor(trace[path])).to(p.device, p.dtype)
        optimizer.state[p]["momentum_buffer"] = buf.contiguous().clone()
