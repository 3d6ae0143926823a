"""Weight carry-over between Flax parameter trees and PyTorch modules.

A Flax tree is a nested dict of arrays keyed by module and leaf name; the
shard-native checkpoint manifest records each leaf by its path (as
``jax.tree_util.keystr`` writes it, ``['Block_0']['qkv']['kernel']``). Here a
leaf is addressed by the dotted form of that path (``Block_0.qkv.kernel``);
``flax_path`` turns either spelling into the dotted one.

Name and layout rules (Flax -> torch):
  * module ``Block_<i>`` -> ``blocks.<i>``; every other module keeps its name;
  * ``Dense.kernel`` (in, out) -> ``Linear.weight`` (out, in), transposed;
  * ``LayerNorm.scale`` -> ``LayerNorm.weight``;
  * ``Embed.embedding`` (num, d) -> ``Embedding.weight`` (num, d), as is;
  * ``bias`` -> ``bias``.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

_BLOCK = re.compile(r"^Block_(\d+)$")
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
        out.extend(["blocks", m.group(1)] if m else [name])
    return out


def _flax_module_path(torch_modules: list[str]) -> list[str]:
    out: list[str] = []
    i = 0
    while i < len(torch_modules):
        if torch_modules[i] == "blocks" and i + 1 < len(torch_modules):
            out.append(f"Block_{torch_modules[i + 1]}")
            i += 2
        else:
            out.append(torch_modules[i])
            i += 1
    return out


def torch_key(path: str) -> str:
    """state_dict key of a dotted Flax leaf path."""
    *mods, leaf = flax_path(path).split(".")
    name = {"kernel": "weight", "scale": "weight", "embedding": "weight",
            "bias": "bias"}.get(leaf)
    if name is None:
        raise KeyError(f"no torch counterpart for Flax leaf {path!r}")
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


def params_to_flax(module: nn.Module) -> dict[str, Any]:
    """The module's parameters as a nested Flax-form dict of numpy arrays
    (float32 on the host, whatever device the module lives on)."""
    tree: dict[str, Any] = {}
    for mod_name, sub in module.named_modules():
        leaves: dict[str, torch.Tensor] = {}
        if isinstance(sub, nn.Linear):
            leaves = {"kernel": sub.weight.t(), "bias": sub.bias}
        elif isinstance(sub, nn.LayerNorm):
            leaves = {"scale": sub.weight, "bias": sub.bias}
        elif isinstance(sub, nn.Embedding):
            leaves = {"embedding": sub.weight}
        elif any(True for _ in sub.parameters(recurse=False)):
            raise TypeError(
                f"no Flax counterpart for module {mod_name!r} "
                f"({type(sub).__name__})"
            )
        if not leaves:
            continue
        node = tree
        for part in _flax_module_path(mod_name.split(".")):
            node = node.setdefault(part, {})
        for leaf, t in leaves.items():
            node[leaf] = t.detach().to("cpu", torch.float32).contiguous().numpy()
    return tree
