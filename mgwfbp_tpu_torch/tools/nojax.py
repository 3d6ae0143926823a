"""Run a module of the port as a machine without JAX would: JAX, Flax,
optax, orbax and the JAX package (``mgwfbp_tpu``) cannot be imported.

    python -m mgwfbp_tpu_torch.tools.nojax <module> [arguments...]

Each refused name is set to None in ``sys.modules`` (Python's own way to
make an import fail with ModuleNotFoundError, and ``importlib.util.
find_spec`` answer None) before ``module`` runs as ``__main__``. It fails
if one of them was imported already, by the port's package on the way in.
The card's machine has no JAX; this makes the same check hold anywhere.
"""

from __future__ import annotations

import runpy
import sys

REFUSED = ("jax", "jaxlib", "flax", "optax", "orbax", "mgwfbp_tpu")


def refuse() -> None:
    """Make every name of ``REFUSED`` fail to import from now on."""
    loaded = [n for n in REFUSED if sys.modules.get(n) is not None]
    if loaded:
        raise SystemExit(f"nojax: already imported: {', '.join(loaded)}")
    for name in REFUSED:
        sys.modules[name] = None  # type: ignore[assignment]


def argv(module: str, *args: str) -> list[str]:
    """The command that runs ``module`` with ``args`` under the refusal."""
    return [sys.executable, "-m", "mgwfbp_tpu_torch.tools.nojax", module,
            *args]


def main(args=None) -> int:
    args = list(sys.argv[1:] if args is None else args)
    if not args:
        raise SystemExit("usage: python -m mgwfbp_tpu_torch.tools.nojax "
                         "<module> [arguments...]")
    refuse()
    sys.argv = list(args)
    runpy.run_module(args[0], run_name="__main__", alter_sys=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
