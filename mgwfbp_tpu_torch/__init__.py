"""mgwfbp_tpu_torch: the PyTorch/CUDA port of mgwfbp_tpu for NVIDIA Hopper.

The JAX package (``mgwfbp_tpu``) is the reference; this package mirrors its
module names so each counterpart is easy to find, and never imports JAX,
Flax or anything of ``mgwfbp_tpu`` — where it needs a numpy-only piece of
the reference (the shard-native checkpoint reader), it keeps its own copy.

What is ported so far is the serving path of the transformer LM:

  * ``ops.flashattn`` — flash-attention forward, a hand-written CUDA kernel
    for ``sm_90a`` (``csrc/flash_attn_fwd.cu``) with its plain PyTorch
    version beside it;
  * ``parallel.ringattn.local_attention`` — the dense attention path;
  * ``models`` — ``TransformerLM`` and the model registry;
  * ``convert`` — Flax parameter trees <-> PyTorch state dicts;
  * ``checkpoint`` — the read side of the shard-native checkpoint format
    plus a single-process replicated writer;
  * ``serving`` and ``telemetry.serve`` — hot-reloading ``/predict``.

Entry points take an explicit ``device`` (default ``"cuda"``) and raise when
a card is asked for and none is present; they never fall back to the CPU.
"""

__version__ = "0.1.0"
