"""Hand-written GPU kernels of the port, each beside its plain PyTorch
version (counterpart of ``mgwfbp_tpu/ops``, the Pallas kernels)."""

from mgwfbp_tpu_torch.ops.flashattn import (
    flash_attention,
    flash_attention_reference,
    flash_supported,
)

__all__ = ["flash_attention", "flash_attention_reference", "flash_supported"]
