"""Operator and measuring tools of the port: the counterparts of the JAX
package's ``tools/`` scripts, each run as ``python -m
mgwfbp_tpu_torch.tools.<name>`` with the JAX tool's flags and output
formats. They read and gate what the port writes (``telemetry_report``,
``telemetry_merge``, ``autotune_report``, ``an4_report``,
``an4_trainmode_wer``, ``fault_smoke``, the pre-PR gate ``check``), or
build steps and time them on the card (``overlap_report``,
``gamma_sensitivity``, ``policy_grid``, ``scaling_efficiency``,
``two_level_validation``, ``input_bench``, ``mfu_ablation``, and
``chip_sequence``, which runs the card legs in order); ``nojax`` runs a
module with JAX and the JAX package refused. None imports JAX."""
