"""Operator tools of the port: the counterparts of the JAX package's
``tools/`` scripts that read and gate what the port writes, each run as
``python -m mgwfbp_tpu_torch.tools.<name>`` with the JAX tool's flags and
output formats (``telemetry_report``, ``telemetry_merge``,
``autotune_report``, ``an4_report``, ``an4_trainmode_wer``, ``fault_smoke``)
and the pre-PR gate (``check``); ``nojax`` runs a module with JAX and the
JAX package refused. None imports JAX."""
