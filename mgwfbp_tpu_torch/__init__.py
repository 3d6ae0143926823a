"""mgwfbp_tpu_torch: the PyTorch/CUDA port of mgwfbp_tpu for NVIDIA Hopper.

The JAX package (``mgwfbp_tpu``) is the reference; this package mirrors its
module names so each counterpart is easy to find, and never imports JAX,
Flax or anything of ``mgwfbp_tpu`` — where it needs a numpy-only piece of
the reference (the shard-native checkpoint reader), it keeps its own copy.

What is ported so far:

  * serving the transformer LM: ``ops.flashattn`` (flash-attention
    forward, a hand-written CUDA kernel for ``sm_90a`` in
    ``csrc/flash_attn_fwd.cu``, with its plain PyTorch version beside it;
    a backward through it raises), ``parallel.ringattn.local_attention``,
    ``models.transformer``, ``serving`` and ``telemetry.serve``
    (hot-reloading ``/predict``);
  * training the CIFAR ResNets with MG-WFBP: ``config``, ``data``,
    ``optim``, ``models.resnet_cifar``, ``parallel.{costmodel,solver}``
    (the merge solver), ``parallel.{buckets,allreduce}`` (one
    ``dist.all_reduce`` per merge group, launched from gradient hooks),
    ``parallel.mesh``, ``profiling``, ``train`` and ``train_cli``;
  * the language models (``models.lstm``, ``data.ptb``), and the ImageNet
    ResNets (``models.resnet_imagenet``, the ``imagenet`` data) at float32
    or bfloat16 (the mixed-precision policy of ``train.step``);
  * ``calibrate``, trace attribution and the event stream (``telemetry``);
    ``bench`` (the merge-policy grid on the card, one JSON line);
  * ``convert`` (Flax parameter and batch-statistics trees and the
    optimizer's momentum <-> PyTorch state dicts and ``momentum_buffer``s)
    and ``checkpoint`` (the shard-native format: the JAX package's
    ``Checkpointer`` with its async writer, sidecar index and GC);
  * resumable training: resume, the SIGTERM/SIGINT drain (rc 75),
    rollback after bad steps, ``--pretrain`` (``train``), the fault plan
    (``utils.faults``), agreement over a gloo side group
    (``runtime.coordination``) and the offline evaluator (``evaluate``);
  * supervision (``runtime.supervisor``, ``utils.watchdog``) and the
    telemetry plane: /metrics, /healthz, /status, /profile and
    /postmortems (``telemetry.serve``, ``telemetry.export``), the fleet
    fan-in (``telemetry.fleet``), drift, straggler and health alarms
    (``telemetry.drift``, ``telemetry.health``), the flight recorder
    (``telemetry.recorder``), the shadow scorer (``serving.shadow``) and
    the scalar stream (``utils.summary``).

Entry points take an explicit ``device`` (default ``"cuda"``) and raise when
a card is asked for and none is present; they never fall back to the CPU.
"""

__version__ = "0.1.0"
