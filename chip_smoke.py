"""Chip smoke for the PyTorch/CUDA port (mgwfbp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Phases, each of which fails the run (non-zero exit, no result line):

  1. build every CUDA kernel of the port from csrc/ (one nvcc per source,
     all started together) and print the build time;
  2. hold each kernel against its plain PyTorch version on the card, at the
     serving shape (through strided views of a fused qkv tensor, as the
     transformer hands them over), at the long-context shapes, at the
     largest D, and on views that take the kernel's misaligned load path,
     with TF32 off; time the kernel (back-to-back calls by CUDA events;
     device time per launch by torch.profiler; the wrapper's host time per
     call on the host clock), the plain version and one PyTorch library
     call computing the same function (a yardstick only; the port never
     calls it);
  3. drive the serving path a user would run: the registered full-width
     transformer (vocab 10000, d_model 256, 4 heads, 4 layers) behind
     ServePlane + TelemetryServer, hot-reloading a checkpoint committed by
     save_replicated_step; POST /predict three requests of 1, 2 and 3
     examples, check each answer (200, served step, shape, finite, equal to
     a dense forward of the same weights), check that the flash kernel was
     launched num_layers times per flush; POST one request with token ids
     outside the vocabulary (answered 200, NaN rows where the ids fall
     outside [-V, V), as the JAX package answers) and check that the next
     answer still equals the dense forward; then commit step 2 and check
     that the next answer reports it and differs;
  4. drive the training path a user would run, full-width ResNet-20 at
     the per-worker batch 32 on synthetic CIFAR-10:
     (a) the Trainer at one worker, policy auto, TRAIN_STEPS steps, one
         evaluate and the epoch's commit: the loss of the last 5 steps
         falls below the first 5's, eval is finite, the committed step
         reads back equal to the live parameters; then the step time (CUDA
         events, median of 20) and torch.profiler's busy share;
     (b) the merged all-reduce at one worker over NCCL, policy mgwfbp on a
         tb the hooks measure on the card, on the ici prior (one leaf per
         group) and on MERGING_LINK (which must merge leaves): each of
         REDUCER_STEPS steps launches num_groups all-reduces in group
         order and its reduced gradients equal, bit for bit, a copy taken
         before the reduction; the hooks' arrival order is printed beside
         the reducer's permutation;
         Two more steps of each run are traced (profiling.
         trace_group_times): per-group device times, or None and why;
     (c) two processes on the one card over gloo, GLOO_STEPS steps of
         mgwfbp on each of GLOO_LINKS: merged gradients equal the
         leaf-by-leaf all_reduce and both ranks' parameters are identical,
         bit for bit, every step; then a few unchecked steps timed, and
         telemetry.overlap.summarize of that reducer at that step time;
     (d) calibration on the card: ``mgwfbp_tpu_torch.calibrate
         --prior-extend 56GbIB`` at one worker over NCCL and ``--forward
         --model resnet20``, both read back and checked (the card's name
         in meta, gamma >= 0, pack_beta > 0, overlap in [0, 1], tb and tf
         finite from hooks); ResNet-20's schedule solved on that profile at
         1 and 16 workers beside (b)'s prior-based ones;
  5. (e) train the language models a user would train, each at full width
     through the Trainer on synthetic PTB, with TF32 off: the PTB LSTM
     (vocab 10000, hidden 1500, 2 layers, window 35, batch 20, its BPTT
     carry) and the transformer (d_model 256, 4 heads, 4 layers, window 64,
     batch 16, dense attention as the JAX package trains it). For each:
     LM_STEPS steps (LM_EPOCHS epochs of the first LM_EPOCH_STEPS batches;
     the PTB loader does not shuffle, so later epochs see the same text)
     whose last 5 losses fall below the first 5's; one evaluate (finite
     loss and perplexity); the commit read back equal to the live
     parameters; one window of the card's logits and carry against the
     same weights on the CPU (LM_WINDOW_TOL); no flash launch during
     training; then the step time (CUDA events, median of 20 after 5),
     tokens/s, torch.profiler's busy share and kernels per step, tb from
     the hooks and the mgwfbp groups it gives at 1 worker (ici) and on
     MERGING_LINK, and for the LSTM where the hooks put the embedding's
     gradient against where the arrival permutation puts it.
  6. (f) train the bench model a user would train: ResNet-50 at full width
     (224 x 224, 1000 classes) on synthetic ImageNet without augmentation,
     through the Trainer at bfloat16 (``--dtype bfloat16``), batch 128 (64
     on an out-of-memory error, printed): RESNET50_STEPS steps whose last 5
     losses fall below the first 5's, one evaluate, the commit read back
     equal to the live parameters and batch statistics, one batch of the
     card's bfloat16 logits against the same weights at float32
     (RESNET50_BF16_TOL), the committed checkpoint served through /predict
     against a float32 forward (RESNET50_SERVE_TOL), no flash launch; then
     the step time (median of 20 after 5), images/s, the float32 step at
     the same batch, torch.profiler's busy share, kernels per step and the
     shares of device time in convolutions, layout transposes and
     batch-norm statistics; last, the bench grid (``mgwfbp_tpu_torch.bench``)
     at RESNET50_BENCH_ITERS iterations.
  7. (g) resumable training on the card:
     (g1) the full PTB LSTM (66,022,000 parameters, 20 x 35, float32)
         through ``python -m mgwfbp_tpu_torch.train_cli`` with
         ``--checkpoint-dir --ckpt-every-steps 5 --deterministic``
         (``CUBLAS_WORKSPACE_CONFIG=:4096:8``), 2 epochs of 15 steps: run A
         uninterrupted; run B with ``MGWFBP_FAULT_PLAN=preempt@step=12``
         (rc 75 and its ``preempted`` line), relaunched with the same
         command (a ``resume`` event with ``mid_epoch``), sent a real
         SIGTERM after its first resumed step (rc 75 again), relaunched to
         the end; B's committed params and carry at step 30 against A's,
         bitwise when no op warned that it is not deterministic, else no
         further than a second run of A. Measured: the relaunch to the
         first resumed step (with the start-up phases from the log) and the
         SIGTERM to the exit;
     (g2) ResNet-50 at bfloat16, batch 128, one Trainer with
         ``MGWFBP_FAULT_PLAN=nan@step=4,count=3`` and ``bad_step_limit`` 3:
         a boundary checkpoint at step 2 (one synchronous save, timed, its
         bytes), three ``bad_step`` events, one ``rollback`` to step 2, a
         finite loss; then the interval between step starts over 20 steps
         without checkpoints and 20 with ``--ckpt-every-steps 5`` (async),
         both through the default prefetch (2 workers), and 20 without
         checkpoints through the bare loader (``MGWFBP_DATA_WORKERS=0``),
         and each async save's span and bytes;
     (g3) ``python -m mgwfbp_tpu_torch.evaluate`` on run A's last epoch:
         its perplexity against A's own evaluation (RES_EVAL_RTOL).
  8. (h) the paper's CNN zoo a user would train, each at full width with
     its preset (ZOO): googlenet (224, aux heads), inceptionv4 (299) and
     densenet201 (604 leaves) at batch 64 in bfloat16 on synthetic
     ImageNet, vgg16 at batch 128 in float32 on synthetic CIFAR-10; each
     through the Trainer with its step swapped for one carrying the mgwfbp
     merged all-reduce over NCCL at one worker (tb from the trainer's
     hooks, MERGING_LINK's constants): ZOO_WARMUP_STEPS steps through the
     trainer's own loop, then ZOO_TIMED_STEPS on one device batch (CUDA
     events, median) after 3 more, each launching num_groups all-reduces
     with every leaf's hook firing once; torch.profiler's busy share and
     kernels per step; the groups held back by the strict group order for
     the merged schedule and for one leaf per group; peak memory; the
     first and last loss, all finite; the card's float32 eval forward of
     the trained weights against the same weights converted into a CPU
     module (ZOO_CPU_TOL); no flash launch. One ``{"zoo": ...}`` line per
     model.
  9. (i) the speech model a user would train: ``lstman4`` at full width
     (DeepSpeech, hidden 800, 5 layers + Lookahead, 27,553,504
     parameters) with its preset (batch 4, float32, TF32 off) on the real
     AN4 utterances of data/an4_memcheck, through the Trainer (default
     prefetch, the native host library, which must build and load) with
     its step swapped for the mgwfbp merged all-reduce over NCCL at one
     worker as in (h): AN4_EPOCHS epochs of 11 steps whose last 5 losses
     fall below the first 5's; one evaluate (finite CTC loss, a WER) equal
     to ``python -m mgwfbp_tpu_torch.evaluate`` on the committed step; the
     commit read back equal; every val batch's card logits against a CPU
     module (AN4_CPU_TOL) and how many utterances decode alike; no flash
     launch; then the step time, utterances/s, busy share, kernels per
     step, peak memory, top kernels, groups and held groups.
 10. (j) supervision, every run launched as a user launches it, through
     ``python -m mgwfbp_tpu_torch.runtime.supervise`` (float32, TF32 off,
     ``--deterministic``, fresh checkpoint directories):
     (j1) full-width ResNet-20 at its preset batch, one process on the
         card with the live plane (``MGWFBP_METRICS_PORT=0``), healed from
         SUP_PLAN: a preemption (rc 75, resubmitted), a SIGKILL in
         incarnation 1 (oom_kill, relaunched at one process) and a wedge in
         incarnation 2 (the liveness monitor's verdict after SUP_GRACE_S,
         SIGTERM, drain, relaunch): four incarnations, the failure and
         heal events in order in the supervisor's stream, and the final
         commit equal bit for bit to an uninterrupted run of the same
         command; measured: each exit to the next incarnation's first
         step (with the relaunch's log marks) and the wedge to the verdict;
     (j2) the same model under ``stall@secs=60,step=5`` with
         ``MGWFBP_WATCHDOG_S`` 5 and ``MGWFBP_WATCHDOG_ABORT=1``, after
         removing the native library (the child rebuilds it at its first
         batch, under the first-step allowance): the stack dump in the
         child's log, /healthz 503 before the exit, a ``watchdog_stall``
         event, rc 86 from the child and the supervisor; measured: the
         stall to the event and to the first 503;
     (j3) a supervised 2-process gloo group on the CPU commits ResNet-20
         under its n2 tag (XW_TRAIN_N images, 8 steps an epoch); a world-1
         Trainer on the card with ``MGWFBP_ELASTIC_RESUME=1`` reads it (the
         iteration, the parameters bit for bit, the next LR on the
         continued schedule at 16 steps an epoch); then the same command
         at one process on the card: a ``resize`` event 2 -> 1 and its
         restore time, training to the end with a finite loss;
     (j4) the transformer trained by a supervised process on the card
         (dense attention) beside ``--serve-replicas 1``: the replica's
         /predict through the flash kernel against a dense forward of the
         served step (LOGITS_TOL), the replica SIGKILLed, respawned by the
         supervisor and answering again, its flash launches in each life
         (read from its /status);
     (j5) ResNet-20's step with the watchdog armed and without (one device
         batch, CUDA events, medians of 20 after 5, interleaved) and the
         /status scrape's latency on a live trainer.
 11. (k) the telemetry plane on the card:
     (k1) full-width ResNet-20 through ``supervise --processes 1
         --fleet-port 0`` with the live plane (``--metrics-port 0``, health
         statistics on) under ``nan@step=4`` and two stalls that hold the
         run: /profile?steps=3 armed during the first, its result (a Chrome
         trace on disk, the attribution); during the second, /metrics
         parsed by the port's ``parse_metrics_text`` against the stream's
         step records (the steps counter, the window's steps, the bad step,
         the health gauge), /postmortems and the NaN step's bundle read
         back; one ``health`` record per step;
     (k2) the health statistics' cost: ResNet-20 (batch 32, float32) and
         ResNet-50 (batch 128, bfloat16) steps with and without them
         (medians of 20, interleaved twice), and ``cudaStreamSynchronize``
         calls and device-to-host copies per step by torch.profiler, which
         must be equal;
     (k3) (in phase 3) the flash-serving process's /metrics: its reload
         and request counters and served step;
     (k4) ``python -m mgwfbp_tpu_torch.serving --shadow`` serving ResNet-20
         on the card: its ``shadow_eval`` record against the CPU scorer on
         the same weights (SHADOW_TOL), and the card scorer's time;
     (k5) the supervisor's /fleet/status (the child reachable at the held
         step) and /fleet/metrics (every series in the registry).
 12. (l) the single-level lowerings of the merged collectives on the card
     (full-width ResNet-20, batch 32, float32, policy mgwfbp on the 10GbE
     constants at 2 workers: 7 groups; cuDNN's deterministic algorithms):
     (l1) one rank over NCCL (set up as (b)), LOWER_STEPS steps of each of
         all_reduce, rs_ag, rs_opt_ag (SGD momentum 0.9, weight decay
         1e-4), both again with the norm clip, and top-k at density 0.01,
         through ``make_merged_allreduce`` and ``TrainStep``: rs_ag's
         reduced gradients equal the all_reduce of the same gradients bit
         for bit; rs_opt_ag's own trajectory through ``TrainStep`` ends
         within LOWER_RTOL of the replicated ``torch.optim.SGD``
         parameters, and with the clip so does rs_opt_ag on the
         replicated run's recorded gradients (each trajectory's forward
         amplifies the clip's one-rounding difference: the clipped
         trajectories are read); top-k's dense result equals
         the plain CPU top-k of the same buckets; each run's collectives
         per step, step time (median) and per-group device time
         (``trace_group_times`` over 2 traced steps), the optimizer-state
         bytes, and ``profile_update_beta`` on the card;
     (l2) two processes on the card over gloo (the card's gloo takes CUDA
         tensors for reduce-scatter and all-gather), LOWER_GLOO_STEPS
         steps of each lowering: both ranks' parameters bit-identical after
         every step, rs_opt_ag within LOWER_RTOL of all_reduce + SGD, its
         optimizer state per rank half the replicated bytes plus the pad;
     (l3) ``python -m mgwfbp_tpu_torch.train_cli --dnn resnet20 --comm-op
         rs_opt_ag`` for LOWER_CLI_STEPS steps: the world-1 fallback (the
         replicated optimizer) logged and the loss falling; beside it
         ``--compressor topk --density 0``: no density is chosen at one
         worker (no reducer, the JAX trainer's rule), and what the chooser
         picks for ResNet-20 on two links is printed. Both start with
         (l2) and run beside it (neither (l2) nor (l3) times anything it
         checks);
 13. (m) the cross-step and two-level lowerings: rs_fwd_ag against
     rs_opt_ag at one rank over NCCL, hier at HIER_WORLD gloo ranks on the
     card, ``train_cli --comm-op rs_fwd_ag`` (started with the hier ranks
     and run beside them) and an all_reduce restore of its step
     (``phase_cross_step``).
 14. (n) closed-loop schedule autotuning, ``train_cli --dnn resnet20
     --synthetic --autotune --autotune-steps 3`` at full width (float32,
     batch 32, the 10GbE constants at 2 workers) in AT_WORLD gloo
     processes sharing the card (NCCL takes one rank a card):
     (n1) the race: the schedule verifier counts every collective of each
         candidate's observed step, the incumbent's included (the hooks
         run on autograd's device thread), every raced entry is verified,
         both ranks commit the same winner and end with the same
         parameters, and the race's loss falls; each candidate's measured
         and predicted step, the refit and the race's seconds printed;
     (n2) the same command again: a cache hit of (n1)'s winner, no race;
         the seconds to the first step against (n1)'s printed;
     (n3) a profile whose alpha and beta are AT_MISCALIBRATION times
         (d)'s: the race's winner against the schedule solved on (d)'s
         constants in interleaved windows (a reading, not a check);
     no flash launch in any run.
 15. (o) the static analysis of the port on the card's machine:
     (o1) ``python -m mgwfbp_tpu_torch.analysis --device cuda --json``: the
         lint, race, lockstep and annotation passes over the port's tree
         and the step pass observing LeNet steps of every policy and
         lowering at 2 gloo ranks sharing the card; exit 0; then each
         static pass again in this process, timed (the step pass's
         seconds: the CLI's less theirs), and the findings by family
         (suppressed ones counted apart);
     (o2) one LeNet step at one worker on the card, observed: a gradient
         hook that calls ``.item()`` gives SCH005 on autograd's device
         thread; the clean step gives no finding and no synchronisation,
         and ``torch.cuda.set_sync_debug_mode("warn")`` reports none for
         it.

 16. (p) sequence parallelism (``phase_seq``): SEQ_WORLD gloo processes
     sharing the card form one ring (NCCL takes one rank a card; gloo's
     point-to-point takes host tensors, so the ring stages K/V through the
     host), the full-width transformer (vocab 10000, d_model 256, 4 heads,
     4 layers, d_ff 1024):
     (p1) ``ring_attention`` on each rank's time slice of seeded (16, 64,
         4, 64) float32 tensors, causal, and its q, k, v gradients, against
         ``local_attention`` on the whole sequence (SEQ_TOL); 2 (S - 1)
         point-to-point operations each way;
     (p2) ``train_cli --seq-parallel 2``'s Trainer: one step (dropout off,
         a constant rate) against a world-1 dense step on the gathered
         global batch (SEQ_STEP_RTOL, relative L2 of the parameters); then
         the user's command (the preset: window 64, batch 16, policy auto)
         for SEQ_STEPS steps and its evaluation: the median step, the
         ring's point-to-point operations per step (2 (S - 1) per layer,
         forward and backward), the groups and those held back, no flash
         launch;
     (p3) one ``TrainStep`` at SEQ_LONG_T tokens and batch SEQ_LONG_BATCH:
         each rank's peak memory over the model and its median step on the
         ring, against the whole window through ``local_attention`` in
         this process alone (seq 1). Every number beside the card's name
         and power limit (the line before the kernels line).

 17. (q) the zero-sync step loop (``phase_zero_sync``): the step decides
     its non-finite guard on the card and reads nothing back; the trainer
     reads each step's metrics late:
     (q1) full-width ResNet-20, batch 32, through its Trainer: ZS_STEPS
         steps under ``HostObserver`` and ``torch.cuda.set_sync_debug_mode
         ("warn")``, which must see no synchronisation; the step's median
         with a synchronisation after each (the earlier phases' step_ms),
         the mean of ZS_STEPS back-to-back steps, the busy share of a
         profiled back-to-back window, and the trainer loop's ms per step
         over a ZS_LOOP_STEPS-step epoch;
     (q2) ``MGWFBP_FAULT_PLAN=nan@step=3`` at
         ``MGWFBP_GUARD_CHECK_INTERVAL=5`` over ZS_NAN_STEPS steps: one
         ``bad_step`` at step 3, the counter at ZS_NAN_STEPS - 1, finite
         parameters, at most ceil(steps / 5) + 1 reads in the epoch;
     (q3) the preset transformer (window 64, batch 16): (q1)'s checks and
         timings;
     (q4) the bench's ResNet-50 ``none`` row (batch 128, bfloat16, 10
         timed steps) with ``MGWFBP_BN_DTYPE`` unset and ``bfloat16``,
         interleaved twice;
     (q5) ``MGWFBP_BN_DTYPE=bfloat16`` in a float32 ResNet-20 (batch 32):
         the training batch norm's own forward and backward
         (``models.common._StatDtypeNorm``) on the card against the same
         step on the CPU: the loss at 2e-2, every gradient finite, the
         gradient's cosine with the CPU's at least ZS_BN_COS (the card's
         own noise beside it), and the step's ms against the variable
         unset. A ``{"zero_sync": ...}`` line with the card's name and
         power limit.
 18. (s) the measuring tools on the card (``phase_measure``), each in a
     subprocess under ``tools.nojax``, all started together but (s5)'s
     steps, which start once its files are written (the tools' times are
     taken beside each other's):
     (s1) ``overlap_report``, ResNet-20 b32 at one worker, two traced
         steps: the parse finds the card's compute kernels, no collective
         kernel (NCCL launches none over one rank) and one prediction per
         group;
     (s2) ``gamma_sensitivity`` on the card's tb and (d)'s profile (kept
         aside by ``_keep``): the 1.0x row's groups equal
         ``build_schedule(policy="auto")`` on the same tb in this process;
     (s3) ``policy_grid`` at MEASURE_WORLD gloo ranks sharing the card
         (``--backend gloo``): each policy's groups equal its solve on the
         grid's tb, and the noise pair is there (the machinery, not a link);
     (s4) ``scaling_efficiency`` at world 1 with predictions at (d)'s
         extents, each labelled with the card's name, every efficiency in
         (0, 1];
     (s5) ``input_bench --make-data --imagenet-n 256`` (the CIFAR leg must
         run; the HDF5 leg fails naming h5py where it is missing, and the
         line says which legs ran), then ResNet-20 over the three loader
         legs: both throughput ratios finite;
     (s6) ``mfu_ablation`` at MEASURE_MFU_ITERS timed steps: all five
         ResNet-50 rows, ``baseline_b128``'s FLOPs equal to
         ``bench.flops_per_step`` in this process, ``batch_64``'s half of
         them (relative MEASURE_FLOPS_RTOL), every MFU in (0, 1].
     A ``{"measure": ...}`` line with each check's numbers and each
     tool's rc and seconds.
 19. (r) the operator tools on the card (``phase_tools``), each in a
     subprocess under ``mgwfbp_tpu_torch.tools.nojax`` (JAX, Flax, optax,
     orbax and the JAX package refused):
     (r1) ``telemetry_report`` on (j3)'s process-0 stream (two gloo
         processes, so it holds an overlap snapshot) with
         ``--chrome-trace`` and ``--prometheus``: rc 0, one table row per
         group of the stream's latest snapshot, a trace that parses and a
         Prometheus dump that ``parse_metrics_text`` reads; and on (k)'s
         stream, written by the card's trainer: rc 0;
     (r2) ``telemetry_merge --out`` on (j3)'s two streams: one monotonic
         timeline and one table row per process;
     (r3) ``autotune_report`` on (n)'s cache entry: the winner and every
         raced label;
     (r4) the fault smoke's single-process lifecycle with ``--device
         cuda`` (skipped when less than FAULT_NEED_S of the smoke's 1200 s
         are left; the line says so).
     A ``{"tools": ...}`` line with each tool's rc and seconds and the
     phase's seconds.

Every phase runs with TF32 off (``utils.device.set_matmul_precision``).

Output, last lines: a JSON line each for the phase-2 shape table, the
serving forward's breakdown (host time of one flush's run_padded, device
time by kernel from torch.profiler), the /predict latencies, the training
phase ({"train": ...}), the calibration phase ({"calibrate": ...}), the
language models ({"lm": ...}), the bench payload ({"bench": ...}), ResNet-50
({"resnet50": ...}), resumable training ({"resilience": ...}), the zoo's
summary ({"zoo_summary": [...]}; each model's full line is printed as it
finishes), the speech model ({"lstman4": ...}), supervision
({"supervise": ...}), the telemetry plane ({"telemetry": ...}), the
lowerings ({"lowerings": ...}), the cross-step and two-level lowerings
({"cross_step": ...}), autotuning ({"autotune": ...}), the static
analysis ({"analysis": ...}), sequence parallelism ({"seq": ...}), the
zero-sync loop ({"zero_sync": ...}), the measuring tools ({"measure":
...}), each phase's seconds ({"phase_seconds": ...}), the tools
({"tools": ...}), the
card's name
and power limit
(nvidia-smi), the kernels line
({"kernels": [...]}) and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# tolerances of tests/test_flashattn.py: float32 2e-5; bfloat16 2e-2, compared
# in bfloat16 (the output type) after both versions round to it
F32_TOL = 2e-5
BF16_TOL = 2e-2
# served logits (flash kernel) vs a dense forward of the same weights: the
# two attention orders differ by float32 rounding, which four residual
# layers and a 10000-way head carry into logits of magnitude ~1-10
LOGITS_TOL = 1e-4

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): device memory rate and
# the arithmetic rate for the type the work is done on. The kernel computes
# float32 attention on the tensor cores as 3xTF32 (three TF32 products per
# float32 product, to keep float32 accuracy), so its float32 peak is a third
# of the 495 TFLOP/s TF32 rate; the 67 TFLOP/s of float32 outside the tensor
# cores is no longer the least time the card could take.
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}

F32, BF16 = torch.float32, torch.bfloat16
KERNEL_SHAPES = [
    # (B, T, H, D), causal, dtype, layout: "qkv" = strided views of one
    # fused (B, T, 3 H D) tensor, as the transformer passes them; "shifted"
    # = views one element off 16-byte alignment (the misaligned load path)
    ((8, 35, 4, 64), True, F32, "qkv"),  # the serving shape
    ((8, 35, 4, 64), True, BF16, "qkv"),
    ((1, 128, 4, 64), True, F32, "contiguous"),
    ((1, 128, 4, 64), False, F32, "contiguous"),
    ((1, 1024, 4, 64), True, F32, "contiguous"),
    ((1, 1024, 4, 64), False, F32, "contiguous"),
    ((1, 4096, 4, 64), True, F32, "contiguous"),  # the model's max_len
    ((1, 4096, 4, 64), False, F32, "contiguous"),
    ((2, 256, 4, 256), True, F32, "contiguous"),  # the contract's largest D
    ((2, 65, 4, 64), True, F32, "contiguous"),  # one row past a tile
    ((2, 100, 3, 33), True, F32, "contiguous"),  # odd D: misaligned path
    ((8, 35, 4, 64), True, F32, "shifted"),
    ((1, 1024, 4, 64), True, BF16, "contiguous"),
    ((1, 4096, 4, 64), True, BF16, "contiguous"),
    ((2, 256, 4, 256), True, BF16, "contiguous"),
    ((8, 35, 4, 64), True, BF16, "shifted"),
]
SERVE_SHAPE = KERNEL_SHAPES[0]
REQUEST_SIZES = (1, 2, 3)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def time_ms(fn, target_s: float = 0.25, max_iters: int = 200) -> float:
    """Mean device time of fn() in ms, by CUDA events over a run of calls
    sized to about target_s, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = max(time.perf_counter() - t0, 1e-6)
    iters = int(min(max_iters, max(3, target_s / once)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(shape, causal: bool, dtype) -> tuple[float, str]:
    """Least time (ms) the card could take for one attention forward:
    q, k, v read once and o written once over the memory rate, against
    the two products' multiply-adds (4 D flops per visible (query, key)
    pair) over the peak rate for the inputs' type (PEAK_FLOPS)."""
    b, t, h, d = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * b * t * h * d * itemsize
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4 * d * pairs * b * h
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def phase_build() -> None:
    from mgwfbp_tpu_torch.ops import _build

    t0 = time.perf_counter()
    try:
        results = _build.build()
    except RuntimeError as e:
        fail(str(e))
    total = time.perf_counter() - t0
    for r in results.values():
        regs = [ln.strip() for ln in r.log.splitlines() if "registers" in ln]
        print(f"built {r.name} in {r.seconds:.2f}s -> {r.path}")
        for ln in regs:
            print(f"  ptxas: {ln}")
    print(f"build phase: {total:.2f}s for {len(results)} kernel(s)", flush=True)


def make_inputs(shape, dtype, layout: str, gen: torch.Generator):
    """q, k, v on the card, from the generator, in the given layout."""
    b, t, h, d = shape
    if layout == "qkv":
        qkv = torch.randn((b, t, 3 * h * d), generator=gen).to("cuda", dtype)
        return [x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=-1)]
    if layout == "shifted":
        n = b * t * h * d
        return [
            torch.randn(n + 1, generator=gen).to("cuda", dtype)[1:].view(shape)
            for _ in range(3)
        ]
    return [torch.randn(shape, generator=gen).to("cuda", dtype) for _ in range(3)]


def host_us(fn, calls: int = 100) -> float:
    """The host's time per call of fn, in µs: the enqueue alone, on the
    host clock, with no synchronisation inside the run of calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def device_us(fn, name: str, calls: int = 20):
    """Device time per call of the kernels whose name contains `name` (all
    of the call's kernels for ""), in µs, from torch.profiler over `calls`
    calls; a string saying why where the profiler records no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key
    )
    if total <= 0:
        return "not measured (the profiler recorded no device time)"
    return total / calls


def phase_kernels(gen: torch.Generator) -> list[dict]:
    import torch.nn.functional as F

    from mgwfbp_tpu_torch.ops import flashattn as fa
    from mgwfbp_tpu_torch.parallel.ringattn import local_attention

    rows = []
    for shape, causal, dtype, layout in KERNEL_SHAPES:
        q, k, v = make_inputs(shape, dtype, layout, gen)
        aligned = fa.aligned_path(q, k, v)
        if aligned != (layout != "shifted" and shape[3] % 4 == 0):
            fail(f"{layout} views at {shape} {dtype} chose aligned={aligned}")
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_reference(q, k, v, causal=causal)
        dense = local_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            fail(f"flash kernel produced non-finite values at {shape}")
        err = (got.float() - want.float()).abs().max().item()
        dense_err = (got.float() - dense.float()).abs().max().item()
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        if err > tol or dense_err > tol:
            fail(
                f"flash kernel disagrees at {shape} causal={causal} {dtype} "
                f"{layout}: max |kernel - plain| {err:.3e}, |kernel - dense| "
                f"{dense_err:.3e} > {tol}"
            )
        # the library's kernels fault on views off 16-byte alignment: the
        # yardstick takes aligned copies of them
        qt, kt, vt = (
            (x if aligned else x.clone()).transpose(1, 2) for x in (q, k, v)
        )

        def kernel():
            return fa.flash_attention(q, k, v, causal=causal)

        kernel_ms = time_ms(kernel)
        dev_us = device_us(kernel, "flash_")
        wrapper_us = host_us(kernel)
        plain_ms = time_ms(
            lambda: fa.flash_attention_reference(q, k, v, causal=causal),
            max_iters=20,
        )

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        library_ms = time_ms(library)
        library_dev_us = device_us(library, "")
        bound_ms, bound_by = attention_bound(shape, causal, dtype)
        rows.append({
            "shape": list(shape), "causal": causal,
            "dtype": str(dtype).replace("torch.", ""), "layout": layout,
            "path": "aligned" if aligned else "misaligned",
            "max_abs_err": err, "max_abs_err_vs_dense": dense_err,
            "ms": kernel_ms, "device_us": dev_us, "host_us": wrapper_us,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_us": library_dev_us,
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        dev, lib = (
            f"{x:.2f}" if isinstance(x, float) else x
            for x in (dev_us, library_dev_us)
        )
        print(
            f"flash {shape} causal={causal} {dtype} {layout} "
            f"({rows[-1]['path']} path): err {err:.2e} (dense "
            f"{dense_err:.2e}) kernel {kernel_ms:.4f} ms, device {dev} us "
            f"per launch, wrapper host {wrapper_us:.2f} us per call, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (device {lib} us), bound "
            f"{bound_ms:.5f} ms ({bound_by})", flush=True,
        )
    return rows


def _post(port: int, inputs: list) -> tuple[int, dict, float]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict",
        data=json.dumps({"inputs": inputs}).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            code, body = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return code, json.loads(body.decode()), time.perf_counter() - t0


def phase_serve(gen: torch.Generator) -> tuple[int, list[dict]]:
    from mgwfbp_tpu_torch import models
    from mgwfbp_tpu_torch.checkpoint import save_replicated_step
    from mgwfbp_tpu_torch.convert import params_from_flax, params_to_flax
    from mgwfbp_tpu_torch.models.transformer import TransformerLM, init_weights
    from mgwfbp_tpu_torch.ops import flash_attention
    from mgwfbp_tpu_torch.serving.model import ServingModel
    from mgwfbp_tpu_torch.serving.plane import ServePlane
    from mgwfbp_tpu_torch.telemetry.serve import MetricsAggregator, TelemetryServer

    module, meta = models.create_model("transformer")
    if module.attn_impl != "flash":
        fail("the registered transformer does not serve through flash attention")
    print(
        f"serving {meta.name}: vocab {module.vocab_size}, d_model "
        f"{module.d_model}, heads {module.num_heads}, layers "
        f"{module.num_layers}, d_ff {module.d_ff}, max_len {module.max_len}, "
        f"input {meta.input_shape}", flush=True,
    )
    params1 = params_to_flax(init_weights(module, gen))
    rng = np.random.RandomState(0)
    examples = rng.randint(
        0, meta.num_classes, (sum(REQUEST_SIZES),) + tuple(meta.input_shape)
    ).astype(np.int32)

    def dense_logits(params) -> np.ndarray:
        ref = TransformerLM(vocab_size=meta.num_classes, attn_impl="dense")
        ref.load_state_dict(params_from_flax(params))
        ref.to("cuda").eval()
        with torch.inference_mode():
            return ref(torch.from_numpy(examples).cuda()).float().cpu().numpy()

    want1 = dense_logits(params1)
    latencies = []
    with tempfile.TemporaryDirectory(prefix="mgwfbp_chip_smoke_") as ckpt:
        save_replicated_step(ckpt, 1, params1)
        model = ServingModel(module, meta, device="cuda")
        agg = MetricsAggregator(run={"role": "serve", "dnn": meta.name})
        server = TelemetryServer(agg, 0)
        plane = ServePlane(model, ckpt, emit=agg.observe, server=server)
        try:
            plane.start()
            if plane.poll_now() != 1 and model.served_step() != 1:
                fail("step 1 was not installed")
            batches0 = plane.service.stats()["batches"]
            flash_attention.launches = 0  # the main path's run starts here
            off = 0
            for n in REQUEST_SIZES:
                x = examples[off:off + n]
                code, doc, dt = _post(server.port, x.tolist())
                if code != 200:
                    fail(f"/predict of {n} example(s) answered {code}: {doc}")
                out = np.asarray(doc["outputs"], np.float32)
                if doc.get("served_step") != 1:
                    fail(f"served_step {doc.get('served_step')} != 1")
                if out.shape != (n,) + tuple(meta.input_shape) + (meta.num_classes,):
                    fail(f"/predict output shape {out.shape}")
                if not np.isfinite(out).all():
                    fail("/predict returned non-finite logits")
                err = float(np.abs(out - want1[off:off + n]).max())
                if err > LOGITS_TOL:
                    fail(f"served logits differ from the dense forward by {err:.3e}")
                latencies.append({
                    "examples": n, "ms": dt * 1e3, "served_step": 1,
                    "max_abs_err_vs_dense": err,
                })
                off += n
            launches = flash_attention.launches  # ... and ends here
            flushes = plane.service.stats()["batches"] - batches0
            if launches == 0 or launches != module.num_layers * flushes:
                fail(
                    f"flash kernel launched {launches} times over {flushes} "
                    f"flushes; expected {module.num_layers} per flush"
                )
            print(
                f"/predict: {len(REQUEST_SIZES)} requests, {flushes} flushes, "
                f"{launches} flash launches", flush=True,
            )
            check_out_of_vocabulary(server.port, meta, examples[:1], want1[:1])
            forward_breakdown(model, examples[:1])

            params2 = params_to_flax(init_weights(module, gen))
            save_replicated_step(ckpt, 2, params2)
            if plane.poll_now() != 2 and model.served_step() != 2:
                fail("hot reload did not install step 2")
            code, doc, dt = _post(server.port, examples[:1].tolist())
            if code != 200 or doc.get("served_step") != 2:
                fail(f"after reload /predict answered {code}, step "
                     f"{doc.get('served_step')}")
            out2 = np.asarray(doc["outputs"], np.float32)
            if not np.isfinite(out2).all() or np.array_equal(out2, want1[:1]):
                fail("step 2's answer is non-finite or equals step 1's")
            err2 = float(np.abs(out2 - dense_logits(params2)[:1]).max())
            if err2 > LOGITS_TOL:
                fail(f"step 2's logits differ from its dense forward by {err2:.3e}")
            latencies.append({
                "examples": 1, "ms": dt * 1e3, "served_step": 2,
                "max_abs_err_vs_dense": err2,
            })
            status = agg.status()["serving"]
            if not status or status["step"] != 2:
                fail(f"/status serving section {status}")
            serve_metrics(server.port)
        finally:
            plane.close()
            server.close()
    return launches, latencies


# phase (k3), read in phase 3: the flash-serving process's /metrics
SERVE_METRICS: dict = {}


def serve_metrics(port: int) -> None:
    """/metrics of the serving process: the registry's text, parsed back by
    the port's parser, with the reload and request counters of this run."""
    from mgwfbp_tpu_torch.telemetry.export import parse_metrics_text

    code, text = _get(port, "/metrics")
    values = parse_metrics_text(text) if code == 200 else {}
    if (values.get("mgwfbp_serve_reloads_total") != 2
            or not values.get("mgwfbp_serve_requests_total")
            or values.get("mgwfbp_serve_step") != 2):
        fail(f"serving /metrics answered {code}: {values}")
    SERVE_METRICS.update(
        reloads_total=values["mgwfbp_serve_reloads_total"],
        requests_total=values["mgwfbp_serve_requests_total"],
        served_step=values["mgwfbp_serve_step"],
        series=len(values), scrape_ms_median=_scrape_ms(port, "/metrics"))


def check_out_of_vocabulary(port: int, meta, clean: np.ndarray,
                            want: np.ndarray) -> None:
    """Token ids outside the vocabulary are answered as the JAX package
    answers them (its embedding is jnp.take in mode "fill"): 200, with ids
    in [-V, -1] wrapped to id + V and NaN wherever an id outside [-V, V)
    reaches through attention. The card must take no fault from them: the
    next in-vocabulary answer still equals the dense forward."""
    v = meta.num_classes
    x = np.concatenate([clean, clean])
    x[0, 5] = v
    x[1, 3] = -1
    code, doc, _ = _post(port, x.tolist())
    if code != 200:
        fail(f"out-of-vocabulary /predict answered {code}: {doc}")
    out = np.asarray(doc["outputs"], np.float32)
    if out.shape != x.shape + (v,):
        fail(f"out-of-vocabulary /predict output shape {out.shape}")
    # position 5 onwards sees the NaN row of id V; id -1 is id V - 1
    if not np.isnan(out[0, 5:]).all() or not np.isfinite(out[1]).all():
        fail("out-of-vocabulary answer: NaN rows not where jnp.take puts them")
    wrapped = clean.copy()
    wrapped[0, 3] = v - 1
    code, doc, _ = _post(port, wrapped.tolist())
    if code != 200 or not np.abs(
        np.asarray(doc["outputs"], np.float32) - out[1:]
    ).max() <= LOGITS_TOL:
        fail("id -1 was not answered as id V - 1")
    code, doc, _ = _post(port, clean.tolist())
    err = float(np.abs(np.asarray(doc["outputs"], np.float32) - want).max())
    if code != 200 or not err <= LOGITS_TOL:
        fail(f"after out-of-vocabulary ids /predict answered {code}, "
             f"{err:.3e} from the dense forward")
    print(f"/predict: out-of-vocabulary ids answered 200; the next answer is "
          f"{err:.2e} from the dense forward", flush=True)


def forward_breakdown(model, x: np.ndarray, reps: int = 10) -> None:
    """Where a /predict flush's time goes, apart from HTTP and JSON: the
    host clock around ServingModel.run_padded (tokens to the card, the
    forward of the full slot, logits back), then torch.profiler over a few
    such calls for the device time by kernel. The profiler is a reading,
    not a check: where it records no device time this says so."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        model.run_padded(x)  # synchronous: ends in a device-to-host copy
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"run_padded_ms": sorted(times)[reps // 2], "slot": model.max_batch}
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                model.run_padded(x)
        # device-side events only: a host op's device time repeats its
        # kernels' own
        per = [
            (e.key, e.self_device_time_total / 3e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
        ]
        per = sorted((p for p in per if p[1] > 0), key=lambda p: -p[1])
        out["device_ms_per_call"] = (
            sum(ms for _, ms in per) if per
            else "not measured (the profiler recorded no device time)"
        )
        out["top_kernels_ms"] = [[k[:80], ms] for k, ms in per[:8]]
    except Exception as e:  # noqa: BLE001 — a reading, not a check
        out["device_ms_per_call"] = f"not measured ({type(e).__name__}: {e})"
    print(json.dumps({"forward": out}), flush=True)


TRAIN_DEVICE = "cuda"  # the training phases' device
TRAIN_STEPS = 40  # phase (a): optimizer steps of the trainer
REDUCER_STEPS = 10  # phase (b)
GLOO_STEPS = 5  # phase (c), on each of GLOO_LINKS
# the reference's 56Gb IB constants at 16 workers: against a backward of
# about 10 ms mgwfbp merges ResNet-20's 65 leaves into a few tens of groups
# of several leaves (the ici prior at 1 or 2 workers leaves them alone)
MERGING_LINK = ("56GbIB", 16)
GLOO_LINKS = (("ici", None), MERGING_LINK)  # None: the world's size


def _step_profile(fn, steps: int = 5, all_kernels: bool = False) -> dict:
    """torch.profiler over `steps` calls of fn: the card's busy share (sum
    of kernel time over the host's wall time), the kernels and the host
    operators that take most time, per call. A reading, not a check:
    where the profiler records no device time this says so."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    dev = [(e.key, e.self_device_time_total) for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [(e.key, e.self_cpu_time_total, e.count) for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    busy_us = sum(t for _, t in dev)
    kernels = sum(e.count for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    out = {
        "busy_share": (
            busy_us / wall_us if busy_us > 0
            else "not measured (the profiler recorded no device time)"
        ),
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_ms_per_step": busy_us / steps / 1e3,
        "kernels_per_step": kernels / steps,
        "top_kernels_ms_per_step": [
            [k[:60], t / steps / 1e3]
            for k, t in sorted(dev, key=lambda r: -r[1])[:6]
        ],
        "top_host_ops_ms_per_step": [
            [k[:60], t / steps / 1e3, n // steps]
            for k, t, n in sorted(host, key=lambda r: -r[1])[:10]
        ],
    }
    if all_kernels:
        out["all_kernels_ms_per_step"] = [[k, t / steps / 1e3] for k, t in dev]
    return out


def train_phase_trainer(ckpt_root: str) -> dict:
    """(a) The trainer a user runs, at one worker: full-width ResNet-20,
    batch 32, synthetic CIFAR-10, policy auto, TRAIN_STEPS steps, one
    evaluate and the epoch's commit; then the step time and the card's
    busy share on one batch."""
    from mgwfbp_tpu_torch.checkpoint import read_step
    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.convert import flatten_flax, variables_to_flax
    from mgwfbp_tpu_torch.train import Trainer

    cfg = make_config("resnet20", batch_size=32, policy="auto",
                      num_batches_per_epoch=TRAIN_STEPS, logdir=ckpt_root,
                      checkpoint_dir=ckpt_root)
    t0 = time.perf_counter()
    tr = Trainer(cfg, device=TRAIN_DEVICE, synthetic_data=True)
    metrics = tr.fit(1)
    fit_s = time.perf_counter() - t0
    losses = tr.losses
    if len(losses) != TRAIN_STEPS:
        fail(f"the trainer took {len(losses)} steps, not {TRAIN_STEPS}")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not np.isfinite(losses).all() or not last5 < first5:
        fail(f"training loss did not fall: first 5 {first5:.4f}, last 5 "
             f"{last5:.4f} ({losses})")
    ev = metrics["eval"]
    if not np.isfinite([ev["loss"], ev["top1"], ev["top5"]]).all():
        fail(f"evaluate returned non-finite metrics {ev}")
    params, bstats, meta = read_step(tr.ckpt_dir, tr.iteration)
    live_p, live_b = variables_to_flax(tr.model)
    for live, saved in ((live_p, params), (live_b, bstats)):
        live = flatten_flax(live)
        if list(live) != list(saved) or not all(
            np.array_equal(live[k], saved[k]) for k in live
        ):
            fail("the committed step does not read back equal to the live "
                 "parameters")
    # step time: one fixed batch, CUDA events around each step, median of
    # 20 after 5 of warm-up, a synchronisation after each (the step itself
    # reads nothing back)
    xb, yb = tr.bundle.train.load_batch(0, 0)
    x, y = tr._to_device(xb[None], yb[None])
    times = []
    for i in range(25):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tr.train_step(x, y)
        end.record()
        torch.cuda.synchronize()
        if i >= 5:
            times.append(start.elapsed_time(end))
    step_ms = float(np.median(times))
    prof = _step_profile(lambda: tr.train_step(x, y))
    busy = prof["busy_share"]
    tr.close()
    out = {
        "steps": TRAIN_STEPS, "batch": 32, "fit_s": fit_s,
        "loss_first5": first5, "loss_last5": last5, "eval": ev,
        "committed_step": int(meta["iteration"]), "step_ms": step_ms,
        "step_ms_min": float(np.min(times)), "images_per_s": 32e3 / step_ms,
        "busy_share": busy, "profile": prof,
    }
    print(f"train (a): {TRAIN_STEPS} steps in {fit_s:.1f}s, loss "
          f"{first5:.4f} -> {last5:.4f}, eval {ev}, step {step_ms:.3f} ms "
          f"({out['images_per_s']:.0f} images/s), busy share {busy}",
          flush=True)
    return out


def _grad_copies(params):
    """Hooks that copy each parameter's gradient as it lands, before any
    reduction writes .grad."""
    copies: dict[int, torch.Tensor] = {}
    hooks = [
        p.register_post_accumulate_grad_hook(
            lambda t, j=j: copies.__setitem__(j, t.grad.detach().clone())
        )
        for j, p in enumerate(params)
    ]
    return copies, hooks


def _held_groups(groups, arrivals) -> int:
    """Groups that were complete before a lower group had launched, so that
    the strict group order held their launch back."""
    pos = {k: i for i, k in enumerate(arrivals)}
    held, launched_at = 0, -1
    for members in groups:
        complete_at = max(pos[k] for k in members)
        launched_at = max(launched_at, complete_at)
        held += launched_at > complete_at
    return held


def _reducer_run(dev, bundle, tb, connection: str, nworkers: int) -> dict:
    """REDUCER_STEPS steps of a fresh model through the merged all-reduce,
    policy mgwfbp on ``tb`` and the named link's alpha-beta constants."""
    from mgwfbp_tpu_torch.convert import flax_leaves
    from mgwfbp_tpu_torch.models import create_model
    from mgwfbp_tpu_torch.models.common import init_weights
    from mgwfbp_tpu_torch.optim import make_optimizer
    from mgwfbp_tpu_torch.parallel.allreduce import make_merged_allreduce
    from mgwfbp_tpu_torch.parallel.costmodel import lookup_alpha_beta
    from mgwfbp_tpu_torch.train import TrainStep

    model, _ = create_model("resnet20")
    init_weights(model, torch.Generator().manual_seed(1)).to(dev)
    params = [t for _, t in flax_leaves(model)]
    reducer = make_merged_allreduce(
        model, policy="mgwfbp", tb=tb,
        cost_model=lookup_alpha_beta(connection, nworkers),
    )
    opt, lr_fn, _ = make_optimizer(model.parameters(), 0.1,
                                   num_batches_per_epoch=REDUCER_STEPS)
    step = TrainStep(model, opt, lr_fn, reducer=reducer)
    copies, hooks = _grad_copies(params)
    checks = {"bitwise": True}
    sync = reducer.synchronize

    def checked_sync():
        out = sync()
        for j, p in enumerate(params):
            if not torch.equal(p.grad, copies[j]):
                checks["bitwise"] = False
        return out

    reducer.synchronize = checked_sync
    launches = []
    for k in range(REDUCER_STEPS):
        xb, yb = bundle.train.load_batch(0, k)
        x = torch.from_numpy(xb).to(dev).movedim(-1, -3).contiguous()
        y = torch.from_numpy(yb.astype(np.int64)).to(dev)
        before = reducer.launches
        m = step(x[None], y[None])
        launches.append(reducer.launches - before)
        if not np.isfinite(float(m["loss"])):
            fail(f"reducer phase ({connection}): non-finite loss at step {k}")
    for h in hooks:
        h.remove()
    reducer.synchronize = sync
    traced = _trace_reducer(step, reducer, bundle, dev)
    reducer.detach()
    g = reducer.num_groups
    label = f"reducer phase ({connection} at {nworkers} workers)"
    if launches != [g] * REDUCER_STEPS:
        fail(f"{label}: all-reduce launches per step {launches}, expected "
             f"{g} (num_groups) each")
    if reducer.launch_log != list(range(g)):
        fail(f"{label}: groups launched in the order {reducer.launch_log}")
    if not checks["bitwise"]:
        fail(f"{label}: reduced gradients differ from the copies taken "
             "before the reduction")
    groups = [list(gr) for gr in reducer.schedule.groups]
    return {
        "cost_model": f"{connection} at {nworkers} workers",
        "num_groups": g, "groups": groups,
        "largest_group": max(len(gr) for gr in groups),
        "held_by_group_order": _held_groups(groups, reducer.arrivals),
        "predicted_nonoverlap_s": reducer.schedule.predicted_nonoverlap_time,
        "allreduce_launches_per_step": launches,
        "bitwise_equal_to_pre_reduction_copy": True,
        "arrivals": list(reducer.arrivals),
        "trace": traced,
    }


TRACE_STEPS = 2  # phase (b): steps traced per run


def _trace_reducer(step, reducer, bundle, dev) -> dict:
    """TRACE_STEPS steps of a run under torch.profiler: each group's
    all-reduce time (trace_group_times' arithmetic, None unless every
    group's range holds a collective kernel), the device time of each
    group's range whatever it holds (at one rank: the pack copies), the
    kernels found in the ranges, and why there are no group times. A
    reading, not a check."""
    from mgwfbp_tpu_torch.profiling import (
        collective_group_times,
        group_times_from_rows,
        is_collective_kernel,
        trace_group_rows,
    )

    xb, yb = bundle.train.load_batch(0, 0)
    x = torch.from_numpy(xb).to(dev).movedim(-1, -3).contiguous()[None]
    y = torch.from_numpy(yb.astype(np.int64)).to(dev)[None]

    def run():
        for _ in range(TRACE_STEPS):
            step(x, y)
        if dev.type == "cuda":
            torch.cuda.synchronize()

    rows = trace_group_rows(run)
    g = reducer.num_groups
    kernels = sorted({ident.split(" ", 1)[1] for ident, _ in rows})
    out = {"group_times_s": collective_group_times(rows, g, TRACE_STEPS),
           "range_device_s": group_times_from_rows(rows, g, TRACE_STEPS),
           "kernels": kernels,
           "kernel_rows_per_step": len(rows) / TRACE_STEPS}
    if out["group_times_s"] is None:
        bare = [gi for gi in range(g) if not any(
            ident.startswith(f"mgwfbp_group{gi:04d} ")
            and is_collective_kernel(ident.split(" ", 1)[1])
            for ident, _ in rows)]
        out["reason"] = (
            f"{len(bare)} of {g} groups had no collective kernel in their "
            "range (NCCL launches none for a sum over one rank); "
            "range_device_s is what their ranges held"
            if rows else "the trace holds no device activity in any group's "
            "range"
        )
    return out


def train_phase_reducer() -> dict:
    """(b) The merged all-reduce at one worker over NCCL: policy mgwfbp on
    a tb the hooks measure on the card, REDUCER_STEPS steps on each of two
    cost models: the ``ici`` prior at one worker (every leaf its own group)
    and the reference's comm-bound MERGING_LINK (groups of many leaves).
    Each step launches num_groups all-reduces, in group order, and its
    reduced gradients equal, bit for bit, the same backward's gradients
    copied before the reduction (the mean over one rank is the identity)."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch.convert import flax_leaves, keystr
    from mgwfbp_tpu_torch.data import data_prepare
    from mgwfbp_tpu_torch.models import create_model
    from mgwfbp_tpu_torch.models.common import init_weights
    from mgwfbp_tpu_torch.parallel.allreduce import arrival_order
    from mgwfbp_tpu_torch.parallel.mesh import init_distributed
    from mgwfbp_tpu_torch.profiling import benchmark_backward
    from mgwfbp_tpu_torch.train import cross_entropy

    dev = torch.device(TRAIN_DEVICE, 0) if TRAIN_DEVICE == "cuda" else (
        torch.device(TRAIN_DEVICE)
    )
    rdv = tempfile.TemporaryDirectory(prefix="mgwfbp_nccl_")
    init_distributed(dev, num_processes=1, process_id=0,
                     init_method=f"file://{os.path.join(rdv.name, 'rdv')}")
    try:
        model, _ = create_model("resnet20")
        init_weights(model, torch.Generator().manual_seed(1)).to(dev)
        bundle = data_prepare("cifar10", batch_size=32, seed=1, synthetic=True)
        leaves = flax_leaves(model)
        names = [keystr(p) for p, _ in leaves]
        perm = arrival_order(len(names), names=names)
        xb, yb = bundle.train.load_batch(0, 0)
        x = torch.from_numpy(xb).to(dev).movedim(-1, -3).contiguous()
        y = torch.from_numpy(yb.astype(np.int64)).to(dev)
        model.train()
        tb = benchmark_backward(
            model, lambda: cross_entropy(model(x), y), [t for _, t in leaves],
            perm,
        )
        runs = [_reducer_run(dev, bundle, tb, "ici", 1),
                _reducer_run(dev, bundle, tb, *MERGING_LINK)]
    finally:
        dist.destroy_process_group()
        rdv.cleanup()
    if runs[1]["num_groups"] >= len(names):
        fail(f"reducer phase: {runs[1]['cost_model']} merged no leaves "
             f"({runs[1]['num_groups']} groups for {len(names)} leaves)")
    names_arr = [names[j] for j in perm]
    measured = [names_arr[k] for k in runs[0].pop("arrivals")]
    runs[1].pop("arrivals")
    stem = [i for i, n in enumerate(names_arr) if n.startswith("['ConvBN_0']")]
    ici, merged = runs
    out = {
        "policy": "mgwfbp", "cost_model": ici["cost_model"],
        "num_groups": ici["num_groups"], "groups": ici["groups"],
        "predicted_nonoverlap_s": ici["predicted_nonoverlap_s"],
        "allreduce_launches_per_step": ici["allreduce_launches_per_step"],
        "bitwise_equal_to_pre_reduction_copy": True,
        "merging": merged, "trace": ici["trace"],
        "tb": list(tb), "tb_total_s": float(sum(tb)), "tb_source": tb.source,
        "arrival_positions_of_the_stem_in_the_permutation": stem,
        "arrival_positions_of_the_stem_measured": [
            measured.index(names_arr[i]) for i in stem
        ],
        "permutation_order": names_arr,
        "measured_hook_order": measured,
    }
    for r in runs:
        print(f"train (b): {r['cost_model']}: {r['num_groups']} groups "
              f"(largest {r['largest_group']} leaves, "
              f"{r['held_by_group_order']} held back by the group order), "
              f"{r['allreduce_launches_per_step'][0]} all-reduces per step "
              f"over {REDUCER_STEPS} steps, reduced == pre-reduction bit for "
              "bit", flush=True)
        t = r["trace"]
        times, ranges = t["group_times_s"], t["range_device_s"]
        print(f"train (b): {r['cost_model']}: traced group all-reduce times "
              + (f"sum {sum(times) * 1e3:.4f} ms over {len(times)} groups"
                 if times is not None else f"None ({t['reason']})")
              + "; device time in the groups' ranges "
              + (f"sum {sum(ranges) * 1e3:.4f} ms" if ranges is not None
                 else "None (some range held nothing)")
              + f"; kernels in the ranges: {t['kernels']}", flush=True)
    print(f"train (b): tb {sum(tb) * 1e3:.3f} ms ({tb.source}); the stem is "
          f"at arrival positions {stem} of the permutation, "
          f"{out['arrival_positions_of_the_stem_measured']} as measured",
          flush=True)
    return out


def _gloo_rank(rank: int, world: int, rdv: str, out_path: str,
               device: str, tb: list) -> None:
    """(c) One of two processes on the one card over gloo: GLOO_STEPS steps
    of a fresh model on each of GLOO_LINKS."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch.convert import flax_leaves
    from mgwfbp_tpu_torch.data import ShardInfo, data_prepare
    from mgwfbp_tpu_torch.models import create_model
    from mgwfbp_tpu_torch.models.common import init_weights
    from mgwfbp_tpu_torch.optim import make_optimizer
    from mgwfbp_tpu_torch.parallel.allreduce import make_merged_allreduce
    from mgwfbp_tpu_torch.parallel.costmodel import lookup_alpha_beta
    from mgwfbp_tpu_torch.train import TrainStep

    from mgwfbp_tpu_torch.utils.device import set_matmul_precision

    set_matmul_precision(None)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    results = []
    try:
        bundle = data_prepare("cifar10", batch_size=32,
                              shard=ShardInfo(rank, world), seed=2,
                              synthetic=True)
        for connection, nworkers in ((c, world if n is None else n)
                                     for c, n in GLOO_LINKS):
            result = {"rank": rank, "cost_model":
                      f"{connection} at {nworkers} workers", "steps": 0,
                      "merged_equals_leafwise": True,
                      "params_identical": True}
            results.append(result)
            model, _ = create_model("resnet20")
            init_weights(model, torch.Generator().manual_seed(2)).to(dev)
            params = [t for _, t in flax_leaves(model)]
            reducer = make_merged_allreduce(
                model, policy="mgwfbp", tb=tb,
                cost_model=lookup_alpha_beta(connection, nworkers),
            )
            opt, lr_fn, _ = make_optimizer(model.parameters(), 0.1,
                                           num_batches_per_epoch=GLOO_STEPS)
            step = TrainStep(model, opt, lr_fn, reducer=reducer)
            copies, hooks = _grad_copies(params)
            sync = reducer.synchronize

            def checked_sync(sync=sync, params=params, copies=copies,
                             result=result):
                out = sync()
                for j, p in enumerate(params):
                    leafwise = copies[j].clone()
                    dist.all_reduce(leafwise)
                    leafwise.div_(world)
                    if not torch.equal(p.grad, leafwise):
                        result["merged_equals_leafwise"] = False
                return out

            reducer.synchronize = checked_sync
            for k in range(GLOO_STEPS):
                xb, yb = bundle.train.load_batch(0, k)
                x = torch.from_numpy(xb).to(dev).movedim(-1, -3).contiguous()
                y = torch.from_numpy(yb.astype(np.int64)).to(dev)
                step(x[None], y[None])
                flat = torch.cat([p.detach().reshape(-1) for p in params]).cpu()
                gathered = [torch.empty_like(flat) for _ in range(world)]
                dist.all_gather(gathered, flat)
                if not all(torch.equal(t, gathered[0]) for t in gathered):
                    result["params_identical"] = False
                result["steps"] += 1
            result["num_groups"] = reducer.num_groups
            result["num_leaves"] = len(params)
            result["launches"] = reducer.launches
            for h in hooks:
                h.remove()
            reducer.synchronize = sync
            result["overlap"] = _gloo_overlap(
                step, reducer, bundle, dev, tb,
                lookup_alpha_beta(connection, nworkers),
            )
            reducer.detach()
    finally:
        dist.destroy_process_group()
        with open(out_path, "w") as f:
            json.dump(results, f)


GLOO_TIMED_STEPS = 3  # phase (c): unchecked steps timed for the overlap


def _gloo_overlap(step, reducer, bundle, dev, tb, cost_model) -> dict:
    """GLOO_TIMED_STEPS steps without the checks (``measure_step_time``: the
    host clock, a synchronisation at the end), and the overlap accounting of this
    reducer at that step time (starts replayed from tb in the arrival
    permutation's order)."""
    from mgwfbp_tpu_torch.profiling import measure_step_time
    from mgwfbp_tpu_torch.telemetry import summarize

    xb, yb = bundle.train.load_batch(0, GLOO_STEPS)
    x = torch.from_numpy(xb).to(dev).movedim(-1, -3).contiguous()[None]
    y = torch.from_numpy(yb.astype(np.int64)).to(dev)[None]
    step_s = measure_step_time(step, x, y, warmup=1, iters=GLOO_TIMED_STEPS,
                               device=dev)
    s = summarize(reducer, cost_model, tb, step_s)
    return {**s.to_event_fields(),
            "note": "starts replayed from tb in the arrival permutation's "
                    "order, which places the stem among the first arrivals "
                    "although its hooks fire last"}


def train_phase_gloo(tb: list) -> dict:
    """(c) Two processes on the one card over gloo (NCCL refuses two ranks
    on one device): GLOO_STEPS steps of mgwfbp on phase (b)'s measured tb
    (the trainer broadcasts rank 0's), on the ``ici`` prior at two workers
    and on MERGING_LINK; both ranks' parameters are bit-identical after
    every step and each step's merged gradients equal, bit for bit, the
    same gradients reduced leaf by leaf."""
    import torch.multiprocessing as mp

    world = 2
    with tempfile.TemporaryDirectory(prefix="mgwfbp_gloo_") as d:
        ctx = mp.get_context("spawn")
        outs = [os.path.join(d, f"rank{r}.json") for r in range(world)]
        procs = [
            ctx.Process(target=_gloo_rank,
                        args=(r, world, os.path.join(d, "rdv"), outs[r],
                              TRAIN_DEVICE, tb))
            for r in range(world)
        ]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(300)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        codes = [p.exitcode for p in procs]
        results = []
        for path in outs:
            if os.path.exists(path):
                with open(path) as f:
                    results.append(json.load(f))
    if codes != [0] * world or len(results) != world:
        fail(f"gloo phase: ranks exited {codes}")
    for rank_results in results:
        if len(rank_results) != len(GLOO_LINKS):
            fail(f"gloo phase: {rank_results}")
        for r in rank_results:
            if r["steps"] != GLOO_STEPS or not r["merged_equals_leafwise"] or (
                not r["params_identical"]
            ):
                fail(f"gloo phase: {r}")
    merged = results[0][1]
    if merged["num_groups"] >= merged["num_leaves"]:
        fail(f"gloo phase: {merged['cost_model']} merged no leaves ({merged})")
    runs = []
    for i, r in enumerate(results[0]):
        print(f"train (c): 2 ranks over gloo, {r['cost_model']}: "
              f"{GLOO_STEPS} steps, {r['num_groups']} groups; merged == "
              "leaf-by-leaf and the ranks' parameters equal, bit for bit, "
              "after every step", flush=True)
        ov = r["overlap"]
        print(f"train (c): {r['cost_model']}: overlap ({ov['attribution']}) "
              f"efficiency {ov['efficiency']:.4f}: {ov['comm_s'] * 1e3:.4f} ms "
              f"comm per step = {ov['hidden_s'] * 1e3:.4f} hidden + "
              f"{ov['exposed_s'] * 1e3:.4f} exposed, step "
              f"{ov['step_s'] * 1e3:.3f} ms", flush=True)
        runs.append({"cost_model": r["cost_model"],
                     "num_groups": r["num_groups"],
                     "launches": [rr[i]["launches"] for rr in results],
                     "overlap": [rr[i]["overlap"] for rr in results]})
    return {"world": world, "steps": GLOO_STEPS,
            "num_groups": runs[0]["num_groups"], "launches": runs[0]["launches"],
            "runs": runs,
            "merged_equals_leafwise_bitwise": True,
            "params_identical_every_step": True}


def phase_train() -> tuple[dict, dict]:
    with tempfile.TemporaryDirectory(prefix="mgwfbp_train_") as ckpt:
        a = train_phase_trainer(ckpt)
    b = train_phase_reducer()
    c = train_phase_gloo(b["tb"])
    return b, {
        "model": "resnet20", "step_ms": a["step_ms"],
        "images_per_s": a["images_per_s"], "busy_share": a["busy_share"],
        "num_groups": b["num_groups"], "groups": b["groups"],
        "merging_num_groups": b["merging"]["num_groups"],
        "merging_groups": b["merging"]["groups"],
        "tb_total_s": b["tb_total_s"], "tb_source": b["tb_source"],
        "allreduce_launches_per_step": b["allreduce_launches_per_step"],
        "arrival": {
            k: b[k] for k in (
                "arrival_positions_of_the_stem_in_the_permutation",
                "arrival_positions_of_the_stem_measured",
                "permutation_order", "measured_hook_order",
            )
        },
        "trainer": a, "reducer": {
            k: ({kk: vv for kk, vv in v.items() if kk != "groups"}
                if k == "merging" else v)
            for k, v in b.items()
            if k not in ("permutation_order", "measured_hook_order", "groups",
                         "tb")
        },
        "gloo": c,
    }


def _solve_on(cost_model, tb, name: str = "resnet20") -> dict:
    """A registered model's mgwfbp schedule (arrival order, as the reducer
    solves it) on a cost model and tb."""
    from mgwfbp_tpu_torch.convert import flax_leaves, keystr
    from mgwfbp_tpu_torch.models import create_model
    from mgwfbp_tpu_torch.parallel.allreduce import arrival_order
    from mgwfbp_tpu_torch.parallel.solver import LayerSpec, build_schedule

    with torch.device("meta"):  # shapes only
        model, _ = create_model(name)
    leaves = flax_leaves(model)
    perm = arrival_order(len(leaves), names=[keystr(p) for p, _ in leaves])
    specs = [LayerSpec(keystr(leaves[j][0]), leaves[j][1].numel(), 4)
             for j in perm]
    s = build_schedule(specs, tb, policy="mgwfbp", cost_model=cost_model)
    return {"num_groups": s.num_groups,
            "groups": [list(g) for g in s.groups],
            "largest_group": max(len(g) for g in s.groups),
            "predicted_nonoverlap_s": s.predicted_nonoverlap_time}


def phase_calibrate(b: dict, gloo: dict) -> dict:
    """(d) The cost model measured on the card: ``calibrate --prior-extend
    56GbIB`` at one worker over NCCL and ``--forward --model resnet20`` at
    the per-worker batch, read back and checked; ResNet-20's schedule on
    that profile at 1 and 16 workers beside (b)'s prior-based ones; (b)'s
    traced group times and (c)'s overlap accounting."""
    from mgwfbp_tpu_torch import calibrate
    from mgwfbp_tpu_torch.parallel.costmodel import load_profile, resolve_profile
    from mgwfbp_tpu_torch.profiling import load_layer_profile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mgwfbp_calibrate_") as d:
        prof_path = os.path.join(d, "profile.json")
        layer_path = os.path.join(d, "layers.json")
        if calibrate.main(["--out", prof_path, "--prior-extend", "56GbIB"]):
            fail("calibrate --prior-extend returned non-zero")
        if calibrate.main(["--out", layer_path, "--forward", "--model",
                           "resnet20", "--batch-size", "32"]):
            fail("calibrate --forward returned non-zero")
        with open(prof_path) as f:
            meta = json.load(f)["meta"]
        family = load_profile(prof_path)
        layers = load_layer_profile(layer_path)
        _keep("d_calibrate", d)  # the card's profile, for (s)
    calibrate_s = time.perf_counter() - t0
    card = torch.cuda.get_device_name(0)
    measured = resolve_profile(family, 1)
    if meta.get("device_kind") != card or meta.get("backend") != "nccl":
        fail(f"calibrate meta names {meta.get('device_kind')!r} over "
             f"{meta.get('backend')!r}, not {card!r} over nccl")
    if not (measured.gamma >= 0.0 and measured.pack_beta > 0.0
            and 0.0 <= measured.overlap <= 1.0):
        fail(f"calibrated constants out of range: gamma {measured.gamma}, "
             f"pack_beta {measured.pack_beta}, overlap {measured.overlap}")
    for key in ("tb_s", "tf_s"):
        if len(layers[key]) != 65 or not np.isfinite(layers[key]).all():
            fail(f"calibrate --forward: {key} is not 65 finite values")
    if layers["source"] != "hooks" or layers["tf_source"] != "hooks":
        fail(f"calibrate --forward: sources {layers['source']}, "
             f"{layers['tf_source']}, not hooks")
    tb = b["tb"]
    schedules = {}
    for n in (1, 16):
        schedules[str(n)] = _solve_on(resolve_profile(family, n), tb)
    prior = {"ici at 1 workers": {k: b[k] for k in (
                 "num_groups", "groups", "predicted_nonoverlap_s")},
             f"{MERGING_LINK[0]} at {MERGING_LINK[1]} workers": {
                 k: b["merging"][k] for k in (
                     "num_groups", "groups", "predicted_nonoverlap_s")}}
    for n, s in schedules.items():
        print(f"calibrate (d): calibrated profile at {n} worker(s): "
              f"{s['num_groups']} groups (largest {s['largest_group']} "
              "leaves)", flush=True)
    for k, s in prior.items():
        print(f"calibrate (d): (b)'s {k}: {s['num_groups']} groups",
              flush=True)
    print(f"calibrate (d): alpha {measured.alpha:.4g} s, beta "
          f"{measured.beta:.4g} s/B, gamma {measured.gamma:.4g} s, pack_beta "
          f"{measured.pack_beta:.4g} s/B, overlap {measured.overlap:.4g}, tb "
          f"{sum(layers['tb_s']) * 1e3:.4f} ms, tf "
          f"{sum(layers['tf_s']) * 1e3:.4f} ms ({calibrate_s:.1f}s)",
          flush=True)
    return {
        "device_kind": meta["device_kind"], "backend": meta["backend"],
        "measured_world": 1, "seconds": calibrate_s,
        "alpha_s": measured.alpha, "beta_s_per_byte": measured.beta,
        "gamma_s": measured.gamma,
        "pack_beta_s_per_byte": measured.pack_beta,
        "overlap": measured.overlap,
        "update_beta": "not measured (ROADMAP.md Queue 1 item 7)",
        "curve": {"sizes_bytes": list(measured.sizes_bytes),
                  "times_s": list(measured.times_s)},
        "gamma_samples_s": meta.get("gamma_samples_s"),
        "prior_fields": meta.get("prior_fields"),
        "tb_total_s": sum(layers["tb_s"]), "tf_total_s": sum(layers["tf_s"]),
        "tb_s": layers["tb_s"], "tf_s": layers["tf_s"],
        "schedules_on_calibrated": schedules,
        "schedules_on_priors": prior,
        "trace_b": {"ici": b["trace"], "merging": b["merging"]["trace"]},
        "overlap_c": [
            {"cost_model": r["cost_model"], **r["overlap"][0]}
            for r in gloo["runs"]
        ],
    }


LM_MODELS = ("lstm", "transformer")
LM_EPOCHS, LM_EPOCH_STEPS = 4, 10  # phase (e): 40 steps per model
LM_STEPS = LM_EPOCHS * LM_EPOCH_STEPS
# one window of the card's logits and carry against the same weights on the
# CPU, TF32 off: cuDNN's LSTM and cuBLAS sum in other orders than the CPU's
# kernels, over 35 recurrent steps or 4 residual layers and a 10000-way
# head; the bound is relative to the largest logit
LM_WINDOW_TOL = 1e-4


def _lm_window_check(tr, name: str) -> dict:
    """One validation window through the trained model on the card and
    through a CPU copy of the same weights; the LSTM from the carry the
    training left."""
    from mgwfbp_tpu_torch import models

    xb, _ = tr.bundle.val.load_batch(0, 0)
    ref, _ = models.create_model(name)
    ref = models.for_training(ref)
    ref.load_state_dict({k: v.detach().cpu()
                         for k, v in tr.model.state_dict().items()})
    ref.eval()
    tr.model.eval()
    try:
        with torch.no_grad():
            x = torch.from_numpy(xb)
            if tr.carry is None:
                got, want = tr.model(x.cuda()), ref(x)
                carries = []
            else:
                got, got_c = tr.model(x.cuda(), tr.carry)
                want, want_c = ref(x, tuple((c.cpu(), h.cpu())
                                            for c, h in tr.carry))
                carries = [(a, b) for ga, wa in zip(got_c, want_c)
                           for a, b in zip(ga, wa)]
    finally:
        tr.model.train()
    scale = max(1.0, float(want.abs().max()))
    err = float((got.cpu() - want).abs().max())
    carry_err = max((float((a.cpu() - b).abs().max()) for a, b in carries),
                    default=0.0)
    if not torch.isfinite(got).all() or err > LM_WINDOW_TOL * scale or (
        carry_err > LM_WINDOW_TOL
    ):
        fail(f"{name}: the card's window differs from the CPU's: logits "
             f"{err:.3e} (largest logit {scale:.3g}), carry {carry_err:.3e}")
    return {"max_abs_err_logits": err, "largest_logit": scale,
            "max_abs_err_carry": carry_err if carries else None,
            "tolerance": f"{LM_WINDOW_TOL} x max(1, largest logit); "
                         f"{LM_WINDOW_TOL} on the carry"}


def _hook_arrival(tr) -> list[str]:
    """The Flax paths of the leaves in the order their post-accumulate-grad
    hooks fire in one backward of the LM loss."""
    from mgwfbp_tpu_torch.convert import flax_leaves, keystr
    from mgwfbp_tpu_torch.train.step import forward_loss

    leaves = flax_leaves(tr.model)
    order: list[str] = []
    hooks = [t.register_post_accumulate_grad_hook(
                 lambda _t, n=keystr(p): order.append(n))
             for p, t in leaves]
    xb, yb = tr.bundle.train.load_batch(0, 0)
    x, y = tr._to_device(xb, yb)
    try:
        loss, _, _ = forward_loss(tr.model, "lm", x, y, tr._zero_carry())
        loss.backward()
    finally:
        for h in hooks:
            h.remove()
        for _, t in leaves:
            t.grad = None
    return order


def _lm_run(name: str, root: str) -> dict:
    from mgwfbp_tpu_torch.checkpoint import read_step
    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.convert import (
        flatten_flax,
        flax_leaves,
        keystr,
        variables_to_flax,
    )
    from mgwfbp_tpu_torch.ops import flash_attention
    from mgwfbp_tpu_torch.parallel.allreduce import arrival_order
    from mgwfbp_tpu_torch.parallel.costmodel import lookup_alpha_beta
    from mgwfbp_tpu_torch.train import Trainer

    cfg = make_config(name, num_batches_per_epoch=LM_EPOCH_STEPS,
                      eval_every_epochs=LM_EPOCHS,
                      checkpoint_every_epochs=LM_EPOCHS,
                      logdir=os.path.join(root, "logs"),
                      checkpoint_dir=os.path.join(root, "ckpt"))
    t0 = time.perf_counter()
    tr = Trainer(cfg, device=TRAIN_DEVICE, synthetic_data=True)
    if getattr(tr.model, "attn_impl", "dense") != "dense":
        fail(f"{name}: the trainer's model attends with {tr.model.attn_impl}")
    flash_attention.launches = 0  # training starts here
    metrics = tr.fit(LM_EPOCHS)
    flash_launches = flash_attention.launches  # ... and ends here
    fit_s = time.perf_counter() - t0
    losses = tr.losses
    if len(losses) != LM_STEPS:
        fail(f"{name}: the trainer took {len(losses)} steps, not {LM_STEPS}")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not np.isfinite(losses).all() or not last5 < first5:
        fail(f"{name}: training loss did not fall: first 5 {first5:.4f}, "
             f"last 5 {last5:.4f} ({losses})")
    if flash_launches:
        fail(f"{name}: training launched the flash kernel {flash_launches} "
             "times")
    ev = metrics["eval"]
    if not np.isfinite([ev["loss"], ev["perplexity"]]).all():
        fail(f"{name}: evaluate returned non-finite metrics {ev}")
    params, _, meta = read_step(tr.ckpt_dir, tr.iteration)
    live = flatten_flax(variables_to_flax(tr.model)[0])
    if list(live) != list(params) or not all(
        np.array_equal(live[k], params[k]) for k in live
    ):
        fail(f"{name}: the committed step does not read back equal to the "
             "live parameters")
    window = _lm_window_check(tr, name)
    # step time: one fixed batch, CUDA events around each step, median of
    # 20 after 5 of warm-up, a synchronisation after each (the step itself
    # reads nothing back)
    xb, yb = tr.bundle.train.load_batch(0, 0)
    x, y = tr._to_device(xb[None], yb[None])
    tokens = xb.size
    times = []
    for i in range(25):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tr.step_batch(x, y)
        end.record()
        torch.cuda.synchronize()
        if i >= 5:
            times.append(start.elapsed_time(end))
    step_ms = float(np.median(times))
    prof = _step_profile(lambda: tr.step_batch(x, y))
    tb = tr._profile_backward()
    leaves = flax_leaves(tr.model)
    names = [keystr(p) for p, _ in leaves]
    perm_names = [names[j] for j in arrival_order(len(names), names=names)]
    schedules = {
        f"{conn} at {n} workers": _solve_on(lookup_alpha_beta(conn, n), tb,
                                            name)
        for conn, n in (("ici", 1), MERGING_LINK)
    }
    out = {
        "steps": LM_STEPS, "batch": cfg.batch_size,
        "window": int(xb.shape[1]), "fit_s": fit_s,
        "params": int(sum(t.numel() for _, t in leaves)),
        "leaves": len(leaves), "loss_first5": first5, "loss_last5": last5,
        "eval": ev, "committed_step": int(meta["iteration"]),
        "window_check": window, "flash_launches_training": flash_launches,
        "step_ms": step_ms, "step_ms_min": float(np.min(times)),
        "tokens_per_s": tokens * 1e3 / step_ms,
        "busy_share": prof["busy_share"],
        "kernels_per_step": prof["kernels_per_step"], "profile": prof,
        "tb_source": tb.source, "tb_total_s": float(sum(tb)),
        "num_groups": {k: v["num_groups"] for k, v in schedules.items()},
        "schedules": schedules,
    }
    if name == "lstm":
        emb = "['embedding']['embedding']"
        measured = _hook_arrival(tr)
        out["embedding_arrival"] = {
            "in_the_permutation": perm_names.index(emb),
            "measured_by_hooks": measured.index(emb),
            "leaves": len(measured),
        }
    tr.close()
    print(f"lm (e): {name}: {LM_STEPS} steps in {fit_s:.1f}s, loss "
          f"{first5:.4f} -> {last5:.4f}, eval {ev}, step {step_ms:.3f} ms "
          f"({out['tokens_per_s']:.0f} tokens/s), busy share "
          f"{out['busy_share']}, {out['kernels_per_step']:.0f} kernels per "
          f"step, groups {out['num_groups']} (tb {tb.source}), window err "
          f"{window['max_abs_err_logits']:.2e}"
          + (f", embedding arrives at {out['embedding_arrival']}"
             if name == "lstm" else ""), flush=True)
    return out


def phase_lm() -> dict:
    """(e) Both language models at full width through the Trainer."""
    out = {}
    for name in LM_MODELS:
        with tempfile.TemporaryDirectory(prefix=f"mgwfbp_{name}_") as root:
            out[name] = _lm_run(name, root)
    return out


RESNET50_BATCH, RESNET50_FALLBACK = 128, 64  # the preset's, then on OOM
RESNET50_STEPS = 32  # phase (f): 512 synthetic images repeated
RESNET50_BENCH_ITERS = 10  # the bench grid at a reduced count in the smoke
# one batch of the card's bfloat16 logits against the same weights at
# float32 on the card, eval mode: bfloat16 keeps 8 bits, and 53 layers
# round each activation again (measured on the CPU at 224: 1.2 % relative
# L2); the bound is relative L2 and max abs against max(1, largest logit)
RESNET50_BF16_TOL = 5e-2
# /predict of the committed float32 checkpoint against a float32 forward of
# the live weights on the card: the same math, through cuDNN algorithms
# that may differ with the batch (the serve slot pads to 8)
RESNET50_SERVE_TOL = 1e-3
SERVE_IMAGES = 2
# substrings of the device kernels counted as convolutions (cuDNN's and
# CUTLASS's implicit-GEMM fprop/dgrad/wgrad kernels), layout transposes,
# and batch-norm statistics
CONV_KERNELS = ("conv", "fprop", "dgrad", "wgrad", "implicit_gemm", "xmma")
LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw", "nchw2nhwc", "nhwc2nchw")
BN_KERNELS = ("batch_norm", "welford", "var_mean")


def _kernel_shares(prof: dict) -> dict:
    """Shares of the step's device time by kernel family, from a
    torch.profiler run (``_step_profile(..., all_kernels=True)``)."""
    rows = prof.get("all_kernels_ms_per_step") or []
    total = sum(ms for _, ms in rows)
    if total <= 0:
        return {"note": "not measured (the profiler recorded no device time)"}

    def share(keys):
        return sum(ms for k, ms in rows if any(s in k for s in keys)) / total

    return {"conv": share(CONV_KERNELS), "layout_transposes": share(LAYOUT_KERNELS),
            "batch_norm": share(BN_KERNELS), "device_ms_per_step": total}


def _resnet50_train(root: str, batch: int) -> tuple:
    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.train import Trainer

    cfg = make_config("resnet50", dtype="bfloat16", batch_size=batch,
                      augment=False,
                      logdir=os.path.join(root, "logs"),
                      checkpoint_dir=os.path.join(root, "ckpt"))
    tr = Trainer(cfg, device=TRAIN_DEVICE, synthetic_data=True)
    epochs = max(RESNET50_STEPS // max(tr._steps_per_epoch(), 1), 1)
    cfg.eval_every_epochs = cfg.checkpoint_every_epochs = epochs
    t0 = time.perf_counter()
    metrics = tr.fit(epochs)
    return tr, metrics, time.perf_counter() - t0


def _resnet50_serve(ckpt_dir: str, step: int, model, x: np.ndarray) -> dict:
    """The committed checkpoint behind /predict (float32, NHWC requests)
    against a float32 forward of the live weights on the card."""
    from mgwfbp_tpu_torch import models
    from mgwfbp_tpu_torch.serving.model import ServingModel
    from mgwfbp_tpu_torch.serving.plane import ServePlane
    from mgwfbp_tpu_torch.telemetry.serve import MetricsAggregator, TelemetryServer

    module, meta = models.create_model("resnet50")
    serving = ServingModel(module, meta, device=TRAIN_DEVICE)
    agg = MetricsAggregator(run={"role": "serve", "dnn": meta.name})
    server = TelemetryServer(agg, 0)
    plane = ServePlane(serving, ckpt_dir, emit=agg.observe, server=server)
    try:
        plane.start()
        if plane.poll_now() != step and serving.served_step() != step:
            fail(f"resnet50: the committed step {step} was not installed")
        code, doc, dt = _post(server.port, x.tolist())
    finally:
        plane.close()
        server.close()
    if code != 200 or doc.get("served_step") != step:
        fail(f"resnet50 /predict answered {code}, step {doc.get('served_step')}")
    got = np.asarray(doc["outputs"], np.float32)
    model.eval()
    try:
        with torch.no_grad():
            want = model(torch.from_numpy(x).to(TRAIN_DEVICE).movedim(-1, -3)
                         .contiguous()).float().cpu().numpy()
    finally:
        model.train()
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    if got.shape != want.shape or not np.isfinite(got).all() or (
        err > RESNET50_SERVE_TOL * scale
    ):
        fail(f"resnet50 /predict differs from the float32 forward: shape "
             f"{got.shape}, max abs {err:.3e} (largest logit {scale:.3g})")
    return {"images": len(x), "ms": dt * 1e3, "served_step": step,
            "max_abs_err_vs_float32_forward": err, "largest_logit": scale,
            "tolerance": f"{RESNET50_SERVE_TOL} x max(1, largest logit)"}


def _bf16_vs_f32_logits(tr, x: torch.Tensor) -> dict:
    from mgwfbp_tpu_torch.train.step import model_forward

    tr.model.eval()
    try:
        with torch.no_grad():
            low = model_forward(tr.model, x, None, torch.bfloat16)
            ref = tr.model(x).float()
    finally:
        tr.model.train()
    scale = max(1.0, float(ref.abs().max()))
    err = float((low - ref).abs().max())
    rel = float((low - ref).norm() / ref.norm())
    if not torch.isfinite(low).all() or rel > RESNET50_BF16_TOL or (
        err > RESNET50_BF16_TOL * scale
    ):
        fail(f"resnet50: bfloat16 logits differ from float32: relative L2 "
             f"{rel:.3e}, max abs {err:.3e} (largest logit {scale:.3g})")
    return {"rel_l2": rel, "max_abs_err": err, "largest_logit": scale,
            "tolerance": f"{RESNET50_BF16_TOL} relative L2 and x max(1, "
                         "largest logit) max abs"}


def _timed_steps(step, x, y, n: int = 20, warmup: int = 5) -> list[float]:
    """ms of each of n steps after warm-up, CUDA events around each and a
    synchronisation after each (the step itself reads nothing back)."""
    times = []
    for i in range(warmup + n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(x, y)
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return times


def phase_resnet50() -> dict:
    """(f) ResNet-50 at full width (224 x 224, 1000 classes) on synthetic
    ImageNet through the Trainer at bfloat16."""
    from mgwfbp_tpu_torch import bench
    from mgwfbp_tpu_torch.checkpoint import read_step
    from mgwfbp_tpu_torch.convert import flatten_flax, variables_to_flax
    from mgwfbp_tpu_torch.ops import flash_attention
    from mgwfbp_tpu_torch.train.step import TrainStep

    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="mgwfbp_resnet50_") as root:
        flash_attention.launches = 0  # this path's run starts here
        batch = RESNET50_BATCH
        try:
            tr, metrics, fit_s = _resnet50_train(root, batch)
        except torch.cuda.OutOfMemoryError:
            import gc

            gc.collect()
            torch.cuda.empty_cache()
            batch = RESNET50_FALLBACK
            print(f"resnet50 (f): out of memory at batch {RESNET50_BATCH}; "
                  f"batch {batch}", flush=True)
            tr, metrics, fit_s = _resnet50_train(root, batch)
        losses = tr.losses
        out.update(batch=batch, steps=len(losses), fit_s=fit_s)
        if len(losses) < RESNET50_STEPS:
            fail(f"resnet50: the trainer took {len(losses)} steps")
        first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        if not np.isfinite(losses).all() or not last5 < first5:
            fail(f"resnet50: training loss did not fall: first 5 {first5:.4f}, "
                 f"last 5 {last5:.4f} ({losses})")
        ev = metrics["eval"]
        if not np.isfinite([ev["loss"], ev["top1"], ev["top5"]]).all():
            fail(f"resnet50: evaluate returned non-finite metrics {ev}")
        params, bstats, meta = read_step(tr.ckpt_dir, tr.iteration)
        live_p, live_b = variables_to_flax(tr.model)
        for live, saved in ((live_p, params), (live_b, bstats)):
            live = flatten_flax(live)
            if list(live) != list(saved) or not all(
                np.array_equal(live[k], saved[k]) for k in live
            ):
                fail("resnet50: the committed step does not read back equal "
                     "to the live parameters and batch statistics")
        xb, yb = tr.bundle.val.load_batch(0, 0)
        x, y = tr._to_device(xb[None], yb[None])
        out.update(loss_first5=first5, loss_last5=last5, eval=ev,
                   committed_step=int(meta["iteration"]),
                   input_channels_last=bool(
                       x[0].is_contiguous(memory_format=torch.channels_last)),
                   leaves=len(params), batch_stat_leaves=len(bstats),
                   params=int(sum(v.size for v in params.values())))
        out["bf16_vs_f32_logits"] = _bf16_vs_f32_logits(tr, x[0])
        out["serve"] = _resnet50_serve(tr.ckpt_dir, tr.iteration, tr.model,
                                       xb[:SERVE_IMAGES])
        out["flash_launches"] = flash_attention.launches  # ... ends here
        if out["flash_launches"]:
            fail(f"resnet50: the path launched the flash kernel "
                 f"{out['flash_launches']} times")
        times = _timed_steps(tr.train_step, x, y)
        out.update(step_ms=float(np.median(times)),
                   step_ms_min=float(np.min(times)))
        out["images_per_s"] = batch * 1e3 / out["step_ms"]
        prof = _step_profile(lambda: tr.train_step(x, y), all_kernels=True)
        out.update(busy_share=prof["busy_share"],
                   kernels_per_step=prof["kernels_per_step"],
                   kernel_shares=_kernel_shares(prof))
        prof.pop("all_kernels_ms_per_step", None)
        out["profile"] = prof
        f32 = TrainStep(tr.model, tr.optimizer, tr.lr_fn)
        times32 = _timed_steps(f32, x, y)
        out["float32_step_ms"] = float(np.median(times32))
        out["float32_images_per_s"] = batch * 1e3 / out["float32_step_ms"]
        tr.close()
        del tr, f32, x, y
        torch.cuda.empty_cache()
    os.environ["MGWFBP_BENCH_ITERS"] = str(RESNET50_BENCH_ITERS)
    try:
        payload = bench.run_bench(TRAIN_DEVICE)
    finally:
        del os.environ["MGWFBP_BENCH_ITERS"]
    print(json.dumps({"bench": payload}), flush=True)
    if (payload.get("error") or payload.get("skipped")
            or set(payload["policies"]) != set(bench.POLICIES)):
        fail(f"resnet50: the bench grid failed: {payload}")
    out["bench"] = payload
    print(f"resnet50 (f): {out['steps']} bf16 steps at batch {batch} in "
          f"{out['fit_s']:.1f}s, loss {out['loss_first5']:.4f} -> "
          f"{out['loss_last5']:.4f}, eval {out['eval']}, step "
          f"{out['step_ms']:.3f} ms ({out['images_per_s']:.0f} images/s; "
          f"float32 {out['float32_step_ms']:.3f} ms), busy share "
          f"{out['busy_share']}, {out['kernels_per_step']:.0f} kernels per "
          f"step, shares {out['kernel_shares']}, bf16 vs f32 logits "
          f"{out['bf16_vs_f32_logits']['rel_l2']:.3e}, /predict "
          f"{out['serve']['max_abs_err_vs_float32_forward']:.2e}, bench mfu "
          f"{payload['mfu']}", flush=True)
    return out


# phase (g): resumable training
RES_LSTM_EPOCHS, RES_LSTM_EPOCH_STEPS = 2, 15  # 30 steps of the full LSTM
RES_PREEMPT_STEP = 12  # run B's fault plan: SIGTERM to itself after it
RES_CKPT_EVERY = 5
RES_EVAL_RTOL = 1e-5  # the evaluator's perplexity against the trainer's
RES_R50_TIMED_N = 2688  # synthetic ImageNet: 21 steps (20 intervals)/epoch
# params, momentum and batch statistics of ResNet-50 in float32: 204.6 MB
RES_R50_MIN_SAVE_BYTES = 150e6
RES_TIMEOUT_S = 240  # per train_cli process
NONDETERMINISTIC = "does not have a deterministic implementation"


def _lstm_cli(root: str) -> list[str]:
    """The command of every (g1) run: full-width PTB LSTM (batch 20 x 35,
    float32, TF32 off), 2 epochs of 15 steps, a mid-epoch checkpoint every
    5 steps, torch's deterministic algorithms."""
    return [
        sys.executable, "-m", "mgwfbp_tpu_torch.train_cli", "--dnn", "lstm",
        "--synthetic", "--max-epochs", str(RES_LSTM_EPOCHS),
        "--num-batches-per-epoch", str(RES_LSTM_EPOCH_STEPS),
        "--ckpt-every-steps", str(RES_CKPT_EVERY), "--telemetry",
        "--deterministic", "--device", TRAIN_DEVICE,
        "--logdir", os.path.join(root, "logs"),
        "--checkpoint-dir", os.path.join(root, "ckpt"),
    ]


def _res_env(plan: str = "") -> dict:
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               MGWFBP_FAULT_PLAN=plan,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    return env


_CHILDREN: list = []  # every train_cli / evaluate process phase (g) starts


def _kill_children() -> None:
    for p in _CHILDREN:
        if p.poll() is None:
            p.kill()
            p.wait()


def _start(cmd: list[str], env: dict, log: str) -> tuple:
    f = open(log, "w")
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=f, text=True,
                         env=env)
    _CHILDREN.append(p)
    return p, f, log


def _finish(run: tuple, name: str) -> tuple[int, str, str]:
    """(rc, last stdout line, stderr) of a started run; kills it past the
    time limit."""
    p, f, log = run
    try:
        out, _ = p.communicate(timeout=RES_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        f.close()
        fail(f"resilience (g1): run {name} exceeded {RES_TIMEOUT_S}s")
    f.close()
    with open(log) as fh:
        err = fh.read()
    lines = out.strip().splitlines()
    return p.returncode, (lines[-1] if lines else ""), err


def _stream(root: str) -> str:
    logs = os.path.join(root, "logs")
    (tag,) = os.listdir(logs)
    return os.path.join(logs, tag, "telemetry.jsonl")


def _events(root: str, name: str) -> list[dict]:
    from mgwfbp_tpu_torch.telemetry import events_of, read_events

    return events_of(read_events(_stream(root)), name)


def _committed(root: str, step: int) -> tuple[dict, list]:
    """(params, carry leaves) of a committed step of a (g1) run."""
    from mgwfbp_tpu_torch.checkpoint import read_step

    ckpt = os.path.join(root, "ckpt")
    (tag,) = os.listdir(ckpt)
    params, _, _ = read_step(os.path.join(ckpt, tag), step)
    pdir = os.path.join(ckpt, tag, "sharded", f"{step:08d}", "p00000")
    carry = [np.load(os.path.join(pdir, f"carry.l{i}.npy")) for i in range(4)]
    return params, carry


def _distance(a: tuple, b: tuple) -> float:
    pa, ca = a
    pb, cb = b
    if list(pa) != list(pb):
        fail("resilience (g1): the runs committed different leaves")
    d = max(float(np.max(np.abs(pa[k] - pb[k]))) for k in pa)
    return max([d] + [float(np.max(np.abs(x - y))) for x, y in zip(ca, cb)])


def _log_marks(err: str, t_launch: float) -> dict:
    """Seconds from a relaunch to the trainer's log lines that bound its
    start-up phases: the trainer begins (imports done), the model is on
    the card (data and model built), the checkpoint is restored."""
    marks = {}
    for line in err.splitlines():
        for key, text in (("trainer_start", "precision:"),
                          ("model_on_card", "single device:"),
                          ("restored", "resumed from")):
            if key not in marks and text in line:
                stamp, ms = line[:23].split(",")
                wall = time.mktime(time.strptime(stamp, "%Y-%m-%d %H:%M:%S"))
                marks[key] = wall + int(ms) / 1e3 - t_launch
    return marks


def resilience_lstm(work: str) -> dict:
    """(g1) The PTB LSTM preempted and resumed through train_cli: run A
    uninterrupted; run B preempted by its fault plan after step 12 (rc 75),
    relaunched with the same command (it resumes mid-epoch), sent a real
    SIGTERM once it has stepped (rc 75 again), relaunched to the end. B's
    final committed params and carry against A's: bitwise when every op ran
    deterministically, else no further than a second run of A. Then the
    offline evaluator on A's last epoch against A's own evaluation."""
    last = RES_LSTM_EPOCHS * RES_LSTM_EPOCH_STEPS
    a, b = os.path.join(work, "a"), os.path.join(work, "b")
    plan = f"preempt@step={RES_PREEMPT_STEP}"
    t0 = time.perf_counter()
    run_a = _start(_lstm_cli(a), _res_env(), os.path.join(work, "a.err"))
    run_b1 = _start(_lstm_cli(b), _res_env(plan),
                    os.path.join(work, "b1.err"))
    rc_a, line_a, err_a = _finish(run_a, "A")
    rc_b1, line_b1, err_b1 = _finish(run_b1, "B1")
    out: dict = {"rcs": {"A": rc_a, "B1": rc_b1}}
    if rc_a != 0:
        fail(f"resilience (g1): run A exited {rc_a}: {err_a[-2000:]}")
    if rc_b1 != 75:
        fail(f"resilience (g1): run B exited {rc_b1}, not 75: "
             f"{err_b1[-2000:]}")
    pre = json.loads(line_b1)
    if not (pre.get("preempted") and pre["iteration"] == RES_PREEMPT_STEP
            and pre["signal"] == "SIGTERM"):
        fail(f"resilience (g1): run B printed {line_b1!r}")
    # B2: the same command; SIGTERM once it has taken a resumed step
    stream = _stream(b)
    seen = len(_events(b, "step"))
    t_launch = time.time()
    run_b2 = _start(_lstm_cli(b), _res_env(plan),
                    os.path.join(work, "b2.err"))
    first_wall = None
    deadline = time.time() + RES_TIMEOUT_S
    while time.time() < deadline and run_b2[0].poll() is None:
        with open(stream) as fh:
            recs = [json.loads(x) for x in fh.read().splitlines()[1:]]
        steps = [r for r in recs if r.get("event") == "step"][seen:]
        if steps:
            first_wall = float(steps[0]["wall"])
            break
        time.sleep(0.005)
    t_sig = time.time()
    run_b2[0].send_signal(signal.SIGTERM)
    rc_b2, line_b2, err_b2 = _finish(run_b2, "B2")
    drain_s = time.time() - t_sig
    out["rcs"]["B2"] = rc_b2
    if rc_b2 != 75 or first_wall is None:
        fail(f"resilience (g1): the SIGTERMed relaunch exited {rc_b2} (a "
             f"resumed step seen: {first_wall is not None}): "
             f"{err_b2[-2000:]}")
    sig_step = json.loads(line_b2)["iteration"]
    # B3 to the end, and beside it (g3) the offline evaluator on A's last
    # epoch
    run_b3 = _start(_lstm_cli(b), _res_env(plan),
                    os.path.join(work, "b3.err"))
    ckpt_a = os.path.join(a, "ckpt")
    (tag,) = os.listdir(ckpt_a)
    run_ev = _start(
        [sys.executable, "-m", "mgwfbp_tpu_torch.evaluate", "--dnn", "lstm",
         "--checkpoint-dir", os.path.join(ckpt_a, tag), "--synthetic",
         "--device", TRAIN_DEVICE], _res_env(), os.path.join(work, "ev.err"))
    rc_b3, line_b3, err_b3 = _finish(run_b3, "B3")
    rc_ev, line_ev, err_ev = _finish(run_ev, "evaluate")
    out["rcs"]["B3"] = rc_b3
    if rc_b3 != 0:
        fail(f"resilience (g1): the last relaunch exited {rc_b3}: "
             f"{err_b3[-2000:]}")
    resumes = _events(b, "resume")
    if [(r["iteration"], r["mid_epoch"]) for r in resumes] != [
            (RES_PREEMPT_STEP, True), (sig_step, True)]:
        fail(f"resilience (g1): resume events {resumes}")
    steps_b = sorted({r["step"] for r in _events(b, "step")})
    if steps_b != list(range(1, last + 1)):
        fail(f"resilience (g1): run B's steps {steps_b}")
    nondet = any(NONDETERMINISTIC in e for e in (err_a, err_b1, err_b2, err_b3))
    dist_ba = _distance(_committed(b, last), _committed(a, last))
    out.update(
        preempt_step=RES_PREEMPT_STEP, sigterm_step=sig_step,
        resume_steps=[r["iteration"] for r in resumes],
        relaunch_to_first_resumed_step_s=first_wall - t_launch,
        relaunch_marks_s=_log_marks(err_b2, t_launch),
        drain_s_signal_to_exit=drain_s, deterministic=not nondet,
        max_abs_diff_b_vs_a=dist_ba,
    )
    if nondet:
        run_a2 = _start(_lstm_cli(os.path.join(work, "a2")), _res_env(),
                        os.path.join(work, "a2.err"))
        rc_a2, _, err_a2 = _finish(run_a2, "A2")
        if rc_a2 != 0:
            fail(f"resilience (g1): run A2 exited {rc_a2}: {err_a2[-2000:]}")
        dist_aa = _distance(_committed(os.path.join(work, "a2"), last),
                            _committed(a, last))
        out["max_abs_diff_a2_vs_a"] = dist_aa
        if not dist_ba <= dist_aa:
            fail(f"resilience (g1): B is {dist_ba:.3e} from A, further than "
                 f"a second A ({dist_aa:.3e})")
    elif dist_ba != 0.0:
        fail(f"resilience (g1): deterministic runs differ: B is "
             f"{dist_ba:.3e} from A")
    if rc_ev != 0:
        fail(f"resilience (g3): evaluate exited {rc_ev}: {err_ev[-2000:]}")
    got = json.loads(line_ev)
    want = json.loads(line_a)["eval"]
    rel = abs(got["perplexity"] - want["perplexity"]) / want["perplexity"]
    out["evaluate"] = {"perplexity": got["perplexity"],
                       "trainer_perplexity": want["perplexity"],
                       "rel_err": rel, "epoch": got["epoch"]}
    if not (got["epoch"] == RES_LSTM_EPOCHS - 1 and rel <= RES_EVAL_RTOL):
        fail(f"resilience (g3): evaluate {got} against the trainer's {want}")
    out["phase_s"] = time.perf_counter() - t0
    return out


def resilience_resnet50(work: str) -> dict:
    """(g2) ResNet-50 at bfloat16, batch 128, synthetic ImageNet, one
    trainer with MGWFBP_FAULT_PLAN=nan@step=4,count=3 and --bad-step-limit
    3: an epoch of 2 steps commits its boundary (one synchronous save,
    timed); the next epoch takes three bad steps, rolls back to step 2 and
    ends with a finite loss. Then the step interval (wall time between
    step starts, so that a save counts) over an epoch of RES_R50_TIMED_N /
    128 steps without checkpoints and one with --ckpt-every-steps 5
    (async), both through the default prefetch (MGWFBP_DATA_WORKERS 2),
    and one more without checkpoints through the bare loader (what
    MGWFBP_DATA_WORKERS=0 gives)."""
    from mgwfbp_tpu_torch.data import PrefetchLoader
    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.telemetry import events_of, read_events
    from mgwfbp_tpu_torch.train import Trainer

    t0 = time.perf_counter()
    root = os.path.join(work, "r50")
    cfg = make_config("resnet50", dtype="bfloat16", batch_size=RESNET50_BATCH,
                      augment=False, telemetry=True, eval_every_epochs=1000,
                      num_batches_per_epoch=2, bad_step_limit=3,
                      logdir=os.path.join(root, "logs"),
                      checkpoint_dir=os.path.join(root, "ckpt"))
    os.environ["MGWFBP_FAULT_PLAN"] = "nan@step=4,count=3"
    os.environ["MGWFBP_SYNTH_TRAIN_N"] = str(RES_R50_TIMED_N)
    try:
        tr = Trainer(cfg, device=TRAIN_DEVICE, synthetic_data=True)
    finally:
        del os.environ["MGWFBP_FAULT_PLAN"], os.environ["MGWFBP_SYNTH_TRAIN_N"]

    def events(name: str) -> list[dict]:
        return events_of(read_events(tr.telemetry.path), name)

    tr.fit(1)  # steps 1-2 and the boundary save
    (save,) = events("checkpoint")
    out: dict = {"sync_save_s": save["duration_s"],
                 "sync_save_bytes": save["bytes"],
                 "sync_save_step": save["iteration"]}
    if not save["bytes"] > RES_R50_MIN_SAVE_BYTES:
        fail(f"resilience (g2): the synchronous save wrote {save['bytes']} B")
    cfg.num_batches_per_epoch, cfg.checkpoint_every_epochs = 6, 1000
    metrics = tr.fit(1)  # bad steps 4-6, the rollback, steps 3-8 again
    bad, rbs = events("bad_step"), events("rollback")
    loss = metrics["train"]["loss"]
    out.update(bad_steps=[r["step"] for r in bad],
               rollback_to=[r["restored_iteration"] for r in rbs],
               final_loss=loss)
    if ([r["step"] for r in bad] != [4, 5, 6]
            or [r["restored_iteration"] for r in rbs] != [2]
            or not np.isfinite(loss)):
        fail(f"resilience (g2): bad steps {bad}, rollbacks {rbs}, loss {loss}")
    # the cost of --ckpt-every-steps: one epoch without, one with; then the
    # prefetch's gain: one epoch without checkpoints through the bare loader
    cfg.num_batches_per_epoch = None
    prefetch = tr.bundle.train
    if not isinstance(prefetch, PrefetchLoader) or prefetch.workers != 2:
        fail(f"resilience (g2): the train loader is {prefetch!r}, not the "
             f"default prefetch of 2 workers")
    timed = {}
    for epoch, every, loader in ((2, 0, prefetch),
                                 (3, RES_CKPT_EVERY, prefetch),
                                 (4, 0, prefetch.inner)):
        cfg.ckpt_every_steps = every
        tr.bundle.train = loader
        tr.train_epoch(epoch)
        tr._poll_async_ckpt(block=True)
        starts = [r["start_s"] for r in events("step") if r["epoch"] == epoch]
        timed[epoch] = [1e3 * (b - a) for a, b in zip(starts, starts[1:])]
    asyncs = [r for r in events("checkpoint") if r.get("async")]
    tr.close()
    without, with_ckpt, bare = timed[2], timed[3], timed[4]
    out.update(
        timed_intervals=len(without),
        step_ms_without=float(np.median(without)),
        step_ms_mean_without=float(np.mean(without)),
        step_ms_with_async=float(np.median(with_ckpt)),
        step_ms_mean_with_async=float(np.mean(with_ckpt)),
        data_workers=prefetch.workers,
        step_ms_no_prefetch=float(np.median(bare)),
        step_ms_mean_no_prefetch=float(np.mean(bare)),
        async_saves=len(asyncs),
        async_save_s=[r["duration_s"] for r in asyncs],
        async_save_bytes=[r["bytes"] for r in asyncs],
        async_commit_lag_steps=[r["commit_iteration"] - r["iteration"]
                                for r in asyncs],
    )
    if len(asyncs) != (len(with_ckpt) + 1) // RES_CKPT_EVERY:
        fail(f"resilience (g2): {len(asyncs)} async saves committed")
    out["phase_s"] = time.perf_counter() - t0
    return out


def phase_resilience() -> dict:
    """(g) Resumable training on the card: (g1) and (g3) on the PTB LSTM,
    (g2) on ResNet-50."""
    with tempfile.TemporaryDirectory(prefix="mgwfbp_resilience_") as work:
        try:
            lstm = resilience_lstm(work)
        finally:
            _kill_children()  # a failed check leaves no process behind
        print(f"resilience (g1): rcs {lstm['rcs']}, resumed at "
              f"{lstm['resume_steps']}, B vs A {lstm['max_abs_diff_b_vs_a']}"
              f" (deterministic {lstm['deterministic']}), relaunch to first "
              f"step {lstm['relaunch_to_first_resumed_step_s']:.2f} s "
              f"({lstm['relaunch_marks_s']}), drain "
              f"{lstm['drain_s_signal_to_exit']:.2f} s, evaluate "
              f"{lstm['evaluate']}", flush=True)
        r50 = resilience_resnet50(work)
        print(f"resilience (g2): sync save {r50['sync_save_s']:.3f} s for "
              f"{r50['sync_save_bytes']} B, rollback to "
              f"{r50['rollback_to']} after bad steps {r50['bad_steps']}, "
              f"step ms without / with async saves "
              f"{r50['step_ms_without']:.2f} / "
              f"{r50['step_ms_with_async']:.2f} (means "
              f"{r50['step_ms_mean_without']:.2f} / "
              f"{r50['step_ms_mean_with_async']:.2f}); prefetch of "
              f"{r50['data_workers']} workers / none "
              f"{r50['step_ms_without']:.2f} / "
              f"{r50['step_ms_no_prefetch']:.2f} (means "
              f"{r50['step_ms_mean_without']:.2f} / "
              f"{r50['step_ms_mean_no_prefetch']:.2f})", flush=True)
    return {"lstm": lstm, "resnet50": r50}


# phase (h): the paper's CNN zoo at full width, each with its preset batch
# and dtype, on the synthetic twin of its dataset
ZOO = (("googlenet", 64, "bfloat16"), ("inceptionv4", 64, "bfloat16"),
       ("densenet201", 64, "bfloat16"), ("vgg16", 128, "float32"))
ZOO_WARMUP_STEPS = 3  # through the trainer's own loop
ZOO_TIMED_STEPS = 10  # on a fixed device batch, after 3 more of warm-up
ZOO_PROFILE_STEPS = 3  # profiled steps per model (the busy share, kernels)
ZOO_CPU_IMAGES = 2
# the card's float32 eval forward of the trained weights, converted into a
# fresh CPU module, against that module's forward: TF32 is off, and cuDNN's
# algorithms (Winograd, FFT, implicit GEMM) sum in other orders than the
# CPU's through 16-200 layers; the bound is relative to the largest logit
ZOO_CPU_TOL = 1e-3


def _zoo_cpu_check(name: str, model, x: np.ndarray) -> dict:
    """Eval forward of the trained weights on the card (float32) against a
    fresh CPU module that takes them through convert (variables_to_flax ->
    state_from_flax)."""
    from mgwfbp_tpu_torch import models
    from mgwfbp_tpu_torch.convert import state_from_flax, variables_to_flax

    params, bstats = variables_to_flax(model)
    cpu, _ = models.create_model(name)
    cpu.load_state_dict(state_from_flax(cpu, params, bstats or None),
                        strict=True)
    cpu.eval()
    model.eval()
    try:
        with torch.no_grad():
            xt = torch.from_numpy(x).movedim(-1, -3).contiguous()
            card = model(xt.to(TRAIN_DEVICE)).float().cpu().numpy()
            plain = cpu(xt).numpy()
    finally:
        model.train()
    scale = max(1.0, float(np.abs(plain).max()))
    err = float(np.abs(card - plain).max())
    if card.shape != plain.shape or not np.isfinite(card).all() or (
        err > ZOO_CPU_TOL * scale
    ):
        fail(f"zoo {name}: the card's forward differs from the CPU's: max "
             f"abs {err:.3e} (largest logit {scale:.3g}, shape {card.shape})")
    return {"max_abs_err": err, "largest_logit": scale,
            "tolerance": f"{ZOO_CPU_TOL} x max(1, largest logit)",
            "images": len(x)}


def _zoo_run(name: str, batch: int, dtype: str, root: str) -> dict:
    """One zoo model: the Trainer at its preset batch and dtype, its step
    swapped for one with the mgwfbp merged all-reduce (hooks, NCCL at one
    worker; tb measured by the trainer's hooks, MERGING_LINK's constants);
    warm-up steps through the trainer's loop, then ZOO_TIMED_STEPS on one
    device batch, a profile, held groups, peak memory and the CPU check."""
    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.parallel.allreduce import make_merged_allreduce
    from mgwfbp_tpu_torch.parallel.costmodel import lookup_alpha_beta
    from mgwfbp_tpu_torch.train import Trainer, TrainStep

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = make_config(name, batch_size=batch, dtype=dtype, augment=False,
                      num_batches_per_epoch=ZOO_WARMUP_STEPS,
                      logdir=os.path.join(root, name), checkpoint_dir=None)
    tr = Trainer(cfg, device=TRAIN_DEVICE, synthetic_data=True)
    build_s = time.perf_counter() - t0
    tb = tr._profile_backward()
    _, perm, names = tr._arrival_leaves()
    t_solve = time.perf_counter()
    reducer = make_merged_allreduce(
        tr.model, policy="mgwfbp", tb=tb,
        cost_model=lookup_alpha_beta(*MERGING_LINK),
    )
    solve_s = time.perf_counter() - t_solve  # the solver, on the host
    tr.train_step = TrainStep(
        tr.model, tr.optimizer, tr.lr_fn, reducer=reducer,
        task=tr.meta.task, compute_dtype=tr.compute_dtype,
    )
    tr.fit(1)
    losses = list(tr.losses)
    xb, yb = tr.bundle.train.load_batch(0, 0)
    if xb.shape != (batch, *tr.meta.input_shape):
        fail(f"zoo {name}: the loader gives {xb.shape}, the model takes "
             f"{tr.meta.input_shape}")
    x, y = tr._to_device(xb[None], yb[None])
    launches, times = [], []
    for i in range(3 + ZOO_TIMED_STEPS):
        before = reducer.launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = tr.train_step(x, y)
        end.record()
        torch.cuda.synchronize()
        losses.append(float(m["loss"]))
        launches.append(reducer.launches - before)
        if i >= 3:
            times.append(start.elapsed_time(end))
    prof = _step_profile(lambda: tr.train_step(x, y),
                         steps=ZOO_PROFILE_STEPS)
    arrivals = list(reducer.arrivals)
    groups = [list(g) for g in reducer.schedule.groups]
    g = reducer.num_groups
    peak = torch.cuda.max_memory_allocated()
    if launches != [g] * len(launches):
        fail(f"zoo {name}: all-reduce launches per step {launches}, "
             f"expected {g} (num_groups)")
    if sorted(arrivals) != list(range(len(names))):
        fail(f"zoo {name}: the hooks fired for {len(arrivals)} leaf "
             f"arrivals, not each of {len(names)} leaves once")
    if not np.isfinite(losses).all():
        fail(f"zoo {name}: non-finite loss in {losses}")
    meta = tr.meta
    cpu = _zoo_cpu_check(name, tr.model, xb[:ZOO_CPU_IMAGES])
    reducer.detach()
    names_arr = [names[j] for j in perm]
    aux = [i for i, n in enumerate(names_arr) if n.startswith("['aux")]
    step_ms = float(np.median(times))
    out = {
        "model": name, "batch": batch, "dtype": dtype,
        "input": list(meta.input_shape), "leaves": len(names),
        "params": int(sum(p.numel() for p in tr.model.parameters())),
        "step_ms": step_ms, "step_ms_min": float(np.min(times)),
        "images_per_s": batch * 1e3 / step_ms,
        "busy_share": prof["busy_share"],
        "kernels_per_step": prof["kernels_per_step"],
        "device_ms_per_step": prof["device_ms_per_step"],
        "top_kernels_ms_per_step": prof["top_kernels_ms_per_step"],
        "num_groups": g, "largest_group": max(len(gr) for gr in groups),
        "held_groups": _held_groups(groups, arrivals),
        "held_groups_one_leaf_per_group": _held_groups(
            [[k] for k in range(len(names))], arrivals),
        "cost_model": f"{MERGING_LINK[0]} at {MERGING_LINK[1]} workers",
        "tb_total_s": float(sum(tb)), "tb_source": tb.source,
        "reducer_build_s": solve_s,
        "allreduce_launches_per_step": launches[0],
        "peak_memory_bytes": int(peak),
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "steps": len(losses), "cpu_check": cpu, "build_s": build_s,
        "wall_s": time.perf_counter() - t0,
    }
    if aux:
        out["aux_leaves_in_the_permutation"] = aux
        out["aux_leaves_measured"] = [arrivals.index(i) for i in aux]
    tr.close()
    return out


def phase_zoo() -> list[dict]:
    """(h) The zoo at full width through the Trainer with the merged
    all-reduce over NCCL at one worker."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch.ops import flash_attention
    from mgwfbp_tpu_torch.parallel.mesh import init_distributed

    dev = torch.device(TRAIN_DEVICE, 0)
    rdv = tempfile.TemporaryDirectory(prefix="mgwfbp_zoo_nccl_")
    init_distributed(dev, num_processes=1, process_id=0,
                     init_method=f"file://{os.path.join(rdv.name, 'rdv')}")
    flash_attention.launches = 0
    rows = []
    try:
        with tempfile.TemporaryDirectory(prefix="mgwfbp_zoo_") as root:
            for name, batch, dtype in ZOO:
                r = _zoo_run(name, batch, dtype, root)
                print(json.dumps({"zoo": r}), flush=True)
                print(f"zoo (h): {name} batch {batch} {dtype}: step "
                      f"{r['step_ms']:.2f} ms ({r['images_per_s']:.0f} "
                      f"images/s), busy {r['busy_share']}, "
                      f"{r['kernels_per_step']:.0f} kernels per step, "
                      f"{r['num_groups']} groups ({r['held_groups']} held; "
                      f"{r['held_groups_one_leaf_per_group']} of "
                      f"{r['leaves']} one leaf per group), peak "
                      f"{r['peak_memory_bytes'] / 2**30:.2f} GiB, loss "
                      f"{r['loss_first']:.4f} -> {r['loss_last']:.4f}, card "
                      f"vs CPU {r['cpu_check']['max_abs_err']:.2e}, "
                      f"{r['wall_s']:.1f} s", flush=True)
                rows.append(r)
    finally:
        dist.destroy_process_group()
        rdv.cleanup()
    if flash_attention.launches:
        fail(f"zoo: the path launched the flash kernel "
             f"{flash_attention.launches} times")
    return rows


# phase (i): the speech model at full width on the real AN4 utterances
AN4_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "an4_memcheck")
AN4_EPOCHS = 4  # of 11 steps at batch 4 (45 utterances)
AN4_TIMED_STEPS = 20  # on one device batch, after 5 of warm-up
# the card's float32 eval logits against the same weights in a CPU module,
# relative to max(1, the largest logit): TF32 is off, and cuDNN's LSTM and
# convolutions sum in other orders than the CPU's through five recurrent
# layers over up to 320 frames
AN4_CPU_TOL = 1e-3


def _an4_cpu_check(model, tr) -> dict:
    """The card's eval forward on every val batch against the same weights
    converted into a CPU module (variables_to_flax -> state_from_flax): the
    largest logit difference, and how many utterances greedy-decode to the
    same string on both."""
    from mgwfbp_tpu_torch import models
    from mgwfbp_tpu_torch.convert import state_from_flax, variables_to_flax
    from mgwfbp_tpu_torch.data.audio import greedy_decode

    params, bstats = variables_to_flax(model)
    cpu, _ = models.create_model("lstman4")
    cpu.load_state_dict(state_from_flax(cpu, params, bstats), strict=True)
    cpu.eval()
    model.eval()
    err, scale, same, total = 0.0, 1.0, 0, 0
    try:
        with torch.no_grad():
            for batch in tr.bundle.val:
                x = torch.from_numpy(batch["x"])
                lens = torch.from_numpy(batch["input_lengths"]).long()
                card, olen = model(x.to(TRAIN_DEVICE), lens.to(TRAIN_DEVICE))
                card = card.float().cpu().numpy()
                plain, plen = cpu(x, lens)
                plain = plain.numpy()
                if card.shape != plain.shape or not np.isfinite(card).all() \
                        or olen.cpu().tolist() != plen.tolist():
                    fail(f"lstman4: the card's eval forward {card.shape} "
                         f"differs in shape, lengths or finiteness from the "
                         f"CPU's {plain.shape}")
                err = max(err, float(np.abs(card - plain).max()))
                scale = max(scale, float(np.abs(plain).max()))
                a = greedy_decode(card, plen.numpy())
                b = greedy_decode(plain, plen.numpy())
                same += sum(x == y for x, y in zip(a, b))
                total += len(a)
    finally:
        model.train()
    if err > AN4_CPU_TOL * scale:
        fail(f"lstman4: the card's eval logits differ from the CPU's by "
             f"{err:.3e} (largest logit {scale:.3g})")
    return {"max_abs_err": err, "largest_logit": scale,
            "tolerance": f"{AN4_CPU_TOL} x max(1, largest logit)",
            "utterances": total, "same_greedy_decode": same}


def _an4_evaluator(ckpt_dir: str) -> dict:
    """``python -m mgwfbp_tpu_torch.evaluate --dnn lstman4`` on the run's
    newest epoch boundary, in a process of its own."""
    run = _start([sys.executable, "-m", "mgwfbp_tpu_torch.evaluate",
                  "--dnn", "lstman4", "--checkpoint-dir", ckpt_dir,
                  "--data-dir", AN4_DIR, "--batch-size", "4",
                  "--device", TRAIN_DEVICE],
                 _res_env(), ckpt_dir + ".evaluate.err")
    try:
        rc, line, err = _finish(run, "lstman4 evaluate")
    finally:
        _kill_children()
    if rc != 0:
        fail(f"lstman4: evaluate exited {rc}: {err[-2000:]}")
    return json.loads(line)


def phase_lstman4() -> dict:
    """(i) The speech model a user would train: lstman4 at full width
    (hidden 800, 5 layers, unidirectional + Lookahead, 27,553,504
    parameters) with its preset (batch 4, float32, lr 2e-4 anneal, norm
    clip 400) on the real utterances of data/an4_memcheck, through the
    Trainer with its step swapped for one with the mgwfbp merged all-reduce
    (hooks, NCCL at one worker; tb from the trainer's hooks, MERGING_LINK's
    constants), the train batches through the default prefetch and the
    native host library: AN4_EPOCHS epochs whose last 5 losses fall below
    the first 5's, all finite, each committed; one evaluate (finite CTC
    loss, WER >= 0) equal to the offline evaluator's on the committed step;
    the commit read back equal to the live parameters and batch
    statistics; the card's eval logits against a CPU module (AN4_CPU_TOL);
    no flash launch. Then the step on one device batch (CUDA events,
    median of AN4_TIMED_STEPS after 5), utterances/s, the profile, peak
    memory, the groups and the held groups, the reducer's build time."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch import native
    from mgwfbp_tpu_torch.checkpoint import read_step
    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.convert import flatten_flax, variables_to_flax
    from mgwfbp_tpu_torch.data import PrefetchLoader
    from mgwfbp_tpu_torch.ops import flash_attention
    from mgwfbp_tpu_torch.parallel.allreduce import make_merged_allreduce
    from mgwfbp_tpu_torch.parallel.costmodel import lookup_alpha_beta
    from mgwfbp_tpu_torch.parallel.mesh import init_distributed
    from mgwfbp_tpu_torch.train import Trainer, TrainStep
    from mgwfbp_tpu_torch.train.trainer import batch_fields

    if not native.available():
        fail(f"lstman4: the native host library did not build or load: "
             f"{native.build_error}")
    dev = torch.device(TRAIN_DEVICE, 0)
    rdv = tempfile.TemporaryDirectory(prefix="mgwfbp_an4_nccl_")
    init_distributed(dev, num_processes=1, process_id=0,
                     init_method=f"file://{os.path.join(rdv.name, 'rdv')}")
    flash_attention.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    work = tempfile.TemporaryDirectory(prefix="mgwfbp_an4_")
    try:
        cfg = make_config("lstman4", data_dir=AN4_DIR,
                          eval_every_epochs=1000,
                          logdir=os.path.join(work.name, "logs"),
                          checkpoint_dir=os.path.join(work.name, "ckpt"))
        tr = Trainer(cfg, device=TRAIN_DEVICE)
        build_s = time.perf_counter() - t0
        if tr.bundle.synthetic or not isinstance(tr.bundle.train,
                                                 PrefetchLoader):
            fail(f"lstman4: synthetic {tr.bundle.synthetic}, train loader "
                 f"{type(tr.bundle.train).__name__}")
        tb = tr._profile_backward()
        _, perm, names = tr._arrival_leaves()
        t_solve = time.perf_counter()
        reducer = make_merged_allreduce(
            tr.model, policy="mgwfbp", tb=tb,
            cost_model=lookup_alpha_beta(*MERGING_LINK),
        )
        solve_s = time.perf_counter() - t_solve
        tr.train_step = TrainStep(
            tr.model, tr.optimizer, tr.lr_fn, reducer=reducer,
            task="ctc", norm_clip=tr.train_step.norm_clip,
        )
        t_fit = time.perf_counter()
        tr.fit(AN4_EPOCHS)
        fit_s = time.perf_counter() - t_fit
        losses = list(tr.losses)
        first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        if (len(losses) != 11 * AN4_EPOCHS or not np.isfinite(losses).all()
                or not last5 < first5):
            fail(f"lstman4: {len(losses)} steps, loss first 5 {first5:.4f}, "
                 f"last 5 {last5:.4f} ({losses})")
        ev = tr.evaluate()
        if not (np.isfinite(ev["loss"]) and np.isfinite(ev["wer"])
                and ev["wer"] >= 0.0 and ev["count"] == 44):
            fail(f"lstman4: evaluate returned {ev}")
        params, bstats, meta = read_step(tr.ckpt_dir, tr.iteration)
        live_p, live_b = variables_to_flax(tr.model)
        for live, saved in ((live_p, params), (live_b, bstats)):
            live = flatten_flax(live)
            if list(live) != list(saved) or not all(
                np.array_equal(live[k], saved[k]) for k in live
            ):
                fail("lstman4: the committed step does not read back equal "
                     "to the live parameters and batch statistics")
        offline = _an4_evaluator(tr.ckpt_dir)
        rel = abs(offline["loss"] - ev["loss"]) / abs(ev["loss"])
        if not (offline["wer"] == ev["wer"] and rel <= RES_EVAL_RTOL
                and offline["epoch"] == AN4_EPOCHS - 1):
            fail(f"lstman4: the evaluator's {offline} against the trainer's "
                 f"{ev}")
        cpu = _an4_cpu_check(tr.model, tr)
        # the step on one device batch
        fields = batch_fields(tr.bundle.train.load_batch(0, 0))
        x, y, ilen, llen = tr._to_device(*(f[None] for f in fields))
        launches, times = [], []
        for i in range(5 + AN4_TIMED_STEPS):
            before = reducer.launches
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tr.train_step(x, y, lengths=(ilen, llen))
            end.record()
            torch.cuda.synchronize()
            launches.append(reducer.launches - before)
            if i >= 5:
                times.append(start.elapsed_time(end))
        prof = _step_profile(
            lambda: tr.train_step(x, y, lengths=(ilen, llen)))
        arrivals = list(reducer.arrivals)
        groups = [list(g) for g in reducer.schedule.groups]
        g = reducer.num_groups
        if launches != [g] * len(launches):
            fail(f"lstman4: all-reduce launches per step {launches}, "
                 f"expected {g}")
        if sorted(arrivals) != list(range(len(names))):
            fail(f"lstman4: the hooks fired {len(arrivals)} arrivals, not "
                 f"each of {len(names)} leaves once")
        peak = torch.cuda.max_memory_allocated()
        step_ms = float(np.median(times))
        out = {
            "model": "lstman4", "batch": 4, "dtype": "float32",
            "input": list(x.shape[2:]), "leaves": len(names),
            "batch_stat_leaves": len(flatten_flax(live_b)),
            "params": int(sum(p.numel() for p in tr.model.parameters())),
            "steps": len(losses), "loss_first5": first5, "loss_last5": last5,
            "fit_s": fit_s, "eval": ev, "evaluator": offline,
            "evaluator_loss_rel_err": rel, "cpu_check": cpu,
            "step_ms": step_ms, "step_ms_min": float(np.min(times)),
            "utterances_per_s": 4e3 / step_ms,
            "busy_share": prof["busy_share"],
            "kernels_per_step": prof["kernels_per_step"],
            "device_ms_per_step": prof["device_ms_per_step"],
            "top_kernels_ms_per_step": prof["top_kernels_ms_per_step"],
            "top_host_ops_ms_per_step": prof["top_host_ops_ms_per_step"],
            "peak_memory_bytes": int(peak),
            "num_groups": g, "largest_group": max(len(gr) for gr in groups),
            "held_groups": _held_groups(groups, arrivals),
            "held_groups_one_leaf_per_group": _held_groups(
                [[k] for k in range(len(names))], arrivals),
            "cost_model": f"{MERGING_LINK[0]} at {MERGING_LINK[1]} workers",
            "tb_total_s": float(sum(tb)), "tb_source": tb.source,
            "reducer_build_s": solve_s,
            "allreduce_launches_per_step": launches[0],
            "native_library": native.library_path(),
            "flash_launches": flash_attention.launches,
            "build_s": build_s, "wall_s": time.perf_counter() - t0,
        }
        reducer.detach()
        tr.close()
    finally:
        work.cleanup()
        dist.destroy_process_group()
        rdv.cleanup()
    if flash_attention.launches:
        fail(f"lstman4: the path launched the flash kernel "
             f"{flash_attention.launches} times")
    print(f"lstman4 (i): {out['steps']} steps, loss {first5:.2f} -> "
          f"{last5:.2f}, eval loss {ev['loss']:.3f} wer {ev['wer']:.4f} "
          f"(evaluator {offline['wer']:.4f}), step {step_ms:.2f} ms "
          f"({out['utterances_per_s']:.1f} utterances/s), busy "
          f"{out['busy_share']}, {out['kernels_per_step']:.0f} kernels per "
          f"step, {g} groups ({out['held_groups']} held; "
          f"{out['held_groups_one_leaf_per_group']} of {len(names)} one leaf "
          f"per group), peak {peak / 2**30:.2f} GiB, card vs CPU "
          f"{cpu['max_abs_err']:.2e} ({cpu['same_greedy_decode']} of "
          f"{cpu['utterances']} decode alike), {out['wall_s']:.1f} s",
          flush=True)
    return out


# phase (j): the supervisor, the watchdog, the live plane, cross-world resume
SUP_TIMEOUT_S = 420  # one supervised run, its relaunches included
SUP_GRACE_S = 10.0  # MGWFBP_LIVENESS_GRACE_S of the heal run
SUP_PLAN = "preempt@step=6;kill@step=12,inc=1;wedge@step=18,secs=600,inc=2"
SUP_EPOCHS, SUP_EPOCH_STEPS = 2, 12  # the heal run: 24 ResNet-20 steps
WATCHDOG_S = 5  # MGWFBP_WATCHDOG_S of the watchdog run
WATCHDOG_PLAN = "stall@secs=60,step=5"
XW_TRAIN_N = 512  # cross-world: 8 steps per epoch at 2 x 32, 16 at 1 x 32
SERVE_PLAN = "stall@secs=30,step=7"  # holds the run open after a commit
SERVE_EXAMPLES = 2


def _sup_env(plan: str = "", **extra) -> dict:
    return dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
                MGWFBP_FAULT_PLAN=plan,
                PYTHONPATH=os.path.dirname(os.path.abspath(__file__)),
                **extra)


def _supervise(log_dir: str, train_args: list, env: dict, processes: int = 1,
               sup_args: tuple = ()) -> subprocess.Popen:
    """``python -m mgwfbp_tpu_torch.runtime.supervise`` as a user runs it;
    its own log goes to <log_dir>.err."""
    os.makedirs(log_dir, exist_ok=True)
    err = open(log_dir + ".err", "w")
    p = subprocess.Popen(
        [sys.executable, "-m", "mgwfbp_tpu_torch.runtime.supervise",
         "--processes", str(processes), "--log-dir", log_dir, *sup_args,
         "--", *train_args],
        stdout=err, stderr=subprocess.STDOUT, env=env)
    _CHILDREN.append(p)
    p._err_file = err  # closed by _wait_supervised
    return p


def _wait_supervised(p: subprocess.Popen, log_dir: str, name: str,
                     want_rc: int = 0) -> str:
    try:
        p.wait(timeout=SUP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        fail(f"supervise (j) {name}: exceeded {SUP_TIMEOUT_S}s")
    p._err_file.close()
    with open(log_dir + ".err") as f:
        err = f.read()
    if p.returncode != want_rc:
        tail = "\n".join(err.splitlines()[-15:])
        fail(f"supervise (j) {name}: rc {p.returncode}, wanted {want_rc}:\n"
             f"{tail}")
    return err


def _tag_stream(logdir: str, world: int = 1, rank: int = 0) -> list[dict]:
    from mgwfbp_tpu_torch.telemetry import read_events, stream_filename

    (tag,) = [t for t in os.listdir(logdir) if f"-n{world}-" in t]
    return read_events(os.path.join(logdir, tag,
                                    stream_filename(rank, world)))


def _last_commit(ckpt_root: str, world: int = 1) -> tuple[int, dict]:
    from mgwfbp_tpu_torch.checkpoint import peek_steps, read_step

    (tag,) = [t for t in os.listdir(ckpt_root) if f"-n{world}-" in t]
    d = os.path.join(ckpt_root, tag)
    step = peek_steps(d)[-1]
    params, bstats, _ = read_step(d, step)
    return step, {**{f"params/{k}": v for k, v in params.items()},
                  **{f"batch_stats/{k}": v for k, v in bstats.items()}}


def _resnet20_args(root: str, *extra: str) -> list:
    return ["--dnn", "resnet20", "--synthetic", "--deterministic",
            "--telemetry", "--checkpoint-dir", os.path.join(root, "ckpt"),
            "--logdir", os.path.join(root, "logs"), *extra]


def supervise_heal(work: str) -> dict:
    """(j1) One supervised process on the card, healed from a preemption, a
    SIGKILL and a wedge, against an uninterrupted run of the same command."""
    from mgwfbp_tpu_torch.telemetry import events_of

    args = ["--max-epochs", str(SUP_EPOCHS), "--num-batches-per-epoch",
            str(SUP_EPOCH_STEPS), "--ckpt-every-steps", "5",
            "--metrics-port", "0"]
    env = dict(MGWFBP_METRICS_PORT="0", MGWFBP_LIVENESS_GRACE_S=str(SUP_GRACE_S))
    ref, heal = os.path.join(work, "ref"), os.path.join(work, "heal")
    # the two runs side by side: each is deterministic on its own
    t0 = time.perf_counter()
    p_ref = _supervise(ref + "/sup", _resnet20_args(ref, *args),
                       _sup_env(**env))
    p = _supervise(heal + "/sup", _resnet20_args(heal, *args),
                   _sup_env(SUP_PLAN, **env))
    _wait_supervised(p_ref, ref + "/sup", "uninterrupted run")
    ref_s = time.perf_counter() - t0
    err = _wait_supervised(p, heal + "/sup", "heal run")
    heal_s = time.perf_counter() - t0
    codes = [line.split("exit codes ", 1)[1] for line in err.splitlines()
             if "exit codes" in line]
    if codes != ["[75]", "[-9]", "[75]", "[0]"]:
        fail(f"supervise (j1): incarnations exited {codes}, wanted "
             "[75], [-9], [75], [0]")
    from mgwfbp_tpu_torch.telemetry import read_events

    sup = read_events(os.path.join(heal, "sup", "telemetry.supervisor.jsonl"))
    seq = [(e["event"], e.get("class"), e.get("action")) for e in sup
           if e["event"] in ("failure", "heal")]
    want = [("failure", "oom_kill", None), ("heal", "oom_kill", "relaunch"),
            ("failure", "wedged", None), ("heal", "wedged", "relaunch")]
    if seq != want:
        fail(f"supervise (j1): supervisor events {seq}, wanted {want}")
    step_a, a = _last_commit(os.path.join(heal, "ckpt"))
    step_b, b = _last_commit(os.path.join(ref, "ckpt"))
    last = SUP_EPOCHS * SUP_EPOCH_STEPS
    if step_a != last or step_b != last or list(a) != list(b):
        fail(f"supervise (j1): final commits {step_a} / {step_b} of {last}")
    differ = [k for k in a if not np.array_equal(a[k], b[k])]
    if differ:
        fail(f"supervise (j1): healed run differs from the uninterrupted one "
             f"in {len(differ)} leaves, e.g. {differ[:3]}")
    # the child's stream spans the four incarnations: each life after the
    # first starts with a resume; its first step against the previous
    # life's exit (the drain's preempt event, or the supervisor's failure
    # event for the SIGKILL)
    recs = _tag_stream(os.path.join(heal, "logs"))
    oom = [e for e in sup if e.get("class") == "oom_kill"][0]
    wedged = [e for e in sup if e.get("class") == "wedged"][0]
    exits, relaunch = [], []
    preempts = iter(events_of(recs, "preempt"))
    for k, r in enumerate(recs):
        if r["event"] != "resume":
            continue
        exit_wall = oom["wall"] if len(relaunch) == 1 else next(preempts)["wall"]
        first = next(x for x in recs[k:] if x["event"] == "step")
        exits.append(exit_wall)
        relaunch.append(first["wall"] - exit_wall)
    if len(relaunch) != 3:
        fail(f"supervise (j1): {len(relaunch)} resumes in the stream, wanted 3")
    # where a relaunch's seconds go: the trainer's first log line (imports
    # done), the model on the card, the restore, against the exit
    marks = []
    for k, exit_wall in enumerate(exits, start=1):
        with open(os.path.join(heal, "sup", f"p0.i{k}.log")) as f:
            marks.append(_log_marks(f.read(), exit_wall))
    frozen = [r for r in recs if r["event"] == "step" and r["step"] == 17]
    wedge_to_verdict = wedged["wall"] - frozen[-1]["wall"]
    if not SUP_GRACE_S <= wedge_to_verdict <= SUP_GRACE_S + 5:
        fail(f"supervise (j1): wedge to verdict {wedge_to_verdict:.3f} s "
             f"against a {SUP_GRACE_S} s grace")
    out = {"incarnations": 4, "exit_codes": [75, -9, 75, 0],
           "bitwise_equal_to_uninterrupted": True, "final_step": last,
           "relaunch_to_first_step_s": relaunch, "relaunch_marks_s": marks,
           "wedge_to_verdict_s": wedge_to_verdict,
           "liveness_grace_s": SUP_GRACE_S,
           "uninterrupted_wall_s": ref_s, "healed_wall_s": heal_s}
    print(f"supervise (j1): 4 incarnations {codes}, healed run equal to the "
          f"uninterrupted one at step {last}; exit to first step "
          f"{', '.join(f'{x:.2f}' for x in relaunch)} s; wedge to verdict "
          f"{wedge_to_verdict:.2f} s (grace {SUP_GRACE_S} s); {heal_s:.1f} s "
          f"healed, {ref_s:.1f} s uninterrupted", flush=True)
    return out


def supervise_watchdog(work: str) -> dict:
    """(j2) A supervised process whose step loop stalls: the watchdog dumps
    the stacks, /healthz answers 503, the child exits 86 and the supervisor
    stops with 86. The native library is removed first, so the child's
    first batch builds it under the first-step allowance."""
    from mgwfbp_tpu_torch import native
    from mgwfbp_tpu_torch.telemetry import events_of

    so = native.library_path()
    if os.path.exists(so):
        os.unlink(so)
    root = os.path.join(work, "watchdog")
    log_dir = os.path.join(root, "sup")
    env = _sup_env(WATCHDOG_PLAN, MGWFBP_METRICS_PORT="0",
                   MGWFBP_WATCHDOG_S=str(WATCHDOG_S), MGWFBP_WATCHDOG_ABORT="1")
    t_launch = time.time()
    p = _supervise(log_dir, _resnet20_args(
        root, "--epochs", "1", "--num-batches-per-epoch", "12",
        "--metrics-port", "0"), env)
    port_file = os.path.join(log_dir, "metrics_port.p0.json")
    first_503, seen_ok = None, False
    while p.poll() is None and time.time() - t_launch < SUP_TIMEOUT_S:
        try:
            with open(port_file) as f:
                port = json.load(f)["port"]
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                        timeout=2) as r:
                seen_ok = seen_ok or r.status == 200
        except urllib.error.HTTPError as e:
            if e.code == 503 and first_503 is None:
                first_503 = time.time()
        except (OSError, ValueError, KeyError):
            pass
        time.sleep(0.05)
    err = _wait_supervised(p, log_dir, "watchdog run", want_rc=86)
    if "watchdog abort (rc 86)" not in err:
        fail("supervise (j2): the supervisor did not stop on the watchdog")
    with open(os.path.join(log_dir, "p0.i0.log")) as f:
        child = f.read()
    if "all-thread traceback dump" not in child or "Thread 0x" not in child:
        fail("supervise (j2): no stack dump in the child's log")
    if "native host augment loaded" not in child or not os.path.exists(so):
        fail("supervise (j2): the native library was not rebuilt")
    if first_503 is None or not seen_ok:
        fail(f"supervise (j2): /healthz never answered 503 (200 seen: "
             f"{seen_ok})")
    recs = _tag_stream(os.path.join(root, "logs"))
    stalls = events_of(recs, "watchdog_stall")
    steps = events_of(recs, "step")
    if len(stalls) != 1 or not stalls[0]["abort"] or steps[-1]["step"] != 4:
        fail(f"supervise (j2): stalls {stalls}, last step {steps[-1]}")
    stall_start = steps[-1]["wall"]
    out = {"rc": 86, "stack_dump": True, "healthz_503": True,
           "stall_to_watchdog_event_s": stalls[0]["wall"] - stall_start,
           "stall_to_first_503_s": first_503 - stall_start,
           "watchdog_s": WATCHDOG_S, "abort_hold_s": 1.0,
           "launch_to_first_step_s": steps[0]["wall"] - t_launch,
           "cold_native_build": True}
    print(f"supervise (j2): rc 86 after a stack dump; stall to the "
          f"watchdog_stall event {out['stall_to_watchdog_event_s']:.2f} s, to "
          f"the first 503 {out['stall_to_first_503_s']:.2f} s (timeout "
          f"{WATCHDOG_S} s); launch to the first step "
          f"{out['launch_to_first_step_s']:.2f} s with a cold native build",
          flush=True)
    return out


def supervise_cross_world(work: str) -> dict:
    """(j3) A supervised 2-process gloo group on the CPU commits ResNet-20
    under its n2 tag; a world-1 trainer on the card resumes from it (checked
    in this process: iteration, parameters bit for bit, the continued
    schedule), then the same command at one process on the card trains to
    the end."""
    from mgwfbp_tpu_torch.checkpoint import peek_steps, read_step
    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.convert import flatten_flax, variables_to_flax
    from mgwfbp_tpu_torch.telemetry import events_of
    from mgwfbp_tpu_torch.train import Trainer

    root = os.path.join(work, "xw")
    synth = dict(MGWFBP_SYNTH_TRAIN_N=str(XW_TRAIN_N), MGWFBP_SYNTH_VAL_N="128")
    args = ["--dnn", "resnet20", "--synthetic", "--epochs", "1",
            "--ckpt-every-steps", "3", "--no-profile-backward", "--telemetry",
            "--checkpoint-dir", os.path.join(root, "ckpt"),
            "--logdir", os.path.join(root, "logs")]
    t0 = time.perf_counter()
    p = _supervise(os.path.join(root, "sup2"), args + ["--device", "cpu"],
                   _sup_env(OMP_NUM_THREADS="4", **synth), processes=2)
    _wait_supervised(p, os.path.join(root, "sup2"), "n2 gloo group")
    n2_s = time.perf_counter() - t0
    (tag2,) = os.listdir(os.path.join(root, "ckpt"))
    n2 = os.path.join(root, "ckpt", tag2)
    step = peek_steps(n2)[-1]
    params, _, meta = read_step(n2, step)
    old_nbpe = int(meta["steps_per_epoch"])
    anchor_epoch = float(meta["sched_epoch_offset"]) + (
        step - int(meta["sched_step_offset"])) / old_nbpe
    # in this process: the resume itself, checked before anything trains
    saved = {k: os.environ.get(k) for k in (*synth, "MGWFBP_ELASTIC_RESUME")}
    os.environ.update(synth, MGWFBP_ELASTIC_RESUME="1")
    try:
        cfg = make_config("resnet20", checkpoint_dir=os.path.join(root, "ckpt"),
                          logdir="")
        t0 = time.perf_counter()
        tr = Trainer(cfg, device=TRAIN_DEVICE, synthetic_data=True,
                     profile_backward=False)
        build_s = time.perf_counter() - t0
        try:
            got = flatten_flax(variables_to_flax(tr.model)[0])
            new_nbpe = tr._steps_per_epoch()
            lr_next = tr.lr_fn(int(tr.train_step.step) + 1)
            want_lr = tr.epoch_schedule(anchor_epoch + 1 / new_nbpe)
            if tr.iteration != step or list(got) != list(params) or any(
                    not np.array_equal(got[k], params[k]) for k in params):
                fail(f"supervise (j3): the world-1 resume at iteration "
                     f"{tr.iteration} differs from the n2 commit of {step}")
            if lr_next != want_lr or new_nbpe == old_nbpe:
                fail(f"supervise (j3): next LR {lr_next} against the "
                     f"continued schedule's {want_lr} ({old_nbpe} -> "
                     f"{new_nbpe} steps per epoch)")
        finally:
            tr.close()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    _keep("j3_logs", os.path.join(root, "logs"))  # the n2 streams, for (r)
    t0 = time.perf_counter()
    p = _supervise(os.path.join(root, "sup1"), args, _sup_env(**synth))
    _wait_supervised(p, os.path.join(root, "sup1"), "world-1 resume")
    n1_s = time.perf_counter() - t0
    recs = _tag_stream(os.path.join(root, "logs"))
    resize = events_of(recs, "resize")
    if len(resize) != 1 or (resize[0]["old_world"], resize[0]["new_world"],
                            resize[0]["iteration"]) != (2, 1, step):
        fail(f"supervise (j3): resize events {resize}")
    with open(os.path.join(root, "sup1", "p0.i0.log")) as f:
        result = json.loads(f.read().strip().splitlines()[-1])
    steps = events_of(recs, "step")
    if not np.isfinite(result["train"]["loss"]) or steps[-1]["step"] != (
            step + XW_TRAIN_N // 32):
        fail(f"supervise (j3): world-1 run ended at {steps[-1]['step']} with "
             f"{result['train']}")
    out = {"old_world": 2, "new_world": 1, "iteration": step,
           "params_bitwise": True, "steps_per_epoch": [old_nbpe, new_nbpe],
           "lr_next": lr_next, "restore_s": resize[0]["restore_s"],
           "in_process_trainer_build_s": build_s,
           "final_step": steps[-1]["step"], "final_loss": result["train"]["loss"],
           "n2_group_wall_s": n2_s, "n1_run_wall_s": n1_s}
    print(f"supervise (j3): n2 (gloo, CPU) commit {step} resumed at world 1 "
          f"on the card bit for bit, LR {lr_next:.6g} continued ({old_nbpe} -> "
          f"{new_nbpe} steps per epoch), restore {out['restore_s']:.3f} s, "
          f"trained to {steps[-1]['step']} (loss "
          f"{result['train']['loss']:.4f})", flush=True)
    return out


def _replica(log_dir: str, old_pid=None, timeout_s: float = 180.0) -> dict:
    """The replica's port file once it names a process other than
    ``old_pid``."""
    path = os.path.join(log_dir, "metrics_port.serve0.json")
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        try:
            with open(path) as f:
                doc = json.load(f)
            if doc["pid"] != old_pid:
                return doc
        except (OSError, ValueError, KeyError):
            pass
        time.sleep(0.2)
    fail(f"supervise (j4): no serving replica port file after {timeout_s}s")


def _answer(port: int, x: np.ndarray, timeout_s: float = 180.0) -> tuple:
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        try:
            code, doc, dt = _post(port, x.tolist())
        except OSError:
            code = None
        if code == 200:
            return doc, dt
        time.sleep(0.5)
    fail(f"supervise (j4): /predict did not answer 200 within {timeout_s}s")


def supervise_serving(work: str) -> dict:
    """(j4) The transformer trained by a supervised process on the card
    (dense attention) and served by a supervised replica through the flash
    kernel: /predict against a dense forward of the served step; the
    replica SIGKILLed once, respawned by the supervisor, answering again."""
    from mgwfbp_tpu_torch import models
    from mgwfbp_tpu_torch.checkpoint import read_step
    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.convert import state_from_flax
    from mgwfbp_tpu_torch.models.transformer import TransformerLM
    from mgwfbp_tpu_torch.telemetry import read_events

    root = os.path.join(work, "serve")
    log_dir = os.path.join(root, "sup")
    cfg = make_config("transformer")
    cfg.nworkers = 1
    ckdir = os.path.join(root, "ckpt", cfg.tag())
    module, meta = models.create_model("transformer")
    x = np.random.RandomState(1).randint(
        0, meta.num_classes, (SERVE_EXAMPLES,) + tuple(meta.input_shape))

    def dense(step: int) -> np.ndarray:
        params, _, _ = read_step(ckdir, step)
        ref = TransformerLM(vocab_size=meta.num_classes, attn_impl="dense")
        ref.load_state_dict(state_from_flax(ref, params))
        ref.to(TRAIN_DEVICE).eval()
        with torch.inference_mode():
            return ref(torch.from_numpy(x).to(TRAIN_DEVICE)).float().cpu().numpy()

    def check(doc: dict) -> tuple[int, float]:
        step = int(doc["served_step"])
        out = np.asarray(doc["outputs"], np.float32)
        want = dense(step)
        err = float(np.abs(out - want).max())
        if out.shape != want.shape or not np.isfinite(out).all() or (
                err > LOGITS_TOL):
            fail(f"supervise (j4): served step {step} differs from its dense "
                 f"forward by {err:.3e} (shape {out.shape})")
        return step, err

    def launches(port: int) -> int:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/status",
                                    timeout=10) as r:
            return int(json.load(r)["kernel_launches"]["flash_attention_fwd"])

    t0 = time.perf_counter()
    p = _supervise(log_dir, [
        "--dnn", "transformer", "--synthetic", "--epochs", "1",
        "--num-batches-per-epoch", "12", "--ckpt-every-steps", "5",
        # synchronous saves: step 5 is committed before the stall holds the
        # run open (an async commit lands at a later step's poll)
        "--no-ckpt-async",
        "--no-profile-backward", "--telemetry", "--metrics-port", "0",
        "--checkpoint-dir", os.path.join(root, "ckpt"),
        "--logdir", os.path.join(root, "logs")],
        _sup_env(SERVE_PLAN, MGWFBP_METRICS_PORT="0"),
        sup_args=("--serve-replicas", "1", "--serve-args",
                  f"--dnn transformer --checkpoint-dir {ckdir} --poll-s 0.5"))
    first = _replica(log_dir)
    doc, dt1 = _answer(first["port"], x)
    step1, err1 = check(doc)
    n1 = launches(first["port"])
    os.kill(first["pid"], signal.SIGKILL)
    t_kill = time.time()
    second = _replica(log_dir, old_pid=first["pid"])
    doc, dt2 = _answer(second["port"], x)
    back_s = time.time() - t_kill
    step2, err2 = check(doc)
    n2 = launches(second["port"])
    _wait_supervised(p, log_dir, "serving run")
    sup = read_events(os.path.join(log_dir, "telemetry.supervisor.jsonl"))
    seq = [(e["event"], e.get("class"), e.get("action"), e.get("target"))
           for e in sup if e["event"] in ("failure", "heal")]
    if seq != [("failure", "oom_kill", None, "serve0"),
               ("heal", None, "respawn_serve", "serve0")]:
        fail(f"supervise (j4): supervisor events {seq}")
    if n1 < 1 or n2 < 1:
        fail(f"supervise (j4): flash launches {n1} / {n2} in the two lives")
    out = {"served_steps": [step1, step2], "max_abs_err_vs_dense": [err1, err2],
           "tolerance": LOGITS_TOL, "predict_ms": [dt1 * 1e3, dt2 * 1e3],
           "sigkill_to_answer_s": back_s, "respawns": 1,
           "flash_launches": [n1, n2], "wall_s": time.perf_counter() - t0}
    print(f"supervise (j4): replica served steps {step1} / {step2} through "
          f"the flash kernel ({n1} / {n2} launches), within {err1:.2e} / "
          f"{err2:.2e} of the dense forward; SIGKILL to the respawned "
          f"replica's answer {back_s:.2f} s", flush=True)
    return out


def supervise_costs(work: str) -> dict:
    """(j5) What the supervision adds to a step: ResNet-20's step with the
    watchdog armed and without (one device batch, CUDA events, median of 20
    after 5), and the /status scrape's latency on a live trainer's plane."""
    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.train import Trainer
    from mgwfbp_tpu_torch.utils.watchdog import ProgressWatchdog

    cfg = make_config("resnet20", logdir=os.path.join(work, "costs"),
                      metrics_port=0)
    tr = Trainer(cfg, device=TRAIN_DEVICE, synthetic_data=True,
                 profile_backward=False)
    try:
        xb, yb = tr.bundle.train.load_batch(0, 0)
        x, y = tr._to_device(xb[None], yb[None])  # one micro-batch
        plain, armed = [], []
        for _ in range(2):  # interleaved: unarmed, armed, unarmed, armed
            plain.append(float(np.median(_timed_steps(tr.train_step, x, y))))
            with ProgressWatchdog(timeout_s=60.0) as wd:
                def beating(xs, ys):
                    out = tr.train_step(xs, ys)
                    wd.beat("train epoch 0")
                    return out

                armed.append(float(np.median(_timed_steps(beating, x, y))))
        port = tr._metrics_server.port
        scrape = []
        for _ in range(50):
            t0 = time.perf_counter()
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/status",
                                        timeout=5) as r:
                r.read()
            scrape.append((time.perf_counter() - t0) * 1e3)
    finally:
        tr.close()
    out = {"step_ms": plain, "step_ms_watchdog_armed": armed,
           "status_scrape_ms_median": float(np.median(scrape)),
           "status_scrape_ms_max": float(np.max(scrape))}
    print(f"supervise (j5): ResNet-20 step {plain[0]:.3f} / {plain[1]:.3f} "
          f"ms, {armed[0]:.3f} / {armed[1]:.3f} ms with the watchdog armed "
          f"(medians of 20, interleaved); "
          f"/status scrape {out['status_scrape_ms_median']:.3f} ms median",
          flush=True)
    return out


def _log_tails(work: str, lines: int = 25) -> None:
    """The end of every log phase (j) wrote, for a failed sub-phase."""
    for dirpath, _, names in sorted(os.walk(work)):
        for name in sorted(names):
            if name.endswith((".log", ".err")):
                path = os.path.join(dirpath, name)
                with open(path, errors="replace") as f:
                    tail = f.read().splitlines()[-lines:]
                print(f"---- {os.path.relpath(path, work)}", file=sys.stderr)
                print("\n".join(tail), file=sys.stderr, flush=True)


SUPERVISE_PARTS = (("j1", "heal", "supervise_heal"),
                   ("j2", "watchdog", "supervise_watchdog"),
                   ("j3", "cross_world", "supervise_cross_world"),
                   ("j4", "serving", "supervise_serving"),
                   ("j5", "costs", "supervise_costs"))


def phase_supervise(parts: tuple = ("j1", "j2", "j3", "j4", "j5")) -> dict:
    """The parts named; (j1) runs on a thread of its own beside (j4) and
    (j3): its lives wait on process starts, a drain and a wedge's grace
    more than they compute. (j2) removes the native library and (j5) times
    steps, so both run alone after."""
    import concurrent.futures

    t0 = time.perf_counter()
    done = {}
    pool = concurrent.futures.ThreadPoolExecutor(1)
    with tempfile.TemporaryDirectory(prefix="mgwfbp_supervise_") as work:
        try:
            side = (pool.submit(supervise_heal, work) if "j1" in parts
                    else None)
            for key, name, fn in SUPERVISE_PARTS:
                if key in parts and key in ("j4", "j3"):
                    done[key] = globals()[fn](work)
            if side is not None:
                done["j1"] = side.result()
            for key, name, fn in SUPERVISE_PARTS:
                if key in parts and key not in done:
                    done[key] = globals()[fn](work)
        except BaseException:
            _kill_children()  # ends the other thread's wait
            _log_tails(work)
            raise
        finally:
            _kill_children()
            pool.shutdown(wait=True)
            _kill_children()
    out = {name: done[key] for key, name, _ in SUPERVISE_PARTS
           if key in parts}
    out["wall_s"] = time.perf_counter() - t0
    return out


# phase (k): the telemetry plane on the card
TEL_STEPS = 40  # the supervised trainer's steps (one epoch)
TEL_NAN_STEP = 4  # nan@step: a bad_step and its postmortem bundle
TEL_HOLD_STEP, TEL_HOLD_S = 6, 4.0  # holds the run after the NaN step: arm
TEL_STALL_STEP, TEL_STALL_S = 30, 12.0  # holds the run open for the scrapes
TEL_PROFILE_STEPS = 3
TEL_TIMEOUT_S = 180  # each wait of phase (k)
SHADOW_TOL = 1e-4  # card vs CPU shadow loss: float32 logits, TF32 off
HEALTH_MODELS = (("resnet20", 32, None), ("resnet50", 128, "bfloat16"))
FLEET_PORT_LINE = "fleet fan-in: http://"


def _get(port: int, path: str, timeout_s: float = 10.0) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout_s) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _wait_for(what: str, probe, timeout_s: float = TEL_TIMEOUT_S,
              poll_s: float = 0.2):
    """probe()'s first truthy value within timeout_s, else fail."""
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        try:
            got = probe()
        except (OSError, ValueError, KeyError):
            got = None
        if got:
            return got
        time.sleep(poll_s)
    fail(f"telemetry (k): {what} within {timeout_s:.0f}s")


def _scrape_ms(port: int, path: str, n: int = 20) -> float:
    """Median ms of n GETs of path (loopback HTTP)."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        code, _ = _get(port, path)
        times.append((time.perf_counter() - t0) * 1e3)
        if code != 200:
            fail(f"telemetry (k): {path} answered {code}")
    return float(np.median(times))


def _labeled_names(text: str) -> set:
    """The metric names of a (labeled) Prometheus exposition."""
    names = set()
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            float(value)
            names.add(name.split("{")[0])
    return names


def _shadow_checkpoint(work: str) -> str:
    """A committed step of full-width ResNet-20 at a seeded init, its batch
    statistics moved off their init (eval mode reads them)."""
    from mgwfbp_tpu_torch import models
    from mgwfbp_tpu_torch.checkpoint import save_replicated_step
    from mgwfbp_tpu_torch.convert import flatten_flax, variables_to_flax
    from mgwfbp_tpu_torch.models.common import init_weights

    module, _ = models.create_model("resnet20")
    init_weights(module, torch.Generator().manual_seed(5))
    params, bstats = variables_to_flax(module)
    rs = np.random.RandomState(11)
    bstats = {k: (v + np.float32(0.1) * rs.randn(*v.shape).astype(np.float32)
                  if k.endswith("mean") else v * np.float32(1.3))
              for k, v in flatten_flax(bstats).items()}
    d = os.path.join(work, "shadow_ckpt")
    save_replicated_step(d, 3, params, batch_stats=bstats)
    return d


def telemetry_shadow(work: str, replica: subprocess.Popen, ckpt: str,
                     tel_dir: str) -> dict:
    """(k4) The replica ``python -m mgwfbp_tpu_torch.serving --shadow`` on
    the card scored the committed step: its ``shadow_eval`` record against
    the CPU scorer on the same weights, and the card scorer's time."""
    from mgwfbp_tpu_torch import models
    from mgwfbp_tpu_torch.serving.model import ServingModel
    from mgwfbp_tpu_torch.serving.shadow import ShadowScorer
    from mgwfbp_tpu_torch.telemetry import events_of, read_events

    path = os.path.join(tel_dir, "telemetry.jsonl")
    rec = _wait_for("a shadow_eval record from the --shadow replica",
                    lambda: events_of(read_events(path), "shadow_eval"))[0]
    replica.send_signal(signal.SIGTERM)
    try:
        replica.wait(timeout=60)
    except subprocess.TimeoutExpired:
        fail("telemetry (k4): the serving replica ignored SIGTERM")
    if replica.returncode != 0:
        fail(f"telemetry (k4): the serving replica exited {replica.returncode}")
    cpu_loss = None
    card_s = []
    for device in ("cpu", TRAIN_DEVICE):
        module, meta = models.create_model("resnet20")
        model = ServingModel(module, meta, device=device)
        snap = model.load_step(ckpt, 3)
        scorer = ShadowScorer(model)
        loss = scorer.score(snap)
        if device == "cpu":
            cpu_loss = loss
            continue
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scorer.score(snap)
            card_s.append(time.perf_counter() - t0)
    err = abs(float(rec["loss"]) - float(cpu_loss))
    if rec["step"] != 3 or not np.isfinite(rec["loss"]) or err > SHADOW_TOL:
        fail(f"telemetry (k4): shadow_eval {rec} against the CPU scorer's "
             f"{cpu_loss} (|diff| {err:.3e} > {SHADOW_TOL})")
    return {"model": "resnet20", "step": rec["step"], "loss": rec["loss"],
            "cpu_loss": cpu_loss, "abs_err": err, "tolerance": SHADOW_TOL,
            "score_s_median": float(np.median(card_s))}


def telemetry_trainer(work: str, sup: subprocess.Popen, log_dir: str,
                      logs: str) -> dict:
    """(k1) + (k5) ResNet-20 on the card under ``supervise --processes 1
    --fleet-port 0``: /metrics against the stream, a /profile window, the
    NaN step's postmortem bundle, and the fan-in's /fleet/status and
    /fleet/metrics."""
    from mgwfbp_tpu_torch.telemetry import events_of, read_event_set
    from mgwfbp_tpu_torch.telemetry.export import METRICS, parse_metrics_text
    from mgwfbp_tpu_torch.telemetry.recorder import read_bundle

    out: dict = {}
    port_file = os.path.join(log_dir, "metrics_port.p0.json")
    port = _wait_for("the child's port file",
                     lambda: json.load(open(port_file))["port"])

    def fleet_port():
        with open(log_dir + ".err") as f:
            for line in f:
                if FLEET_PORT_LINE in line:
                    return int(line.split(FLEET_PORT_LINE)[1]
                               .split()[0].rsplit(":", 1)[1])

    fport = _wait_for("the supervisor's fleet fan-in", fleet_port)

    def step() -> int:
        code, body = _get(port, "/status")
        return int(json.loads(body)["step"] or 0) if code == 200 else 0

    # the hold before step TEL_HOLD_STEP: the window is armed there and
    # runs at the boundary after it
    _wait_for("the NaN step", lambda: step() >= TEL_HOLD_STEP - 1, poll_s=0.05)
    code, body = _get(port, f"/profile?steps={TEL_PROFILE_STEPS}")
    if code != 200 or not json.loads(body).get("armed"):
        fail(f"telemetry (k1): /profile?steps={TEL_PROFILE_STEPS} answered "
             f"{code}: {body}")

    def window():
        doc = json.loads(_get(port, "/profile")[1])
        return doc if doc["state"] in ("done", "failed") else None

    prof = _wait_for("the profile window", window)
    if prof["state"] != "done":
        fail(f"telemetry (k1): the profile window failed: {prof}")
    res = prof["result"]
    traces = os.listdir(res["trace_dir"]) if res.get("trace_dir") else []
    if res["steps"] != TEL_PROFILE_STEPS or "trace.json" not in traces:
        fail(f"telemetry (k1): profile result {res}, trace dir {traces}")
    with open(os.path.join(res["trace_dir"], "trace.json")) as f:
        trace_events = len(json.load(f)["traceEvents"])
    out["profile"] = {"steps": res["steps"], "wall_s": res["wall_s"],
                      "attribution": res["attribution"],
                      "trace_events": trace_events,
                      "trace_bytes": os.path.getsize(
                          os.path.join(res["trace_dir"], "trace.json"))}
    # the stall holds the run at TEL_STALL_STEP - 1: nothing is written
    _wait_for("the stall", lambda: step() >= TEL_STALL_STEP - 1)
    (tag,) = os.listdir(logs)
    stream = os.path.join(logs, tag, "telemetry.jsonl")
    code, text = _get(port, "/metrics")
    values = parse_metrics_text(text)
    rows = read_event_set(stream)
    steps = len(events_of(rows, "step"))
    want = {"mgwfbp_steps_total": steps,
            "mgwfbp_current_step": steps + TEL_PROFILE_STEPS,
            "mgwfbp_bad_steps_total": 1,
            "mgwfbp_profile_windows_total": 1}
    got = {k: values.get(k) for k in want}
    if code != 200 or got != want or steps != TEL_STALL_STEP - 1 - (
            TEL_PROFILE_STEPS) or "mgwfbp_health_grad_norm" not in values:
        fail(f"telemetry (k1): /metrics {got} against the stream's {want} "
             f"({steps} step records)")
    out["metrics"] = {"values": len(values), **got,
                      "postmortems_total": values.get(
                          "mgwfbp_postmortems_total"),
                      "health_grad_norm": values["mgwfbp_health_grad_norm"],
                      "scrape_ms_median": _scrape_ms(port, "/metrics")}
    code, body = _get(port, "/postmortems")
    pm = json.loads(body)
    if code != 200 or pm["total"] < 1:
        fail(f"telemetry (k1): /postmortems {pm}")
    first = pm["recent"][0]
    bundle = read_bundle(first["path"])
    if (bundle["manifest"]["trigger"] != "bad_step"
            or bundle["manifest"]["step"] != TEL_NAN_STEP
            or not bundle.get("events") or "status" not in bundle):
        fail(f"telemetry (k1): postmortem bundle {bundle.get('manifest')}")
    out["postmortem"] = {
        "bundles": pm["total"], "trigger": bundle["manifest"]["trigger"],
        "step": bundle["manifest"]["step"],
        "ring_records": bundle["manifest"]["ring_records"],
        "bytes": sum(os.path.getsize(os.path.join(first["path"], n))
                     for n in os.listdir(first["path"]))}
    # (k5) the fan-in over the supervised child
    code, body = _get(fport, "/fleet/status", timeout_s=30)
    fs = json.loads(body)
    if (code != 200 or fs["reachable"] != 1 or fs["unreachable"]
            or fs["processes"]["0"]["step"] != TEL_STALL_STEP - 1):
        fail(f"telemetry (k5): /fleet/status {code}: reachable "
             f"{fs.get('reachable')}, unreachable {fs.get('unreachable')}")
    code, text = _get(fport, "/fleet/metrics", timeout_s=30)
    names = _labeled_names(text)
    if (code != 200 or not names <= {n for n, _, _ in METRICS}
            or 'mgwfbp_steps_total{process="0"}' not in text
            or "mgwfbp_fleet_processes 1" not in text):
        fail(f"telemetry (k5): /fleet/metrics {code}: {text[:400]}")
    out["fleet"] = {"reachable": fs["reachable"],
                    "series": len(names),
                    "status_scrape_ms_median": _scrape_ms(fport,
                                                          "/fleet/status", 5),
                    "metrics_scrape_ms_median": _scrape_ms(fport,
                                                           "/fleet/metrics", 5)}
    _wait_supervised(sup, log_dir, "telemetry run")
    rows = read_event_set(stream)
    health = events_of(rows, "health")
    kinds = {r["event"] for r in rows}
    if len(health) != len(events_of(rows, "step")) or "bench_skip" in kinds:
        fail(f"telemetry (k1): {len(health)} health records for "
             f"{len(events_of(rows, 'step'))} steps; events {sorted(kinds)}")
    out["health_records"] = len(health)
    out["events"] = sorted(kinds)
    return out


def _sync_counts(fn, steps: int = 5) -> tuple[dict, float]:
    """(cudaStreamSynchronize calls, device-to-host copies and
    cudaMemcpyAsync calls per call of fn; kernels per call), counted by
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA
                  for e in prof.events())
    return {"cudaStreamSynchronize": sum(
                n == "cudaStreamSynchronize" for n in names) / steps,
            "memcpy_dtoh": sum("DtoH" in n for n in names) / steps,
            "cudaMemcpyAsync": sum(
                n == "cudaMemcpyAsync" for n in names) / steps,
            }, kernels / steps


def telemetry_health_cost(work: str) -> list[dict]:
    """(k2) The in-step health statistics' cost: each model's step with them
    and without (one device batch, CUDA events, medians of 20 after 5,
    interleaved twice), beside the synchronisations and device-to-host
    copies per step, which must be equal."""
    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.train import Trainer

    out = []
    for name, batch, dtype in HEALTH_MODELS:
        cfg = make_config(name, logdir=os.path.join(work, "health"),
                          telemetry=True, batch_size=batch, dtype=dtype,
                          augment=False)
        tr = Trainer(cfg, device=TRAIN_DEVICE, synthetic_data=True,
                     profile_backward=False)
        try:
            step = tr.train_step
            if not step.health_stats:
                fail(f"telemetry (k2): {name}: health statistics are off")
            xb, yb = tr.bundle.train.load_batch(0, 0)
            x, y = tr._to_device(xb[None], yb[None])
            times: dict = {"off": [], "on": []}
            for _ in range(2):
                for mode in ("off", "on"):
                    step.health_stats = mode == "on"
                    times[mode].append(float(np.median(
                        _timed_steps(step, x, y))))
            counts, kernels = {}, {}
            for mode in ("off", "on"):
                step.health_stats = mode == "on"
                step(x, y)  # the mode's first step allocates its buffers
                counts[mode], kernels[mode] = _sync_counts(
                    lambda: step(x, y))
            step.health_stats = True
            health = {k: float(v) for k, v in step(x, y).items()
                      if k.startswith("health/")}
            param_bytes = sum(p.numel() * p.element_size()
                              for p in step.params)
        finally:
            tr.close()
        del tr, step, x, y
        torch.cuda.empty_cache()
        if counts["on"] != counts["off"]:
            fail(f"telemetry (k2): {name}: the health statistics change the "
                 f"host reads per step: {counts}")
        if not np.isfinite(list(health.values())).all():
            fail(f"telemetry (k2): {name}: health statistics {health}")
        row = {"model": name, "batch": batch, "dtype": dtype or "float32",
               "step_ms_without": times["off"], "step_ms_with": times["on"],
               "per_step_off": counts["off"], "per_step_on": counts["on"],
               "device_ops_per_step_off": kernels["off"],
               "device_ops_per_step_on": kernels["on"],
               "param_snapshot_bytes": param_bytes,
               "grad_norm": health["health/grad_norm"],
               "update_ratio": health["health/update_ratio"]}
        print(f"telemetry (k2): {name} b{batch} step {times['off']} ms "
              f"without, {times['on']} ms with the health statistics; per "
              f"step {counts['on']}, device ops {kernels['off']} -> "
              f"{kernels['on']}", flush=True)
        out.append(row)
    return out


def phase_telemetry() -> dict:
    """(k) The telemetry plane on the card: a supervised ResNet-20 run with
    the live plane and the fleet fan-in (k1, k5), the health statistics'
    cost (k2), a --shadow replica (k4); (k3), the flash-serving process's
    /metrics, is checked in phase 3."""
    t0 = time.perf_counter()
    out: dict = {"serve_metrics": SERVE_METRICS}
    with tempfile.TemporaryDirectory(prefix="mgwfbp_telemetry_") as work:
        try:
            ckpt = _shadow_checkpoint(work)
            tel_dir = os.path.join(work, "shadow_tel")
            replica = subprocess.Popen(
                [sys.executable, "-m", "mgwfbp_tpu_torch.serving", "--dnn",
                 "resnet20", "--checkpoint-dir", ckpt, "--shadow",
                 "--telemetry-dir", tel_dir, "--poll-s", "0.2",
                 "--max-seconds", str(TEL_TIMEOUT_S)],
                stdout=subprocess.DEVNULL,
                stderr=open(os.path.join(work, "replica.err"), "w"),
                env=_sup_env())
            _CHILDREN.append(replica)
            root = os.path.join(work, "train")
            log_dir = os.path.join(root, "sup")
            logs = os.path.join(root, "logs")
            sup = _supervise(log_dir, [
                "--dnn", "resnet20", "--synthetic", "--epochs", "1",
                "--num-batches-per-epoch", str(TEL_STEPS), "--telemetry",
                "--metrics-port", "0", "--logdir", logs],
                _sup_env(f"nan@step={TEL_NAN_STEP};stall@secs={TEL_HOLD_S},"
                         f"step={TEL_HOLD_STEP};stall@secs={TEL_STALL_S},"
                         f"step={TEL_STALL_STEP}", MGWFBP_METRICS_PORT="0"),
                sup_args=("--fleet-port", "0"))
            out["trainer"] = telemetry_trainer(work, sup, log_dir, logs)
            _keep("k_logs", logs)  # the card trainer's stream, for (r)
            out["shadow"] = telemetry_shadow(work, replica, ckpt, tel_dir)
            out["health_cost"] = telemetry_health_cost(work)
        except BaseException:
            _log_tails(work)
            raise
        finally:
            _kill_children()
    out["wall_s"] = time.perf_counter() - t0
    tr = out["trainer"]
    print(f"telemetry (k): /metrics {tr['metrics']['scrape_ms_median']:.2f} "
          f"ms, profile window {tr['profile']['wall_s']:.2f} s "
          f"({tr['profile']['attribution']}), postmortem "
          f"{tr['postmortem']['bytes']} B, shadow |card - cpu| "
          f"{out['shadow']['abs_err']:.2e}, phase {out['wall_s']:.1f} s",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# (l) The single-level lowerings: rs_ag, rs_opt_ag (the sharded optimizer)
# and top-k compression
# ---------------------------------------------------------------------------

LOWER_STEPS = 10  # (l1): checked steps of each lowering
LOWER_TIMED_STEPS = 10  # (l1): steps timed after the checks (3 of warm-up)
LOWER_GLOO_STEPS = 5  # (l2): checked steps of each lowering at 2 ranks
LOWER_CLIP = 0.5  # the clipped runs' norm clip (unscaled)
LOWER_DENSITY = 0.01
LOWER_RTOL = 1e-6  # rs_opt_ag against the replicated SGD: relative L2
LOWER_CLI_STEPS = 20  # (l3): the CLI's steps with --comm-op rs_opt_ag
LOWER_CLI_TOPK_STEPS = 8  # (l3): with --compressor topk --density 0
LOWER_TIMEOUT_S = 240  # each CLI run of (l3)
LOWER_LINK = ("10GbE", 2)  # mgwfbp's constants: 7 groups of ResNet-20
# (l1)'s runs: (label, lowering, norm clip, the replicated run whose
# parameters it must match: its own trajectory without the clip, a replay
# of the replicated run's gradients with it)
LOWER_RUNS = (("all_reduce", "all_reduce", None, None),
              ("rs_ag", "rs_ag", None, None),
              ("rs_opt_ag", "rs_opt_ag", None, "all_reduce"),
              ("all_reduce_clip", "all_reduce", LOWER_CLIP, None),
              ("rs_opt_ag_clip", "rs_opt_ag", LOWER_CLIP, "all_reduce_clip"),
              ("topk", "topk", None, None))
LOWER_REFERENCES = {against for _, _, clip, against in LOWER_RUNS
                    if against and clip is not None}


class _DeterministicCudnn:
    """cuDNN's deterministic algorithms for the phase: two runs from one
    initialisation on the same batches then differ only where their
    optimizers' arithmetic does."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.deterministic,
                      torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = self.saved


def _lowering_step(dev, op: str, clip, world: int, steps: int,
                   levels=None, dtype=torch.float32):
    """A fresh full-width ResNet-20 (seed 3) on ``dev`` with its merged
    collectives lowered as ``op`` (``topk``: all_reduce with the top-k
    compressor at LOWER_DENSITY; ``hier`` over ``levels``), policy mgwfbp
    on LOWER_LINK's constants (several groups of several leaves, some of
    odd length), SGD momentum 0.9 and weight decay 1e-4 (the rs_opt_ag
    and rs_fwd_ag reducers run them on their shards), and its
    TrainStep."""
    from mgwfbp_tpu_torch.models import create_model
    from mgwfbp_tpu_torch.models.common import init_weights
    from mgwfbp_tpu_torch.optim import make_optimizer
    from mgwfbp_tpu_torch.parallel.allreduce import make_merged_allreduce
    from mgwfbp_tpu_torch.parallel.compression import TopKCompressor
    from mgwfbp_tpu_torch.parallel.costmodel import lookup_alpha_beta
    from mgwfbp_tpu_torch.train import TrainStep

    model, _ = create_model("resnet20")
    init_weights(model, torch.Generator().manual_seed(3)).to(dev, dtype)
    opt, lr_fn, _, spec = make_optimizer(
        model.parameters(), 0.1, num_batches_per_epoch=steps, norm_clip=clip,
        world_size=world, return_spec=True)
    reducer = make_merged_allreduce(
        model, policy="mgwfbp", cost_model=lookup_alpha_beta(*LOWER_LINK),
        comm_op="all_reduce" if op == "topk" else op,
        compressor=TopKCompressor(LOWER_DENSITY) if op == "topk" else None,
        optim_spec=spec if op in ("rs_opt_ag", "rs_fwd_ag") else None,
        world_size=world, levels=levels)
    step = TrainStep(model, opt, lr_fn, reducer=reducer,
                     norm_clip=spec.norm_clip)
    return model, reducer, step


def _flat_params(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def _plain_topk_matches(reducer, copies: dict, params) -> dict:
    """Each group's reduced bucket on the card (one rank: the top-k
    entries of the local bucket, the rest zero) against the plain top-k of
    the same bucket on the CPU (numpy, stable by magnitude). Where the
    k-th and (k+1)-th magnitudes tie, the k-set is not unique: the kept
    energy is compared there instead."""
    leaf = {id(p): j for j, p in enumerate(params)}
    arr = reducer.arrival_params
    exact, ties = True, 0
    for members in reducer.layout.groups:
        local = torch.cat([copies[leaf[id(arr[k])]].reshape(-1)
                           for k in members]).cpu().numpy()
        got = torch.cat([arr[k].grad.reshape(-1)
                         for k in members]).cpu().numpy()
        n = local.shape[0]
        k = reducer.compressor.k_for(n)
        if k >= n:
            exact = exact and np.array_equal(got, local)
            continue
        mag = np.abs(local)
        order = np.argsort(-mag, kind="stable")
        plain = np.zeros_like(local)
        plain[order[:k]] = local[order[:k]]
        if mag[order[k - 1]] == mag[order[k]]:
            ties += 1
            exact = exact and np.float64(np.square(got, dtype=np.float64)
                                         .sum()) == np.float64(
                np.square(plain, dtype=np.float64).sum())
        else:
            exact = exact and np.array_equal(got, plain)
    return {"equal": bool(exact), "groups_with_a_tie_at_k": ties}


def _lowering_replay(dev, clip, grads: list, ref: torch.Tensor) -> dict:
    """rs_opt_ag on a reference run's local gradients: from the same
    initialisation, each step's gradients planted by a backward of
    sum(p * g) (the hooks launch the reduce-scatters), then
    ``reduce_and_update`` at the step's learning rate; the parameters
    after the LOWER_STEPS steps against the reference's, which differ only
    by the optimizer's arithmetic (each trajectory's own forward would
    amplify a one-rounding difference: the run's reading beside it)."""
    from mgwfbp_tpu_torch.convert import flax_leaves

    model, reducer, step = _lowering_step(dev, "rs_opt_ag", clip, 1,
                                          LOWER_STEPS)
    params = [t for _, t in flax_leaves(model)]
    for k, gk in enumerate(grads):
        for p in params:
            p.grad = None
        reducer.begin()
        sum((p * g).sum() for p, g in zip(params, gk)).backward()
        reducer.reduce_and_update(lr=step.lr_fn(k))
    reducer.detach()
    got = _flat_params(model)
    return {"rel_l2": _rel(got, ref),
            "max_abs_diff": float((got - ref).abs().max()),
            "bitwise": bool(torch.equal(got, ref))}


def _lowering_one_rank(dev, bundle, label: str, op: str, clip,
                       record: bool) -> tuple[dict, torch.Tensor, list]:
    """(l1) One run: LOWER_STEPS checked steps (with ``record``, each
    step's local gradients kept), then the timing and the trace."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch.convert import flax_leaves

    model, reducer, step = _lowering_step(dev, op, clip, 1, LOWER_STEPS)
    params = [t for _, t in flax_leaves(model)]
    copies, hooks = _grad_copies(params)
    checks = {"bitwise": True, "topk": []}
    sync = reducer.synchronize
    recorded = []

    def checked_sync():
        if record:
            recorded.append([copies[j].clone() for j in range(len(params))])
        out = sync()
        if op == "topk":
            checks["topk"].append(_plain_topk_matches(reducer, copies, params))
            return out
        for j, p in enumerate(params):
            leafwise = copies[j].clone()
            dist.all_reduce(leafwise)
            if not torch.equal(p.grad, leafwise):
                checks["bitwise"] = False
        return out

    if op != "rs_opt_ag":
        reducer.synchronize = checked_sync
    launches = []
    for k in range(LOWER_STEPS):
        xb, yb = bundle.train.load_batch(0, k)
        x = torch.from_numpy(xb).to(dev).movedim(-1, -3).contiguous()
        y = torch.from_numpy(yb.astype(np.int64)).to(dev)
        before = reducer.launches
        m = step(x[None], y[None])
        launches.append(reducer.launches - before)
        if not np.isfinite(float(m["loss"])):
            fail(f"lowerings (l1) {label}: non-finite loss at step {k}")
    for h in hooks:
        h.remove()
    reducer.synchronize = sync
    params_after = _flat_params(model).clone()
    xb, yb = bundle.train.load_batch(0, LOWER_STEPS)
    x = torch.from_numpy(xb).to(dev).movedim(-1, -3).contiguous()[None]
    y = torch.from_numpy(yb.astype(np.int64)).to(dev)[None]
    times = _timed_steps(step, x, y, n=LOWER_TIMED_STEPS, warmup=3)
    traced = _trace_reducer(step, reducer, bundle, dev)
    out = {
        "comm_op": reducer.comm_op, "norm_clip": clip,
        "num_groups": reducer.num_groups,
        "launches_per_step": launches,
        "step_ms_median": float(np.median(times)),
        "step_ms_range": [float(min(times)), float(max(times))],
        "group_device_s": traced["group_times_s"],
        "group_range_device_s": traced["range_device_s"],
        "trace_kernels": sorted({k.split("(")[0].split("<")[0][-48:]
                                 for k in traced["kernels"]}),
    }
    if "reason" in traced:
        out["group_device_s_reason"] = traced["reason"]
    if op in ("all_reduce", "rs_ag"):
        if not checks["bitwise"]:
            fail(f"lowerings (l1) {label}: reduced gradients differ from "
                 "the all_reduce of the same gradients")
        out["reduced_equals_all_reduce_bitwise"] = True
    if op == "topk":
        if not all(c["equal"] for c in checks["topk"]):
            fail(f"lowerings (l1) topk: the card's dense result differs "
                 f"from the plain CPU top-k: {checks['topk']}")
        out["dense_equals_plain_cpu_topk"] = True
        out["groups_with_a_tie_at_k"] = sum(
            c["groups_with_a_tie_at_k"] for c in checks["topk"])
        out["density"] = LOWER_DENSITY
    if op == "rs_opt_ag":
        optim = reducer.optim
        out["opt_state_bytes"] = optim.state_bytes_per_device()
        out["replicated_opt_state_bytes"] = optim.replicated_state_bytes()
    reducer.detach()
    return out, params_after, recorded


def lowerings_one_rank() -> dict:
    """(l1) One rank over NCCL on the card (set up as (b)): each of
    LOWER_RUNS for LOWER_STEPS steps from one initialisation on the same
    batches; rs_ag's reduced gradients equal the all_reduce of the same
    gradients bit for bit; rs_opt_ag's own trajectory through TrainStep
    comes within LOWER_RTOL of the replicated torch.optim.SGD run's
    parameters, and with the clip so does rs_opt_ag on the replicated
    run's gradients (the clipped trajectories are read); top-k's dense
    result equals the plain CPU top-k of the same bucket; then each run's
    step time, launches and traced group times, and
    ``profile_update_beta`` on the card."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch.data import data_prepare
    from mgwfbp_tpu_torch.parallel.mesh import init_distributed
    from mgwfbp_tpu_torch.profiling import profile_update_beta

    dev = torch.device("cuda", 0)
    rdv = tempfile.TemporaryDirectory(prefix="mgwfbp_lower_")
    init_distributed(dev, num_processes=1, process_id=0,
                     init_method=f"file://{os.path.join(rdv.name, 'rdv')}")
    runs, finals, grads = {}, {}, {}
    try:
        bundle = data_prepare("cifar10", batch_size=32, seed=1,
                              synthetic=True)
        with _DeterministicCudnn():
            for label, op, clip, against in LOWER_RUNS:
                runs[label], finals[label], grads[label] = (
                    _lowering_one_rank(dev, bundle, label, op, clip,
                                       label in LOWER_REFERENCES))
                if against is not None and clip is not None:
                    runs[label]["on_" + against + "_gradients"] = (
                        _lowering_replay(dev, clip, grads[against],
                                         finals[against]))
        t0 = time.perf_counter()
        update_beta = profile_update_beta(None, dev)
        update_beta_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
        rdv.cleanup()
    for label, _, clip, against in LOWER_RUNS:
        if against is None:
            continue
        # the two trajectories, each through its own forward
        traj = _rel(finals[label], finals[against])
        runs[label]["trajectory_rel_l2_to_" + against] = traj
        runs[label]["trajectory_bitwise_to_" + against] = bool(
            torch.equal(finals[label], finals[against]))
        if clip is None:
            if not traj <= LOWER_RTOL:
                fail(f"lowerings (l1) {label}: parameters {traj:.3g} "
                     f"(relative L2) from {against}'s after {LOWER_STEPS} "
                     f"steps through TrainStep, bound {LOWER_RTOL}")
            continue
        replay = runs[label]["on_" + against + "_gradients"]
        if not replay["rel_l2"] <= LOWER_RTOL:
            fail(f"lowerings (l1) {label}: on {against}'s gradients, "
                 f"parameters {replay['rel_l2']:.3g} (relative L2) from "
                 f"{against}'s after {LOWER_STEPS} steps, bound {LOWER_RTOL}")
    for label, r in runs.items():
        print(f"lowerings (l1): {label}: {r['num_groups']} groups, "
              f"{r['launches_per_step'][0]} collectives per step, step "
              f"{r['step_ms_median']:.3f} ms (median of "
              f"{LOWER_TIMED_STEPS}), traced group times "
              + (f"sum {sum(r['group_device_s']) * 1e3:.4f} ms"
                 if r["group_device_s"] is not None else "None")
              + "".join(f", on {k[3:-10]}'s gradients {v['rel_l2']:.3g} "
                        f"(bitwise {v['bitwise']})" for k, v in r.items()
                        if k.endswith("_gradients"))
              + "".join(f", trajectory {v:.3g} from {k[21:]}"
                        for k, v in r.items()
                        if k.startswith("trajectory_rel_l2_to_"))
              + (f", opt-state {r['opt_state_bytes']} B vs "
                 f"{r['replicated_opt_state_bytes']} B replicated"
                 if "opt_state_bytes" in r else ""), flush=True)
    print(f"lowerings (l1): update_beta {update_beta:.4g} s/B on the card at "
          f"one rank ({update_beta_s:.1f} s)", flush=True)
    return {"runs": runs, "update_beta_s_per_byte": update_beta,
            "update_beta_probe_s": update_beta_s}


def _lowering_gloo_rank(rank: int, world: int, rdv: str, out_path: str) -> None:
    """(l2) One of two processes on the one card over gloo: LOWER_GLOO_STEPS
    steps of each lowering; after every step both ranks' parameters are
    gathered and compared."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch.data import ShardInfo, data_prepare
    from mgwfbp_tpu_torch.utils.device import set_matmul_precision

    set_matmul_precision(None)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    results: dict = {}
    try:
        bundle = data_prepare("cifar10", batch_size=32,
                              shard=ShardInfo(rank, world), seed=2,
                              synthetic=True)
        with _DeterministicCudnn():
            for op in ("all_reduce", "rs_ag", "rs_opt_ag", "topk"):
                model, reducer, step = _lowering_step(
                    dev, op, None, world, LOWER_GLOO_STEPS)
                r = {"identical": True, "launches": 0}
                for k in range(LOWER_GLOO_STEPS):
                    xb, yb = bundle.train.load_batch(0, k)
                    x = torch.from_numpy(xb).to(dev).movedim(-1, -3)
                    y = torch.from_numpy(yb.astype(np.int64)).to(dev)
                    m = step(x.contiguous()[None], y[None])
                    if not np.isfinite(float(m["loss"])):
                        r["identical"] = False
                    flat = _flat_params(model).cpu()
                    gathered = [torch.empty_like(flat) for _ in range(world)]
                    dist.all_gather(gathered, flat)
                    r["identical"] &= all(torch.equal(t, gathered[0])
                                          for t in gathered)
                r["launches"] = reducer.launches
                r["num_groups"] = reducer.num_groups
                r["params"] = _flat_params(model).cpu()
                if op == "rs_opt_ag":
                    optim = reducer.optim
                    r["opt_state_bytes"] = optim.state_bytes_per_device()
                    r["replicated_opt_state_bytes"] = (
                        optim.replicated_state_bytes())
                    r["live_opt_state_bytes"] = sum(
                        t.numel() * t.element_size()
                        for slot in reducer.opt_state.slots for t in slot)
                    r["half_plus_pad_bytes"] = sum(
                        -(-n // world) * 4 for n in reducer.layout.group_sizes)
                results[op] = r
                reducer.detach()
        base = results["all_reduce"]["params"]
        for op, r in results.items():
            r["rel_l2_to_all_reduce"] = _rel(r.pop("params"), base)
    finally:
        dist.destroy_process_group()
        with open(out_path, "w") as f:
            json.dump(results, f)


def lowerings_gloo() -> dict:
    """(l2) Two processes on the one card over gloo (CUDA tensors: the
    card's gloo takes them for reduce-scatter and all-gather):
    LOWER_GLOO_STEPS steps of all_reduce, rs_ag, rs_opt_ag and top-k (no
    clip: the clip's norm is summed in another order on the two paths,
    and each trajectory's own forward amplifies that rounding); both
    ranks' parameters bit-identical after every step, rs_opt_ag within
    LOWER_RTOL of all_reduce + SGD, its optimizer state per rank half the
    replicated bytes plus the pad."""
    import torch.multiprocessing as mp

    world = 2
    with tempfile.TemporaryDirectory(prefix="mgwfbp_lower_gloo_") as d:
        ctx = mp.get_context("spawn")
        outs = [os.path.join(d, f"rank{r}.json") for r in range(world)]
        procs = [ctx.Process(target=_lowering_gloo_rank,
                             args=(r, world, os.path.join(d, "rdv"), outs[r]))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(300)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        codes = [p.exitcode for p in procs]
        results = []
        for path in outs:
            if os.path.exists(path):
                with open(path) as f:
                    results.append(json.load(f))
    if codes != [0] * world or len(results) != world:
        fail(f"lowerings (l2): ranks exited {codes}")
    for res in results:
        for op, r in res.items():
            if not r["identical"]:
                fail(f"lowerings (l2) {op}: the ranks' parameters differ or "
                     "a loss was not finite")
        sh = res["rs_opt_ag"]
        if not sh["rel_l2_to_all_reduce"] <= LOWER_RTOL:
            fail(f"lowerings (l2) rs_opt_ag: {sh['rel_l2_to_all_reduce']:.3g}"
                 f" from all_reduce after {LOWER_GLOO_STEPS} steps")
        if not (sh["opt_state_bytes"] - 4 == sh["live_opt_state_bytes"]
                == sh["half_plus_pad_bytes"]):
            fail(f"lowerings (l2) rs_opt_ag: opt-state bytes {sh}")
    for op, r in results[0].items():
        print(f"lowerings (l2): 2 ranks over gloo, {op}: {r['num_groups']} "
              f"groups, {r['launches'] // LOWER_GLOO_STEPS} collectives per "
              f"step, parameters bit-identical across the ranks after every "
              f"step, {r['rel_l2_to_all_reduce']:.3g} from all_reduce"
              + (f", opt-state {r['opt_state_bytes']} B per rank vs "
                 f"{r['replicated_opt_state_bytes']} B replicated"
                 if "opt_state_bytes" in r else ""), flush=True)
    return {"world": world, "steps": LOWER_GLOO_STEPS,
            "ranks_identical_every_step": True, "runs": results[0]}


def _cli_start(work: str, name: str, steps: int, *flags: str) -> dict:
    """Start ``python -m mgwfbp_tpu_torch.train_cli --dnn resnet20`` on the
    card with the given flags for ``steps`` steps (telemetry on);
    ``_cli_finish`` joins it."""
    logdir = os.path.join(work, name)
    cmd = [sys.executable, "-m", "mgwfbp_tpu_torch.train_cli", "--dnn",
           "resnet20", "--synthetic", "--epochs", "1",
           "--num-batches-per-epoch", str(steps), "--telemetry",
           "--logdir", logdir, *flags]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(
        __file__)), MGWFBP_FAULT_PLAN="")
    return {"name": name, "logdir": logdir, "t0": time.perf_counter(),
            "proc": subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     env=env)}


def _cli_finish(run: dict) -> tuple[str, list, float]:
    """A started CLI run's stderr, its ``health`` records (each step's
    loss) and its seconds; a non-zero rc or LOWER_TIMEOUT_S from its start
    fails the smoke."""
    p = run["proc"]
    try:
        _, err = p.communicate(timeout=max(
            LOWER_TIMEOUT_S - (time.perf_counter() - run["t0"]), 1.0))
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait(10)
        fail(f"train_cli {run['name']}: no end within {LOWER_TIMEOUT_S} s")
    if p.returncode != 0:
        fail(f"train_cli {run['name']}: rc {p.returncode}:\n"
             + "\n".join(err.splitlines()[-15:]))
    health = [e for e in _tag_stream(run["logdir"])
              if e.get("event") == "health"]
    return err, health, time.perf_counter() - run["t0"]


def _kill_runs(runs) -> None:
    """Kill every started CLI run that is still alive (a failed check
    beside them must not leave them running)."""
    for run in runs:
        if run["proc"].poll() is None:
            run["proc"].kill()
            run["proc"].wait(10)


def lowerings_cli_start(work: str) -> list:
    """(l3)'s two CLI runs, started together (beside (l2), which times
    nothing)."""
    return [_cli_start(work, "rs_opt_ag", LOWER_CLI_STEPS, "--comm-op",
                       "rs_opt_ag"),
            _cli_start(work, "topk", LOWER_CLI_TOPK_STEPS, "--compressor",
                       "topk", "--density", "0")]


def lowerings_cli(runs: list) -> dict:
    """(l3) ``train_cli --comm-op rs_opt_ag`` at one worker on the card:
    the world-1 fallback (the replicated optimizer) logged, and the loss
    of the last 5 steps below the first 5's; beside it ``--compressor
    topk --density 0``: no reducer at one worker, so the chooser picks no
    density (the JAX trainer's rule); what the chooser picks for
    ResNet-20 on LOWER_LINK and on the 1GbE table at 16 workers is
    printed beside it. The seconds are the two runs' side by side."""
    from mgwfbp_tpu_torch.parallel.costmodel import (
        choose_density,
        lookup_alpha_beta,
    )

    err, health, secs = _cli_finish(runs[0])
    if "--comm-op rs_opt_ag runs the replicated optimizer" not in err:
        fail("lowerings (l3): the world-1 fallback was not logged")
    losses = [float(h["loss"]) for h in health]
    if len(losses) < LOWER_CLI_STEPS - 1 or not all(
            np.isfinite(losses)) or not (
            np.mean(losses[-5:]) < np.mean(losses[:5])):
        fail(f"lowerings (l3): losses {losses} do not fall")
    err2, health2, secs2 = _cli_finish(runs[1])
    if "--compressor topk unused, no density chosen" not in err2:
        fail("lowerings (l3): the compressor at one worker was not logged "
             "as unused")
    n_params = 272474  # ResNet-20
    chosen = {f"{c} at {n}": choose_density(n_params, n,
                                            lookup_alpha_beta(c, n))
              for c, n in (LOWER_LINK, ("1GbE-large", 16))}
    print(f"lowerings (l3): train_cli --comm-op rs_opt_ag: replicated "
          f"optimizer at one worker, loss {np.mean(losses[:5]):.4f} -> "
          f"{np.mean(losses[-5:]):.4f} (first and last 5 of "
          f"{len(losses)}), {secs:.1f} s; --compressor topk --density 0: "
          f"no density chosen at one worker ({len(health2)} steps, "
          f"{secs2:.1f} s); the chooser picks {chosen} for ResNet-20",
          flush=True)
    return {"rs_opt_ag": {"first5_loss": float(np.mean(losses[:5])),
                          "last5_loss": float(np.mean(losses[-5:])),
                          "steps": len(losses), "seconds": secs,
                          "world_1_fallback_logged": True},
            "topk_density_0": {"density_chosen": "none at one worker",
                               "steps": len(health2), "seconds": secs2,
                               "chooser_for_resnet20": chosen}}


def phase_lowerings() -> dict:
    """(l) The single-level lowerings on the card: (l1), (l2), (l3)."""
    t0 = time.perf_counter()
    one = lowerings_one_rank()
    with tempfile.TemporaryDirectory(prefix="mgwfbp_lower_cli_") as work:
        runs = lowerings_cli_start(work)
        try:
            gloo = lowerings_gloo()
            cli = lowerings_cli(runs)
        finally:
            _kill_runs(runs)
    secs = time.perf_counter() - t0
    print(f"lowerings (l): {secs:.1f} s", flush=True)
    return {"one_rank_nccl": one, "two_ranks_gloo": gloo, "cli": cli,
            "seconds": secs}


# ---------------------------------------------------------------------------
# phase (m): the cross-step and two-level lowerings
# ---------------------------------------------------------------------------

XSTEP_STEPS = 10  # (m1): checked steps of rs_fwd_ag against rs_opt_ag
XSTEP_TIMED_STEPS = 10  # (m1): steps timed after the checks (3 of warm-up)
HIER_WORLD, HIER_DCN = 4, 2  # (m2): 2 slices of 2 ranks over gloo
HIER_STEPS = 5  # (m2): checked steps of hier and all_reduce
HIER_RTOL = 1e-6  # (m2): hier against all_reduce, relative L2
XSTEP_CLI_STEPS = 20  # (m3): the CLI's steps with --comm-op rs_fwd_ag
XSTEP_TRACED_STEPS = 5  # (m1): steps traced one at a time per lowering


def _carried_flat(reducer) -> torch.Tensor:
    """The parameters rs_fwd_ag's carried shards hold (all-gathered,
    unpacked into leaf order, flattened as ``_flat_params`` flattens the
    module): what the next forward gathers."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch.parallel import buckets

    arr: list = [None] * len(reducer.perm)
    for gi, shard in enumerate(reducer.param_shards):
        full = shard.new_empty(reducer.optim.padded_size(gi))
        dist.all_gather_into_tensor(full, shard, group=reducer.group)
        for k, v in buckets.unpack_group(full, reducer.layout, gi,
                                         reducer._shapes).items():
            arr[k] = v
    by_id = {id(reducer.params[j]): arr[k]
             for k, j in enumerate(reducer.perm)}
    return torch.cat([by_id[id(p)].reshape(-1)
                      for p in reducer.module.parameters()])


def _forward_window(step, x, y) -> dict:
    """One traced step: the host span of its forward (its first module's
    pre-hook, or its first convolution, to the backward's first autograd
    node), the group ranges launched before it (rs_fwd_ag's all-gathers,
    each group's first range) and those inside it (the pre-hooks waiting
    for a group's gather and copying it into the parameters, each group's
    second range), with their host time and the device time of what they
    launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mgwfbp_tpu_torch.parallel.allreduce import GROUP_SCOPE_PREFIX

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(x, y)
        torch.cuda.synchronize()
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    b0 = min(e.time_range.start for e in cpu
             if e.name.startswith("autograd::engine::evaluate_function"))
    launched, waited, seen = [], [], set()
    for e in sorted((e for e in cpu if e.name.startswith(GROUP_SCOPE_PREFIX)
                     and e.time_range.start < b0),
                    key=lambda e: e.time_range.start):
        (waited if e.name in seen else launched).append(e)
        seen.add(e.name)
    f0 = min([e.time_range.start for e in cpu if e.name == "aten::conv2d"]
             + [e.time_range.start for e in waited])
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and e.name.startswith(GROUP_SCOPE_PREFIX)
           and f0 <= e.time_range.start < b0]
    return {"forward_host_ms": (b0 - f0) / 1e3,
            "group_ranges_before_forward": len(launched),
            "group_ranges_in_forward": len(waited),
            "in_forward_host_ms": sum(e.time_range.elapsed_us()
                                      for e in waited) / 1e3,
            "in_forward_order": [e.name for e in waited],
            "group_range_device_ms": sum(e.time_range.elapsed_us()
                                         for e in dev) / 1e3}


def xstep_one_rank() -> dict:
    """(m1) One rank over NCCL on the card (set up as (l1)): XSTEP_STEPS
    steps of rs_opt_ag and rs_fwd_ag from one initialisation on the same
    batches, the parameters bit for bit after every step (rs_fwd_ag's
    from its carried shards, which the next forward gathers), the
    collectives per step; then the step time of all_reduce, rs_opt_ag and
    rs_fwd_ag (CUDA events, median of XSTEP_TIMED_STEPS) and one traced
    step of each: rs_fwd_ag's all-gathers are waited for inside the
    forward, by the pre-hooks of the modules that first use each group."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch.data import data_prepare
    from mgwfbp_tpu_torch.parallel.mesh import init_distributed

    dev = torch.device("cuda", 0)
    rdv = tempfile.TemporaryDirectory(prefix="mgwfbp_xstep_")
    init_distributed(dev, num_processes=1, process_id=0,
                     init_method=f"file://{os.path.join(rdv.name, 'rdv')}")
    runs: dict = {}
    try:
        bundle = data_prepare("cifar10", batch_size=32, seed=1,
                              synthetic=True)

        def batch(k):
            xb, yb = bundle.train.load_batch(0, k)
            x = torch.from_numpy(xb).to(dev).movedim(-1, -3).contiguous()
            return x[None], torch.from_numpy(yb.astype(np.int64)).to(dev)[None]

        with _DeterministicCudnn():
            live = {op: _lowering_step(dev, op, None, 1, XSTEP_STEPS)
                    for op in ("rs_opt_ag", "rs_fwd_ag")}
            per = {op: [] for op in live}
            for k in range(XSTEP_STEPS):
                x, y = batch(k)
                flats = {}
                for op, (model, reducer, step) in live.items():
                    before = reducer.launches
                    m = step(x, y)
                    per[op].append(reducer.launches - before)
                    if not np.isfinite(float(m["loss"])):
                        fail(f"cross-step (m1) {op}: non-finite loss at "
                             f"step {k}")
                    flats[op] = (_carried_flat(reducer) if op == "rs_fwd_ag"
                                 else _flat_params(model))
                if not torch.equal(flats["rs_fwd_ag"], flats["rs_opt_ag"]):
                    fail(f"cross-step (m1): rs_fwd_ag's parameters differ "
                         f"from rs_opt_ag's after step {k + 1}: "
                         f"{_rel(flats['rs_fwd_ag'], flats['rs_opt_ag']):.3g}"
                         " relative L2")
            model, fwd, _ = live["rs_fwd_ag"]
            if not fwd.stale:
                fail("cross-step (m1): rs_fwd_ag's module is not one update "
                     "stale between steps")
            fwd.materialize()
            if not torch.equal(_flat_params(model),
                               _flat_params(live["rs_opt_ag"][0])):
                fail("cross-step (m1): the materialized module differs from "
                     "rs_opt_ag's")
            for op, (_, reducer, _) in live.items():
                runs[op] = {"num_groups": reducer.num_groups,
                            "collectives_per_step": per[op]}
                reducer.detach()
            del live
            x, y = batch(XSTEP_STEPS)
            for op in ("all_reduce", "rs_opt_ag", "rs_fwd_ag"):
                model, reducer, step = _lowering_step(dev, op, None, 1,
                                                      XSTEP_STEPS)
                times = _timed_steps(step, x, y, n=XSTEP_TIMED_STEPS,
                                     warmup=3)
                r = runs.setdefault(op, {"num_groups": reducer.num_groups})
                r["step_ms_median"] = float(np.median(times))
                r["step_ms_range"] = [float(min(times)), float(max(times))]
                traced = [_forward_window(step, x, y)
                          for _ in range(XSTEP_TRACED_STEPS)]
                r["traced_step"] = traced[0]
                r["forward_host_ms_median"] = float(np.median(
                    [t["forward_host_ms"] for t in traced]))
                reducer.detach()
    finally:
        dist.destroy_process_group()
        rdv.cleanup()
    tr = runs["rs_fwd_ag"]["traced_step"]
    g = runs["rs_fwd_ag"]["num_groups"]
    if not (tr["group_ranges_before_forward"] == tr[
            "group_ranges_in_forward"] == g):
        fail(f"cross-step (m1): the traced rs_fwd_ag step launched "
             f"{tr['group_ranges_before_forward']} gathers before its "
             f"forward and waited {tr['group_ranges_in_forward']} inside it "
             f"({g} groups)")
    stall = (runs["rs_fwd_ag"]["forward_host_ms_median"]
             - runs["rs_opt_ag"]["forward_host_ms_median"])
    for op, r in runs.items():
        t = r["traced_step"]
        print(f"cross-step (m1): {op}: {r['num_groups']} groups, "
              + (f"collectives per step {r['collectives_per_step']}, "
                 if "collectives_per_step" in r else "")
              + f"step {r['step_ms_median']:.3f} ms (median of "
              f"{XSTEP_TIMED_STEPS}), traced forward "
              f"{r['forward_host_ms_median']:.3f} ms host (median of "
              f"{XSTEP_TRACED_STEPS}); one traced step: "
              f"{t['group_ranges_in_forward']} group range(s) "
              f"inside ({t['in_forward_host_ms']:.3f} ms host, "
              f"{t['group_range_device_ms']:.4f} ms device)", flush=True)
    print(f"cross-step (m1): rs_fwd_ag equals rs_opt_ag bit for bit after "
          f"each of {XSTEP_STEPS} steps; forward stall against rs_opt_ag "
          f"{stall:.3f} ms (medians of the traced host forwards)", flush=True)
    return {"runs": runs, "steps": XSTEP_STEPS, "bitwise_every_step": True,
            "forward_stall_host_ms": stall}


def _hier_gloo_rank(rank: int, world: int, rdv: str, out_path: str) -> None:
    """(m2) One of HIER_WORLD processes on the one card over gloo (2 slices
    of 2): HIER_STEPS steps of all_reduce and of hier from one
    initialisation, in float32 and in float64 (after every step all ranks'
    parameters gathered and compared); then, each step, seeded float32
    gradients planted on the float32 model and reduced by both lowerings,
    beside their float64 mean."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch.data import ShardInfo, data_prepare
    from mgwfbp_tpu_torch.parallel.mesh import two_level_groups
    from mgwfbp_tpu_torch.utils.device import set_matmul_precision

    set_matmul_precision(None)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    results: dict = {}
    try:
        levels = two_level_groups(HIER_DCN)
        bundle = data_prepare("cifar10", batch_size=32,
                              shard=ShardInfo(rank, world), seed=2,
                              synthetic=True)
        finals = {}
        with _DeterministicCudnn():
            for dtype in (torch.float32, torch.float64):
                for op in ("all_reduce", "hier"):
                    model, reducer, step = _lowering_step(
                        dev, op, None, world, HIER_STEPS,
                        levels=levels if op == "hier" else None, dtype=dtype)
                    r = {"identical": True, "launches": []}
                    for k in range(HIER_STEPS):
                        xb, yb = bundle.train.load_batch(0, k)
                        x = torch.from_numpy(xb).to(dev, dtype).movedim(-1, -3)
                        y = torch.from_numpy(yb.astype(np.int64)).to(dev)
                        before = reducer.launches
                        m = step(x.contiguous()[None], y[None])
                        r["launches"].append(reducer.launches - before)
                        r["identical"] &= bool(np.isfinite(float(m["loss"])))
                        flat = _flat_params(model).cpu()
                        gathered = [torch.empty_like(flat)
                                    for _ in range(world)]
                        dist.all_gather(gathered, flat)
                        r["identical"] &= all(torch.equal(t, gathered[0])
                                              for t in gathered)
                    r["num_groups"] = reducer.num_groups
                    r["dcn_groups"] = len(reducer.dcn_groups)
                    name = f"{op}_{str(dtype)[6:]}"
                    finals[name] = _flat_params(model).cpu()
                    results[name] = r
                    reducer.detach()
            for bits in ("float32", "float64"):
                results[f"hier_{bits}"]["rel_l2_to_all_reduce"] = _rel(
                    finals[f"hier_{bits}"], finals[f"all_reduce_{bits}"])
            # the reductions themselves, float32, against float64
            from mgwfbp_tpu_torch.parallel.allreduce import (
                make_merged_allreduce,
            )
            from mgwfbp_tpu_torch.parallel.costmodel import lookup_alpha_beta

            model, hier, _ = _lowering_step(dev, "hier", None, world, 1,
                                            levels=levels)
            hier.detach()
            plain = make_merged_allreduce(
                model, policy="mgwfbp",
                cost_model=lookup_alpha_beta(*LOWER_LINK))
            plain.detach()
            params = list(model.parameters())
            gen = torch.Generator(device=dev)
            worst = {"hier_vs_float64": 0.0, "hier_vs_all_reduce": 0.0,
                     "all_reduce_vs_float64": 0.0}
            for k in range(HIER_STEPS):
                gen.manual_seed(100 * k + rank)
                local = [torch.randn(p.shape, generator=gen, device=dev)
                         for p in params]
                flat64 = torch.cat([g.reshape(-1) for g in local]).double()
                every = [torch.empty_like(flat64) for _ in range(world)]
                dist.all_gather(every, flat64)
                exact = torch.stack(every).mean(0)
                got = {}
                for name, red in (("hier", hier), ("all_reduce", plain)):
                    red.attach()
                    for p in params:
                        p.grad = None
                    red.begin()
                    sum((p * g).sum() for p, g in zip(params, local)).backward()
                    red.synchronize()
                    red.detach()
                    got[name] = torch.cat([p.grad.reshape(-1)
                                           for p in params]).double()
                for key, a, b in (("hier_vs_float64", got["hier"], exact),
                                  ("hier_vs_all_reduce", got["hier"],
                                   got["all_reduce"]),
                                  ("all_reduce_vs_float64", got["all_reduce"],
                                   exact)):
                    worst[key] = max(worst[key], _rel(a, b))
            results["reduction_rel_l2"] = worst
    finally:
        dist.destroy_process_group()
        with open(out_path, "w") as f:
            json.dump(results, f)


def hier_gloo() -> dict:
    """(m2) hier at HIER_WORLD gloo ranks on the one card, 2 slices of 2
    (CUDA tensors; gloo takes them for every collective hier issues):
    every rank's parameters identical after every step; the float64
    trajectory within HIER_RTOL of all_reduce's after HIER_STEPS steps
    (float32's is a reading: each trajectory's forward amplifies a
    rounding difference); each step's float32 reduction within HIER_RTOL
    of the float64 mean and of all_reduce's; G + D + G collectives per
    step."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="mgwfbp_hier_gloo_") as d:
        ctx = mp.get_context("spawn")
        outs = [os.path.join(d, f"rank{r}.json") for r in range(HIER_WORLD)]
        procs = [ctx.Process(target=_hier_gloo_rank,
                             args=(r, HIER_WORLD, os.path.join(d, "rdv"),
                                   outs[r]))
                 for r in range(HIER_WORLD)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(300)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        codes = [p.exitcode for p in procs]
        results = []
        for path in outs:
            if os.path.exists(path):
                with open(path) as f:
                    results.append(json.load(f))
    if codes != [0] * HIER_WORLD or len(results) != HIER_WORLD:
        fail(f"cross-step (m2): ranks exited {codes}")
    for res in results:
        for name, r in res.items():
            if name != "reduction_rel_l2" and not r["identical"]:
                fail(f"cross-step (m2) {name}: the ranks' parameters differ "
                     "or a loss was not finite")
        h = res["hier_float64"]
        if not h["rel_l2_to_all_reduce"] <= HIER_RTOL:
            fail(f"cross-step (m2): float64 hier {h['rel_l2_to_all_reduce']:.3g}"
                 f" from all_reduce after {HIER_STEPS} steps, bound "
                 f"{HIER_RTOL}")
        for key, v in res["reduction_rel_l2"].items():
            if not v <= HIER_RTOL:
                fail(f"cross-step (m2): reduction {key} {v:.3g}, bound "
                     f"{HIER_RTOL}")
        want = 2 * h["num_groups"] + h["dcn_groups"]
        if h["launches"] != [want] * HIER_STEPS:
            fail(f"cross-step (m2): hier launched {h['launches']} collectives "
                 f"per step, want {want}")
    r = results[0]
    h = r["hier_float32"]
    print(f"cross-step (m2): hier over {HIER_WORLD} gloo ranks ({HIER_DCN} "
          f"slices): {h['num_groups']} groups, {h['dcn_groups']} DCN groups, "
          f"{h['launches'][0]} collectives per step, parameters identical "
          f"across the ranks after every step; after {HIER_STEPS} steps "
          f"{r['hier_float64']['rel_l2_to_all_reduce']:.3g} (float64) and "
          f"{h['rel_l2_to_all_reduce']:.3g} (float32, a reading) from "
          f"all_reduce; worst reduction {r['reduction_rel_l2']}", flush=True)
    return {"world": HIER_WORLD, "dcn": HIER_DCN, "steps": HIER_STEPS,
            "runs": r}


def xstep_cli_start(work: str) -> dict:
    """(m3)'s first CLI run, started beside (m2), which times nothing."""
    return _cli_start(work, "rs_fwd_ag", XSTEP_CLI_STEPS, "--comm-op",
                      "rs_fwd_ag", "--checkpoint-dir",
                      os.path.join(work, "ck"))


def xstep_cli(work: str, run: dict) -> dict:
    """(m3) ``train_cli --comm-op rs_fwd_ag`` for XSTEP_CLI_STEPS steps on
    the card with a checkpoint (``run``, started by ``xstep_cli_start``):
    at one worker the world-1 fallback (the replicated optimizer) logged
    and the loss falling; then an ``--comm-op all_reduce`` run of the same
    tag restores its step and trains the next epoch (the same epoch
    length: the schedule's anchor is the checkpoint's)."""
    ck = os.path.join(work, "ck")
    err, health, secs = _cli_finish(run)
    if "--comm-op rs_fwd_ag runs the replicated optimizer" not in err:
        fail("cross-step (m3): the world-1 fallback was not logged")
    losses = [float(h["loss"]) for h in health]
    if len(losses) < XSTEP_CLI_STEPS - 1 or not all(
            np.isfinite(losses)) or not (
            np.mean(losses[-5:]) < np.mean(losses[:5])):
        fail(f"cross-step (m3): losses {losses} do not fall")
    err2, health2, secs2 = _cli_finish(_cli_start(
        work, "restore", XSTEP_CLI_STEPS, "--comm-op", "all_reduce",
        "--checkpoint-dir", ck))
    mark = f"resumed from epoch 0 (iter {XSTEP_CLI_STEPS})"
    if mark not in err2:
        fail(f"cross-step (m3): the all_reduce run did not log {mark!r}")
    after = [float(h["loss"]) for h in health2]
    if not after or not all(np.isfinite(after)) or not (
            np.mean(after[-5:]) < np.mean(losses[:5])):
        fail(f"cross-step (m3): the restored run's losses {after} do not "
             f"end below the first run's first five {losses[:5]}")
    print(f"cross-step (m3): train_cli --comm-op rs_fwd_ag: replicated "
          f"optimizer at one worker, loss {np.mean(losses[:5]):.4f} -> "
          f"{np.mean(losses[-5:]):.4f} ({len(losses)} steps, {secs:.1f} s); "
          f"an all_reduce run restored iter {XSTEP_CLI_STEPS} and trained "
          f"{len(after)} steps, loss {after[0]:.4f} -> "
          f"{np.mean(after[-5:]):.4f} ({secs2:.1f} s)",
          flush=True)
    return {"rs_fwd_ag": {"first5_loss": float(np.mean(losses[:5])),
                          "last5_loss": float(np.mean(losses[-5:])),
                          "steps": len(losses), "seconds": secs,
                          "world_1_fallback_logged": True},
            "all_reduce_restore": {"restored_iteration": XSTEP_CLI_STEPS,
                                   "losses": after, "seconds": secs2}}


def phase_cross_step() -> dict:
    """(m) The cross-step and two-level lowerings on the card: (m1), (m2),
    (m3)."""
    t0 = time.perf_counter()
    one = xstep_one_rank()
    with tempfile.TemporaryDirectory(prefix="mgwfbp_xstep_cli_") as work:
        run = xstep_cli_start(work)
        try:
            hier = hier_gloo()
            cli = xstep_cli(work, run)
        finally:
            _kill_runs([run])
    secs = time.perf_counter() - t0
    print(f"cross-step (m): {secs:.1f} s", flush=True)
    return {"one_rank_nccl": one, "hier_gloo": hier, "cli": cli,
            "seconds": secs}


# ---------------------------------------------------------------------------
# phase (n): closed-loop schedule autotuning
# ---------------------------------------------------------------------------

AT_WORLD = 2  # two gloo ranks on the one card (NCCL takes one rank a card)
AT_EPOCH_STEPS = 10  # the epoch each run trains after its race
AT_WINDOWS, AT_WINDOW_STEPS = 3, 5  # (n3): interleaved windows per schedule
AT_MISCALIBRATION = 10.0  # (n3): alpha and beta of (d) times this


def _at_argv(work: str, cache: str, *extra: str) -> list[str]:
    """(n)'s train_cli command: full-width ResNet-20, float32, batch 32, the
    10GbE constants at 2 workers, the race with 3 timed steps each."""
    return ["--dnn", "resnet20", "--synthetic", "--autotune",
            "--autotune-steps", "3", "--connection", "10GbE",
            "--batch-size", "32", "--epochs", "1",
            "--num-batches-per-epoch", str(AT_EPOCH_STEPS),
            "--schedule-cache", cache, "--logdir",
            os.path.join(work, "logs"), *extra]


def _at_run(argv: list, dev: torch.device, truth=None) -> dict:
    """One ``train_cli`` run of (n) in this rank (the CLI's parser and
    config, then ``Trainer.fit`` in the running gloo world): the autotune
    report, the seconds from the trainer's construction to the epoch's
    first step, a digest of the final parameters, the epoch's metrics and
    the flash kernel's launches (none: not on this path). With ``truth``
    (a cost model), the committed winner and the schedule solved on
    ``truth`` are timed in AT_WINDOWS interleaved windows."""
    import hashlib

    from mgwfbp_tpu_torch import train_cli
    from mgwfbp_tpu_torch.convert import flax_leaves
    from mgwfbp_tpu_torch.ops import flash_attention
    from mgwfbp_tpu_torch.parallel.solver import build_schedule
    from mgwfbp_tpu_torch.profiling import time_carried_steps
    from mgwfbp_tpu_torch.train import Trainer

    args = train_cli.build_parser().parse_args(argv)
    cfg = train_cli.config_from_args(args)
    t0 = time.perf_counter()
    tr = Trainer(cfg, device=dev, synthetic_data=True)
    first: dict = {}
    train_on = tr._train_on

    def first_step(epoch, fields):
        out = train_on(epoch, fields)
        first.setdefault("s", time.perf_counter() - t0)
        return out

    tr._train_on = first_step
    try:
        flash_attention.launches = 0  # this path's run starts here
        metrics = tr.fit(args.epochs)
        flash = flash_attention.launches  # ... and ends here
        flat = torch.cat([t.detach().reshape(-1).cpu()
                          for _, t in flax_leaves(tr.model)])
        res = {"report": tr.autotune_report, "first_step_s": first.get("s"),
               "params_sha256": hashlib.sha256(
                   flat.numpy().tobytes()).hexdigest(),
               "train": metrics.get("train"), "flash_launches": flash,
               "live_groups": [list(g) for g in tr.reducer.layout.groups],
               "live_comm_op": tr.comm_op}
        if truth is not None:
            solved = build_schedule(tr._layer_specs(), list(tr.tb),
                                    policy="auto", cost_model=truth,
                                    comm_op=cfg.comm_op)
            arms = {"winner": (tuple(map(tuple, tr.reducer.layout.groups)),
                               tr.comm_op),
                    "truth_solved": (tuple(map(tuple, solved.groups)),
                                     cfg.comm_op)}
            res["truth_groups"] = len(solved.groups)
            res["winner_groups"] = len(arms["winner"][0])
            times: dict = {k: [] for k in arms}
            if arms["winner"] != arms["truth_solved"]:
                batches = tr._autotune_batches()

                def step_once(state):
                    tr._apply_train_step(next(batches))
                    return state

                for _ in range(AT_WINDOWS):
                    for name, (groups, op) in arms.items():
                        if not tr._reducer_is_live(groups, op):
                            tr._swap_reducer(tr._reducer_for(
                                groups, op, detail=f"reading:{name}"))
                        _, dt = time_carried_steps(
                            step_once, None, AT_WINDOW_STEPS, warmup=1,
                            device=dev)
                        times[name].append(dt * 1e3)
            res["window_ms"] = times
        return res
    finally:
        tr.close()


def _autotune_gloo_rank(rank: int, world: int, rdv: str, work: str,
                        consts: dict, out_path: str, device: str) -> None:
    """(n) One of AT_WORLD processes on the one card over gloo: (n1) the
    race, (n2) the same command again, (n3) the race on a profile whose
    alpha and beta are AT_MISCALIBRATION times (d)'s, then the winner
    against the schedule solved on (d)'s constants."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch.parallel.costmodel import AlphaBeta, save_profile
    from mgwfbp_tpu_torch.utils.device import set_matmul_precision

    set_matmul_precision(None)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    results: dict = {}
    try:
        cache = os.path.join(work, "cache")
        results["n1"] = _at_run(_at_argv(work, cache), dev)
        results["n2"] = _at_run(_at_argv(work, cache), dev)
        truth = AlphaBeta(alpha=consts["alpha_s"],
                          beta=consts["beta_s_per_byte"],
                          gamma=consts["gamma_s"],
                          overlap=consts["overlap"],
                          pack_beta=consts["pack_beta_s_per_byte"])
        mis = dataclasses.replace(truth, alpha=truth.alpha * AT_MISCALIBRATION,
                                  beta=truth.beta * AT_MISCALIBRATION)
        profile = os.path.join(work, f"miscalibrated.p{rank}.json")
        save_profile(profile, mis)
        results["n3"] = _at_run(
            _at_argv(work, os.path.join(work, "cache_mis"),
                     "--comm-profile", profile), dev, truth=truth)
        results["n3"]["miscalibrated"] = {"alpha": mis.alpha,
                                          "beta": mis.beta}
    finally:
        dist.destroy_process_group()
        with open(out_path, "w") as f:
            json.dump(results, f)


def _gate_contract(entry: dict) -> bool:
    """A clean gate entry counted every collective of its lowering: per
    group one all-reduce (all_reduce) or one reduce-scatter and one
    all-gather (rs_ag), beside the step's two all-reduces (metrics, batch
    statistics)."""
    g, kinds = entry["num_groups"], entry["kinds"]
    want = ({"all_reduce": g + 2} if entry["comm_op"] == "all_reduce" else
            {"reduce_scatter": g, "all_gather": g, "all_reduce": 2})
    return entry["rules"] == [] and kinds == want


def phase_autotune(consts: dict, device: str = "cuda:0") -> dict:
    """(n) Closed-loop schedule autotuning: ``train_cli --dnn resnet20
    --synthetic --autotune --autotune-steps 3`` at full width, float32,
    batch 32, on the 10GbE constants at AT_WORLD gloo ranks sharing the
    card (as (m2)).
    (n1) the race: the gate counts every collective of each candidate's
        observed step, the incumbent's included (the hooks run on the
        card's autograd thread), every raced entry is verified, both ranks
        commit the same winner and end with the same parameters, and the
        race's loss falls; printed: each candidate's measured and
        predicted s/step, the refit before and after, the race's seconds;
    (n2) the same command again: a cache hit, no race, the same groups;
        printed: the seconds to the first step against (n1)'s;
    (n3) a profile whose alpha and beta are AT_MISCALIBRATION times (d)'s:
        the race's winner against the schedule solved on (d)'s constants,
        in AT_WINDOWS interleaved windows of AT_WINDOW_STEPS steps (a
        reading: the host moves ResNet-20's step between runs).
    ``device`` "cpu" rehearses the phase without a card."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mgwfbp_autotune_") as work:
        ctx = mp.get_context("spawn")
        outs = [os.path.join(work, f"rank{r}.json") for r in range(AT_WORLD)]
        procs = [ctx.Process(target=_autotune_gloo_rank,
                             args=(r, AT_WORLD, os.path.join(work, "rdv"),
                                   work, consts, outs[r], device))
                 for r in range(AT_WORLD)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(300)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        codes = [p.exitcode for p in procs]
        results = []
        for path in outs:
            if os.path.exists(path):
                with open(path) as f:
                    results.append(json.load(f))
        if os.path.isdir(os.path.join(work, "cache")):
            _keep("n_cache", os.path.join(work, "cache"))  # for (r)
    secs = time.perf_counter() - t0
    if codes != [0] * AT_WORLD or len(results) != AT_WORLD or not all(
            "n3" in r for r in results):
        fail(f"autotune (n): ranks exited {codes}")
    n1 = [r["n1"] for r in results]
    reps = [r["report"] for r in n1]
    for rep in reps:
        if rep is None or rep.get("source") != "race":
            fail(f"autotune (n1): no race ran: {rep}")
        if not rep["race"] or not all(e["verified"] for e in rep["race"]):
            fail(f"autotune (n1): an entry was not verified: {rep['race']}")
        bad = [g for g in rep["gate"] if not _gate_contract(g)]
        if bad:
            fail(f"autotune (n1): the gate did not count the lowering's "
                 f"collectives: {bad}")
        losses = rep["losses"]
        if not (np.isfinite(losses).all()
                and np.mean(losses[-5:]) < np.mean(losses[:5])):
            fail(f"autotune (n1): the race's losses {losses} do not fall")
    if len({(r["winner"], json.dumps(r["groups"])) for r in reps}) != 1:
        fail(f"autotune (n1): the ranks committed different winners "
             f"{[r['winner'] for r in reps]}")
    if len({r["params_sha256"] for r in n1}) != 1:
        fail("autotune (n1): the ranks' parameters differ")
    n2 = [r["n2"] for r in results]
    for r in n2:
        rep = r["report"]
        if rep.get("source") != "cache" or rep["groups"] != reps[0]["groups"]:
            fail(f"autotune (n2): not a cache hit of (n1)'s winner: {rep}")
        if r["live_groups"] != reps[0]["groups"]:
            fail("autotune (n2): the live groups are not the winner's")
    if len({r["params_sha256"] for r in n2}) != 1:
        fail("autotune (n2): the ranks' parameters differ")
    if any(r[k]["flash_launches"] for r in results for k in ("n1", "n2",
                                                               "n3")):
        fail("autotune (n): the flash kernel launched while training")
    rep = reps[0]
    for e in rep["race"]:
        print(f"autotune (n1): {e['label']}: {e['num_groups']} groups, "
              f"measured {e['measured_step_s'] * 1e3:.3f} ms/step, predicted "
              f"{(e['predicted_total_s'] or float('nan')) * 1e3:.3f} ms",
              flush=True)
    gate = rep["gate"][0]
    print(f"autotune (n1): the gate counted {gate['collectives']} "
          f"collectives of the incumbent's step ({gate['kinds']}) on threads "
          f"{gate['threads']}; committed {rep['winner']} "
          f"({len(rep['groups'])} groups, {rep['comm_op']}); refit "
          f"{(rep.get('refit') or {}).get('before')} -> "
          f"{(rep.get('refit') or {}).get('after')}; race "
          f"{rep['race_s']:.2f} s, loss {np.mean(rep['losses'][:5]):.4f} -> "
          f"{np.mean(rep['losses'][-5:]):.4f}", flush=True)
    print(f"autotune (n2): cache hit, {len(n2[0]['live_groups'])} groups; "
          f"first step {n2[0]['first_step_s']:.2f} s after the trainer's "
          f"construction against (n1)'s {n1[0]['first_step_s']:.2f} s",
          flush=True)
    n3 = [r["n3"] for r in results]
    w = n3[0]["window_ms"]
    print(f"autotune (n3): alpha and beta x{AT_MISCALIBRATION:g}: committed "
          f"{n3[0]['report'].get('winner')} ({n3[0]['winner_groups']} "
          f"groups) against the schedule solved on (d)'s constants "
          f"({n3[0]['truth_groups']} groups): "
          + (f"winner {w['winner']} ms, truth-solved {w['truth_solved']} ms "
             "per step (rank 0, interleaved windows)" if w["winner"] else
             "the same schedule"), flush=True)
    print(f"autotune (n): {secs:.1f} s", flush=True)
    return {"world": AT_WORLD, "seconds": secs,
            "n1": {"ranks": n1}, "n2": {"ranks": n2}, "n3": {"ranks": n3}}


ANALYSIS_TIMEOUT_S = 300  # (o1): the CLI, its step pass included


def _analysis_cli() -> tuple[dict, float]:
    """(o1): the CLI's JSON document and its seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mgwfbp_tpu_torch.analysis", "--device",
         "cuda", "--json"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=ANALYSIS_TIMEOUT_S)
    secs = time.perf_counter() - t0
    try:
        doc = json.loads(proc.stdout)
    except ValueError:
        doc = None
    if proc.returncode != 0 or doc is None:
        fail(f"analysis (o1): the CLI exited {proc.returncode}: "
             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return doc, secs


def _analysis_passes(cli_s: float) -> dict:
    """(o1): each static pass in this process, timed, and the step pass's
    seconds as the CLI's less theirs (running it again here would double
    the phase); findings by family."""
    from mgwfbp_tpu_torch.analysis import ast_lint, race_check, spmd_check
    from mgwfbp_tpu_torch.analysis.rules import SuppressionTracker, family

    tracker = SuppressionTracker()
    pkg = os.path.dirname(os.path.abspath(
        sys.modules["mgwfbp_tpu_torch"].__file__))
    passes = (
        ("lint", lambda: ast_lint.lint_paths([pkg], tracker)),
        ("thr", lambda: race_check.check_paths(tracker=tracker)),
        ("run", lambda: spmd_check.check_paths(tracker=tracker)),
        ("ana", tracker.unused_findings),
    )
    seconds, found = {}, []
    for name, run in passes:
        t0 = time.perf_counter()
        found += run()
        seconds[name] = time.perf_counter() - t0
    seconds["step (the CLI's less the static passes)"] = (
        cli_s - sum(seconds.values()))
    by_family: dict = {}
    for f in found:
        by_family[family(f.rule_id)] = by_family.get(family(f.rule_id), 0) + 1
    suppressed: dict = {}
    for f in tracker.suppressed_findings:
        k = family(f.rule_id)
        suppressed[k] = suppressed.get(k, 0) + 1
    if found:
        fail("analysis (o1): findings on the shipped tree: "
             + "; ".join(f.format() for f in found[:10]))
    return {"seconds": seconds, "findings_by_family": by_family,
            "suppressed_by_family": suppressed}


def _analysis_seeded_sync() -> dict:
    """(o2): a hook's .item() on the card is SCH005 on autograd's thread;
    the clean step does not synchronise."""
    import warnings

    from mgwfbp_tpu_torch import models as zoo
    from mgwfbp_tpu_torch.analysis import step_pass
    from mgwfbp_tpu_torch.analysis.schedule_check import verify_observed_step
    from mgwfbp_tpu_torch.optim import make_optimizer
    from mgwfbp_tpu_torch.train.step import TrainStep

    dev = torch.device("cuda")
    model, meta = zoo.create_model("lenet")
    model.to(dev)
    opt, lr_fn = make_optimizer(model.parameters(), 0.1, momentum=0.9,
                                weight_decay=0.0)[:2]
    step = TrainStep(model, opt, lr_fn, norm_clip=1.0)
    data = step_pass.batches(meta, dev, 0)
    step(*next(data))
    clean = verify_observed_step(lambda: step(*next(data)), step,
                                 file="<o2 clean>")
    if clean.findings or clean.syncs:
        fail(f"analysis (o2): the clean step: {clean.findings} "
             f"{clean.syncs}")
    step(*next(data))
    batch = next(data)  # its pageable host-to-device copies are not the step's
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(*batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    debug_syncs = [str(w.message).splitlines()[0] for w in caught
                   if "called a synchronizing" in str(w.message)]
    threads = []

    def hook(g):
        threads.append(threading.current_thread().name)
        g.sum().item()
        return g

    handle = step.params[0].register_hook(hook)
    try:
        seeded = verify_observed_step(lambda: step(*next(data)), step,
                                      file="<o2 seeded>")
    finally:
        handle.remove()
    sch005 = [f for f in seeded.findings if f.rule_id == "SCH005"]
    hook_syncs = [s for s in seeded.syncs
                  if s.op == "aten._local_scalar_dense"]
    if not sch005 or not hook_syncs:
        fail(f"analysis (o2): the hook's .item() on the card gave no "
             f"SCH005: {seeded.findings} {seeded.syncs}")
    if dev.type == "cuda" and (
            hook_syncs[0].thread == threading.current_thread().name):
        fail("analysis (o2): the hook ran on the step's own thread, not on "
             "autograd's device thread")
    return {"sch005": [f.message for f in sch005],
            "hook_thread": threads[0] if threads else None,
            "sync_thread": hook_syncs[0].thread,
            "main_thread": threading.current_thread().name,
            "observed_syncs_clean_step": len(clean.syncs),
            "sync_debug_warnings_clean_step": len(debug_syncs),
            "sync_debug_messages": debug_syncs}


def phase_analysis() -> dict:
    """(o) The port's static analysis on the card's machine (module
    docstring)."""
    t0 = time.perf_counter()
    doc, cli_s = _analysis_cli()
    passes = _analysis_passes(cli_s)
    o2 = _analysis_seeded_sync()
    secs = time.perf_counter() - t0
    print(f"analysis (o1): the CLI exited 0 in {cli_s:.1f} s "
          f"(errors {doc['errors']}, by family {doc['errors_by_family']}, "
          f"suppressed {sum(f['suppressed'] for f in doc['findings'])}); "
          "passes "
          + ", ".join(f"{k} {v:.2f} s" for k, v in passes["seconds"].items())
          + f"; findings {passes['findings_by_family']}, suppressed "
          f"{passes['suppressed_by_family']}", flush=True)
    print(f"analysis (o2): the hook's .item() ran on thread "
          f"{o2['hook_thread']!r} (main {o2['main_thread']!r}) and gave "
          f"SCH005 there ({o2['sync_thread']!r}); the clean step: "
          f"{o2['observed_syncs_clean_step']} observed synchronisation(s), "
          f"{o2['sync_debug_warnings_clean_step']} by set_sync_debug_mode "
          f"{o2['sync_debug_messages']}", flush=True)
    print(f"analysis (o): {secs:.1f} s", flush=True)
    return {"seconds": secs, "cli_seconds": cli_s,
            "cli_exit_code": doc["exit_code"], "o1": passes, "o2": o2}


# ---------------------------------------------------------------------------
# phase (p): sequence parallelism (ring attention, --seq-parallel)
# ---------------------------------------------------------------------------

SEQ_WORLD = 2  # (p): two gloo ranks sharing the card, one ring of 2
SEQ_TOL = 2e-5  # (p1): ring vs local_attention, float32 (tests' bound)
SEQ_RING_SHAPE = (16, 64, 4, 64)  # (p1): (B, T, H, D) of the trained model
SEQ_STEP_RTOL = 1e-5  # (p2): step-1 parameters vs the dense step, rel. L2
SEQ_STEPS = 10  # (p2): train_cli steps of the timed run
SEQ_LONG_T = 4096  # (p3): the window of the memory comparison
SEQ_LONG_BATCH = 2
SEQ_LONG_STEPS = 5  # (p3): timed steps, after 2 of warm-up
SEQ_TIMEOUT_S = 300  # (p): each rank's join


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def seq_ring_check(dev, group, seq: int, pos: int) -> dict:
    """(p1) ``ring_attention`` on this rank's time slice of seeded (B, T, H,
    D) = SEQ_RING_SHAPE float32 tensors, causal, and its q, k, v gradients
    under a seeded upstream gradient, against ``local_attention`` on the
    whole sequence on the same device: the max abs errors, the
    point-to-point operations of the forward and of the backward, and
    whether the shift stages through the host."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch.parallel import ringattn

    gen = torch.Generator().manual_seed(5)
    full = [torch.randn(SEQ_RING_SHAPE, generator=gen).to(dev)
            for _ in range(4)]
    t = SEQ_RING_SHAPE[1] // seq
    sl = slice(pos * t, (pos + 1) * t)
    q, k, v = (a[:, sl].clone().requires_grad_(True) for a in full[:3])
    before = ringattn.p2p_ops
    out = ringattn.ring_attention(q, k, v, group, causal=True)
    fwd = ringattn.p2p_ops - before
    (out * full[3][:, sl]).sum().backward()
    bwd = ringattn.p2p_ops - before - fwd
    qf, kf, vf = (a.clone().requires_grad_(True) for a in full[:3])
    ref = ringattn.local_attention(qf, kf, vf, causal=True)
    (ref * full[3]).sum().backward()
    err = {"out": (out - ref[:, sl]).abs().max().item()}
    for name, a, b in (("dq", q, qf), ("dk", k, kf), ("dv", v, vf)):
        err[name] = (a.grad - b.grad[:, sl]).abs().max().item()
    return {"shape": list(SEQ_RING_SHAPE), "max_abs_err": err,
            "p2p_forward": fwd, "p2p_backward": bwd,
            "backend": dist.get_backend(group),
            "staged_through_host": ringattn.staged(group, q)}


def _seq_cli_config(argv: list):
    from mgwfbp_tpu_torch import train_cli

    args = train_cli.build_parser().parse_args(argv)
    return args, train_cli.config_from_args(args)


def _seq_argv(work: str, seq: int, steps: int, name: str, *extra) -> list:
    """The user's ``train_cli`` command of (p2): the full-width
    transformer preset (vocab 10000, d_model 256, 4 heads, 4 layers, d_ff
    1024, 64-token windows, batch 16) on synthetic PTB."""
    return ["--dnn", "transformer", "--synthetic", "--seq-parallel",
            str(seq), "--epochs", "1", "--num-batches-per-epoch", str(steps),
            "--logdir", os.path.join(work, name), *extra]


def seq_parity(dev, work: str, seq: int) -> dict:
    """(p2) One step of ``train_cli --seq-parallel S``'s Trainer (dropout
    off, so that the masks do not differ) against a world-1 dense step
    (the same initial weights, the world's global batch gathered from the
    rings, the trainer's optimizer and learning rate) computed here:
    the relative L2 of the parameters after step 1."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch.models import create_model, for_training
    from mgwfbp_tpu_torch.optim import make_optimizer, set_lr
    from mgwfbp_tpu_torch.train import Trainer
    from mgwfbp_tpu_torch.train.step import forward_loss

    # a constant rate: the preset's cosine warms up from 0, and a step of
    # rate 0 would match anything
    args, cfg = _seq_cli_config(_seq_argv(work, seq, 1, "parity",
                                          "--no-profile-backward",
                                          "--lr-schedule", "const"))
    tr = Trainer(cfg, device=dev, synthetic_data=True, profile_backward=False)
    try:
        for m in tr.model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        ref = for_training(create_model("transformer")[0])
        ref.load_state_dict(tr.model.state_dict())
        ref.to(dev).train()
        init = torch.cat([p.detach().reshape(-1)
                          for p in ref.parameters()]).double()
        for m in ref.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        seen: list = []
        train_on = tr._train_on

        def capture(epoch, fields):
            seen.append([torch.as_tensor(np.asarray(f)) for f in fields[:2]])
            return train_on(epoch, fields)

        tr._train_on = capture
        tr.train_epoch(0)
        # the world's global batch: each data index's rows, from ring
        # position 0 of every ring, in data order
        # position 0 of every ring, in data order (NCCL gathers on the
        # card, gloo on the host)
        on = dev if dist.get_backend() == "nccl" else torch.device("cpu")
        rows = []
        for t in seen[0]:
            t = t.to(on).contiguous()
            every = [torch.empty_like(t) for _ in range(tr.world)]
            dist.all_gather(every, t)
            rows.append(torch.cat(every[::seq], dim=1)[0].to(dev))
        opt, *_ = make_optimizer(ref.parameters(), cfg.lr,
                                 momentum=cfg.momentum,
                                 weight_decay=cfg.weight_decay)
        loss, _, _ = forward_loss(ref, "lm", rows[0], rows[1])
        loss.backward()
        set_lr(opt, tr.lr_fn(0))
        opt.step()
        got = torch.cat([p.detach().reshape(-1)
                         for p in tr.model.parameters()]).double()
        want = torch.cat([p.detach().reshape(-1)
                          for p in ref.parameters()]).double()
        rel = ((got - want).norm() / want.norm()).item()
        return {"rel_l2_to_dense_step": rel, "bound": SEQ_STEP_RTOL,
                "lr": tr.lr_fn(0),
                "step_rel_l2": ((want - init).norm() / init.norm()).item(),
                "loss_seq": tr.losses[0], "loss_dense": loss.item(),
                "global_rows": int(rows[0].shape[0])}
    finally:
        tr.close()


def seq_timed(dev, work: str, seq: int) -> dict:
    """(p2) ``train_cli --seq-parallel S`` as a user runs it (the preset's
    dropout, the backward profile, policy auto): SEQ_STEPS steps (fewer
    where the epoch is shorter) and the epoch's evaluation; each step's wall time (synchronised), the ring's
    point-to-point operations per step, the merge groups and those the
    strict group order held back, the flash kernel's launches."""
    from mgwfbp_tpu_torch.ops import flash_attention
    from mgwfbp_tpu_torch.parallel import ringattn
    from mgwfbp_tpu_torch.train import Trainer

    args, cfg = _seq_cli_config(_seq_argv(work, seq, SEQ_STEPS, "timed"))
    tr = Trainer(cfg, device=dev, synthetic_data=True)
    try:
        times, p2p = [], []
        train_on = tr._train_on

        def timed(epoch, fields):
            _sync(dev)
            before, t0 = ringattn.p2p_ops, time.perf_counter()
            out = train_on(epoch, fields)
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            p2p.append(ringattn.p2p_ops - before)
            return out

        tr._train_on = timed
        flash_attention.launches = 0  # this path's run starts here
        metrics = tr.fit(args.epochs)
        flash = flash_attention.launches  # ... and ends here
        reducer = tr.reducer
        groups = ([list(g) for g in reducer.schedule.groups]
                  if reducer is not None else [])
        return {
            "step_ms": times, "step_ms_median": float(np.median(times[2:])),
            "p2p_per_step": p2p, "layers": tr.model.num_layers,
            "num_groups": len(groups),
            "held_groups": (_held_groups(groups, reducer.arrivals)
                            if reducer is not None else 0),
            "comm_op": tr.comm_op, "losses": list(tr.losses),
            "eval": metrics.get("eval"), "flash_launches": flash,
            "data_size": tr.data_size, "seq_size": tr.seq_size,
        }
    finally:
        tr.close()


def _long_step(dev, group, seq: int, pos: int) -> dict:
    """(p3) The full-width transformer at SEQ_LONG_T tokens and batch
    SEQ_LONG_BATCH (this rank's T/S slice on a ring, the whole window
    through ``local_attention`` without one): the peak memory of the steps
    over what the model and optimizer hold, and the median step."""
    from mgwfbp_tpu_torch.models import create_model, for_training
    from mgwfbp_tpu_torch.models.common import init_weights
    from mgwfbp_tpu_torch.train import TrainStep

    model = for_training(create_model("transformer")[0])
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(dev)
    model.set_seq_group(group)
    opt = torch.optim.SGD(model.parameters(), lr=0.01)
    step = TrainStep(model, opt, lambda s: 0.01, task="lm", seq_group=group)
    gen = torch.Generator().manual_seed(9)
    x, y = (torch.randint(0, model.vocab_size,
                          (1, SEQ_LONG_BATCH, SEQ_LONG_T), generator=gen)
            for _ in range(2))
    t = SEQ_LONG_T // seq
    x, y = (a[..., pos * t:(pos + 1) * t].to(dev) for a in (x, y))
    _sync(dev)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for k in range(2 + SEQ_LONG_STEPS):
        _sync(dev)
        t0 = time.perf_counter()
        m = step(x, y)
        _sync(dev)
        if k >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    out = {"seq": seq, "tokens_per_rank": t, "batch": SEQ_LONG_BATCH,
           "peak_bytes_over_model": int(peak - base), "peak_bytes": int(peak),
           "step_ms_median": float(np.median(times)), "step_ms": times,
           "loss": float(m["loss"])}
    del model, opt, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def seq_rank(dev, work: str, seq: int, long: bool = True) -> dict:
    """Every part of (p) in this rank of a running world: (p1) on a ring of
    ``parallel.mesh.seq_groups``, (p2) ``seq_parity`` and ``seq_timed``,
    and with ``long`` (p3) on the ring. The problems found are returned,
    not raised,
    so that the caller reads every rank's."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch.parallel.mesh import seq_groups
    from mgwfbp_tpu_torch.utils.device import set_matmul_precision

    set_matmul_precision(None)
    rank = dist.get_rank()
    group = seq_groups(seq)
    pos = rank % seq
    res: dict = {"rank": rank, "problems": []}
    t0 = time.perf_counter()
    res["p1"] = p1 = seq_ring_check(dev, group, seq, pos)
    worst = max(p1["max_abs_err"].values())
    if not worst <= SEQ_TOL:
        res["problems"].append(f"(p1) ring vs local_attention {worst:.3g} "
                               f"> {SEQ_TOL}")
    if [p1["p2p_forward"], p1["p2p_backward"]] != [2 * (seq - 1)] * 2:
        res["problems"].append(f"(p1) p2p {p1['p2p_forward']} + "
                               f"{p1['p2p_backward']}, want {2 * (seq - 1)}"
                               " each")
    res["p2_parity"] = par = seq_parity(dev, work, seq)
    if not par["step_rel_l2"] > 100 * SEQ_STEP_RTOL:
        res["problems"].append(f"(p2) the dense step moved the parameters "
                               f"by {par['step_rel_l2']:.3g} only")
    if not par["rel_l2_to_dense_step"] <= SEQ_STEP_RTOL:
        res["problems"].append(
            f"(p2) parameters after step 1 {par['rel_l2_to_dense_step']:.3g}"
            f" from the dense step, bound {SEQ_STEP_RTOL}")
    res["p2"] = tim = seq_timed(dev, work, seq)
    # SEQ_STEPS, or the epoch's steps where the data extent leaves fewer
    want = 2 * 2 * (seq - 1) * tim["layers"]
    steps = len(tim["p2p_per_step"])
    if steps < 3 or tim["p2p_per_step"] != [want] * steps:
        res["problems"].append(f"(p2) p2p per step {tim['p2p_per_step']}, "
                               f"want {want}")
    losses = tim["losses"]
    if not (len(losses) == steps and np.all(np.isfinite(losses))
            and np.isfinite((tim["eval"] or {}).get("loss", np.nan))):
        res["problems"].append(f"(p2) losses {losses}, eval {tim['eval']}")
    if tim["flash_launches"] != 0:
        res["problems"].append(f"(p2) {tim['flash_launches']} flash "
                               "launches on the ring's path")
    if long:
        res["p3"] = _long_step(dev, group, seq, pos)
    res["seconds"] = time.perf_counter() - t0
    return res


def _seq_gloo_rank(rank: int, world: int, rdv: str, work: str,
                   out_path: str) -> None:
    """(p) One of SEQ_WORLD processes sharing the card over gloo."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    res: dict = {"rank": rank, "problems": ["did not finish"]}
    try:
        res = seq_rank(torch.device("cuda", 0), work, world)
    finally:
        from mgwfbp_tpu_torch.runtime import coordination

        coordination.release()
        dist.destroy_process_group()
        with open(out_path, "w") as f:
            json.dump(res, f)


def phase_seq() -> dict:
    """(p) Sequence parallelism on the card: SEQ_WORLD gloo ranks sharing
    it form one ring (NCCL takes one rank a card); (p1) the ring against
    ``local_attention``, (p2) ``train_cli --seq-parallel`` against a dense
    step and timed, (p3) the peak memory at SEQ_LONG_T tokens against
    seq 1 (module docstring)."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mgwfbp_seq_") as d:
        ctx = mp.get_context("spawn")
        outs = [os.path.join(d, f"rank{r}.json") for r in range(SEQ_WORLD)]
        procs = [ctx.Process(target=_seq_gloo_rank,
                             args=(r, SEQ_WORLD, os.path.join(d, "rdv"), d,
                                   outs[r]))
                 for r in range(SEQ_WORLD)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SEQ_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        codes = [p.exitcode for p in procs]
        results = []
        for path in outs:
            if os.path.exists(path):
                with open(path) as f:
                    results.append(json.load(f))
    if codes != [0] * SEQ_WORLD or len(results) != SEQ_WORLD:
        fail(f"seq (p): ranks exited {codes}")
    for r in results:
        if r["problems"]:
            fail(f"seq (p) rank {r['rank']}: {'; '.join(r['problems'])}")
    # (p3) at seq 1: the whole window through local_attention, alone on
    # the card, in this process (a world of one), its peak over its own
    # baseline as the ranks' are
    dense = _long_step(torch.device("cuda", 0), None, 1, 0)
    r0 = results[0]
    p1, par, tim, ring = r0["p1"], r0["p2_parity"], r0["p2"], r0["p3"]
    if not (np.isfinite(ring["loss"]) and np.isfinite(dense["loss"])):
        fail(f"seq (p3): losses {ring['loss']} (ring), {dense['loss']}")
    secs = time.perf_counter() - t0
    print(f"seq (p1): ring of {SEQ_WORLD} over {p1['backend']} (staged "
          f"through the host: {p1['staged_through_host']}) at (B, T, H, D) "
          f"{tuple(p1['shape'])} float32 causal against local_attention: "
          f"max abs err {p1['max_abs_err']} (bound {SEQ_TOL}); "
          f"{p1['p2p_forward']} + {p1['p2p_backward']} p2p ops", flush=True)
    print(f"seq (p2): train_cli --seq-parallel {SEQ_WORLD}: parameters "
          f"after step 1 {par['rel_l2_to_dense_step']:.3g} from a world-1 "
          f"dense step (relative L2, bound {SEQ_STEP_RTOL}; the step "
          f"moved them {par['step_rel_l2']:.3g} at lr {par['lr']}; loss "
          f"{par['loss_seq']:.6f} vs {par['loss_dense']:.6f}); "
          f"{SEQ_STEPS} steps: median {tim['step_ms_median']:.2f} ms, "
          f"{tim['p2p_per_step'][0]} p2p ops per step "
          f"({tim['layers']} layers), {tim['num_groups']} groups "
          f"({tim['comm_op']}), {tim['held_groups']} held, eval "
          f"{tim['eval']}", flush=True)
    print(f"seq (p3): T={SEQ_LONG_T}, batch {SEQ_LONG_BATCH}: peak "
          f"{ring['peak_bytes_over_model'] / 2**20:.1f} MiB per rank at seq "
          f"{SEQ_WORLD} ({ring['tokens_per_rank']} tokens a rank) against "
          f"{dense['peak_bytes_over_model'] / 2**20:.1f} MiB at seq 1 "
          f"(local_attention); step {ring['step_ms_median']:.2f} ms (two "
          f"processes sharing the card) against {dense['step_ms_median']:.2f}"
          f" ms alone; (p) {secs:.1f} s", flush=True)
    return {"world": SEQ_WORLD, "seconds": secs,
            "ranks": [{k: r[k] for k in ("rank", "p1", "p2_parity", "p2",
                                         "seconds")} for r in results],
            "p3": {"ring": [r["p3"] for r in results], "dense": dense}}


ZS_STEPS = 20  # (q1), (q3): steps under set_sync_debug_mode, and timed
ZS_LOOP_STEPS = 30  # (q1): the trainer loop's timed epoch
ZS_NAN_STEPS, ZS_NAN_INTERVAL = 10, 5  # (q2): nan@step=3 at interval 5
ZS_BENCH_ITERS = 10  # (q4): the bench's timed steps per row
ZS_BENCH_BATCH = 128
# (q5): the least cosine of the card's bfloat16-statistics gradient with the
# CPU's. The gradient is rounding noise at percents (the batch norm's
# backward cancels nearly all its terms in bfloat16), so the check is a
# direction, with the card's own noise (a 1e-7 change of the input) beside it
ZS_BN_COS = 0.95


def _zs_timing(step, x, y) -> dict:
    """One fixed batch: the median step with a synchronisation after each
    (CUDA events: the earlier phases' step_ms), the mean of ZS_STEPS
    back-to-back steps closed by one synchronisation (the host clock: how
    the loop runs them now that no step waits), and the busy share of a
    profiled back-to-back window."""
    synced = _timed_steps(step, x, y, n=ZS_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ZS_STEPS):
        step(x, y)
    torch.cuda.synchronize()
    back = (time.perf_counter() - t0) * 1e3 / ZS_STEPS
    prof = _step_profile(lambda: step(x, y), steps=10)
    return {"step_ms_synced": float(np.median(synced)),
            "step_ms_back_to_back": back,
            "busy_share": prof["busy_share"],
            "profiled_wall_ms_per_step": prof["wall_ms_per_step"],
            "device_ms_per_step": prof["device_ms_per_step"],
            "kernels_per_step": prof["kernels_per_step"]}


def _zs_syncs(step, x, y) -> dict:
    """Host synchronisations inside ZS_STEPS steps: the port's observer
    (``analysis.schedule_check.HostObserver``) and
    ``torch.cuda.set_sync_debug_mode("warn")``, both of which must see
    none."""
    import warnings

    from mgwfbp_tpu_torch.analysis.schedule_check import HostObserver

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with HostObserver() as host:
                for _ in range(ZS_STEPS):
                    step(x, y)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    debug = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message)]
    if host.syncs or debug:
        fail(f"zero-sync (q1): host synchronisations inside {ZS_STEPS} "
             f"steps: observed {[s.op for s in host.syncs]}, "
             f"sync debug {debug}")
    return {"steps": ZS_STEPS, "observed_syncs": len(host.syncs),
            "sync_debug_warnings": len(debug)}


def _zs_env(**env):
    """Set (a value) or unset (None) environment variables; returns the
    previous values for ``_zs_env(**previous)``."""
    prev = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return prev


def zero_sync_resnet20(work: str) -> dict:
    """(q1) full-width ResNet-20, batch 32, synthetic CIFAR-10, one worker:
    no synchronisation inside ZS_STEPS steps, the step's timings, and the
    trainer loop's ms per step over a ZS_LOOP_STEPS-step epoch (after one
    of warm-up) with its late reads."""
    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.train import Trainer

    cfg = make_config("resnet20", batch_size=32,
                      num_batches_per_epoch=ZS_LOOP_STEPS,
                      logdir=os.path.join(work, "r20"), checkpoint_dir=None)
    tr = Trainer(cfg, device=TRAIN_DEVICE, synthetic_data=True,
                 profile_backward=False)
    try:
        tr.train_epoch(0)  # cuDNN's first use, the loader's start
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_epoch(1)
        loop_ms = (time.perf_counter() - t0) * 1e3 / ZS_LOOP_STEPS
        if len(tr.losses) != 2 * ZS_LOOP_STEPS or not np.isfinite(
                tr.losses).all():
            fail(f"zero-sync (q1): the loop's losses {tr.losses}")
        xb, yb = tr.bundle.train.load_batch(0, 0)
        x, y = tr._to_device(xb[None], yb[None])
        out = {"model": "resnet20", "batch": 32,
               "params": sum(p.numel() for p in tr.model.parameters()),
               "loop_ms_per_step": loop_ms,
               "syncs": _zs_syncs(tr.train_step, x, y),
               **_zs_timing(tr.train_step, x, y)}
    finally:
        tr.close()
    return out


def zero_sync_nan(work: str) -> dict:
    """(q2) ``nan@step=3`` at ``MGWFBP_GUARD_CHECK_INTERVAL=5`` on the
    ResNet-20 trainer: the step skips on the card (the counter ends at
    ZS_NAN_STEPS - 1, the parameters finite), the late read reports one
    ``bad_step`` at step 3, and the epoch reads the card at most
    ceil(steps / 5) + 1 times."""
    from mgwfbp_tpu_torch.analysis.schedule_check import HostObserver
    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.telemetry import events_of, read_events
    from mgwfbp_tpu_torch.train import Trainer

    prev = _zs_env(MGWFBP_FAULT_PLAN="nan@step=3",
                   MGWFBP_GUARD_CHECK_INTERVAL=str(ZS_NAN_INTERVAL),
                   MGWFBP_LOG_INTERVAL="1000")
    try:
        cfg = make_config("resnet20", batch_size=32, telemetry=True,
                          num_batches_per_epoch=ZS_NAN_STEPS,
                          logdir=os.path.join(work, "nan"),
                          checkpoint_dir=None)
        tr = Trainer(cfg, device=TRAIN_DEVICE, synthetic_data=True,
                     profile_backward=False)
        try:
            with HostObserver() as host:
                out = tr.train_epoch(0)
            stream = tr.telemetry.path
            counter = tr.train_step.step
            finite = all(bool(torch.isfinite(p).all())
                         for p in tr.model.parameters())
            losses = list(tr.losses)
        finally:
            tr.close()
    finally:
        _zs_env(**prev)
    bad = events_of(read_events(stream), "bad_step")
    reads = len(host.syncs)
    limit = -(-ZS_NAN_STEPS // ZS_NAN_INTERVAL) + 1
    if ([b["step"] for b in bad] != [3] or counter != ZS_NAN_STEPS - 1
            or not finite or not np.isnan(losses[2])
            or not np.isfinite(out["loss"]) or reads > limit):
        fail(f"zero-sync (q2): bad steps {bad}, counter {counter}, finite "
             f"{finite}, losses {losses}, reads {reads} (at most {limit})")
    return {"interval": ZS_NAN_INTERVAL, "steps": ZS_NAN_STEPS,
            "bad_steps": [b["step"] for b in bad],
            "nonfinite": bad[0]["nonfinite"], "step_counter": counter,
            "reads_per_epoch": reads, "reads_limit": limit}


def zero_sync_transformer(work: str) -> dict:
    """(q3) the preset transformer (window 64, batch 16) through its
    trainer: no synchronisation inside ZS_STEPS steps, and the timings."""
    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.train import Trainer

    cfg = make_config("transformer", num_batches_per_epoch=5,
                      logdir=os.path.join(work, "tf"), checkpoint_dir=None)
    tr = Trainer(cfg, device=TRAIN_DEVICE, synthetic_data=True,
                 profile_backward=False)
    try:
        tr.train_epoch(0)
        xb, yb = tr.bundle.train.load_batch(0, 0)
        x, y = tr._to_device(xb[None], yb[None])
        if tuple(x.shape[1:]) != (16, 64):
            fail(f"zero-sync (q3): the preset batch is {tuple(x.shape)}")
        out = {"model": "transformer", "batch": 16, "window": 64,
               "syncs": _zs_syncs(tr.step_batch, x, y),
               **_zs_timing(tr.step_batch, x, y)}
    finally:
        tr.close()
    return out


def zero_sync_bench() -> dict:
    """(q4) the bench's ResNet-50 row ``none`` (batch 128, bfloat16, one
    worker: what the trainer runs there) with ``MGWFBP_BN_DTYPE`` unset
    and ``bfloat16``, twice each, interleaved; every row's losses are read
    after its window."""
    from mgwfbp_tpu_torch import bench
    from mgwfbp_tpu_torch.utils.device import set_matmul_precision

    rows: dict = {"unset": [], "bfloat16": []}
    set_matmul_precision(torch.bfloat16)
    try:
        for mode in ("unset", "bfloat16", "unset", "bfloat16"):
            prev = _zs_env(MGWFBP_BN_DTYPE=None if mode == "unset" else mode)
            try:
                grid = bench._Grid("resnet50", ZS_BENCH_BATCH, ZS_BENCH_ITERS,
                                   torch.device("cuda"), torch.bfloat16, None)
                try:
                    dt, _ = grid.time_policy("none", None)
                finally:
                    grid.close()
            finally:
                _zs_env(**prev)
            rows[mode].append(dt * 1e3)
    finally:
        set_matmul_precision(None)
    return {mode: {"step_ms": ms, "images_per_s": [
                ZS_BENCH_BATCH * 1e3 / t for t in ms]}
            for mode, ms in rows.items()} | {
        "batch": ZS_BENCH_BATCH, "iters": ZS_BENCH_ITERS,
        "dtype": "bfloat16", "policy": "none"}


def zero_sync_bn_stat_dtype() -> dict:
    """(q5) ``MGWFBP_BN_DTYPE=bfloat16`` in a float32 ResNet-20, batch 32:
    one training step's loss and gradients on the card (the batch norm's
    ``_StatDtypeNorm``) against the same step on the CPU from the same
    weights and batch, the card's noise floor (the step on the batch
    changed by 1e-7 relative), and the step's ms, unset and set."""
    from mgwfbp_tpu_torch.models.common import BatchNorm
    from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet
    from mgwfbp_tpu_torch.train.step import forward_loss

    gen = torch.Generator().manual_seed(18)
    x = torch.randn(32, 3, 32, 32, generator=gen)
    y = torch.randint(0, 10, (32,), generator=gen)
    nudged = x * (1 + 1e-7 * torch.randn(x.shape, generator=gen))

    def grads(m, xx, yy):
        m.zero_grad()
        loss, _, _ = forward_loss(m, "classify", xx, yy)
        loss.backward()
        return loss.detach(), torch.cat([p.grad.flatten()
                                         for p in m.parameters()])

    def cos(a, b):
        return float(a @ b / (a.norm() * b.norm()))

    out: dict = {"model": "resnet20", "batch": 32}
    models = {}
    for mode in ("unset", "bfloat16"):
        prev = _zs_env(MGWFBP_BN_DTYPE=None if mode == "unset" else mode)
        try:
            torch.manual_seed(0)
            models[mode] = CifarResNet(depth=20).train()
        finally:
            _zs_env(**prev)
    m = models["bfloat16"]
    if not all(b.stat_dtype == torch.bfloat16 for b in m.modules()
               if isinstance(b, BatchNorm)):
        fail("zero-sync (q5): the batch norms do not take MGWFBP_BN_DTYPE")
    state = {k: v.clone() for k, v in m.state_dict().items()}
    loss_cpu, g_cpu = grads(m, x, y)
    m.load_state_dict(state)
    m.cuda()
    xd, yd, nd = x.cuda(), y.cuda(), nudged.cuda()
    loss_gpu, g_gpu = (t.cpu() for t in grads(m, xd, yd))
    m.load_state_dict(state)
    _, g_nudged = (t.cpu() for t in grads(m, nd, yd))
    rel_loss = float((loss_gpu - loss_cpu).abs() / loss_cpu.abs())
    out.update(loss_rel=rel_loss, cos_cpu=cos(g_gpu, g_cpu),
               cos_noise=cos(g_gpu, g_nudged),
               rel_cpu=float((g_gpu - g_cpu).norm() / g_cpu.norm()),
               rel_noise=float((g_gpu - g_nudged).norm() / g_gpu.norm()))
    if not torch.isfinite(g_gpu).all() or rel_loss > 2e-2 or (
            out["cos_cpu"] < ZS_BN_COS):
        fail(f"zero-sync (q5): the card's bfloat16-statistics step against "
             f"the CPU's: {out}")
    for mode, model in models.items():
        model.cuda()

        def step(xx, yy, model=model):
            grads(model, xx, yy)

        out[f"{mode}_step_ms"] = float(np.median(_timed_steps(
            step, xd, yd, n=ZS_STEPS)))
    return out


def phase_zero_sync() -> dict:
    """(q) the zero-sync step loop on the card (module docstring)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mgwfbp_zero_sync_") as work:
        out = {"resnet20": zero_sync_resnet20(work),
               "nan": zero_sync_nan(work),
               "transformer": zero_sync_transformer(work),
               "bench_resnet50": zero_sync_bench(),
               "bn_stat_dtype": zero_sync_bn_stat_dtype()}
    out["seconds"] = time.perf_counter() - t0
    r20, tf, b = out["resnet20"], out["transformer"], out["bench_resnet50"]
    bn = out["bn_stat_dtype"]
    print(f"zero-sync (q): no synchronisation in {ZS_STEPS} steps; "
          f"resnet20 b32 {r20['step_ms_synced']:.2f} ms synced, "
          f"{r20['step_ms_back_to_back']:.2f} ms back to back, busy "
          f"{r20['busy_share']}, loop {r20['loop_ms_per_step']:.2f} ms; "
          f"transformer 16x64 {tf['step_ms_synced']:.2f} / "
          f"{tf['step_ms_back_to_back']:.2f} ms, busy {tf['busy_share']}; "
          f"nan@step=3 at interval {ZS_NAN_INTERVAL}: bad steps "
          f"{out['nan']['bad_steps']}, {out['nan']['reads_per_epoch']} "
          f"read(s); resnet50 none {b['unset']['step_ms']} ms, "
          f"MGWFBP_BN_DTYPE=bfloat16 {b['bfloat16']['step_ms']} ms; "
          f"float32 resnet20 at bfloat16 statistics: loss rel "
          f"{bn['loss_rel']:.2e}, gradient cosine with the CPU "
          f"{bn['cos_cpu']:.4f} (noise {bn['cos_noise']:.4f}), step "
          f"{bn['bfloat16_step_ms']:.2f} ms against {bn['unset_step_ms']:.2f} "
          f"unset; "
          f"{out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase (r): the operator tools on the card
# ---------------------------------------------------------------------------

SMOKE_T0 = time.monotonic()  # the script's start: (r4) reads the time left
SMOKE_LIMIT_S = 1200.0  # the whole run's limit
TOOL_TIMEOUT_S = 120  # each report tool
FAULT_TIMEOUT_S = 300  # (r4): two train_cli processes and their stall
# (r4) runs when this much of the smoke's limit is left: twice the 52.5 s
# it took on the card alone, with room for the lines after it (on the
# card's host the lifecycle takes as long on the CPU, so it is never
# moved there)
FAULT_NEED_S = 110.0
END_MARGIN_S = 15.0  # the lines printed after phase (r)
KEPT: dict = {}  # name -> a copy of what an earlier phase wrote, for (r)


def _keep(name: str, src: str) -> None:
    """Copy ``src`` (a file or directory an earlier phase wrote inside its
    own temporary directory) aside for phase (r)."""
    if "_dir" not in KEPT:
        KEPT["_dir"] = tempfile.mkdtemp(prefix="mgwfbp_tools_in_")
    dst = os.path.join(KEPT["_dir"], name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    KEPT[name] = dst


def _start_tool(module: str, *args: str, n: int = 1) -> dict:
    """Start ``module`` with JAX refused, in n processes of one world when
    n > 1 (a localhost rendezvous in the launch environment that
    ``parallel.mesh.init_distributed`` reads); ``_finish_tool`` joins it."""
    from mgwfbp_tpu_torch.runtime.supervisor import free_port
    from mgwfbp_tpu_torch.tools import nojax

    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    if n > 1:
        env.update(MGWFBP_COORDINATOR=f"127.0.0.1:{free_port()}",
                   MGWFBP_NUM_PROCESSES=str(n))
    procs = [subprocess.Popen(
        nojax.argv(module, *args), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**env, **({"MGWFBP_PROCESS_ID": str(r)} if n > 1 else {})})
        for r in range(n)]
    return {"procs": procs, "t0": time.perf_counter()}


def _finish_tool(rows: list, name: str, run: dict,
                 timeout_s: float = TOOL_TIMEOUT_S,
                 phase: str = "measure (s)") -> list[str]:
    """Join a ``_start_tool`` run within ``timeout_s`` of its start: its
    standard outputs; its rc and seconds join ``rows``; a non-zero rc or a
    hang fails the run (``phase`` names it; every process of it is killed
    first)."""
    outs, codes = [], []
    try:
        for p in run["procs"]:
            left = timeout_s - (time.perf_counter() - run["t0"])
            try:
                out, err = p.communicate(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                fail(f"{phase}: {name} did not end within {timeout_s} s")
            outs.append(out)
            codes.append(p.returncode)
            if p.returncode:
                print(out[-3000:], file=sys.stderr)
                print(err[-3000:], file=sys.stderr)
    finally:
        for p in run["procs"]:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    rows.append({"name": name, "rc": codes if len(codes) > 1 else codes[0],
                 "seconds": time.perf_counter() - run["t0"]})
    if codes != [0] * len(codes):
        fail(f"{phase}: {name} exited {codes}")
    return outs


def _tool(rows: list, name: str, module: str, *args: str,
          timeout_s: float = TOOL_TIMEOUT_S,
          phase: str = "tools (r)") -> subprocess.CompletedProcess:
    """One tool in a subprocess with JAX refused, run to its end
    (``_start_tool``, ``_finish_tool``)."""
    (out,) = _finish_tool(rows, name, _start_tool(module, *args),
                          timeout_s, phase)
    return subprocess.CompletedProcess(module, 0, stdout=out)


def phase_tools() -> dict:
    """(r) The port's operator tools on what the earlier phases wrote, each
    in a subprocess with JAX and the JAX package refused: the report and
    its exports on (j3)'s and (k)'s streams, the merge of (j3)'s two
    streams, the autotune report of (n)'s cache entry, and the fault
    smoke's single-process lifecycle on the card."""
    from mgwfbp_tpu_torch.telemetry import read_event_set
    from mgwfbp_tpu_torch.telemetry.export import (
        latest_snapshot,
        parse_metrics_text,
    )

    t0 = time.perf_counter()
    rows: list = []
    out: dict = {}
    work = tempfile.mkdtemp(prefix="mgwfbp_tools_")
    try:
        n2 = [d for d in glob.glob(os.path.join(KEPT["j3_logs"], "*"))
              if "-n2-" in os.path.basename(d)]
        if len(n2) != 1:
            fail(f"tools (r): (j3) left no single n2 tag directory: {n2}")
        streams = sorted(glob.glob(os.path.join(n2[0], "telemetry.p*.jsonl")))
        if len(streams) != 2:
            fail(f"tools (r): (j3)'s streams {streams}")
        # (r1) the report and its exports
        trace = os.path.join(work, "trace.json")
        prom = os.path.join(work, "metrics.prom")
        res = _tool(rows, "telemetry_report",
                    "mgwfbp_tpu_torch.tools.telemetry_report", streams[0],
                    "--chrome-trace", trace, "--prometheus", prom)
        snap, groups = latest_snapshot(read_event_set(streams[0]))
        text = res.stdout
        table = text[text.index("overlap snapshot"):].splitlines()[2:]
        table = table[:next(i for i, line in enumerate(table)
                            if line.startswith("  total comm"))]
        got = [int(line.split()[0]) for line in table]
        if snap is None or got != [int(g["group"]) for g in groups]:
            fail(f"tools (r1): overlap table groups {got} against the "
                 f"snapshot's {[g['group'] for g in groups]}")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        with open(prom) as f:
            values = parse_metrics_text(f.read())
        if not events or not values.get("mgwfbp_steps_total"):
            fail("tools (r1): the trace or the Prometheus dump is empty")
        (k_stream,) = glob.glob(os.path.join(KEPT["k_logs"], "*",
                                             "telemetry.jsonl"))
        res = _tool(rows, "telemetry_report_k",
                    "mgwfbp_tpu_torch.tools.telemetry_report", k_stream)
        if "training health" not in res.stdout:
            fail("tools (r1): (k)'s report has no health section")
        out["r1"] = {"groups": got, "trace_events": len(events),
                     "metrics": len(values)}
        # (r2) the merge
        merged_path = os.path.join(work, "merged.jsonl")
        res = _tool(rows, "telemetry_merge",
                    "mgwfbp_tpu_torch.tools.telemetry_merge", *streams,
                    "--out", merged_path)
        with open(merged_path) as f:
            merged = [json.loads(line) for line in f]
        ts = [r["t"] for r in merged]
        procs = [line.split()[0] for line in res.stdout.splitlines()[3:]
                 if line.strip()]
        if ts != sorted(ts) or procs != ["0", "1"] or (
                "2 stream(s), 2 process(es)" not in res.stdout):
            fail(f"tools (r2): merge report {res.stdout!r}")
        out["r2"] = {"records": len(merged), "processes": procs}
        # (r3) the autotune report
        (entry,) = glob.glob(os.path.join(KEPT["n_cache"], "*.json"))
        with open(entry) as f:
            doc = json.load(f)
        res = _tool(rows, "autotune_report",
                    "mgwfbp_tpu_torch.tools.autotune_report", entry)
        labels = [e["label"] for e in doc["race"]]
        if f"committed winner: {doc['winner']}" not in res.stdout or not (
                labels and all(lb in res.stdout for lb in labels)):
            fail(f"tools (r3): the report misses the winner {doc['winner']} "
                 f"or a label of {labels}")
        out["r3"] = {"winner": doc["winner"], "labels": len(labels)}
        # (r4) the fault smoke on the card, unless the time left says not
        left = SMOKE_LIMIT_S - (time.monotonic() - SMOKE_T0)
        if left < FAULT_NEED_S:
            out["r4"] = {"skipped": f"{left:.0f} s left of the smoke's "
                                    f"{SMOKE_LIMIT_S:.0f}"}
        else:
            res = _tool(rows, "fault_smoke",
                        "mgwfbp_tpu_torch.tools.fault_smoke", "--device",
                        "cuda", timeout_s=min(FAULT_TIMEOUT_S,
                                              left - END_MARGIN_S))
            result = json.loads(res.stdout.strip().splitlines()[-1])
            if result.get("fault_smoke") != "ok" or (
                    result["final_step"], result["resume_iteration"]) != (
                    12, 4):
                fail(f"tools (r4): fault smoke {result}")
            out["r4"] = {"left_s": left, **result}
    finally:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(KEPT.get("_dir", ""), ignore_errors=True)
    out["tools"] = rows
    out["seconds"] = time.perf_counter() - t0
    print("tools (r): " + ", ".join(
        f"{r['name']} rc {r['rc']} {r['seconds']:.2f} s" for r in rows)
        + ("; fault smoke skipped: " + out["r4"]["skipped"]
           if "skipped" in out["r4"] else "")
        + f"; phase {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase (s): the measuring tools on the card
# ---------------------------------------------------------------------------

MEASURE_BATCH = 32  # ResNet-20's per-worker batch in (s1)-(s5)
MEASURE_WORLD = 2  # (s3): gloo ranks sharing the card
MEASURE_IMAGENET_N = 256  # (s5): --make-data --imagenet-n
MEASURE_INPUT_ITERS = 30  # (s5): timed steps per leg (3 of warm-up)
MEASURE_MFU_ITERS = 3  # (s6): timed steps per row
MEASURE_FLOPS_RTOL = 1e-6  # (s6): batch_64's FLOPs against half of b128's


def _resnet20_specs() -> list:
    """ResNet-20's LayerSpecs in arrival order (shapes only)."""
    from mgwfbp_tpu_torch.models import create_model
    from mgwfbp_tpu_torch.tools.overlap_report import arrival_layers

    with torch.device("meta"):
        model, _ = create_model("resnet20")
    return arrival_layers(model, 4)


def phase_measure() -> dict:
    """(s) The port's measuring tools on the card, each in a subprocess with
    JAX refused, at their smallest honest arguments (module docstring), all
    started together, but for (s5)'s steps, which start once its files are
    written. The checks are of the tools' machinery; their times are
    taken beside each other's."""
    from mgwfbp_tpu_torch.bench import flops_per_step, make_model
    from mgwfbp_tpu_torch.parallel.costmodel import (
        load_profile,
        lookup_alpha_beta,
        resolve_profile,
    )
    from mgwfbp_tpu_torch.parallel.solver import build_schedule

    t0 = time.perf_counter()
    rows: list = []
    out: dict = {}
    work = tempfile.mkdtemp(prefix="mgwfbp_measure_")
    tool = "mgwfbp_tpu_torch.tools."
    data_dir = os.path.join(work, "data")
    r20 = ("--model", "resnet20", "--batch", str(MEASURE_BATCH))
    paths = {k: os.path.join(work, f"{k}.json") for k in (
        "s1", "s2", "s3", "s4", "s5", "s6")}
    running: list = []

    def start(*args, n: int = 1) -> dict:
        run = _start_tool(*args, n=n)
        running.append(run)
        return run

    def doc(key):
        with open(paths[key]) as f:
            return json.load(f)

    try:
        if "d_calibrate" in KEPT:
            profile = os.path.join(KEPT["d_calibrate"], "profile.json")
        else:  # (s) alone: the card's profile as (d) makes it
            profile = os.path.join(work, "profile.json")
            _tool(rows, "calibrate", "mgwfbp_tpu_torch.calibrate", "--out",
                  profile, "--prior-extend", "56GbIB", phase="measure (s)")
        make = start(tool + "input_bench", "--make-data", "--data-dir",
                     data_dir, "--imagenet-n", str(MEASURE_IMAGENET_N))
        s1 = start(tool + "overlap_report", *r20, "--steps", "2", "--out",
                   paths["s1"])
        s2 = start(tool + "gamma_sensitivity", "--models", "resnet20",
                   "--batch", str(MEASURE_BATCH), "--comm-profile", profile,
                   "--out", paths["s2"])
        s4 = start(tool + "scaling_efficiency", *r20, "--iters", "3",
                   "--warmup", "1", "--comm-profile", profile, "--out",
                   paths["s4"])
        s3 = start(tool + "policy_grid", *r20, "--iters", "6", "--warmup",
                   "2", "--rounds", "3", "--backend", "gloo", "--out",
                   paths["s3"], n=MEASURE_WORLD)
        s6 = start(tool + "mfu_ablation", "--iters", str(MEASURE_MFU_ITERS),
                   "--out", paths["s6"])
        _finish_tool(rows, "overlap_report", s1)
        ov = doc("s1")
        pva = ov.get("predicted_vs_actual", [])
        if (ov["n_compute_events"] <= 0 or ov["compute_us"] <= 0
                or ov["n_collective_events"] != 0
                or len(pva) != ov["merge_groups"]):
            fail(f"measure (s1): {ov['n_compute_events']} compute kernels, "
                 f"{ov['n_collective_events']} collectives (one rank: "
                 f"none), {len(pva)} predictions of {ov['merge_groups']} "
                 "groups")
        out["s1"] = {k: ov[k] for k in (
            "n_compute_events", "compute_us", "n_collective_events",
            "merge_groups", "seconds")}
        _finish_tool(rows, "gamma_sensitivity", s2)
        g = doc("s2")["models"]["resnet20"]
        solved = build_schedule(
            _resnet20_specs(), g["tb_s"], policy="auto",
            cost_model=resolve_profile(load_profile(profile), 2))
        if [list(x) for x in solved.groups] != g["groups_at_1.0"]:
            fail(f"measure (s2): the 1.0x row's {len(g['groups_at_1.0'])} "
                 f"groups differ from build_schedule's {solved.num_groups}")
        out["s2"] = {"num_groups": solved.num_groups,
                     "flips": g["schedule_flips_at"],
                     "max_regret_frac": g["max_regret_frac"],
                     "tb_total_s": g["tb_total_s"]}
        _finish_tool(rows, "scaling_efficiency", s4)
        sc = doc("s4")
        card = torch.cuda.get_device_name(0)
        pred = sc["predicted_targets"]
        effs = [p["predicted_efficiency"] for t in pred.values()
                for p in t["policies"].values()]
        if (sc["measured_weak_scaling"]["1"]["efficiency"] != 1.0 or not pred
                or not all(card in t for t in pred)
                or not all(0.0 < e <= 1.0 for e in effs)):
            fail(f"measure (s4): measured {sc['measured_weak_scaling']}, "
                 f"targets {sorted(pred)}")
        out["s4"] = {"t1_sec_per_iter": sc["t1_sec_per_iter"],
                     "targets": {t: {p: r["predicted_efficiency"] for p, r in
                                     v["policies"].items()}
                                 for t, v in pred.items()}}
        (made,) = _finish_tool(rows, "input_bench --make-data", make)
        legs = json.loads(made.strip().splitlines()[-1])["legs"]
        if legs.get("cifar10") != "ok":
            fail(f"measure (s5): --make-data legs {legs}")
        s5 = start(tool + "input_bench", "--model", "resnet20", "--data-dir",
                   data_dir, "--iters", str(MEASURE_INPUT_ITERS), "--warmup",
                   "3", "--out", paths["s5"])
        model, meta = make_model("resnet50", "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(128, 3, 224, 224, device="cuda", generator=gen)
        y = torch.randint(0, 1000, (128,), device="cuda", generator=gen)
        want = flops_per_step(model, x, y, torch.bfloat16)
        del model, x, y
        torch.cuda.empty_cache()
        _finish_tool(rows, "policy_grid", s3)
        grid = doc("s3")
        prior = lookup_alpha_beta("ici", MEASURE_WORLD)
        for pol, groups in grid["groups"].items():
            solved = build_schedule(_resnet20_specs(), grid["tb_s"],
                                    policy=pol.split("#")[0],
                                    cost_model=prior)
            if [list(x) for x in solved.groups] != groups:
                fail(f"measure (s3): {pol}'s groups differ from its solve")
        if "noise_pair" not in grid or grid["n_devices"] != MEASURE_WORLD:
            fail(f"measure (s3): no noise pair, or {grid['n_devices']} "
                 "devices")
        out["s3"] = {"sec_per_iter": {p: r["sec_per_iter"] for p, r in
                                      grid["policies"].items()},
                     "merge_groups": {p: r["merge_groups"] for p, r in
                                      grid["policies"].items()},
                     "noise_bound_s": grid["noise_pair"]["bound_s"],
                     "fastest": grid["conclusion"]["fastest_by_median"]}
        _finish_tool(rows, "input_bench", s5)
        ib = doc("s5")["results"]
        ratios = [ib.get("real_over_synthetic_throughput"),
                  ib.get("prefetch_over_no_prefetch_throughput")]
        if not all(r is not None and np.isfinite(r) for r in ratios):
            fail(f"measure (s5): ratios {ratios}")
        out["s5"] = {"legs": legs, "results": ib}
        _finish_tool(rows, "mfu_ablation", s6)
        mfu = doc("s6")["rows"]
        base, half = mfu["baseline_b128"], mfu["batch_64"]
        if (base["flops_per_step"] != want
                or abs(half["flops_per_step"] * 2 - want)
                > MEASURE_FLOPS_RTOL * want
                or not all(0.0 < r["mfu"] <= 1.0 for r in mfu.values())):
            fail(f"measure (s6): FLOPs {base['flops_per_step']} against "
                 f"bench.flops_per_step {want}, batch_64 "
                 f"{half['flops_per_step']}, MFU "
                 f"{[r['mfu'] for r in mfu.values()]}")
        out["s6"] = {n: {k: r[k] for k in ("sec_per_iter", "images_per_sec",
                                           "mfu", "flops_per_step")}
                     for n, r in mfu.items()}
    finally:
        for run in running:
            for p in run["procs"]:
                if p.poll() is None:
                    p.kill()
                    p.wait(10)
        shutil.rmtree(work, ignore_errors=True)
    out["tools"] = rows
    out["seconds"] = time.perf_counter() - t0
    print(f"measure (s1): resnet20 b{MEASURE_BATCH}, "
          f"{out['s1']['n_compute_events']} compute kernels "
          f"({out['s1']['compute_us']:.1f} us), no collective kernel at one "
          f"rank, {out['s1']['merge_groups']} groups; (s2) auto "
          f"{out['s2']['num_groups']} group(s) = build_schedule, flips at "
          f"{out['s2']['flips']}; (s3) {MEASURE_WORLD} gloo ranks: "
          + ", ".join(f"{p} {v * 1e3:.2f} ms"
                      for p, v in out["s3"]["sec_per_iter"].items())
          + f", noise bound {out['s3']['noise_bound_s'] * 1e3:.2f} ms; (s4) "
          f"t1 {out['s4']['t1_sec_per_iter'] * 1e3:.2f} ms, "
          f"{len(out['s4']['targets'])} targets; (s5) legs {legs}, "
          f"real/synthetic {ratios[0]}, prefetch/none {ratios[1]}; (s6) "
          + ", ".join(f"{n} {r['images_per_sec']:.1f} img/s MFU "
                      f"{r['mfu']:.4f}" for n, r in out["s6"].items())
          + "; " + ", ".join(f"{r['name']} {r['seconds']:.1f} s"
                             for r in rows)
          + f"; phase {out['seconds']:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA card")
    import mgwfbp_tpu_torch  # noqa: F401 — fails outside a checkout
    from mgwfbp_tpu_torch.utils.device import set_matmul_precision

    set_matmul_precision(None)  # float32 phases: TF32 off (the trainer's)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = (smi.stdout.strip().splitlines() or ["nvidia-smi unavailable"])[0]
    print(
        f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
        flush=True,
    )
    gen = torch.Generator().manual_seed(0)
    phase_s: dict = {}  # each phase's seconds, printed with the results

    def timed(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        phase_s[name] = round(time.perf_counter() - t, 1)
        return res

    timed("build", phase_build)
    rows = timed("kernels", phase_kernels, gen)
    launches, latencies = timed("serve", phase_serve, gen)
    reducer_b, train = timed("a-c train", phase_train)
    calibrated = timed("d calibrate", phase_calibrate, reducer_b,
                       train["gloo"])
    lm = timed("e lm", phase_lm)
    resnet50 = timed("f resnet50", phase_resnet50)
    resilience = timed("g resilience", phase_resilience)
    zoo = timed("h zoo", phase_zoo)
    lstman4 = timed("i lstman4", phase_lstman4)
    supervise = timed("j supervise", phase_supervise)
    telemetry = timed("k telemetry", phase_telemetry)
    lowerings = timed("l lowerings", phase_lowerings)
    cross_step = timed("m cross_step", phase_cross_step)
    autotune = timed("n autotune", phase_autotune, calibrated)
    analysis = timed("o analysis", phase_analysis)
    seq = timed("p seq", phase_seq)
    zero_sync = timed("q zero_sync", phase_zero_sync)
    measure = timed("s measure", phase_measure)
    tools = timed("r tools", phase_tools)

    serve = rows[0]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "mgwfbp_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "mgwfbp_tpu/ops/flashattn.py:115",
        "launches": launches,
        # the supervised replica's two lives (phase (j4)), read from its
        # /status: another process, its count starts at 0 in each life
        "launches_supervised_replica": supervise["serving"]["flash_launches"],
        "max_abs_err": serve["max_abs_err"],
        "ms": serve["ms"],
        "kernel_ms": serve["ms"],
        "device_us": serve["device_us"],
        "host_us": serve["host_us"],
        "plain_ms": serve["plain_ms"],
        "bound_ms": serve["bound_ms"],
        "bound_by": serve["bound_by"],
        "library_ms": serve["library_ms"],
    }]
    print(json.dumps({"flash_attention_shapes": rows}))
    print(json.dumps({"predict_latencies": latencies}))
    print(json.dumps({"train": train}))
    print(json.dumps({"calibrate": calibrated}))
    print(json.dumps({"lm": lm}))
    print(json.dumps({"resnet50": resnet50}))
    print(json.dumps({"resilience": resilience}))
    print(json.dumps({"zoo_summary": [
        {k: r[k] for k in ("model", "step_ms", "images_per_s", "busy_share",
                           "num_groups", "held_groups", "peak_memory_bytes")}
        for r in zoo]}))
    print(json.dumps({"lstman4": lstman4}))
    print(json.dumps({"supervise": supervise}))
    print(json.dumps({"telemetry": telemetry}))
    print(json.dumps({"lowerings": lowerings}))
    print(json.dumps({"cross_step": cross_step}))
    print(json.dumps({"autotune": autotune}))
    print(json.dumps({"analysis": analysis}))
    print(json.dumps({"seq": seq}))
    print(json.dumps({"zero_sync": zero_sync, "card": card}))
    print(json.dumps({"measure": measure, "card": card}))
    print(json.dumps({"phase_seconds": phase_s,
                      "smoke_s": time.monotonic() - SMOKE_T0}))
    print(json.dumps({"tools": tools, "card": card}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
