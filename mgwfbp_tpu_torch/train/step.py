"""The data-parallel train step with MG-WFBP merged all-reduce (counterpart
of the ``all_reduce`` path of ``mgwfbp_tpu/train/step.py``, classify, lm and
ctc tasks).

One ``TrainStep`` call is one optimizer step:

  * ``nsteps_update`` micro-steps of forward + backward, gradients summed
    in ``.grad`` and averaged (scaled by 1/n before the reduction, as the
    JAX step scales before its pmean). Only the last micro-step's backward
    carries communication: the reducer's hooks launch each merge group's
    all-reduce as its gradients land; ``synchronize`` waits and unpacks.
    Without a reducer (policy 'none', several workers) each leaf is
    all-reduced on its own after the backward; one worker reduces nothing;
  * the loss: mean softmax cross-entropy in float32, over the batch
    (classify) or over every token of the batch (lm, logits reshaped to
    (B*T, V)), plus 0.3 x each aux head's for googlenet and inceptionv3;
    the metric beside it is the accuracy (of the main logits) or the
    perplexity ``exp(loss)``. A ctc batch (the speech model) carries its
    input and label lengths with the micro-batch axis, and its loss is the
    mean over the batch of each sequence's CTC negative log-likelihood
    (``ctc_loss``, optax's ``ctc_loss`` to the last impossible alignment);
  * a BPTT carry (the LSTM) goes in, threads through the micro-batches in
    order, each micro-step starting from the previous one's carry
    detached, and comes out detached; a windowed LM (the transformer)
    passes none;
  * the non-finite guard, decided on the device as the JAX step's
    ``bad_step_guard`` does, never on the host: the reduced gradients'
    non-finite values are counted, the count rides the metrics' mean, and
    ``ok`` (a 0-dim bool tensor, count == 0) masks the update. A bad step
    keeps the WHOLE pre-step state exactly: parameters and momentum
    buffers (the gradients are zeroed and the update made an exact no-op,
    ``optim.sgd_update_``; the sharded lowerings select the old shards and
    slots with ``torch.where``), the step counter, the carry that came in
    (``torch.where``) and the batch-norm running statistics, which torch
    updates in place during the forward, selected from a snapshot taken
    before it. Every rank issues the same collectives whatever the flag
    says;
  * the step counter is a 0-dim int64 device tensor advanced by ``ok``,
    and the learning rate ``lr_fn(step)`` is read from a device table of
    the schedule indexed by it, so the schedule's index stays put on a bad
    step with nothing read back (``step`` reads the counter on the host,
    outside the step);
  * batch-norm running statistics and the metrics (mean loss, accuracy or
    perplexity, non-finite count) are averaged across ranks, the running
    statistics on every step;
  * ``compute_dtype`` (bfloat16): the JAX step's mixed-precision policy.
    The forward and backward run on copies of the parameters, the input
    and the carry cast to that dtype (``model_forward``, through
    ``torch.func.functional_call``); logits come back to float32 before the
    loss, and metrics are float32. The masters stay float32: gradients
    arrive on the float32 parameters (so the reducer's hooks stay where
    they are), the optimizer state and the carry are float32, and each
    ``BatchNorm`` reduces its statistics in float32 and merges its update
    into its float32 running statistics as a delta (``BatchNorm.forward``).
    No ``torch.autocast``: it picks a dtype per op, and the JAX policy casts
    the whole program.

  * a reducer built with ``comm_op='rs_opt_ag'`` (the sharded optimizer)
    changes the optimizer contract, as in the JAX step: the reduced
    gradients never materialize, the step does not call
    ``optimizer.step()`` (the reducer's ``reduce_and_update`` updates the
    parameters from its own sharded state, and its ``OptimSpec`` clips),
    and the non-finite count, like the health statistics below, is taken
    on the LOCAL pre-reduction gradients and averaged over the ranks: a
    non-finite value survives the reduce-scatter, so the count is non-zero
    exactly when the update would consume one;
  * a reducer built with ``comm_op='rs_fwd_ag'`` (the cross-step pipeline)
    keeps that contract with the all-gather moved into the next step: the
    step starts with the reducer's ``gather_params()`` (the all-gathers of
    the previous update, which the forward's pre-hooks wait for; at a
    compute dtype every gather is waited for before the forward's cast,
    which reads all the parameters at once) and ends with
    ``reduce_and_defer`` (the module's parameters stay one update stale
    until the next step's forward). A skipped step keeps the pre-step
    shards and count (selected on the device). The update ratio is then
    taken on the shards
    (old and new, every rank's summed by one two-element all-reduce);
  * a reducer built with ``comm_op='hier'`` reduces through
    ``synchronize`` like the single-level lowerings;
  * ``seq_group`` (sequence parallelism, ``parallel.mesh.seq_groups``):
    the model is a windowed LM whose blocks attend through that ring
    (``TransformerLM.set_seq_group``) and x, y are this rank's time slice
    of its data index's rows. Each rank's loss is the mean over its token
    slice, so the global loss gradient is the mean over every rank: the
    reducer and the plain path reduce over the whole world, as the JAX
    step's ``red_axes = data_axes + (seq_axis,)`` does, and the metrics
    average over it. A model with a BPTT carry is refused (the JAX
    step's message);

  * ``health_stats`` (the JAX step's ``_health_stat_entries``): the L2
    norm of the post-reduction gradients (before clipping; the local ones,
    averaged over the ranks, on ``rs_opt_ag`` and ``rs_fwd_ag``), one norm
    per merge group
    in the reducer's arrival permutation, the update ratio
    ||new - old params|| / max(||old params||, 1e-12) (NaN on a skipped
    step, as the JAX step's update of non-finite gradients gives). Each
    leaf's norm is taken once, accumulated in float32 (float64 leaves in
    float64), by the multi-tensor ``torch._foreach_norm``; the old
    parameters are copied into a preallocated snapshot each step. They
    describe THIS step and come back with its metrics under ``health/``
    keys, as the JAX step's do. With a sparsifying compressor they also
    hold each merge group's relative top-k compression error on the local
    bucket at the wire dtype (the JAX step's
    ``_compression_error_entries``, which the reducer's hooks measure as
    they select), averaged over the ranks.

The step does not synchronise with the host: it returns its metrics as
0-dim device tensors (views of one vector), and a caller reads them when
it needs them, the trainer one step late (``Trainer._note_step``), the
timing loops after their window. The model's buffers are re-seated as
views of one flat tensor, so the snapshot, the selection and the
cross-rank average are one operation each. The step's own collectives run
in the ranges the JAX step declares for them (``metrics_reduce``,
``bstats_reduce``, ``flat_grad_reduce``;
``parallel.allreduce.collective_scope``), which the schedule verifier
(``analysis.schedule_check``) tells from a merge group's; the guard's count
runs in ``finite_check``, the range SCH008 reads, and SCH005 holds that
nothing inside the step reads the device on the host.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mgwfbp_tpu_torch.models.lstm import repackage_carry
from mgwfbp_tpu_torch.optim import clip_by_global_norm_, sgd_update_
from mgwfbp_tpu_torch.parallel.allreduce import (
    SHARDED_OPS,
    MergedAllreduce,
    collective_scope,
)
from mgwfbp_tpu_torch.parallel.mesh import world_size


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels, in float32; LM logits
    (B, T, V) count every token, reshaped to (B*T, V)."""
    logits = logits.float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def _cast(tree, dtype: torch.dtype):
    """Floating tensors of a tensor or a (nested) tuple cast to dtype."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cast(t, dtype) for t in tree)
    return tree.to(dtype) if tree.is_floating_point() else tree


def model_forward(model: nn.Module, x: torch.Tensor, carry=None,
                  compute_dtype: Optional[torch.dtype] = None):
    """``model(x)`` (``model(x, carry)`` with a second input: an LM's carry,
    a ctc model's input lengths). At a compute dtype: on the parameters,
    the input and the carry cast to it (integer tensors stay as they are),
    with the outputs returned in float32; the gradients land, cast back, on
    the float32 parameters."""
    if compute_dtype is None:
        return model(x) if carry is None else model(x, carry)
    params = {name: p.to(compute_dtype)
              for name, p in model.named_parameters()}
    args = (_cast(x, compute_dtype),)
    if carry is not None:
        args += (_cast(carry, compute_dtype),)
    out = torch.func.functional_call(model, params, args)
    return _cast(out, torch.float32)


AUX_WEIGHT = 0.3  # the aux heads' share of the loss (JAX make_loss_fn)
CTC_LOG_EPSILON = -1e5  # optax ctc_loss's log(0)


def ctc_impossible(labels: torch.Tensor, label_lengths: torch.Tensor,
                   out_lengths: torch.Tensor) -> torch.Tensor:
    """Per sequence, whether no CTC alignment exists: fewer output frames
    than labels plus the blanks that must separate repeated labels. Host
    tensors in, a host bool tensor out."""
    labels = labels.long()
    n = labels.shape[1]
    pos = torch.arange(1, n)
    repeat = (labels[:, 1:] == labels[:, :-1]) & (pos[None, :] < label_lengths[:, None])
    need = label_lengths.long() + repeat.sum(1)
    return out_lengths.long() < need


def ctc_loss_plain(logits: torch.Tensor, out_lengths: torch.Tensor,
                   labels: torch.Tensor, label_lengths: torch.Tensor,
                   log_epsilon: float = CTC_LOG_EPSILON) -> torch.Tensor:
    """optax's ``ctc_loss`` (blank 0) in plain torch, one step of its
    forward recursion per frame: per-sequence negative log-likelihoods
    (B,). Where no alignment exists it returns what optax returns, a large
    finite value from ``log_epsilon`` in place of log(0), and its gradient
    is autograd's of that value."""
    b, t, _ = logits.shape
    n = labels.shape[1]
    dev = logits.device
    kw = {"device": dev, "dtype": torch.promote_types(logits.dtype,
                                                       torch.float32)}
    logp = F.log_softmax(logits.to(kw["dtype"]), -1)
    labels = labels.long().to(dev)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(kw["dtype"]), (0, 1))
    emit = logp.gather(2, labels[:, None, :].expand(b, t, n))  # (B, T, N)
    pad = (torch.arange(t, device=dev)[None, :]
           >= out_lengths.to(dev)[:, None]).to(kw["dtype"])  # (B, T)
    phi = torch.cat([torch.zeros((b, 1), **kw),
                     torch.full((b, n), log_epsilon, **kw)], 1)
    em = torch.full((b, n), log_epsilon, **kw)

    def add_to_phi(p, score):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], score)], 1)

    for k in range(t):
        phi_orig = phi
        phi = add_to_phi(phi, em + log_epsilon * repeat)
        lp_emit, lp_phi = emit[:, k], logp[:, k, :1]
        next_em = torch.logaddexp(phi[:, :-1] + lp_emit, em + lp_emit)
        next_phi = add_to_phi(phi + lp_phi,
                              em + lp_phi + log_epsilon * (1.0 - repeat))
        p = pad[:, k:k + 1]
        em = p * em + (1.0 - p) * next_em
        phi = p * phi_orig + (1.0 - p) * next_phi
    phi = add_to_phi(phi, em)
    return -phi.gather(1, label_lengths.long().to(dev)[:, None])[:, 0]


def ctc_loss(logits: torch.Tensor, out_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihoods (B,) of logits (B, T, C),
    blank 0, in float32 (float64 logits stay float64): the JAX step's
    ``optax.ctc_loss``. torch's CTC
    (``reduction="none"``; its "mean" would divide by the label lengths)
    gives every sequence that has an alignment; where none exists torch
    gives inf and optax a large finite value, so those sequences take
    ``ctc_loss_plain``. The lengths and labels are read on the host (torch's
    CTC reads the lengths there anyway)."""
    olen, llen = out_lengths.cpu().long(), label_lengths.cpu().long()
    logp = F.log_softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), -1)
    per = F.ctc_loss(logp.transpose(0, 1), labels.long(), olen, llen,
                     blank=0, reduction="none", zero_infinity=True)
    bad = ctc_impossible(labels.cpu(), llen, olen)
    if bool(bad.any()):
        idx = bad.nonzero()[:, 0].to(logits.device)
        plain = ctc_loss_plain(logits[idx], olen[bad], labels[idx], llen[bad])
        per = per.index_put((idx,), plain)
    return per


def forward_loss(model: nn.Module, task: str, x: torch.Tensor,
                 y: torch.Tensor, carry=None,
                 compute_dtype: Optional[torch.dtype] = None,
                 lengths=None):
    """(loss, metric, new carry) of one batch: the metric is the accuracy
    (classify) or the perplexity (lm); a model with a BPTT carry takes and
    returns one, the others return the carry they were given (None). A
    classifier with aux heads (googlenet, inceptionv3) returns ``(logits,
    *aux)`` in training: the loss is ``CE(logits) + AUX_WEIGHT * sum
    CE(aux)``, each in float32, and the accuracy reads the main logits.
    A ctc model takes ``lengths`` = (input lengths, label lengths): its loss
    is the batch mean of ``ctc_loss``, and it has no metric beside it (0)."""
    if task == "ctc":
        input_lengths, label_lengths = lengths
        logits, out_lengths = model_forward(model, x, input_lengths,
                                            compute_dtype)
        loss = ctc_loss(logits, out_lengths, y, label_lengths).mean()
        return loss, torch.zeros((), device=loss.device), carry
    out = model_forward(model, x, carry, compute_dtype)
    if carry is not None:
        logits, carry = out
    else:
        logits = out
    aux = ()
    if isinstance(logits, tuple):
        logits, *aux = logits
    loss = cross_entropy(logits, y)
    for a in aux:
        loss = loss + AUX_WEIGHT * cross_entropy(a, y)
    with torch.no_grad():
        if task == "lm":
            metric = torch.exp(loss.detach())
        else:
            metric = (logits.argmax(-1) == y).float().mean()
    return loss, metric, carry


def flatten_buffers(module: nn.Module) -> Optional[torch.Tensor]:
    """Re-seat every floating buffer of ``module`` as a view of one flat
    tensor and return it (None when there are none). In-place updates of
    the buffers then land in the flat tensor; ``load_state_dict`` copies
    into the views. Moving the module afterwards (``.to``) would replace
    the views, so call this once the module is on its device."""
    owners = [
        (mod, name, buf)
        for mod in module.modules()
        for name, buf in mod.named_buffers(recurse=False)
        if buf.is_floating_point()
    ]
    if not owners:
        return None
    flat = torch.cat([buf.reshape(-1) for _, _, buf in owners])
    off = 0
    for mod, name, buf in owners:
        mod._buffers[name] = flat[off:off + buf.numel()].view_as(buf)
        off += buf.numel()
    return flat


# the trainer recognises (and strips) the health statistics in a step's
# metrics by this prefix, as the JAX trainer does
HEALTH_PREFIX = "health/"


def health_keys(num_groups: int, compression: bool = False) -> list[str]:
    """The metric names of a health vector, in its order: the global norm,
    one norm per merge group, the update ratio and, with a sparsifying
    compressor, one compression error per merge group."""
    return ([f"{HEALTH_PREFIX}grad_norm"]
            + [f"{HEALTH_PREFIX}gnorm_g{gi:04d}" for gi in range(num_groups)]
            + [f"{HEALTH_PREFIX}update_ratio"]
            + ([f"{HEALTH_PREFIX}comp_err_g{gi:04d}"
                for gi in range(num_groups)] if compression else []))


def leaf_norms(tensors) -> torch.Tensor:
    """Each tensor's L2 norm as one float32 vector, accumulated in float32
    (float64 tensors in float64): the multi-tensor kernel, not a handful
    of launches per leaf. The ``dtype`` argument is passed only for 16-bit
    tensors: with it, float32 lists leave the fused path for one
    reduction per tensor."""
    tensors = list(tensors)
    if all(t.dtype in (torch.float32, torch.float64) for t in tensors):
        norms = torch._foreach_norm(tensors, 2)
    else:
        norms = torch._foreach_norm(tensors, 2, dtype=torch.float32)
    return torch.stack(norms).float()


# the range the step declares for the guard's count, which the schedule
# verifier's SCH008 reads (``analysis.schedule_check``)
FINITE_CHECK_SCOPE = "finite_check"


def nonfinite_count(tensors) -> torch.Tensor:
    """Number of non-finite elements over ``tensors``, as a float32 scalar
    (one concatenation and one count, not a handful of kernels per leaf),
    in the ``finite_check`` range."""
    with collective_scope(FINITE_CHECK_SCOPE):
        tensors = [t.reshape(-1) for t in tensors]
        if not tensors:
            return torch.zeros(())
        flat = torch.cat(tensors) if len(tensors) > 1 else tensors[0]
        return torch.count_nonzero(~torch.isfinite(flat)).float()


class TrainStep:
    """``step(x, y) -> metrics`` (classify, windowed lm), ``step(x, y,
    carry) -> (metrics, carry)`` (an lm with a BPTT carry) and ``step(x, y,
    lengths=(input_lengths, label_lengths)) -> metrics`` (ctc): x (n, B, C,
    H, W) images and y (n, B) labels, x and y (n, B, T) tokens, or x (n, B,
    T, F) spectrograms, y (n, B, L) labels and lengths (n, B) each, on the
    model's device, n = ``nsteps_update`` micro-batches. ``task`` is the
    model's (``ModelMeta.task``): classify, lm or ctc. The metrics are
    0-dim device tensors: ``loss``, the task's metric, ``grads_nonfinite``
    and, with ``health_stats``, the ``health/`` statistics of this step."""

    METRICS = {"classify": "accuracy", "lm": "perplexity", "ctc": None}

    def __init__(
        self,
        model: nn.Module,
        optimizer: torch.optim.Optimizer,
        lr_fn: Callable[[int], float],
        *,
        reducer: Optional[MergedAllreduce] = None,
        nsteps_update: int = 1,
        grad_guard: bool = True,
        norm_clip: Optional[float] = None,
        task: str = "classify",
        compute_dtype: Optional[torch.dtype] = None,
        health_stats: bool = False,
        seq_group=None,
        group=None,
    ):
        # group: the process group the step's reductions span (the default
        # when None; the measuring tools time the first n ranks of a world
        # over a subgroup, which the reducer must span too)
        if seq_group is not None and not hasattr(model, "seq_group"):
            raise ValueError(
                "sequence parallelism is for windowed lm models; BPTT carry "
                "models shard only the data axis"
            )
        if task not in self.METRICS:
            raise ValueError(f"task must be one of {sorted(self.METRICS)}, "
                             f"got {task!r}")
        self.model = model
        self.task = task
        self.metric = self.METRICS[task]
        self.optimizer = optimizer
        self.reducer = reducer
        self.nsteps_update = int(nsteps_update)
        self.grad_guard = grad_guard
        self.norm_clip = norm_clip
        self.compute_dtype = compute_dtype
        self.seq_group = seq_group
        self.group = group
        self.world = (world_size() if group is None
                      else dist.get_world_size(group))
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.buffers = flatten_buffers(model)
        device = self.params[0].device if self.params else None
        # the optimizer updates applied (the schedule's count) are _base on
        # the host plus _pos on the device; _calls counts the steps since
        # _base, which bounds _pos and so the learning-rate table's extent
        self._base = 0
        self._pos = torch.zeros((), dtype=torch.int64, device=device)
        self._calls = 0
        self._lr_fn = lr_fn
        self._lr_table: Optional[torch.Tensor] = None
        # rs_opt_ag, rs_fwd_ag: the reducer runs the optimizer on its
        # shards; rs_fwd_ag carries the parameters as shards between steps
        self.sharded = reducer is not None and reducer.comm_op in SHARDED_OPS
        self.cross_step = (reducer is not None
                           and reducer.comm_op == "rs_fwd_ag")
        self.health_stats = bool(health_stats)
        self._compression = (self.health_stats and reducer is not None
                             and reducer.sparse)
        if self._compression:
            reducer.track_compression_error = True
        self.health_keys = health_keys(
            reducer.num_groups if reducer is not None else 0,
            self._compression)
        self._old_params: Optional[list[torch.Tensor]] = None
        self._old_shards: Optional[list[torch.Tensor]] = None
        self._group_matrix: Optional[torch.Tensor] = None

    # -- the step counter and the learning rate --------------------------
    @property
    def step(self) -> int:
        """Optimizer updates applied (the schedule's count, the JAX state's
        ``step``): a read of the device counter, so never inside a step."""
        return self._base + int(self._pos)

    @step.setter
    def step(self, value: int) -> None:
        self._base = int(value)
        self._pos.zero_()
        self._calls = 0
        self._lr_table = None

    @property
    def lr_fn(self) -> Callable[[int], float]:
        return self._lr_fn

    @lr_fn.setter
    def lr_fn(self, fn: Callable[[int], float]) -> None:
        self._lr_fn = fn
        self._lr_table = None

    def _lr(self) -> torch.Tensor:
        """``lr_fn(step)`` as a 0-dim float64 device tensor, with no host
        read of the counter: a device table of ``lr_fn(_base + i)`` indexed
        by ``_pos``. The counter is at most the steps taken since ``_base``,
        so the table covers it once it holds one entry more than those; it
        is rebuilt at twice the length when it does not (the upload from
        pinned memory does not wait for the device)."""
        table = self._lr_table
        if table is None or self._calls >= table.numel():
            n = max(256, self._calls + 1,
                    2 * table.numel() if table is not None else 0)
            host = torch.tensor([float(self._lr_fn(self._base + i))
                                 for i in range(n)], dtype=torch.float64)
            if self._pos.device.type == "cuda":
                host = host.pin_memory()
            table = self._lr_table = host.to(self._pos.device,
                                             non_blocking=True)
        return table.index_select(0, self._pos.reshape(1)).reshape(())

    def __call__(self, x: torch.Tensor, y: torch.Tensor, carry=None,
                 lengths=None):
        if (lengths is None) != (self.task != "ctc"):
            raise ValueError("a ctc step takes lengths=(input_lengths, "
                             "label_lengths); the other tasks take none")
        n = self.nsteps_update
        if x.shape[0] != n or y.shape[0] != n:
            raise ValueError(
                f"expected {n} micro-batches, got x {tuple(x.shape)}, "
                f"y {tuple(y.shape)}"
            )
        model, reducer = self.model, self.reducer
        guard = self.grad_guard
        model.train()
        snapshot = (
            self.buffers.clone()
            if guard and self.buffers is not None else None
        )
        carry_in = carry
        for p in self.params:
            p.grad = None
        if self.cross_step:
            reducer.gather_params()
            if self.compute_dtype is not None:
                reducer.finish_gather()
        elif self.health_stats:
            self._snapshot_params()
        loss_sum = torch.zeros((), device=x.device)
        metric_sum = torch.zeros((), device=x.device)
        for i in range(n):
            if reducer is not None:
                reducer.begin(active=i == n - 1, scale=1.0 / n)
            loss, metric, carry = forward_loss(
                model, self.task, x[i], y[i], carry, self.compute_dtype,
                lengths=None if lengths is None
                else (lengths[0][i], lengths[1][i]),
            )
            if self.cross_step:
                # a group no module's pre-hook consumed lands here
                reducer.finish_gather()
            loss.backward()
            if carry is not None:
                carry = repackage_carry(carry)
            with torch.no_grad():
                loss_sum += loss.detach()
                metric_sum += metric
        if self.sharded:
            reduced = [p.grad for p in self.params]  # local, never reduced
        elif reducer is not None:
            reduced = reducer.synchronize()
        else:
            grads = [p.grad for p in self.params]
            if n > 1:
                torch._foreach_mul_(grads, 1.0 / n)
            if self.world > 1:
                with collective_scope("flat_grad_reduce"):
                    for g in grads:  # one flat mean per leaf, no hooks
                        dist.all_reduce(g, group=self.group)
                        g.div_(self.world)
            # with the guard, the gradients become views of flat buffers
            # (one per dtype): one count and one zeroing each
            reduced = self._flatten_grads() if guard else grads
        metrics = torch.stack([
            loss_sum / n, metric_sum / n,
            nonfinite_count(reduced) if guard
            else torch.zeros((), device=x.device),
        ])
        # health values that differ per rank ride the metrics' mean: the
        # local gradient norms of the sharded path, the compression errors
        local = []
        if self.health_stats and self.sharded:
            # .grad holds the micro-steps' sum; the statistics describe
            # their mean, as the reduced path's do
            local.append(self._grad_norms() / n)
        if self._compression:
            local.append(torch.stack(reducer.compression_errors).float())
        if local:
            metrics = torch.cat([metrics, *(t.to(metrics.dtype) for t in local)])
        if self.world > 1:
            with collective_scope("metrics_reduce"):
                dist.all_reduce(metrics, group=self.group)
            metrics.div_(self.world)
        norms = comp = None
        if self.health_stats:
            ng = 1 + (self.reducer.num_groups if self.reducer is not None
                      else 0)  # the global norm and one per group
            norms = metrics[3:3 + ng] if self.sharded else self._grad_norms()
            if self._compression:
                comp = metrics[metrics.shape[0] - self.reducer.num_groups:]
        metrics = metrics[:3]
        # the guard, on the device: the count is the ranks' mean, so every
        # rank selects alike
        ok = metrics[2] == 0 if guard else None
        lr = self._lr()
        old_shards = None
        if self.cross_step:
            if norms is not None:
                old_shards = self._snapshot_shards()
            reducer.reduce_and_defer(lr=lr, ok=ok)
        elif self.sharded:
            reducer.reduce_and_update(lr=lr, ok=ok)
        else:
            if ok is not None:
                # a bad step's gradients become zeros: the masked update
                # then keeps every value exactly
                with torch.no_grad():
                    for buf in reduced:
                        buf.masked_fill_(~ok, 0.0)
            if self.norm_clip is not None:
                clip_by_global_norm_([p.grad for p in self.params],
                                     self.norm_clip)
            sgd_update_(self.optimizer, lr, ok)
        self._pos.add_(1 if ok is None else ok)
        self._calls += 1
        if self.world > 1 and self.buffers is not None:
            with collective_scope("bstats_reduce"):
                dist.all_reduce(self.buffers, group=self.group)
            self.buffers.div_(self.world)
        if ok is not None:
            # a skipped step never happened: the forward's running
            # statistics and the carry go back too
            if snapshot is not None:
                torch.where(ok, self.buffers, snapshot, out=self.buffers)
            if carry is not None:
                carry = _select(ok, carry, carry_in)
        vec = metrics
        if norms is not None:
            vec = torch.cat([vec, self._health_vector(
                norms, ok, comp, old_shards).to(vec.dtype)])
        for p in self.params:
            p.grad = None
        names = (["loss", self.metric, "grads_nonfinite"]
                 + (self.health_keys if norms is not None else []))
        out = {k: v for k, v in zip(names, vec.unbind()) if k is not None}
        if carry_in is None:
            return out
        return out, carry

    def _flatten_grads(self) -> list[torch.Tensor]:
        """The gradients concatenated into one flat tensor per dtype, each
        ``.grad`` re-seated as a view of it; returns the flat tensors."""
        flats = []
        params = [p for p in self.params if p.grad is not None]
        for dtype in dict.fromkeys(p.dtype for p in params):
            ps = [p for p in params if p.dtype == dtype]
            flat = torch.cat([p.grad.reshape(-1) for p in ps])
            for p, v in zip(ps, flat.split([p.numel() for p in ps])):
                p.grad = v.view_as(p)
            flats.append(flat)
        return flats

    # -- health statistics ---------------------------------------------
    def _snapshot_params(self) -> None:
        """Copy the parameters into the preallocated snapshot (the update
        ratio's old side)."""
        with torch.no_grad():
            if self._old_params is None:
                self._old_params = [torch.empty_like(p) for p in self.params]
            torch._foreach_copy_(self._old_params, self.params)

    def _snapshot_shards(self) -> list[torch.Tensor]:
        """rs_fwd_ag: copy the carried shards, which the update overwrites
        in place, into the preallocated snapshot (the ratio's old side)."""
        with torch.no_grad():
            shards = self.reducer.param_shards
            if self._old_shards is None:
                self._old_shards = [torch.empty_like(s) for s in shards]
            torch._foreach_copy_(self._old_shards, shards)
            return self._old_shards

    def _grad_norms(self) -> torch.Tensor:
        """[global, per group...] L2 norms of the gradients in ``.grad``
        (float32, on the device): the reduced ones, or the local ones on
        the sharded path."""
        with torch.no_grad():
            reducer = self.reducer
            if reducer is None:
                sq = leaf_norms([p.grad for p in self.params]).square()
                return sq.sum().reshape(1).sqrt()
            arr = reducer.arrival_params
            sq = leaf_norms([p.grad for p in arr]).square()
            if self._group_matrix is None:
                # (groups, leaves) membership: one deterministic product
                # sums every group (index_add_ has no deterministic CUDA
                # kernel)
                m = torch.zeros(reducer.num_groups, len(arr))
                m[reducer.group_of, range(len(arr))] = 1.0
                self._group_matrix = m.to(sq.device)
            return torch.cat([sq.sum().reshape(1),
                              self._group_matrix @ sq]).sqrt()

    def _health_vector(self, norms: torch.Tensor,
                       ok: Optional[torch.Tensor],
                       comp: Optional[torch.Tensor] = None,
                       old_shards: Optional[list] = None) -> torch.Tensor:
        """[grad_norm, group norms..., update_ratio, compression errors...]
        of this step (on rs_fwd_ag the ratio from ``old_shards`` and the
        carried ones); the ratio is NaN where ``ok`` says the step was
        skipped."""
        with torch.no_grad():
            if old_shards is not None:
                new = self.reducer.param_shards
                sq = torch.stack([
                    leaf_norms(old_shards).square().sum(),
                    leaf_norms(torch._foreach_sub(new, old_shards))
                    .square().sum()])
                if self.world > 1:
                    with collective_scope("metrics_reduce"):
                        dist.all_reduce(sq, group=self.reducer.group)
                pnorm, unorm = sq.sqrt().unbind()
            else:
                pnorm = leaf_norms(self._old_params).square().sum().sqrt()
                torch._foreach_sub_(self._old_params, self.params)
                unorm = leaf_norms(self._old_params).square().sum().sqrt()
            ratio = (unorm / pnorm.clamp_min(1e-12)).reshape(1)
            if ok is not None:
                ratio = torch.where(ok, ratio, float("nan"))
            return torch.cat([norms, ratio]
                             + ([comp] if comp is not None else []))


def _select(ok: torch.Tensor, new, old):
    """``torch.where(ok, new, old)`` over a (nested) tuple of tensors."""
    if isinstance(new, (tuple, list)):
        return type(new)(_select(ok, a, b) for a, b in zip(new, old))
    return torch.where(ok, new, old)


@torch.no_grad()
def eval_sums(model: nn.Module, x: torch.Tensor, y: torch.Tensor,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[loss, top1, top5, count] summed over one eval batch (the JAX eval
    step's classify sums; every sample counts), the forward at the compute
    dtype."""
    logits = model_forward(model, x, None, compute_dtype).float()
    y = y.long()
    per = F.cross_entropy(logits, y, reduction="none")
    top1 = (logits.argmax(-1) == y).float()
    k = min(5, logits.shape[-1])
    top5 = (logits.topk(k, dim=-1).indices == y[:, None]).any(-1).float()
    return torch.stack([
        per.sum(), top1.sum(), top5.sum(),
        torch.tensor(float(y.shape[0]), device=logits.device),
    ])


@torch.no_grad()
def lm_eval_sums(model: nn.Module, x: torch.Tensor, y: torch.Tensor,
                 carry=None, compute_dtype: Optional[torch.dtype] = None):
    """([loss, count] summed over one eval batch, new carry): each sample's
    loss is its mean token loss (the JAX eval step's lm sums); a model
    with a BPTT carry takes and returns one. On a seq ring each rank sums
    its time slice's means, so summed over the world the count is S times
    the samples and loss / count the true mean token loss."""
    out = model_forward(model, x, carry, compute_dtype)
    if carry is not None:
        logits, carry = out
    else:
        logits = out
    logits = logits.float()
    per_token = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long(),
        reduction="none",
    ).view(y.shape)
    per = per_token.mean(-1)
    return torch.stack([
        per.sum(), torch.tensor(float(y.shape[0]), device=logits.device),
    ]), carry


@torch.no_grad()
def ctc_eval_sums(model: nn.Module, x: torch.Tensor, y: torch.Tensor,
                  input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None):
    """([loss, count] summed over one eval batch, float32 logits, output
    lengths): the JAX eval step's ctc sums, with the decode inputs of the
    same forward, so WER needs no second pass."""
    logits, out_lengths = model_forward(model, x, input_lengths, compute_dtype)
    logits = logits.float()
    per = ctc_loss(logits, out_lengths, y, label_lengths)
    return torch.stack([
        per.sum(), torch.tensor(float(y.shape[0]), device=logits.device),
    ]), logits, out_lengths
