"""Greedy-decode WER with TRAIN-mode batch statistics (memorization check).

The port's counterpart of the JAX package's ``tools/an4_trainmode_wer.py``,
with its flags and its JSON output, plus ``--device``.

DeepSpeech's sequence-wise batch norm normalizes over (B*T, H): on the
45-utterance salvage the per-batch statistics vary so strongly with the
padded-duration mix that the running averages match no batch, and a model
whose TRAIN-mode CTC loss is near 0 can still pin at a high eval loss. The
memorization check is about the spectrogram -> CTC -> decode -> WER path,
so this tool decodes each val batch under the statistics the model was
trained with: a train-mode forward whose batch-statistics update is thrown
away (the running buffers are put back after each batch; the model has no
dropout, so the forward is deterministic). At full-AN4 scale the running
averages converge and the ordinary eval path applies.

The checkpoint is the port's (or the JAX package's: the shard-native format
is shared); ``--checkpoint-dir`` is the run's tag directory.

Usage:
  python -m mgwfbp_tpu_torch.tools.an4_trainmode_wer \\
      --checkpoint-dir checkpoints/<tag> [--epoch N] \\
      [--data-dir data/an4_memcheck] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--data-dir", default="data/an4_memcheck")
    ap.add_argument("--epoch", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; an error without a card) or "
                         "cpu")
    args = ap.parse_args(argv)

    import tempfile

    import numpy as np
    import torch

    from mgwfbp_tpu_torch.checkpoint import Checkpointer
    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.convert import state_from_flax
    from mgwfbp_tpu_torch.data.audio import greedy_decode, ids_to_text, wer
    from mgwfbp_tpu_torch.train.step import model_forward
    from mgwfbp_tpu_torch.train.trainer import Trainer, batch_fields

    # make_config drops None overrides, so an explicit throwaway dir is
    # required: otherwise this tool appends its init lines to the default
    # preset's run log
    cfg = make_config(
        "lstman4", data_dir=args.data_dir,
        logdir=tempfile.mkdtemp(prefix="an4_trainmode_wer_"),
    )
    t = Trainer(cfg, device=args.device, profile_backward=False)
    ckpt = Checkpointer(args.checkpoint_dir)
    try:
        restored = ckpt.restore(t._template(), epoch=args.epoch)
        if restored is None:
            raise SystemExit(f"no checkpoint under {args.checkpoint_dir}")
        model = t.model
        with torch.no_grad():
            model.load_state_dict(state_from_flax(
                model, restored.state.params, restored.state.batch_stats),
                strict=True)
        saved = {k: v.clone() for k, v in model.named_buffers()}
        model.train()
        total, n = 0.0, 0
        hyps: list[dict] = []
        with torch.no_grad():
            for batch in t.bundle.val:
                x, ys, ilen, llen = batch_fields(batch)
                logits, out_lengths = model_forward(
                    model, torch.as_tensor(x).to(t.device),
                    torch.as_tensor(ilen).to(t.device), t.compute_dtype)
                for k, v in model.named_buffers():  # the update thrown away
                    v.copy_(saved[k])
                logits = logits.float().cpu().numpy()
                out_lengths = out_lengths.cpu().numpy()
                ys, llen = np.asarray(ys), np.asarray(llen)
                # the trainer's accounting (``_evaluate_ctc``): the loader
                # pads no sample, so every one counts
                for i, hyp in enumerate(greedy_decode(logits, out_lengths)):
                    ref = ids_to_text(ys[i, : int(llen[i])])
                    total += wer(hyp, ref)
                    n += 1
                    if llen[i] > 0 and len(hyps) < 5:
                        hyps.append({"ref": ref, "hyp": hyp})
    finally:
        ckpt.close()
        t.close()
    out = {
        "train_mode_wer": round(total / max(n, 1), 4),
        "utterances": n,
        "epoch": restored.epoch,
        "samples": hyps,
    }
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
