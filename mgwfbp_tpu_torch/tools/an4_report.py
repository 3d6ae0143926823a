"""Fold an lstman4 ``train.log`` into a real-audio WER artifact.

The port's counterpart of the JAX package's ``tools/an4_report.py``, with
its flags, parsing and summary: the trainer's per-epoch eval lines (``epoch
N eval: loss L, count C, wer W``, which the port's trainer writes as the
JAX trainer does) become a WER trajectory, summarized and printed as one
JSON section; ``--save`` writes that section into the artifact under
``--key``. The artifact path is required (``--artifact``): the port keeps
its runs' records apart from the JAX package's
``profiles/an4_real_audio.json``, which this tool never writes.

The memorization run evaluates the TRAIN split (``data/an4_memcheck``'s val
manifest lists the 45 real train utterances), so a falling WER validates
the spectrogram -> CTC -> greedy decode -> WER path end to end on real
speech; a held-out number on the real val split can be appended with
``--val-wer`` once measured offline.

Usage:
  python -m mgwfbp_tpu_torch.tools.an4_report --log logs/.../train.log \\
      --label "card memorization run" --artifact runs/an4.json [--save]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys

# loss may be nan/inf on a diverged run, negative or in scientific notation
# on other configs: every such epoch must appear in the trajectory, not
# vanish because the number's spelling fell outside the pattern
_NUM = r"-?(?:[\d.]+(?:e-?\d+)?|nan|inf)"
_EVAL = re.compile(
    rf"epoch (\d+) eval: loss ({_NUM}), count {_NUM}, "
    rf"wer ({_NUM})"
)


def parse_log(path: str) -> list[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            m = _EVAL.search(line)
            if m:
                rows.append(
                    {
                        "epoch": int(m.group(1)),
                        "eval_loss": float(m.group(2)),
                        "wer": float(m.group(3)),
                    }
                )
    return rows


def summarize(rows: list[dict], stride: int = 10) -> dict:
    if not rows:
        raise SystemExit("no eval lines found in log")
    finite = [r for r in rows if math.isfinite(r["wer"])]
    if not finite:
        raise SystemExit("every eval row is non-finite (diverged run)")
    best = min(finite, key=lambda r: r["wer"])
    # thin the trajectory for the artifact (every `stride` epochs + first,
    # best and last; stride <= 0 keeps all) so the JSON stays reviewable
    keep = {0, rows[-1]["epoch"], best["epoch"]}
    keep.update(
        r["epoch"] for r in rows if stride <= 0 or r["epoch"] % stride == 0
    )
    return {
        # named for what the log proves: epochs whose EVAL line appears
        # (with eval-every-N configs this is not the trained-epoch count)
        "last_eval_epoch": rows[-1]["epoch"],
        "evals": len(rows),
        "diverged_evals": len(rows) - len(finite),
        "best_wer": best["wer"],
        "best_wer_epoch": best["epoch"],
        "final_wer": rows[-1]["wer"],
        "wer_below_1.0": best["wer"] < 1.0,
        "trajectory": [r for r in rows if r["epoch"] in keep],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--log", required=True)
    ap.add_argument("--label", required=True,
                    help="run description recorded in the artifact, e.g. "
                         "'card memorization run, lr 1e-3'")
    ap.add_argument("--artifact", required=True,
                    help="the JSON artifact whose --key section --save "
                         "writes (made if missing); the log is recorded "
                         "relative to its directory")
    ap.add_argument("--key", default="memorization_run",
                    help="artifact section to write")
    ap.add_argument("--val-wer", type=float, default=None,
                    help="held-out real-val WER measured offline")
    ap.add_argument("--stride", type=int, default=10)
    ap.add_argument("--save", action="store_true",
                    help="write into the artifact (default: print only)")
    args = ap.parse_args(argv)

    artifact = os.path.abspath(args.artifact)
    rows = parse_log(args.log)
    section = {
        "label": args.label,
        "log": os.path.relpath(args.log, os.path.dirname(artifact)),
        **summarize(rows, stride=args.stride),
    }
    if args.val_wer is not None:
        section["held_out_val_wer"] = args.val_wer
        section["held_out_caveat"] = (
            "real val split is only 8 utterances (archive tail lost); "
            "the memorization number is the mechanism check, this one is "
            "directional"
        )
    print(json.dumps(section, indent=2))
    if args.save:
        art = {}
        if os.path.exists(artifact):
            with open(artifact) as f:
                art = json.load(f)
        art[args.key] = section
        with open(artifact, "w") as f:
            json.dump(art, f, indent=1)
        print(f"updated {artifact}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
