"""Batch scoring CLI (flag-compatible with ``druglamp_tpu.cli.predict``, plus
``--device``).

    python -m druglamp_tpu_torch.cli.predict --ckpt results/run --model DrugLAMPwoLLM \
        --input pairs.csv --output scores.csv [--device cuda|cpu]

Input CSV needs SMILES and Protein columns; output adds a `score` column.
The checkpoint is the port's own (``serve.save_checkpoint``).
"""

from __future__ import annotations

import argparse
import csv
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="DrugLAMP (PyTorch) batch inference")
    p.add_argument("--ckpt", required=True, help="work dir containing ckpt_best.pt")
    p.add_argument("--model", default="DrugLAMP")
    p.add_argument("--which", default="best", choices=["best", "last"])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from druglamp_tpu_torch.serve import Predictor

    with open(args.input) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        print("error: empty input", file=sys.stderr)
        return 2
    missing = {"SMILES", "Protein"} - set(rows[0].keys())
    if missing:
        print(f"error: input CSV missing column(s): {', '.join(sorted(missing))}",
              file=sys.stderr)
        return 2
    pairs = [(r["SMILES"], r["Protein"]) for r in rows]

    predictor = Predictor.from_checkpoint(args.ckpt, args.model, which=args.which,
                                          batch_size=args.batch_size, device=args.device)
    probs = predictor.predict_pairs(pairs)

    fieldnames = list(rows[0].keys()) + ["score"]
    with open(args.output, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        for row, s in zip(rows, probs):
            w.writerow({**row, "score": f"{float(s):.6f}"})
    print(f"scored {len(rows)} pairs -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
