"""Run the REAL-corpus retrieval quality campaign (eval/real_corpus.py):
recall@10 for hash / untrained / corpus-fine-tuned embedding providers on
the Python-stdlib-documentation corpus, ingested through the normal upload
path. Prints one JSON object; the README records the numbers.

Run: PYTHONPATH=. python -u tools/quality_real_corpus.py
(pass --steps N to change the fine-tune length; default 300)
"""

from __future__ import annotations

import argparse
import json


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    from omni_recall_tpu.eval.real_corpus import evaluate_real_corpus

    print(json.dumps(evaluate_real_corpus(steps=args.steps, seed=args.seed)))


if __name__ == "__main__":
    main()
