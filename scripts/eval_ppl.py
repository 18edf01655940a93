#!/usr/bin/env python
"""Perplexity evaluation CLI (ref: JLM:train/ PPL eval — SURVEY.md §3.1).

  python scripts/eval_ppl.py --data data/ --exp experiments/h512 [--split test]
"""

import argparse

from jlm.data.io import load_dataset
from jlm.train import load_checkpoint
from jlm.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--exp", required=True)
    ap.add_argument("--split", default="test", choices=["dev", "test"])
    args = ap.parse_args(argv)

    vocab, train, dev, test = load_dataset(args.data)
    params, cfg = load_checkpoint(args.exp)
    trainer = Trainer(cfg, params=params)
    ids = dev if args.split == "dev" else test
    ppl = trainer.evaluate_ppl(ids)
    print(f"{args.split}_ppl={ppl:.3f}")


if __name__ == "__main__":
    main()
