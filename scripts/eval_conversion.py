#!/usr/bin/env python
"""Conversion-accuracy eval CLI (ref: JLM:decoder/ eval — SURVEY.md §5.5).

  python scripts/eval_conversion.py --data data/ --exp experiments/h512 \
      [--test-file pairs.tsv] [--int8]

The test file has ``kana<TAB>gold_display`` lines; defaults to the fixed
synthetic test set.
"""

import argparse

from jlm.data import generate_test_set
from jlm.data.io import load_dataset
from jlm.data.lexicon import Lexicon
from jlm.decoder.engine import BeamDecoder
from jlm.eval import evaluate_conversion
from jlm.ops.quant import quantize_params
from jlm.train import load_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--exp", required=True)
    ap.add_argument("--test-file", default=None)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--n-best", type=int, default=1,
                    help=">1 also reports n-best oracle accuracy")
    ap.add_argument("--n-test", type=int, default=50,
                    help="synthetic test-set size when no --test-file")
    args = ap.parse_args(argv)

    vocab, *_ = load_dataset(args.data)
    lexicon = Lexicon.from_vocab(vocab)
    params, cfg = load_checkpoint(args.exp)
    if args.int8:
        params = quantize_params(params)
    if args.test_file:
        with open(args.test_file) as f:
            tests = [tuple(l.rstrip("\n").split("\t")[:2]) for l in f if l.strip()]
    else:
        tests = generate_test_set(args.n_test, seed=777)
    if args.n_best > 1:
        cfg = cfg.replace(n_best_max=max(cfg.n_best_max, args.n_best))
    eng = BeamDecoder(params, lexicon, vocab, cfg)
    rep = evaluate_conversion(eng, tests, n_best=args.n_best)
    print(rep.summary())


if __name__ == "__main__":
    main()
