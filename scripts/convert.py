#!/usr/bin/env python
"""Conversion CLI / interactive demo (ref: JLM:decoder/ __main__ demos).

  python scripts/convert.py --data data/ --exp experiments/h512 [--int8]
      [--kana きょうはいいてんき] [--n-best 3] [--incremental]

With no --kana, reads kana lines from stdin (interactive IME demo).
"""

import argparse
import sys

import jax

from jlm.data.io import load_dataset
from jlm.data.lexicon import Lexicon
from jlm.decoder.engine import BeamDecoder
from jlm.decoder.incremental import IncrementalDecoder
from jlm.ops.quant import quantize_params
from jlm.train import load_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--exp", required=True)
    ap.add_argument("--kana", default=None)
    ap.add_argument("--n-best", type=int, default=3)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--incremental", action="store_true")
    ap.add_argument("--beam-width", type=int, default=None)
    args = ap.parse_args(argv)

    vocab, *_ = load_dataset(args.data)
    lexicon = Lexicon.from_vocab(vocab)
    params, cfg = load_checkpoint(args.exp)
    if args.beam_width:
        cfg = cfg.replace(beam_width=args.beam_width)
    if args.n_best > cfg.n_best_max:
        cfg = cfg.replace(n_best_max=args.n_best)
    if args.int8:
        params = quantize_params(params)

    if args.incremental:
        dec = IncrementalDecoder(params, lexicon, vocab, cfg)

        def convert(kana):
            dec.reset()
            for ch in kana:
                res = dec.push(ch, n_best=args.n_best)
            return res
    else:
        eng = BeamDecoder(params, lexicon, vocab, cfg)

        def convert(kana):
            return eng.decode(kana, n_best=args.n_best)

    def emit(kana):
        for r in convert(kana):
            print(f"{r.surface}\t{r.score:.4f}")

    if args.kana:
        emit(args.kana)
    else:
        print("kana> ", end="", flush=True)
        for line in sys.stdin:
            kana = line.strip()
            if kana:
                emit(kana)
            print("kana> ", end="", flush=True)


if __name__ == "__main__":
    main()
