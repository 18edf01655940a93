#!/usr/bin/env python
"""Corpus prep CLI (ref: JLM:data/data.py — SURVEY.md §5.1).

Reads a ``display/reading/POS``-token corpus (or generates the synthetic
one), builds the frequency vocab, encodes, splits, and writes the data dir.

  python scripts/prepare_data.py --out data/ --vocab-size 50000 \
      [--corpus corpus.txt | --synthetic-sentences 50000]
"""

import argparse
import sys

from jlm.data import build_vocab, encode_corpus, generate_corpus, split_corpus
from jlm.data.io import save_dataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--corpus", default=None, help="corpus file, one sentence/line")
    ap.add_argument("--synthetic-sentences", type=int, default=50_000)
    ap.add_argument("--synthetic-seed", type=int, default=1234)
    ap.add_argument("--vocab-size", type=int, default=50_000)
    ap.add_argument("--dev-frac", type=float, default=0.05)
    ap.add_argument("--test-frac", type=float, default=0.05)
    ap.add_argument("--stream", action="store_true",
                    help="constant-memory prep: native C++ chunk encoder, "
                         "memory-mapped corpus.bin output (for corpora that "
                         "don't fit in RAM)")
    args = ap.parse_args(argv)

    if args.stream:
        assert args.corpus, "--stream requires --corpus (a file to stream)"
        from jlm.data.streaming import save_dataset_streamed

        vocab, n = save_dataset_streamed(
            args.out, args.corpus, args.vocab_size,
            args.dev_frac, args.test_frac,
        )
        print(f"wrote {args.out} (streamed): vocab={len(vocab)} ids={n}")
        return

    if args.corpus:
        with open(args.corpus) as f:
            lines = [l.rstrip("\n") for l in f]
    else:
        lines = generate_corpus(args.synthetic_sentences, args.synthetic_seed)
    vocab = build_vocab(lines, args.vocab_size)
    ids = encode_corpus(lines, vocab)
    train, dev, test = split_corpus(ids, args.dev_frac, args.test_frac)
    save_dataset(args.out, vocab, train, dev, test)
    print(
        f"wrote {args.out}: vocab={len(vocab)} train={len(train)} "
        f"dev={len(dev)} test={len(test)}"
    )


if __name__ == "__main__":
    main()
