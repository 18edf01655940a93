#!/usr/bin/env python
"""Checkpoint → int8 inference-weight exporter CLI.

Rebuild of the reference's weight export + quantization step (ref:
JLM:decoder/ checkpoint→numpy converter + 8-bit quantizer — SURVEY.md
§5.3): reads a training checkpoint, quantizes per the weight spec
(symmetric int8, per-output-channel scales; embeddings per-row), and
writes an ``int8`` tagged checkpoint the decoders load directly.

  python scripts/export_int8.py --exp experiments/h512 [--tag int8]
"""

import argparse

import numpy as np

from jlm.ops.quant import quantize_params
from jlm.train import load_checkpoint, save_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", required=True)
    ap.add_argument("--src-tag", default="latest")
    ap.add_argument("--tag", default="int8")
    args = ap.parse_args(argv)

    params, config = load_checkpoint(args.exp, tag=args.src_tag)
    qp = quantize_params(params)
    path = save_checkpoint(args.exp, qp, config, tag=args.tag)

    f32 = sum(np.asarray(x).nbytes for x in _leaves(params))
    i8 = sum(np.asarray(x).nbytes for x in _leaves(qp))
    print(f"wrote {path}: {f32/1e6:.1f} MB fp32 -> {i8/1e6:.1f} MB int8 "
          f"({f32/i8:.2f}x smaller)")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
