#!/usr/bin/env python
"""Import a reference (JLM-style) numpy weight export into an experiment dir.

The reference's pipeline exports trained TF variables as a plain numpy
dict (pickle or .npz — SURVEY.md §3.1 "Checkpoint→numpy exporter"); this
CLI re-keys such an export into the build's weight spec and writes a
standard experiment checkpoint the engine/eval tools load directly:

    python scripts/import_reference_weights.py \
        --export jlm_weights.pkl --exp exp/imported \
        --vocab-size 50000 --hidden 512 [--dsoftmax] [--int8]

After import, parity against the reference's own outputs follows from the
engine's oracle-parity discipline (the oracle and engine score any weight
set identically; tests/test_io_cli.py pins an import round trip).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--export", required=True,
                    help="reference weight export (.pkl or .npz)")
    ap.add_argument("--exp", required=True, help="output experiment dir")
    ap.add_argument("--vocab-size", type=int, default=50_000)
    ap.add_argument("--embed", type=int, default=256)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--dsoftmax", action="store_true")
    ap.add_argument("--int8", action="store_true",
                    help="also quantize the imported weights to int8")
    args = ap.parse_args(argv)

    from jlm.config import Config, default_dsoftmax_blocks
    from jlm.train.checkpoint import save_checkpoint
    from jlm.train.import_reference import (
        import_reference_weights,
        load_export,
    )

    cfg = Config(
        vocab_size=args.vocab_size, embed_size=args.embed,
        hidden_size=args.hidden, num_layers=args.layers,
        head="dsoftmax" if args.dsoftmax else "full",
        dsoftmax=default_dsoftmax_blocks(args.vocab_size, args.hidden)
        if args.dsoftmax else None,
    )
    export = load_export(args.export)
    params, mapping = import_reference_weights(export, cfg)
    if args.int8:
        from jlm.ops.quant import quantize_params

        params = quantize_params(params)
        cfg = cfg.replace(quantize=True)
    path = save_checkpoint(args.exp, params, cfg)
    print(json.dumps({"checkpoint": path, "mapping": mapping}, indent=1),
          file=sys.stderr)
    print(path)


if __name__ == "__main__":
    main()
