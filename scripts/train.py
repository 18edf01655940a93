#!/usr/bin/env python
"""Training CLI (ref: JLM:train/train.py — SURVEY.md §5.2).

  python scripts/train.py --data data/ --exp experiments/h512-v50k \
      --hidden-size 512 --epochs 8 [--sampled-softmax 1024] [--dsoftmax] \
      [--mesh-data 2 --mesh-vocab 4] [--bf16] [--grad-accum 4] [--resume]

With ``--mesh-data``/``--mesh-vocab`` the same epoch loop runs the sharded
SPMD step (batch rows over ``data``, vocab-parallel CE over ``vocab``) on
however many local devices the mesh needs; combine with
``scripts/launch_multihost.py`` for multi-host runs.
"""

import argparse

from jlm.config import Config, default_dsoftmax_blocks, pad_vocab_size
from jlm.data.io import load_dataset
from jlm.train import train_lm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--exp", required=True, help="experiment output dir")
    ap.add_argument("--embed-size", type=int, default=256)
    ap.add_argument("--hidden-size", type=int, default=512)
    ap.add_argument("--num-layers", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-steps", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--lr-decay", type=float, default=0.8)
    ap.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    ap.add_argument("--sampled-softmax", type=int, default=0)
    ap.add_argument("--dsoftmax", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="data-parallel axis size (sharded step if product>1)")
    ap.add_argument("--mesh-vocab", type=int, default=1,
                    help="vocab (tensor) parallel axis size")
    ap.add_argument("--mesh-seq", type=int, default=1,
                    help="sequence/time-block pipeline axis size (the BPTT "
                         "window's time axis shards across devices; "
                         "exclusive with --mesh-data/--mesh-vocab)")
    ap.add_argument("--seq-microbatches", type=int, default=0,
                    help="pipeline streams per step (0 = auto ~2x mesh-seq)")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 forward/backward with fp32 master params")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches accumulated per optimizer update")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize LSTM activations in backprop "
                         "(fit longer BPTT windows / larger batches)")
    ap.add_argument("--model-vocab", type=int, default=0,
                    help="force the model's (padded) vocab size above the "
                         "data vocab — BASELINE config 5 trains a 100k head "
                         "even when the corpus lexicon is smaller; extra ids "
                         "are dead classes (never targets)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --exp")
    args = ap.parse_args(argv)

    vocab, train, dev, _ = load_dataset(args.data)
    # Pad the model vocab so each vocab shard is equal-sized; padded ids
    # are dead classes (never appear as targets or lattice candidates).
    v_model = pad_vocab_size(max(len(vocab), args.model_vocab),
                             args.mesh_vocab)
    cfg = Config(
        vocab_size=v_model,
        embed_size=args.embed_size,
        hidden_size=args.hidden_size,
        num_layers=args.num_layers,
        batch_size=args.batch_size,
        num_steps=args.num_steps,
        epochs=args.epochs,
        optimizer=args.optimizer,
        learning_rate=args.lr,
        lr_decay=args.lr_decay,
        sampled_softmax_samples=args.sampled_softmax,
        head="dsoftmax" if args.dsoftmax else "full",
        dsoftmax=(
            default_dsoftmax_blocks(v_model, args.hidden_size,
                                    multiple=args.mesh_vocab)
            if args.dsoftmax
            else None
        ),
        seed=args.seed,
        mesh_data=args.mesh_data,
        mesh_vocab=args.mesh_vocab,
        mesh_seq=args.mesh_seq,
        seq_microbatches=args.seq_microbatches,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        grad_accum_steps=args.grad_accum,
        remat=args.remat,
    )
    mesh = None
    if cfg.mesh_seq > 1:
        assert cfg.mesh_data * cfg.mesh_vocab == 1, (
            "--mesh-seq is exclusive with --mesh-data/--mesh-vocab"
        )
        assert cfg.num_steps % cfg.mesh_seq == 0, (
            "--num-steps must divide by --mesh-seq (time blocks)"
        )
        from jlm.parallel.mesh import make_seq_mesh

        mesh = make_seq_mesh(cfg)
    elif cfg.mesh_data * cfg.mesh_vocab > 1:
        from jlm.parallel.mesh import make_mesh

        mesh = make_mesh(cfg)
    train_lm(cfg, train, dev, exp_dir=args.exp, resume=args.resume, mesh=mesh)


if __name__ == "__main__":
    main()
