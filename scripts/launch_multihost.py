#!/usr/bin/env python
"""Multi-host SPMD launcher (BASELINE config 5; SURVEY.md §3.3).

One process per host, identical invocation everywhere (the MPI-equivalent
bootstrap the reference lacks):

  # on every host i of N:
  python scripts/launch_multihost.py --coordinator host0:8476 \
      --num-processes N --process-id i \
      --data data/ --exp experiments/h512-2l-100k --mesh-data 2 --mesh-vocab 4

After ``jax.distributed.initialize`` the global device set is visible on
every process; the (data, vocab) mesh spans hosts, the training step is the
same SPMD program as single-host (:class:`jlm.train.Trainer` with a
mesh), and XLA hands the collectives to NCCL: keep the vocab axis within
a host, where the cards are joined all to all by NVLink, and let the data
axis (no per-step traffic in decode; one gradient all-reduce per training
step) span hosts.  One process drives all the cards of its host.  Fails fast if the mesh does not match the global device count
(SURVEY.md §7 failure-detection minimum); crashed runs resume with
``--resume`` (checkpoints carry params + optimizer moments + epoch).
"""

import argparse

import jax


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True, help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--exp", required=True)
    ap.add_argument("--mesh-data", type=int, default=2)
    ap.add_argument("--mesh-vocab", type=int, default=4)
    ap.add_argument("--num-layers", type=int, default=2)
    ap.add_argument("--hidden-size", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    from jlm.parallel.mesh import multihost_init

    multihost_init(args.coordinator, args.num_processes, args.process_id)
    n_global = len(jax.devices())
    need = args.mesh_data * args.mesh_vocab
    assert n_global >= need, (
        f"mesh {args.mesh_data}x{args.mesh_vocab} needs {need} devices, "
        f"global set has {n_global} — aborting on all hosts"
    )

    from jlm.config import Config, pad_vocab_size
    from jlm.data.io import load_dataset
    from jlm.parallel.mesh import make_mesh
    from jlm.train import train_lm

    vocab, train, dev, _ = load_dataset(args.data)
    config = Config(
        vocab_size=pad_vocab_size(len(vocab), args.mesh_vocab),
        num_layers=args.num_layers,
        hidden_size=args.hidden_size,
        mesh_data=args.mesh_data,
        mesh_vocab=args.mesh_vocab,
        epochs=args.epochs,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        grad_accum_steps=args.grad_accum,
    )
    mesh = make_mesh(config)
    train_lm(config, train, dev, exp_dir=args.exp, resume=args.resume,
             mesh=mesh)


if __name__ == "__main__":
    main()
