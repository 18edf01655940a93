"""Optax trainer with truncated BPTT.

Rebuild of the reference's training loop (ref: JLM:train/train.py
``run_epoch`` — SURVEY.md §4.8, §5.2): epoch loop over BPTT windows
carrying LSTM state, gradient clipping by global norm, multiplicative lr
decay after a start epoch, per-epoch dev perplexity, checkpoints into a
per-experiment dir.

Differences from the TF 1.x reference: one jitted
``value_and_grad`` train step (no session), optax optimizer chain with
``inject_hyperparams`` for the decayed lr, and the whole window scanned on
device via :func:`jlm.models.lstm.forward_hidden`.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from jlm.config import Config
from jlm.data.reader import bptt_batches
from jlm.models.heads import full_softmax_loss, sampled_softmax_loss
from jlm.models.lstm import forward_hidden, initial_state
from jlm.models.params import init_params
from jlm.train.checkpoint import append_log, save_checkpoint


def make_optimizer(config: Config) -> optax.GradientTransformation:
    base = optax.adam if config.optimizer == "adam" else optax.sgd

    def build(learning_rate):
        tx = optax.chain(
            optax.clip_by_global_norm(config.max_grad_norm),
            base(learning_rate),
        )
        if config.grad_accum_steps > 1:
            # Accumulate k microbatch grads, then clip+update on their mean
            # (scales the effective batch without scaling per-step memory).
            tx = optax.MultiSteps(tx, every_k_schedule=config.grad_accum_steps)
        return tx

    return optax.inject_hyperparams(build)(learning_rate=config.learning_rate)


def cast_floats(tree: Any, dtype) -> Any:
    """Cast float leaves to ``dtype`` (int8 ``q`` leaves pass through)."""
    def cast(x):
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(dtype)
        return x
    return jax.tree.map(cast, tree)


def epoch_lr(config: Config, epoch: int, decay_start=None) -> float:
    """lr · decay^max(0, epoch − start): the reference's decay schedule.

    ``decay_start`` overrides ``config.lr_decay_start_epoch`` — the
    PPL-GATED schedule (``config.lr_decay_gate_ppl``) passes the epoch at
    which dev PPL first cleared the gate, so decay begins only after the
    run escapes its initial plateau (round 5: the topic-conditioned task
    has a long unigram plateau whose escape epoch varies by seed; fixed
    early decay traps late escapers at PPL ~15 while the escaped runs
    anneal to ~12.3)."""
    start = (config.lr_decay_start_epoch if decay_start is None
             else decay_start)
    k = max(0, epoch - start)
    return config.learning_rate * (config.lr_decay ** k)


class Trainer:
    """Single-device trainer; pass ``mesh`` to scale the same loop SPMD.

    With a ``(data, vocab)`` mesh the step swaps to
    :func:`jlm.parallel.train_step.make_sharded_train_step` (batch rows
    over ``data``, vocab-parallel CE over ``vocab``) — the epoch loop,
    checkpoints, lr schedule, and PPL eval are identical.
    """

    def __init__(
        self,
        config: Config,
        params: Optional[Any] = None,
        mesh: Optional[Any] = None,
    ):
        self.config = config
        self.params = params if params is not None else init_params(config)
        self.params = jax.tree.map(jnp.asarray, self.params)
        self.opt = make_optimizer(config)
        self.mesh = mesh
        if (
            mesh is not None
            and mesh.devices.size > 1
            and "seq" in mesh.axis_names
        ):
            # Time-block pipeline parallelism over a ('seq',) mesh: the
            # BPTT window's time axis shards across devices; (c, h) carries
            # ppermute between neighbors (SURVEY.md §7 long-context row).
            # Params stay replicated — the axis buys activation memory and
            # recurrence wall-clock, not parameter memory.
            from jlm.parallel.train_step import (
                make_seq_eval_step,
                make_seq_train_step,
            )

            self.opt_state = jax.jit(self.opt.init)(self.params)
            self._train_step = make_seq_train_step(
                mesh, config, self.opt, config.seq_microbatches
            )
            self._eval_step = make_seq_eval_step(
                mesh, config, config.seq_microbatches
            )
        elif mesh is not None and mesh.devices.size > 1:
            if (
                config.sampled_softmax_samples > 0
                and mesh.shape.get("vocab", 1) > 1
            ):
                # Construction-time check (the r2 version raised for ANY
                # mesh and only at runtime): sampled softmax now works
                # data-parallel — only vocab (tensor) sharding is
                # incompatible (the sampled candidate columns would live
                # on one shard).
                raise ValueError(
                    "sampled softmax is incompatible with vocab (tensor) "
                    "parallelism; use a data-only mesh (mesh_vocab=1) or "
                    "the default vocab-parallel full-softmax CE"
                )
            from jlm.parallel.train_step import (
                init_sharded_training,
                make_sharded_eval_step,
                make_sharded_train_step,
            )

            self.params, self.opt_state = init_sharded_training(
                self.params, config, mesh, self.opt
            )
            self._train_step = make_sharded_train_step(mesh, config, self.opt)
            self._eval_step = make_sharded_eval_step(mesh, config)
        else:
            self.opt_state = self.opt.init(self.params)
            self._train_step = jax.jit(self._train_step_fn)
            self._eval_step = jax.jit(self._eval_step_fn)

    # --- jitted bodies -------------------------------------------------
    def _forward(self, params, x, state):
        cfg = self.config
        if cfg.compute_dtype == "bfloat16":
            # Mixed precision: fp32 master params, bf16 forward; the cast's
            # transpose returns fp32 grads to the optimizer.
            state = jax.tree.map(lambda s: s.astype(jnp.bfloat16), state)
            hs, state = forward_hidden(cast_floats(params, jnp.bfloat16),
                                       cfg, x, state, remat=cfg.remat)
            return hs, jax.tree.map(lambda s: s.astype(jnp.float32), state)
        return forward_hidden(params, cfg, x, state, remat=cfg.remat)

    def _loss(self, params, x, y, state, rng):
        cfg = self.config
        hs, state = self._forward(params, x, state)
        bf16 = cfg.compute_dtype == "bfloat16"
        head_params = cast_floats(params, jnp.bfloat16) if bf16 else params
        if cfg.sampled_softmax_samples > 0:
            loss = sampled_softmax_loss(head_params, cfg, hs, y, rng)
        else:
            loss = full_softmax_loss(head_params, cfg, hs, y)
        return loss, state

    def _train_step_fn(self, params, opt_state, state, x, y, rng, lr):
        (loss, state), grads = jax.value_and_grad(self._loss, has_aux=True)(
            params, x, y, state, rng
        )
        opt_state.hyperparams["learning_rate"] = lr
        updates, opt_state = self.opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, state, loss

    def _eval_step_fn(self, params, state, x, y):
        hs, state = self._forward(params, x, state)
        return full_softmax_loss(params, self.config, hs, y), state

    # --- checkpoint/resume of the FULL training state -------------------
    # (params + optimizer moments + epoch counter; SURVEY.md §7
    # "Checkpoint / resume".)  Optimizer leaves are stored flat; the tree
    # structure is rebuilt from a fresh opt.init of the same config, so the
    # archive stays plain arrays (no pickled Python objects).
    def _feed(self, x, batch_axis: int = 0):
        """Host batch -> array the sharded step can consume.

        Single-process: plain ``jnp.asarray`` (jit reshards).  Multi-process
        SPMD: every process holds the SAME host batch (the corpus is
        replicated, `bptt_batches` is deterministic), so build a global
        array via ``make_array_from_callback`` with rows sharded over the
        ``data`` mesh axis — each process materializes only its
        locally-addressable shards.
        """
        if self.mesh is None or jax.process_count() == 1:
            return jnp.asarray(x)
        from jax.sharding import NamedSharding, PartitionSpec as P

        x = np.asarray(x)
        if "data" in self.mesh.axis_names:
            spec = [None] * x.ndim
            spec[batch_axis] = "data"
            sh = NamedSharding(self.mesh, P(*spec))
        else:
            sh = NamedSharding(self.mesh, P())
        return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])

    @staticmethod
    def _to_host(x):
        """Fetch an array to host numpy; allgathers multi-host shards."""
        if hasattr(x, "is_fully_addressable") and not x.is_fully_addressable:
            from jax.experimental import multihost_utils

            x = multihost_utils.process_allgather(x, tiled=True)
        return np.asarray(x)

    def save_state(self, exp_dir: str, epoch: int) -> str:
        """Checkpoint params+optimizer+epoch.

        Call on EVERY process (the multi-host allgather is collective);
        only process 0 touches the filesystem.
        """
        import os

        host_params = jax.tree.map(self._to_host, self.params)
        leaves = [self._to_host(x) for x in jax.tree.leaves(self.opt_state)]
        if jax.process_index() != 0:
            return ""
        os.makedirs(exp_dir, exist_ok=True)
        save_checkpoint(exp_dir, host_params, self.config, tag="latest")
        path = os.path.join(exp_dir, "opt_state.npz")
        np.savez(path, epoch=np.int64(epoch),
                 **{f"leaf{i}": l for i, l in enumerate(leaves)})
        return path

    def load_state(self, exp_dir: str) -> int:
        """Restore params + optimizer state; returns the next epoch index.

        In sharded mode the restored leaves are re-placed onto the mesh with
        the same shardings a fresh :func:`init_sharded_training` would give
        them, so a run can resume on a different host/mesh topology as long
        as the mesh axis sizes still divide the vocab.
        """
        import os

        from jlm.train.checkpoint import load_checkpoint

        params, _ = load_checkpoint(exp_dir, tag="latest")
        self.params = jax.tree.map(jnp.asarray, params)
        if self.mesh is not None and self.mesh.devices.size > 1:
            from jlm.parallel.sharded_head import shard_params

            self.params = shard_params(self.params, self.config, self.mesh)
        path = os.path.join(exp_dir, "opt_state.npz")
        if not os.path.exists(path):
            self.opt_state = jax.jit(self.opt.init)(self.params)
            return 0
        with np.load(path) as z:
            leaves = [z[f"leaf{i}"] for i in range(len(z.files) - 1)]
            epoch = int(z["epoch"])
        template = jax.jit(self.opt.init)(self.params)
        tleaves, treedef = jax.tree.flatten(template)

        def put(l, t):
            if self.mesh is not None and self.mesh.devices.size > 1:
                from jax.sharding import NamedSharding, PartitionSpec
                s = getattr(t, "sharding", None)
                if not isinstance(s, NamedSharding):
                    # scalar counters etc.: replicate over the whole mesh so
                    # every step input spans the same device set
                    s = NamedSharding(self.mesh, PartitionSpec())
                return jax.device_put(l, s)
            return jnp.asarray(l)

        self.opt_state = jax.tree.unflatten(
            treedef, [put(l, t) for l, t in zip(leaves, tleaves)]
        )
        return epoch + 1

    # --- loops ---------------------------------------------------------
    def run_epoch(self, ids: np.ndarray, epoch: int, rng: jax.Array,
                  decay_start=None) -> float:
        cfg = self.config
        state = initial_state(cfg, cfg.batch_size)
        lr = jnp.float32(epoch_lr(cfg, epoch, decay_start))
        state = jax.tree.map(lambda s: self._feed(np.asarray(s), 1), state)
        # Loss accumulates ON DEVICE and is fetched ONCE per epoch:
        # `float(loss)` per step forces a sync device->host round trip,
        # which would serialize the whole epoch on host latency.
        total, n = None, 0
        for x, y in bptt_batches(ids, cfg.batch_size, cfg.num_steps):
            rng, sub = jax.random.split(rng)
            self.params, self.opt_state, state, loss = self._train_step(
                self.params, self.opt_state, state, self._feed(x),
                self._feed(y), sub, lr,
            )
            contrib = loss * jnp.float32(x.size)
            total = contrib if total is None else total + contrib
            n += x.size
        if total is None:
            return float("nan")
        return float(np.exp(self._to_host(total) / max(1, n)))

    def evaluate_ppl(self, ids: np.ndarray) -> float:
        """Dev/test perplexity with the full-softmax objective.

        Always full softmax (sampled softmax is a training-only
        approximation), matching the reference's eval pass [SURVEY.md §3.1
        "PPL evaluator"].
        """
        cfg = self.config
        state = initial_state(cfg, cfg.batch_size)
        state = jax.tree.map(lambda s: self._feed(np.asarray(s), 1), state)
        total, n = None, 0  # device-side accumulation (see run_epoch)
        for x, y in bptt_batches(ids, cfg.batch_size, cfg.num_steps):
            loss, state = self._eval_step(
                self.params, state, self._feed(x), self._feed(y)
            )
            contrib = loss * jnp.float32(x.size)
            total = contrib if total is None else total + contrib
            n += x.size
        if total is None:
            return float("nan")
        return float(np.exp(self._to_host(total) / max(1, n)))


def train_lm(
    config: Config,
    train_ids: np.ndarray,
    dev_ids: np.ndarray,
    exp_dir: Optional[str] = None,
    log: bool = True,
    resume: bool = False,
    mesh: Optional[Any] = None,
    save_every: int = 1,
) -> Tuple[Any, List[Dict[str, float]]]:
    """Full training run; returns (params, per-epoch history).

    ``resume=True`` restores params + optimizer state + epoch counter from
    ``exp_dir`` and continues (a crashed run re-enters at the next epoch).
    ``mesh`` switches the step to the sharded SPMD program (same loop).
    ``save_every``: checkpoint every N epochs (plus always the final one)
    — at flagship dims a full state save fetches ~570 MB of params +
    optimizer moments to the host.
    """
    trainer = Trainer(config, mesh=mesh)
    start_epoch = 0
    if resume and exp_dir:
        start_epoch = trainer.load_state(exp_dir)
        if log and start_epoch:
            print(f"resumed {exp_dir} at epoch {start_epoch}")
    rng = jax.random.key(config.seed)
    history: List[Dict[str, float]] = []
    # PPL-gated decay: hold full lr until dev PPL clears the gate, then
    # anneal from the NEXT epoch.  On resume, recover the recorded gate
    # epoch from the experiment log.
    gate = float(getattr(config, "lr_decay_gate_ppl", 0.0) or 0.0)
    decay_start = None
    if gate > 0:
        # lr_decay_start_epoch acts as the FALLBACK (latest) start when the
        # gate is enabled: hold full lr until dev PPL clears the gate, but
        # never past the fallback epoch (a run that never escapes must
        # still anneal rather than thrash at full lr forever).
        decay_start = config.lr_decay_start_epoch
        if resume and exp_dir:
            log_path = os.path.join(exp_dir, "log.jsonl")
            if os.path.exists(log_path):
                import json as _json
                with open(log_path) as f:
                    for line in f:
                        r = _json.loads(line)
                        if "decay_start" in r:
                            decay_start = min(decay_start,
                                              int(r["decay_start"]))
    for epoch in range(start_epoch, config.epochs):
        rng, sub = jax.random.split(rng)
        t0 = time.time()
        train_ppl = trainer.run_epoch(train_ids, epoch, sub, decay_start)
        dev_ppl = trainer.evaluate_ppl(dev_ids)
        rec = {
            "epoch": epoch,
            "lr": epoch_lr(config, epoch, decay_start),
            "train_ppl": train_ppl,
            "dev_ppl": dev_ppl,
            "seconds": time.time() - t0,
        }
        if gate > 0 and dev_ppl < gate and epoch + 1 < decay_start:
            decay_start = epoch + 1
        if gate > 0:
            rec["decay_start"] = decay_start
        history.append(rec)
        if log and jax.process_index() == 0:
            print(
                f"epoch {epoch}: train_ppl={train_ppl:.2f} "
                f"dev_ppl={dev_ppl:.2f} lr={rec['lr']:.4g} "
                f"({rec['seconds']:.1f}s)"
            )
        if exp_dir:
            if jax.process_index() == 0:
                append_log(exp_dir, rec)
            if (epoch + 1) % max(1, save_every) == 0 or (
                epoch + 1 == config.epochs
            ):
                trainer.save_state(exp_dir, epoch)
    return trainer.params, history
