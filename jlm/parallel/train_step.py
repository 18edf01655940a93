"""Sharded training step over a (data, vocab) mesh.

The full SPMD training step for multi-chip/multi-host runs (SURVEY.md §3.3,
BASELINE config 5): batch rows sharded over ``data``, output head sharded
over ``vocab`` (the vocab-parallel CE of
:mod:`jlm.parallel.sharded_head`), LSTM/embedding replicated.  The same
program runs on any mesh shape — 1 card, 1 host, N hosts — with XLA
handing the collectives to NCCL.

The step signature mirrors the single-device :class:`jlm.train.Trainer`
step (``rng``/``lr`` threaded through) so :class:`Trainer` can swap it in
behind the same epoch loop; ``lr`` lands in ``opt_state.hyperparams`` when
the optimizer was built with ``optax.inject_hyperparams`` (the reference's
per-epoch lr decay, SURVEY.md §4.8).
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from jlm.config import Config
from jlm.models.lstm import forward_hidden
from jlm.parallel.mesh import DATA_AXIS
from jlm.parallel.sharded_head import (
    shard_params,
    vocab_parallel_nll,
)


def _cast_floats(tree: Any, dtype) -> Any:
    """Cast float leaves (incl. int8-quant scales untouched) to ``dtype``."""
    def cast(x):
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(dtype)
        return x
    return jax.tree.map(cast, tree)


def _make_loss_fn(mesh: jax.sharding.Mesh, config: Config, precision: str,
                  force_full: bool = False):
    sampled = config.sampled_softmax_samples > 0 and not force_full
    if sampled:
        # Data-parallel sampled softmax (VERDICT r2 weak #7): with the
        # vocab axis trivial, the head is replicated and the sampled loss
        # is plain jnp — GSPMD row-shards ``hs`` over ``data`` and the
        # global mean falls out of the unsharded reduction.  The candidate
        # set is drawn from the REPLICATED rng, so every shard shares the
        # same negatives (the estimator stays exactly the single-device
        # one on the global batch).
        from jlm.models.heads import sampled_softmax_loss
        assert mesh.shape.get("vocab", 1) == 1, (
            "sampled softmax is incompatible with vocab (tensor) "
            "parallelism — the sampled candidate columns live on one "
            "shard; use full-softmax vocab-parallel CE (the default) or "
            "a data-only mesh"
        )
    else:
        loss_head = vocab_parallel_nll(mesh, config, precision)
    bf16 = config.compute_dtype == "bfloat16"

    def loss_fn(params, state, x, y, rng=None):
        fparams = _cast_floats(params, jnp.bfloat16) if bf16 else params
        if bf16:
            state = jax.tree.map(lambda s: s.astype(jnp.bfloat16), state)
        hs, new_state = forward_hidden(fparams, config, x, state, precision,
                                       remat=config.remat)
        new_state = jax.tree.map(lambda s: s.astype(jnp.float32), new_state)
        if sampled:
            return sampled_softmax_loss(fparams, config, hs, y, rng), new_state
        return loss_head(fparams, hs, y), new_state

    return loss_fn


def make_sharded_train_step(
    mesh: jax.sharding.Mesh,
    config: Config,
    optimizer: optax.GradientTransformation,
    precision: str = "default",
) -> Callable:
    """Returns jitted ``step(params, opt_state, state, x, y[, rng, lr])``.

    ``x``/``y`` are ``[B, T]`` with rows sharded over ``data``; the LSTM
    state is likewise batch-sharded.  The loss's internal ``pmean`` over
    ``data`` makes gradients global-batch means, so no separate grad
    all-reduce is needed.  ``rng`` is accepted (unused) for signature parity
    with the single-device step; ``lr`` overrides
    ``opt_state.hyperparams["learning_rate"]`` when present.
    """
    loss_fn = _make_loss_fn(mesh, config, precision)

    data_sharding = NamedSharding(mesh, P(DATA_AXIS))
    state_sharding = NamedSharding(mesh, P(None, DATA_AXIS))

    @jax.jit
    def step(params, opt_state, state, x, y, rng=None, lr=None):
        x = jax.lax.with_sharding_constraint(x, data_sharding)
        y = jax.lax.with_sharding_constraint(y, data_sharding)
        state = jax.tree.map(
            lambda s: jax.lax.with_sharding_constraint(s, state_sharding), state
        )
        (loss, new_state), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, state, x, y, rng
        )
        if lr is not None and hasattr(opt_state, "hyperparams"):
            opt_state.hyperparams["learning_rate"] = lr
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, new_state, loss

    return step


def make_sharded_eval_step(
    mesh: jax.sharding.Mesh, config: Config, precision: str = "default"
) -> Callable:
    """Jitted ``eval(params, state, x, y) -> (mean NLL, state')`` on the mesh.

    Always full softmax (sampled softmax is a training-only approximation,
    SURVEY.md §3.1 "PPL evaluator")."""
    loss_fn = _make_loss_fn(mesh, config, precision, force_full=True)

    data_sharding = NamedSharding(mesh, P(DATA_AXIS))
    state_sharding = NamedSharding(mesh, P(None, DATA_AXIS))

    @jax.jit
    def eval_step(params, state, x, y):
        x = jax.lax.with_sharding_constraint(x, data_sharding)
        y = jax.lax.with_sharding_constraint(y, data_sharding)
        state = jax.tree.map(
            lambda s: jax.lax.with_sharding_constraint(s, state_sharding), state
        )
        loss, new_state = loss_fn(params, state, x, y)
        return loss, new_state

    return eval_step


def _make_seq_loss_fn(
    seq_mesh: jax.sharding.Mesh, config: Config, microbatches: int
):
    """Loss over the time-block pipeline (SURVEY.md §7 long-context row).

    The BPTT window's time axis is sharded over the ``seq`` mesh axis and
    the batch is split into ``microbatches`` pipeline streams; the (c, h)
    carries hand off between neighbor devices via ``ppermute``
    (:mod:`jlm.parallel.seq_pipeline`).  The embedding and the softmax
    head run replicated — pairing ``seq`` with a ``vocab`` axis on a 2-D
    mesh is the full config-5 layout; this step is the ``seq``-only wiring.
    Exactly equals the single-device step (pinned by test_sharded).
    """
    from jlm.models.heads import full_softmax_loss
    from jlm.models.lstm import _w, embed
    from jlm.parallel.seq_pipeline import make_seq_pipeline_scan

    pipe = make_seq_pipeline_scan(
        seq_mesh, num_layers=config.num_layers, forget_bias=config.forget_bias
    )
    M = microbatches
    L, H = config.num_layers, config.hidden_size

    def loss_fn(params, state, x, y):
        B_all, T = x.shape
        assert B_all % M == 0, (
            f"batch {B_all} must divide into {M} pipeline microbatches"
        )
        Bm = B_all // M
        xs = embed(params, x).reshape(M, Bm, T, -1)
        c0, h0 = state  # [L, B_all, H]
        c0m = jnp.moveaxis(c0.reshape(L, M, Bm, H), 1, 0)  # [M, L, Bm, H]
        h0m = jnp.moveaxis(h0.reshape(L, M, Bm, H), 1, 0)
        layers = tuple((_w(l["W"]), l["b"]) for l in params["lstm"])
        hs, c_f, h_f = pipe(xs, layers, c0m, h0m)
        hs = hs.reshape(B_all, T, H)
        loss = full_softmax_loss(params, config, hs, y)
        new_state = (
            jnp.moveaxis(c_f, 0, 1).reshape(L, B_all, H),
            jnp.moveaxis(h_f, 0, 1).reshape(L, B_all, H),
        )
        return loss, new_state

    return loss_fn


def make_seq_train_step(
    seq_mesh: jax.sharding.Mesh,
    config: Config,
    optimizer: optax.GradientTransformation,
    microbatches: int = 0,
) -> Callable:
    """Jitted ``step(params, opt_state, state, x, y[, rng, lr])`` on a
    ``('seq',)`` mesh — time-block pipeline parallel training.

    ``microbatches`` defaults to the seq axis size (must be a multiple of
    it; more microbatches raise pipeline utilization M/(M+P-1)).
    """
    P_seq = seq_mesh.shape["seq"]
    M = microbatches or max(P_seq, min(config.batch_size, 2 * P_seq))
    assert M % P_seq == 0, f"microbatches {M} must divide by seq axis {P_seq}"
    loss_fn = _make_seq_loss_fn(seq_mesh, config, M)

    @jax.jit
    def step(params, opt_state, state, x, y, rng=None, lr=None):
        del rng
        (loss, new_state), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, state, x, y
        )
        if lr is not None and hasattr(opt_state, "hyperparams"):
            opt_state.hyperparams["learning_rate"] = lr
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, new_state, loss

    return step


def make_seq_eval_step(
    seq_mesh: jax.sharding.Mesh, config: Config, microbatches: int = 0
) -> Callable:
    """Jitted pipeline-parallel ``eval(params, state, x, y)``."""
    P_seq = seq_mesh.shape["seq"]
    M = microbatches or max(P_seq, min(config.batch_size, 2 * P_seq))
    loss_fn = _make_seq_loss_fn(seq_mesh, config, M)
    return jax.jit(loss_fn)


def init_sharded_training(
    params: Any,
    config: Config,
    mesh: jax.sharding.Mesh,
    optimizer: optax.GradientTransformation,
) -> Tuple[Any, Any]:
    """Shard params per the layout and build matching sharded opt state."""
    sharded = shard_params(jax.tree.map(jnp.asarray, params), config, mesh)
    opt_state = jax.jit(
        optimizer.init,
        # opt state mirrors param shardings leaf-wise via propagation
    )(sharded)
    return sharded, opt_state
