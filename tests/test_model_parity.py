"""JAX model core vs numpy oracle parity (SURVEY.md §9.1 layer 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jlm.config import Config, DSoftmaxConfig
from jlm.models import init_params
from jlm.models.heads import (
    full_softmax_loss,
    sample_log_uniform,
    sampled_softmax_loss,
)
from jlm.models.lstm import (
    forward_hidden,
    head_logits,
    initial_state,
    log_softmax,
    step_logp,
)
from jlm.oracle import OracleLM
from jlm.ops.quant import quantize_params


def test_step_matches_oracle(tiny_params, tiny_config):
    lm = OracleLM(tiny_params, tiny_config)
    ids = np.array([3, 9, 27], np.int32)
    s_np = lm.initial_state(3)
    logp_np, (c_np, h_np) = lm.step(ids, s_np)
    logp_np2, _ = lm.step(np.array([1, 1, 1], np.int32), (c_np, h_np))

    s_j = initial_state(tiny_config, 3)
    logp_j, s_j = step_logp(tiny_params, tiny_config, jnp.asarray(ids), s_j)
    logp_j2, _ = step_logp(
        tiny_params, tiny_config, jnp.asarray([1, 1, 1]), s_j
    )
    np.testing.assert_allclose(logp_j, logp_np, atol=1e-5)
    np.testing.assert_allclose(logp_j2, logp_np2, atol=1e-5)


def test_step_matches_oracle_quantized(tiny_params, tiny_config):
    qp = quantize_params(tiny_params)
    lm = OracleLM(qp, tiny_config)  # oracle dequantizes up front
    qp_j = jax.tree.map(jnp.asarray, qp)
    ids = np.array([5, 0], np.int32)
    logp_np, _ = lm.step(ids, lm.initial_state(2))
    logp_j, _ = step_logp(qp_j, tiny_config, jnp.asarray(ids), initial_state(tiny_config, 2))
    np.testing.assert_allclose(logp_j, logp_np, atol=1e-5)


@pytest.mark.parametrize("mode", ["prefix", "disjoint"])
def test_dsoftmax_head_matches_oracle(mode):
    dims = (32, 16, 8) if mode == "prefix" else (16, 8, 8)  # disjoint must fit H
    cfg = Config(
        vocab_size=96,
        embed_size=16,
        hidden_size=32,
        head="dsoftmax",
        dsoftmax=DSoftmaxConfig(block_sizes=(32, 32, 32), block_dims=dims, mode=mode),
        seed=7,
    )
    params = init_params(cfg)
    lm = OracleLM(params, cfg)
    ids = np.array([2, 4], np.int32)
    logp_np, _ = lm.step(ids, lm.initial_state(2))
    logp_j, _ = step_logp(params, cfg, jnp.asarray(ids), initial_state(cfg, 2))
    assert logp_j.shape == (2, 96)
    np.testing.assert_allclose(logp_j, logp_np, atol=1e-5)


def test_forward_hidden_scan_matches_steps(tiny_params, tiny_config):
    """lax.scan over a window must equal repeated single steps."""
    B, T = 2, 5
    rng = np.random.default_rng(0)
    ids = rng.integers(0, tiny_config.vocab_size, (B, T)).astype(np.int32)
    hs, state = forward_hidden(
        tiny_params, tiny_config, jnp.asarray(ids), initial_state(tiny_config, B),
        precision="highest",
    )
    lm = OracleLM(tiny_params, tiny_config)
    s = lm.initial_state(B)
    for t in range(T):
        _, s = lm.step(ids[:, t], s)
    np.testing.assert_allclose(state[1], s[1], atol=1e-5)  # h carry
    np.testing.assert_allclose(hs[:, -1, :], s[1][-1], atol=1e-5)


def test_full_softmax_loss_value(tiny_params, tiny_config):
    B, T = 2, 4
    rng = np.random.default_rng(1)
    ids = rng.integers(0, tiny_config.vocab_size, (B, T + 1)).astype(np.int32)
    hs, _ = forward_hidden(
        tiny_params, tiny_config, jnp.asarray(ids[:, :-1]),
        initial_state(tiny_config, B), precision="highest",
    )
    loss = full_softmax_loss(
        tiny_params, tiny_config, hs, jnp.asarray(ids[:, 1:]), precision="highest"
    )
    # oracle NLL
    lm = OracleLM(tiny_params, tiny_config)
    s = lm.initial_state(B)
    total = 0.0
    for t in range(T):
        logp, s = lm.step(ids[:, t], s)
        total -= logp[np.arange(B), ids[:, t + 1]].sum()
    np.testing.assert_allclose(float(loss), total / (B * T), atol=1e-5)


def test_sampled_softmax_trains_toward_full():
    """Sampled loss must be finite and roughly track full loss."""
    cfg = Config(
        vocab_size=128, embed_size=16, hidden_size=32,
        sampled_softmax_samples=32, seed=3,
    )
    params = init_params(cfg)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    hs, _ = forward_hidden(params, cfg, jnp.asarray(ids), initial_state(cfg, 4))
    l_s = sampled_softmax_loss(
        params, cfg, hs, jnp.asarray(tgt), jax.random.key(0)
    )
    l_f = full_softmax_loss(params, cfg, hs, jnp.asarray(tgt))
    assert np.isfinite(float(l_s))
    # crude sanity: same order of magnitude
    assert 0.2 < float(l_s) / float(l_f) < 2.0


def test_log_uniform_sampler_is_zipfian():
    ids = sample_log_uniform(jax.random.key(1), 1000, 4000)
    ids = np.asarray(ids)
    assert ids.min() >= 0 and ids.max() < 1000
    # low ids must dominate
    assert (ids < 100).mean() > 0.5


def test_grad_flows_through_scan(tiny_params, tiny_config):
    ids = jnp.asarray(np.arange(8, dtype=np.int32).reshape(2, 4))
    tgt = jnp.roll(ids, -1, axis=1)

    def loss_fn(p):
        hs, _ = forward_hidden(p, tiny_config, ids, initial_state(tiny_config, 2))
        return full_softmax_loss(p, tiny_config, hs, tgt)

    g = jax.grad(loss_fn)(tiny_params)
    gnorm = float(
        jnp.sqrt(sum(jnp.sum(x * x) for x in jax.tree.leaves(g)))
    )
    assert np.isfinite(gnorm) and gnorm > 0

