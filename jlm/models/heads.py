"""Training losses over the LSTM hidden sequence.

The reference's three loss variants (ref: JLM:train/lm.py — SURVEY.md
§4.2): full softmax cross-entropy, sampled softmax (log-uniform/Zipf
candidate sampling for large-vocab speed), and D-softmax (structured head;
its loss is plain CE over the segmented logits, which
:func:`jlm.models.lstm.head_logits` already produces).

All losses take the ``[B, T, H]`` hidden sequence from
:func:`jlm.models.lstm.forward_hidden` so they are interchangeable
under one training step.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

from jlm.config import Config
from jlm.models.lstm import _w, head_logits, log_softmax


def full_softmax_loss(
    params: Dict[str, Any],
    config: Config,
    hs: jnp.ndarray,  # [B, T, H]
    targets: jnp.ndarray,  # [B, T]
    precision: str = "default",
) -> jnp.ndarray:
    """Mean token NLL with the full (or D-softmax) projection."""
    B, T, H = hs.shape
    logits = head_logits(params, config, hs.reshape(B * T, H), precision)
    logp = log_softmax(logits)
    nll = -jnp.take_along_axis(
        logp, targets.reshape(B * T, 1), axis=1
    ).squeeze(1)
    return nll.mean()


def log_uniform_logq(vocab_size: int) -> jnp.ndarray:
    """log q(k) of the Zipfian (log-uniform) candidate sampler.

    q(k) = (log(k+2) - log(k+1)) / log(V+1) — the sampler the reference's
    TF ``sampled_softmax_loss`` uses for frequency-ordered vocabs, where
    frequent (low-id) words are sampled more often.
    """
    k = jnp.arange(vocab_size, dtype=jnp.float32)
    return jnp.log(jnp.log1p(1.0 / (k + 1.0)) / jnp.log(vocab_size + 1.0))


def sample_log_uniform(rng: jax.Array, vocab_size: int, n: int) -> jnp.ndarray:
    """Draw ``n`` ids with P(k) ∝ log((k+2)/(k+1)) via inverse CDF."""
    u = jax.random.uniform(rng, (n,))
    # CDF(k) = log(k+2)/log(V+1)  ⇒  k = exp(u·log(V+1)) - 2, clipped.
    ids = jnp.exp(u * jnp.log(vocab_size + 1.0)) - 2.0
    return jnp.clip(ids.round().astype(jnp.int32), 0, vocab_size - 1)


def sampled_softmax_loss(
    params: Dict[str, Any],
    config: Config,
    hs: jnp.ndarray,  # [B, T, H]
    targets: jnp.ndarray,  # [B, T]
    rng: jax.Array,
    precision: str = "default",
) -> jnp.ndarray:
    """Sampled-softmax NLL (full-softmax head only).

    True + S sampled classes, both corrected by −log q(class); accidental
    hits (sampled == true) are masked out, matching TF's
    ``remove_accidental_hits`` behavior.
    """
    head = params["head"]
    assert "blocks" not in head, "sampled softmax requires the full head"
    S = config.sampled_softmax_samples
    V = config.vocab_size
    B, T, H = hs.shape
    h = hs.reshape(B * T, H)
    t = targets.reshape(B * T)

    sampled = sample_log_uniform(rng, V, S)  # [S], shared across batch (TF-style)
    logq = log_uniform_logq(V)

    W = _w(head["W"])  # [H, V]
    b = head["b"]
    w_true = W[:, t]  # [H, N]
    w_samp = W[:, sampled]  # [H, S]
    true_logit = (
        jnp.einsum("nh,hn->n", h, w_true, precision=precision) + b[t] - logq[t]
    )
    samp_logit = (
        jnp.dot(h, w_samp, precision=precision) + b[sampled] - logq[sampled]
    )  # [N, S]
    # Mask accidental hits so the true class is not double-counted.
    hit = sampled[None, :] == t[:, None]
    samp_logit = jnp.where(hit, -1e9, samp_logit)

    joint = jnp.concatenate([true_logit[:, None], samp_logit], axis=1)
    return (-log_softmax(joint)[:, 0]).mean()
