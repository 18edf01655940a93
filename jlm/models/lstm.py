"""JAX LSTM LM core — functional init/apply over the shared param pytree.

Re-design of the reference's TF graph + numpy engine (ref:
JLM:train/lm.py, JLM:decoder/ model file — SURVEY.md §4.2): pure functions
over pytrees, ``jax.lax.scan`` over time (static shapes, XLA-fusable), one
fused ``[x; h] @ W`` matmul per cell with ``i, j, f, o`` gate split.

Quantized weights (int8 + per-channel scale dicts, see
:mod:`jlm.ops.quant`) are dequantized inline with jnp — XLA fuses the
dequant into the consumer matmul; the head kernel in :mod:`jlm.ops`
dequantizes its weight tiles in-kernel on the decode path.

``precision`` threads through every matmul: ``"highest"`` (true fp32, no
TF32 on the GPU) is the parity mode matching the numpy oracle;
``"default"`` lets the tensor cores run at bf16/TF32 speed.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from jlm.config import Config

State = Tuple[jnp.ndarray, jnp.ndarray]  # (c, h) each [L, B, H]


def _w(leaf, axis: int = 0):
    """Materialize an (optionally int8-quantized) weight as fp32."""
    if isinstance(leaf, dict) and "q" in leaf:
        return leaf["q"].astype(jnp.float32) * jnp.expand_dims(leaf["scale"], axis)
    return leaf


def embed(params: Dict[str, Any], word_ids: jnp.ndarray) -> jnp.ndarray:
    """Embedding row gather with per-row dequant for int8 tables."""
    emb = params["embedding"]
    if isinstance(emb, dict) and "q" in emb:
        rows = emb["q"][word_ids].astype(jnp.float32)
        return rows * emb["scale"][word_ids][..., None]
    return emb[word_ids]


def initial_state(config: Config, batch: int) -> State:
    shape = (config.num_layers, batch, config.hidden_size)
    return jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)


def lstm_step(
    params: Dict[str, Any],
    config: Config,
    x: jnp.ndarray,  # [B, E] embedded input
    state: State,
    precision: str = "highest",
) -> Tuple[jnp.ndarray, State]:
    """One fused-cell step through all layers; returns (h_top [B,H], state')."""
    c, h = state
    H = config.hidden_size
    new_c, new_h = [], []
    for l, layer in enumerate(params["lstm"]):
        z = (
            jnp.dot(
                jnp.concatenate([x, h[l]], axis=1),
                _w(layer["W"]),
                precision=precision,
            )
            + layer["b"]
        )
        i, j, f, o = jnp.split(z, 4, axis=1)
        cl = jax.nn.sigmoid(f + config.forget_bias) * c[l] + jax.nn.sigmoid(
            i
        ) * jnp.tanh(j)
        hl = jax.nn.sigmoid(o) * jnp.tanh(cl)
        new_c.append(cl)
        new_h.append(hl)
        x = hl
    return x, (jnp.stack(new_c), jnp.stack(new_h))


def cell(x, h, c, W, b, forget_bias: float, compute_dtype):
    """One LSTM cell on the decode path: returns ``(c', h')``.

    ``[x; h] @ W`` takes ``compute_dtype`` operands with an fp32
    accumulator; the gate chain runs in fp32 and XLA fuses it after the
    GEMM.  ``c'`` and ``h'`` come back in ``compute_dtype``.  fp32 runs at
    ``Precision.HIGHEST`` so parity mode gets no TF32 on the GPU.
    """
    precision = (jax.lax.Precision.HIGHEST if compute_dtype == jnp.float32
                 else jax.lax.Precision.DEFAULT)
    z = jnp.dot(
        jnp.concatenate([x.astype(compute_dtype), h.astype(compute_dtype)],
                        axis=1),
        W.astype(compute_dtype), precision=precision,
        preferred_element_type=jnp.float32,
    ) + b.astype(jnp.float32)
    i, j, f, o = jnp.split(z, 4, axis=1)
    c_new = jax.nn.sigmoid(f + forget_bias) * c.astype(jnp.float32) + (
        jax.nn.sigmoid(i) * jnp.tanh(j))
    h_new = jax.nn.sigmoid(o) * jnp.tanh(c_new)
    return c_new.astype(compute_dtype), h_new.astype(compute_dtype)


def head_logits(
    params: Dict[str, Any],
    config: Config,
    h_top: jnp.ndarray,  # [B, H]
    precision: str = "highest",
) -> jnp.ndarray:
    """Output projection → logits [B, V]; full or D-softmax head (§4.4)."""
    head = params["head"]
    if "blocks" in head:
        cfg = config.dsoftmax
        outs = []
        offset = 0
        for k, blk in enumerate(head["blocks"]):
            d = cfg.block_dims[k]
            if cfg.mode == "prefix":
                hs = h_top[:, :d]
            else:
                hs = h_top[:, offset : offset + d]
                offset += d
            outs.append(jnp.dot(hs, _w(blk["W"]), precision=precision) + blk["b"])
        return jnp.concatenate(outs, axis=1)
    return jnp.dot(h_top, _w(head["W"]), precision=precision) + head["b"]


def candidate_logits(
    params: Dict[str, Any],
    config: Config,
    h_top: jnp.ndarray,  # [..., H]
    words: jnp.ndarray,  # [N] global word ids
    precision: str = "highest",
) -> jnp.ndarray:
    """Unnormalized logits for specific vocab columns only: ``[..., N]``.

    The incremental decoder's lazy scoring path (SURVEY.md §4.7): gathers
    just the candidate columns of the output matrix instead of projecting
    the whole vocab.  Combined with a cached per-path logsumexp this prices
    a keystroke at O(N·H) instead of O(V·H).
    """
    head = params["head"]
    if "blocks" in head:
        cfg = config.dsoftmax
        sizes = np.asarray(cfg.block_sizes, np.int64)
        bases = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        out = jnp.zeros(h_top.shape[:-1] + (words.shape[0],), jnp.float32)
        offset = 0
        for k, blk in enumerate(head["blocks"]):
            d = cfg.block_dims[k]
            if cfg.mode == "prefix":
                hs = h_top[..., :d]
            else:
                hs = h_top[..., offset : offset + d]
                offset += d
            in_blk = (words >= bases[k]) & (words < bases[k] + sizes[k])
            local = jnp.clip(words - bases[k], 0, sizes[k] - 1)
            W = _w(blk["W"])  # [d, s_k]
            cols = jnp.take(W, local, axis=1)  # [d, N]
            vals = (
                jnp.einsum("...d,dn->...n", hs, cols, precision=precision)
                + blk["b"][local]
            )
            out = jnp.where(in_blk, vals, out)
        return out
    W = _w(head["W"])
    cols = jnp.take(W, words, axis=1)  # [H, N]
    return (
        jnp.einsum("...h,hn->...n", h_top, cols, precision=precision)
        + head["b"][words]
    )


def node_logits(
    params: Dict[str, Any],
    config: Config,
    h_src: jnp.ndarray,  # [..., N, B, H] hidden states paired per node
    words: jnp.ndarray,  # [..., N] each node's own word id
    precision: str = "highest",
) -> jnp.ndarray:
    """Raw logit of each node's OWN word from each beam path: ``[..., N, B]``.

    The paired form of :func:`candidate_logits`: node ``n`` is scored only
    against its own output column, so the work is one column gather + einsum
    — O(N·B·H) instead of the O(N²·B·H) "all words × all rows then keep the
    diagonal" shape.  Shared by the incremental decoder and the multi-session
    server (SURVEY.md §4.7 lazy scoring; both heads, int8-aware).
    """
    lead = words.shape[:-1]
    N = words.shape[-1]
    B, H = h_src.shape[-2], h_src.shape[-1]
    E = int(np.prod(lead)) if lead else 1
    h_src = h_src.reshape(E, N, B, H)
    words = words.reshape(E, N)
    head = params["head"]

    def cols_of(W, ids):  # -> fp32 [d, E, N]
        if isinstance(W, dict):
            c = jnp.take(W["q"], ids.reshape(-1), axis=1).astype(jnp.float32)
            c = c * jnp.take(W["scale"], ids.reshape(-1))[None, :]
        else:
            c = jnp.take(W, ids.reshape(-1), axis=1)
        return c.reshape(c.shape[0], E, N)

    if "blocks" in head:
        ds = config.dsoftmax
        sizes = np.asarray(ds.block_sizes, np.int64)
        bases = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        out = jnp.zeros((E, N, B), jnp.float32)
        offset = 0
        for k, blk in enumerate(head["blocks"]):
            d = ds.block_dims[k]
            hs = (
                h_src[..., :d] if ds.mode == "prefix"
                else h_src[..., offset:offset + d]
            )
            if ds.mode == "disjoint":
                offset += d
            in_blk = (words >= bases[k]) & (words < bases[k] + sizes[k])
            local = jnp.clip(words - bases[k], 0, sizes[k] - 1)
            cols = cols_of(blk["W"], local)
            vals = jnp.einsum(
                "enbd,den->enb", hs, cols, precision=precision
            ) + jnp.take(blk["b"], local)[:, :, None]
            out = jnp.where(in_blk[:, :, None], vals, out)
        return out.reshape(*lead, N, B)
    cols = cols_of(head["W"], words)
    out = jnp.einsum(
        "enbh,hen->enb", h_src, cols, precision=precision
    ) + jnp.take(head["b"], words.reshape(-1)).reshape(E, N)[:, :, None]
    return out.reshape(*lead, N, B)


def log_softmax(logits: jnp.ndarray) -> jnp.ndarray:
    """Max-subtracted fp32 log-softmax — the frozen parity numeric rule."""
    logits = logits.astype(jnp.float32)
    m = jnp.max(logits, axis=-1, keepdims=True)
    return logits - (m + jnp.log(jnp.sum(jnp.exp(logits - m), axis=-1, keepdims=True)))


def step_logp(
    params: Dict[str, Any],
    config: Config,
    word_ids: jnp.ndarray,  # [B]
    state: State,
    precision: str = "highest",
) -> Tuple[jnp.ndarray, State]:
    """Full LM step mirroring :meth:`OracleLM.step`: ids → (logp [B,V], state')."""
    x = embed(params, word_ids)
    h_top, state = lstm_step(params, config, x, state, precision)
    return log_softmax(head_logits(params, config, h_top, precision)), state


def forward_hidden(
    params: Dict[str, Any],
    config: Config,
    ids: jnp.ndarray,  # [B, T] int32
    state: State,
    precision: str = "default",
    remat: bool = False,
) -> Tuple[jnp.ndarray, State]:
    """Run the LSTM over a time window via ``lax.scan``.

    Returns the top-layer hidden sequence ``[B, T, H]`` and the carried
    state — the training path's recurrent core (the output head/loss is
    applied by the caller so sampled-softmax and D-softmax losses can share
    this scan).

    ``remat=True`` wraps each cell step in ``jax.checkpoint``: backprop
    recomputes gate activations instead of storing ``[B, T, 4H·L]`` of
    them — the HBM-for-FLOPs trade that lets long BPTT windows / big
    batches fit (the tensor cores re-pay a cheap [x;h]·W; activation
    memory drops to the carried (c, h) per step).
    """
    xs = embed(params, ids)  # [B, T, E]

    def scan_fn(carry, x_t):
        h_top, carry = lstm_step(params, config, x_t, carry, precision)
        return carry, h_top

    if remat:
        scan_fn = jax.checkpoint(scan_fn)

    state, hs = jax.lax.scan(scan_fn, state, jnp.swapaxes(xs, 0, 1))
    return jnp.swapaxes(hs, 0, 1), state
