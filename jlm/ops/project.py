"""Hopper kernel: output projection fused with an online logsumexp.

The decode head's per-frame normaliser ``lse = logsumexp(h @ W + b)`` over
the whole vocabulary is the frame's dominant cost: at the bench shape
(20,480 beam rows, H=512, V=50,000) it is about 1 TFLOP, against 64 GFLOP
for the LSTM cell.  Left to XLA it is a GEMM that writes ``[R, V]`` logits
to device memory (2-4 GB) and a reduction that reads them back.  This
kernel never materialises the logits: each program holds one block of
rows in on-chip memory, walks its share of the vocabulary in tiles with
``lax.fori_loop`` and keeps a running max and sum in registers.

Written for Pallas through Triton (``backend="triton"``):

- grid ``(row blocks, vocab splits)``.  Row blocks alone may leave the
  132 SMs idle at keystroke batch sizes, so the vocabulary is split into
  ``P`` parts whose partial ``(m, s)`` merge with the same three-line rule
  that merges D-softmax blocks and vocab shards (:func:`merge_ms`);
- programs that run together walk the same vocab tiles in the same order,
  so weight tiles are shared through L2 (the int8 head is 25.6 MB, the
  bf16 head 51 MB, against 50 MB of L2);
- rows, hidden width and vocabulary need not be multiples of the tiles:
  loads are masked, and masked columns get a ``-1e30`` bias so they add
  nothing to the sum.

Weight modes: bf16 (or fp32) weights; int8 weights converted to the
compute dtype in the tile (exact for int8 values) with the per-column
scale applied to the fp32 product; ``int8_mxu``, which quantises each row
of activations to int8 and runs an int8 x int8 -> int32 product.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from jlm.config import Config

# Finite stand-in for -inf: exp(NEG - m) underflows to 0 for any real m,
# and a split whose columns are all masked merges away (see merge_ms).
NEG = -1e30

# Programs to aim for when choosing the vocab split: two per SM of an H100.
_TARGET_PROGRAMS = 2 * 132
# Shared memory one block may use on Hopper.  A program holds its row
# block of h and ``num_stages`` weight tiles there.
_SMEM_BYTES = 232_448


@dataclasses.dataclass(frozen=True)
class LaunchParams:
    block_r: int  # rows per program (power of two, >= 16 for the dot)
    block_v: int  # vocab columns per loop step (power of two, >= 16)
    splits: int  # vocab parts P, one program each per row block
    num_warps: int
    num_stages: int


def _pow2_at_least(x: int, lo: int = 16) -> int:
    return max(lo, 1 << max(0, int(x) - 1).bit_length())


def smem_bytes(block_r, block_v, d_pad, num_stages, h_bytes, w_bytes):
    """Shared memory of one program: its h block plus the weight tiles."""
    return (block_r * d_pad * h_bytes
            + num_stages * d_pad * block_v * w_bytes)


def launch_params(
    R: int, D: int, V: int, *, h_bytes: int = 2, w_bytes: int = 2,
    block_r: Optional[int] = None, block_v: Optional[int] = None,
    splits: Optional[int] = None, num_warps: Optional[int] = None,
    num_stages: Optional[int] = None,
) -> LaunchParams:
    """Tile sizes and vocab split for ``R`` rows, width ``D``, ``V`` columns.

    ``h_bytes``/``w_bytes`` are the element sizes of the activations and
    weights as they sit in shared memory.  The defaults follow a sweep on
    an H100 at the bench shape (PERF.md): row blocks of 128 (256 for int8
    activations), then the widest weight tile with two pipeline stages
    that fits a block's shared memory; where that is narrower than 64
    columns, one stage of 64 columns instead.  The vocabulary is split
    until there are about two programs per SM; each split gets a whole
    number of tiles and only the last may be short.
    """
    d_pad = _pow2_at_least(D)
    br = block_r or min(256 if h_bytes == 1 else 128, _pow2_at_least(R))
    stages = num_stages or 2
    bv = block_v
    if bv is None:
        bv = 128
        while bv > 16 and smem_bytes(br, bv, d_pad, stages, h_bytes,
                                     w_bytes) > _SMEM_BYTES:
            bv //= 2
        if (bv < 64 and num_stages is None and smem_bytes(
                br, 64, d_pad, 1, h_bytes, w_bytes) <= _SMEM_BYTES):
            bv, stages = 64, 1
    n_tiles = -(-V // bv)
    n_rows = -(-R // br)
    p = splits or max(1, min(n_tiles, -(-_TARGET_PROGRAMS // n_rows)))
    tiles_per = -(-n_tiles // p)
    p = -(-n_tiles // tiles_per)
    return LaunchParams(
        block_r=br, block_v=bv, splits=p,
        num_warps=num_warps or (8 if br * bv >= 128 * 64 else 4),
        num_stages=stages,
    )


def _ms_kernel(*refs, R, D, V, d_pad, block_r, block_v, tiles_per_split,
               mode, compute_dtype):
    if mode == "int8_mxu":
        h_ref, hs_ref, w_ref, scale_ref, b_ref, m_ref, s_ref = refs
    elif mode == "int8":
        h_ref, w_ref, scale_ref, b_ref, m_ref, s_ref = refs
    else:
        h_ref, w_ref, b_ref, m_ref, s_ref = refs
    r = pl.program_id(0)
    p = pl.program_id(1)
    rows = r * block_r + jnp.arange(block_r)
    row_ok = rows < R
    d_ok = jnp.arange(d_pad) < D
    h = plgpu.load(
        h_ref.at[pl.ds(r * block_r, block_r), pl.ds(0, d_pad)],
        mask=row_ok[:, None] & d_ok[None, :], other=0,
    )
    if mode == "int8_mxu":
        h_scale = plgpu.load(
            hs_ref.at[pl.ds(r * block_r, block_r)], mask=row_ok, other=0.0
        )

    def body(t, carry):
        m, s = carry
        v0 = (p * tiles_per_split + t) * block_v
        col_ok = v0 + jnp.arange(block_v) < V
        w = plgpu.load(
            w_ref.at[pl.ds(0, d_pad), pl.ds(v0, block_v)],
            mask=d_ok[:, None] & col_ok[None, :], other=0,
        )
        bias = plgpu.load(b_ref.at[pl.ds(v0, block_v)], mask=col_ok,
                          other=NEG)
        if mode == "int8_mxu":
            scale = plgpu.load(scale_ref.at[pl.ds(v0, block_v)],
                               mask=col_ok, other=0.0)
            acc = pl.dot(h, w).astype(jnp.float32)  # int32 accumulator
            logits = acc * h_scale[:, None] * scale[None, :] + bias[None, :]
        elif mode == "int8":
            scale = plgpu.load(scale_ref.at[pl.ds(v0, block_v)],
                               mask=col_ok, other=0.0)
            acc = pl.dot(h, w.astype(compute_dtype))
            logits = acc * scale[None, :] + bias[None, :]
        else:
            logits = pl.dot(h, w.astype(compute_dtype)) + bias[None, :]
        m_new = jnp.maximum(m, jnp.max(logits, axis=1))
        s = s * jnp.exp(m - m_new) + jnp.sum(
            jnp.exp(logits - m_new[:, None]), axis=1)
        return m_new, s

    m0 = jnp.full((block_r,), NEG, jnp.float32)
    s0 = jnp.zeros((block_r,), jnp.float32)
    m, s = jax.lax.fori_loop(0, tiles_per_split, body, (m0, s0))
    m_ref[...] = m
    s_ref[...] = s


def _full(x):
    return pl.BlockSpec(x.shape, lambda r, p: (0,) * x.ndim)


def _block_ms(
    h: jnp.ndarray,  # [R, D]
    w: jnp.ndarray,  # [D, V] fp, or int8 when ``scale`` is given
    scale: Optional[jnp.ndarray],  # [V] per-column scale, or None
    bias: jnp.ndarray,  # [V]
    *,
    compute_dtype,
    int8_mxu: bool,
    interpret: bool,
    lp: LaunchParams,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Partial ``(m, s)`` of one weight block, each ``[P, R_pad]``."""
    R, D = h.shape
    V = w.shape[1]
    d_pad = _pow2_at_least(D)
    n_rows = -(-R // lp.block_r)
    n_tiles = -(-V // lp.block_v)
    tiles_per = -(-n_tiles // lp.splits)
    bias = bias.astype(jnp.float32)
    if scale is None:
        mode = "fp"
        args = (h.astype(compute_dtype), w, bias)
    elif int8_mxu:
        mode = "int8_mxu"
        hf = h.astype(jnp.float32)
        h_scale = jnp.maximum(jnp.max(jnp.abs(hf), axis=1), 1e-30) / 127.0
        hq = jnp.round(hf / h_scale[:, None]).astype(jnp.int8)
        args = (hq, h_scale, w, scale.astype(jnp.float32), bias)
    else:
        mode = "int8"
        args = (h.astype(compute_dtype), w, scale.astype(jnp.float32), bias)
    kernel = functools.partial(
        _ms_kernel, R=R, D=D, V=V, d_pad=d_pad, block_r=lp.block_r,
        block_v=lp.block_v, tiles_per_split=tiles_per, mode=mode,
        compute_dtype=compute_dtype,
    )
    out = jax.ShapeDtypeStruct((lp.splits, n_rows * lp.block_r), jnp.float32)
    out_spec = pl.BlockSpec((None, lp.block_r), lambda r, p: (p, r))
    return pl.pallas_call(
        kernel,
        grid=(n_rows, lp.splits),
        in_specs=[_full(a) for a in args],
        out_specs=(out_spec, out_spec),
        out_shape=(out, out),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=lp.num_warps, num_stages=lp.num_stages),
        interpret=interpret,
        name="project_ms",
    )(*args)


def merge_ms(m: jnp.ndarray, s: jnp.ndarray, axis: int = 0):
    """Merge partial softmax statistics along ``axis``:
    ``m = max m_k``, ``s = sum s_k exp(m_k - m)``."""
    m_g = jnp.max(m, axis=axis, keepdims=True)
    s_g = jnp.sum(s * jnp.exp(m - m_g), axis=axis, keepdims=True)
    return m_g, s_g


def head_blocks(head, config: Config):
    """``(h column slice, W, scale, b)`` per weight block of a head.

    A full head is one block over all of ``h``; a D-softmax head has one
    block per frequency tier, each reading its prefix (D-softmax*) or
    disjoint slice of ``h``.  ``W`` may be an int8 quant dict.
    """
    blocks = head["blocks"] if "blocks" in head else [head]
    out = []
    offset = 0
    for k, blk in enumerate(blocks):
        if "blocks" in head:
            ds = config.dsoftmax
            d = ds.block_dims[k]
            sl = (0, d) if ds.mode == "prefix" else (offset, d)
            offset += d if ds.mode == "disjoint" else 0
        else:
            sl = None
        W = blk["W"]
        w, scale = (W["q"], W["scale"]) if isinstance(W, dict) else (W, None)
        out.append((sl, w, scale, blk["b"]))
    return out


def project_ms(
    h: jnp.ndarray,  # [R, H]
    head,  # {"W","b"} | {"blocks": [...]}; W may be an int8 quant dict
    config: Config,
    *,
    compute_dtype=jnp.bfloat16,
    int8_mxu: bool = False,
    interpret: bool = False,
    **launch,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-row softmax statistics ``(m, s)`` over this head's columns.

    ``m`` is the row max and ``s`` the sum of ``exp(logit - m)``, each
    ``[R, 1]``, so ``lse = m + log s``.  A vocab-sharded head runs this on
    its local columns and merges across cards with one ``pmax`` and one
    ``psum``.  ``launch`` overrides :func:`launch_params`.
    """
    R = h.shape[0]
    ms, ss = [], []
    for sl, w, scale, b in head_blocks(head, config):
        hs = h if sl is None else h[:, sl[0]:sl[0] + sl[1]]
        mxu = int8_mxu and scale is not None
        lp = launch_params(
            R, hs.shape[1], w.shape[1],
            h_bytes=1 if mxu else jnp.dtype(compute_dtype).itemsize,
            w_bytes=w.dtype.itemsize, **launch)
        m, s = _block_ms(
            hs, w, scale, b, compute_dtype=compute_dtype,
            int8_mxu=mxu, interpret=interpret, lp=lp,
        )
        ms.append(m[:, :R])
        ss.append(s[:, :R])
    m, s = merge_ms(jnp.concatenate(ms), jnp.concatenate(ss))
    return m[0][:, None], s[0][:, None]


def project_lse(h, head, config: Config, **kw) -> jnp.ndarray:
    """Per-row log-sum-exp of the full output projection: ``[R, 1]``."""
    m, s = project_ms(h, head, config, **kw)
    return m + jnp.log(s)


def project_lse_plain(h, head, config: Config, compute_dtype=jnp.float32):
    """The same ``[R, 1]`` log-sum-exp as plain XLA: logits, then reduce.

    fp32 runs at ``Precision.HIGHEST`` (the reference; no TF32 on the
    GPU); bf16 is the plain version the kernel is timed against.
    """
    precision = (jax.lax.Precision.HIGHEST if compute_dtype == jnp.float32
                 else jax.lax.Precision.DEFAULT)
    outs = []
    for sl, w, scale, b in head_blocks(head, config):
        hs = h if sl is None else h[:, sl[0]:sl[0] + sl[1]]
        logits = jnp.dot(hs.astype(compute_dtype), w.astype(compute_dtype),
                         precision=precision,
                         preferred_element_type=jnp.float32)
        if scale is not None:
            logits = logits * scale[None, :]
        outs.append(logits + b[None, :])
    return jax.nn.logsumexp(jnp.concatenate(outs, axis=1), axis=1,
                            keepdims=True)


def project_candidates_ref(h, weight, scale, bias, cand_ids):
    """fp32 candidate log-probs ``log softmax(h @ W + b)[:, cand]``."""
    w = weight.astype(jnp.float32)
    if scale is not None:
        w = w * scale[None, :]
    logits = jnp.dot(h.astype(jnp.float32), w,
                     precision=jax.lax.Precision.HIGHEST) + bias
    m = jnp.max(logits, axis=1, keepdims=True)
    lse = m + jnp.log(jnp.sum(jnp.exp(logits - m), axis=1, keepdims=True))
    return logits[:, cand_ids] - lse


def project_flops(R: int, head, config: Config) -> int:
    """Multiply-add FLOPs of one normaliser call (2 per weight per row)."""
    return int(sum(2 * R * w.shape[0] * w.shape[1]
                   for _sl, w, _s, _b in head_blocks(head, config)))

