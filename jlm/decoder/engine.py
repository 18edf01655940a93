"""Device-resident beam-Viterbi decoding.

Re-design of the reference's decode loop (ref:
JLM:decoder/decoder.py ``Decoder.decode`` — SURVEY.md §4.6, §5.4).  The
reference interleaves Python lattice bookkeeping with one numpy LM call per
frame; a literal port would pay a host↔device round trip per frame
(SURVEY.md §9.3.1 ranks this the #1 hard part).  Here the ENTIRE search —
for a whole BATCH of independent lattices — is one jitted ``lax.scan``
over frames:

- lattices are packed host-side into ONE ``[S, T_max, N]`` int32 tensor
  (word|start|cand_idx|mask bit-packed) to minimize upload latency; the
  per-position candidate ("lookahead") table is reconstructed on device by
  a single scatter;
- beams, LSTM states, and per-position forward caches live in device
  arrays indexed by (sentence, ring slot): a node spanning (i, j] always
  has ``j - i <= max_word_len``, so only the last ``max_word_len`` frame
  rows are ever gathered — the caches are RING BUFFERS of ``R = 8`` rows
  instead of ``T_max + 1``, cutting the scan's carry traffic ~8x;
- each scan step: gather cached candidate log-probs → score all
  (node × path) extensions → per-sentence stable ``lax.top_k`` prune →
  ring-indexed gather of surviving states → ONE batched LM forward over
  all ``S·B`` beam rows (one large matmul per layer);
- final ``<eos>``-rescored totals accumulate inside the scan at each
  sentence's true length; backtracking runs on device; only
  ``[S, K, T_max, 2]`` int16 paths and final scores return to the host.

Batched-first: every gather is expressed over a leading batch axis
(``take_along_axis`` or an exact 0/1 selection einsum), never a
per-sentence ``vmap`` of advanced indexing.  ``decode()`` is the S=1 case of ``decode_batch()``.

Parity with the numpy oracle is exact in fp32: same cached-forward
formulation, same extension enumeration order (node-major, path-minor —
flat index ``n·B + p``), same stable top-k tie-break (``lax.top_k``
prefers lower flat indices), same max-subtracted log-softmax.

The LM forward is pluggable (``forward_fn``, batched signature) so the
full-softmax jnp head, the Pallas kernel head, and the vocab-sharded
``shard_map`` head all drive the same search skeleton.  A forward may
carry a ``prepare`` attribute — ``prepare(params, look_w) -> payload`` runs
once per decode call (on device, before the scan) and its per-position
payload is sliced into each frame step; the fast path uses it to pre-gather
all candidate output-matrix COLUMNS for the whole lattice batch from a
transposed head copy, so the per-frame candidate work is one small einsum
instead of a strided O(C·H) gather from the ``[H, V]`` weight.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from jlm.backend import use_kernels
from jlm.config import Config, EOS_ID, UNK_ID
from jlm.data.corpus import Vocab
from jlm.data.lexicon import Lexicon
from jlm.decoder.lattice import Lattice, build_lattice
from jlm.models.lstm import initial_state, step_logp
from jlm.oracle.decoder import DecodeResult

# Batched LM forward over all beam rows:
#   forward_fn(params, words [S, B], state (c,h) [L, S*B, H], payload)
#     -> (cand_logp [S, B, C], eos_logp [S, B], new_state)
# ``payload`` is the per-position slice of what ``forward_fn.prepare``
# returned (default: the raw candidate word ids ``[S, C]``).
ForwardFn = Callable[..., Tuple[jnp.ndarray, jnp.ndarray, Any]]

# bit-packing layout for the lattice upload (see pack_lattice_batch)
_WORD_BITS = 17  # vocab ids < 131072
_START_SHIFT = 17  # start position: 6 bits (T_max <= 63)
_CIDX_SHIFT = 23  # lookahead column: 6 bits (C_max <= 64)
_MASK_SHIFT = 29

# Ring size for the per-position caches.  Nodes span at most max_word_len
# kana, so gathers reach back at most max_word_len rows; 8 covers the
# default max_word_len=5 and keeps the modulo a cheap bit-mask.
_RING = 8


def topk_stable(x: jnp.ndarray, k: int, mode: str = "argmax"):
    """Top-k with ``lax.top_k``'s EXACT semantics (desc values, ties in
    ascending-index order), selectable implementation.

    ``mode="argmax"`` (default): k unrolled argmax+mask passes, k cheap
    max-reduces in place of a full-width sort per frame at the decode
    scan's shape ([S, N·B] → k=10).  ``jnp.argmax`` returns the FIRST
    maximal index, which reproduces the frozen parity tie rule
    bit-for-bit (pinned by test_engine_parity and the tie test in
    test_kernels).

    ``mode="sort"``: plain ``lax.top_k``.
    """
    if mode == "sort":
        return jax.lax.top_k(x, k)
    S, M = x.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (S, M), 1)
    vals, idxs = [], []
    for _ in range(k):
        i = jnp.argmax(x, axis=1).astype(jnp.int32)
        vals.append(jnp.take_along_axis(x, i[:, None], axis=1)[:, 0])
        idxs.append(i)
        x = jnp.where(col == i[:, None], -jnp.inf, x)
    return jnp.stack(vals, axis=1), jnp.stack(idxs, axis=1)


def full_softmax_forward(
    params, config: Config, words, state, cand_words, precision="highest"
):
    """Batched reference forward: full log-softmax then candidate gather."""
    S, B = words.shape
    logp, state = step_logp(params, config, words.reshape(S * B), state, precision)
    lp = logp.reshape(S, B, -1)
    cand_logp = jnp.take_along_axis(
        lp, cand_words[:, None, :], axis=2
    )  # [S, B, C]
    return cand_logp, lp[:, :, EOS_ID], state


def make_full_softmax_forward(config: Config, precision="highest") -> ForwardFn:
    """The jnp reference forward with the ``score_hidden`` hook attached.

    ``score_hidden(params, h_top [S, B, H], cand_words [S, C])`` scores a
    candidate table directly from an already-computed top hidden state —
    used by multi-root ``decode_long`` seeding, where chunk k+1 re-scores
    its own lookahead against chunk k's exported boundary beams (no LSTM
    step: the beams' post-word states are the seeds).
    """
    from jlm.models.lstm import head_logits

    def forward(params, words, state, cand_words):
        return full_softmax_forward(
            params, config, words, state, cand_words, precision=precision
        )

    def score_hidden(params, h_top, cand_words):
        S, B, H = h_top.shape
        logits = head_logits(
            params, config, h_top.reshape(S * B, H), precision
        ).astype(jnp.float32)
        m = jnp.max(logits, axis=-1, keepdims=True)
        logp = logits - (m + jnp.log(
            jnp.sum(jnp.exp(logits - m), axis=-1, keepdims=True)))
        lp = logp.reshape(S, B, -1)
        return jnp.take_along_axis(lp, cand_words[:, None, :], axis=2)

    forward.score_hidden = score_hidden
    return forward


def build_decode_head(params, config: Config, compute_dtype=jnp.float32):
    """One-time decode-side head prep: transposed columns + cast weights.

    Returns a dict stashed under ``params["_decode"]``:

    - ``head_T [V, H]``: every word's output column as a ROW (zero-padded
      to H for D-softmax blocks, at the right offset for disjoint mode),
      in ``compute_dtype``.  Candidate logits then come from a fast
      major-axis row gather + einsum instead of a strided column gather
      from the ``[H, V]`` (or per-block) weights.
    - ``bias [V]`` fp32: matching output biases.
    - ``head_c``: the projection head with fp weights pre-cast to
      ``compute_dtype`` (int8 quant dicts pass through — the kernel
      dequantizes its tiles), so the lse kernel reads half the bytes in
      bf16 speed mode.
    """
    head = params["head"]
    H = config.hidden_size

    def deq(W):
        if isinstance(W, dict):
            return W["q"].astype(jnp.float32) * W["scale"][None, :]
        return W.astype(jnp.float32)

    def cast_w(W):
        if isinstance(W, dict):
            return W  # int8 stays int8: the kernel dequantizes its tiles
        return W.astype(compute_dtype)

    # Pre-cast (and pre-dequantize) LSTM weights for the decode cell: done
    # once per decode-head build instead of per frame inside the scan.
    def deq_full(W):
        if isinstance(W, dict):
            return W["q"].astype(jnp.float32) * W["scale"][None, :]
        return W
    lstm_c = [
        {
            "W": deq_full(layer["W"]).astype(compute_dtype),
            "b": layer["b"].astype(jnp.float32),
        }
        for layer in params["lstm"]
    ]

    if "blocks" in head:
        ds = config.dsoftmax
        rows_all, bias_all, blocks_c = [], [], []
        offset = 0
        for k, blk in enumerate(head["blocks"]):
            d = ds.block_dims[k]
            rows = deq(blk["W"]).T  # [s_k, d]
            if ds.mode == "prefix":
                rows = jnp.pad(rows, ((0, 0), (0, H - d)))
            else:
                rows = jnp.pad(rows, ((0, 0), (offset, H - offset - d)))
                offset += d
            rows_all.append(rows)
            bias_all.append(blk["b"].astype(jnp.float32))
            blocks_c.append({"W": cast_w(blk["W"]), "b": blk["b"]})
        head_T = jnp.concatenate(rows_all, axis=0).astype(compute_dtype)
        bias = jnp.concatenate(bias_all, axis=0)
        head_c = {"blocks": blocks_c}
    else:
        head_T = deq(head["W"]).T.astype(compute_dtype)  # [V, H]
        bias = head["b"].astype(jnp.float32)
        head_c = {"W": cast_w(head["W"]), "b": head["b"]}
    return {"head_T": head_T, "bias": bias, "head_c": head_c,
            "lstm_c": lstm_c}


def candidate_dot(h3, cols, bias, compute_dtype=jnp.float32):
    """Per-sentence candidate logits ``[S, B, C1]`` fp32, bias added.

    ``h3 [S, B, H]`` against each sentence's own pre-gathered candidate
    columns ``cols [S, C1, H]``: a batched einsum that XLA hands to a
    batched GEMM.  ``compute_dtype`` operands, fp32 accumulator; fp32 runs
    at ``Precision.HIGHEST`` (no TF32 in parity mode).
    """
    precision = (jax.lax.Precision.HIGHEST if compute_dtype == jnp.float32
                 else jax.lax.Precision.DEFAULT)
    return jnp.einsum(
        "sbh,sch->sbc", h3.astype(compute_dtype), cols.astype(compute_dtype),
        precision=precision, preferred_element_type=jnp.float32,
    ) + bias.astype(jnp.float32)[:, None, :]


def make_pallas_forward(
    config: Config,
    compute_dtype=None,
    interpret: bool = False,
    int8_mxu: Optional[bool] = None,
    **launch,
) -> ForwardFn:
    """Batched ForwardFn whose head normaliser is the Pallas kernel.

    The kernel (:func:`jlm.ops.project.project_lse`) computes the global
    logsumexp over vocab tiles with in-kernel int8 dequant, never writing
    ``[S·B, V]`` logits to device memory.  The LSTM cell and the candidate
    scoring are plain XLA (:func:`jlm.models.lstm.cell`,
    :func:`candidate_dot`); candidate columns come from pre-gathered
    transposed-head rows via the ``prepare`` hook (one row gather per
    decode call, outside the scan).  ``interpret=True`` runs the kernel in
    the Pallas interpreter (CPU tests); ``launch`` overrides the kernel's
    tile choice.
    """
    from jlm.models.lstm import cell, embed
    from jlm.ops.project import project_lse

    if compute_dtype is None:
        compute_dtype = jnp.float32
    if int8_mxu is None:
        int8_mxu = config.int8_mxu
    lse_kw = dict(compute_dtype=compute_dtype, interpret=interpret,
                  int8_mxu=int8_mxu, **launch)

    def prepare(params, look_w):
        """[S, T1, C] ids -> (cols [S, T1, C+1, H], bias [S, T1, C+1]).

        EOS is appended as the last column so the frame step prices the
        final-rescore logit with the same einsum.
        """
        dec = params["_decode"]
        S, T1, C = look_w.shape
        ids = jnp.concatenate(
            [look_w, jnp.full((S, T1, 1), EOS_ID, jnp.int32)], axis=2
        )
        cols = jnp.take(dec["head_T"], ids, axis=0)  # [S, T1, C+1, H]
        bias = jnp.take(dec["bias"], ids)  # [S, T1, C+1]
        return {"cols": cols, "bias": bias}

    def forward(params, words, state, payload):
        S, B = words.shape
        x = embed(params, words.reshape(S * B))
        c, h = state
        new_c, new_h = [], []
        for l, layer in enumerate(params["_decode"]["lstm_c"]):
            # c'/h' come back in compute dtype, the ring's cache dtype in
            # speed mode
            c_l, h_l = cell(x, h[l], c[l], layer["W"], layer["b"],
                            config.forget_bias, compute_dtype)
            new_c.append(c_l)
            new_h.append(h_l)
            x = h_l
        h_top = x  # [S*B, H] compute dtype
        state = (jnp.stack(new_c), jnp.stack(new_h))
        lse = project_lse(h_top, params["_decode"]["head_c"], config,
                          **lse_kw)  # [S*B, 1]
        raw = candidate_dot(h_top.reshape(S, B, -1), payload["cols"],
                            payload["bias"], compute_dtype)  # [S, B, C+1]
        logp = raw - lse.reshape(S, B, 1)
        return logp[:, :, :-1], logp[:, :, -1], state

    def score_hidden(params, h_top, payload):
        """Candidate logp from an existing top hidden state (no LSTM step).

        Multi-root ``decode_long`` seeding: ``h_top [S, B, H]`` are chunk
        k's exported boundary-beam hidden states; ``payload`` is the
        prepare-hook slice for the seeded position.
        """
        S, B, H = h_top.shape
        raw = candidate_dot(h_top, payload["cols"], payload["bias"],
                            compute_dtype)  # [S, B, C+1]
        lse = project_lse(h_top.reshape(S * B, H),
                          params["_decode"]["head_c"], config, **lse_kw)
        logp = raw - lse.reshape(S, B, 1)
        return logp[:, :, :-1]

    forward.prepare = prepare
    forward.score_hidden = score_hidden
    forward.compute_dtype = compute_dtype
    return forward


def _candidate_logits_batched(head, config: Config, h_flat, ids, S, B):
    """Raw logits for per-sentence candidate columns: [S, B, C+1].

    Gathers the needed output-matrix columns (O(C·H) per sentence instead
    of O(V·H)) with int8 dequant on the gathered columns only.  Kept as the
    jnp reference for the prepare-hook fast path, which hoists the strided
    column gathers out of the scan via ``head_T`` row gathers.
    """
    C1 = ids.shape[1]
    if "blocks" in head:
        ds = config.dsoftmax
        sizes = np.asarray(ds.block_sizes, np.int64)
        bases = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        out = jnp.zeros((S, B, C1), jnp.float32)
        offset = 0
        h3 = h_flat.reshape(S, B, -1)
        for k, blk in enumerate(head["blocks"]):
            d = ds.block_dims[k]
            hs = h3[..., :d] if ds.mode == "prefix" else h3[..., offset:offset + d]
            if ds.mode == "disjoint":
                offset += d
            in_blk = (ids >= bases[k]) & (ids < bases[k] + sizes[k])
            local = jnp.clip(ids - bases[k], 0, sizes[k] - 1)
            W = blk["W"]
            if isinstance(W, dict):
                cols = jnp.take(W["q"], local, axis=1).astype(jnp.float32)
                cols = cols * jnp.take(W["scale"], local)[:, None, :]
            else:
                cols = jnp.take(W, local, axis=1)  # [d, S, C1]
            cols = jnp.moveaxis(cols, 0, -1)  # [S, C1, d]
            vals = jnp.einsum("sbd,scd->sbc", hs, cols) + jnp.take(blk["b"], local)[:, None, :]
            out = jnp.where(in_blk[:, None, :], vals, out)
        return out
    W = head["W"]
    if isinstance(W, dict):
        cols = jnp.take(W["q"], ids, axis=1).astype(jnp.float32)  # [H, S, C1]
        cols = cols * jnp.take(W["scale"], ids)[None, :, :]
    else:
        cols = jnp.take(W, ids, axis=1)  # [H, S, C1]
    cols = jnp.moveaxis(cols, 0, -1)  # [S, C1, H]
    h3 = h_flat.reshape(S, B, -1)
    return jnp.einsum("sbh,sch->sbc", h3, cols) + jnp.take(head["b"], ids)[:, None, :]


def pack_lattice_batch(lattices: List[Lattice]) -> Tuple[np.ndarray, np.ndarray]:
    """Bit-pack node tensors of a lattice batch into one int32 array.

    Layout per node: ``word | start<<17 | cand_idx<<23 | mask<<29`` — a
    single ``[S, T_max, N]`` upload instead of six tensors (one transfer
    per chunk; SURVEY.md §9.3.1).
    """
    words = np.stack([l.node_word for l in lattices]).astype(np.int64)
    starts = np.stack([l.node_start for l in lattices]).astype(np.int64)
    cidx = np.stack([l.node_cand_idx for l in lattices]).astype(np.int64)
    mask = np.stack([l.node_mask for l in lattices]).astype(np.int64)
    assert words.max(initial=0) < (1 << _WORD_BITS), "vocab too large to pack"
    assert starts.max(initial=0) < 64 and cidx.max(initial=0) < 64
    packed = words | (starts << _START_SHIFT) | (cidx << _CIDX_SHIFT) | (
        mask << _MASK_SHIFT
    )
    lengths = np.asarray([l.length for l in lattices], np.int32)
    return packed.astype(np.int32), lengths


def _unpack_lattice(packed, config: Config):
    """Device-side unpack + lookahead-table reconstruction (one scatter)."""
    T_max = packed.shape[1]
    C = config.max_lookahead
    word = packed & ((1 << _WORD_BITS) - 1)
    start = (packed >> _START_SHIFT) & 0x3F
    cidx = (packed >> _CIDX_SHIFT) & 0x3F
    mask = ((packed >> _MASK_SHIFT) & 1) == 1

    S = packed.shape[0]
    flat_pos = start * C + cidx
    oob = (T_max + 1) * C  # out-of-bounds => dropped by the scatter
    flat_pos = jnp.where(mask, flat_pos, oob)
    s_idx = jnp.broadcast_to(
        jnp.arange(S)[:, None, None], packed.shape
    )
    look_flat = jnp.full((S, (T_max + 1) * C), -1, jnp.int32)
    look_flat = look_flat.at[s_idx, flat_pos].set(word, mode="drop")
    look_w = look_flat.reshape(S, T_max + 1, C)
    look_m = look_w >= 0
    look_w = jnp.maximum(look_w, 0)
    return word, start, cidx, mask, look_w, look_m


def _decode_scan(
    params,
    packed,  # int32 [S, T_max, N] (pack_lattice_batch)
    lengths,  # int32 [S]
    root=None,  # optional carried beam from a previous chunk (chain mode):
    #   {"words" [S, B], "score" [S, B], "c"/"h" [L, S*B, H]}
    seed=None,  # optional multi-root seed rows from a previous chunk:
    #   {"score" [S, M, B], "c"/"h" [S, M, B, L, H]} — row i seeds local
    #   position i+1 (decode_long overlap-save; requires seed_m = M)
    *,
    config: Config,
    forward_fn: ForwardFn,
    chain: bool = False,
    seed_m: int = 0,
    export_rings: bool = False,
    walk: bool = True,
):
    # T_max here is the BATCH's bucketed time bound (<= config.max_kana_len):
    # short inputs scan far fewer frames than the global static maximum.
    S, T_max, N = packed.shape
    B = config.beam_pad
    C = config.max_lookahead
    L, H = config.num_layers, config.hidden_size
    R = _RING
    assert config.max_word_len < R, (
        f"max_word_len={config.max_word_len} must be < ring size {R}"
    )
    assert seed_m == 0 or (seed is not None and seed_m == config.max_word_len)
    NEG = jnp.float32(-1e30)

    word, start, cidx, mask, look_w, look_m = _unpack_lattice(packed, config)
    # gather_mode="onehot": BOTH per-frame selections run as exact
    # 0/1-matrix matmuls instead of XLA dynamic gathers.  The candidate
    # cache then stores [S, R, C, B] so the (ring, cand) onehot contracts
    # its leading R·C axis directly.
    onehot_sel = config.gather_mode == "onehot"

    # Per-position payload for the forward (default: the candidate ids).
    prepare = getattr(forward_fn, "prepare", None)
    payload = prepare(params, look_w) if prepare is not None else look_w

    def state_to_cache(c):  # [L, S*B, H] -> [S, B, L, H]
        return jnp.moveaxis(c.reshape(L, S, B, H), 0, 2)

    def cache_to_state(g):  # [S, B, L, H] -> [L, S*B, H]
        return jnp.moveaxis(g, 2, 0).reshape(L, S * B, H)

    # Speed mode stores the state ring buffers in bf16: they are the scan's
    # largest carries ([S, R, B, L, H] x2 — 64 MB each at flagship dims) and
    # feed matmuls that already run bf16; halving their memory traffic cuts
    # the scan-framework overhead.  Parity mode (fp32 forwards) keeps fp32.
    cache_dtype = (
        jnp.bfloat16
        if getattr(forward_fn, "compute_dtype", None) == jnp.bfloat16
        else jnp.float32
    )

    if seed_m == 0:
        # --- position-0 root beam ---
        # Default: path 0 alive, fed <eos> from zero state.  Chain mode
        # feeds a carried beam from the previous chunk (legacy single-root
        # chaining, still used by forwards without a score_hidden hook —
        # forces a word boundary at the cut).
        payload_0 = jax.tree.map(lambda a: a[:, 0], payload)
        if root is None:
            c0 = jnp.zeros((L, S * B, H), jnp.float32)
            h0 = jnp.zeros((L, S * B, H), jnp.float32)
            words0 = jnp.full((S, B), EOS_ID, jnp.int32)
            score0 = jnp.full((S, B), NEG).at[:, 0].set(0.0)
        else:
            c0, h0 = root["c"], root["h"]
            words0 = root["words"]
            score0 = root["score"]
        cand0, _eos0, (c1, h1) = forward_fn(
            params, words0, (c0, h0), payload_0
        )
        cand0 = jnp.where(look_m[:, 0][:, None, :], cand0, NEG)
        cand0 = jnp.where(score0[:, :, None] > NEG / 2, cand0, NEG)

        # Ring caches indexed [S, pos % R, ...]; states stored as
        # [S, R, B, L, H] so a single flat (ring_row*B + path)
        # take_along_axis gathers survivors.  Only the last max_word_len
        # rows are ever read, so stale rows beyond the span can never leak
        # (masked extensions aside, starts always satisfy
        # pos - start <= max_word_len < R).
        score = jnp.full((S, R, B), NEG).at[:, 0].set(score0)
        cand_cache = (
            jnp.zeros((S, R, C, B)).at[:, 0].set(jnp.swapaxes(cand0, 1, 2))
            if onehot_sel else
            jnp.zeros((S, R, B, C)).at[:, 0].set(cand0)
        )
        c_cache = jnp.zeros((S, R, B, L, H), cache_dtype).at[:, 0].set(
            state_to_cache(c1).astype(cache_dtype)
        )
        h_cache = jnp.zeros((S, R, B, L, H), cache_dtype).at[:, 0].set(
            state_to_cache(h1).astype(cache_dtype)
        )
        words_last = (
            jnp.broadcast_to(words0, (S, B)) if chain else None
        )
    else:
        # --- multi-root seeding (decode_long overlap-save, SURVEY.md §4.5
        # follow-up): local positions 1..M carry the previous chunk's
        # beams at global positions cut-M+1..cut — scores, LSTM states,
        # and freshly scored candidate rows for THIS chunk's lookahead
        # (words may start in the overlap and end beyond the cut, so no
        # word boundary is forced).  Scored via the forward's
        # ``score_hidden`` hook from the seeds' top-layer hidden states.
        M = seed_m
        score_hidden = forward_fn.score_hidden
        htop_seed = seed["h"][..., L - 1, :]  # [S, M, B, H]
        payload_seed = jax.tree.map(
            lambda a: a[:, 1:M + 1].reshape((S * M,) + a.shape[2:]), payload
        )
        cand_seed = score_hidden(
            params, htop_seed.reshape(S * M, B, H), payload_seed
        ).reshape(S, M, B, C)  # [S, M, B, C]
        cand_seed = jnp.where(
            look_m[:, 1:M + 1][:, :, None, :], cand_seed, NEG
        )
        cand_seed = jnp.where(
            seed["score"][:, :, :, None] > NEG / 2, cand_seed, NEG
        )
        score = jnp.full((S, R, B), NEG).at[:, 1:M + 1].set(seed["score"])
        cand_cache = (
            jnp.zeros((S, R, C, B)).at[:, 1:M + 1].set(
                jnp.swapaxes(cand_seed, 2, 3))
            if onehot_sel else
            jnp.zeros((S, R, B, C)).at[:, 1:M + 1].set(cand_seed)
        )
        c_cache = jnp.zeros((S, R, B, L, H), cache_dtype).at[:, 1:M + 1].set(
            seed["c"].astype(cache_dtype)
        )
        h_cache = jnp.zeros((S, R, B, L, H), cache_dtype).at[:, 1:M + 1].set(
            seed["h"].astype(cache_dtype)
        )
        words_last = None
    final = jnp.full((S, B), NEG)
    payload_xs = jax.tree.map(
        lambda a: jnp.moveaxis(a[:, seed_m + 1:], 1, 0), payload
    )

    def step(carry, xs):
        score, cand_cache, c_cache, h_cache, final = carry[:5]
        pos, words_t, starts_t, mask_t, cidx_t, look_m_t, payload_t = xs
        # words_t/starts_t/... [S, N]; look_m_t [S, C]
        ring_t = starts_t & (R - 1)  # ring row of each node's start

        # Extension scores [S, N, B]: cached logp of each node's word from
        # each path of the beam at the node's start position.
        if onehot_sel:
            # exact 0/1 selection matmuls (each output sums ONE nonzero
            # product)
            rc = ring_t * C + cidx_t  # [S, N]
            oh = (
                rc[:, :, None]
                == jnp.arange(R * C, dtype=jnp.int32)[None, None, :]
            ).astype(jnp.float32)  # [S, N, R·C]
            # HIGHEST: a default-precision fp32 matmul may round its
            # operands (TF32 on the GPU) — the 0/1 selection must return
            # the cached fp32 value bit-faithfully (the CPU is exact
            # either way, so only an on-device run can catch it)
            ext_logp = jnp.einsum(
                "snr,srb->snb", oh, cand_cache.reshape(S, R * C, B),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            oh_r = (
                ring_t[:, :, None]
                == jnp.arange(R, dtype=jnp.int32)[None, None, :]
            ).astype(jnp.float32)  # [S, N, R]
            sc_n = jnp.einsum(
                "snr,srb->snb", oh_r, score,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            ext = sc_n + ext_logp
        else:
            # ONE fused flat gather of [S, N·B] elements — composing two
            # take_along_axis calls would materialize an [S, N, B, C]
            # (MBs) intermediate per step only to keep one C-column of it.
            flat_idx = (
                ring_t[:, :, None] * (B * C)
                + jnp.arange(B, dtype=jnp.int32)[None, None, :] * C
                + cidx_t[:, :, None]
            )  # [S, N, B]
            ext_logp = jnp.take_along_axis(
                cand_cache.reshape(S, R * B * C),
                flat_idx.reshape(S, N * B),
                axis=1,
            ).reshape(S, N, B)
            ext = jnp.take_along_axis(
                score, ring_t[:, :, None], axis=1
            ) + ext_logp
        ext = jnp.where(mask_t[:, :, None], ext, NEG)

        # Per-sentence stable top-k over the flat (node-major, path-minor)
        # enumeration; padding slots beyond beam_width stay dead so the
        # beam is exactly the reference's width (parity rule).
        top_scores, top_idx = topk_stable(
            ext.reshape(S, N * B), B, config.topk_mode
        )
        top_scores = jnp.where(jnp.arange(B) < config.beam_width, top_scores, NEG)
        sel_n = top_idx // B
        sel_p = top_idx % B
        src_pos = jnp.take_along_axis(starts_t, sel_n, axis=1)  # [S, B]
        new_words = jnp.take_along_axis(words_t, sel_n, axis=1)  # [S, B]

        # Gather surviving LSTM states: ONE flat (ring*B + path) index,
        # either as a dynamic gather or as an exact 0/1 selection matmul
        # (config.gather_mode: a [B, R·B]x[R·B, L·H] einsum per sentence).
        flat2 = (src_pos & (R - 1)) * B + sel_p  # [S, B]
        if config.gather_mode == "onehot":
            sel1h = (
                flat2[:, :, None]
                == jnp.arange(R * B, dtype=jnp.int32)[None, None, :]
            ).astype(cache_dtype)  # [S, B, R*B]
            # HIGHEST for the same reason as the ext selection: in fp32
            # parity mode the cache is fp32 and a default-precision matmul
            # would round it to TF32 (bf16 speed mode is exact either way
            # — the cached values are already bf16)
            csel = jnp.einsum(
                "sbr,srx->sbx", sel1h,
                c_cache.reshape(S, R * B, L * H),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            ).astype(cache_dtype).reshape(S, B, L, H)
            hsel = jnp.einsum(
                "sbr,srx->sbx", sel1h,
                h_cache.reshape(S, R * B, L * H),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            ).astype(cache_dtype).reshape(S, B, L, H)
        else:
            flat = flat2[:, :, None, None]  # [S, B, 1, 1]
            csel = jnp.take_along_axis(
                c_cache.reshape(S, R * B, L, H), flat, axis=1
            )
            hsel = jnp.take_along_axis(
                h_cache.reshape(S, R * B, L, H), flat, axis=1
            )

        # One batched LM forward over all S·B beam rows.  States pass in
        # the CACHE dtype (bf16 in speed mode): the forward casts to its
        # compute dtype anyway, and an fp32 round trip would only write
        # casts — value-identical because the values CAME from bf16
        # storage.
        cand_new, eos_new, (c_new, h_new) = forward_fn(
            params, new_words,
            (cache_to_state(csel), cache_to_state(hsel)),
            payload_t,
        )
        cand_new = jnp.where(look_m_t[:, None, :], cand_new, NEG)
        alive = top_scores > NEG / 2
        cand_new = jnp.where(alive[:, :, None], cand_new, NEG)

        # Final <eos> rescoring accumulates in-scan at each sentence's true
        # length (SURVEY.md §4.6) — the ring may overwrite older rows later.
        final = jnp.where(
            (pos == lengths)[:, None], top_scores + eos_new, final
        )

        ring_w = pos & (R - 1)
        score = score.at[:, ring_w].set(top_scores)
        cand_cache = cand_cache.at[:, ring_w].set(
            jnp.swapaxes(cand_new, 1, 2) if onehot_sel else cand_new
        )
        c_cache = c_cache.at[:, ring_w].set(
            state_to_cache(c_new).astype(cache_dtype)
        )
        h_cache = h_cache.at[:, ring_w].set(
            state_to_cache(h_new).astype(cache_dtype)
        )
        carry_out = (score, cand_cache, c_cache, h_cache, final)
        if chain:
            carry_out = carry_out + (new_words,)
        return carry_out, (src_pos, sel_p, sel_n)

    xs = (
        jnp.arange(seed_m + 1, T_max + 1),
        jnp.moveaxis(word[:, seed_m:], 1, 0),  # [T_max - seed_m, S, N]
        jnp.moveaxis(start[:, seed_m:], 1, 0),
        jnp.moveaxis(mask[:, seed_m:], 1, 0),
        jnp.moveaxis(cidx[:, seed_m:], 1, 0),
        jnp.moveaxis(look_m[:, seed_m + 1:], 1, 0),  # [T_max - seed_m, S, C]
        payload_xs,
    )
    T_scan = T_max - seed_m
    carry = (score, cand_cache, c_cache, h_cache, final)
    unroll = max(1, config.scan_unroll)
    if chain:
        carry = carry + (words_last,)
        (score, _, c_cache, h_cache, final, last_words), bp = jax.lax.scan(
            step, carry, xs, unroll=unroll
        )
    else:
        (score, _, c_cache, h_cache, final), bp = jax.lax.scan(
            step, carry, xs, unroll=unroll
        )
    bp_src, bp_p, bp_n = bp  # each [T_scan, S, B]
    bp_src_s = jnp.moveaxis(bp_src, 1, 0)  # [S, T_scan, B]
    bp_p_s = jnp.moveaxis(bp_p, 1, 0)
    bp_n_s = jnp.moveaxis(bp_n, 1, 0)

    out = {}
    if walk:
        # Device-side backtracking for the top-K beams; only compact paths
        # are fetched.  Walks stop at seed_m: a seeded row belongs to
        # the previous chunk, whose own backpointers continue the path.
        if chain:
            # chain mode walks EVERY beam slot: the host only learns which
            # boundary beams matter after later chunks are decoded.
            K = B
            top_beams = jnp.broadcast_to(
                jnp.arange(B, dtype=jnp.int32), (S, B)
            )
            top_vals = final
        else:
            K = min(config.n_best_max, B)
            top_vals, top_beams = jax.lax.top_k(final, K)  # [S, K]

        def wstep(carry, _):
            pos, bi = carry  # [S, K] each
            p = jnp.maximum(pos - 1 - seed_m, 0)  # bp row of frame pos
            valid = pos > seed_m

            def gather_bp(bp):  # bp [S, T_scan, B] -> [S, K]
                rows = jnp.take_along_axis(bp, p[:, :, None], axis=1)
                return jnp.take_along_axis(rows, bi[:, :, None], axis=2)[..., 0]

            node = gather_bp(bp_n_s)
            out_s = jnp.where(
                valid[:, :, None],
                jnp.stack([pos, node], axis=-1),
                jnp.zeros((S, K, 2), jnp.int32),
            )
            nxt = (
                jnp.where(valid, gather_bp(bp_src_s), pos),
                jnp.where(valid, gather_bp(bp_p_s), bi),
            )
            return nxt, out_s

        init = (jnp.broadcast_to(lengths[:, None], (S, K)), top_beams)
        (root_pos, root_beam), paths = jax.lax.scan(
            wstep, init, None, length=T_scan
        )
        paths = jnp.moveaxis(paths, 0, 2)  # [S, K, T_scan, 2], end-to-start
        out.update({
            "final_topk": top_vals,  # [S, K]
            "paths": paths.astype(jnp.int16),  # small ints: cheap to fetch
            # where each walked beam STOPPED: position 0 (chunk root) or a
            # seeded row 1..M — (root_pos, root_beam) is the entry point
            # into the previous chunk's backpointers for path stitching.
            "root_beam": root_beam,  # [S, K]
            "root_pos": root_pos,  # [S, K]
            # One host payload: every field the host needs, packed into
            # a single int32 array, so a chunk costs one device->host
            # transfer.
            "blob": jnp.concatenate(
                [
                    jax.lax.bitcast_convert_type(top_vals, jnp.int32)
                    [:, :, None],
                    root_beam[:, :, None],
                    root_pos[:, :, None],
                    paths.astype(jnp.int32).reshape(S, K, 2 * T_scan),
                ],
                axis=2,
            ).reshape(S, K * (3 + 2 * T_scan)),
        })
    else:
        # No device walk: the host stitches multi-chunk paths from the raw
        # backpointers (decode_long is per-sentence — the arrays are tiny).
        out["bp"] = (
            bp_src_s.astype(jnp.int16),
            bp_p_s.astype(jnp.int16),
            bp_n_s.astype(jnp.int16),
        )
    if export_rings:
        # Multi-root boundary export: the last max_word_len positions'
        # beams (scores WITHOUT <eos>, full LSTM states) — already resident
        # in the ring; rows T-M+1..T never collide since M < R.
        M = config.max_word_len
        rows = [(T_max - M + 1 + i) & (R - 1) for i in range(M)]
        out["rings"] = {
            "score": jnp.stack([score[:, r] for r in rows], axis=1),
            "c": jnp.stack(
                [c_cache[:, r] for r in rows], axis=1
            ).astype(jnp.float32),  # [S, M, B, L, H]
            "h": jnp.stack(
                [h_cache[:, r] for r in rows], axis=1
            ).astype(jnp.float32),
        }
    if chain:
        # Boundary beam for the next chunk (legacy single-root chaining):
        # ring row T_max (requires every length == T_max, asserted
        # host-side) — scores WITHOUT the <eos> rescore, per-beam LSTM
        # states, last words, and each beam's root slot for stitching.
        ring_T = T_max & (R - 1)
        out["chain"] = {
            "words": last_words,
            "score": score[:, ring_T],
            "c": cache_to_state(c_cache[:, ring_T]).astype(jnp.float32),
            "h": cache_to_state(h_cache[:, ring_T]).astype(jnp.float32),
        }
    return out


class BeamDecoder:
    """Host wrapper: lattice build + pack → one device call → surfaces.

    Mirrors the reference's ``Decoder`` API (``decode(kana, top_n)``) while
    keeping every per-frame operation on device; ``decode_batch`` is the
    streaming batched entry (BASELINE config 5's per-chip unit) and
    ``decode_stream`` pipelines many chunks through the device without
    waiting for each chunk's results (hides the host round trip).
    """

    def __init__(
        self,
        params,
        lexicon: Lexicon,
        vocab: Vocab,
        config: Config,
        forward_fn: Optional[ForwardFn] = None,
        precision: str = "highest",
        use_native: Optional[bool] = None,
    ):
        # Materialize params on device ONCE — passing host numpy arrays into
        # the jitted call would re-upload the full weight set (~150 MB at
        # flagship dims) on every decode_batch.
        self.params = dict(jax.tree.map(jnp.asarray, params))
        self.lexicon = lexicon
        self.vocab = vocab
        self.config = config
        # Host-side lattice building: native C++ builder when the toolchain
        # is available (bit-identical output, ~100x less host time), else
        # the pure-Python path.
        self._native = None
        if use_native is not False:
            from jlm import native as _native_mod

            if _native_mod.available():
                self._native = _native_mod.NativeLatticeBuilder(lexicon, config)
            elif use_native is True:
                raise RuntimeError("native lattice builder requested but unavailable")
        if forward_fn is None:
            if use_kernels(precision):
                # Speed mode on the GPU: Pallas head (in-kernel int8
                # dequant + online logsumexp, bf16 tensor cores) +
                # pre-gathered candidate columns.
                fwd = make_pallas_forward(config, compute_dtype=jnp.bfloat16)
            else:
                # Parity mode (or CPU): fp32 jnp head, oracle-exact.
                fwd = make_full_softmax_forward(config, precision=precision)
        else:
            fwd = forward_fn
        # Forwards with a prepare hook need the one-time transposed-head
        # prep (decode-side only; never touches training checkpoints).
        # sharded forwards need S divisible by the data-mesh axis
        self._min_batch = int(getattr(fwd, "min_batch", 1))
        # Multi-PROCESS SPMD decode (BASELINE config 5: streaming batched
        # conversion over a multi-host pod slice): a sharded forward carries
        # its mesh; when the mesh spans processes, lattice uploads become
        # global replicated arrays (every process builds identical lattices
        # — deterministic packers) and result fetches allgather the
        # data-sharded outputs.
        self._mesh = getattr(fwd, "mesh", None)
        if getattr(fwd, "prepare", None) is not None and "_decode" not in self.params:
            cd = getattr(fwd, "compute_dtype", jnp.float32)
            self.params["_decode"] = build_decode_head(self.params, config, cd)
        # Sharded forwards pin the decode-param placement themselves (e.g.
        # head columns over ``vocab``, candidate table replicated).
        place = getattr(fwd, "place_params", None)
        if place is not None:
            self.params = place(self.params)
        self._fwd = fwd
        self._decode_jit = jax.jit(
            functools.partial(_decode_scan, config=config, forward_fn=fwd)
        )
        # chain-mode variant for long inputs (decode_long): exports the
        # boundary beam and walks every beam slot back to its root.
        self._decode_jit_chain = jax.jit(
            functools.partial(_decode_scan, config=config, forward_fn=fwd,
                              chain=True)
        )
        # multi-root (overlap-save) decode_long variants, built lazily:
        # first/mid chunks export ring seeds + raw backpointers; the last
        # chunk walks on device, stopping at seeded rows.
        self._mr_jits: Dict[str, Any] = {}

    def results_from_packed(
        self, kana: str, packed_row: np.ndarray, finals: np.ndarray,
        paths: np.ndarray, n_best: int,
    ) -> List[DecodeResult]:
        """Materialize surfaces from device-walked paths for one sentence.

        Node identity lives in the packed tensor: word id + start position
        recover the display (``<unk>`` fallback nodes surface their kana
        substring), so no host-side lattice objects are needed.
        """
        assert n_best <= self.config.n_best_max, (
            f"n_best={n_best} exceeds config.n_best_max="
            f"{self.config.n_best_max}"
        )
        results = []
        for k in range(min(n_best, len(finals))):
            if finals[k] <= -1e29:
                continue
            segs = self._segments(kana, packed_row, paths[k])
            results.append(
                DecodeResult(
                    surface="".join(d for d, _ in segs),
                    score=float(finals[k]),
                    segments=segs,
                )
            )
        return results

    def _segments(
        self, kana: str, packed_row: np.ndarray, path: np.ndarray
    ) -> List[Tuple[str, int]]:
        """Decode one device-walked path (end-to-start) into segments."""
        segs: List[Tuple[str, int]] = []
        for pos, n in path:
            if pos <= 0:
                break
            node = int(packed_row[int(pos) - 1, int(n)])
            word = node & ((1 << _WORD_BITS) - 1)
            start = (node >> _START_SHIFT) & 0x3F
            display = (
                kana[start:int(pos)] if word == UNK_ID
                else self.vocab.display(word)
            )
            segs.append((display, word))
        segs.reverse()
        return segs

    @staticmethod
    def _bucket(n: int) -> int:
        """Pad batch sizes to power-of-two buckets.

        Each distinct batch shape costs a fresh XLA compile; bucketing
        bounds the number of compiled programs a serving process ever
        sees.
        """
        b = 1
        while b < n:
            b *= 2
        return b

    def _t_bucket(self, n: int) -> int:
        """Pad frame counts to ``config.t_bucket_multiple`` (min 4).

        Finer than the power-of-two sentence-batch buckets: device time is
        LINEAR in the scanned frame count (each frame is a fixed-cost step
        at a given S), so rounding a max length of 9 up to 16 wastes ~40%
        of the scan.  Default multiple 1 = exact per-chunk max length;
        compile count stays bounded by the persistent cache.
        """
        m = max(1, self.config.t_bucket_multiple)
        return max(4, -(-n // m) * m)

    def _pack(self, kanas: List[str]):
        """Bucket-pad, build lattices (native if available), time-bucket."""
        n_real = len(kanas)
        pad = max(self._bucket(n_real), self._min_batch) - n_real
        kanas_padded = list(kanas) + [kanas[-1]] * pad
        if self._native is not None:
            packed, lengths = self._native.pack_batch(kanas_padded)
        else:
            lattices = [
                build_lattice(k, self.lexicon, self.vocab, self.config)
                for k in kanas_padded
            ]
            packed, lengths = pack_lattice_batch(lattices)
        # Time bucketing: scan only as many frames as the batch needs,
        # capped at max_kana_len — typical IME inputs are ~10 kana, a
        # 62-step scan would waste ~5x device time.
        t_bucket = min(self._t_bucket(int(lengths.max())), self.config.max_kana_len)
        return packed[:, :t_bucket], lengths

    def _upload(self, x: np.ndarray):
        """Host array -> device array (global replicated under a
        multi-process mesh: every process passes the same value)."""
        if self._mesh is None or jax.process_count() == 1:
            return jnp.asarray(x)
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = NamedSharding(self._mesh, P())
        return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])

    @staticmethod
    def _fetch(x) -> np.ndarray:
        """Device array -> host numpy; allgathers multi-process shards."""
        if hasattr(x, "is_fully_addressable") and not x.is_fully_addressable:
            from jax.experimental import multihost_utils

            x = multihost_utils.process_allgather(x, tiled=True)
        return np.asarray(x)

    def decode_batch_async(self, kanas: List[str]):
        """Dispatch one chunk; returns (packed, device outputs) unfetched.

        The device call is asynchronous — chaining several dispatches keeps
        the device busy while earlier chunks' results are fetched.
        """
        packed, lengths = self._pack(kanas)
        out = self._decode_jit(
            self.params, self._upload(packed), self._upload(lengths)
        )
        return packed, out

    def materialize(
        self, kanas: List[str], packed: np.ndarray, out, n_best: int = 1
    ) -> List[List[DecodeResult]]:
        """Fetch one dispatched chunk's results and build surfaces.

        Exactly ONE device→host transfer per chunk (the packed ``blob``).
        """
        S, K, T_scan, _ = out["paths"].shape
        blob = self._fetch(out["blob"]).reshape(S, K, 3 + 2 * T_scan)
        finals = blob[:, :, 0].view(np.float32)
        paths = blob[:, :, 3:].reshape(S, K, T_scan, 2)
        # Vectorized path unpack: one numpy pass over the whole chunk.
        n = len(kanas)
        pos = paths[:n, :, :, 0]  # [n, K, T]
        nodes = paths[:n, :, :, 1]
        s_idx = np.arange(n)[:, None, None]
        node_vals = packed[s_idx, np.maximum(pos - 1, 0), nodes]
        words = node_vals & ((1 << _WORD_BITS) - 1)
        starts = (node_vals >> _START_SHIFT) & 0x3F
        valid = pos > 0
        display = self.vocab.display
        results: List[List[DecodeResult]] = []
        for i in range(n):
            res_i: List[DecodeResult] = []
            for k in range(min(n_best, K)):
                if finals[i, k] <= -1e29:
                    continue
                segs: List[Tuple[str, int]] = []
                for t in range(T_scan):
                    if not valid[i, k, t]:
                        break
                    w = int(words[i, k, t])
                    segs.append((
                        kanas[i][starts[i, k, t]:pos[i, k, t]]
                        if w == UNK_ID else display(w),
                        w,
                    ))
                segs.reverse()
                res_i.append(DecodeResult(
                    surface="".join(d for d, _ in segs),
                    score=float(finals[i, k]),
                    segments=segs,
                ))
            results.append(res_i)
        return results

    def decode_batch(
        self, kanas: List[str], n_best: int = 1
    ) -> List[List[DecodeResult]]:
        T_c = self.config.max_kana_len
        if any(len(k) > T_c for k in kanas):
            # route over-length inputs through the chunked path; keep the
            # rest batched
            short = [k for k in kanas if len(k) <= T_c]
            by_kana: Dict[int, List[DecodeResult]] = {}
            if short:
                packed, out = self.decode_batch_async(short)
                for i, r in enumerate(self.materialize(short, packed, out, n_best)):
                    by_kana[i] = r
            results, si = [], 0
            for k in kanas:
                if len(k) > T_c:
                    results.append(self.decode_long(k, n_best))
                else:
                    results.append(by_kana[si])
                    si += 1
            return results
        packed, out = self.decode_batch_async(kanas)
        return self.materialize(kanas, packed, out, n_best)

    def decode_stream(
        self, kanas: List[str], chunk_size: int = 128, n_best: int = 1,
        sort_by_length: bool = True,
    ) -> List[List[DecodeResult]]:
        """Pipelined streaming conversion of a long sentence stream.

        All chunks are packed and DISPATCHED before any result is fetched:
        chunk k's device scan overlaps chunk k-1's result fetch and chunk
        k+1's host-side lattice build, so steady-state throughput is set by
        device time per chunk, not by the host round trip.

        ``sort_by_length`` groups similar-length sentences into the same
        chunk (results are returned in the ORIGINAL order regardless): a
        chunk's scan runs ``t_bucket(max length in chunk)`` frames, so
        mixing a 14-kana sentence into a chunk of 8-kana ones makes every
        sentence pay 16 frames.  Length-grouped chunks cut total scanned
        frames by ~35% on IME-typical length distributions — the standard
        throughput-serving batching move; per-sentence results are
        identical either way (each lattice is independent).
        """
        if sort_by_length and len(kanas) > 1:
            order = sorted(range(len(kanas)), key=lambda i: len(kanas[i]))
        else:
            order = list(range(len(kanas)))
        chunks = [
            order[i:i + chunk_size] for i in range(0, len(order), chunk_size)
        ]
        inflight = [
            ([kanas[i] for i in idxs], idxs) for idxs in chunks
        ]
        inflight = [
            (c, idxs, *self.decode_batch_async(c)) for c, idxs in inflight
        ]
        results: List[Optional[List[DecodeResult]]] = [None] * len(kanas)
        for c, idxs, packed, out in inflight:
            for i, r in zip(idxs, self.materialize(c, packed, out, n_best)):
                results[i] = r
        return results

    def decode_long(self, kana: str, n_best: int = 1) -> List[DecodeResult]:
        """Decode an input longer than the static scan bound, in chunks.

        Multi-root overlap-save: consecutive
        chunks overlap by ``max_word_len`` positions; chunk k exports its
        beams at the last M positions (scores + LSTM states, straight from
        the ring caches) and chunk k+1 SEEDS its ring with them, admitting
        lattice nodes that START in the overlap — so words span chunk cuts
        freely and the search is exactly the unchunked scan's (the
        per-position beams are identical; tests pin >62-kana inputs to an
        unchunked oracle decode).  The built-in forwards (jnp parity,
        Pallas speed, vocab-sharded) all carry the hook; custom forwards
        without one fall back to single-root chaining (forced word
        boundary at each cut).
        Beam states never leave the device between chunks.
        """
        if getattr(self._fwd, "score_hidden", None) is not None:
            return self._decode_long_multiroot(kana, n_best)
        return self._decode_long_chain(kana, n_best)

    def _mr_jit(self, kind: str):
        """Lazily build the multi-root jit variants."""
        if kind not in self._mr_jits:
            M = self.config.max_word_len
            base = dict(config=self.config, forward_fn=self._fwd)
            if kind == "first":
                fn = functools.partial(
                    _decode_scan, **base, export_rings=True, walk=False)
            elif kind == "mid":
                fn = functools.partial(
                    _decode_scan, **base, seed_m=M, export_rings=True,
                    walk=False)
            else:  # "last"
                fn = functools.partial(_decode_scan, **base, seed_m=M)
            self._mr_jits[kind] = jax.jit(fn)
        return self._mr_jits[kind]

    def _pack_window(self, window: str, mask_upto: int) -> np.ndarray:
        """Pack one chunk window's lattice, masking frames <= mask_upto
        (overlap positions the previous chunk already searched).

        The single sentence replicates to ``min_batch`` rows when the
        forward is sharded (row-sharded meshes need divisible batches);
        the duplicates ride along and row 0 is read out.
        """
        batch = [window] * max(1, self._min_batch)
        if self._native is not None:
            packed, _ = self._native.pack_batch(batch)
        else:
            lats = [
                build_lattice(w, self.lexicon, self.vocab, self.config)
                for w in batch
            ]
            packed, _ = pack_lattice_batch(lats)
        packed = packed[:, :len(window)]
        if mask_upto > 0:
            packed = packed.copy()
            packed[:, :mask_upto] = 0  # mask bit cleared => dead nodes
        return packed

    @staticmethod
    def _walk_host(bp, entry_pos: int, entry_slot: int, seed_m: int):
        """Backtrack one chunk on the host from (pos, slot) to its root.

        ``bp`` = (src, selp, seln) arrays [T_scan, B]; returns the visited
        (pos, node) list end-to-start plus the stop (pos, slot) — a seeded
        row (1..M) pointing into the previous chunk, or 0 at the true
        root.
        """
        src, selp, seln = bp
        pos, b = entry_pos, entry_slot
        steps = []
        while pos > seed_m:
            row = pos - 1 - seed_m
            steps.append((pos, int(seln[row, b])))
            pos, b = int(src[row, b]), int(selp[row, b])
        return steps, pos, b

    def _decode_long_multiroot(
        self, kana: str, n_best: int = 1
    ) -> List[DecodeResult]:
        cfg = self.config
        M, T_c = cfg.max_word_len, cfg.max_kana_len
        stride = T_c - M
        G = len(kana)
        # chunk k searches global positions cut_{k-1}+1 .. cut_k
        cuts = [T_c]
        while cuts[-1] < G:
            cuts.append(min(cuts[-1] + stride, G))
        chunks = []  # (window, packed, out, seed_m)
        seed = None
        for k, cut in enumerate(cuts):
            last = k == len(cuts) - 1
            if k == 0:
                window = kana[:cut]
                seed_m = 0
            else:
                window = kana[cuts[k - 1] - M:cut]
                seed_m = M
            packed = self._pack_window(window, seed_m)
            lengths = jnp.asarray(
                [len(window)] * packed.shape[0], jnp.int32
            )
            if k == 0:
                # chunk 0 always exports rings: decode_long only runs for
                # G > T_c, so there are >= 2 chunks and chunk 0 is never
                # the last.
                out = self._mr_jit("first")(
                    self.params, self._upload(packed), lengths
                )
            elif last:
                out = self._mr_jit("last")(
                    self.params, self._upload(packed), lengths, seed=seed
                )
            else:
                out = self._mr_jit("mid")(
                    self.params, self._upload(packed), lengths, seed=seed
                )
            seed = out.get("rings")  # stays on device
            chunks.append((window, packed, out, seed_m))

        # --- host-side stitching across chunks ---
        window_l, packed_l, out_l, _ = chunks[-1]
        finals = np.asarray(out_l["final_topk"])[0]
        paths = np.asarray(out_l["paths"])[0]  # [K, T_scan, 2]
        root_pos = np.asarray(out_l["root_pos"])[0]
        root_beam = np.asarray(out_l["root_beam"])[0]
        prev_bps = [
            tuple(np.asarray(a)[0] for a in out["bp"])
            for _w, _p, out, _m in chunks[:-1]
        ]
        results = []
        for j in range(min(n_best, len(finals))):
            if finals[j] <= -1e29:
                continue
            segs = self._segments(window_l, packed_l[0], paths[j])
            pos, slot = int(root_pos[j]), int(root_beam[j])
            for k in range(len(chunks) - 2, -1, -1):
                window_k, packed_k, _out, seed_m_k = chunks[k]
                # entry position in chunk k's local coordinates
                pos_k = len(window_k) - M + pos
                steps, pos, slot = self._walk_host(
                    prev_bps[k], pos_k, slot, seed_m_k
                )
                seg_k = []
                for p, n in steps:
                    node = int(packed_k[0][p - 1, n])
                    word = node & ((1 << _WORD_BITS) - 1)
                    start = (node >> _START_SHIFT) & 0x3F
                    display = (
                        window_k[start:p] if word == UNK_ID
                        else self.vocab.display(word)
                    )
                    seg_k.append((display, word))
                seg_k.reverse()
                segs = seg_k + segs
            results.append(
                DecodeResult(
                    surface="".join(d for d, _ in segs),
                    score=float(finals[j]),
                    segments=segs,
                )
            )
        return results

    def _decode_long_chain(self, kana: str, n_best: int = 1) -> List[DecodeResult]:
        """Legacy single-root chaining: each chunk's boundary beam seeds
        the next chunk's position-0 root, forcing a word boundary at every
        ``max_kana_len``-th position (quantified at ~11 logp per forced
        split in tests/test_long_input.py).  Kept for forwards without a
        ``score_hidden`` hook.
        """
        cfg = self.config
        T_c = cfg.max_kana_len
        parts = [kana[i : i + T_c] for i in range(0, len(kana), T_c)]
        outs = []
        root = None
        for i, part in enumerate(parts):
            last = i == len(parts) - 1
            packed, lengths = self._pack([part])
            if not last:
                # chain mode requires length == the scan bound exactly
                assert int(lengths[0]) == packed.shape[1] == T_c
            fn = self._decode_jit if last else self._decode_jit_chain
            out = fn(self.params, jnp.asarray(packed), jnp.asarray(lengths),
                     root)
            root = out.get("chain")  # stays on device
            outs.append((part, packed, out))
        last_part, last_packed, last_out = outs[-1]
        finals = np.asarray(last_out["final_topk"])[0]
        paths = np.asarray(last_out["paths"])[0]
        roots = np.asarray(last_out["root_beam"])[0]
        prev = [
            (
                part,
                packed,
                np.asarray(out["paths"])[0],
                np.asarray(out["root_beam"])[0],
            )
            for part, packed, out in outs[:-1]
        ]
        results = []
        for k in range(min(n_best, len(finals))):
            if finals[k] <= -1e29:
                continue
            segs = self._segments(last_part, last_packed[0], paths[k])
            rb = int(roots[k])
            for part, packed, paths_j, roots_j in reversed(prev):
                segs = self._segments(part, packed[0], paths_j[rb]) + segs
                rb = int(roots_j[rb])
            results.append(
                DecodeResult(
                    surface="".join(d for d, _ in segs),
                    score=float(finals[k]),
                    segments=segs,
                )
            )
        return results

    def decode(self, kana: str, n_best: int = 1) -> List[DecodeResult]:
        if len(kana) > self.config.max_kana_len:
            return self.decode_long(kana, n_best)
        return self.decode_batch([kana], n_best)[0]
