"""Vocab-sharded output head, globally-consistent top-k, and vocab-parallel loss.

The [NORM] tensor-parallel dimension of the build (SURVEY.md §3.3):
the output vocabulary — the FLOP-dominant matmul at V=50k–100k, §4.4 —
is column-sharded over the ``vocab`` mesh axis.  Everything here uses
explicit ``shard_map`` collectives so the exchange pattern is pinned:

- :func:`make_sharded_forward` — decode-time LM forward whose head
  computes per-shard logits, reduces a global log-sum-exp
  (``pmax``+``psum``), and exchanges candidate/eos logits via ``psum``
  so every shard sees identical beam scores (the "all-gather top-k
  candidate logits, beam stays globally consistent" requirement of
  BASELINE config 3; a psum of one-hot-owned values is the same wire
  traffic as an all-gather of per-shard candidates, in one collective);
- :func:`sharded_topk` — per-shard top-k → ``all_gather`` → re-top-k,
  bit-identical to unsharded ``lax.top_k`` INCLUDING tie order (shard-major
  flat order == global-id order, see the parity test);
- :func:`vocab_parallel_nll` — Megatron-style vocab-parallel softmax
  cross-entropy for training over a ``(data, vocab)`` mesh.

D-softmax blocks are each column-sharded (every shard owns a slice of
every frequency block), so per-shard FLOPs stay balanced across the
frequency tiers.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from jlm.backend import use_kernels
from jlm.config import Config, EOS_ID
from jlm.parallel.mesh import DATA_AXIS, VOCAB_AXIS
from jlm.models.lstm import embed, lstm_step, _w


# --------------------------------------------------------------------------
# Param shardings
# --------------------------------------------------------------------------

def param_shardings(config: Config, mesh: jax.sharding.Mesh) -> Any:
    """PartitionSpec pytree for the model params.

    Head weights are column-sharded over ``vocab``; LSTM + embedding are
    replicated (small next to the head at 50k–100k vocab).  Quantized
    leaves shard ``q`` and ``scale`` along the same output axis.
    """

    if config.head == "dsoftmax":
        head = {
            "blocks": [
                {"W": P(None, VOCAB_AXIS), "b": P(VOCAB_AXIS)}
                for _ in config.dsoftmax.block_sizes
            ]
        }
    else:
        head = {"W": P(None, VOCAB_AXIS), "b": P(VOCAB_AXIS)}
    return {
        "embedding": P(),
        "lstm": [{"W": P(), "b": P()} for _ in range(config.num_layers)],
        "head": head,
    }


def shard_params(params: Any, config: Config, mesh: jax.sharding.Mesh) -> Any:
    """Place params on the mesh per :func:`param_shardings`.

    Quantized dict leaves get their spec broadcast to ``q`` (2-D) and a
    1-D spec for ``scale``.
    """
    specs = param_shardings(config, mesh)

    def put(leaf, spec):
        if isinstance(leaf, dict) and "q" in leaf:
            qspec = spec
            sspec = P(spec[1]) if len(spec) > 1 else P()
            return {
                "q": jax.device_put(leaf["q"], NamedSharding(mesh, qspec)),
                "scale": jax.device_put(leaf["scale"], NamedSharding(mesh, sspec)),
            }
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree.map(
        put, params, specs,
        is_leaf=lambda x: isinstance(x, dict) and "q" in x,
    )


# --------------------------------------------------------------------------
# Static vocab layout: candidate global id -> (owner shard, local column)
# --------------------------------------------------------------------------

def _vocab_layout(config: Config, n: int):
    """Owner/local-position math for column-sharded (blocked) vocab.

    Returns a closure mapping global word ids to (owner, local_pos) under
    the per-block column sharding, plus the local vocab size.
    """
    if config.head == "dsoftmax":
        sizes = np.asarray(config.dsoftmax.block_sizes, np.int32)
        assert (sizes % n == 0).all(), (
            f"dsoftmax block sizes {tuple(sizes)} must divide by mesh_vocab={n}"
        )
        bases = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
        slice_sizes = sizes // n
        local_bases = np.concatenate([[0], np.cumsum(slice_sizes)[:-1]]).astype(
            np.int32
        )
        v_local = int(slice_sizes.sum())
        bases_j = jnp.asarray(bases)
        slice_j = jnp.asarray(slice_sizes)
        lbases_j = jnp.asarray(local_bases)

        def owner_pos(ids: jnp.ndarray):
            blk = jnp.searchsorted(bases_j, ids, side="right") - 1
            off = ids - bases_j[blk]
            owner = off // slice_j[blk]
            pos = lbases_j[blk] + off % slice_j[blk]
            return owner, pos

        return owner_pos, v_local
    V = config.vocab_size
    assert V % n == 0, f"vocab {V} must divide by mesh_vocab={n}"
    v_local = V // n

    def owner_pos(ids: jnp.ndarray):
        return ids // v_local, ids % v_local

    return owner_pos, v_local


def _local_head_logits(
    config: Config, head: Dict, h_top: jnp.ndarray, precision: str
) -> jnp.ndarray:
    """Per-shard logits [B, V_local] from the shard's head slice."""
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


# --------------------------------------------------------------------------
# Decode-time sharded forward (plugs into BeamDecoder as forward_fn)
# --------------------------------------------------------------------------

def make_sharded_forward(
    mesh: jax.sharding.Mesh, config: Config, precision: str = "highest",
    seq_shard: bool = True,
    use_pallas: Optional[bool] = None,
    compute_dtype=None,
    int8_mxu: Optional[bool] = None,
    interpret: bool = False,
) -> Callable:
    """Batched ForwardFn with the head sharded over the ``vocab`` axis.

    ``use_pallas`` (default: :func:`jlm.backend.use_kernels`, i.e. GPU
    speed mode) runs the single-card kernel head under the vocab
    sharding: inside the ``shard_map`` body every shard runs the XLA
    LSTM cell and candidate einsum on its own rows and the vocab-tiled
    projection kernel on its LOCAL head columns, merging the per-shard
    partial ``(m, s)`` logsumexp statistics with one ``pmax`` + one
    ``psum``.  ``False`` keeps the jnp head (the fp32 layout used by
    parity tests and the CPU).  ``interpret=True`` runs the kernel in the
    Pallas interpreter.  See :func:`_make_sharded_pallas_forward`.

    Engine signature: ``(params, words [S,B], state [L,S*B,H], cand [S,C])``.

    ``seq_shard=True`` (default): sentence rows shard over BOTH mesh axes
    for everything outside the head (the embedding, LSTM, and — by XLA
    propagation — the engine's whole scan skeleton),
    Megatron-sequence-parallel style, so the only replication left is the
    head-boundary exchange — one ``all_gather`` of the vocab group's h_top
    (bf16-sized rows), the logsumexp ``pmax``+``psum``, and one
    ``psum_scatter`` that returns each shard exactly its own sentences'
    candidate logits (half the wire of a full-candidate ``psum``).
    ``seq_shard=False`` keeps rows replicated over vocab (candidate
    ``psum``) for meshes where S cannot divide data*vocab.

    Every shard's beam stays globally consistent either way (BASELINE
    config 3); tie-exactness is pinned by tests/test_sharded.py.
    """
    if use_pallas is None:
        use_pallas = use_kernels(precision)
    if use_pallas:
        if compute_dtype is None and precision == "default":
            compute_dtype = jnp.bfloat16
        return _make_sharded_pallas_forward(
            mesh, config, seq_shard=seq_shard, compute_dtype=compute_dtype,
            int8_mxu=int8_mxu, interpret=interpret,
        )
    n = mesh.shape[VOCAB_AXIS]
    owner_pos, v_local = _vocab_layout(config, n)

    head_specs = (
        {"blocks": [{"W": P(None, VOCAB_AXIS), "b": P(VOCAB_AXIS)}
                    for _ in config.dsoftmax.block_sizes]}
        if config.head == "dsoftmax"
        else {"W": P(None, VOCAB_AXIS), "b": P(VOCAB_AXIS)}
    )

    row_spec = P((DATA_AXIS, VOCAB_AXIS)) if seq_shard else P(DATA_AXIS)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(head_specs, row_spec, row_spec),
        out_specs=(row_spec, row_spec),
        check_vma=False,
    )
    def _sharded_head(head, h_top, ids):
        # h_top [R_local, H]; ids [S_local, C+1] (eos appended by caller)
        S_local, C1 = ids.shape
        B = h_top.shape[0] // S_local
        if seq_shard:
            # head boundary: gather the vocab group's rows (sequence ->
            # tensor parallel switch), compute the full group's head slice
            h_grp = jax.lax.all_gather(h_top, VOCAB_AXIS, tiled=True)
            ids_grp = jax.lax.all_gather(ids, VOCAB_AXIS, tiled=True)
        else:
            h_grp, ids_grp = h_top, ids
        S_grp = ids_grp.shape[0]
        logits = _local_head_logits(config, head, h_grp, precision).astype(
            jnp.float32
        )  # [R_grp, Vl]
        m = jax.lax.pmax(jnp.max(logits, axis=1), VOCAB_AXIS)
        se = jax.lax.psum(
            jnp.sum(jnp.exp(logits - m[:, None]), axis=1), VOCAB_AXIS
        )
        lse = m + jnp.log(se)
        # Candidate columns — each shard contributes the ids it owns.
        owner, pos = owner_pos(ids_grp)  # [S_grp, C1]
        mine = owner == jax.lax.axis_index(VOCAB_AXIS)
        lp3 = logits.reshape(S_grp, B, v_local)
        vals = jnp.take_along_axis(
            lp3, jnp.clip(pos, 0, v_local - 1)[:, None, :], axis=2
        )  # [S_grp, B, C1]
        vals = jnp.where(mine[:, None, :], vals, 0.0)
        if seq_shard:
            # one reduce-scatter: every shard receives exactly ITS OWN
            # sentences' summed candidate logits — (n-1)/n of the psum's
            # wire bytes, and the output lands already row-sharded
            vals = jax.lax.psum_scatter(
                vals, VOCAB_AXIS, scatter_dimension=0, tiled=True
            )  # [S_local, B, C1]
            i0 = jax.lax.axis_index(VOCAB_AXIS) * S_local * B
            lse_loc = jax.lax.dynamic_slice_in_dim(lse, i0, S_local * B)
            vals = vals - lse_loc.reshape(S_local, B, 1)
        else:
            vals = jax.lax.psum(vals, VOCAB_AXIS) - lse.reshape(
                S_local, B, 1
            )
        return vals[:, :, :-1], vals[:, :, -1]

    def forward(params, words, state, cand_words):
        S, B = words.shape
        x = embed(params, words.reshape(S * B))
        h_top, state = lstm_step(params, config, x, state, precision)
        ids = jnp.concatenate(
            [cand_words, jnp.full((S, 1), EOS_ID, jnp.int32)], axis=1
        )
        cand_logp, eos_logp = _sharded_head(params["head"], h_top, ids)
        return cand_logp, eos_logp, state

    def score_hidden(params, h_top, cand_words):
        """Candidate logp from existing top hidden states (no LSTM step):
        multi-root ``decode_long`` seeding under vocab sharding — the same
        head exchange as the frame forward, minus <eos> (the seeded rows
        never rescore).  ``h_top [S', B, H]``, ``cand_words [S', C]``;
        S' must divide the row sharding like any batch."""
        Sp, B, H = h_top.shape
        out = _sharded_head(params["head"], h_top.reshape(Sp * B, H),
                            cand_words)
        # _sharded_head appends nothing itself — the caller of the FRAME
        # forward appends <eos>; here the ids table is the payload as-is,
        # so "eos" (the last column split) is just the last candidate.
        cand_logp, last_col = out
        return jnp.concatenate([cand_logp, last_col[:, :, None]], axis=2)

    forward.score_hidden = score_hidden
    # the engine pads lattice batches up to this (S must divide the row
    # sharding: data*vocab when sequence-sharded, data otherwise)
    forward.min_batch = int(
        mesh.shape[DATA_AXIS] * (mesh.shape[VOCAB_AXIS] if seq_shard else 1)
    )
    # the engine uploads lattices as global arrays over this mesh and
    # allgathers results when the mesh spans multiple processes
    forward.mesh = mesh
    return forward


# --------------------------------------------------------------------------
# Kernel head × vocab sharding
# --------------------------------------------------------------------------

def _rep_specs(tree: Any) -> Any:
    """Replicated PartitionSpec pytree matching ``tree`` leaf-for-leaf."""
    return jax.tree.map(lambda _: P(), tree)


def _head_w_spec(leaf):
    """Column-sharded spec for a head weight leaf (fp array or quant dict)."""
    if isinstance(leaf, dict) and "q" in leaf:
        return {"q": P(None, VOCAB_AXIS), "scale": P(VOCAB_AXIS)}
    return P(None, VOCAB_AXIS)


def _head_specs_of(head: Dict) -> Dict:
    """PartitionSpec pytree for a (possibly D-softmax / quantized) head."""
    def blk(b):
        return {"W": _head_w_spec(b["W"]), "b": P(VOCAB_AXIS)}
    if "blocks" in head:
        return {"blocks": [blk(b) for b in head["blocks"]]}
    return blk(head)


def _embed_rows(emb, ids):
    """Embedding row gather with per-row dequant (local, shard_map body)."""
    if isinstance(emb, dict) and "q" in emb:
        rows = emb["q"][ids].astype(jnp.float32)
        return rows * emb["scale"][ids][..., None]
    return emb[ids]


def _make_sharded_pallas_forward(
    mesh: jax.sharding.Mesh,
    config: Config,
    *,
    seq_shard: bool = True,
    compute_dtype=None,
    int8_mxu: Optional[bool] = None,
    interpret: bool = False,
) -> Callable:
    """Vocab-sharded decode forward built from the single-card kernel head.

    The head IS the perf core (SURVEY.md §4.4: the output matmul ≈ 25× the
    LSTM FLOPs; ref: JLM:decoder/ model file, D-softmax inference path), so
    the sharded program runs the same pieces as the single-card speed
    path.  Per ``shard_map`` body:

    - the XLA LSTM cell (:func:`jlm.models.lstm.cell`) on the shard's
      own beam rows;
    - candidate logits from the pre-gathered transposed-head rows
      (``prepare`` hook → :func:`jlm.decoder.engine.candidate_dot`) — the
      candidate table ``head_T`` is REPLICATED (bf16 ``[V, H]``, ~100 MB at
      the 100k flagship), which removes the candidate exchange entirely:
      each shard scores only its own sentences, zero collectives;
    - the vocab-tiled projection kernel (:func:`jlm.ops.project
      .project_ms`, in-kernel int8 dequant / int8 x int8 product) on the
      shard's LOCAL head columns, merged across shards with one ``pmax``
      + one ``psum`` of per-row scalars.

    Wire per frame (seq_shard): one ``all_gather`` of the vocab group's
    h_top rows (bf16) at the head boundary + two scalar-vector collectives
    — strictly less than the jnp layout's candidate ``psum_scatter``.  The
    FLOP-dominant lse weights stay column-sharded (memory scales with the
    mesh); only the decode-side candidate table is replicated.

    On a (1, 1) mesh this is bit-identical to
    :func:`jlm.decoder.engine.make_pallas_forward` (same pieces, no
    collectives).
    """
    from jlm.decoder.engine import candidate_dot
    from jlm.models.lstm import cell
    from jlm.ops.project import project_ms

    if compute_dtype is None:
        compute_dtype = jnp.float32
    if int8_mxu is None:
        int8_mxu = config.int8_mxu
    n = mesh.shape[VOCAB_AXIS]
    _vocab_layout(config, n)  # validates V / block sizes divide the axis
    row_axes = (DATA_AXIS, VOCAB_AXIS) if seq_shard else (DATA_AXIS,)
    row0 = P(row_axes)  # leading axis = sentences
    state_spec = P(None, row_axes)  # [L, S*B, H]: rows are axis 1

    def _lse_local(head_c, h_rows):
        """Global per-row lse from the LOCAL head columns.

        ``h_rows [R_local, H]``; under seq_shard the vocab group's rows are
        all_gathered first (sequence→tensor switch at the head boundary,
        bf16-sized), then the partial ``(m, s)`` from this shard's columns
        merge via ``pmax`` + ``psum``.  Returns this shard's own rows' lse.
        """
        h_rows = h_rows.astype(compute_dtype)
        R_l = h_rows.shape[0]
        if seq_shard and n > 1:
            h_grp = jax.lax.all_gather(h_rows, VOCAB_AXIS, tiled=True)
        else:
            h_grp = h_rows
        m, s = project_ms(
            h_grp, head_c, config,
            compute_dtype=compute_dtype, interpret=interpret,
            int8_mxu=int8_mxu,
        )  # [R_grp, 1] each, this shard's columns only
        if n > 1:
            m1 = m[:, 0]
            m_g = jax.lax.pmax(m1, VOCAB_AXIS)
            se = jax.lax.psum(s[:, 0] * jnp.exp(m1 - m_g), VOCAB_AXIS)
            lse = m_g + jnp.log(se)
        else:
            lse = m[:, 0] + jnp.log(s[:, 0])
        if seq_shard and n > 1:
            i0 = jax.lax.axis_index(VOCAB_AXIS) * R_l
            lse = jax.lax.dynamic_slice_in_dim(lse, i0, R_l)
        return lse  # [R_local]

    def _local_fwd(head_c, lstm_c, emb, words, c, h, cols, bias):
        S_l, B = words.shape
        H = config.hidden_size
        x = _embed_rows(emb, words.reshape(S_l * B))
        new_c, new_h = [], []
        for l, layer in enumerate(lstm_c):
            c_l, h_l = cell(x, h[l], c[l], layer["W"], layer["b"],
                            config.forget_bias, compute_dtype)
            new_c.append(c_l)
            new_h.append(h_l)
            x = h_l
        h_top = x  # [S_l*B, H] compute dtype
        raw = candidate_dot(
            h_top.reshape(S_l, B, H), cols, bias, compute_dtype,
        )  # [S_l, B, C1] — own sentences only, zero collectives
        lse = _lse_local(head_c, h_top)
        logp = raw - lse.reshape(S_l, B, 1)
        return (logp[:, :, :-1], logp[:, :, -1],
                (jnp.stack(new_c), jnp.stack(new_h)))

    def _local_score(head_c, h3, cols, bias):
        S_l, B, H = h3.shape
        raw = candidate_dot(h3, cols, bias, compute_dtype)
        lse = _lse_local(head_c, h3.reshape(S_l * B, H))
        logp = raw - lse.reshape(S_l, B, 1)
        return logp[:, :, :-1]

    def prepare(params, look_w):
        """[S, T1, C] ids -> (cols [S, T1, C+1, H], bias [S, T1, C+1]).

        Same hook as the unsharded kernel forward: one replicated-table row
        gather per decode call, outside the scan; <eos> appended as the
        last column so the frame step prices the final rescore too.
        """
        dec = params["_decode"]
        S, T1, C = look_w.shape
        ids = jnp.concatenate(
            [look_w, jnp.full((S, T1, 1), EOS_ID, jnp.int32)], axis=2
        )
        cols = jnp.take(dec["head_T"], ids, axis=0)
        bias = jnp.take(dec["bias"], ids)
        return {"cols": cols, "bias": bias}

    def forward(params, words, state, payload):
        dec = params["_decode"]
        c, h = state
        f = shard_map(
            _local_fwd,
            mesh=mesh,
            in_specs=(_head_specs_of(dec["head_c"]),
                      _rep_specs(dec["lstm_c"]),
                      _rep_specs(params["embedding"]),
                      row0, state_spec, state_spec, row0, row0),
            out_specs=(row0, row0, (state_spec, state_spec)),
            check_vma=False,
        )
        return f(dec["head_c"], dec["lstm_c"], params["embedding"],
                 words, c, h, payload["cols"], payload["bias"])

    def score_hidden(params, h_top, payload):
        """Multi-root decode_long seeding under vocab sharding — same head
        exchange as the frame forward, minus the LSTM step."""
        dec = params["_decode"]
        f = shard_map(
            _local_score,
            mesh=mesh,
            in_specs=(_head_specs_of(dec["head_c"]), row0, row0, row0),
            out_specs=row0,
            check_vma=False,
        )
        return f(dec["head_c"], h_top, payload["cols"], payload["bias"])

    def place_params(params):
        """Pin decode-param placement on the mesh (called by BeamDecoder
        after the one-time ``build_decode_head`` prep): head columns
        sharded over ``vocab`` (the O(V·H) lse input — memory scales with
        the mesh), candidate table ``head_T``/``bias`` + LSTM + embedding
        replicated.  Without this the eagerly-built ``head_T`` inherits a
        row sharding from the transposed head and every decode call would
        re-gather it."""
        def put(tree, specs):
            return jax.tree.map(
                lambda leaf, sp: jax.device_put(
                    leaf, NamedSharding(mesh, sp)),
                tree, specs,
            )
        out = dict(params)
        dec = dict(params["_decode"])
        dec["head_c"] = put(dec["head_c"], _head_specs_of(dec["head_c"]))
        dec["head_T"] = put(dec["head_T"], P())
        dec["bias"] = put(dec["bias"], P())
        dec["lstm_c"] = put(dec["lstm_c"], _rep_specs(dec["lstm_c"]))
        out["_decode"] = dec
        out["embedding"] = put(
            params["embedding"], _rep_specs(params["embedding"])
        )
        return out

    forward.prepare = prepare
    forward.score_hidden = score_hidden
    forward.place_params = place_params
    forward.compute_dtype = compute_dtype
    forward.min_batch = int(
        mesh.shape[DATA_AXIS] * (mesh.shape[VOCAB_AXIS] if seq_shard else 1)
    )
    forward.mesh = mesh
    return forward


# --------------------------------------------------------------------------
# Globally-consistent sharded top-k (next-word prediction / suggestion API)
# --------------------------------------------------------------------------

def sharded_topk(
    mesh: jax.sharding.Mesh, logits: jnp.ndarray, k: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k over a column-sharded ``[B, V]`` logits array.

    Per-shard ``lax.top_k`` → ``all_gather`` of (value, global id) pairs →
    re-top-k.  Exactly equivalent to unsharded ``lax.top_k`` including tie
    order: the gathered flat layout is shard-major, and within a shard the
    local list is value-desc/id-asc, so a tie group reads off in global-id
    order — the same lower-index-first rule ``lax.top_k`` applies
    (SURVEY.md §9.3.2, the hard part this function pins down).
    """
    n = mesh.shape[VOCAB_AXIS]
    V = logits.shape[-1]
    v_local = V // n
    kl = min(k, v_local)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=P(None, VOCAB_AXIS),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def _topk(local):  # [B, v_local]
        vals, idx = jax.lax.top_k(local, kl)
        gids = idx + jax.lax.axis_index(VOCAB_AXIS) * v_local
        # all_gather over shards → [n, B, kl] → shard-major flat [B, n*kl]
        av = jax.lax.all_gather(vals, VOCAB_AXIS)
        ai = jax.lax.all_gather(gids, VOCAB_AXIS)
        av = jnp.swapaxes(av, 0, 1).reshape(local.shape[0], n * kl)
        ai = jnp.swapaxes(ai, 0, 1).reshape(local.shape[0], n * kl)
        fv, fi = jax.lax.top_k(av, k)
        return fv, jnp.take_along_axis(ai, fi, axis=1)

    return _topk(logits)


# --------------------------------------------------------------------------
# Training: vocab-parallel cross-entropy over a (data, vocab) mesh
# --------------------------------------------------------------------------

def vocab_parallel_nll(
    mesh: jax.sharding.Mesh, config: Config, precision: str = "default",
) -> Callable:
    """Mean-NLL loss with head column-sharded and batch row-sharded.

    Differentiable through ``shard_map``; the data-axis ``pmean`` makes the
    gradient the global-batch mean, so data-parallel grad sync falls out of
    the loss itself.
    """
    n = mesh.shape[VOCAB_AXIS]
    owner_pos, v_local = _vocab_layout(config, n)

    head_specs = (
        {"blocks": [{"W": P(None, VOCAB_AXIS), "b": P(VOCAB_AXIS)}
                    for _ in config.dsoftmax.block_sizes]}
        if config.head == "dsoftmax"
        else {"W": P(None, VOCAB_AXIS), "b": P(VOCAB_AXIS)}
    )

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(head_specs, P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=P(),
        check_vma=False,
    )
    def _nll(head, hs, targets):  # hs [b, T, H], targets [b, T] (local rows)
        b, T, H = hs.shape
        h = hs.reshape(b * T, H)
        t = targets.reshape(b * T)
        logits = _local_head_logits(config, head, h, precision).astype(jnp.float32)
        # stop_gradient before pmax: lse is shift-invariant in m, and pmax
        # lacks a JVP rule — zero the tangent on its input.
        m = jax.lax.pmax(
            jax.lax.stop_gradient(jnp.max(logits, axis=1)), VOCAB_AXIS
        )
        se = jax.lax.psum(jnp.sum(jnp.exp(logits - m[:, None]), axis=1), VOCAB_AXIS)
        lse = m + jnp.log(se)
        owner, pos = owner_pos(t)
        mine = owner == jax.lax.axis_index(VOCAB_AXIS)
        tl = jnp.take_along_axis(
            logits, jnp.clip(pos, 0, v_local - 1)[:, None], axis=1
        )[:, 0]
        tl = jax.lax.psum(jnp.where(mine, tl, 0.0), VOCAB_AXIS)
        local_mean = jnp.mean(lse - tl)
        return jax.lax.pmean(local_mean, DATA_AXIS)

    def loss(params, hs, targets):
        return _nll(params["head"], hs, targets)

    return loss
