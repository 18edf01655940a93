"""Incremental per-keystroke decoding (BASELINE config 4).

Rebuild of the reference's per-keystroke mode (ref: JLM:decoder/decoder.py
incremental entry point — SURVEY.md §4.7): after keystroke ``T+1`` only the
new frame is processed; beams 0..T and their cached LSTM states are reused,
so each keystroke costs ONE device frame-step instead of re-decoding the
lattice.

Cache design differs from the batch engine on purpose: the batch scan
pre-computes candidate log-probs per position because the whole lattice is
known up front; under incremental typing, future candidates are unknown at
beam-finalization time.  Instead every position caches ``(c, h, score,
logsumexp)`` and a keystroke scores its frame's nodes LAZILY via
:func:`jlm.models.lstm.candidate_logits` (gather only the needed output
columns) — ``logp(w | path) = logit_w(h) − lse``.  This is exactly equal to
the batch engine's numbers, which the parity test pins.

Also supports ``pop()`` (backspace): positions after the cursor are simply
overwritten by later keystrokes, so deletion is O(1) host bookkeeping —
the cached prefix stays valid.
"""

from __future__ import annotations

import functools
from typing import Any, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from jlm.backend import use_kernels
from jlm.config import Config, EOS_ID
from jlm.data.corpus import Vocab
from jlm.data.lexicon import Lexicon
from jlm.decoder.lattice import Node
from jlm.models.lstm import (
    embed,
    head_logits,
    initial_state,
    lstm_step,
    node_logits,
)
from jlm.oracle.decoder import DecodeResult


def _forward_with_lse(params, config, words, state, precision,
                      pallas_head=None):
    """One LM step returning (state', h_top, lse, eos_logp).

    ``pallas_head=None`` (parity mode / CPU) materializes the full logits
    row and reduces in jnp.  A dict ``{compute_dtype, interpret,
    int8_mxu}`` instead routes the normalizer through the vocab-tiled
    :func:`jlm.ops.project.project_lse` kernel — logits never reach
    device memory (``[rows, V]`` fp32 is ~256 MB per server step at the
    config-5 shape) — and prices the <eos> logit as one candidate-column
    gather.
    """
    x = embed(params, words)
    h_top, state = lstm_step(params, config, x, state, precision)
    if pallas_head is not None:
        from jlm.models.lstm import candidate_logits
        from jlm.ops.project import project_lse

        lse = project_lse(h_top, params["head"], config, **pallas_head)[:, 0]
        eos_logit = candidate_logits(
            params, config, h_top, jnp.asarray([EOS_ID], jnp.int32), precision
        )[:, 0].astype(jnp.float32)
        return state, h_top, lse, eos_logit - lse
    logits = head_logits(params, config, h_top, precision).astype(jnp.float32)
    m = jnp.max(logits, axis=-1)
    lse = m + jnp.log(jnp.sum(jnp.exp(logits - m[:, None]), axis=-1))
    return state, h_top, lse, logits[:, EOS_ID] - lse


def pallas_head_args(config: Config, precision: str,
                     use_pallas: Optional[bool], interpret: bool):
    """Kernel-normaliser arguments for the keystroke paths, or None.

    ``use_pallas=None`` asks :func:`jlm.backend.use_kernels`; ``interpret``
    is passed through as given (never derived from the platform).
    """
    if use_pallas is None:
        use_pallas = use_kernels(precision)
    if not use_pallas:
        return None
    return dict(
        compute_dtype=jnp.bfloat16 if precision == "default" else jnp.float32,
        interpret=interpret,
        int8_mxu=config.int8_mxu,
    )


def _root_init(params, *, config, precision, pallas_head=None):
    B = config.beam_pad
    state = initial_state(config, B)
    words = jnp.full((B,), EOS_ID, jnp.int32)
    (c, h), h_top, lse, eos = _forward_with_lse(
        params, config, words, state, precision, pallas_head
    )
    return c, h, h_top, lse, eos


def _frame_rows(
    params,
    score_cache,  # [T_max+1, B]
    lse_cache,  # [T_max+1, B]
    eos_cache,  # [T_max+1, B]
    c_cache,  # [T_max+1, L, B, H]
    h_cache,  # [T_max+1, L, B, H]
    htop_cache,  # [T_max+1, B, H]
    node_word,  # int32 [N] nodes ending at the new position
    node_start,  # int32 [N]
    node_mask,  # bool [N]
    pos,  # int32 scalar: the new end position (1-based)
    probe_pos,  # int32 [Q] continuation-probe start positions (or empty)
    probe_wid,  # int32 [Q] continuation-probe word ids
    probe_mask,  # bool [Q]
    *,
    config: Config,
    precision: str,
    pallas_head=None,
):
    """One frame's beam extension WITHOUT cache writes.

    Returns the new cache ROW values ``(score, lse, eos, c, h, h_top)`` plus
    the packed host payload — so the same body serves the committed
    keystroke step and the batched speculative step (which computes rows for
    several hypothetical next kana and commits at most one).

    The ``probe_*`` inputs piggyback the LM next-kana predictor on the same
    device call, so prediction adds no synchronous round trip.
    Each probe is a (start position, continuation word) pair; its score is
    the best beam extension of that word, evaluated against the caches AS
    IF this frame were already committed (probes at ``probe_pos == pos``
    read the freshly computed rows).  The scores travel inside the single
    packed payload, so the keystroke critical path stays at ONE fetch.
    """
    B = config.beam_pad
    NEG = jnp.float32(-1e30)

    # Lazy extension scores: logit of each node's word from each path of the
    # beam at the node's start, minus that path's cached logsumexp.  The
    # paired node_logits form scores node n only against its own column —
    # O(N·B·H) instead of the old all-words-by-all-rows diagonal (O(N²·B·H)).
    h_src = htop_cache[node_start]  # [N, B, H]
    logits = node_logits(params, config, h_src, node_word, precision)  # [N, B]
    ext = score_cache[node_start] + logits - lse_cache[node_start]
    ext = jnp.where(node_mask[:, None], ext, NEG)

    from jlm.decoder.engine import topk_stable

    top_scores, top_idx = topk_stable(
        ext.reshape(1, -1), B, config.topk_mode
    )
    top_scores, top_idx = top_scores[0], top_idx[0]
    slot_alive = jnp.arange(B) < config.beam_width
    top_scores = jnp.where(slot_alive, top_scores, NEG)
    sel_n = top_idx // B
    sel_p = top_idx % B
    src_pos = node_start[sel_n]
    new_words = node_word[sel_n]

    new_c = jnp.moveaxis(c_cache[src_pos, :, sel_p, :], 0, 1)
    new_h = jnp.moveaxis(h_cache[src_pos, :, sel_p, :], 0, 1)
    (c2, h2), h_top, lse, eos = _forward_with_lse(
        params, config, new_words, (new_c, new_h), precision, pallas_head
    )
    finals = top_scores + eos

    # Continuation probes against the post-commit caches.
    Q = probe_wid.shape[0]
    if Q:
        at_new = probe_pos[:, None] == pos
        sc = jnp.where(at_new, top_scores[None, :], score_cache[probe_pos])
        ls = jnp.where(at_new, lse[None, :], lse_cache[probe_pos])
        ht = jnp.where(
            at_new[:, :, None], h_top[None], htop_cache[probe_pos]
        )  # [Q, B, H]
        p_logits = node_logits(params, config, ht, probe_wid, precision)
        p_best = jnp.max(sc + p_logits - ls, axis=1)
        p_best = jnp.where(probe_mask, p_best, NEG)
    else:
        p_best = jnp.zeros((0,), jnp.float32)

    # Pack the per-keystroke host payload into ONE int32 array: one fetch
    # per keystroke is the latency floor.
    packed_out = jnp.concatenate(
        [
            src_pos.astype(jnp.int32),
            sel_p.astype(jnp.int32),
            sel_n.astype(jnp.int32),
            jax.lax.bitcast_convert_type(finals, jnp.int32),
            jax.lax.bitcast_convert_type(p_best, jnp.int32),
        ]
    )
    return (top_scores, lse, eos, c2, h2, h_top), packed_out


def build_probe_arrays(lexicon, config: Config, Q: int, window: str,
                       lm_probes: bool = True):
    """(pos, wid, mask arrays, per-probe chars) ranking continuations of
    ``window`` — consumed on-device by the piggybacked probe scorer.

    For every start position within ``max_word_len`` of the frontier, the
    lexicon's prefix index lists which characters can extend the
    already-typed suffix into a real word and which words witness each
    character; longest typed suffix first (mid-word continuations are the
    most constrained, most likely extensions).  Shared by the
    single-session decoder and the multi-session server.
    """
    T = len(window)
    M = min(config.max_word_len, lexicon.max_reading_len)
    trie = lexicon.prefix_next()
    probes: List[Tuple[int, int, str]] = []  # (pos, wid, char)
    if lm_probes:
        for p in range(max(0, T - M + 1), T + 1):
            for ch, wids in trie.get(window[p:T], {}).items():
                for w in wids[:2]:
                    if len(probes) < Q:
                        probes.append((p, w, ch))
    pos = np.zeros(Q, np.int32)
    wid = np.full(Q, EOS_ID, np.int32)
    msk = np.zeros(Q, bool)
    for k, (p, w, _ch) in enumerate(probes):
        pos[k], wid[k], msk[k] = p, w, True
    return pos, wid, msk, [ch for _p, _w, ch in probes]


def _commit_rows(
    score_cache, lse_cache, eos_cache, c_cache, h_cache, htop_cache,
    pos, rows,
):
    """Write one frame's row values into the caches at ``pos``."""
    top_scores, lse, eos, c2, h2, h_top = rows
    return (
        score_cache.at[pos].set(top_scores),
        lse_cache.at[pos].set(lse),
        eos_cache.at[pos].set(eos),
        c_cache.at[pos].set(c2),
        h_cache.at[pos].set(h2),
        htop_cache.at[pos].set(h_top),
    )


def _keystroke_step(
    params,
    score_cache,
    lse_cache,
    eos_cache,
    c_cache,
    h_cache,
    htop_cache,
    pos,  # int32 scalar: the new end position (1-based)
    blob,  # int32 [3N + 3Q]: nw|ns|nm|pp|pw|pm — single upload per
    #   keystroke (each jnp.asarray argument is its own transfer)
    *,
    N: int,
    Q: int,
    config: Config,
    precision: str,
    pallas_head=None,
):
    node_word = jax.lax.dynamic_slice_in_dim(blob, 0, N)
    node_start = jax.lax.dynamic_slice_in_dim(blob, N, N)
    node_mask = jax.lax.dynamic_slice_in_dim(blob, 2 * N, N) != 0
    probe_pos = jax.lax.dynamic_slice_in_dim(blob, 3 * N, Q)
    probe_wid = jax.lax.dynamic_slice_in_dim(blob, 3 * N + Q, Q)
    probe_mask = jax.lax.dynamic_slice_in_dim(blob, 3 * N + 2 * Q, Q) != 0
    rows, packed_out = _frame_rows(
        params, score_cache, lse_cache, eos_cache, c_cache, h_cache,
        htop_cache, node_word, node_start, node_mask,
        pos, probe_pos, probe_wid, probe_mask,
        config=config, precision=precision, pallas_head=pallas_head,
    )
    caches = _commit_rows(
        score_cache, lse_cache, eos_cache, c_cache, h_cache, htop_cache,
        pos, rows,
    )
    return caches, packed_out


def _prime_step(
    params,
    score_cache, lse_cache, eos_cache, c_cache, h_cache, htop_cache,
    pos,  # int32 scalar: the speculated end position
    node_word,  # int32 [K, N]: frame nodes for K hypothetical next kana
    node_start,  # int32 [K, N]
    node_mask,  # bool [K, N]
    probe_pos,  # int32 [K, Q]
    probe_wid,  # int32 [K, Q]
    probe_mask,  # bool [K, Q]
    *,
    config: Config,
    precision: str,
    pallas_head=None,
):
    """Speculation WITHOUT a typed frame: seeds a fresh/rolled/popped
    session so the very first keystroke can hit.  Off the typing critical
    path (dispatched at reset/roll/pop); ranking comes from the host
    (static prior or custom predictor — there are no probe scores yet)."""
    _rows, packed = jax.vmap(
        lambda nw, ns, nm, pp, pw, pm: _frame_rows(
            params, score_cache, lse_cache, eos_cache, c_cache, h_cache,
            htop_cache, nw, ns, nm, pos, pp, pw, pm,
            config=config, precision=precision, pallas_head=pallas_head,
        )
    )(node_word, node_start, node_mask, probe_pos, probe_wid, probe_mask)
    return packed  # [K, 4B+Q]


def pack_unified_blob(N, Q, A, nw, ns, nm, pp, pw, pm, probe_char,
                      spec_nw, spec_ns, spec_nm, spec_pp, spec_pw, spec_pm,
                      spec_ok, char_prior):
    """Host-side: pack the unified step's 15 small int tensors into ONE
    int32 upload — each `jnp.asarray` argument is a separate transfer."""
    import numpy as _np

    return _np.concatenate([
        nw.ravel(), ns.ravel(), nm.astype(_np.int32).ravel(),
        pp.ravel(), pw.ravel(), pm.astype(_np.int32).ravel(),
        probe_char.ravel(),
        spec_nw.ravel(), spec_ns.ravel(), spec_nm.astype(_np.int32).ravel(),
        spec_pp.ravel(), spec_pw.ravel(), spec_pm.astype(_np.int32).ravel(),
        spec_ok.astype(_np.int32).ravel(),
        char_prior.astype(_np.float32).view(_np.int32).ravel(),
    ]).astype(_np.int32)


def _unified_step(
    params,
    score_cache, lse_cache, eos_cache, c_cache, h_cache, htop_cache,
    pos,  # int32 scalar: the typed character's end position (1-based)
    blob,  # int32 [3N + 4Q + A(3N + 3Q + 2)] — pack_unified_blob layout
    *,
    K: int,
    N: int,
    Q: int,
    A: int,
    config: Config,
    precision: str,
    pallas_head=None,
):
    """ONE device call per keystroke: commit + predict + speculate.

    Unified speculative step: a separate speculative call after each
    keystroke would add a dispatch and a round trip to every keystroke,
    so this function does everything in one dispatch:

      1. the typed char's frame extension + cache commit (`_frame_rows`),
      2. continuation-probe scoring for the typed prefix,
      3. next-kana ranking ON DEVICE: per-candidate-char best probe score
         via a one-hot segment max (``probe_char`` maps probes to
         candidate rows),
      4. gathers the top-``K`` candidates' host-prepared node/probe
         tensors and runs their frames against the POST-commit caches —
         the next keystroke's full payload (backpointers, finals, its own
         probe ranking), computed before it is typed.

    The host passes tensors for ALL ``A`` candidate chars and learns which
    ``K`` the device chose from the returned ``topk_idx`` — so prediction,
    ranking, and speculation cost zero extra round trips, and a HIT answers the
    next keystroke from the previous call's payload with no device work on
    the critical path.
    """
    NEG = jnp.float32(-1e30)
    B = config.beam_pad

    # unpack the single-upload blob (static slices; see pack_unified_blob)
    o = 0

    def cut(n, shape=None, dtype=None):
        nonlocal o
        a = jax.lax.dynamic_slice_in_dim(blob, o, n)
        o += n
        if shape is not None:
            a = a.reshape(shape)
        if dtype is bool:
            a = a != 0
        elif dtype is jnp.float32:
            a = jax.lax.bitcast_convert_type(a, jnp.float32)
        return a

    node_word = cut(N)
    node_start = cut(N)
    node_mask = cut(N, dtype=bool)
    probe_pos = cut(Q)
    probe_wid = cut(Q)
    probe_mask = cut(Q, dtype=bool)
    probe_char = cut(Q)
    spec_nw = cut(A * N, (A, N))
    spec_ns = cut(A * N, (A, N))
    spec_nm = cut(A * N, (A, N), dtype=bool)
    spec_pp = cut(A * Q, (A, Q))
    spec_pw = cut(A * Q, (A, Q))
    spec_pm = cut(A * Q, (A, Q), dtype=bool)
    spec_ok = cut(A, dtype=bool)
    char_prior = cut(A, dtype=jnp.float32)

    rows, packed_t = _frame_rows(
        params, score_cache, lse_cache, eos_cache, c_cache, h_cache,
        htop_cache, node_word, node_start, node_mask,
        pos, probe_pos, probe_wid, probe_mask,
        config=config, precision=precision, pallas_head=pallas_head,
    )
    caches = _commit_rows(
        score_cache, lse_cache, eos_cache, c_cache, h_cache, htop_cache,
        pos, rows,
    )

    # On-device next-kana ranking: best probe score per candidate char,
    # with the host prior as the floor (it carries custom-predictor order
    # and breaks trie-order ties for chars no probe witnessed).
    p_best = jax.lax.bitcast_convert_type(packed_t[4 * B:], jnp.float32)
    onehot = probe_char[:, None] == jnp.arange(A)[None, :]  # [Q, A]
    char_scores = jnp.max(
        jnp.where(onehot, p_best[:, None], NEG), axis=0
    )  # [A]
    char_scores = jnp.maximum(char_scores, char_prior)
    char_scores = jnp.where(spec_ok, char_scores, NEG)
    _topk_scores, topk_idx = jax.lax.top_k(char_scores, K)

    # Speculative frames for the chosen K, against the committed caches.
    take = lambda a: jnp.take(a, topk_idx, axis=0)
    spec_rows, spec_packed = jax.vmap(
        lambda nw, ns, nm, pp, pw, pm: _frame_rows(
            params, *caches, nw, ns, nm, pos + 1, pp, pw, pm,
            config=config, precision=precision, pallas_head=pallas_head,
        )
    )(take(spec_nw), take(spec_ns), take(spec_nm),
      take(spec_pp), take(spec_pw), take(spec_pm))
    del spec_rows  # hit frames are recomputed as the next call's typed frame

    # One flat int32 payload: typed payload | topk idx | K spec payloads.
    packed_all = jnp.concatenate(
        [packed_t, topk_idx.astype(jnp.int32), spec_packed.reshape(-1)]
    )
    return caches, packed_all


class IncrementalDecoder:
    """Per-keystroke conversion session.

    ``push(kana_char)`` appends one kana and returns the current n-best;
    ``pop()`` removes the last kana (backspace); ``reset()`` starts over.
    Each push costs one jitted device step over static shapes.
    """

    def __init__(
        self,
        params,
        lexicon: Lexicon,
        vocab: Vocab,
        config: Config,
        precision: str = "highest",
        speculate: int = 0,
        next_char_predictor=None,
        use_pallas: Optional[bool] = None,
        interpret: bool = False,
    ):
        # device-resident params: avoid re-uploading weights every keystroke
        self.params = jax.tree.map(jnp.asarray, params)
        self.lexicon = lexicon
        self.vocab = vocab
        self.config = config
        self._Q = 96  # padded (position, word) probe count per step
        self._A = 16  # padded candidate-char rows in the unified spec table
        # Route the per-step normalizer through the project_lse kernel;
        # auto (jlm.backend.use_kernels): on for GPU speed mode, off in
        # parity mode (the jnp lse is the oracle-exact rule).
        pallas_head = pallas_head_args(config, precision, use_pallas,
                                       interpret)
        self._root = jax.jit(
            functools.partial(_root_init, config=config, precision=precision,
                              pallas_head=pallas_head)
        )
        self._step = jax.jit(
            functools.partial(
                _keystroke_step, N=config.max_nodes_per_frame, Q=self._Q,
                config=config, precision=precision, pallas_head=pallas_head,
            )
        )
        # Speculative lookahead (UNIFIED design): every keystroke issues
        # exactly ONE device call that (a) commits
        # the typed frame, (b) scores continuation probes, (c) ranks next
        # kana on-device, and (d) pre-computes the full payload for the K
        # most likely next keystrokes.  A predicted keystroke ("hit") is
        # answered from the PREVIOUS call's already-fetched payload with
        # zero device work on the critical path; the call it dispatches is
        # fetched lazily at the following keystroke.  K=0 disables.
        self.speculate = int(speculate)
        # Next-kana predictor (feeds speculation):
        #   None      -> LM-driven (default): walk the lexicon's reading-
        #                prefix continuation index and score every candidate
        #                continuation word against the beam caches.  The
        #                probes PIGGYBACK on the keystroke/speculative device
        #                step (scores arrive in the same packed payload), so
        #                prediction costs zero extra round trips.
        #   "static"  -> corpus-frequency kana prior (prefix-blind);
        #   callable  -> custom ``predict(kana_prefix) -> [chars]``.
        self._static_rank = self._default_predictor()
        self._lm_probes = next_char_predictor is None
        self._custom_predict = (
            next_char_predictor if callable(next_char_predictor) else None
        )
        if self.speculate > 0:
            assert self.speculate <= self._A
            self._unified = jax.jit(
                functools.partial(
                    _unified_step, K=self.speculate,
                    N=config.max_nodes_per_frame, Q=self._Q, A=self._A,
                    config=config, precision=precision,
                    pallas_head=pallas_head,
                )
            )
            self._prime_jit = jax.jit(
                functools.partial(
                    _prime_step, config=config, precision=precision,
                    pallas_head=pallas_head,
                )
            )
        self.spec_hits = 0
        self.spec_misses = 0
        self.reset()

    def _default_predictor(self):
        """Static kana prior: corpus-frequency-weighted kana occurrence.

        Ranks every kana that appears in any vocab reading by the total
        corpus count of tokens containing it.  A pluggable
        ``next_char_predictor(kana_prefix) -> [chars]`` can replace this
        with an LM- or layout-aware model.
        """
        weight: dict = {}
        for tok, cnt in zip(self.vocab.tokens, np.asarray(self.vocab.counts)):
            for ch in tok.reading:
                weight[ch] = weight.get(ch, 0) + int(cnt)
        ranked = [c for c, _ in sorted(weight.items(), key=lambda kv: -kv[1])]

        def predict(_prefix: str):
            return ranked

        return predict

    def _build_probes(self, window: str):
        return build_probe_arrays(
            self.lexicon, self.config, self._Q, window,
            lm_probes=self._lm_probes,
        )

    def _rank_chars(self, probe_chars: List[str],
                    probe_scores: Optional[np.ndarray]) -> List[str]:
        """Merge device probe scores into a ranked next-kana list."""
        if self._custom_predict is not None:
            return list(self._custom_predict(self.kana))
        ranked: List[str] = []
        if probe_scores is not None and probe_chars:
            char_score: dict = {}
            for k, ch in enumerate(probe_chars):
                s = float(probe_scores[k])
                if s > char_score.get(ch, -1e31):
                    char_score[ch] = s
            ranked = [
                c for c, _ in sorted(char_score.items(), key=lambda kv: -kv[1])
            ]
        seen = set(ranked)
        for c in self._static_rank(self.kana):  # fill the tail
            if c not in seen:
                ranked.append(c)
        return ranked

    def reset(self) -> None:
        cfg = self.config
        B, L, H = cfg.beam_pad, cfg.num_layers, cfg.hidden_size
        T1 = cfg.max_kana_len + 1
        c, h, h_top, lse, eos = self._root(self.params)
        NEG = -1e30
        self._score = jnp.full((T1, B), NEG).at[0, 0].set(0.0)
        self._lse = jnp.zeros((T1, B)).at[0].set(lse)
        self._eos = jnp.zeros((T1, B)).at[0].set(eos)
        self._c = jnp.zeros((T1, L, B, H)).at[0].set(c)
        self._h = jnp.zeros((T1, L, B, H)).at[0].set(h)
        self._htop = jnp.zeros((T1, B, H)).at[0].set(h_top)
        self.kana = ""
        # window bookkeeping: positions are relative to self._base (the
        # number of kana already committed by window rolls; see _roll)
        self._base = 0
        self._committed: List[List[Tuple[str, int]]] = [
            [] for _ in range(cfg.beam_pad)
        ]
        self._frames: List[List[Node]] = [[]]  # frames[j] = nodes ending at j
        self._bp: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = [None]
        self._finals: List[Optional[np.ndarray]] = [None]
        self._ranked_next: Optional[List[str]] = None
        self._pending = None
        self._prefetched: dict = {}
        self._prime()

    def _walk(self, pos: int, beam: int) -> Tuple[List[Tuple[str, int]], int]:
        """Backtrack beam ``beam`` from window position ``pos`` to the root;
        returns (segments, root beam slot)."""
        segs: List[Tuple[str, int]] = []
        bi = beam
        while pos > 0:
            src, selp, seln = self._bp[pos]
            node = self._frames[pos][int(seln[bi])]
            segs.append((node.display, node.word_id))
            pos, bi = int(src[bi]), int(selp[bi])
        segs.reverse()
        return segs, bi

    def _roll(self) -> None:
        """Commit the current window and continue typing past the bound.

        The cache row at the window end becomes the new root row (scores
        WITHOUT <eos>, states, logsumexp — exactly decode_long's chaining,
        SURVEY.md §4.5 note on the forced boundary), and each beam's window
        segments append to its committed history.  O(1) device work; the
        session can now run indefinitely.  ``pop()`` cannot cross a roll
        boundary (the committed window's frames are released).
        """
        T_w = len(self.kana) - self._base
        B = self.config.beam_pad
        new_committed = []
        for b in range(B):
            segs, rb = self._walk(T_w, b)
            new_committed.append(self._committed[rb] + segs)
        self._committed = new_committed
        row = jnp.int32(T_w)
        self._score = self._score.at[0].set(self._score[row])
        self._lse = self._lse.at[0].set(self._lse[row])
        self._eos = self._eos.at[0].set(self._eos[row])
        self._c = self._c.at[0].set(self._c[row])
        self._h = self._h.at[0].set(self._h[row])
        self._htop = self._htop.at[0].set(self._htop[row])
        self._base += T_w
        self._frames = [[]]
        self._bp = [None]
        self._finals = [None]
        self._ranked_next = None
        self._prime()

    def _frame_nodes(self, pos: int, kana: Optional[str] = None) -> List[Node]:
        """Nodes ending at ``pos`` for a kana prefix (default: current).

        Same canonical order as :func:`jlm.decoder.lattice.build_lattice`
        (start ascending, dictionary order within a start), so incremental
        results are tie-for-tie identical to batch decoding.
        """
        cfg = self.config
        kana = self.kana[self._base:] if kana is None else kana
        M = min(cfg.max_word_len, self.lexicon.max_reading_len)
        nodes: List[Node] = []
        for start in range(max(0, pos - M), pos):
            reading = kana[start:pos]
            for wid, disp in self.lexicon.candidates(reading):
                display = disp if disp is not None else self.vocab.display(wid)
                nodes.append(Node(wid, start, pos, display))
        nodes.sort(key=lambda n: n.start)
        from jlm.decoder.lattice import handle_node_overflow

        handle_node_overflow(
            len(nodes) - cfg.max_nodes_per_frame, cfg, f"pos={pos}"
        )
        return nodes[: cfg.max_nodes_per_frame]

    def _nodes_tensor(self, nodes: List[Node]):
        N = self.config.max_nodes_per_frame
        nw = np.full(N, EOS_ID, np.int32)
        ns = np.zeros(N, np.int32)
        nm = np.zeros(N, bool)
        for k, n in enumerate(nodes):
            nw[k], ns[k], nm[k] = n.word_id, n.start, True
        return nw, ns, nm

    def _candidate_chars(self, window_next: str) -> List[str]:
        """Ordered candidate next-kana rows for the unified spec table.

        LM mode: every char the lexicon's prefix-continuation trie admits
        after ``window_next`` (trie order; the DEVICE ranks them by probe
        score).  Custom/static mode: the predictor's own order (no probes
        are scored, so the host prior IS the ranking).
        """
        A = self._A
        if not self._lm_probes:
            pred = (self._custom_predict or self._static_rank)
            return list(pred(self.kana))[:A]
        T = len(window_next)
        M = min(self.config.max_word_len, self.lexicon.max_reading_len)
        trie = self.lexicon.prefix_next()
        chars: List[str] = []
        seen = set()
        for p in range(max(0, T - M + 1), T + 1):
            for ch in trie.get(window_next[p:T], {}):
                if ch not in seen and len(chars) < A:
                    seen.add(ch)
                    chars.append(ch)
        for ch in self._static_rank(self.kana):  # fill remaining rows
            if ch not in seen and len(chars) < A:
                seen.add(ch)
                chars.append(ch)
        return chars

    def _spec_table(self, window_next: str, chars: Optional[List[str]] = None,
                    rows: Optional[int] = None):
        """Host tensors for candidate next kana (the device picks K).

        ``window_next`` includes the just-typed char; the table describes
        hypothetical frames at ``len(window_next) + 1``.  All rows are
        masked invalid when the window is full (the next push rolls
        first).  Default ``chars``: every trie-admissible continuation
        (the device ranks); ``rows`` defaults to the full table width A.
        """
        cfg = self.config
        pos1 = len(window_next) + 1
        A = self._A if rows is None else rows
        N, Q = cfg.max_nodes_per_frame, self._Q
        nw = np.full((A, N), EOS_ID, np.int32)
        ns = np.zeros((A, N), np.int32)
        nm = np.zeros((A, N), bool)
        pp = np.zeros((A, Q), np.int32)
        pw = np.full((A, Q), EOS_ID, np.int32)
        pm = np.zeros((A, Q), bool)
        ok = np.zeros(A, bool)
        # Fallback prior: far below any real probe logp, descending in row
        # order — carries predictor order in custom mode and breaks ties
        # for probe-less chars in LM mode.
        prior = np.full(A, -1e30, np.float32)
        meta: List[Optional[Tuple[str, List[Node], tuple]]] = [None] * A
        if pos1 <= cfg.max_kana_len:
            if chars is None:
                chars = self._candidate_chars(window_next)
            for a, ch in enumerate(chars[:A]):
                nodes = self._frame_nodes(pos1, window_next + ch)
                probes = self._build_probes(window_next + ch)
                nw[a], ns[a], nm[a] = self._nodes_tensor(nodes)
                pp[a], pw[a], pm[a] = probes[0], probes[1], probes[2]
                ok[a] = True
                prior[a] = -1e20 - a
                meta[a] = (ch, nodes, probes)
        return {
            "arrays": (nw, ns, nm, pp, pw, pm, ok, prior),
            "meta": meta,
        }

    def _prime(self) -> None:
        """Speculate the next frame with no typed frame to commit: seeds a
        fresh / rolled / popped / resumed session so the first keystroke
        can hit.  Host-ranked (no device probe scores exist yet)."""
        self._pending = None
        self._prefetched = {}
        if self.speculate <= 0:
            return
        window = self.kana[self._base:]
        if len(window) + 1 > self.config.max_kana_len:
            return
        ranked = self._ranked_next
        if ranked is None:
            ranked = self._rank_chars([], None)
        K = self.speculate
        table = self._spec_table(window, chars=ranked, rows=K)
        if not any(m is not None for m in table["meta"]):
            return
        nw, ns, nm, pp, pw, pm, _ok, _prior = table["arrays"]
        packed = self._prime_jit(
            self.params, self._score, self._lse, self._eos, self._c,
            self._h, self._htop, jnp.int32(len(window) + 1),
            jnp.asarray(nw), jnp.asarray(ns), jnp.asarray(nm),
            jnp.asarray(pp), jnp.asarray(pw), jnp.asarray(pm),
        )
        self._pending = {"packed": packed, "meta": table["meta"],
                         "kind": "prime"}
        self._start_prefetch()

    def _dispatch_unified(self, pos: int, nodes: List[Node],
                          probes: tuple) -> None:
        """Issue the one unified device call for a committed keystroke."""
        window_next = self.kana[self._base:]
        table = self._spec_table(window_next)
        chars = [m[0] if m else None for m in table["meta"]]
        # map each typed-frame probe to its candidate-char table row
        probe_char = np.full(self._Q, self._A, np.int32)  # A => no row
        for q, ch in enumerate(probes[3]):
            if ch in chars:
                probe_char[q] = chars.index(ch)
        nw, ns, nm = self._nodes_tensor(nodes)
        blob = pack_unified_blob(
            self.config.max_nodes_per_frame, self._Q, self._A,
            nw, ns, nm, np.asarray(probes[0]), np.asarray(probes[1]),
            np.asarray(probes[2]), probe_char, *table["arrays"],
        )
        caches, packed = self._unified(
            self.params, self._score, self._lse, self._eos, self._c,
            self._h, self._htop, jnp.int32(pos), jnp.asarray(blob),
        )
        (self._score, self._lse, self._eos, self._c, self._h,
         self._htop) = caches
        self._pending = {"packed": packed, "meta": table["meta"],
                         "kind": "unified"}
        self._start_prefetch()

    def _start_prefetch(self) -> None:
        """Fetch the pending payload on a background thread.

        The device→host fetch is the one per-keystroke cost the unified
        design cannot remove from the DEVICE side.  Fetching on a thread
        moves it into the user's think time: by the next keystroke the
        payload is host-resident and a predicted keystroke costs only host
        bookkeeping.
        """
        import threading

        pend = self._pending
        if pend is None:
            return

        def work():
            try:
                pend["fetched"] = np.asarray(pend["packed"])
            except Exception as e:  # surfaced on join in _fetch_pending
                pend["error"] = e

        # non-daemon: the thread lives one fetch; a daemon thread mid-fetch
        # at interpreter teardown aborts the process (pthread cancellation
        # inside the PJRT client)
        t = threading.Thread(target=work, daemon=False)
        pend["thread"] = t
        t.start()

    def _fetch_pending(self) -> None:
        """Unpack the last dispatched call's payload into ``_prefetched``.

        The fetch itself ran on the prefetch thread (see _start_prefetch);
        this joins it — during real typing the fetch overlaps the user's
        think time entirely.
        """
        if self._pending is None:
            return
        B, Q, K = self.config.beam_pad, self._Q, self.speculate
        stride = 4 * B + Q
        thread = self._pending.get("thread")
        if thread is not None:
            thread.join()
        if "error" in self._pending:
            raise self._pending["error"]
        out = self._pending.get("fetched")
        if out is None:
            out = np.asarray(self._pending["packed"])
        meta = self._pending["meta"]
        kind = self._pending["kind"]
        self._pending = None
        if kind == "prime":  # [K, stride]; row k is hypothesis meta[k]
            topk = np.arange(out.shape[0])
            payloads = out
        else:  # flat: typed stride | topk K | K spec payloads
            topk = out[stride:stride + K]
            payloads = out[stride + K:].reshape(K, stride)
        self._prefetched = {}
        for k, a in enumerate(topk):
            m = meta[int(a)] if 0 <= int(a) < len(meta) else None
            if m is None:
                continue
            ch, nodes, probes = m
            pay = payloads[k]
            self._prefetched[ch] = {
                "bp": (pay[:B], pay[B:2 * B], pay[2 * B:3 * B]),
                "finals": pay[3 * B:4 * B].view(np.float32),
                "probe_scores": pay[4 * B:].view(np.float32),
                "nodes": nodes,
                "probes": probes,
            }

    def push(self, kana_char: str, n_best: int = 1) -> List[DecodeResult]:
        assert len(kana_char) == 1, "push one kana at a time"
        cfg = self.config
        if len(self.kana) - self._base >= cfg.max_kana_len:
            self._roll()  # commit the full window, keep typing (was: assert)
        pos = len(self.kana) - self._base + 1
        self.kana += kana_char

        if self.speculate > 0:
            self._fetch_pending()
            hit = self._prefetched.pop(kana_char, None)
            self._prefetched = {}  # other hypotheses are now stale
            if hit is not None:
                # Predicted keystroke: results come from the PREVIOUS
                # call's payload — no device work on the critical path.
                self.spec_hits += 1
                nodes = hit["nodes"]
                bp, finals = hit["bp"], hit["finals"]
                probe_scores, probe_chars = (
                    hit["probe_scores"], hit["probes"][3]
                )
                typed_probes = hit["probes"]
            else:
                self.spec_misses += 1
                nodes = self._frame_nodes(pos)
                typed_probes = self._build_probes(self.kana[self._base:])
                bp = finals = probe_scores = None
                probe_chars = typed_probes[3]
            self._dispatch_unified(pos, nodes, typed_probes)
            if bp is None:
                # miss: fetch THIS call's payload for the typed results
                pend = self._pending
                self._fetch_pending()
                out = np.asarray(pend["packed"])
                B = cfg.beam_pad
                bp = (out[:B], out[B:2 * B], out[2 * B:3 * B])
                finals = out[3 * B:4 * B].view(np.float32)
                probe_scores = out[4 * B:4 * B + self._Q].view(np.float32)
        else:
            nodes = self._frame_nodes(pos)
            nw, ns, nm = self._nodes_tensor(nodes)
            pp, pw, pm, probe_chars = self._build_probes(
                self.kana[self._base:]
            )
            blob = np.concatenate([
                nw.ravel(), ns.ravel(), nm.astype(np.int32).ravel(),
                np.asarray(pp).ravel(), np.asarray(pw).ravel(),
                np.asarray(pm).astype(np.int32).ravel(),
            ]).astype(np.int32)
            caches, packed_out = self._step(
                self.params, self._score, self._lse, self._eos, self._c,
                self._h, self._htop, jnp.int32(pos), jnp.asarray(blob),
            )
            (self._score, self._lse, self._eos, self._c, self._h,
             self._htop) = caches
            B = cfg.beam_pad
            out = np.asarray(packed_out)  # single device fetch per keystroke
            bp = (out[:B], out[B:2 * B], out[2 * B:3 * B])
            finals = out[3 * B:4 * B].view(np.float32)
            probe_scores = (
                out[4 * B:].view(np.float32) if self._lm_probes else None
            )

        if len(self._frames) <= pos:
            self._frames.append(nodes)
            self._bp.append(None)
            self._finals.append(None)
        self._frames[pos] = nodes
        self._bp[pos] = bp
        self._finals[pos] = finals
        res = self.results(n_best)
        self._ranked_next = self._rank_chars(probe_chars, probe_scores)
        return res

    def pop(self) -> None:
        """Backspace: drop the last kana; cached prefix stays valid.

        Cannot cross a window-roll boundary: the committed window's frames
        are released at roll time (an IME would have committed that text).
        """
        assert self.kana, "nothing to pop"
        if len(self.kana) <= self._base:
            raise ValueError(
                "cannot backspace across a committed window boundary"
            )
        self.kana = self.kana[:-1]
        # in-flight speculation was for the longer prefix: discard it and
        # re-prime for the shortened one
        self._ranked_next = None
        self._prime()

    # --- session checkpoint/resume (SURVEY.md §7: decode streams are
    # resumable — the full session state is (c, h) caches + beams) --------
    def save_session(self, path: str) -> None:
        """Snapshot the typing session to one .npz (cheap: a few MB)."""
        import json

        arrays = {
            "score": np.asarray(self._score),
            "lse": np.asarray(self._lse),
            "eos": np.asarray(self._eos),
            "c": np.asarray(self._c),
            "h": np.asarray(self._h),
            "htop": np.asarray(self._htop),
        }
        T = len(self.kana) - self._base
        for pos in range(1, T + 1):
            src, selp, seln = self._bp[pos]
            arrays[f"bp{pos}"] = np.stack([src, selp, seln])
            arrays[f"fin{pos}"] = self._finals[pos]
        meta = {
            "kana": self.kana,
            "base": self._base,
            "committed": self._committed,
            # shape contract: every cached array is laid out with
            # beam_pad rows (which changed 16 -> 10 for beam 10 in round
            # 3); record it so resume under a different build fails loud
            # instead of mis-indexing (ADVICE r3).
            "beam_pad": self.config.beam_pad,
            "beam_width": self.config.beam_width,
            "frames": [
                [(n.word_id, n.start, n.end, n.display) for n in fr]
                for fr in self._frames[: T + 1]
            ],
        }
        np.savez(path, meta=np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8), **arrays)

    def load_session(self, path: str) -> None:
        """Resume a snapshot saved by :meth:`save_session`."""
        import json

        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            saved_pad = meta.get("beam_pad")
            if saved_pad is not None and saved_pad != self.config.beam_pad:
                raise ValueError(
                    f"session snapshot was saved with beam_pad={saved_pad} "
                    f"(beam_width={meta.get('beam_width')}); this decoder "
                    f"uses beam_pad={self.config.beam_pad} — cache/payload "
                    "shapes are incompatible, re-type the session"
                )
            self.kana = meta["kana"]
            self._base = meta.get("base", 0)
            self._committed = [
                [tuple(seg) for seg in beam]
                for beam in meta.get(
                    "committed", [[] for _ in range(self.config.beam_pad)]
                )
            ]
            self._frames = [
                [Node(w, s, e, d) for (w, s, e, d) in fr]
                for fr in meta["frames"]
            ]
            self._score = jnp.asarray(z["score"])
            self._lse = jnp.asarray(z["lse"])
            self._eos = jnp.asarray(z["eos"])
            self._c = jnp.asarray(z["c"])
            self._h = jnp.asarray(z["h"])
            self._htop = jnp.asarray(z["htop"])
            T = len(self.kana) - self._base
            self._bp = [None] * (T + 1)
            self._finals = [None] * (T + 1)
            for pos in range(1, T + 1):
                bp = z[f"bp{pos}"]
                self._bp[pos] = (bp[0], bp[1], bp[2])
                self._finals[pos] = z[f"fin{pos}"]
        self._ranked_next = None
        self._prime()

    def results(self, n_best: int = 1) -> List[DecodeResult]:
        T = len(self.kana) - self._base
        if T == 0:
            return []
        finals = self._finals[T]
        order = np.argsort(-finals, kind="stable")[:n_best]
        out = []
        for b in order:
            if finals[b] <= -1e29:
                continue
            segs, root = self._walk(T, int(b))
            segs = self._committed[root] + segs
            out.append(
                DecodeResult(
                    surface="".join(d for d, _ in segs),
                    score=float(finals[b]),
                    segments=segs,
                )
            )
        return out
