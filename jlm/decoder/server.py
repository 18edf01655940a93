"""Multi-session IME serving: batched per-keystroke steps.

Production deployment serves MANY concurrent typing sessions; the
per-keystroke engine (SURVEY.md §4.7) must batch keystrokes arriving from
different sessions into one device step or throughput dies by dispatch
latency.  ``SessionServer`` holds ``max_sessions`` session states in
device arrays with a leading session axis and advances an arbitrary batch
of ``(session, kana_char)`` events per jitted call:

- per-event frame nodes are built host-side (same canonical rules as the
  lattice builder — parity with single-session decoding is exact);
- the device step gathers each event's beam/caches by session index,
  scores extensions lazily (cached per-path logsumexp + candidate-column
  logits, as in :mod:`jlm.decoder.incremental`), prunes, runs ONE
  LM forward over all events' beams, and scatters results back;
- event batches pad to power-of-two buckets (bounded compile count).

Session lifecycle: ``open() -> sid``, ``push(events)``, ``results(sid)``,
``backspace(sid)``, ``close(sid)``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from jlm.config import Config, EOS_ID
from jlm.data.corpus import Vocab
from jlm.data.lexicon import Lexicon
from jlm.decoder.lattice import Node
from jlm.decoder.incremental import _forward_with_lse, pallas_head_args
from jlm.models.lstm import node_logits as _node_logits
from jlm.oracle.decoder import DecodeResult


def _batch_keystroke_step(
    params,
    score_c,  # [Smax, T+1, B]
    lse_c,  # [Smax, T+1, B]
    eos_c,  # [Smax, T+1, B]
    c_c,  # [Smax, T+1, B, L, H]
    h_c,  # [Smax, T+1, B, L, H]
    htop_c,  # [Smax, T+1, B, H]
    sid,  # int32 [E] session index per event
    pos,  # int32 [E] new end position per event (1-based)
    node_word,  # int32 [E, N]
    node_start,  # int32 [E, N]
    node_mask,  # bool [E, N]
    ev_mask,  # bool [E] real event (not padding)
    probe_pos,  # int32 [E, Q] next-kana predictor probes (piggybacked, as
    probe_wid,  # int32 [E, Q]  in incremental._frame_rows — scores ride
    probe_mask,  # bool [E, Q]  the same packed payload, zero extra fetches)
    *,
    config: Config,
    precision: str,
    pallas_head=None,
):
    E, N = node_word.shape
    B = config.beam_pad
    L, H = config.num_layers, config.hidden_size
    NEG = jnp.float32(-1e30)

    # Per-event caches gathered by session: [E, T+1, ...]
    def ses(x):
        return jnp.take(x, sid, axis=0)

    htop_e = ses(htop_c)  # [E, T+1, B, H]
    h_src = jnp.take_along_axis(
        htop_e, node_start[:, :, None, None], axis=1
    )  # [E, N, B, H]
    # lazy logits: one output-column gather per (event, node), O(E·N·B·H)
    logits = _node_logits(params, config, h_src, node_word, precision)

    score_e = jnp.take_along_axis(ses(score_c), node_start[:, :, None], axis=1)
    lse_e = jnp.take_along_axis(ses(lse_c), node_start[:, :, None], axis=1)
    ext = score_e + logits - lse_e
    ext = jnp.where(node_mask[:, :, None], ext, NEG)

    from jlm.decoder.engine import topk_stable

    top_scores, top_idx = topk_stable(
        ext.reshape(E, N * B), B, config.topk_mode
    )
    top_scores = jnp.where(jnp.arange(B) < config.beam_width, top_scores, NEG)
    sel_n = top_idx // B
    sel_p = top_idx % B
    src_pos = jnp.take_along_axis(node_start, sel_n, axis=1)  # [E, B]
    new_words = jnp.take_along_axis(node_word, sel_n, axis=1)

    flat = (src_pos * B + sel_p)[:, :, None, None]
    T1 = score_c.shape[1]
    c_sel = jnp.take_along_axis(ses(c_c).reshape(E, T1 * B, L, H), flat, axis=1)
    h_sel = jnp.take_along_axis(ses(h_c).reshape(E, T1 * B, L, H), flat, axis=1)
    c_in = jnp.moveaxis(c_sel, 2, 0).reshape(L, E * B, H)
    h_in = jnp.moveaxis(h_sel, 2, 0).reshape(L, E * B, H)

    (c2, h2), h_top, lse, eos = _forward_with_lse(
        params, config, new_words.reshape(E * B), (c_in, h_in), precision,
        pallas_head,
    )

    # scatter back per event at (sid, pos); padding events scatter to a
    # dummy session row (Smax-1 is reserved) so they never disturb state.
    Smax = score_c.shape[0]
    sid_w = jnp.where(ev_mask, sid, Smax - 1)
    pos_w = jnp.where(ev_mask, pos, 0)

    score_c = score_c.at[sid_w, pos_w].set(top_scores, mode="drop")
    lse_c = lse_c.at[sid_w, pos_w].set(lse.reshape(E, B), mode="drop")
    eos_c = eos_c.at[sid_w, pos_w].set(eos.reshape(E, B), mode="drop")
    c_new = jnp.moveaxis(c2.reshape(L, E, B, H), 0, 2)  # [E, B, L, H]
    h_new = jnp.moveaxis(h2.reshape(L, E, B, H), 0, 2)
    c_c = c_c.at[sid_w, pos_w].set(c_new, mode="drop")
    h_c = h_c.at[sid_w, pos_w].set(h_new, mode="drop")
    htop_c = htop_c.at[sid_w, pos_w].set(h_top.reshape(E, B, H), mode="drop")

    finals = top_scores + eos.reshape(E, B)

    # Continuation probes against the post-commit rows (probe_pos == pos
    # reads the freshly computed values, matching incremental._frame_rows).
    # Q == 0 statically compiles the probe work away (SessionServer
    # probes=False).
    Q = probe_wid.shape[1]
    if Q == 0:
        packed = jnp.concatenate(
            [
                src_pos.astype(jnp.int32),
                sel_p.astype(jnp.int32),
                sel_n.astype(jnp.int32),
                jax.lax.bitcast_convert_type(finals, jnp.int32),
            ],
            axis=1,
        )  # [E, 4*B]
        return (score_c, lse_c, eos_c, c_c, h_c, htop_c), packed
    at_new = probe_pos == pos[:, None]  # [E, Q]
    sc_pq = jnp.take_along_axis(ses(score_c), probe_pos[:, :, None], axis=1)
    sc_pq = jnp.where(at_new[:, :, None], top_scores[:, None, :], sc_pq)
    ls_pq = jnp.take_along_axis(ses(lse_c), probe_pos[:, :, None], axis=1)
    ls_pq = jnp.where(
        at_new[:, :, None], lse.reshape(E, B)[:, None, :], ls_pq
    )
    ht_pq = jnp.take_along_axis(
        ses(htop_c), probe_pos[:, :, None, None], axis=1
    )  # [E, Q, B, H]
    ht_pq = jnp.where(
        at_new[:, :, None, None], h_top.reshape(E, 1, B, H), ht_pq
    )
    p_logits = _node_logits(params, config, ht_pq, probe_wid, precision)
    p_best = jnp.max(sc_pq + p_logits - ls_pq, axis=2)  # [E, Q]
    p_best = jnp.where(probe_mask, p_best, NEG)

    packed = jnp.concatenate(
        [
            src_pos.astype(jnp.int32),
            sel_p.astype(jnp.int32),
            sel_n.astype(jnp.int32),
            jax.lax.bitcast_convert_type(finals, jnp.int32),
            jax.lax.bitcast_convert_type(p_best, jnp.int32),
        ],
        axis=1,
    )  # [E, 4*B + Q]
    return (score_c, lse_c, eos_c, c_c, h_c, htop_c), packed


class SessionServer:
    def __init__(
        self,
        params,
        lexicon: Lexicon,
        vocab: Vocab,
        config: Config,
        max_sessions: int = 64,
        precision: str = "highest",
        probes: bool = True,
        use_pallas: Optional[bool] = None,
        interpret: bool = False,
    ):
        """``probes=False`` compiles the next-kana probe scoring out of
        the batched step (suggest_next then returns []) for
        latency-critical deployments that don't surface suggestions.

        ``use_pallas`` (auto: :func:`jlm.backend.use_kernels`, GPU speed
        mode) routes the batched step's softmax normalizer through the
        vocab-tiled project_lse kernel — at the config-5 serving shape
        (64 events x beam 10 x 100k vocab) the jnp path materializes
        ~256 MB of fp32 logits per step only to get an lse.
        ``interpret=True`` runs that kernel in the Pallas interpreter."""
        self.params = jax.tree.map(jnp.asarray, params)
        self.lexicon = lexicon
        self.vocab = vocab
        self.config = config
        pallas_head = pallas_head_args(config, precision, use_pallas,
                                       interpret)
        # one extra reserved row absorbs padding-event scatters
        self.Smax = max_sessions + 1
        self._step = jax.jit(
            functools.partial(
                _batch_keystroke_step, config=config, precision=precision,
                pallas_head=pallas_head,
            )
        )
        cfg = config
        B, L, H, T1 = cfg.beam_pad, cfg.num_layers, cfg.hidden_size, cfg.max_kana_len + 1
        self._score = jnp.full((self.Smax, T1, B), -1e30)
        self._lse = jnp.zeros((self.Smax, T1, B))
        self._eos = jnp.zeros((self.Smax, T1, B))
        self._c = jnp.zeros((self.Smax, T1, B, L, H))
        self._h = jnp.zeros((self.Smax, T1, B, L, H))
        self._htop = jnp.zeros((self.Smax, T1, B, H))
        self._root: Optional[Tuple] = None
        self._free = list(range(max_sessions))
        self._kana: Dict[int, str] = {}
        self._frames: Dict[int, List[List[Node]]] = {}
        self._bp: Dict[int, List] = {}
        self._finals: Dict[int, List] = {}
        # window-roll bookkeeping (parity with IncrementalDecoder._roll):
        # _base[sid] = kana committed by rolls; _committed[sid][b] = each
        # beam slot's committed segments
        self._base: Dict[int, int] = {}
        self._committed: Dict[int, List[List[Tuple[str, int]]]] = {}
        # piggybacked next-kana probe state (0 = compiled out)
        self._Q = 96 if probes else 0
        self._probe_chars: Dict[int, List[str]] = {}
        self._probe_scores: Dict[int, Optional[np.ndarray]] = {}

    # --- session lifecycle -------------------------------------------------
    def open(self) -> int:
        assert self._free, "session pool exhausted"
        sid = self._free.pop()
        if self._root is None:
            self._root = self._compute_root()
        c, h, h_top, lse, eos = self._root
        self._score = self._score.at[sid].set(-1e30).at[sid, 0, 0].set(0.0)
        self._lse = self._lse.at[sid, 0].set(lse)
        self._eos = self._eos.at[sid, 0].set(eos)
        self._c = self._c.at[sid, 0].set(c)
        self._h = self._h.at[sid, 0].set(h)
        self._htop = self._htop.at[sid, 0].set(h_top)
        self._kana[sid] = ""
        self._frames[sid] = [[]]
        self._bp[sid] = [None]
        self._finals[sid] = [None]
        self._base[sid] = 0
        self._committed[sid] = [[] for _ in range(self.config.beam_pad)]
        self._probe_chars[sid] = []
        self._probe_scores[sid] = None
        return sid

    def _compute_root(self):
        from jlm.models.lstm import initial_state

        cfg = self.config
        B = cfg.beam_pad
        state = initial_state(cfg, B)
        (c, h), h_top, lse, eos = _forward_with_lse(
            self.params, cfg, jnp.full((B,), EOS_ID, jnp.int32), state,
            "highest",
        )
        # [L,B,H] -> [B,L,H]
        return jnp.moveaxis(c, 0, 1), jnp.moveaxis(h, 0, 1), h_top, lse, eos

    def close(self, sid: int) -> None:
        for d in (self._kana, self._frames, self._bp, self._finals,
                  self._base, self._committed, self._probe_chars,
                  self._probe_scores):
            d.pop(sid, None)
        self._free.append(sid)

    def backspace(self, sid: int) -> None:
        assert self._kana[sid], "nothing to delete"
        if len(self._kana[sid]) <= self._base[sid]:
            raise ValueError(
                "cannot backspace across a committed window boundary"
            )
        self._kana[sid] = self._kana[sid][:-1]

    def _walk(self, sid: int, pos: int, beam: int):
        """Backtrack beam ``beam`` from window position ``pos``; returns
        (segments, root beam slot)."""
        segs: List[Tuple[str, int]] = []
        bi = beam
        while pos > 0:
            src, selp, seln = self._bp[sid][pos]
            node = self._frames[sid][pos][int(seln[bi])]
            segs.append((node.display, node.word_id))
            pos, bi = int(src[bi]), int(selp[bi])
        segs.reverse()
        return segs, bi

    def _roll(self, sid: int) -> None:
        """Commit a full window and keep typing (VERDICT r3 weak #6: the
        server previously hard-asserted at max_kana_len while the
        single-session IncrementalDecoder rolled).  The window-end cache
        row becomes the session's new root row; each beam's window
        segments append to its committed history."""
        T_w = len(self._kana[sid]) - self._base[sid]
        B = self.config.beam_pad
        new_committed = []
        for b in range(B):
            segs, rb = self._walk(sid, T_w, b)
            new_committed.append(self._committed[sid][rb] + segs)
        self._committed[sid] = new_committed
        row = jnp.int32(T_w)
        self._score = self._score.at[sid, 0].set(self._score[sid, row])
        self._lse = self._lse.at[sid, 0].set(self._lse[sid, row])
        self._eos = self._eos.at[sid, 0].set(self._eos[sid, row])
        self._c = self._c.at[sid, 0].set(self._c[sid, row])
        self._h = self._h.at[sid, 0].set(self._h[sid, row])
        self._htop = self._htop.at[sid, 0].set(self._htop[sid, row])
        self._base[sid] += T_w
        self._frames[sid] = [[]]
        self._bp[sid] = [None]
        self._finals[sid] = [None]

    # --- batched keystrokes ------------------------------------------------
    def _frame_nodes(self, sid: int, pos: int) -> List[Node]:
        cfg = self.config
        kana = self._kana[sid][self._base[sid]:]
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
            len(nodes) - cfg.max_nodes_per_frame, cfg, f"sid={sid} pos={pos}"
        )
        return nodes[: cfg.max_nodes_per_frame]

    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def push(self, events: Sequence[Tuple[int, str]]) -> None:
        """Advance a batch of sessions by one kana each (one device step).

        ``events`` = [(sid, kana_char)]; a session may appear at most once
        per batch.
        """
        cfg = self.config
        E_real = len(events)
        assert E_real > 0
        sids = [s for s, _ in events]
        assert len(set(sids)) == E_real, "duplicate session in one batch"
        # roll any session whose window is full BEFORE batching (rare:
        # once per max_kana_len keystrokes per session)
        for sid, _ in events:
            if len(self._kana[sid]) - self._base[sid] >= cfg.max_kana_len:
                self._roll(sid)
        E = self._bucket(E_real)
        N, Q = cfg.max_nodes_per_frame, self._Q

        sid_a = np.zeros(E, np.int32)
        pos_a = np.zeros(E, np.int32)
        nw = np.full((E, N), EOS_ID, np.int32)
        ns = np.zeros((E, N), np.int32)
        nm = np.zeros((E, N), bool)
        ev = np.zeros(E, bool)
        pp = np.zeros((E, Q), np.int32)
        pw = np.full((E, Q), EOS_ID, np.int32)
        pm = np.zeros((E, Q), bool)
        frames_new: List[List[Node]] = []
        from jlm.decoder.incremental import build_probe_arrays

        for i, (sid, ch) in enumerate(events):
            assert len(ch) == 1, "one kana per event"
            pos = len(self._kana[sid]) - self._base[sid] + 1
            self._kana[sid] += ch
            nodes = self._frame_nodes(sid, pos)
            frames_new.append(nodes)
            sid_a[i], pos_a[i], ev[i] = sid, pos, True
            for k, n in enumerate(nodes):
                nw[i, k], ns[i, k], nm[i, k] = n.word_id, n.start, True
            probes = build_probe_arrays(
                self.lexicon, cfg, Q, self._kana[sid][self._base[sid]:]
            )
            pp[i], pw[i], pm[i] = probes[0], probes[1], probes[2]
            self._probe_chars[sid] = probes[3]

        caches = (self._score, self._lse, self._eos, self._c, self._h, self._htop)
        caches, packed = self._step(
            self.params, *caches,
            jnp.asarray(sid_a), jnp.asarray(pos_a),
            jnp.asarray(nw), jnp.asarray(ns), jnp.asarray(nm), jnp.asarray(ev),
            jnp.asarray(pp), jnp.asarray(pw), jnp.asarray(pm),
        )
        (self._score, self._lse, self._eos, self._c, self._h, self._htop) = caches
        B = cfg.beam_pad
        out = np.asarray(packed)  # [E, 4B+Q] — one fetch for the whole batch
        for i, (sid, _) in enumerate(events):
            pos = int(pos_a[i])
            while len(self._frames[sid]) <= pos:
                self._frames[sid].append([])
                self._bp[sid].append(None)
                self._finals[sid].append(None)
            self._frames[sid][pos] = frames_new[i]
            self._bp[sid][pos] = (
                out[i, :B], out[i, B:2 * B], out[i, 2 * B:3 * B]
            )
            self._finals[sid][pos] = out[i, 3 * B:4 * B].view(np.float32)
            self._probe_scores[sid] = out[i, 4 * B:].view(np.float32)

    def suggest_next(self, sid: int, k: int = 8) -> List[str]:
        """LM-ranked likely next kana for a session (zero extra fetches: the
        probe scores rode the last push's payload)."""
        scores = self._probe_scores.get(sid)
        chars = self._probe_chars.get(sid, [])
        if scores is None or not chars:
            return []
        best: Dict[str, float] = {}
        for q, ch in enumerate(chars):
            s = float(scores[q])
            if s > best.get(ch, -1e31):
                best[ch] = s
        return [c for c, _ in sorted(best.items(), key=lambda kv: -kv[1])][:k]

    def results(self, sid: int, n_best: int = 1) -> List[DecodeResult]:
        T = len(self._kana[sid]) - self._base[sid]
        if T == 0:
            return []
        finals = self._finals[sid][T]
        order = np.argsort(-finals, kind="stable")[:n_best]
        res = []
        for b in order:
            if finals[b] <= -1e29:
                continue
            segs, root = self._walk(sid, T, int(b))
            segs = self._committed[sid][root] + segs
            res.append(
                DecodeResult(
                    surface="".join(d for d, _ in segs),
                    score=float(finals[b]),
                    segments=segs,
                )
            )
        return res
