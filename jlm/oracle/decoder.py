"""Numpy beam-pruned Viterbi decoder — the golden conversion oracle.

Independent re-implementation of SURVEY.md §4.6–§4.7 (ref:
JLM:decoder/decoder.py ``Decoder.decode``) over the shared
:mod:`jlm.decoder.lattice`.

Formulation (the "cached forward" form the device engine mirrors exactly):
when the beam at position ``s`` is finalized, one batched LM step feeds each
path's last word into its predecessor state, caching ``logp_next[B, V]`` and
the post state.  A later frame-``j`` extension of node ``(w, start=s)`` by
path ``p`` scores ``score[s][p] + logp_next[s][p][w]`` — identical to the
reference's per-frame batched predict (§4.6), but with the LM call hoisted
to beam-finalization time so the device version needs exactly one fixed
shape forward per frame.

Frozen parity rules (SURVEY.md §9.3.5):
- extensions enumerate node-major (canonical lattice order) then path-minor;
- top-k selection is a *stable* sort on descending score (ties keep
  enumeration order — matching ``lax.top_k``'s lower-index-first rule);
- final scores add ``logp(<eos>)`` from the last beam (eos rescoring);
- all score math in fp32 with max-subtracted logsumexp.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from jlm.config import Config, EOS_ID
from jlm.data.corpus import Vocab
from jlm.data.lexicon import Lexicon
from jlm.decoder.lattice import Lattice, Node, build_lattice
from jlm.oracle.lm import OracleLM


@dataclasses.dataclass
class DecodeResult:
    surface: str
    score: float
    segments: List[Tuple[str, int]]  # (display, word_id) per lattice arc


@dataclasses.dataclass
class _Path:
    score: float
    history: Tuple[Node, ...]
    # set when the beam at this position is finalized:
    logp_next: Optional[np.ndarray] = None  # [V]
    post_c: Optional[np.ndarray] = None  # [L, H]
    post_h: Optional[np.ndarray] = None  # [L, H]


class OracleDecoder:
    def __init__(self, lm: OracleLM, lexicon: Lexicon, vocab: Vocab, config: Config):
        self.lm = lm
        self.lexicon = lexicon
        self.vocab = vocab
        self.config = config

    def _forward_beam(self, paths: List[_Path], pred_c, pred_h, words) -> None:
        """Batched LM step for a finalized beam; fills the forward cache."""
        logp, (c, h) = self.lm.step(
            np.asarray(words, np.int32), (pred_c, pred_h)
        )
        for k, p in enumerate(paths):
            p.logp_next = logp[k]
            p.post_c = c[:, k]
            p.post_h = h[:, k]

    def decode(self, kana: str, n_best: int = 1) -> List[DecodeResult]:
        cfg = self.config
        lattice = build_lattice(kana, self.lexicon, self.vocab, cfg)
        T = lattice.length
        B = cfg.beam_width

        beams: List[List[_Path]] = [[] for _ in range(T + 1)]
        root = _Path(score=0.0, history=())
        c0, h0 = self.lm.initial_state(1)
        beams[0] = [root]
        self._forward_beam([root], c0, h0, [EOS_ID])

        for pos in range(1, T + 1):
            # Enumerate extensions node-major, path-minor (parity order).
            exts: List[Tuple[float, Node, int, int]] = []
            for node in lattice.frames[pos]:
                for pi, path in enumerate(beams[node.start]):
                    s = path.score + float(path.logp_next[node.word_id])
                    exts.append((s, node, node.start, pi))
            if not exts:
                continue
            scores = np.asarray([e[0] for e in exts], np.float32)
            order = np.argsort(-scores, kind="stable")[:B]

            new_paths: List[_Path] = []
            pred_c = np.zeros((cfg.num_layers, len(order), cfg.hidden_size), np.float32)
            pred_h = np.zeros_like(pred_c)
            words = []
            for k, ei in enumerate(order):
                s, node, src_pos, pi = exts[ei]
                src = beams[src_pos][pi]
                new_paths.append(_Path(score=s, history=src.history + (node,)))
                pred_c[:, k] = src.post_c
                pred_h[:, k] = src.post_h
                words.append(node.word_id)
            beams[pos] = new_paths
            self._forward_beam(new_paths, pred_c, pred_h, words)

        # Final <eos> rescoring over the last beam (SURVEY.md §4.6).
        finals = [
            (p.score + float(p.logp_next[EOS_ID]), p) for p in beams[T]
        ]
        order = np.argsort(
            -np.asarray([f[0] for f in finals], np.float32), kind="stable"
        )[:n_best]
        results = []
        for ei in order:
            score, p = finals[ei]
            segs = [(n.display, n.word_id) for n in p.history]
            results.append(
                DecodeResult(
                    surface="".join(d for d, _ in segs), score=score, segments=segs
                )
            )
        return results
