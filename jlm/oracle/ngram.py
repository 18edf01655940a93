"""N-gram baseline LM for the conversion-quality comparison.

The reference's headline quality result is "LSTM LM beats the n-gram
baseline on conversion accuracy" (SURVEY.md §8 quality row; ref:
JLM:README.md / arXiv:1810.09309 compares against an n-gram KKC baseline).
This module supplies that baseline for OUR corpus: an interpolated
absolute-discount bigram (and its unigram special case) trained on encoded
corpus lines, exposing the same ``initial_state``/``step`` interface as
:class:`jlm.oracle.lm.OracleLM` so the unchanged
:class:`jlm.oracle.decoder.OracleDecoder` performs EXACT Viterbi
search over the lattice with it (an n-gram LM is Markov, so beam search
with a wide-enough beam is exact — the classic-engine configuration the
reference improves on).

State convention: the decoder feeds each path's *last word* into ``step``,
which for a bigram is the entire needed history — the carried (c, h)
arrays are shape-compatible dummies (use ``ngram_config`` below).
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

from jlm.config import EOS_ID, Config
from jlm.data.corpus import Vocab, parse_line

State = Tuple[np.ndarray, np.ndarray]


def ngram_config(base: Config) -> Config:
    """Decode config for n-gram scoring: same lattice params, dummy dims.

    ``OracleDecoder`` allocates per-path state buffers of
    ``[num_layers, hidden_size]`` — 1×1 for the stateless n-gram.
    """
    return base.replace(num_layers=1, hidden_size=1)


class NgramLM:
    """Interpolated absolute-discount bigram / unigram LM.

    P(w|v) = max(c(v,w) - d, 0)/c(v) + d·T(v)/c(v) · P_uni(w)
    with ``T(v)`` the number of distinct continuations of ``v`` and
    P_uni add-α smoothed over the full vocab; ``order=1`` is plain
    add-α unigram.
    """

    def __init__(self, vocab: Vocab, order: int = 2, discount: float = 0.75,
                 alpha: float = 0.1):
        assert order in (1, 2)
        self.order = order
        self.V = len(vocab)
        self.discount = discount
        self.alpha = alpha
        self._uni = np.zeros(self.V, np.int64)
        self._big: dict = {}

    def fit_lines(self, lines: Iterable[str], vocab: Vocab) -> "NgramLM":
        seqs = []
        for line in lines:
            toks = parse_line(line)
            if toks:
                seqs.append([vocab.lookup(t) for t in toks] + [EOS_ID])
        return self.fit(seqs)

    def fit(self, id_sentences: Iterable[List[int]]) -> "NgramLM":
        for ids in id_sentences:
            prev = EOS_ID  # sentences start after an <eos>
            for w in ids:
                self._uni[w] += 1
                if self.order >= 2:
                    self._big.setdefault(prev, {})[w] = (
                        self._big.get(prev, {}).get(w, 0) + 1
                    )
                prev = w
        # precompute smoothed unigram logp and per-context rows
        u = self._uni + self.alpha
        self._logp_uni = np.log(u / u.sum()).astype(np.float32)
        self._rows: dict = {}
        return self

    def _row(self, v: int) -> np.ndarray:
        """log P(· | v) as a dense [V] fp32 row (cached per context)."""
        if self.order == 1:
            return self._logp_uni
        row = self._rows.get(v)
        if row is None:
            cont = self._big.get(v)
            p_uni = np.exp(self._logp_uni)
            if not cont:
                p = p_uni
            else:
                c_v = sum(cont.values())
                t_v = len(cont)
                p = (self.discount * t_v / c_v) * p_uni
                for w, c in cont.items():
                    p[w] += max(c - self.discount, 0.0) / c_v
            row = np.log(np.maximum(p, 1e-30)).astype(np.float32)
            self._rows[v] = row
        return row

    # --- OracleLM interface ------------------------------------------------
    def initial_state(self, batch: int) -> State:
        z = np.zeros((1, batch, 1), np.float32)
        return z, z.copy()

    def step(self, word_ids: np.ndarray, state: State):
        logp = np.stack([self._row(int(w)) for w in word_ids])
        b = len(word_ids)
        z = np.zeros((1, b, 1), np.float32)
        return logp, (z, z.copy())

    def sequence_nll(self, ids: np.ndarray) -> float:
        total = 0.0
        for t in range(len(ids) - 1):
            total -= float(self._row(int(ids[t]))[int(ids[t + 1])])
        return total / max(1, len(ids) - 1)
