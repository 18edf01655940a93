"""Lattice construction from a kana string.

Rebuild of the reference's lattice builder (ref: JLM:decoder/decoder.py —
SURVEY.md §4.5): every lexicon word whose reading matches a substring
``r[i:j]`` becomes a node; nodes are grouped by end position ("frames");
single-kana fallback keeps the lattice connected.

This module is the SINGLE lattice implementation shared by the numpy oracle
and the device engine — both consume the same ``Lattice``, so candidate
sets, node ordering, and therefore tie-breaking can never diverge between
the golden fixture and the device path (parity discipline, SURVEY.md §9.3.5).

Canonical node order within a frame: start position ascending, then
dictionary (frequency) order — the same order the reference's
``for i: for j:`` construction loop appends in.  When a frame exceeds the
static node budget ``N_max`` it is truncated in this canonical order.

Besides the frame-major node arrays the builder also emits the
**lookahead table** used by the device engine's forward cache: for every
start position ``s``, the deduplicated list of word ids of nodes starting
at ``s`` (``lookahead_words[s]``) and, for each node, the index of its word
in that list (``cand_idx``).  The engine computes log-probs only for these
columns per step instead of materializing ``[B, V]`` scores.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from jlm.config import Config, EOS_ID, UNK_ID
from jlm.data.corpus import Vocab
from jlm.data.lexicon import Lexicon


def handle_node_overflow(dropped: int, config: Config, where: str) -> None:
    """Apply the configured policy when a frame exceeds the node budget.

    The reference's lattices are uncapped (SURVEY.md §4.5); dropping nodes
    can lose the gold path, so drops must never be silent by default.
    """
    if dropped <= 0 or config.node_overflow == "ignore":
        return
    msg = (
        f"lattice node overflow ({where}): {dropped} node(s) dropped beyond "
        f"max_nodes_per_frame={config.max_nodes_per_frame}; raise "
        f"max_nodes_per_frame to preserve reference parity "
        f"(reference lattices are uncapped)"
    )
    if config.node_overflow == "raise":
        raise ValueError(msg)
    warnings.warn(msg, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class Node:
    """One lattice arc: word ``word_id`` spanning kana ``(start, end]``.

    ``display`` overrides the vocab display for ``<unk>`` fallback nodes
    (the raw kana itself).
    """

    word_id: int
    start: int
    end: int
    display: str


@dataclasses.dataclass
class Lattice:
    """Frames + padded device tensors for one kana string."""

    kana: str
    frames: List[List[Node]]  # frames[j] = nodes ending at j, j in 0..T (0 empty)

    # Padded device-side encoding (all shapes static per Config):
    node_word: np.ndarray   # int32 [T_max, N_max]  word id per node (frame j-1 at row j-1)
    node_start: np.ndarray  # int32 [T_max, N_max]  start position per node
    node_mask: np.ndarray   # bool  [T_max, N_max]
    node_cand_idx: np.ndarray   # int32 [T_max, N_max] index into lookahead_words[start]
    lookahead_words: np.ndarray  # int32 [T_max + 1, C_max] word ids starting at s
    lookahead_mask: np.ndarray   # bool  [T_max + 1, C_max]
    length: int  # T = len(kana)
    dropped_nodes: int = 0  # nodes truncated beyond the per-frame budget


def build_lattice(
    kana: str, lexicon: Lexicon, vocab: Vocab, config: Config
) -> Lattice:
    T = len(kana)
    assert 0 < T <= config.max_kana_len, (
        f"kana length {T} exceeds max_kana_len {config.max_kana_len}"
    )
    M = min(config.max_word_len, lexicon.max_reading_len)
    N_max = config.max_nodes_per_frame
    C_max = config.max_lookahead
    T_max = config.max_kana_len

    frames: List[List[Node]] = [[] for _ in range(T + 1)]
    # Canonical construction order: i (start) ascending, j (end) ascending,
    # dictionary order within a reading (ref loop structure, SURVEY.md §4.5).
    for i in range(T):
        for j in range(i + 1, min(i + M, T) + 1):
            reading = kana[i:j]
            for wid, disp in lexicon.candidates(reading):
                display = disp if disp is not None else vocab.display(wid)
                frames[j].append(Node(wid, i, j, display))
    # Connectivity guarantee: candidates() already yields an <unk> fallback
    # for any single kana, so frames[i+1] is never empty.

    # Frame-major sort + truncation in canonical order (start asc, then
    # append order which is frequency order within a start).
    dropped = 0
    for j in range(1, T + 1):
        frames[j].sort(key=lambda n: n.start)  # stable: keeps dict order per start
        if len(frames[j]) > N_max:
            dropped += len(frames[j]) - N_max
            frames[j] = frames[j][:N_max]
    handle_node_overflow(dropped, config, f"kana={kana!r}")

    # Lookahead sets: words of surviving nodes grouped by start position.
    lookahead: List[List[int]] = [[] for _ in range(T_max + 1)]
    look_index: List[Dict[int, int]] = [dict() for _ in range(T_max + 1)]
    for j in range(1, T + 1):
        for n in frames[j]:
            if n.word_id not in look_index[n.start]:
                assert len(lookahead[n.start]) < C_max, (
                    f"lookahead overflow at pos {n.start}: raise max_lookahead"
                )
                look_index[n.start][n.word_id] = len(lookahead[n.start])
                lookahead[n.start].append(n.word_id)

    node_word = np.full((T_max, N_max), EOS_ID, np.int32)
    node_start = np.zeros((T_max, N_max), np.int32)
    node_mask = np.zeros((T_max, N_max), bool)
    node_cand_idx = np.zeros((T_max, N_max), np.int32)
    for j in range(1, T + 1):
        for k, n in enumerate(frames[j]):
            node_word[j - 1, k] = n.word_id
            node_start[j - 1, k] = n.start
            node_mask[j - 1, k] = True
            node_cand_idx[j - 1, k] = look_index[n.start][n.word_id]

    lookahead_words = np.full((T_max + 1, C_max), EOS_ID, np.int32)
    lookahead_mask = np.zeros((T_max + 1, C_max), bool)
    for s in range(T_max + 1):
        for c, wid in enumerate(lookahead[s]):
            lookahead_words[s, c] = wid
            lookahead_mask[s, c] = True

    return Lattice(
        kana=kana,
        frames=frames,
        node_word=node_word,
        node_start=node_start,
        node_mask=node_mask,
        node_cand_idx=node_cand_idx,
        lookahead_words=lookahead_words,
        lookahead_mask=lookahead_mask,
        length=T,
        dropped_nodes=dropped,
    )
