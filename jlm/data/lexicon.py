"""Reading dictionary for lattice construction.

Rebuild of the reference's lexicon (ref: built in JLM:data/, consumed in
JLM:decoder/decoder.py — SURVEY.md §3.1 "Lexicon / reading dictionary",
§4.1): a ``reading → [word ids]`` multimap over the vocab's
display/reading/POS triples, plus single-kana fallback entries so every
length-1 substring has at least one node and the lattice stays connected.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from jlm.config import UNK_ID
from jlm.data.corpus import Vocab


@dataclasses.dataclass
class Lexicon:
    """``reading → candidate word ids`` with unknown-kana fallback.

    ``by_reading`` holds real vocab entries.  ``fallback(r)`` returns the
    candidates for a single kana char ``r`` even when it is out-of-vocab:
    the surface form is the kana itself and the id is ``<unk>`` (scored by
    the LM's unk probability), mirroring the reference's single-char
    fallback mechanism [SURVEY.md §4.1, C-high].
    """

    by_reading: Dict[str, List[int]]
    max_reading_len: int

    @staticmethod
    def from_vocab(vocab: Vocab) -> "Lexicon":
        by_reading: Dict[str, List[int]] = {}
        max_len = 1
        # Iterate in id order => candidate lists are frequency-ordered, which
        # makes truncation under a node budget keep the most frequent words.
        for wid, tok in enumerate(vocab.tokens):
            if not tok.reading:
                continue  # specials
            by_reading.setdefault(tok.reading, []).append(wid)
            max_len = max(max_len, len(tok.reading))
        return Lexicon(by_reading=by_reading, max_reading_len=max_len)

    def prefix_next(self) -> Dict[str, Dict[str, List[int]]]:
        """``strict-prefix → {next_char: [word ids]}`` continuation index.

        For every reading ``r`` and every strict prefix ``p`` of it
        (including the empty prefix = "a new word starts here"), maps the
        character that would extend ``p`` within ``r`` to the words it
        leads to — the structure the LM-driven next-kana predictor walks
        (SURVEY.md §4.7; an IME's lookahead must rank MID-WORD
        continuations, not just word starts).  Word lists inherit the
        lexicon's frequency order.  Built lazily, cached.
        """
        idx = getattr(self, "_prefix_next", None)
        if idx is None:
            idx = {}
            for reading, wids in self.by_reading.items():
                for i in range(len(reading)):
                    d = idx.setdefault(reading[:i], {})
                    lst = d.setdefault(reading[i], [])
                    for w in wids:
                        if len(lst) < 4:  # cap: a few words witness a char
                            lst.append(w)
            self._prefix_next = idx
        return idx

    def candidates(self, reading: str) -> List[Tuple[int, str]]:
        """All (word_id, display) whose reading equals ``reading``.

        For an unmatched single kana, returns the ``<unk>`` fallback whose
        display is the kana itself (lattice connectivity guarantee).
        """
        wids = self.by_reading.get(reading)
        if wids:
            return [(w, None) for w in wids]  # display resolved via vocab
        if len(reading) == 1:
            return [(UNK_ID, reading)]
        return []
