"""Lattice construction + beam-Viterbi decoding (ref: JLM:decoder/decoder.py).

Host side builds the lattice (cheap bookkeeping, SURVEY.md §4.5); the whole
beam-pruned Viterbi search (§4.6) runs device-resident as one ``lax.scan``
— zero per-frame host↔device round trips, which is this build's answer to
the reference's "numpy instead of TF Session" latency move (§9.3.1).
"""

from jlm.decoder.lattice import Lattice, Node, build_lattice  # noqa: F401
