"""Exact per-frame collective traffic of the sharded decode path.

An accounting of the bytes each decode frame moves between cards —
derived from the same shapes
:func:`jlm.parallel.sharded_head.make_sharded_forward` exchanges — so a
measured collective time can be read against the bytes it had to move.

Per frame the jnp sharded forward runs three vocab-axis collectives
(`sharded_head.py` ``_sharded_head``):

  1. ``pmax``  of the running row max            [R_local]        fp32
  2. ``psum``  of the shifted sumexp             [R_local]        fp32
  3. ``psum``  of candidate+eos logits           [S_local, B, C+1] fp32

Data-axis traffic is ZERO during the scan — lattices are independent
streams; the axis that costs wire bytes is vocab (tensor) parallelism.

Ring-allreduce wire cost per device for an N-byte payload over n shards:
``2·N·(n-1)/n`` bytes (reduce-scatter + all-gather).
"""

from __future__ import annotations

from typing import Dict

from jlm.config import Config


def decode_collective_bytes_per_frame(
    config: Config, batch_s: int, n_vocab: int, n_data: int = 1,
    seq_shard: bool = False, htop_bytes: int = 4,
) -> Dict[str, float]:
    """Exact per-frame, per-device collective payloads (bytes).

    ``batch_s`` = global sentence batch S; shapes mirror
    ``make_sharded_forward``.  ``seq_shard=True`` models the
    sequence-sharded layout: rows shard over the vocab axis outside the
    head, so the exchange is one ``all_gather`` of the vocab group's
    h_top (``htop_bytes``/element — 2 in bf16 speed mode), the lse
    ``pmax``+``psum``, and a ``psum_scatter`` of candidates at HALF the
    ring cost of the full ``psum``.
    """
    S_grp = batch_s // max(1, n_data)  # sentences per vocab group
    B = config.beam_pad
    R_grp = S_grp * B
    C1 = config.max_lookahead + 1
    n = max(1, n_vocab)
    ring = 2.0 * (n - 1) / n  # ring all-reduce wire factor
    half_ring = 1.0 * (n - 1) / n  # all-gather / reduce-scatter factor
    payload_max = R_grp * 4
    payload_sum = R_grp * 4
    payload_cand = S_grp * B * C1 * 4
    if seq_shard:
        payload_htop = R_grp * config.hidden_size * htop_bytes
        wire = (
            half_ring * payload_htop  # all_gather h_top at the boundary
            + ring * (payload_max + payload_sum)
            + half_ring * payload_cand  # psum_scatter
        )
    else:
        payload_htop = 0
        wire = ring * (payload_max + payload_sum + payload_cand)
    return {
        "payload_bytes_pmax": payload_max,
        "payload_bytes_psum_lse": payload_sum,
        "payload_bytes_psum_cand": payload_cand,
        "payload_bytes_allgather_htop": payload_htop,
        "payload_bytes_total": payload_max + payload_sum + payload_cand
        + payload_htop,
        "wire_bytes_per_device_per_frame": wire,
    }
