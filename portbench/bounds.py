"""The least time the card needs for the work of one PE pass, counted
per step of the algorithm (ROADMAP's steps 1-6), never per kernel.

`HBM_BYTES_S`, `INT8_OPS_S`, `ENTRY_BYTES` and `bound` are copied from
`chip_smoke.py` at commit bc5e135ef114cb1be5519b7422aa36d058e4b564 (the
file last changed in 50981ea): published H100 SXM peaks at 700 W, each
input byte read once and each output byte written once. `hash_bound`'s
9 bytes a window (q1 and h2 as int32, valid as one byte) are that
file's too. `pass_steps` is new: the four steps of a dense pass, from
the counts of what the inputs need (`reference.pe_links`' `work`).
"""

from __future__ import annotations

from typing import Dict

# H100 SXM published peaks at 700 W (NVIDIA data sheet): HBM3 bytes/s
# and dense int8 tensor-core operations/s
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
ENTRY_BYTES = 12     # a table entry's h1, h2 and node
HASH_BYTES = 9       # a window's q1, h2 (int32) and valid (uint8)
STAT_BYTES = 8       # a (read, node) pair's count and lowest window (int32)
COUNT_BYTES = 8      # an int64 link counter


def bound(nbytes: float, int8_ops: float = 0.0) -> dict:
    """The least time the card could take: each input byte read once and
    each output byte written once at the memory rate, or the int8
    operations at the tensor cores' rate, whichever is longer."""
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = int8_ops / INT8_OPS_S * 1e3
    if by_ops > by_bytes:
        return {"bound_ms": by_ops, "bound_by": "operations",
                "bound_rate": "1,979 TOP/s int8 tensor cores"}
    return {"bound_ms": by_bytes, "bound_by": "bytes",
            "bound_rate": "3.35 TB/s HBM3"}


def pass_steps(work: Dict[str, int]) -> Dict[str, dict]:
    """Each step's bound for one pass over the reads:

      * window hashes: the reads packed two bits a base (and a 4-byte
        length each) read once, each window's hashes written once;
      * probe and stats: the table entries that some window matches read
        once, each (read, node) pair with a match written once;
      * pair counts: fᵀr and triu(fᵀf + rᵀr) over every pair, 2·(2P)·N²
        int8 operations;
      * the two N² link matrices written once."""
    N = work["nodes"]
    packed = work["read_bases"] // 4 + 4 * work["reads"]
    return {
        "window_hashes": bound(packed + HASH_BYTES * work["windows"]),
        "probe_stats": bound(ENTRY_BYTES * work["entries"]
                             + STAT_BYTES * work["read_node_hits"]),
        "pair_counts": bound(0, 4.0 * work["pairs"] * N * N),
        "matrices": bound(2 * COUNT_BYTES * N * N),
    }
