"""The least time the card needs for the work of one pass of the sparse
PE engine, counted per step of the algorithm, never per kernel, from
what the inputs need (`reference.pe_links`' `work` and the loop's
`sat_entries`), never from the program's caps, batch, padding or
retries:

  * window hashes, and the probe with its stats: `bounds.pass_steps`'
    own two steps;
  * the sort of the matched (read, node) candidates: each of them, as an
    8-byte key, read once and written once;
  * the saturated lists: each saturated (read, node) entry written once
    as a 4-byte node id.

The host's COO expansion and merge is not the card's work and is left
out (the span `pe.coo` times it)."""

from __future__ import annotations

from typing import Dict

from portbench.bounds import bound, pass_steps as dense_steps

CANDIDATE_BYTES = 8  # a matched (read, node) candidate's sort key
SAT_BYTES = 4        # a saturated node id (int32)


def pass_steps(work: Dict[str, int]) -> Dict[str, dict]:
    dense = dense_steps(work)
    return {
        "window_hashes": dense["window_hashes"],
        "probe_stats": dense["probe_stats"],
        "sort_candidates": bound(2 * CANDIDATE_BYTES
                                 * work["read_node_hits"]),
        "saturated_lists": bound(SAT_BYTES * work["sat_entries"]),
    }
