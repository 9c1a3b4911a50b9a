"""Stage-boundary checkpoints with explicit resume.

The reference is only *implicitly* checkpointed: every stage round-trips
the graph through GFA files (SURVEY.md section 5), and a crashed run must
be restarted by hand. Here each stage boundary persists the full pipeline
state — graph checkpoint name, contig dict, PE-link dict, id mappings —
into `<out>/ckpt/<stage>.json` next to the GFA files, and the pipeline can
resume from the last completed stage (`--resume`).

Graphs themselves are stored as the stage GFA files (already written by
store_reinit_graph); this module (de)serializes the Python-side state.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

STAGES = ["contigs", "pe_links", "cleaned", "disentangled", "extended"]


def _ckpt_dir(out_dir: str) -> str:
    d = os.path.join(out_dir, "ckpt")
    os.makedirs(d, exist_ok=True)
    return d


def _encode_pe_info(pe_info: Dict[Tuple[str, str], int]) -> List:
    return [[u, v, c] for (u, v), c in pe_info.items()]


def _decode_pe_info(items: List) -> Dict[Tuple[str, str], int]:
    return {(u, v): c for u, v, c in items}


def save_stage(out_dir: str, stage: str, state: Dict) -> None:
    """Persist one stage's state. Tuple-keyed dicts are list-encoded."""
    assert stage in STAGES, stage
    enc = dict(state)
    for key in ("pe_info", "dcpy_pe_info"):
        if key in enc and enc[key] is not None:
            enc[key] = _encode_pe_info(enc[key])
    if "contig_info" in enc and enc["contig_info"] is not None:
        enc["contig_info"] = {
            cno: [None, repeat] for cno, (_x, repeat)
            in enc["contig_info"].items()}
    path = os.path.join(_ckpt_dir(out_dir), f"{stage}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(enc, f)
    os.replace(tmp, path)


def load_stage(out_dir: str, stage: str) -> Optional[Dict]:
    path = os.path.join(_ckpt_dir(out_dir), f"{stage}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        state = json.load(f)
    for key in ("pe_info", "dcpy_pe_info"):
        if key in state and state[key] is not None:
            state[key] = _decode_pe_info(state[key])
    if "contig_info" in state and state["contig_info"] is not None:
        state["contig_info"] = {
            cno: (None, repeat) for cno, (_x, repeat)
            in state["contig_info"].items()}
    return state


def latest_stage(out_dir: str) -> Optional[str]:
    """Most advanced stage with a saved checkpoint."""
    found = None
    for stage in STAGES:
        if os.path.exists(os.path.join(out_dir, "ckpt", f"{stage}.json")):
            found = stage
    return found
