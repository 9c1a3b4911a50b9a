"""The comparisons that decide `correct`: what the timed path produced
against the reference, each as a number beside its limit."""

from __future__ import annotations

import hashlib
import os
import warnings
from typing import Dict, List, Sequence

import numpy as np
import torch

# sample outputs after the PE stage, compared byte for byte
SAMPLE_FILES = ("gfa/split_graph_final.gfa", "strain.fasta", "strain.paths")


_FIELDS = bytes.maketrans(b":\n", b"  ")


def read_links(path: str, ids: Sequence[str]) -> Dict[str, object]:
    """An `aln/pe_info` or `aln/st_info` file (`u:v:count` lines, full or
    nonzero-only) as an int64 [N, N] matrix over `ids`, with the count of
    lines that name an unknown id or repeat a pair (every line, when the
    file does not parse as three numbers a line)."""
    N = len(ids)
    mat = np.zeros((N, N), dtype=np.int64)
    if not os.path.exists(path):
        return {"mat": mat, "bad_lines": N * N}
    with open(path, "rb") as fh:
        text = fh.read()
    lines = text.count(b"\n") + (0 if text.endswith(b"\n") else 1)
    if not text:
        return {"mat": mat, "bad_lines": 0}
    if text.count(b":") != 2 * lines:
        return {"mat": mat, "bad_lines": lines}
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            nums = np.fromstring(text.translate(_FIELDS), dtype=np.int64,
                                 sep=" ")
    except (DeprecationWarning, ValueError):
        return {"mat": mat, "bad_lines": lines}
    if nums.size != 3 * lines:
        return {"mat": mat, "bad_lines": lines}
    u, v, c = nums[0::3], nums[1::3], nums[2::3]
    ints = np.array([int(x) for x in ids], dtype=np.int64)
    if np.unique(ints).size != N or ints.min(initial=0) < 0:
        raise ValueError("node ids are not distinct whole numbers")
    slot = np.full(int(ints.max(initial=0)) + 2, -1, dtype=np.int64)
    slot[ints] = np.arange(N)
    top = slot.size - 1  # ids outside [0, top) are unknown

    def index(x):
        return np.where((x >= 0) & (x < top), slot[np.clip(x, 0, top)], -1)

    su, sv = index(u), index(v)
    ok = (su >= 0) & (sv >= 0)
    key = su[ok] * N + sv[ok]
    seen = np.bincount(key, minlength=N * N)
    repeats = int((seen[seen > 1] - 1).sum())
    mat.reshape(-1)[key] = c[ok]
    return {"mat": mat, "bad_lines": int((~ok).sum()) + repeats}


def verdict(readings: Dict[str, int], limits: Dict[str, int]):
    """Each reading beside its limit, and whether all are within them; a
    limit with no reading fails."""
    checks = {k: {"value": readings.get(k), "limit": v}
              for k, v in limits.items()}
    within = all(c["value"] is not None and c["value"] <= c["limit"]
                 for c in checks.values())
    return checks, within


def links_differ(node_mat, short_mat, ref_node, ref_short) -> int:
    """Entries of the two link matrices that differ from the reference's."""
    def count(a, b):
        a = torch.as_tensor(a)
        b = torch.as_tensor(b, device=a.device)
        return int((a != b).sum())
    return count(node_mat, ref_node) + count(short_mat, ref_short)


def digest(out: str) -> tuple:
    """sha256 of the files a sample check reads, so that byte-equal
    outputs are checked once."""
    out_d = []
    for name in ("aln/pe_info", "aln/st_info") + SAMPLE_FILES:
        path = os.path.join(out, name)
        h = hashlib.sha256()
        if os.path.exists(path):
            with open(path, "rb") as fh:
                for block in iter(lambda: fh.read(1 << 24), b""):
                    h.update(block)
        out_d.append(h.hexdigest() if os.path.exists(path) else None)
    return tuple(out_d)


def sample_checks(out: str, ref_out: str, ids: List[str], links) -> dict:
    """Numbers of one timed sample's output directory `out` against the
    reference's run in `ref_out`."""
    pe = read_links(os.path.join(out, "aln", "pe_info"), ids)
    st = read_links(os.path.join(out, "aln", "st_info"), ids)
    differ = links_differ(pe["mat"], st["mat"], links.node_mat.cpu(),
                          links.short_mat.cpu())
    files = 0
    for name in SAMPLE_FILES:
        a = os.path.join(out, name)
        b = os.path.join(ref_out, name)
        if not (os.path.exists(a) and _same_bytes(a, b)):
            files += 1
    return {"pe_links_differ": differ + pe["bad_lines"] + st["bad_lines"],
            "files_differ": files}


def _same_bytes(a: str, b: str) -> bool:
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()
