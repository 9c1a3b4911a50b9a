"""The 95th percentile (nearest rank) of the window's PE pass times."""

import math


def read(run):
    t = sorted(r["seconds"] for r in run.records if "pairs" in r)
    return t[math.ceil(0.95 * len(t)) - 1] if t else None
