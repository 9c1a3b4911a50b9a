"""Wall seconds a sample costs: the window over the samples completed in
it (the sample running when the window's time is up is finished and
counted)."""


def read(run):
    n = sum(r.get("samples", 0) for r in run.records)
    return run.window_s / n if n else None
