"""Read pairs handed to the PE engine in the window, over the window."""


def read(run):
    pairs = sum(r.get("pairs", 0) for r in run.records)
    return pairs / run.window_s if pairs else None
