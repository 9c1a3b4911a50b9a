"""Share of the traced window with no kernel, copy or set on the card,
in a window of whole samples."""


def read(run):
    if (run.trace is None or run.trace.busy_s <= 0
            or not any("samples" in r for r in run.records)):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
