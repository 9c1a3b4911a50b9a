"""Share of the traced window with no kernel, copy or set on the card,
in a window of PE engine passes."""


def read(run):
    if (run.trace is None or run.trace.busy_s <= 0
            or not any("pairs" in r for r in run.records)):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
