"""The traced passes' least time on the card (`bounds.pass_steps`, from
what the inputs need) over their device-busy time, in percent."""

from portbench import bounds


def read(run):
    if (run.trace is None or not run.work or not run.trace.step_busy_s
            or not any("pairs" in r for r in run.records)):
        return None
    busy = sum(run.trace.step_busy_s)
    if busy <= 0:
        return None
    per_pass = sum(s["bound_ms"] for s in bounds.pass_steps(run.work).values())
    return 100.0 * per_pass * 1e-3 * len(run.trace.step_busy_s) / busy
