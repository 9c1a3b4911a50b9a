"""The traced sparse passes' least time on the card
(`sparse_bounds.pass_steps`, from what the inputs need) over their
device-busy time, in percent."""

from portbench import sparse_bounds


def read(run):
    if (run.trace is None or "sat_entries" not in (run.work or {})
            or not run.trace.step_busy_s
            or not any("pairs" in r for r in run.records)):
        return None
    busy = sum(run.trace.step_busy_s)
    if busy <= 0:
        return None
    per_pass = sum(s["bound_ms"]
                   for s in sparse_bounds.pass_steps(run.work).values())
    return 100.0 * per_pass * 1e-3 * len(run.trace.step_busy_s) / busy
