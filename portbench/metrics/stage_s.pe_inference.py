"""Mean seconds of the pipeline's PE stage (`timings.json`) over the
window's samples."""


def read(run):
    vals = [r["stages"]["pe_inference"] for r in run.records
            if "pe_inference" in r.get("stages", {})]
    return sum(vals) / len(vals) if vals else None
