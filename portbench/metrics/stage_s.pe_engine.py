"""Mean seconds of `infer_pe_links` inside the samples (the pipeline's
"PE engine: ... in ... s" line)."""


def read(run):
    vals = [r["engine_s"] for r in run.records
            if r.get("engine_s") is not None]
    return sum(vals) / len(vals) if vals else None
