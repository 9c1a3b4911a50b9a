"""Mean seconds of every pipeline stage but the PE stage
(`timings.json`): the host graph stages."""


def read(run):
    vals = [sum(s for k, s in r["stages"].items() if k != "pe_inference")
            for r in run.records if r.get("stages")]
    return sum(vals) / len(vals) if vals else None
