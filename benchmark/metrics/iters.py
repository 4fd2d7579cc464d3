"""Mean outer iterations the entry reports per call (``SolveInfo.nits``:
cycles of defect correction, FCG iterations, or batched cycles)."""


def read(rec):
    calls = rec["calls"]
    return sum(c["nits"] for c in calls) / len(calls) if calls else None
