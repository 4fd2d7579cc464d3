"""Share of the entry calls' host time spent moving vectors between host
and device, in %: the ``amg.upload`` (host b and x0 into the padded,
permuted device vectors) and ``amg.download`` (x back, unpermuted)
spans' seconds over the ``amg.solve`` spans' seconds, in the profiled
stretch of calls (``port_trace.profiled``; rank 0's in a process
group)."""

from benchmark import port_trace


def read(rec):
    t = port_trace.profiled()
    if not t or t["amg.solve"]["s"] <= 0:
        return None
    return 100.0 * port_trace.seconds(t, "amg.upload", "amg.download") \
        / t["amg.solve"]["s"]
