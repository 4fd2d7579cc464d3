"""MiB moved between host and device per entry call: the bytes of the
``amg.upload`` spans (b, x0 and level 0's permutation up) and of the
``amg.download`` spans (x down) over the ``amg.solve`` spans, in the
profiled stretch of calls (``port_trace.profiled``; rank 0's in a
process group)."""

from benchmark import port_trace


def read(rec):
    v = port_trace.per_call(port_trace.profiled(), "amg.upload",
                            "amg.download", field="bytes")
    return None if v is None else v / 2**20
