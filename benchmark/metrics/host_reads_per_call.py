"""Blocking device-to-host reads per entry call (a norm, a batch of
residuals, a loop flag, the truth check): ``amg.read`` spans over
``amg.solve`` spans, in the profiled stretch of calls
(``port_trace.profiled``; rank 0's in a process group)."""

from benchmark import port_trace


def read(rec):
    v = port_trace.per_call(port_trace.profiled(), "amg.read", field="n")
    return None if v is None else float(v)
