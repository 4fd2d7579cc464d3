"""Seconds spent making the cycle's graphs: the ``amg.capture`` spans
(each step graph's warm-ups, capture and instantiation; each device
loop's build), over the whole run, warm-up included
(``port_trace.totals``; rank 0's in a process group)."""

from benchmark import port_trace


def read(rec):
    return port_trace.seconds(port_trace.totals(), "amg.capture")
