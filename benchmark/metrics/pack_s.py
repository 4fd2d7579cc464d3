"""Seconds of the set-up's device pack: the ``amg.setup.pack`` span
(every level's operators into their device formats and the coarse
inverse) and the ``amg.setup.refine_op`` span (the f64 level-0 operator
of defect correction), over the whole run (``port_trace.totals``; rank
0's in a process group)."""

from benchmark import port_trace


def read(rec):
    return port_trace.seconds(port_trace.totals(), "amg.setup.pack",
                              "amg.setup.refine_op")
