"""Seconds of ``SpmdAMGSolver``'s sharding at set-up: the
``amg.setup.shard`` span (the packed hierarchy's sharded levels and the
f64 level-0 operator of FCG cut to this process's rows), over the whole
run (``port_trace.totals``).  Rank 0's table (rank 0 is an edge rank of
the ring; every rank shards alike).  None on a program without the
span."""

from benchmark import port_trace


def read(rec):
    t = port_trace.totals()
    if not t or "amg.setup.shard" not in t:
        return None
    return port_trace.seconds(t, "amg.setup.shard")
