"""Messages and collectives that cross processes per outer iteration:
the ``amg.ring.send`` (point-to-point halo messages sent),
``amg.ring.all_reduce`` and ``amg.ring.all_gather`` counts of the
profiled stretch of calls (``port_trace.profiled``: the replays of the
step graphs add what their captures counted) over those calls' outer
iterations.  Rank 0's table: rank 0 is an edge rank of the ring, with
one neighbour, so it sends half the halo messages of an inner rank.
None on a program whose table has no ring rows."""

from benchmark import port_trace

RING = ("amg.ring.send", "amg.ring.all_reduce", "amg.ring.all_gather")


def read(rec):
    t = port_trace.profiled()
    nits = (rec.get("profile") or {}).get("nits")
    if not t or not nits or not all(n in t for n in RING):
        return None
    return sum(t[n]["n"] for n in RING) / nits
