"""MiB that cross processes per outer iteration: the bytes of the
``amg.ring.send`` (halo payloads sent), ``amg.ring.all_reduce`` (the
reduced tensors) and ``amg.ring.all_gather`` (this process's share)
rows of the profiled stretch of calls (``port_trace.profiled``) over
those calls' outer iterations.  Rank 0's table: rank 0 is an edge rank
of the ring, with one neighbour, so it sends half the halo bytes of an
inner rank.  None on a program whose table has no ring rows."""

from benchmark import port_trace

RING = ("amg.ring.send", "amg.ring.all_reduce", "amg.ring.all_gather")


def read(rec):
    t = port_trace.profiled()
    nits = (rec.get("profile") or {}).get("nits")
    if not t or not nits or not all(n in t for n in RING):
        return None
    return sum(t[n]["bytes"] for n in RING) / 2**20 / nits
