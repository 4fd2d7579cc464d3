"""Level 0's product ``y = A x`` on the solver's own packed operator, as
a share of the least time the card could take for it: the operator's
bytes (``peaks.spmv_bytes``: values, x and y once, no index bytes) over
the card's memory bandwidth, against the median of 21 launches timed with
CUDA events, L2 flushed.  One right-hand side; on a rank of a group,
its row shard against its share of the bytes."""

from benchmark.peaks import bandwidth_bound_ms


def read(rec):
    op = rec.get("l0_op")
    if not op or rec["columns"] != 1 or op["ms"] <= 0:
        return None
    return 100.0 * bandwidth_bound_ms(op["bytes"]) / op["ms"]
