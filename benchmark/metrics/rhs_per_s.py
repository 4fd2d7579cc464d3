"""Right-hand sides solved to the cell's tolerance per second of the
window: a call whose reported residual misses the tolerance solves none
of its columns; a batched call solves all of its columns or none."""


def read(rec):
    return rec["rhs_solved"] / rec["window_s"]
