"""95th percentile of the wall time of every call of the window, in ms
(one call: one ``solve``, or one ``solve_batched`` of all its columns),
from handing the host right-hand side in to having the host solution."""

import numpy as np


def read(rec):
    return float(np.percentile([c["ms"] for c in rec["calls"]], 95))
