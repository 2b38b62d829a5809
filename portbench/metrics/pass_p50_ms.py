"""pass_p50_ms: the median of the latencies of all the window's passes,
from the call to the means on the host (linear between the two nearest
ranks)."""

import numpy as np


def read(rec: dict) -> float:
    return float(np.percentile(np.asarray(rec["pass_s"]) * 1e3, 50))
