"""eval_batch_ms_p90: the 90th percentile of every val batch of the
window, from the loop asking the loader for the batch to its captions
scored."""

import numpy as np


def read(r):
    lat = [x for u in r.window.units for x in u[2].get("latencies", [])]
    if not lat:
        return None
    return 1e3 * float(np.percentile(lat, 90))
