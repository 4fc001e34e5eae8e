"""The 95th percentile of every request's latency in the window, from the
hand-off of its scene to its image on the host; a failed request counts as
missing (infinite)."""

import numpy as np


def read(run):
    lat = [(r['t_done'] - r['t_submit']) * 1e3 for r in run.window['records']]
    return float(np.percentile(lat, 95))
