"""The 95th percentile of every frame's latency in the window (call to
device synchronize), in ms."""
import numpy as np

from gsbench.metrics._read import loop


def read(run):
    if loop(run) != "serve":
        return None
    return float(np.percentile(np.asarray(run.window["latencies"]) * 1e3, 95))
