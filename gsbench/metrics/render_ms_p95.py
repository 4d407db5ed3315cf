"""The 95th percentile of every frame's latency in the window (call to
device synchronize), in ms."""
import numpy as np


def read(run):
    if run.traffic["loop"] != "serve":
        return None
    return float(np.percentile(np.asarray(run.window["latencies"]) * 1e3, 95))
