"""Device time of one traced ``epoch_boundary`` of a statistics epoch
(densify, then the Morton resort): the union of its kernels, copies and
sets under the profiler, in ms."""


def read(run):
    t = getattr(run, "boundary_trace", None)
    if not t or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"]
