"""raster_bwd_kernel's share of its roofline: the bound of the work the
traced views need (gsbench.work.raster_bwd) over the kernel's device
time."""
from gsbench import work
from gsbench.metrics._read import roofline_pct


def read(run):
    return roofline_pct(run, "train", "raster_bwd_kernel", work.raster_bwd)
