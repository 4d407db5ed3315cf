from . import (binning, losses, lpips, projection, raster,  # noqa: F401
               raster_cuda, raster_plain)
