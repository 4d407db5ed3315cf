"""The benchmark's plain reference of 3D Gaussian Splatting.

Plain PyTorch, float32 unless a caller asks for another type, written
from the published equations (LiteGS / 3DGS: chunk frustum culling, EWA
projection with the 0.3 low-pass, exact ellipse-tile binning, front-to-
back alpha blending with the 1/256 and 1/8192 thresholds, L1 + SSIM,
Adam without bias correction over the visible chunks).  It imports
nothing of the program under test: it works out again, from the raw
parameters, cameras and targets the benchmark made, every quantity the
program derives (visibility, projection, tile table, blend, gradients).
"""
