"""The raster kernels' per-warp cull against the plain rasterizer's alpha.

Both raster kernels skip an entry for a warp whose pixel block the
entry's alpha >= 1/256 region cannot reach (``csrc/raster_common.cuh``).
That may never drop a pair that contributes.  ``raster_cuda.
warp_block_visible`` is the plain PyTorch version of the test; on seeded
ellipses -- random ones, ones whose largest alpha over the block sits at
1/256 within a few ulps, ones whose cull box ends at the block's edge, and
degenerate ones -- every (entry, block) it culls must have alpha_raw <
1/256 (or NaN) at every pixel of the block, with alpha_raw formed as
``raster_plain.rasterize_reference`` forms it.  CPU only; no JAX.
"""
import numpy as np
import torch

from litegs_torch.ops import raster_cuda, raster_plain

# one warp block of pixel centres x0..x1, y0..y1
X0, Y0, X1, Y1 = 24, 16, 31, 23


def ellipses(rng, n, scale=(0.3, 20.0), stretch=50.0):
    """Inverse covariances [3, n] (float64) of random rotated ellipses."""
    s1 = rng.uniform(*scale, n)
    s2 = s1 / rng.uniform(1.0, stretch, n)
    theta = rng.uniform(0, np.pi, n)
    ct, st = np.cos(theta), np.sin(theta)
    a = ct * ct * s1 * s1 + st * st * s2 * s2
    b = ct * st * (s1 * s1 - s2 * s2)
    c = st * st * s1 * s1 + ct * ct * s2 * s2
    det = a * c - b * b
    return np.stack([c / det, -b / det, a / det])


def block_alpha(mean, inv, op):
    """alpha_raw [N, 64] at the block's pixels, as rasterize_reference
    forms it."""
    ys, xs = torch.meshgrid(torch.arange(Y0, Y1 + 1.0),
                            torch.arange(X0, X1 + 1.0), indexing="ij")
    n = op.shape[0]
    pix_x = xs.flatten()[None].expand(n, -1)
    pix_y = ys.flatten()[None].expand(n, -1)
    return raster_plain.pair_alpha(mean, inv, op, torch.arange(n), pix_x,
                                   pix_y)[-1]


def check(mean, inv, op):
    """Asserts the cull is conservative; returns (kept, reached)."""
    f32 = [torch.tensor(np.asarray(x), dtype=torch.float32)
           for x in (mean, inv, op)]
    kept = raster_cuda.warp_block_visible(*f32, X0, Y0, X1, Y1)
    reached = (block_alpha(*f32) >= raster_plain.ALPHA_MIN).any(dim=1)
    bad = reached & ~kept
    assert not bool(bad.any()), np.flatnonzero(bad.numpy())[:10]
    return kept.numpy(), reached.numpy()


def q_min_over_block(mean, inv):
    """min over the block's pixels of the quadratic form (float64)."""
    xs, ys = np.meshgrid(np.arange(X0, X1 + 1.0), np.arange(Y0, Y1 + 1.0))
    dx = mean[0][:, None] - xs.ravel()[None]
    dy = mean[1][:, None] - ys.ravel()[None]
    a, b, c = (v[:, None] for v in inv)
    return (a * dx * dx + 2 * b * dx * dy + c * dy * dy).min(axis=1)


def test_random_ellipses_around_a_block():
    rng = np.random.default_rng(0)
    n = 20000
    inv = ellipses(rng, n)
    mean = np.stack([rng.uniform(X0 - 50, X1 + 50, n),
                     rng.uniform(Y0 - 50, Y1 + 50, n)])
    op = rng.uniform(0.5 / 256, 1.0, n)
    kept, reached = check(mean, inv, op)
    # the test culls much of what misses the block: not vacuous
    assert reached.mean() > 0.05
    assert (~kept).sum() > 0.4 * (~reached).sum()


def test_alpha_at_the_cut():
    """The largest alpha over the block within a few ulps of 1/256."""
    rng = np.random.default_rng(1)
    n = 20000
    inv = ellipses(rng, n)
    mean = np.stack([rng.uniform(X0 - 25, X1 + 25, n),
                     rng.uniform(Y0 - 25, Y1 + 25, n)])
    q = np.minimum(q_min_over_block(mean, inv), 20.0)
    op = np.exp(q / 2) / 256 * (1 + rng.integers(-6, 7, n) * 2.0 ** -23)
    ok = op <= 1.0
    kept, reached = check(mean[:, ok], inv[:, ok], op[ok])
    assert ok.sum() > 3000 and 0.05 < reached.mean() < 0.95
    assert kept.all()


def test_box_edge_at_the_block_edge():
    """Centres placed so that the cull box ends within 0.2 pixel of the
    block's edge, on each of the four sides."""
    rng = np.random.default_rng(2)
    n = 20000
    inv = ellipses(rng, n)
    op = rng.uniform(1.0 / 256, 1.0, n)
    a, b, c = inv
    t = 2 * np.log(256 * op)
    det = a * c - b * b
    rx, ry = np.sqrt(t * c / det), np.sqrt(t * a / det)
    side = rng.integers(0, 4, n)
    d = rng.uniform(-0.2, 0.2, n)
    mx = rng.uniform(X0 - 4, X1 + 4, n)
    my = rng.uniform(Y0 - 4, Y1 + 4, n)
    mx = np.where(side == 0, X0 - rx + d, np.where(side == 1, X1 + rx + d,
                                                   mx))
    my = np.where(side == 2, Y0 - ry + d, np.where(side == 3, Y1 + ry + d,
                                                   my))
    kept, reached = check(np.stack([mx, my]), inv, op)
    assert 0.05 < kept.mean() < 0.95 and reached.any()


def test_degenerate_entries():
    """Kept where the form is not positive definite or a number is not
    finite; culled where opacity < 1/256 on a positive-definite form."""
    nan, inf = float("nan"), float("inf")
    inv = np.array([[1.0, 0.0, 1.0],      # positive definite
                    [1.0, 1.0, 1.0],      # singular
                    [1.0, 2.0, 1.0],      # indefinite
                    [-1.0, 0.0, -1.0],    # negative definite
                    [nan, 0.0, 1.0],
                    [1.0, 0.0, inf],
                    [1.0, 0.0, 1.0],
                    [1.0, 0.0, 1.0],
                    [1e-30, 0.0, 1e-30]]).T
    op = np.array([0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5 / 256, nan, 0.9])
    mean = np.array([[X0 - 30.0] * 9, [Y0 - 30.0] * 9])
    kept, _ = check(mean, inv, op)
    assert kept.tolist() == [False, True, True, True, True, True, False,
                             True, True]
