"""litegs_torch's raster backward against autograd and against litegs_tpu.

The plain backward (``raster_plain.raster_backward_reference``) is held to
autograd of the port's own ``rasterize_reference`` at 1e-5 (max |diff| /
max |autograd|): two orders of float32 arithmetic over the same blend.
The port's ``rasterize`` Function on CPU tensors (the wiring the card runs,
with the kernels' plain versions) is held to ``jax.grad`` of JAX
``rasterize(backend="jnp")`` at the scaled 2e-4 bar of
tests/test_raster_pallas.py, and its RasterStats to JAX ``raster_stats``
(the Pallas backward in interpret mode) at that file's bars: weight_sum
2e-3 absolute, frag_count 0.5, err_sum 2e-4 and grad_norm 2e-3 scaled, and
err_square_sum 1e-3 scaled (a square doubles the relative error of each
pair's opacity gradient, whose (D0 - prefix) / (1 - alpha) term cancels
on deep tiles).  Scenes are util_scenes.random_screen_gaussians at 8x16
and 16x32 tiles, shallow, deep (several hundred entries in a tile) and
sparse (empty tiles).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litegs_tpu.ops import binning as jbin
from litegs_tpu.ops import raster as jraster
from litegs_torch.ops import binning as tbin
from litegs_torch.ops import raster as traster
from litegs_torch.ops import raster_cuda, raster_plain
from util_scenes import random_screen_gaussians

IMG_H, IMG_W = 40, 64
# name: (points, seed, splat size in pixels, tile)
CASES = {
    "shallow-8x16": (60, 12, (1.0, 8.0), (8, 16)),
    "deep-8x16": (400, 11, (6.0, 16.0), (8, 16)),
    "sparse-8x16": (4, 13, (0.5, 2.0), (8, 16)),
    "shallow-16x32": (80, 14, (1.0, 8.0), (16, 32)),
    "deep-16x32": (400, 15, (6.0, 16.0), (16, 32)),
}


def T(x):
    return torch.tensor(np.asarray(x))


def scaled_close(got, want, atol, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, atol=atol,
                               err_msg=name)


class Scene:
    def __init__(self, name):
        n, seed, spx, (self.th, self.tw) = CASES[name]
        rng = np.random.default_rng(seed)
        mean, inv, color, op, z, ndc = random_screen_gaussians(
            rng, n, IMG_H, IMG_W, scale_px=spx)
        self.jargs = (mean, inv, color, op)
        self.targs = [T(a) for a in self.jargs]
        self.binning_inputs = (ndc, z, inv, op, jnp.ones(n, bool))
        self.tt = tbin.build_tile_table(T(ndc), T(z), T(inv), T(op),
                                        torch.ones(n, dtype=torch.bool),
                                        IMG_H, IMG_W, self.th, self.tw)
        self.tiles_x = -(-IMG_W // self.tw)
        self.tiles_total = -(-IMG_H // self.th) * self.tiles_x
        npix = self.th * self.tw
        self.dcol = rng.standard_normal(
            (self.tiles_total, 3, npix)).astype(np.float32)
        self.dtrans = (0.3 * rng.standard_normal(
            (self.tiles_total, npix))).astype(np.float32)
        self.geom = (self.tiles_total, self.tiles_x, self.th, self.tw)

    @functools.cached_property
    def jt(self):
        """The JAX package's table (built only by the tests that use it)."""
        jt = jbin.build_tile_table(*self.binning_inputs, IMG_H, IMG_W,
                                   self.th, self.tw, 16384, 16384)
        assert not bool(jt.overflow)
        return jt

    def jax_loss(self, backend):
        def f(mean, inv, color, op):
            col, trans, _ = jraster.rasterize(
                mean, inv, color, op, self.jt, *self.geom, backend=backend,
                interpret=True)
            return jnp.sum(col * self.dcol) + jnp.sum(trans * self.dtrans)
        return f

    def port_grads(self, with_sink):
        args = [a.clone().requires_grad_(True) for a in self.targs]
        sink = traster.zero_stats_sink(args[0].shape[1], "cpu") \
            if with_sink else None
        col, trans, _ = traster.rasterize(*args, self.tt, *self.geom,
                                          stats_sink=sink, img_h=IMG_H,
                                          img_w=IMG_W)
        ((col * T(self.dcol)).sum() + (trans * T(self.dtrans)).sum()
         ).backward()
        grads = [a.grad for a in args]
        stats = traster.RasterStats(*[s.grad for s in sink]) \
            if with_sink else None
        return grads, stats, col.detach(), trans.detach()


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_autograd(name):
    s = Scene(name)
    tt = s.tt
    args = [a.clone().requires_grad_(True) for a in s.targs]
    out = raster_plain.rasterize_reference(
        *args, tt.sorted_point, tt.sorted_tile, tt.entry_valid,
        tt.tile_start, *s.geom)
    ((out.tiles_color * T(s.dcol)).sum()
     + (out.tiles_trans * T(s.dtrans)).sum()).backward()
    g = raster_plain.raster_backward_reference(
        *s.targs, tt.sorted_point, tt.sorted_tile, tt.entry_valid,
        tt.tile_start, *s.geom, out.tiles_color.detach(),
        out.tiles_trans.detach(), T(s.dcol), T(s.dtrans), with_stats=True)
    for field, a in zip(("d_mean", "d_inv_cov", "d_color", "d_opacity"),
                        args):
        scaled_close(getattr(g, field), a.grad, 1e-5, field)
    np.testing.assert_allclose(g.weight_sum.numpy(),
                               out.frag_weight.numpy(), atol=1e-5)
    np.testing.assert_array_equal(g.frag_count.numpy(),
                                  out.frag_count.numpy())
    # the wrapper's CPU path splits the tiles into groups: same sums
    gp = raster_cuda.raster_backward(
        *s.targs, tt.sorted_point, tt.tile_start, tt.tile_count,
        s.tiles_x, s.th, s.tw, out.tiles_color.detach(),
        out.tiles_trans.detach(), T(s.dcol), T(s.dtrans), with_stats=True)
    grouped = raster_cuda.raster_backward_plain(
        *s.targs, tt.sorted_point, tt.tile_start, tt.tile_count,
        s.tiles_x, s.th, s.tw, out.tiles_color.detach(),
        out.tiles_trans.detach(), T(s.dcol), T(s.dtrans), with_stats=True,
        max_entries=37)
    for field, a, b in zip(raster_plain.PointGrads._fields, gp, grouped):
        scaled_close(b, a, 1e-6, field)
    if name.startswith("sparse"):
        assert bool((tt.tile_count == 0).any())
    if name.startswith("deep"):
        assert int(tt.tile_count.max()) > 256


@pytest.mark.parametrize("name", list(CASES))
def test_torch_backend_groups_match_whole_table(name):
    """The 'torch' backend on the table split into checkpointed groups of
    whole tiles (``rasterize_plain(max_entries=37)``, the path of tables
    over ``PLAIN_GROUP_PAIRS`` pairs) gives the whole table's tiles and,
    through the checkpoints, its gradients."""
    s = Scene(name)
    runs = []
    for max_entries in (None, 37):
        args = [a.clone().requires_grad_(True) for a in s.targs]
        col, trans = traster.rasterize_plain(*args, s.tt, *s.geom,
                                             max_entries=max_entries)
        ((col * T(s.dcol)).sum() + (trans * T(s.dtrans)).sum()).backward()
        runs.append((col.detach(), trans.detach(), [a.grad for a in args]))
    (col, trans, grads), (gcol, gtrans, ggrads) = runs
    np.testing.assert_allclose(gcol.numpy(), col.numpy(), atol=1e-6)
    np.testing.assert_allclose(gtrans.numpy(), trans.numpy(), atol=1e-6)
    for field, a, b in zip(("d_mean", "d_inv_cov", "d_color", "d_opacity"),
                           grads, ggrads):
        scaled_close(b, a, 1e-6, field)
    assert name.startswith("sparse") or s.tt.sorted_point.shape[0] > 37


@pytest.mark.parametrize("name", list(CASES))
def test_rasterize_function_matches_jax_grad(name):
    s = Scene(name)
    g_j = jax.grad(s.jax_loss("jnp"), argnums=(0, 1, 2, 3))(*s.jargs)
    for with_sink in (False, True):
        g_t, _, _, _ = s.port_grads(with_sink)
        for field, a, b in zip(("mean", "invcov", "color", "opacity"),
                               g_j, g_t):
            scaled_close(b.numpy(), a, 2e-4, f"{field} sink={with_sink}")


@pytest.mark.parametrize("name", ["shallow-8x16", "deep-8x16",
                                  "sparse-8x16"])
def test_stats_match_jax_raster_stats(name):
    s = Scene(name)
    _, got, col, trans = s.port_grads(with_sink=True)
    col_j, trans_j, _ = jraster.rasterize(*s.jargs, s.jt, *s.geom,
                                          backend="pallas", interpret=True)
    want = jraster.raster_stats(
        *s.jargs, s.jt, col_j, trans_j, jnp.asarray(s.dcol),
        jnp.asarray(s.dtrans), *s.geom, IMG_H, IMG_W, backend="pallas",
        interpret=True)
    np.testing.assert_allclose(got.weight_sum.numpy(), want.weight_sum,
                               atol=2e-3)
    np.testing.assert_allclose(got.frag_count.numpy(), want.frag_count,
                               atol=0.5)
    scaled_close(got.err_sum.numpy(), want.err_sum, 2e-4, "err_sum")
    scaled_close(got.err_square_sum.numpy(), want.err_square_sum, 1e-3,
                 "err_square_sum")
    scaled_close(got.grad_norm.numpy(), want.grad_norm, 2e-3, "grad_norm")
    assert float(got.frag_count.sum()) > 0


@pytest.mark.parametrize("name", ["deep-8x16", "shallow-16x32"])
def test_sink_equals_raster_stats_and_leaves_gradients(name):
    s = Scene(name)
    g_plain, _, _, _ = s.port_grads(with_sink=False)
    g_sink, got, col, trans = s.port_grads(with_sink=True)
    want = traster.raster_stats(*s.targs, s.tt, col, trans, T(s.dcol),
                                T(s.dtrans), *s.geom, IMG_H, IMG_W)
    for field in traster.RasterStats._fields:
        scaled_close(getattr(got, field).numpy(),
                     getattr(want, field).numpy(), 1e-5, field)
    # the 'torch' backend's explicit pass takes the same plain version
    want_t = traster.raster_stats(*s.targs, s.tt, col, trans, T(s.dcol),
                                  T(s.dtrans), *s.geom, IMG_H, IMG_W,
                                  backend="torch")
    for a, b in zip(want, want_t):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(g_plain, g_sink):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_empty_table_backward_is_zero():
    s = Scene("sparse-8x16")
    none = s.tt._replace(sorted_point=s.tt.sorted_point[:0],
                         sorted_tile=s.tt.sorted_tile[:0],
                         entry_valid=s.tt.entry_valid[:0],
                         tile_count=torch.zeros_like(s.tt.tile_count),
                         tile_start=torch.zeros_like(s.tt.tile_start))
    args = [a.clone().requires_grad_(True) for a in s.targs]
    col, trans, _ = traster.rasterize(*args, none, *s.geom)
    assert bool((col == 0).all() and (trans == 1).all())
    ((col * T(s.dcol)).sum() + (trans * T(s.dtrans)).sum()).backward()
    assert all(bool((a.grad == 0).all()) for a in args)
    with pytest.raises(ValueError, match="'cuda' backend"):
        traster.rasterize(*s.targs, s.tt, *s.geom, backend="torch",
                          stats_sink=traster.zero_stats_sink(4, "cpu"))
