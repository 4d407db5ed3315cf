"""litegs_torch's binning table against litegs_tpu's on the same scenes.

The JAX table is padded (128-aligned segments, capacity tail); with its
pads stripped it must equal the port's exact table entry for entry: each
tile's ordered point list, the per-tile counts, the per-point counts and
visibility, all identical (integers, no tolerance), from the non-streaming
route and from the default 'keys' route (its plain version on the CPU).
Every other route (plain expansions on the CPU) must give the port's
non-streaming table in every field, and JAX's streaming table with its pads
stripped.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litegs_tpu.ops import binning as jbin
from litegs_torch.ops import binning as tbin
from util_scenes import random_screen_gaussians


def T(x):
    return torch.tensor(np.asarray(x))


def strip_jax_table(table):
    """(sorted_point, sorted_tile) of the JAX table's real entries."""
    valid = np.asarray(table.entry_valid)
    return (np.asarray(table.sorted_point)[valid],
            np.asarray(table.sorted_tile)[valid])


CASES = [
    # (tile_h, tile_w, img_h, img_w, n, seed, scale_px)
    (8, 16, 40, 64, 60, 0, (1.0, 8.0)),
    (8, 16, 40, 64, 400, 1, (6.0, 16.0)),
    (8, 16, 37, 70, 200, 2, (0.5, 20.0)),
    (16, 32, 48, 96, 150, 3, (1.0, 12.0)),
    (16, 32, 50, 100, 300, 4, (4.0, 30.0)),
]


_JAX_TABLES = {}


def _jax_table(case, ndc, z, inv, op, valid):
    """JAX's table of one case, built once for both routes."""
    if case not in _JAX_TABLES:
        tile_h, tile_w, img_h, img_w = case[:4]
        _JAX_TABLES[case] = jbin.build_tile_table(
            ndc, z, inv, op, jnp.asarray(valid), img_h, img_w, tile_h,
            tile_w, 1 << 15, 1 << 16)
    return _JAX_TABLES[case]


# the non-streaming route under the cases' own ids, the 'keys' route's
# plain version added
@pytest.mark.parametrize(
    "case,stream", [(c, False) for c in CASES] + [(c, "keys") for c in CASES],
    ids=[f"case{i}" for i in range(len(CASES))]
    + [f"keys-case{i}" for i in range(len(CASES))])
def test_tile_table_matches_jax(case, stream):
    tile_h, tile_w, img_h, img_w, n, seed, spx = case
    rng = np.random.default_rng(seed)
    mean, inv, color, op, z, ndc = random_screen_gaussians(
        rng, n, img_h, img_w, scale_px=spx)
    valid = np.ones(n, bool)
    valid[::7] = False
    jt = _jax_table(case, ndc, z, inv, op, valid)
    assert not bool(jt.overflow)
    tt = tbin.build_tile_table(T(ndc), T(z), T(inv), T(op), T(valid),
                               img_h, img_w, tile_h, tile_w, stream=stream)
    sp_j, st_j = strip_jax_table(jt)
    assert tt.num_entries == int(jt.num_entries) == sp_j.shape[0] > 0
    assert tt.num_rows == int(jt.num_rows)
    np.testing.assert_array_equal(tt.sorted_point.numpy(), sp_j)
    np.testing.assert_array_equal(tt.sorted_tile.numpy(), st_j)
    np.testing.assert_array_equal(tt.tile_count.numpy(),
                                  np.asarray(jt.tile_count))
    np.testing.assert_array_equal(tt.point_counts.numpy(),
                                  np.asarray(jt.point_counts))
    np.testing.assert_array_equal(tt.primitive_visible.numpy(),
                                  np.asarray(jt.primitive_visible))
    # exact layout: tile t owns [tile_start[t], tile_start[t] + count)
    cnt = tt.tile_count.numpy()
    np.testing.assert_array_equal(tt.tile_start.numpy(),
                                  np.cumsum(cnt) - cnt)
    assert tt.entry_valid.all() and tt.overflow is False
    np.testing.assert_array_equal(
        tbin.estimate_table_sizes(T(ndc), T(z), T(inv), T(op), T(valid),
                                  img_h, img_w, tile_h, tile_w).numpy(),
        np.asarray(jbin.estimate_table_sizes(ndc, z, inv, op,
                                             jnp.asarray(valid), img_h,
                                             img_w, tile_h, tile_w)))


@pytest.mark.parametrize("stream", [None, False, True, "async", "prefix",
                                    "keys"])
@pytest.mark.parametrize("n", [20, 0])
def test_empty_view_gives_empty_table(n, stream):
    """Points survive culling but none emits a tile row (or there is no
    point at all): every route returns the empty table."""
    rng = np.random.default_rng(5)
    mean, inv, color, op, z, ndc = random_screen_gaussians(rng, 20, 40, 64)
    ndc, z, inv, op = ndc[:, :n], z[:n], inv[:, :n], op[:n]
    tt = tbin.build_tile_table(T(ndc), T(z), T(inv), T(op),
                               torch.zeros(n, dtype=torch.bool),
                               40, 64, 8, 16, stream=stream)
    assert tt.num_entries == 0 and tt.num_rows == 0
    assert tt.sorted_point.shape == tt.sorted_tile.shape == (0,)
    assert tt.sorted_point.dtype == torch.int32
    assert int(tt.tile_count.sum()) == 0 and tt.tile_count.shape == (20,)
    assert tt.point_counts.shape == (n,)
    assert not tt.primitive_visible.any()


# ---- the streaming configuration ----

def scene_args(case):
    tile_h, tile_w, img_h, img_w, n, seed, spx = case
    rng = np.random.default_rng(seed)
    mean, inv, color, op, z, ndc = random_screen_gaussians(
        rng, n, img_h, img_w, scale_px=spx)
    valid = np.ones(n, bool)
    valid[::7] = False
    return (ndc, z, inv, op, valid), (img_h, img_w, tile_h, tile_w)


def assert_tables_identical(a, b):
    for field in a._fields:
        x, y = getattr(a, field), getattr(b, field)
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y), field
        else:
            assert x == y and type(x) is type(y), field


@pytest.mark.parametrize("route", [True, "async", "prefix", "keys"])
@pytest.mark.parametrize("case", CASES)
def test_stream_table_equals_non_stream_table(case, route, monkeypatch):
    arrays, geom = scene_args(case)
    args = [T(x) for x in arrays]
    plain = tbin.build_tile_table(*args, *geom, stream=False)
    assert plain.num_entries > 0
    calls = tbin.PLAIN_CALLS
    assert_tables_identical(
        tbin.build_tile_table(*args, *geom, stream=route), plain)
    # only the 'keys' route on a CPU tensor takes its plain version
    assert tbin.PLAIN_CALLS == calls + (route == "keys")
    # the default is the 'keys' route, on any device, while
    # BINNING_STREAM is on
    assert tbin.stream_route(None) == "keys"
    monkeypatch.setattr(tbin.config, "BINNING_STREAM", False)
    assert tbin.stream_route(None) is None


@pytest.mark.parametrize("case", ["equal_depths", "giants"])
def test_keys_route_on_equal_depths_and_giant_splats(case):
    """The 'keys' route's plain version against stream=False where its key
    is narrowest (every depth equal: no depth bits) and where a few splats
    cover most tiles (points whose rows the kernels share within a warp)."""
    rng = np.random.default_rng(11)
    mean, inv, color, op, z, ndc = random_screen_gaussians(
        rng, 300, 64, 128, scale_px=(0.5, 6.0))
    args = [T(x) for x in (ndc, z, inv, op)]
    if case == "equal_depths":
        args[1] = torch.full_like(args[1], 2.5)
    else:
        _, inv_b, _, op_b, z_b, ndc_b = random_screen_gaussians(
            rng, 3, 64, 128, scale_px=(30.0, 40.0))
        for k, extra in enumerate((ndc_b, z_b, inv_b, op_b)):
            args[k] = torch.cat([args[k], T(extra)], dim=-1)
        args[3][-3:] = 0.95
    args.append(torch.ones(args[1].shape[0], dtype=torch.bool))
    plain = tbin.build_tile_table(*args, 64, 128, 8, 16, stream=False)
    keys = tbin.build_tile_table(*args, 64, 128, 8, 16, stream="keys")
    assert_tables_identical(keys, plain)
    if case == "giants":
        assert int(plain.point_counts.max()) > 32


def test_stream_table_matches_jax_stream_table():
    """One case through JAX's streaming configuration (its Pallas window
    kernels in interpret mode), pads stripped."""
    arrays, geom = scene_args(CASES[2])
    ndc, z, inv, op, valid = arrays
    jt = jbin.build_tile_table(ndc, z, inv, op, jnp.asarray(valid), *geom,
                               1024, 4096, stream=True)
    assert not bool(jt.overflow)
    tt = tbin.build_tile_table(*[T(x) for x in arrays], *geom, stream=True)
    sp_j, st_j = strip_jax_table(jt)
    assert tt.num_entries == int(jt.num_entries) == sp_j.shape[0] > 0
    assert tt.num_rows == int(jt.num_rows)
    np.testing.assert_array_equal(tt.sorted_point.numpy(), sp_j)
    np.testing.assert_array_equal(tt.sorted_tile.numpy(), st_j)
    np.testing.assert_array_equal(tt.tile_count.numpy(),
                                  np.asarray(jt.tile_count))
    np.testing.assert_array_equal(tt.point_counts.numpy(),
                                  np.asarray(jt.point_counts))


@pytest.mark.parametrize("case", CASES)
def test_tightened_rows_fit_the_stream_windows(case, monkeypatch):
    """What the streaming windows count on: the row counts handed to the
    first expansion are positive on a prefix and zero behind it, and every
    row handed to the second owns at least one tile, so no step's owners
    can outrun a window as wide as the step."""
    seen = []
    real = tbin.stream_gather.expand_attrs_windowed

    def spy(attrs, counts, *args, **kwargs):
        out = real(attrs, counts, *args, **kwargs)
        seen.append((counts.numpy().copy(), kwargs, bool(out[3])))
        return out

    monkeypatch.setattr(tbin.stream_gather, "expand_attrs_windowed", spy)
    arrays, geom = scene_args(case)
    tbin.build_tile_table(*[T(x) for x in arrays], *geom, stream=True)
    (rows, kw1, ok1), (tiles, kw2, ok2) = seen
    live = int((rows > 0).sum())
    assert live > 0 and (rows[:live] > 0).all() and (rows[live:] == 0).all()
    assert (tiles >= 1).all()
    assert ok1 and ok2
    step = tbin.STREAM_STEP
    assert kw1["slots_per_step"] == kw2["slots_per_step"] == step
    assert kw1["window_items"] == step + 128
    assert kw2["window_items"] == step + 256


def test_window_overrun_raises():
    with pytest.raises(RuntimeError, match="window"):
        tbin._check_windows(torch.tensor(True), torch.tensor(False))
    tbin._check_windows(torch.tensor(True), torch.tensor(True))
    with pytest.raises(ValueError):
        tbin.stream_route("dma")


@pytest.mark.parametrize("empty_share", [0.3, 0.0])
def test_expand_helpers_match_jax(empty_share):
    rng = np.random.default_rng(9)
    m = 500
    counts = rng.integers(0, 5, m).astype(np.int32)
    counts[rng.random(m) < empty_share] = 0
    table = rng.standard_normal((m, 4)).astype(np.float32)
    total = int(counts.sum())
    # JAX pads to a static capacity; the port's outputs are exactly total
    o_j, r_j, v_j, t_j, f_j = [np.asarray(x) for x in jbin.expand_with_table(
        jnp.asarray(counts), 4096, jnp.asarray(table))]
    o_t, r_t, t_t, f_t = tbin.expand_with_table(T(counts), T(table))
    assert t_t == int(t_j) == total == int(v_j.sum())
    assert len(o_t) == len(r_t) == len(f_t) == total
    assert o_t.dtype == r_t.dtype == torch.int32
    np.testing.assert_array_equal(o_t.numpy(), o_j[:total])
    np.testing.assert_array_equal(r_t.numpy(), r_j[:total])
    np.testing.assert_array_equal(f_t.numpy(), f_j[:total])
    o_b, r_b, t_b = tbin.expand_by_counts(T(counts))
    o_jb, r_jb, v_jb, t_jb = jbin.expand_by_counts(jnp.asarray(counts), 4096)
    assert t_b == int(t_jb) == len(o_b)
    np.testing.assert_array_equal(o_b.numpy(), np.asarray(o_jb)[:total])
    np.testing.assert_array_equal(r_b.numpy(), np.asarray(r_jb)[:total])
