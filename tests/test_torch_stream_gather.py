"""litegs_torch's streaming expansions and block gather against
litegs_tpu's on the same numpy inputs.

The JAX functions run their Pallas kernels in interpret mode; the port's
run their plain PyTorch versions (the tensors lie on the CPU).  The cases
are those of tests/test_stream_gather.py.  Everything compared is a copy of
an input word or an integer rank, so the tolerance is 0: ``total``, ``ok``,
``rank[:total]`` and ``out[:, :total]`` must be equal exactly (slots past
the total are arbitrary in both packages).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litegs_tpu.ops import stream_gather as jsg
from litegs_torch.ops import stream_gather as tsg


def T(x):
    return torch.tensor(np.asarray(x))


def prefix_case():
    rng = np.random.default_rng(0)
    s, a, e = 300, 16, 1024
    counts = rng.integers(1, 5, s).astype(np.int32)
    counts[200:] = 0  # live items form a prefix
    return rng.random((a, s)).astype(np.float32), counts, e


def spanning_case():
    # single item covering many blocks + many 1-slot items
    counts = np.r_[np.full(1, 200), np.ones(150)].astype(np.int32)
    attrs = np.arange(151, dtype=np.float32)[None].repeat(8, 0)
    return attrs, counts, 512


def windowed_random_case():
    rng = np.random.default_rng(3)
    s = 700
    counts = rng.integers(0, 4, s).astype(np.int32)
    counts[rng.random(s) < 0.4] = 0     # zero counts interspersed
    attrs = rng.standard_normal((8, s)).astype(np.float32)
    cap = ((int(counts.sum()) + 255) // 256) * 256 + 256
    return attrs, counts, cap, 256, 128, True


def windowed_overflow_case():
    # slots 1..300 are owned by item 600: a window of 256 misses it
    s = 1024
    counts = np.zeros(s, np.int32)
    counts[0] = 1
    counts[600] = 300
    attrs = np.arange(8 * s, dtype=np.float32).reshape(8, s)
    return attrs, counts, 512, 256, 128, False


def windowed_multi_slot_case():
    rng = np.random.default_rng(5)
    s = 2000
    counts = rng.integers(1, 5, s).astype(np.int32)
    attrs = rng.standard_normal((16, s)).astype(np.float32)
    cap = ((int(counts.sum()) + 511) // 512) * 512 + 512
    return attrs, counts, cap, 640, 512, True


def assert_expansion_equal(got, want, counts):
    """(out, rank, total) of the port against JAX's, on the live slots."""
    total = int(counts.sum())
    assert int(got[2]) == int(want[2]) == total
    live = min(total, got[0].shape[1])
    np.testing.assert_array_equal(got[1].numpy()[:live],
                                  np.asarray(want[1])[:live])
    np.testing.assert_array_equal(got[0].numpy()[:, :live],
                                  np.asarray(want[0])[:, :live])


@pytest.mark.parametrize("case", [prefix_case, spanning_case])
def test_expand_attrs_matches_jax(case):
    attrs, counts, out_len = case()
    want = jsg.expand_attrs(jnp.asarray(attrs), jnp.asarray(counts),
                            out_len, interpret=True)
    before = tsg.PLAIN_CALLS
    got = tsg.expand_attrs(T(attrs), T(counts), out_len)
    assert tsg.PLAIN_CALLS == before + 1      # CPU tensors: plain version
    assert got[0].shape == (attrs.shape[0], out_len)
    assert got[1].dtype == torch.int32
    assert_expansion_equal(got, want, counts)
    # and the values themselves, against numpy
    owner = np.repeat(np.arange(len(counts)), counts)
    np.testing.assert_array_equal(got[0].numpy()[:, :len(owner)],
                                  attrs[:, owner])


@pytest.mark.parametrize("dma", [False, True])
@pytest.mark.parametrize("case", [windowed_random_case,
                                  windowed_overflow_case,
                                  windowed_multi_slot_case])
def test_expand_attrs_windowed_matches_jax(case, dma):
    attrs, counts, out_len, window, step, ok_expected = case()
    want = jsg.expand_attrs_windowed(
        jnp.asarray(attrs), jnp.asarray(counts), out_len,
        window_items=window, slots_per_step=step, interpret=True, dma=dma)
    got = tsg.expand_attrs_windowed(T(attrs), T(counts), out_len,
                                    window_items=window,
                                    slots_per_step=step, dma=dma)
    assert bool(got[3]) == bool(want[3]) == ok_expected
    assert int(got[2]) == int(want[2]) == int(counts.sum())
    if ok_expected:
        assert_expansion_equal(got[:3], want[:3], counts)


def test_gather_blocks_matches_jax():
    rng = np.random.default_rng(1)
    s = 700
    attrs = rng.random((8, s)).astype(np.float32)
    src_lo = np.sort(rng.integers(0, s - 1, 4)).astype(np.int32)
    # one run that crosses the end of the rows, one offset past it and one
    # negative offset (both clip)
    src_lo = np.r_[src_lo, s - 40, s + 500, -3].astype(np.int32)
    want = np.asarray(jsg.gather_blocks(jnp.asarray(attrs),
                                        jnp.asarray(src_lo), interpret=True))
    got = tsg.gather_blocks(T(attrs), T(src_lo))
    assert got.shape == (8, len(src_lo) * 128)
    np.testing.assert_array_equal(got.numpy(), want)
    padded = np.pad(attrs, ((0, 0), (0, 128)))
    for b, lo in enumerate(np.clip(src_lo, 0, s - 1)):
        np.testing.assert_array_equal(got.numpy()[:, b * 128:(b + 1) * 128],
                                      padded[:, lo:lo + 128])


def test_gather_blocks_int64_offsets():
    """int64 offsets, as a caller's index arithmetic leaves them: those
    JAX can take (it narrows to int32) against JAX, those past 2^31 and
    far below 0 against the clip contract (the first or the last item)."""
    rng = np.random.default_rng(2)
    s = 1001
    attrs = rng.integers(-2 ** 31, 2 ** 31 - 1, (3, s)).astype(np.int32)
    in_range = np.r_[np.sort(rng.integers(0, s, 5)), s - 1, -7]
    want = np.asarray(jsg.gather_blocks(
        jnp.asarray(attrs.view(np.float32)),
        jnp.asarray(in_range.astype(np.int32)),
        interpret=True)).view(np.int32)
    got = tsg.gather_blocks(T(attrs), T(in_range.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    wide = np.array([2 ** 31, 2 ** 40 + 3, -2 ** 31 - 5, -2 ** 40, s],
                    np.int64)
    got = tsg.gather_blocks(T(attrs), T(wide)).numpy().reshape(3, 5, 128)
    padded = np.pad(attrs, ((0, 0), (0, 128)))
    for b, lo in enumerate((s - 1, s - 1, 0, 0, s - 1)):
        np.testing.assert_array_equal(got[:, b], padded[:, lo:lo + 128])


def test_owner_of_slots_matches_jax():
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 6, 500).astype(np.int32)
    cum = np.cumsum(counts).astype(np.int32)
    slots = np.r_[0, rng.integers(0, cum[-1] + 50, 300),
                  cum[-1] - 1, cum[-1]].astype(np.int32)
    want = np.asarray(jsg.owner_of_slots(jnp.asarray(cum),
                                         jnp.asarray(slots)))
    got = tsg.owner_of_slots(T(cum), T(slots))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---- what only the port offers ----

@pytest.mark.parametrize("fn", ["prefix", "window", "async"])
def test_int32_rows_and_exact_length(fn):
    """Integer rows ride as they are, and out_len=None sizes the output to
    exactly the total -- here not a multiple of 128."""
    rng = np.random.default_rng(11)
    s = 333
    counts = rng.integers(1, 7, s).astype(np.int32)
    counts[250:] = 0
    attrs = rng.integers(-2 ** 31, 2 ** 31 - 1, (3, s)).astype(np.int32)
    if fn == "prefix":
        out, rank, total = tsg.expand_attrs(T(attrs), T(counts))
    else:
        out, rank, total, ok = tsg.expand_attrs_windowed(
            T(attrs), T(counts), None, window_items=256, slots_per_step=200,
            dma=fn == "async")
        assert bool(ok)
    n = int(counts.sum())
    assert n % 128 and int(total) == n
    assert out.shape == (3, n) and out.dtype == torch.int32
    owner = np.repeat(np.arange(s), counts)
    np.testing.assert_array_equal(out.numpy(), attrs[:, owner])
    starts = np.cumsum(counts) - counts
    np.testing.assert_array_equal(rank.numpy(), np.arange(n) - starts[owner])


@pytest.mark.parametrize("out_len", [None, 0, 256])
def test_all_zero_counts(out_len):
    attrs = np.arange(40, dtype=np.float32).reshape(4, 10)
    counts = np.zeros(10, np.int64)
    out, rank, total = tsg.expand_attrs(T(attrs), T(counts), out_len)
    out_w, rank_w, total_w, ok = tsg.expand_attrs_windowed(
        T(attrs), T(counts), out_len)
    n = out_len or 0
    assert int(total) == int(total_w) == 0 and bool(ok)
    assert out.shape == out_w.shape == (4, n)
    assert rank.shape == rank_w.shape == (n,)


@pytest.mark.parametrize("out_len", [None, 0, 256])
def test_no_items(out_len):
    """An expansion of no items has no live slot (a view whose points emit
    no tile row hands binning's second expansion such a table)."""
    attrs = torch.zeros((3, 0), dtype=torch.int32)
    counts = torch.zeros(0, dtype=torch.int32)
    out, rank, total = tsg.expand_attrs(attrs, counts, out_len)
    out_w, rank_w, total_w, ok = tsg.expand_attrs_windowed(
        attrs, counts, out_len, window_items=768, slots_per_step=512)
    n = out_len or 0
    assert int(total) == int(total_w) == 0 and bool(ok)
    assert out.shape == out_w.shape == (3, n) and out.dtype == torch.int32
    assert rank.shape == rank_w.shape == (n,)


def test_truncating_length_keeps_the_leading_slots():
    attrs, counts, _ = prefix_case()
    full = tsg.expand_attrs(T(attrs), T(counts))
    cut = tsg.expand_attrs_windowed(T(attrs), T(counts), 130,
                                    slots_per_step=128)
    assert int(cut[2]) == int(full[2]) > 130 and bool(cut[3])
    assert torch.equal(cut[0], full[0][:, :130])
    assert torch.equal(cut[1], full[1][:130])


def test_prefix_counts_always_fit_the_step_window():
    """With counts > 0 forming a prefix every step of `step` slots has
    owners within `step` items, so window_items = step rounded up to 128 is
    sufficient whatever the counts -- the case of binning's first
    expansion."""
    rng = np.random.default_rng(13)
    for step in (128, 512):
        for hi in (2, 40, 700):
            live = int(rng.integers(1, 3000))
            counts = np.zeros(3000, np.int32)
            counts[:live] = rng.integers(1, hi, live)
            attrs = np.zeros((1, 3000), np.float32)
            ok = tsg.expand_attrs_windowed(
                T(attrs), T(counts), None, window_items=step,
                slots_per_step=step)[3]
            assert bool(ok), (step, hi, live)


def test_wrappers_reject_what_the_kernels_do_not_take():
    attrs = torch.zeros((2, 8))
    counts = torch.ones(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        tsg.expand_attrs(attrs.double(), counts)
    with pytest.raises(TypeError):
        tsg.expand_attrs(attrs, counts.float())
    with pytest.raises(ValueError):
        tsg.expand_attrs(attrs, counts[:5])
    with pytest.raises(ValueError):
        tsg.expand_attrs(attrs[0], counts)
    with pytest.raises(ValueError, match="multiple of 128"):
        tsg.expand_attrs_windowed(attrs, counts, None, window_items=100)
    with pytest.raises(ValueError):
        tsg.expand_attrs_windowed(attrs, counts, None, slots_per_step=0)
    with pytest.raises(TypeError):
        tsg.gather_blocks(attrs, torch.zeros(2))
