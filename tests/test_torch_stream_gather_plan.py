"""The window kernels' plan and decode, in plain PyTorch, against litegs_tpu.

``expand_window_kernel`` and ``expand_window_async_kernel`` find each output
step's first owner, apply the window check and decode each slot's owner
inside the kernel.
``litegs_torch.ops.stream_gather.window_step_plain`` models one block of
that work; here it is held, on numpy-seeded counts, to
``litegs_tpu.ops.stream_gather.owner_of_slots`` and to the ``ok``, ``out``
and ``rank`` of JAX's ``expand_attrs_windowed`` (its Pallas kernel in
interpret mode), and to the port's ``owner_of_slots``.
``expand_window_async_kernel`` plans differently: persistent blocks, each
over a range of steps, carry each step's first owner over from the
previous step's plan.  ``window_block_plain`` models one such block and is
held, for several splits of the steps among blocks, to the same JAX
functions and to JAX's ``dma=True`` expansion.  Everything compared is an
integer: tolerance 0.  The kernels themselves are held to the same models
on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litegs_tpu.ops import stream_gather as jsg
from litegs_torch.ops import stream_gather as tsg


def zeros_anywhere():
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 4, 700)
    counts[rng.random(700) < 0.4] = 0
    total = int(counts.sum())
    return counts, (total + 127) // 128 * 128 + 128, 256, 128


def runs_longer_than_a_step():
    rng = np.random.default_rng(4)
    counts = rng.integers(1, 6, 400)
    counts[rng.integers(0, 400, 6)] = rng.integers(300, 700, 6)
    counts[rng.random(400) < 0.2] = 0
    total = int(counts.sum())
    return counts, (total + 255) // 256 * 256, 256, 256


def straddling_step_edges_short_length():
    # 3 slots per item against 128-slot steps: items straddle every edge;
    # out_len stops short of the total
    counts = np.full(500, 3)
    return counts, 1280, 256, 128


def window_past_the_last_item():
    rng = np.random.default_rng(5)
    return rng.integers(0, 9, 50), 384, 256, 128


def overrun():
    # slots 1..300 belong to item 600: a window of 256 items misses it
    counts = np.zeros(1024, np.int64)
    counts[0], counts[600] = 1, 300
    return counts, 512, 256, 128


def owners_at_the_window_limit():
    # step 0: lo = 0 and hi = 256, exactly window_items apart
    counts = np.zeros(1024, np.int64)
    counts[0], counts[256], counts[700] = 1, 127, 40
    return counts, 256, 256, 128


def owners_one_past_the_window_limit():
    counts = np.zeros(1024, np.int64)
    counts[0], counts[257], counts[700] = 1, 127, 40
    return counts, 256, 256, 128


def many_items_few_slots():
    # 100,000 items, a run of 300 live ones among them: the owner search
    # takes several rounds
    rng = np.random.default_rng(6)
    counts = np.zeros(100_000, np.int64)
    counts[61_000:61_300] = rng.integers(0, 4, 300)
    return counts, 512, 256, 128


def binning_expansion_1_shape():
    # the first binning expansion's step and window: 512 slots, 640 items
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 5, 3000)
    total = int(counts.sum())
    return counts, (total + 511) // 512 * 512, 640, 512


def binning_expansion_2_shape():
    # the second's: 512 slots, 768 items, no zero counts
    rng = np.random.default_rng(8)
    counts = rng.integers(1, 4, 2500)
    total = int(counts.sum())
    return counts, (total + 511) // 512 * 512, 768, 512


def one_item():
    return np.array([77]), 128, 128, 128


def leading_zeros():
    # the first 400 items own nothing: step 0's owner is item 400
    rng = np.random.default_rng(9)
    counts = rng.integers(0, 4, 1000)
    counts[:400] = 0
    total = int(counts.sum())
    return counts, (total + 255) // 256 * 256, 256, 256


def exact_total():
    # out_len equals the total: no slot past it
    counts = np.r_[np.full(256, 3), np.full(256, 1)]
    return counts, 1024, 256, 256


def long_zero_run_after_a_step():
    # step 0 ends exactly at the end of item 63's run and 4,936 empty items
    # follow: the next step's first owner lies past the plan's rounds
    counts = np.zeros(5100, np.int64)
    counts[:64], counts[5000:] = 2, 2
    return counts, 384, 256, 128


def partial_last_step():
    # out_len is not a multiple of the step: the last step has 77 slots
    rng = np.random.default_rng(10)
    counts = rng.integers(0, 4, 1500)
    counts[rng.random(1500) < 0.3] = 0
    return counts, 5 * 512 + 77, 640, 512


def spans_past_a_round():
    # more than ASYNC_ROUND items between a step's first and last owner
    rng = np.random.default_rng(11)
    counts = rng.integers(0, 2, 4000)
    counts[rng.random(4000) < 0.5] = 0
    total = int(counts.sum())
    return counts, (total + 127) // 128 * 128, 768, 128


CASES = [zeros_anywhere, runs_longer_than_a_step,
         straddling_step_edges_short_length, window_past_the_last_item,
         overrun, owners_at_the_window_limit,
         owners_one_past_the_window_limit, many_items_few_slots,
         binning_expansion_1_shape, binning_expansion_2_shape, one_item,
         leading_zeros, exact_total]
ASYNC_CASES = CASES + [long_zero_run_after_a_step, partial_last_step,
                       spans_past_a_round]
OK = {"overrun": False, "owners_one_past_the_window_limit": False}


def jax_expansion(counts, out_len, window, step, dma=False):
    """JAX's expansion of rows whose row 0 is the item index, so that its
    out[0] is each slot's owner.  JAX takes whole steps only: an out_len
    that is not a multiple of the step runs at the next multiple."""
    s = counts.shape[0]
    attrs = np.zeros((8, s), np.float32)
    attrs[0] = np.arange(s)
    out, rank, total, ok = jsg.expand_attrs_windowed(
        jnp.asarray(attrs), jnp.asarray(counts.astype(np.int32)),
        -(-out_len // step) * step, window_items=window,
        slots_per_step=step, interpret=True, dma=dma)
    return (np.asarray(out[0]).astype(np.int64), np.asarray(rank),
            int(total), bool(ok))


@pytest.mark.parametrize("case", CASES)
def test_block_model_matches_jax(case):
    counts, out_len, window, step = case()
    owner_j, rank_j, total, ok_j = jax_expansion(counts, out_len, window,
                                                 step)
    assert ok_j == OK.get(case.__name__, True)
    cum = torch.cumsum(torch.tensor(counts), 0)
    cum_j = jnp.asarray(np.cumsum(counts).astype(np.int32))
    last_live = max(total - 1, 0)
    oks = []
    for b in range(out_len // step):
        s0 = b * step
        lo, ok, owner, rank = tsg.window_step_plain(cum, b, window, step,
                                                    out_len)
        q = np.array([min(s0, last_live), min(s0 + step - 1, last_live)],
                     np.int32)
        lo_j, hi_j = np.asarray(jsg.owner_of_slots(cum_j, jnp.asarray(q)))
        assert lo == lo_j, b
        assert ok == (hi_j - lo_j <= window), b
        oks.append(ok)
        if not ok:
            continue
        live = max(0, min(step, total - s0))
        assert owner.shape == rank.shape == (step,)
        np.testing.assert_array_equal(owner[:live].numpy(),
                                      owner_j[s0:s0 + live])
        np.testing.assert_array_equal(rank[:live].numpy(),
                                      rank_j[s0:s0 + live])
        slots = torch.arange(s0, s0 + live)
        assert torch.equal(owner[:live].int(), tsg.owner_of_slots(cum, slots))
    assert all(oks) == ok_j
    # the port's plain version checks the same steps
    plain_ok = tsg.expand_attrs_windowed_plain(
        torch.zeros((1, counts.shape[0])), torch.tensor(counts), out_len,
        window, step)[3]
    assert bool(plain_ok) == ok_j


def test_block_model_of_no_live_slot():
    """All counts zero: every query clamps to slot 0, whose owner search
    finds no item and takes the last; the window holds."""
    cum = torch.zeros(300, dtype=torch.int64)
    lo, ok, owner, rank = tsg.window_step_plain(cum, 1, 256, 128, 512)
    want = np.asarray(jsg.owner_of_slots(jnp.zeros(300, jnp.int32),
                                         jnp.zeros(1, jnp.int32)))
    assert lo == want[0] == 299 and ok
    assert owner.shape == (128,) and bool((owner == 299).all())


@pytest.mark.parametrize("case", ASYNC_CASES)
def test_async_block_model_matches_jax(case):
    """window_block_plain, with the steps split among 1, 3 and one block
    per step (every split gives every step the same plan), against JAX's
    owner_of_slots and its dma=True expansion: lo, hi, ok, and the owner
    and rank of every live slot; slots past the total take the owner of
    the last live slot."""
    counts, out_len, window, step = case()
    owner_j, rank_j, total, ok_j = jax_expansion(counts, out_len, window,
                                                 step, dma=True)
    assert ok_j == OK.get(case.__name__, True)
    cum = torch.cumsum(torch.tensor(counts), 0)
    cum_j = jnp.asarray(np.cumsum(counts).astype(np.int32))
    last_live = max(total - 1, 0)
    last_owner = int(tsg.owner_of_slots(cum, torch.tensor([last_live]))[0])
    steps = -(-out_len // step)
    for grid in sorted({1, 3, steps}):
        bounds = [steps * k // grid for k in range(grid + 1)]
        plans = [plan for b0, b1 in zip(bounds, bounds[1:])
                 for plan in tsg.window_block_plain(cum, b0, b1, window,
                                                    step, out_len)]
        assert len(plans) == steps
        for b, (lo, hi, ok, owner, rank) in enumerate(plans):
            s0 = b * step
            q = np.array([min(s0, last_live), min(s0 + step - 1, last_live)],
                         np.int32)
            lo_j, hi_j = np.asarray(jsg.owner_of_slots(cum_j,
                                                       jnp.asarray(q)))
            assert lo == lo_j, (grid, b)
            assert ok == (hi_j - lo_j <= window), (grid, b)
            if not ok:
                assert hi is None and owner is None
                continue
            assert hi == hi_j, (grid, b)
            n = min(step, out_len - s0)
            live = max(0, min(n, total - s0))
            assert owner.shape == rank.shape == (n,)
            np.testing.assert_array_equal(owner[:live].numpy(),
                                          owner_j[s0:s0 + live])
            np.testing.assert_array_equal(rank[:live].numpy(),
                                          rank_j[s0:s0 + live])
            past = torch.arange(s0 + live, s0 + n)
            start = int(cum[last_owner] - counts[last_owner])
            assert bool((owner[live:] == last_owner).all()), (grid, b)
            assert torch.equal(rank[live:], (past - start).int())
        assert all(p[2] for p in plans) == ok_j
