"""Streaming expansion and block gather: the wrappers of
``csrc/stream_gather.cu``.

The counterpart of ``litegs_tpu/ops/stream_gather.py``, with the same public
names and argument order.  An expansion replicates per-item attribute rows
``attrs [A, S]`` into flat slots by per-item ``counts``: slot ``e`` belongs
to the item ``owner[e]`` whose run of ``counts[owner]`` slots holds it, at
``rank[e] = e - starts[owner]``.  It is the emit half of the reference's
prefix-sum + emit (``duplicate_with_keys``, binning.cu:33-110).

=========================  ==========================  =====================
function                   kernel on a CUDA tensor     replaces (JAX package)
=========================  ==========================  =====================
expand_attrs               expand_prefix_kernel        _expand_kernel
expand_attrs_windowed      expand_window_kernel        _expand_kernel_w
expand_attrs_windowed      expand_window_async_kernel  _expand_kernel_dma
  (dma=True)
gather_blocks              gather_blocks_kernel        _monotonic_kernel
=========================  ==========================  =====================

All four are bound by bytes on the H100 (each output word written once, the
payload read once); see the source for what each design does about it.  The
prefix sum of the counts stays a torch op here, as it is an XLA op outside
the Pallas bodies in the JAX package.  The per-step owner search and the
window check, XLA ops there too, run inside the two window kernels: their
wrapper runs the prefix sum, allocates the two outputs and a one-byte ``ok``
set to true, and launches (:func:`window_step_plain` is the plain model of
one block of ``expand_window_kernel``, :func:`window_block_plain` of one
persistent block of ``expand_window_async_kernel``).  ``gather_blocks``
hands its offsets to its kernel as they are, int32 or int64: its call is
the one launch.

The kernels move 4-byte words, so ``attrs`` may be float32 or int32 and
integer columns ride as they are.  ``out_len`` may be any length, or None
for exactly the total (one host read of the prefix sum's last element).
An expansion of no items (S = 0) or of no slots launches nothing and
returns empty or arbitrary buffers with ``total`` 0.
The JAX functions' ``A % 8``, ``out_len % 128``, start and attribute pads,
lookahead sentinel and f32-encoded integers are TPU needs and are not
carried over.

On a CPU tensor each function computes the same result with its plain
PyTorch version (``*_plain``); on a CUDA tensor it launches its kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import profiling
from . import _kernels

BLK = 128
SMEM_MAX = 232448    # bytes of shared memory one block can opt in to
# items one planning round of expand_window_async_kernel reads (four per
# thread of its 128)
ASYNC_ROUND = 512

# kernel launches per kernel, and calls of any plain version, so a run can
# show which route it took
LAUNCHES = {"expand_prefix_kernel": 0, "expand_window_kernel": 0,
            "expand_window_async_kernel": 0, "gather_blocks_kernel": 0}
PLAIN_CALLS = 0


def reset_counts():
    global PLAIN_CALLS
    PLAIN_CALLS = 0
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _kernels.library("stream_gather")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.litegs_expand_prefix.argtypes = [p] * 5 + [i] * 3 + [p]
    lib.litegs_expand_window.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.litegs_expand_window_async.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.litegs_gather_blocks.argtypes = [p] * 3 + [i] * 4 + [p]
    for fn in (lib.litegs_expand_prefix, lib.litegs_expand_window,
               lib.litegs_expand_window_async, lib.litegs_gather_blocks):
        fn.restype = i
    lib.litegs_error_string.argtypes = [i]
    lib.litegs_error_string.restype = ctypes.c_char_p
    return lib


def _launch(kernel: str, fn_name: str, *args):
    """Call one launcher of the library on the current stream; raise if the
    launch was refused, count it otherwise."""
    lib = _lib()
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           + lib.litegs_error_string(rc).decode())
    LAUNCHES[kernel] += 1


def _stream(dev) -> int:
    """The raw handle of ``dev``'s current CUDA stream, from torch's own
    accessor (no Stream object is built)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _check_attrs(attrs):
    if attrs.dim() != 2:
        raise ValueError(f"attrs: shape {tuple(attrs.shape)}, expected "
                         "[A, S]")
    if attrs.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"attrs: dtype {attrs.dtype}, expected float32 or "
                        "int32 (the kernels move 4-byte words)")
    if attrs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {attrs.device}")


def _check_index(name, t, length, device):
    if t.dim() != 1 or t.shape[0] != length:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"({length},)")
    if t.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: dtype {t.dtype}, expected int32 or int64")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def owner_of_slots(cum, slots):
    """owner(slot) = first i with cum[i] > slot, clamped to the last item
    (int32)."""
    n = cum.shape[0]
    owner = torch.searchsorted(cum, slots.to(cum.dtype), right=True,
                               out_int32=True)
    return owner.clamp_(max=n - 1)


def _prefix(attrs, counts, out_len):
    """Checks and the prefix sum the expansions share: returns (cum int64,
    total 0-d int64, out_len int).  ``attrs`` may hold no items."""
    _check_attrs(attrs)
    _check_index("counts", counts, attrs.shape[1], attrs.device)
    cum = torch.cumsum(counts, 0)
    # no items expand to no live slot
    total = cum[-1] if attrs.shape[1] else cum.new_zeros(())
    if out_len is None:
        profiling.host_wait("bin.total")
        out_len = int(total)
        if out_len >= 2 ** 31:
            raise ValueError(f"{out_len} slots do not fit int32 offsets")
    if out_len < 0:
        raise ValueError(f"out_len {out_len} is negative")
    return cum, total, out_len


def _starts(cum, counts):
    """Every item's first slot, the exclusive prefix sum (int32)."""
    return (cum - counts).to(torch.int32)


def _check_window_args(window_items: int, slots_per_step: int):
    if window_items <= 0 or window_items % BLK:
        raise ValueError(f"window_items {window_items} is not a positive "
                         f"multiple of {BLK}")
    if slots_per_step <= 0:
        raise ValueError(f"slots_per_step {slots_per_step} is not positive")


def step_owners(cum, total, out_len: int, slots_per_step: int):
    """The owners of the first and of the last slot of every output step:
    [2, steps] int32.  Slots past the total have no owner, so the queries
    are clamped to the live range (the output there is arbitrary by
    contract)."""
    steps = -(-out_len // slots_per_step)
    step0 = torch.arange(0, steps * slots_per_step, slots_per_step,
                         dtype=cum.dtype, device=cum.device)
    ends = torch.stack([step0, step0 + (slots_per_step - 1)])
    ends = torch.minimum(ends, torch.clamp(total - 1, min=0))
    return owner_of_slots(cum, ends)


def _window_plan(cum, total, out_len: int, window_items: int,
                 slots_per_step: int):
    """The window check of ``litegs_tpu/ops/stream_gather.py:223-238``,
    as the plain version makes it: ok (0-d bool) iff every output step's
    owners span at most ``window_items`` items."""
    _check_window_args(window_items, slots_per_step)
    blk_lo, blk_hi = step_owners(cum, total, out_len, slots_per_step)
    return torch.all(blk_hi - blk_lo <= window_items)


def _window_prelude(attrs, counts, out_len):
    """The torch ops of a window kernel's call besides its launch: the
    prefix sum, the two outputs and the ok byte, set to true (the kernel
    clears it where a step's owners outrun the window).  Returns (cum,
    total, out_len, out, rank, ok)."""
    cum, total, out_len = _prefix(attrs, counts, out_len)
    out, rank = _empty_out(attrs, out_len)
    ok = torch.ones((), dtype=torch.bool, device=attrs.device)
    return cum, total, out_len, out, rank, ok


def _empty_out(attrs, out_len):
    return (torch.empty((attrs.shape[0], out_len), dtype=attrs.dtype,
                        device=attrs.device),
            torch.empty(out_len, dtype=torch.int32, device=attrs.device))


def expand_attrs(attrs, counts, out_len=None):
    """Replicate per-item attribute rows into flat expansion slots.

    Args:
      attrs:  [A, S] float32 or int32 per-item rows.
      counts: [S] int32 (or int64) per-item slot counts.  Items with
        count > 0 MUST form a contiguous prefix (callers sort empties to
        the tail).
      out_len: output slots, or None for exactly the total.
    Returns:
      (out [A, out_len], rank [out_len] int32, total 0-d int64).  Slots past
      ``total`` hold arbitrary values; callers mask.
    """
    if attrs.device.type == "cpu":
        return expand_attrs_plain(attrs, counts, out_len)
    cum, total, out_len = _prefix(attrs, counts, out_len)
    attrs = attrs.contiguous()
    out, rank = _empty_out(attrs, out_len)
    if out_len and attrs.numel():
        a, s = attrs.shape
        starts = _starts(cum, counts)
        counts32 = counts.to(torch.int32).contiguous()
        _launch("expand_prefix_kernel", "litegs_expand_prefix",
                attrs.data_ptr(), starts.data_ptr(), counts32.data_ptr(),
                out.data_ptr(), rank.data_ptr(), a, s, out_len,
                _stream(attrs.device))
    return out, rank, total


def expand_attrs_windowed(attrs, counts, out_len=None,
                          window_items: int = 256,
                          slots_per_step: int = 256, dma: bool = False):
    """Replicate per-item attribute rows into flat expansion slots, with a
    parametric item window and multi-slot output steps.

    Unlike :func:`expand_attrs`, zero-count items may appear ANYWHERE (the
    owner decode skips them); the guarantee is instead checked: ``ok`` is
    False iff some output step's owners span more items than the window
    covers, and then ``out`` and ``rank`` are not to be used.  With
    counts > 0 forming a contiguous prefix, ``window_items =
    slots_per_step`` rounded up to 128 is strictly sufficient.

    Args:
      attrs:  [A, S] float32 or int32 per-item rows.
      counts: [S] int32 (or int64) per-item slot counts (>= 0).
      out_len: output slots, or None for exactly the total.
      window_items: item-window width (a multiple of 128): a step's
        owners must lie within ``window_items`` items of its first (the
        kernels stage ``window_items + 128`` items from a 128-aligned
        start).
      slots_per_step: output slots per step, the unit of the window
        check (a block of ``expand_window_kernel`` decodes one step).
      dma: run ``expand_window_async_kernel``: persistent blocks that
        stage each step's owned items in shared memory by asynchronous
        copies while the previous step is written out
        (:func:`window_block_plain`), instead of reading attributes through
        the cache.
    Returns:
      (out [A, out_len], rank [out_len] int32, total 0-d int64, ok 0-d
      bool).  Slots past ``total`` hold arbitrary values.
    """
    if attrs.device.type == "cpu":
        return expand_attrs_windowed_plain(attrs, counts, out_len,
                                           window_items, slots_per_step)
    _check_window_args(window_items, slots_per_step)
    # each block of the kernel plans its own step (window_step_plain)
    cum, total, out_len, out, rank, ok = _window_prelude(attrs, counts,
                                                         out_len)
    a, s = attrs.shape
    names = ("expand_window_kernel", "litegs_expand_window")
    if dma:
        # two stages of [A + 1, window_items + 8] words (ends and
        # attributes), and a step's owners and ranks
        # (csrc/stream_gather.cu async_smem)
        smem = 4 * (2 * (a + 1) * (window_items + 8) + 2 * slots_per_step)
        if smem > SMEM_MAX:
            raise ValueError(
                f"two [{a} + 1, {window_items + 8}] stages and a "
                f"{slots_per_step}-slot step need {smem} bytes of shared "
                f"memory; a block has {SMEM_MAX}")
        names = ("expand_window_async_kernel", "litegs_expand_window_async")
    attrs = attrs.contiguous()
    if out_len and s:
        _launch(*names, attrs.data_ptr(), cum.data_ptr(), out.data_ptr(),
                rank.data_ptr(), ok.data_ptr(), a, s, out_len, window_items,
                slots_per_step, _stream(attrs.device))
    return out, rank, total, ok


def gather_blocks(attrs, src_lo):
    """Gather 128-wide runs: ``out[:, 128 b + j] = attrs[:, lo[b] + j]`` with
    ``lo = clip(src_lo, 0, S - 1)``, zero where ``lo[b] + j`` is past S.

    The 128-alignment pass of a binning table has exactly this shape (each
    aligned block reads one tile's consecutive unaligned entries).
    ``src_lo`` may be int32 or int64; the kernel clamps it, so a call is
    one launch besides the output's allocation.
    """
    if attrs.device.type == "cpu":
        return gather_blocks_plain(attrs, src_lo)
    _check_attrs(attrs)
    _check_index("src_lo", src_lo, src_lo.shape[0], attrs.device)
    a, s = attrs.shape
    if s == 0:
        raise ValueError("attrs has no items")
    nb = src_lo.shape[0]
    attrs = attrs.contiguous()
    out = torch.empty((a, nb * BLK), dtype=attrs.dtype, device=attrs.device)
    if nb and a:
        src_lo = src_lo.contiguous()
        _launch("gather_blocks_kernel", "litegs_gather_blocks",
                attrs.data_ptr(), src_lo.data_ptr(), out.data_ptr(), a, s,
                nb, int(src_lo.dtype == torch.int64), _stream(attrs.device))
    return out


# ---- plain PyTorch versions ----

def _expand_plain(attrs, cum, starts, out_len: int):
    if attrs.shape[1] == 0:
        return _empty_out(attrs, out_len)
    slots = torch.arange(out_len, dtype=cum.dtype, device=cum.device)
    owner = owner_of_slots(cum, slots).long()
    rank = (slots - starts[owner]).to(torch.int32)
    return attrs[:, owner], rank


def expand_attrs_plain(attrs, counts, out_len=None):
    """The plain PyTorch version of :func:`expand_attrs`: a searchsorted
    over the prefix sum and one indexing call.  Slots past the total repeat
    the last item."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    cum, total, out_len = _prefix(attrs, counts, out_len)
    out, rank = _expand_plain(attrs, cum, _starts(cum, counts), out_len)
    return out, rank, total


def expand_attrs_windowed_plain(attrs, counts, out_len=None,
                                window_items: int = 256,
                                slots_per_step: int = 256,
                                dma: bool = False):
    """The plain PyTorch version of :func:`expand_attrs_windowed`; ``ok``
    comes from the same owner-span test.  ``dma`` selects between two
    kernels and changes nothing here."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    cum, total, out_len = _prefix(attrs, counts, out_len)
    ok = _window_plan(cum, total, out_len, window_items, slots_per_step)
    out, rank = _expand_plain(attrs, cum, _starts(cum, counts), out_len)
    return out, rank, total, ok


def window_step_plain(cum, step: int, window_items: int,
                      slots_per_step: int, out_len: int):
    """The plain model of one block of the window kernels: step ``step`` of
    an expansion with the inclusive prefix sum ``cum`` (one item at
    least).

    The block finds ``lo``, the owner of the step's first slot
    (:func:`owner_of_slots`), and applies the window check of
    ``litegs_tpu/ops/stream_gather.py:223-238``: the owner ``hi`` of its
    last slot, both queries clamped to ``[0, total - 1]``, lies within
    ``lo + window_items``.  That needs one item: ``hi`` is there iff the
    window reaches the last item or the window's last item ends past the
    query.  Then the decode: the block stages the starts of the
    ``window_items + 128`` items from ``lo`` rounded down to 128, and a
    slot's owner is the last of them that starts at or before the slot (an
    item with a zero count shares its start with the next item).

    Returns (lo, ok, owner [n] int64, rank [n] int32) for the step's n
    slots inside ``[0, out_len)``, owner and rank None when ``ok`` is
    False (the kernel then writes nothing).  Slots past the total get the
    values the kernel writes there.
    """
    s = cum.shape[0]
    s0 = step * slots_per_step
    n = min(slots_per_step, out_len - s0)
    last_live = max(int(cum[-1]) - 1, 0)
    q1 = min(s0 + slots_per_step - 1, last_live)
    lo = int(owner_of_slots(cum, cum.new_tensor([min(s0, last_live)]))[0])
    far = lo + window_items
    if not (far >= s - 1 or int(cum[far]) > q1):
        return lo, False, None, None
    w0 = lo // BLK * BLK
    j = torch.arange(w0, min(w0 + window_items + BLK, s), device=cum.device)
    start = torch.where(j > 0, cum[(j - 1).clamp(min=0)],
                        torch.zeros_like(j))
    slots = torch.arange(s0, s0 + n, dtype=cum.dtype, device=cum.device)
    local = torch.searchsorted(start, slots, right=True) - 1
    return lo, True, w0 + local, (slots - start[local]).to(torch.int32)


def window_block_plain(cum, first_step: int, end_step: int,
                       window_items: int, slots_per_step: int,
                       out_len: int):
    """The plain model of one persistent block of
    ``expand_window_async_kernel``: steps ``[first_step, end_step)`` of an
    expansion with the inclusive prefix sum ``cum`` (one item at least),
    planned as the block plans them.

    The block searches ``lo``, the owner of its first step's first slot
    (:func:`owner_of_slots`), once.  Each step's plan then reads ``cum``
    from ``lo`` on, :data:`ASYNC_ROUND` items a round, and counts the
    items ending at or before the step's last slot and the next step's
    first slot (both clamped to ``[0, total - 1]``): the first count short
    of the round gives ``hi``, the owner of the last slot, and the second
    the next step's ``lo``.  The rounds stop once they pass
    ``lo + window_items``; ``ok`` (the window check of
    ``litegs_tpu/ops/stream_gather.py:223-238``) is ``hi - lo <=
    window_items``.  A next ``lo`` the rounds did not reach is searched
    anew.  A passing step decodes each slot's owner among the ends of
    ``[lo, hi]``; a slot past the total takes the owner of the last live
    slot.

    Returns one ``(lo, hi, ok, owner [n] int64, rank [n] int32)`` per step
    for its n slots inside ``[0, out_len)``; ``hi``, ``owner`` and
    ``rank`` are None when ``ok`` is False (the kernel then writes
    nothing for the step).
    """
    s = cum.shape[0]
    last_live = max(int(cum[-1]) - 1, 0)

    def owner(q):
        return int(owner_of_slots(cum, cum.new_tensor([q]))[0])

    lo = owner(min(first_step * slots_per_step, last_live))
    plans = []
    for step in range(first_step, end_step):
        s0 = step * slots_per_step
        q1 = min(s0 + slots_per_step - 1, last_live)
        qn = min(s0 + slots_per_step, last_live)
        hi = nxt = None
        base = lo
        while True:
            seg = cum[base:base + ASYNC_ROUND]
            n1, nn = int((seg <= q1).sum()), int((seg <= qn).sum())
            if nxt is None and nn < len(seg):
                nxt = base + nn
            if n1 < len(seg):
                hi = base + n1
                break
            if base + len(seg) >= s:      # every count is zero
                hi = s - 1
                nxt = s - 1 if nxt is None else nxt
                break
            if base + len(seg) > lo + window_items:
                break
            base += ASYNC_ROUND
        if hi is not None and hi - lo > window_items:
            hi = None
        if nxt is None:
            nxt = owner(qn)
        if hi is None:
            plans.append((lo, None, False, None, None))
        else:
            n = min(slots_per_step, out_len - s0)
            slots = torch.arange(s0, s0 + n, dtype=cum.dtype,
                                 device=cum.device)
            ends = cum[lo:hi + 1]
            local = torch.searchsorted(
                ends, slots.clamp(max=last_live), right=True).clamp_(
                    max=hi - lo)
            start_lo = cum[lo - 1] if lo else cum.new_zeros(())
            start = torch.where(local > 0, ends[(local - 1).clamp(min=0)],
                                start_lo)
            plans.append((lo, hi, True, lo + local,
                          (slots - start).to(torch.int32)))
        lo = nxt
    return plans


def gather_blocks_plain(attrs, src_lo):
    """The plain PyTorch version of :func:`gather_blocks`: one indexing
    call and a mask."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    _check_attrs(attrs)
    _check_index("src_lo", src_lo, src_lo.shape[0], attrs.device)
    a, s = attrs.shape
    if s == 0:
        raise ValueError("attrs has no items")
    idx = (src_lo.long().clamp(0, s - 1)[:, None]
           + torch.arange(BLK, device=attrs.device)).flatten()
    run = attrs[:, idx.clamp(max=s - 1)]
    return torch.where(idx < s, run, torch.zeros_like(run))
