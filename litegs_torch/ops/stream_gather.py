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
prefix sum of the counts and the per-step owner search stay torch ops here,
as they are XLA ops outside the Pallas bodies in the JAX package.

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

from . import _kernels

BLK = 128
SMEM_MAX = 232448    # bytes of shared memory one block can opt in to

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
    lib.litegs_gather_blocks.argtypes = [p] * 3 + [i] * 3 + [p]
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
    return torch.cuda.current_stream(dev).cuda_stream


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
    """Checks and the prefix sum the expansions share: returns (cum, starts
    int32, total 0-d int64, out_len int).  ``attrs`` may hold no items."""
    _check_attrs(attrs)
    _check_index("counts", counts, attrs.shape[1], attrs.device)
    cum = torch.cumsum(counts, 0)
    # no items expand to no live slot
    total = cum[-1] if attrs.shape[1] else cum.new_zeros(())
    if out_len is None:
        out_len = int(total)
        if out_len >= 2 ** 31:
            raise ValueError(f"{out_len} slots do not fit int32 offsets")
    if out_len < 0:
        raise ValueError(f"out_len {out_len} is negative")
    starts = (cum - counts).to(torch.int32)
    return cum, starts, total, out_len


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
    """The first owner of every output step and the window check of
    ``litegs_tpu/ops/stream_gather.py:223-238``: returns (blk_lo int32
    [steps], window width in items, ok 0-d bool)."""
    if window_items <= 0 or window_items % BLK:
        raise ValueError(f"window_items {window_items} is not a positive "
                         f"multiple of {BLK}")
    if slots_per_step <= 0:
        raise ValueError(f"slots_per_step {slots_per_step} is not positive")
    nblk = window_items // BLK + 1     # +1 covers unaligned window starts
    blk_lo, blk_hi = step_owners(cum, total, out_len, slots_per_step)
    # the window anchored at floor(lo / 128) * 128 spans nblk * 128 items
    ok = torch.all(blk_hi - blk_lo <= (nblk - 1) * BLK)
    return blk_lo, nblk * BLK, ok


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
    _, starts, total, out_len = _prefix(attrs, counts, out_len)
    attrs = attrs.contiguous()
    out, rank = _empty_out(attrs, out_len)
    if out_len and attrs.numel():
        a, s = attrs.shape
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
      window_items: item-window width (a multiple of 128); the kernels'
        window holds ``window_items + 128`` items.
      slots_per_step: output slots per thread block.
      dma: stage each step's attribute and start window in shared memory
        with asynchronous copies (``expand_window_async_kernel``) instead
        of reading attributes through the cache.
    Returns:
      (out [A, out_len], rank [out_len] int32, total 0-d int64, ok 0-d
      bool).  Slots past ``total`` hold arbitrary values.
    """
    if attrs.device.type == "cpu":
        return expand_attrs_windowed_plain(attrs, counts, out_len,
                                           window_items, slots_per_step)
    cum, starts, total, out_len = _prefix(attrs, counts, out_len)
    blk_lo, window, ok = _window_plan(cum, total, out_len, window_items,
                                      slots_per_step)
    attrs = attrs.contiguous()
    out, rank = _empty_out(attrs, out_len)
    if out_len and attrs.numel():
        a, s = attrs.shape
        if dma:
            smem = (a + 1) * window * 4
            if smem > SMEM_MAX:
                raise ValueError(
                    f"a [{a} + 1, {window}] window needs {smem} bytes of "
                    f"shared memory; a block has {SMEM_MAX}")
            names = ("expand_window_async_kernel",
                     "litegs_expand_window_async")
        else:
            names = ("expand_window_kernel", "litegs_expand_window")
        _launch(*names, attrs.data_ptr(), starts.data_ptr(),
                blk_lo.data_ptr(), out.data_ptr(), rank.data_ptr(), a, s,
                out_len, window, slots_per_step, _stream(attrs.device))
    return out, rank, total, ok


def gather_blocks(attrs, src_lo):
    """Gather 128-wide runs: ``out[:, 128 b + j] = attrs[:, lo[b] + j]`` with
    ``lo = clip(src_lo, 0, S - 1)``, zero where ``lo[b] + j`` is past S.

    The 128-alignment pass of a binning table has exactly this shape (each
    aligned block reads one tile's consecutive unaligned entries).
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
        # clamp before narrowing, so an int64 offset cannot wrap
        lo = src_lo.clamp(0, s - 1).to(torch.int32).contiguous()
        _launch("gather_blocks_kernel", "litegs_gather_blocks",
                attrs.data_ptr(), lo.data_ptr(), out.data_ptr(), a, s, nb,
                _stream(attrs.device))
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
    cum, starts, total, out_len = _prefix(attrs, counts, out_len)
    out, rank = _expand_plain(attrs, cum, starts, out_len)
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
    cum, starts, total, out_len = _prefix(attrs, counts, out_len)
    _, _, ok = _window_plan(cum, total, out_len, window_items,
                            slots_per_step)
    out, rank = _expand_plain(attrs, cum, starts, out_len)
    return out, rank, total, ok


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
