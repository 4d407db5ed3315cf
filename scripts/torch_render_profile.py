"""Where one view's render time goes in litegs_torch, on one CUDA card.

    python3 scripts/torch_render_profile.py [--trace DIR]

The scene of chip_smoke.py's serving phase (1,000,000 gaussians, SH 3,
840x1296, 8x16 tiles).  Prints:
  * the program's own spans over FRAMES renders of view 0 under
    ``profiling.recording()`` (no profiler): per stage of the eval render
    (``aabb``, ``preprocess``, ``project``, ``bin``, ``raster_fwd`` and the
    root's remainder ``other``) its device and host self time a frame, and
    the host waits a frame by site;
  * binning alone on the default route ('keys'), the window route and the
    non-streaming one, in the order keys, window, off, off, window, keys
    (CUDA events, median of 5);
  * the torch.profiler top operators by device time over 5 renders, the
    device's busy share of that window's wall time, and the number of
    device kernels and copies per render; the timeline and the spans are
    written to DIR (``profiling.trace``: trace.json, spans.json).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from litegs_torch import config, evaluation  # noqa: E402
from litegs_torch.data import synthetic  # noqa: E402
from litegs_torch.ops import binning  # noqa: E402
from litegs_torch.render import _project, render_preprocess  # noqa: E402
from litegs_torch.training.trainer import (  # noqa: E402
    camera_batch_from_frames, make_eval_render, masked_chunk_aabb)
from litegs_torch.utils import profiling  # noqa: E402

FRAMES = 20      # renders the span table is taken over


def print_stages(table: dict, frames: int):
    """The recorder's stage table, a frame."""
    print(f"{'stage':12s} {'device ms':>10s} {'host ms':>10s}  host waits")
    for name, s in table["stages"].items():
        waits = " ".join(f"{k}={v / frames:g}"
                         for k, v in sorted(s["waits"].items()))
        print(f"{name:12s} {s['device_ms'] / frames:10.3f} "
              f"{s['host_ms'] / frames:10.3f}  {waits}")
    print(f"{'eval':12s} {table['device_ms'] / frames:10.3f} "
          f"{table['host_ms'] / frames:10.3f}  (the root: the stages' sum)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default="build/render_profile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke.card_line()}")
    dev = torch.device("cuda")
    h, w, sh = chip_smoke.IMG_H, chip_smoke.IMG_W, chip_smoke.SH_DEGREE
    model = chip_smoke.make_scene(dev, chip_smoke.N_POINTS, sh)
    cam, frames = synthetic.make_cameras(1, h, w, seed=0)
    pp = config.PipelineParams()
    params, active = evaluation.prepare_model(model, pp)
    batch = camera_batch_from_frames(cam, frames, torch.zeros(1, 3, h, w),
                                     device=dev)
    view, proj, planes, center = (batch.view[0], batch.proj[0],
                                  batch.planes[0], batch.center[0])
    tile_h, tile_w = pp.tile_size
    fn = make_eval_render(pp, h, w, sh)

    def render():
        return fn(params, active, view, proj, planes, center)

    render()
    torch.cuda.synchronize()
    with profiling.recording() as rec:
        for _ in range(FRAMES):
            render()
    torch.cuda.synchronize()
    print(f"spans over {FRAMES} renders (recording, no profiler):")
    print_stages(rec.stage_table("eval"), FRAMES)

    with torch.no_grad():
        origin, extend = masked_chunk_aabb(params, active, pp.cluster_size)
        culled = render_preprocess(params, origin, extend, planes, center,
                                   sh, pp)
        view_pos, ndc, inv_cov = _project(culled, view, proj, h, w)
        for name, stream in (("keys", None), ("window", True),
                             ("off", False), ("off", False),
                             ("window", True), ("keys", None)):
            ms = chip_smoke.time_ms(lambda stream=stream: (
                binning.build_tile_table(
                    ndc, view_pos[2], inv_cov, culled.opacity, culled.valid,
                    h, w, tile_h, tile_w, stream=stream)))
            print(f"binning alone, route {name:6s} {ms:8.3f} ms")

    with profiling.trace(args.trace) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            render()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # device-side rows only: an operator's row repeats its kernels' time
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = sum(e.count for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"profiled 5 renders: wall {wall_us / 5e3:.3f} ms/render, device "
          f"busy {busy_us / 5e3:.3f} ms/render "
          f"({100 * busy_us / wall_us:.1f}% of wall), "
          f"{launches / 5:.0f} device kernels and copies per render; "
          f"timeline and spans in {args.trace}")
    print(events.table(sort_by="self_device_time_total", row_limit=15,
                       max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
