"""Where one view's render time goes in litegs_torch, on one CUDA card.

    python3 scripts/torch_render_profile.py

The scene of chip_smoke.py's serving phase (1,000,000 gaussians, SH 3,
840x1296, 8x16 tiles).  Prints, for view 0:
  * each stage of the render path timed alone with CUDA events (median of
    5 after a warm-up), beside the whole render; binning is timed with the
    streaming expansion kernels on (the default) and off, in the order
    on, off, off, on;
  * the torch.profiler top operators by device time over 5 renders, the
    device's busy share of that window's wall time, and the number of
    device kernels and copies per render.
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from litegs_torch import config, evaluation  # noqa: E402
from litegs_torch.data import synthetic  # noqa: E402
from litegs_torch.ops import binning, projection, raster  # noqa: E402
from litegs_torch.render import _project, render_preprocess  # noqa: E402
from litegs_torch.training.trainer import (  # noqa: E402
    camera_batch_from_frames, make_eval_render, masked_chunk_aabb)
from litegs_torch.utils import math as um  # noqa: E402


def main() -> int:
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
    tiles_x, tiles_y = -(-w // tile_w), -(-h // tile_h)
    fn = make_eval_render(pp, h, w, sh)

    with torch.no_grad():
        st = {}
        st["chunk_aabb"] = lambda: masked_chunk_aabb(params, active,
                                                     pp.cluster_size)
        origin, extend = st["chunk_aabb"]()
        st["cull+gather+sh"] = lambda: render_preprocess(
            params, origin, extend, planes, center, sh, pp)
        culled = st["cull+gather+sh"]()
        st["projection"] = lambda: _project(culled, view, proj, h, w)
        view_pos, ndc, inv_cov = st["projection"]()
        for name, stream in (("binning", True), ("binning stream off", False),
                             ("binning stream off (2)", False),
                             ("binning (2)", True)):
            st[name] = lambda stream=stream: binning.build_tile_table(
                ndc, view_pos[2], inv_cov, culled.opacity, culled.valid, h,
                w, tile_h, tile_w, stream=stream)
        table = st["binning"]()
        mean_pix = projection.ndc_to_pixel(ndc, h, w)
        st["raster kernel"] = lambda: raster.rasterize(
            mean_pix, inv_cov, culled.color, culled.opacity, table,
            tiles_x * tiles_y, tiles_x, tile_h, tile_w)
        tiles_color = st["raster kernel"]()[0]
        st["tiles_to_img"] = lambda: um.tiles_to_img(
            tiles_color, h, w, tile_h, tile_w).clamp(0.0, 1.0)
        total = 0.0
        for name, f in st.items():
            ms = chip_smoke.time_ms(f)
            # the sum takes binning once, on its default route
            total += 0.0 if name.startswith("binning ") else ms
            print(f"stage {name:22s} {ms:8.3f} ms")
        print(f"stages summed           {total:8.3f} ms")
        whole = chip_smoke.time_ms(
            lambda: fn(params, active, view, proj, planes, center))
        print(f"whole render            {whole:8.3f} ms")

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        fn(params, active, view, proj, planes, center)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                fn(params, active, view, proj, planes, center)
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
          f"{launches / 5:.0f} device kernels and copies per render")
    print(events.table(sort_by="self_device_time_total", row_limit=15,
                       max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
