"""Run one cell of the benchmark once and print its result line.

    python3 -m gsbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, kernel libraries, the scene, the check steps) counts
from process start to the first timed step.  The window runs the cell's
mix for ``--seconds``; with ``--trace 1`` a short profiled stretch
follows it.  Once the window has closed and the device's peak memory is
read, the program's state is freed and the reference is run on the same
inputs.  The last line of standard output is one JSON object; the
numbers compared with the reference, each with its limit, are the last
lines of standard error.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "litegs_tpu")
# (entry, pixel) pairs per block of whole tiles in the reference's blend
MAX_PAIRS = 1 << 26


def load_spec(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(path.read_text())


def _named(items, name: str):
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(name)


def metrics_for(spec: dict, cell: str, trace: bool):
    """The cell's end-to-end metrics (trace 0) or per-layer ones
    (trace 1)."""
    group = spec["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    """The module ``metrics/<name>.py``."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gsbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _program_counters():
    from litegs_torch.ops import binning, raster_plain, stream_gather
    return (stream_gather.PLAIN_CALLS + raster_plain.CALLS
            + raster_plain.BACKWARD_CALLS + binning.PLAIN_CALLS)


def new_run(workload: str, seed: int, device: str, spec: dict | None = None,
            config_update: dict | None = None,
            traffic_update: dict | None = None):
    """The state of one run of a cell: its configuration and traffic mix
    (with ``config_update``'s and ``traffic_update``'s keys replaced: the
    CPU tests' tiny sizes), the seed and the device.  TF32 is switched
    off."""
    import torch
    spec = load_spec() if spec is None else spec
    cell = _named(spec["workloads"], workload)
    conf = _named(spec["configs"], cell["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    config.update(config_update or {})
    traffic = json.loads((PKG / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    traffic.update(traffic_update or {})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return types.SimpleNamespace(
        cell=workload, chips=cell["chips"], config=config, traffic=traffic,
        seed=seed % (1 << 63), device=torch.device(device),
        max_pairs=MAX_PAIRS, trace=None, work=None)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None,
             spec: dict | None = None, config_update: dict | None = None,
             traffic_update: dict | None = None):
    """Run one cell; returns (result dict, info lines, check lines)."""
    import torch
    t0 = T0 if t0 is None else t0
    spec = load_spec() if spec is None else spec
    run = new_run(workload, seed, device, spec, config_update,
                  traffic_update)
    run.seconds = seconds
    dev = run.device
    loop = importlib.import_module(f"gsbench.loops.{run.traffic['loop']}")
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    plain0 = _program_counters()
    phases, last = {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        phases[name] = now - last[0]
        last[0] = now

    loop.setup(run)
    run.setup_s = time.perf_counter() - t0
    mark("setup")
    loop.window(run)
    mark("window")
    if trace:
        loop.traced(run)
        mark("traced")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    plain = _program_counters() - plain0
    loop.release(run)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    mark("release")
    numbers = loop.check(run)
    mark("reference")
    if on_card:
        # no plain fallback on the card: an exact count
        numbers["plain_calls"] = plain
    if trace:
        run.work = loop.work(run)
        mark("work counts")
    from . import check
    correct, shown = check.judge(numbers, check.limits(workload))
    metrics = {}
    for m in metrics_for(spec, workload, trace):
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": run.window["views"],
              "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else dev.type,
                         "kind": (torch.cuda.get_device_name(dev) if on_card
                                  else "cpu"),
                         "count": run.chips, "memory_peak_bytes": peak}}
    info = [f"cell {workload} seed {seed} seconds {seconds} trace "
            f"{int(trace)}", f"card {card_line() if on_card else 'none'}",
            f"memory_peak_bytes {peak}",
            f"window views {run.window['views']} in "
            f"{run.window['seconds']:.6f} s", f"setup_s {run.setup_s:.6f}",
            f"plain_calls {plain}",
            "phases " + " ".join(f"{k}={v:.3f}s" for k, v in phases.items())]
    if trace:
        t = run.trace
        result["device"]["busy_s"] = t["busy_s"]
        result["device"]["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
        info.append(f"traced views {t['views']} kernels {t['kernels']}")
        info += [f"work view {i}: {json.dumps(w)}"
                 for i, w in enumerate(run.work)]
    for key, ends in run.window.items():
        if key.endswith("_ends_s"):
            info.append(f"window {key[:-len('_ends_s')]} ends (s) "
                        + " ".join(f"{t:.4f}" for t in ends))
    if getattr(run, "detail", None):
        info.append("detail " + json.dumps(run.detail))
    result["check"] = shown
    lines = [f"check {k} {v['value']!r} limit {v['limit']!r}"
             for k, v in shown.items()]
    return result, info, lines


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    cell = _named(spec["workloads"], args.workload)
    try:
        importlib.import_module("litegs_torch")
    except ImportError as e:
        print(f"gsbench: the program under test does not import: {e}",
              file=sys.stderr)
        return 2
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"gsbench: cell {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result, info, lines = run_cell(args.workload, args.seed, args.seconds,
                                   bool(args.trace), "cuda", spec=spec)
    bad = forbidden_modules()
    if bad:
        print(f"gsbench: modules loaded that the port must not load: {bad}",
              file=sys.stderr)
        return 3
    for line in info + lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
