"""The readers of the program's own spans and host-wait counter in a tiny
traced cell on the CPU: the counts read, the device times do not."""
import pytest

from gsbench import run

MS = {"train": ["preprocess_ms.train", "project_ms.train", "bin_ms.train",
                "raster_fwd_ms.train", "loss_ms", "backward_ms",
                "raster_bwd_ms", "adam_ms"],
      "serve": ["aabb_ms.serve", "preprocess_ms.serve", "project_ms.serve",
                "bin_ms.serve", "raster_fwd_ms.serve"]}
# the waits each view counts at least, whatever the plain raster's groups:
# cull 1, binning 2 + 4, the table check 1 (+ Adam's 6 learning rates)
LEAST = {"train": 14, "serve": 8}


@pytest.mark.parametrize("cell,kind", [("garden1m-refine", "train"),
                                       ("garden6m-serve", "serve")])
def test_span_readers_in_a_tiny_traced_cell(cell, kind, tiny, monkeypatch):
    result, _, _ = run.run_cell(cell, 2 ** 31 + 23, 0.5, True, "cpu",
                                config_update=tiny)
    got = result["metrics"]
    waits = f"host_waits_per_view.{kind}"
    assert got[waits]["unit"] == "count"
    assert got[waits]["value"] >= LEAST[kind]
    # a CPU run never writes a device time
    assert not set(MS[kind]) & set(got)

    # the readers again on a run object, and on a program without the
    # recorder: nothing, and no error
    state = run.new_run(cell, 1, "cpu", config_update=tiny)
    state.trace = {"views": 0}
    assert run.reader(waits).read(state) is None
    from litegs_torch.utils import profiling
    monkeypatch.delattr(profiling, "RECORDER")
    state.trace = {"views": 8}
    assert run.reader(waits).read(state) is None
    assert all(run.reader(m).read(state) is None for m in MS[kind])
