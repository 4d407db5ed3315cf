"""A run with the program broken underneath the timed path comes out with
``correct`` false: a step that leaves its state unchanged, half of each
view left out of the loss, an answer altered where it is produced."""
import pytest
import torch

from gsbench import run


def _unchanged(mp):
    import litegs_torch.training.trainer as t
    mp.setattr(t, "sparse_adam_step", lambda *a, **k: None)


def _half_view(mp):
    import litegs_torch.training.trainer as t
    orig = t.view_loss

    def half(op, pp, img, gt, scale, trans):
        h = img.shape[1] // 2
        return orig(op, pp, img[:, :h], gt[:, :h], scale, trans)
    mp.setattr(t, "view_loss", half)


def _colour_grad_doubled(mp):
    from litegs_torch.ops import raster_cuda
    orig = raster_cuda.raster_backward

    def doubled(*a, **k):
        g = orig(*a, **k)
        return g._replace(d_color=2 * g.d_color)
    mp.setattr(raster_cuda, "raster_backward", doubled)


def _render_patch(mp, fn):
    import litegs_torch.training.trainer as t
    orig = t.render

    def patched(*a, **k):
        out = orig(*a, **k)
        return out._replace(img=fn(out.img))
    mp.setattr(t, "render", patched)


def _stale(mp):
    # each frame comes back as the frame before it
    last = []

    def previous(img):
        last.append(img)
        return last[-2] if len(last) > 1 else img
    _render_patch(mp, previous)


def _half_tiles(mp):
    def cut(img):
        h = img.shape[1] // 2
        return torch.cat([img[:, :h], torch.zeros_like(img[:, h:])], 1)
    _render_patch(mp, cut)


def _pixel(mp):
    def alter(img):
        img = img.clone()
        img[0, 0, 0] += 0.5
        return img
    _render_patch(mp, alter)


@pytest.mark.parametrize("cell,fault", [
    ("garden1m-refine", _unchanged), ("garden1m-refine", _half_view),
    ("garden1m-refine", _colour_grad_doubled),
    ("garden6m-serve", _stale), ("garden6m-serve", _half_tiles),
    ("garden6m-serve", _pixel)])
def test_fault_is_not_correct(cell, fault, tiny, monkeypatch):
    fault(monkeypatch)
    result, _, lines = run.run_cell(cell, 2 ** 31 + 21, 0.5, False, "cpu",
                                    config_update=tiny)
    assert result["correct"] is False, lines
