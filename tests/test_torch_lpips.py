"""litegs_torch's LPIPS-VGG against litegs_tpu's, on CPU.

No pretrained weights exist here, and the network's computation does not
depend on them: random VGG and linear weights, written to an npz in the
format of ``scripts/export_lpips_weights.py``, go through both packages'
``load_weights`` (``LPIPS_WEIGHTS`` set with monkeypatch).  The port's
distance is held to ``litegs_tpu.ops.lpips.lpips_distance`` at rel 2e-4,
JAX's own bar against its torch transcription
(tests/test_lpips_torch_parity.py), at an odd size (33x47: the max pools
floor) and at 64x96.  ``lpips_fn`` is None without a file and with a key
missing, and ``score_split`` reports JAX's LPIPS within 2e-4 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litegs_tpu import config as jcfg
from litegs_tpu import evaluation as jeval
from litegs_tpu.ops import lpips as jlpips
from litegs_tpu.training import trainer as jtrainer

from litegs_torch import config as tcfg
from litegs_torch import evaluation as teval
from litegs_torch import metrics as tmetrics
from litegs_torch.ops import lpips as tlpips
from litegs_torch.training import trainer as ttrainer
from test_torch_render import drive_scene, to_port

CPU = "cpu"
_WIDTHS = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
_TAPS = (1, 3, 6, 9, 12)


def write_weights(path, seed=7, drop=None):
    """Random LPIPS-vgg weights as the exporter writes them."""
    rng = np.random.default_rng(seed)
    out, cin = {}, 3
    for i, cout in enumerate(_WIDTHS):
        w = rng.standard_normal((cout, cin, 3, 3)).astype(np.float32)
        out[f"conv{i}_weight"] = w * np.float32((2.0 / (cin * 9)) ** 0.5)
        out[f"conv{i}_bias"] = (0.1 * rng.standard_normal(cout)).astype(
            np.float32)
        cin = cout
    for k, t in enumerate(_TAPS):
        out[f"lin{k}"] = np.abs(rng.standard_normal(_WIDTHS[t])).astype(
            np.float32)
    if drop:
        del out[drop]
    np.savez(path, **out)
    return str(path)


@pytest.fixture()
def weights_env(tmp_path, monkeypatch):
    path = write_weights(tmp_path / "lpips_vgg.npz")
    monkeypatch.setenv("LPIPS_WEIGHTS", path)
    return path


@pytest.mark.parametrize("shape", [(33, 47), (64, 96)])
def test_lpips_matches_jax(weights_env, shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.random((3, *shape)).astype(np.float32)
    gt = np.clip(img + 0.1 * rng.standard_normal(img.shape), 0, 1).astype(
        np.float32)
    jw = jlpips.load_weights()
    tw = tlpips.load_weights()
    for (a, b), (c, d) in zip(jw["convs"], tw["convs"]):
        np.testing.assert_array_equal(np.asarray(a), c)
        np.testing.assert_array_equal(np.asarray(b), d)
    want = jlpips.lpips_distance(img, gt, jw)
    net = tlpips.LPIPSVGG(tw, device=CPU)
    got = tlpips.lpips_distance(img, gt, net)
    assert want > 0
    assert got == pytest.approx(want, rel=2e-4), (got, want)
    # a batch of pairs gives each pair's distance; a pair with itself is 0
    both = net(torch.tensor(np.stack([img, gt])),
               torch.tensor(np.stack([gt, gt])))
    assert both.shape == (2,)
    assert float(both[0]) == pytest.approx(got, rel=1e-6)
    assert float(both[1]) == 0.0
    # float64 module: the same distance within float32 roundoff
    assert float(net.double()(torch.tensor(img), torch.tensor(gt))) == (
        pytest.approx(got, rel=1e-4))


def test_lpips_fn_gated_on_the_weight_file(tmp_path, monkeypatch):
    monkeypatch.setenv("LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    assert tlpips.load_weights() is None
    assert tmetrics.lpips_fn() is None
    broken = write_weights(tmp_path / "broken.npz", drop="lin3")
    monkeypatch.setenv("LPIPS_WEIGHTS", broken)
    with pytest.raises(ValueError, match="lin3"):
        tlpips.load_weights()
    assert tmetrics.lpips_fn() is None
    monkeypatch.delenv("LPIPS_WEIGHTS")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert tlpips.default_weight_path() == str(
        tmp_path / ".cache" / "litegs_tpu" / "lpips_vgg.npz")
    assert tmetrics.lpips_fn() is None


def test_score_split_lpips_matches_jax(weights_env):
    """tests/test_torch_render.py's scoring case with weights present."""
    cam, frames, jparams = drive_scene()
    jpp = jcfg.PipelineParams(raster_backend="jnp")
    blank = np.zeros((4, 3, 64, 96), np.float32)
    prep_j, act_j, caps = jeval.prepare_model(jparams, jpp, entry_margin=4.0)
    gt = np.stack([img for _, img in jeval.render_views(
        prep_j, act_j, jtrainer.camera_batch_from_frames(cam, frames, blank),
        jpp, caps, 2)])
    rng = np.random.default_rng(4)
    pert = jparams._replace(sh_0=jparams.sh_0 + jnp.asarray(
        rng.normal(0.0, 0.2, jparams.sh_0.shape).astype(np.float32)))
    prep_j, act_j, caps = jeval.prepare_model(pert, jpp, entry_margin=4.0)
    want = jeval.score_split(prep_j, act_j, jtrainer.camera_batch_from_frames(
        cam, frames, gt), jpp, caps, 2)
    prep_t, act_t = teval.prepare_model(to_port(pert), tcfg.PipelineParams())
    got = teval.score_split(prep_t, act_t, ttrainer.camera_batch_from_frames(
        cam, frames, gt, device=CPU), tcfg.PipelineParams(), 2)
    assert want["lpips"] is not None and want["lpips"] > 0
    assert got["lpips"] == pytest.approx(want["lpips"], rel=2e-4), (got, want)
