"""The port's trajectory entry point against the JAX package, on CPU.

Host preprocessing (PCHIP, rasterisation, image sizing, the brush split,
the sparse-flow canvas) must equal mofa_tpu's exactly, the flow transforms
to 1e-6; CMP at TINY_CMP_CONFIG matches the Flax CMP in fp32 to 1e-4 of
max |flow| on one set of weights carried by `state_dict_from_flax`; the
full-size CMP's names are the reference checkpoint's (mofa_tpu's
`convert_cmp_state_dict` takes them strictly and fills every Flax leaf);
a reference-style `.pth.tar` loads through `load_cmp` with strict=True;
and `traj_app` writes a video on the CPU with `--device cpu --tiny` and
refuses to run without a CUDA device otherwise. The whole chain against
JAX (tracks -> CMP -> TrajPipeline) is in tests/test_torch_traj.py, where
the JAX pipeline is compiled once.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mofa_tpu.models.cmp.model import TINY_CMP_CONFIG as J_TINY_CMP
from mofa_tpu.models.cmp.model import fuser_convert_flow as j_fuser
from mofa_tpu.ops import flow as j_flow
from mofa_tpu.ops.rasterize import rasterize_trajectories as j_rasterize
from mofa_tpu.ops.trajectory import interpolate_trajectory as j_interp
from mofa_tpu.ops.trajectory import pchip_interpolate as j_pchip
from mofa_tpu.preprocess import traj as j_traj

from mofa_tpu_torch.apps import traj_app
from mofa_tpu_torch.apps.loaders import init_random_cmp_, load_cmp
from mofa_tpu_torch.models.cmp.model import CMP, TINY_CMP_CONFIG, CMPConfig, fuser_convert_flow
from mofa_tpu_torch.models.weights import state_dict_from_flax
from mofa_tpu_torch.ops.flow import flow_pyramid, merge_flows, rescale_flow
from mofa_tpu_torch.ops.rasterize import rasterize_trajectories
from mofa_tpu_torch.ops.trajectory import interpolate_trajectory, pchip_interpolate
from mofa_tpu_torch.preprocess import traj as p_traj
from tests.torch_port_util import cmp_template, jax_cmp
from tests.torch_port_util import (flax_apply_without_shape_recheck,  # noqa: F401
                                   one_torch_thread)  # (both autouse)

TRACKS = [[[10.0, 12.0], [30.5, 20.25], [52.0, 18.0], [70.0, 40.0]],
          [[100.0, 40.0], [90.0, 30.0]],
          [[10.0, 12.0], [12.0, 50.0], [5.0, 60.0]],          # same start: sums
          [[64.0, 32.0]]]                                      # one point: skipped


def _tracks(seed, n=5, h=64, w=128):
    rng = np.random.RandomState(seed)
    return [[[float(rng.uniform(0, w - 1)), float(rng.uniform(0, h - 1))]
             for _ in range(rng.randint(2, 6))] for _ in range(n)]


# ---------------------------------------------------------- host code

def test_pchip_and_interpolation_equal_jax():
    rng = np.random.RandomState(0)
    for n in (2, 3, 5, 8):
        x = np.sort(rng.rand(n)) + np.arange(n)
        y = rng.randn(n) * 10
        xq = np.linspace(x[0] - 0.5, x[-1] + 0.5, 40)
        np.testing.assert_array_equal(pchip_interpolate(x, y, xq), j_pchip(x, y, xq))
    for tr in TRACKS + _tracks(1):
        np.testing.assert_array_equal(np.asarray(interpolate_trajectory(tr, 14)),
                                      np.asarray(j_interp(tr, 14)))


def test_rasterize_and_prepare_trajectory_flow_equal_jax():
    pts = np.stack([np.asarray(interpolate_trajectory(tr, 6)) for tr in TRACKS[:3]])
    for got, ref in zip(rasterize_trajectories(pts, 5, 64, 128),
                        j_rasterize(pts, 5, 64, 128)):
        np.testing.assert_array_equal(got, ref)
    for tracks, raster in ((TRACKS, 384), (_tracks(2), 96), ([], 96)):
        for got, ref in zip(p_traj.prepare_trajectory_flow(tracks, 7, 64, 128, raster),
                            j_traj.prepare_trajectory_flow(tracks, 7, 64, 128, raster)):
            assert got.dtype == ref.dtype == np.float32
            np.testing.assert_array_equal(got, ref)


def test_preprocess_image_and_brush_split_equal_jax():
    rng = np.random.RandomState(3)
    for shape in ((100, 150, 3), (300, 217, 3)):
        img = Image.fromarray((rng.rand(*shape) * 255).astype(np.uint8))
        (got, hw), (ref, ref_hw) = (p_traj.preprocess_image(img, 128),
                                    j_traj.preprocess_image(img, 128))
        assert hw == ref_hw
        np.testing.assert_array_equal(got, ref)
    brush = np.zeros((64, 128), np.float32)
    brush[:, :64] = 255.0
    pts = np.stack([np.asarray(interpolate_trajectory(tr, 5)) for tr in _tracks(4)])
    for got, ref in zip(p_traj.divide_points_afterinterpolate(pts, brush),
                        j_traj.divide_points_afterinterpolate(pts, brush)):
        np.testing.assert_array_equal(got, ref)


def test_brush_nearest_resize_equals_pil():
    rng = np.random.RandomState(5)
    for h, w in ((64, 128), (70, 130), (600, 400), (384, 384), (256, 384)):
        mask = ((rng.rand(h, w) > 0.5) * 255).astype(np.uint8)
        pil = np.asarray(Image.fromarray(mask).resize((384, 384), Image.NEAREST))
        np.testing.assert_array_equal(traj_app.nearest_resize(mask, 384), pil)


def test_flow_ops_match_jax():
    rng = np.random.RandomState(6)
    flow = (rng.randn(2, 3, 48, 64, 2) * 4).astype(np.float32)
    t, j = torch.from_numpy(flow), jnp.asarray(flow)
    close = lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                                    rtol=0, atol=1e-6)
    close(rescale_flow(t, 128, 96), j_flow.rescale_flow(j, 128, 96))
    close(rescale_flow(t, 48, 64), j_flow.rescale_flow(j, 48, 64))
    pyr, j_pyr = flow_pyramid(t, (8, 16)), j_flow.flow_pyramid(j, (8, 16))
    for s in (8, 16):
        close(pyr[s], j_pyr[s])
    inside = flow.copy()
    inside[:, :, :, :20] = 0.0
    inside[:, :, :5, :, 1] = 0.0                   # one component zero
    outside = -flow
    close(merge_flows(torch.from_numpy(inside), torch.from_numpy(outside)),
          j_flow.merge_flows(jnp.asarray(inside), jnp.asarray(outside)))


# ---------------------------------------------------------------- CMP

def _random_flax_cmp(cfg, seed):
    """A Flax CMP param tree with seeded random values: kernels N(0,
    1/fan_in), biases N(0, 0.02^2), BatchNorm scales 1 + N(0, 0.05^2), means
    N(0, 0.1^2), variances U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.05 * rng.randn(*leaf.shape)
        elif name == "mean":
            v = 0.1 * rng.randn(*leaf.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            v = 0.02 * rng.randn(*leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, cmp_template(cfg))


def test_tiny_cmp_matches_flax():
    from mofa_tpu.models.cmp.model import CMP as JCMP
    params = _random_flax_cmp(J_TINY_CMP, seed=7)
    port = CMP(TINY_CMP_CONFIG).eval()
    port.load_state_dict(state_dict_from_flax(params, "cmp"), strict=True)
    rng = np.random.RandomState(8)
    image = (rng.rand(2, 64, 96, 3) * 2 - 1).astype(np.float32)
    sparse = (rng.randn(2, 64, 96, 2) * 5).astype(np.float32)
    mask = (rng.rand(2, 64, 96, 2) > 0.9).astype(np.float32)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (image, sparse, mask))).numpy()
    ref = np.asarray(jax.jit(JCMP(J_TINY_CMP).apply)(params, image, sparse, mask))
    assert got.shape == ref.shape == (2, 64, 96, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    logits = rng.randn(3, 5, 7, 2 * 99).astype(np.float32) * 3
    np.testing.assert_allclose(fuser_convert_flow(torch.from_numpy(logits), 99, 50.0).numpy(),
                               np.asarray(j_fuser(jnp.asarray(logits), 99, 50.0)),
                               rtol=0, atol=1e-4)


def test_full_cmp_names_are_the_reference_checkpoints():
    """Every name of the port's full-size CMP lands strictly in mofa_tpu's
    CMP tree, every Flax leaf is filled, and the way back gives the same
    state dict: the port's names are the ones convert_cmp_state_dict
    accepts, i.e. the reference checkpoint's."""
    port = CMP(CMPConfig())
    sd = {k: v for k, v in port.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    _, params = jax_cmp(CMPConfig(), port)
    leaves = jax.tree_util.tree_leaves(params)
    assert len(leaves) == len(sd)
    back = state_dict_from_flax(params, "cmp")
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v.float()), k


def test_load_cmp_reads_a_reference_checkpoint(tmp_path):
    src = init_random_cmp_(CMP(TINY_CMP_CONFIG), torch.Generator().manual_seed(9))
    ckpt = {"step": 42000, "state_dict": {f"module.{k}": v for k, v in
                                          src.state_dict().items()}}
    path = tmp_path / "ckpt_iter_42000.pth.tar"
    torch.save(ckpt, path)
    got = load_cmp(str(path), "cpu", cfg=TINY_CMP_CONFIG)
    ref = src.state_dict()
    for k, v in got.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, ref[k]), k
    ckpt["state_dict"]["module.flow_decoder.extra.weight"] = torch.zeros(1)
    torch.save(ckpt, path)
    with pytest.raises(RuntimeError):                # strict: unknown key
        load_cmp(str(path), "cpu", cfg=TINY_CMP_CONFIG)


# ---------------------------------------------------------------- app

@pytest.fixture
def app_inputs(tmp_path):
    rng = np.random.RandomState(10)
    Image.fromarray((rng.rand(70, 140, 3) * 255).astype(np.uint8)).save(tmp_path / "in.png")
    brush = np.zeros((64, 128), np.uint8)
    brush[:, :64] = 255
    Image.fromarray(brush).save(tmp_path / "brush.png")
    spec = {"tracks": TRACKS[:2], "motion_brush": str(tmp_path / "brush.png")}
    (tmp_path / "tracks.json").write_text(json.dumps(spec))
    return tmp_path


def test_traj_app_writes_a_video_on_the_cpu(app_inputs):
    out = app_inputs / "out.gif"
    traj_app.main(["--image", str(app_inputs / "in.png"), "--tracks",
                   str(app_inputs / "tracks.json"), "--output", str(out),
                   "--tiny", "--device", "cpu", "--num_frames", "3",
                   "--num_inference_steps", "1", "--target_size", "64",
                   "--timings", "--trace_dir", str(app_inputs / "trace")])
    with Image.open(out) as gif:
        assert gif.size == (128, 64) and gif.n_frames == 3
    assert list((app_inputs / "trace").glob("trace_*.json"))


def test_traj_app_refuses_to_run_without_cuda(app_inputs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        traj_app.main(["--image", str(app_inputs / "in.png"), "--tracks",
                       str(app_inputs / "tracks.json"), "--tiny"])
