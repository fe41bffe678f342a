"""Frame-parallel inference of the port on gloo (core/mesh.py,
parallel/activation.py and the models, pipelines and apps that use them).

The ranks are this file run as a script, once per world size (2 and 4):
each joins a gloo group through a FileStore under the test's tmp dir,
runs every scenario of its world and saves its results to an .npz that
the tests read. Meanwhile this process compiles the JAX package's unsharded
UNet once per quirk mode (never on a JAX mesh); the world-1 rank also
computes the port's outputs without a mesh. Inputs come from numpy
seeds; the bundles from `init_random_` with seeded generators, so every
process builds the same weights.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (1, 2, 4)
# the UNet case: B*T = 14 rows (4/4/3/3 at 4 ranks); tokens 192/48/12/3
# (the last split 2/1 at 2 ranks, gathered whole at 4)
B, T, LH, LW = 2, 7, 8, 24
TS = 15.3
HYB_T, HYB_HW = 4, 64           # the hybrid case: 1 x 4 frames at 64^2
KP_T, KP_W, KP_S = 8, 4, 2      # the keypoint case: windows of 4, stride 2
TOL = 2e-5                      # of the reference's largest magnitude


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def micro_unet(quirk: bool):
    from mofa_tpu_torch.models.svd_unet import (
        MICRO_UNET_CONFIG, UNetSpatioTemporalConditionModel)
    from mofa_tpu_torch.pipelines.common import init_random_
    cfg = dataclasses.replace(MICRO_UNET_CONFIG,
                              time_context_hw_major_quirk=quirk)
    unet = UNetSpatioTemporalConditionModel(cfg)
    return init_random_(unet, torch.Generator().manual_seed(3)).eval()


def unet_inputs():
    rng = np.random.RandomState(0)
    return (rng.randn(B, T, LH, LW, 8).astype(np.float32),
            rng.randn(B, 1, 32).astype(np.float32),
            np.tile(np.array([[6.0, 128.0, 0.02]], np.float32), (B, 1)))


def tiny_bundle(seed: int, **kw):
    from mofa_tpu_torch.models.clip_vision import TINY_CLIP_CONFIG
    from mofa_tpu_torch.models.svd_unet import MICRO_UNET_CONFIG
    from mofa_tpu_torch.models.vae import TINY_VAE_CONFIG
    from mofa_tpu_torch.pipelines.common import ModelBundle
    bundle = ModelBundle.init_random(
        "cpu", torch.Generator().manual_seed(seed), MICRO_UNET_CONFIG,
        TINY_VAE_CONFIG, TINY_CLIP_CONFIG, **kw)
    if bundle.controlnet2 is not None:
        # the drag adapter perturbed, so the mask blend mixes different
        # residuals (tests/test_frame_parallel.py:114-119)
        g = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for p in bundle.controlnet2.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=g))
    return bundle


def digest(bundle) -> str:
    h = hashlib.sha256()
    for name, module in bundle.modules().items():
        for k, v in module.state_dict().items():
            h.update(f"{name}.{k}".encode())
            h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


def run_unet(mesh=None) -> dict:
    from mofa_tpu_torch.pipelines.common import frame_parallel_or_none
    x, ehs, ids = map(_t, unet_inputs())
    out = {}
    for quirk in (True, False):
        unet = micro_unet(quirk)
        with torch.no_grad(), frame_parallel_or_none(mesh):
            out[f"unet_{quirk}"] = unet(x, TS, ehs, ids).numpy()
    return out


def hybrid_inputs():
    rng = np.random.RandomState(3)
    t, hw = HYB_T, HYB_HW
    return dict(image01=rng.rand(1, hw, hw, 3), controlnet_flow=rng.randn(1, t - 1, hw, hw, 2),
                drag_flow=rng.randn(1, t - 1, hw, hw, 2), landmarks=rng.rand(1, t, hw, hw, 3),
                face_mask=(rng.rand(1, hw, hw, 1) > 0.5), latents=rng.randn(1, t, hw // 8, hw // 8, 4))


def run_hybrid(mesh=None) -> np.ndarray:
    from mofa_tpu_torch.pipelines.hybrid import HybridPipeline
    kw = {k: _t(np.asarray(v, np.float32)) for k, v in hybrid_inputs().items()}
    bundle = tiny_bundle(7, ldmk=True, dual=True)
    got, _ = HybridPipeline(bundle, mesh=mesh)(
        num_inference_steps=2, noise_aug_strength=0.0, output_type="latent", **kw)
    return got.numpy()


def keypoint_inputs():
    rng = np.random.RandomState(5)
    hw = 64
    return dict(image01=rng.rand(1, hw, hw, 3), controlnet_flow=rng.randn(1, KP_T - 1, hw, hw, 2),
                landmarks=rng.rand(1, KP_T, hw, hw, 3), latents=rng.randn(1, KP_T, hw // 8, hw // 8, 4))


def run_keypoint(mesh=None) -> np.ndarray:
    from mofa_tpu_torch.pipelines.keypoint import KeypointPipeline
    kw = {k: _t(np.asarray(v, np.float32)) for k, v in keypoint_inputs().items()}
    bundle = tiny_bundle(11, ldmk=True)
    got, _ = KeypointPipeline(bundle, mesh=mesh)(
        window_size=KP_W, stride=KP_S, num_inference_steps=2,
        noise_aug_strength=0.0, output_type="latent", window_batch=2, **kw)
    return got.numpy()


def run_decode(mesh=None) -> np.ndarray:
    from mofa_tpu_torch.pipelines.common import decode_latents
    bundle = tiny_bundle(1)
    # 7 frames in chunks of 2: 3 whole chunks dealt, a remainder of 1
    lat = np.random.RandomState(1).randn(1, 7, 8, 8, 4).astype(np.float32)
    with torch.no_grad():
        return decode_latents(bundle, _t(lat), 2, mesh=mesh).numpy()


def write_cli_inputs(d: Path) -> None:
    import cv2
    img = np.random.RandomState(0).rand(64, 64, 3) * 255
    cv2.imwrite(str(d / "in.png"), img.astype(np.uint8))
    (d / "tracks.json").write_text(
        '{"tracks": [[[10, 10], [20, 25], [30, 30]], [[40, 40], [35, 30]]]}')


def cli_args(d: Path, out: str) -> list:
    return ["--image", str(d / "in.png"), "--tracks", str(d / "tracks.json"),
            "--device", "cpu", "--tiny", "--num_frames", "3",
            "--num_inference_steps", "1", "--target_size", "64",
            "--output", out]


def worker(world: int, rank: int, out_dir: str) -> None:
    """One rank: every scenario of its world, results to an .npz."""
    t0 = time.perf_counter()
    torch.set_num_threads(1)
    from mofa_tpu_torch.apps import traj_app
    from mofa_tpu_torch.apps.loaders import share_bundle, start_frame_parallel
    from mofa_tpu_torch.core.mesh import AXES
    _, mesh = start_frame_parallel("cpu")
    res = {"coords": np.array([mesh[a].get_local_rank() for a in AXES.names])}
    # each rank seeds its own weights; the broadcast gives all rank 0's
    res["digest"] = np.array(digest(share_bundle(tiny_bundle(100 + rank), mesh)))
    res.update(run_unet(mesh))
    res["decode"] = run_decode(mesh)
    if world <= 2:
        res["hybrid"] = run_hybrid(mesh)
        res["keypoint"] = run_keypoint(mesh)
        cli_dir = Path(out_dir) / f"cli_{world}"
        cli_dir.mkdir(exist_ok=True)
        traj_app.main(cli_args(Path(out_dir), str(cli_dir / "video.npy"))
                      + ["--frame_parallel"])
    if world == 1:
        # the references without a mesh, here beside the pytest process's
        # JAX compiles rather than after them
        res.update(ref_decode=run_decode(), ref_hybrid=run_hybrid(),
                   ref_keypoint=run_keypoint(),
                   ref_digest=np.array(digest(tiny_bundle(100))))
    np.savez(Path(out_dir) / f"w{world}_r{rank}.npz", **res)
    print(f"rank {rank} of {world}: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    sys.exit(0)

import jax  # noqa: E402
import pytest  # noqa: E402

from mofa_tpu.core.mesh import make_mesh as jax_make_mesh  # noqa: E402
from mofa_tpu.models.svd_unet import MICRO_UNET_CONFIG as J_MICRO  # noqa: E402
from mofa_tpu.models.svd_unet import \
    UNetSpatioTemporalConditionModel as JUNet  # noqa: E402
from mofa_tpu.models.weights import convert_torch_state_dict  # noqa: E402

from mofa_tpu_torch.core import mesh as tmesh  # noqa: E402
from mofa_tpu_torch.kernels.short_attention import \
    short_attention_applicable  # noqa: E402
from tests.torch_port_util import (_tree, jit_fast, sd_np,  # noqa: E402
                                   flax_apply_without_shape_recheck,  # noqa: F401
                                   one_torch_thread)  # noqa: F401


def _close(got, ref, tol=TOL, ulps_of=0.0):
    """|got - ref| <= tol x max|ref|, plus 8 ulps of `ulps_of`."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(
        got, ref, rtol=0,
        atol=tol * scale + 8 * float(np.spacing(np.float32(ulps_of))))


def _latents_close(got, ref, latents, tol=TOL):
    """The denoise bar of tests/test_torch_keypoint.py: the Euler steps form
    x0 as a difference of numbers near sigma_0 * max|latents|, so an ulp
    of the model's output moves it by ulps of that product."""
    from mofa_tpu_torch.ops.euler import make_euler_schedule
    sigma0 = float(make_euler_schedule(2).init_noise_sigma)
    _close(got, ref, tol, ulps_of=sigma0 * np.abs(latents).max())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start every rank of both worlds; the returned function waits for
    them and loads rank r of world n's results."""
    out = tmp_path_factory.mktemp("frame_parallel")
    write_cli_inputs(out)
    procs = []
    for world in WORLDS:
        store = out / f"store_{world}"
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                       MOFA_INIT_METHOD=f"file://{store}",
                       PYTHONPATH=str(ROOT))
            log = open(out / f"w{world}_r{rank}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, __file__, str(world), str(rank), str(out)],
                cwd=out, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    done = {}

    def result(world, rank):
        if not done:
            for p, log in procs:
                p.wait(timeout=300)
                log.close()
            bad = [(p.args[2:4], p.returncode) for p, _ in procs if p.returncode]
            done["ok"] = not bad
            if bad:
                logs = "\n".join((out / f"w{w}_r{r}.log").read_text()[-3000:]
                                 for (w, r), _ in bad)
                raise AssertionError(f"ranks failed: {bad}\n{logs}")
        assert done["ok"], "a rank failed (see the first failure)"
        return np.load(out / f"w{world}_r{rank}.npz")

    result.dir = out
    yield result
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


@pytest.fixture(scope="module")
def references(ranks):
    """The JAX UNet (one compile per quirk mode), compiled here while the
    ranks run; the port's decode and denoises without a mesh and the
    digest of rank 0's seeded bundle, from the world-1 rank."""
    x, ehs, ids = unet_inputs()
    params = convert_torch_state_dict(_tree("unet", J_MICRO),
                                      sd_np(micro_unet(True)))

    def jax_out(quirk):
        jm = JUNet(dataclasses.replace(J_MICRO,
                                       time_context_hw_major_quirk=quirk))
        return np.asarray(jit_fast(
            lambda p, s, e, i: jm.apply(p, s, TS, e, i))(params, x, ehs, ids))

    # one mode's trace overlaps the other's compile
    with ThreadPoolExecutor(2) as pool:
        ref = {f"jax_{q}": out for q, out in
               zip((True, False), pool.map(jax_out, (True, False)))}
    one = ranks(1, 0)
    ref.update({k: one[f"ref_{k}"] for k in ("decode", "hybrid", "keypoint")})
    ref["digest"] = str(one["ref_digest"])
    return ref


@pytest.mark.parametrize("shape", [(1, 1, 1, 8), (1, 2, 1, 4), (2, 2, 2, 1)])
def test_rank_layout_matches_jax_mesh(shape):
    """Rank r sits where JAX device r sits in mofa_tpu's mesh; frames=-1
    takes the rest; a mismatched product raises."""
    dcn, data, model, frames = shape
    jm = jax_make_mesh(data=data, frames=frames, model=model, dcn=dcn)
    assert jm.axis_names == tmesh.AXES.names
    pos = {d.id: i for i, d in enumerate(jax.devices())}
    np.testing.assert_array_equal(
        np.vectorize(lambda d: pos[d.id])(jm.devices),
        tmesh.rank_layout(8, data, frames, model, dcn))
    np.testing.assert_array_equal(tmesh.rank_layout(8, data, -1, model, dcn),
                                  tmesh.rank_layout(8, data, frames, model, dcn))
    assert tmesh.AXES.batch == ("dcn", "data")
    with pytest.raises(ValueError, match=r"mesh 2x3x1x1 != 8"):
        tmesh.rank_layout(8, data=3, frames=1, dcn=2)


def test_shards_are_as_even_as_the_size_allows():
    assert tmesh.split_sizes(50, 4) == [13, 13, 12, 12]
    assert tmesh.shard_range(50, 4, 2) == (26, 38)
    with pytest.raises(ValueError):
        tmesh.split_sizes(3, 4)
    # the classic short kernel's gate takes every /8 site's share at
    # n = 1, 2, 4 (2 x 9216 tokens, H = 5) down to /64's 2 x 144 / n rows
    for n in (1, 2, 4):
        for tokens in (9216, 144):
            assert short_attention_applicable(2 * tokens // n, 25, 25, 5, 64)


class _Axis:
    def __init__(self, size, rank):
        self._size, self._rank = size, rank

    def size(self):
        return self._size

    def get_local_rank(self):
        return self._rank


def test_rank_slices_of_a_batch():
    """frame_sharded / data_sharded / replicated: the part of a [B, T, ...]
    tensor a rank holds, at the mesh coordinates of rank 3 of (1, 2, 1, 2)
    (data 1, frames 1); uneven sizes give the first ranks one more."""
    mesh = {"dcn": _Axis(1, 0), "data": _Axis(2, 1), "model": _Axis(1, 0),
            "frames": _Axis(2, 1)}
    x = torch.arange(5 * 7).reshape(5, 7)
    assert torch.equal(tmesh.replicated(mesh, x), x)
    assert torch.equal(tmesh.data_sharded(mesh, x), x[3:])
    assert torch.equal(tmesh.frame_sharded(mesh, x), x[3:, 4:])


@pytest.mark.parametrize("world", WORLDS)
def test_unet_frame_parallel_matches_world_one_and_jax(ranks, references, world):
    """The micro UNet in frame_parallel on gloo, quirk on and off, every
    rank's gathered output: within the unsharded port's bound (1e-4) of
    the JAX UNet, and within 2e-5 of the port's world-1 output. The
    sharded decode within 2e-5 of the decode without a mesh; every rank
    holds rank 0's weights byte for byte."""
    one = ranks(1, 0)
    for rank in range(world):
        got = ranks(world, rank)
        np.testing.assert_array_equal(
            got["coords"], np.unravel_index(rank, (1, 1, 1, world)))
        for quirk in (True, False):
            _close(got[f"unet_{quirk}"], references[f"jax_{quirk}"], tol=1e-4)
            _close(got[f"unet_{quirk}"], one[f"unet_{quirk}"])
        _close(got["decode"], references["decode"])
        assert str(got["digest"]) == references["digest"]


@pytest.mark.parametrize("case", ["hybrid", "keypoint"])
def test_denoise_frame_parallel_matches_world_one(ranks, references, case):
    """The hybrid dual-adapter denoise (2 steps) and the keypoint
    window_batch=2 denoise: at world 2, on both ranks (the latents are
    replicated), within 2e-5 of world 1; world 1 within the JAX suite's
    frame-parallel bound (2e-4, tests/test_frame_parallel.py) of the
    pipeline without a mesh, which runs the tmajor layout. Each bar adds
    the Euler step's own rounding (`_latents_close`)."""
    lat = (hybrid_inputs if case == "hybrid" else keypoint_inputs)()["latents"]
    one = ranks(1, 0)[case]
    _latents_close(one, references[case], lat, tol=2e-4)
    for rank in range(2):
        _latents_close(ranks(2, rank)[case], one, lat)


def test_traj_app_frame_parallel_writes_once(ranks):
    """traj_app --frame_parallel under 2 gloo ranks writes one video, from
    rank 0, within one uint8 level of the world-1 video; rank 1 writes and
    prints nothing."""
    ranks(2, 0)
    two, one = ranks.dir / "cli_2", ranks.dir / "cli_1"
    assert [p.name for p in two.iterdir()] == ["video.npy"]   # rank 0's
    assert "wrote" in (ranks.dir / "w2_r0.log").read_text()
    rank1 = (ranks.dir / "w2_r1.log").read_text()
    assert "wrote" not in rank1 and "[loaders]" not in rank1
    got, want = np.load(two / "video.npy"), np.load(one / "video.npy")
    assert got.shape == want.shape == (3, 64, 64, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_token_policy_raises_and_no_route_around():
    """policy="tokens" raises naming its ROADMAP item; the port has no
    `is_sharded_execution` switch sending a rank's rows to a plain version."""
    from mofa_tpu_torch.parallel.activation import frame_parallel
    with pytest.raises(ValueError, match="13c"):
        with frame_parallel(object(), policy="tokens"):
            pass
    route = re.compile(r"def (is_)?sharded_execution|sharded_execution\(")
    assert not any(route.search(p.read_text())
                   for p in (ROOT / "mofa_tpu_torch").rglob("*.py"))
