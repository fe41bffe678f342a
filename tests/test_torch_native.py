"""The port's native host library (mofa_tpu_torch/native.py) against its numpy versions, on the CPU.

The library is built here with g++ (into the repository's build/), and
each entry point is held bit-equal to its numpy version, called
directly: `rasterize_tracks` (6 tracks over 24 steps, as on the main
path) against `ops/rasterize.py::rasterize_trajectories`, `square_nms`
against `train/flow_sampler.py::square_nms`, `neighbor_elim` with the
same coins against `native.neighbor_elim_numpy`, `pchip_derivatives`
against `ops/trajectory.py::_pchip_derivatives`.
Each numpy version in turn equals mofa_tpu.native's numpy fallback. A
build that fails is reported with the compiler's message and every entry
point raises; malformed inputs are refused before any pointer is passed.
"""

import numpy as np
import pytest

from mofa_tpu import native as jnative

from mofa_tpu_torch import native
from mofa_tpu_torch.ops.rasterize import rasterize_trajectories
from mofa_tpu_torch.ops.trajectory import _pchip_derivatives
from mofa_tpu_torch.train.flow_sampler import square_nms as square_nms_numpy
from tests.torch_port_util import one_torch_thread  # noqa: F401

H, W = 72, 128      # the canvas (the main path's 576x1024 runs on the card)


@pytest.fixture
def jax_fallback(monkeypatch):
    """mofa_tpu.native's numpy path (its library marked as never built)."""
    monkeypatch.setattr(jnative, "_TRIED", True)
    monkeypatch.setattr(jnative, "_LIB", None)


def _inputs(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    tracks = rng.rand(6, 25, 2) * (W - 1.0, H - 1.0)
    tracks[0, 1:] = tracks[0, 0] + rng.randn(24, 2) * 9   # some negative steps
    x = np.cumsum(rng.rand(12) + 0.05)
    y = rng.randn(12)
    y[4:7] = y[3]                                           # flat run, sign changes
    return dict(tracks=tracks, score=rng.rand(96, 80).astype(np.float32),
                rows=rng.randint(0, 60, 48), cols=rng.randint(0, 60, 48),
                coins=rng.rand(48 * 48).astype(np.float32), x=x, y=y)


def _call_all(a: dict) -> dict:
    flow, mask = native.rasterize_tracks(a["tracks"], 24, H, W)
    bflow, _ = native.rasterize_tracks(a["tracks"], 24, H, W, is_backward_flow=True)
    return dict(flow=flow, mask=mask, bflow=bflow,
                nms=native.square_nms(a["score"], 15),
                elim=np.stack(native.neighbor_elim(a["rows"], a["cols"], 7.0, a["coins"])),
                pchip=native.pchip_derivatives(a["x"], a["y"]),
                pchip2=native.pchip_derivatives(a["x"][:2], a["y"][:2]))


def _call_numpy(a: dict) -> dict:
    """The numpy versions of `_call_all`'s calls."""
    flow, mask = rasterize_trajectories(a["tracks"], 24, H, W)
    bflow, _ = rasterize_trajectories(a["tracks"], 24, H, W, is_backward_flow=True)
    keep = native.neighbor_elim_numpy(a["rows"], a["cols"], 7.0, a["coins"])
    return dict(flow=flow, mask=mask, bflow=bflow,
                nms=square_nms_numpy(a["score"], 15),
                elim=np.stack([a["rows"][keep], a["cols"][keep]]),
                pchip=_pchip_derivatives(a["x"], a["y"]),
                pchip2=_pchip_derivatives(a["x"][:2], a["y"][:2]))


def test_library_builds_and_loads():
    assert native.available(), native.build_error()
    assert native.build_error() is None
    assert native.library_path().exists()
    assert native.library_path().parent.name == "build"


@pytest.mark.parametrize("seed", [0, 1])
def test_native_equals_numpy_bit_for_bit(seed):
    a = _inputs(seed)
    got = _call_all(a)
    want = _call_numpy(a)
    assert got["mask"].sum() == 6 * 24 and np.abs(got["flow"]).sum() > 0
    assert 0 < got["elim"].shape[1] < 48
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_numpy_versions_equal_mofa_tpu_fallback(jax_fallback):
    a = _inputs(2)
    port = _call_numpy(a)
    ref_flow, ref_mask = jnative.rasterize_tracks(a["tracks"], 24, H, W)
    np.testing.assert_array_equal(port["flow"], ref_flow)
    np.testing.assert_array_equal(port["mask"], ref_mask)
    np.testing.assert_array_equal(port["nms"], jnative.square_nms(a["score"], 15))
    np.testing.assert_array_equal(
        port["elim"], np.stack(jnative.neighbor_elim(a["rows"], a["cols"], 7.0, a["coins"])))
    np.testing.assert_array_equal(port["pchip"], jnative.pchip_derivatives(a["x"], a["y"]))


def test_failed_build_is_reported(tmp_path, monkeypatch):
    bad = tmp_path / "mofa_host.cpp"
    bad.write_text('extern "C" { void square_nms( }\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert not native.available()
    msg = native.build_error()
    assert msg and "g++" in msg and "error" in msg
    with pytest.raises(native.NativeLibraryError, match="error"):
        native.square_nms(np.zeros((4, 4), np.float32), 3)
    with pytest.raises(native.NativeLibraryError):
        native.pchip_derivatives(np.arange(3.0), np.arange(3.0))
    assert not list((tmp_path / "build").glob("*.so"))


def test_malformed_inputs_refused():
    with pytest.raises(ValueError, match="tracks"):
        native.rasterize_tracks(np.zeros((2, 5, 2)), 24, 8, 8)
    with pytest.raises(ValueError, match="odd"):
        native.square_nms(np.zeros((4, 4), np.float32), 4)
    with pytest.raises(ValueError, match="coins"):
        native.neighbor_elim(np.zeros(5), np.zeros(5), 2.0, np.zeros(24, np.float32))
    with pytest.raises(ValueError, match="n >= 2"):
        native.pchip_derivatives(np.zeros(1), np.zeros(1))
