"""The port's FILM interpolator (mofa_tpu_torch/models/film.py) against mofa_tpu's, on the CPU.

The weights come from the JAX side: the Flax tree of `FilmNet.init`
(traced, not run) filled from a seeded numpy RNG and carried into the port
by `film_state_dict_from_jax` (strict load). At
TINY_FILM_CONFIG, 16^2, fp32, within 1e-4 of max(1, max |JAX|):

- `FilmNet` at a per-sample dt, and at a scalar dt (one JAX compile);
- `warp`, with flows reaching past every edge;
- `interpolate_frames` with one numpy `predict` against the JAX loop,
  for inter_frames 1 and 3: the same calls in the same order, the same
  frames (no JAX compile).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mofa_tpu.models import film as JF

from mofa_tpu_torch.models import film as PF
from tests.torch_port_util import (flax_apply_without_shape_recheck,  # noqa: F401
                                   jit_fast, one_torch_thread, template)

CFG = PF.TINY_FILM_CONFIG
S = 16
TOL = 1e-4


def _close(got, want, msg=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=TOL * scale, err_msg=msg)


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def nets():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JF.TINY_FILM_CONFIG)
    rng = np.random.RandomState(0)
    x0 = rng.rand(2, S, S, 3).astype(np.float32)
    x1 = np.clip(x0 + 0.2 * rng.randn(2, S, S, 3), 0, 1).astype(np.float32)
    jnet = JF.FilmNet(JF.TINY_FILM_CONFIG)
    tree = template(lambda: jnet.init(jax.random.PRNGKey(1), x0, x1, np.ones(2, np.float32)))
    params = jax.tree_util.tree_map(
        lambda z: (rng.randn(*z.shape) * (np.prod(z.shape[:-1]) ** -0.5 if z.ndim > 1
                                          else 0.05)).astype(np.float32), tree)
    port = PF.FilmNet(CFG).eval()
    port.load_state_dict(PF.film_state_dict_from_jax(params), strict=True)
    apply = jit_fast(lambda a, b, dt: jnet.apply(params, a, b, dt))
    return port, apply, x0, x1


def test_filmnet_matches_jax(nets):
    port, apply, x0, x1 = nets
    dt = np.array([0.25, 0.7], np.float32)
    with torch.no_grad():
        got = port(nchw(x0), nchw(x1), torch.from_numpy(dt))
        scalar = port(nchw(x0), nchw(x1), 0.25)
    assert got.shape == (2, 3, S, S)
    _close(got.permute(0, 2, 3, 1).numpy(), apply(x0, x1, dt), "FilmNet")
    _close(scalar.permute(0, 2, 3, 1).numpy(), apply(x0, x1, np.full(2, 0.25, np.float32)),
           "scalar dt")
    torch.testing.assert_close(scalar[0], got[0], rtol=0, atol=0)


def test_warp_matches_jax_past_the_edges():
    rng = np.random.RandomState(2)
    img = rng.rand(2, 6, 9, 5).astype(np.float32)
    flow = (rng.randn(2, 6, 9, 2) * 6).astype(np.float32)
    flow[0, 0, 0] = (-40.0, -40.0)
    flow[1, -1, -1] = (40.0, 40.0)
    want = jit_fast(JF.warp)(img, flow)
    got = PF.warp(nchw(img), nchw(flow)).permute(0, 2, 3, 1).numpy()
    _close(got, want, "warp")
    zero = PF.warp(nchw(img), torch.zeros(2, 2, 6, 9))
    torch.testing.assert_close(zero, nchw(img), rtol=0, atol=0)


@pytest.mark.parametrize("inter", [1, 3])
def test_interpolate_frames_matches_jax_loop(inter):
    rng = np.random.RandomState(3)
    frames = rng.rand(4, 5, 6, 3).astype(np.float32)
    calls = {"jax": [], "port": []}

    def predict(tag):
        def fn(x0, x1, dt):
            calls[tag].append((x0.copy(), x1.copy(), dt))
            return x0 * (1 - dt) + x1 * dt + 0.3 * np.sin(7 * x0)
        return fn

    want = JF.interpolate_frames(frames, inter, predict("jax"))
    got = PF.interpolate_frames(frames, inter, predict("port"))
    assert got.shape == (4 + 3 * inter, 5, 6, 3)
    np.testing.assert_array_equal(got, want)
    assert len(calls["port"]) == len(calls["jax"]) == 3 * inter
    for (a0, a1, adt), (b0, b1, bdt) in zip(calls["port"], calls["jax"]):
        assert adt == bdt
        np.testing.assert_array_equal(a0, b0)
        np.testing.assert_array_equal(a1, b1)
