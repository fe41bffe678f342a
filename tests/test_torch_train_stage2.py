"""The port's stage-2 training slice against the JAX package, on the CPU.

- `flow_sampler` (every strategy) and `clip_sample_mask`: the same points
  and the same RandomState draws for one seed;
- `stage2_control_flow` at TINY_CMP_CONFIG against JAX's (fp32, relative
  1e-5), the bf16 CMP within the bound of tests/test_train_inputs.py::
  test_cmp_bf16_dense_flow_bound; `Stage2InputPipeline` equal to the
  sequential path, with and without a flow cache;
- the factored optimizer against `optax.adafactor` inside the JAX
  package's own chain (`make_optimizer(memory_lean=True, ...)`), and the
  weight decay it applies without the learning rate;
- `train_app --stage 2 --tiny --device cpu`, sequential and with
  `--overlap_inputs --use_8bit_adam`: the same first step, checkpoints
  whose resume is bit-exact, the frozen modules unchanged.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mofa_tpu.models.cmp.model import TINY_CMP_CONFIG as J_TINY_CMP
from mofa_tpu.train import flow_sampler as jfs
from mofa_tpu.train.inputs import stage2_control_flow as j_stage2_control_flow
from mofa_tpu.train.state import make_optimizer as j_make_optimizer

from mofa_tpu_torch.apps import train_app
from mofa_tpu_torch.apps.loaders import init_random_cmp_, load_bundle
from mofa_tpu_torch.models.clip_vision import TINY_CLIP_CONFIG
from mofa_tpu_torch.models.cmp.model import CMP, TINY_CMP_CONFIG
from mofa_tpu_torch.models.svd_unet import MICRO_UNET_CONFIG
from mofa_tpu_torch.models.vae import TINY_VAE_CONFIG
from mofa_tpu_torch.train import flow_sampler as fs
from mofa_tpu_torch.train.checkpoint import CheckpointManager
from mofa_tpu_torch.train.flow_cache import TeacherFlowCache
from mofa_tpu_torch.train.inputs import Stage2InputPipeline, stage2_control_flow
from mofa_tpu_torch.train.state import FactoredRMS, TrainState, factored_dims
from tests.torch_port_util import (flax_apply_without_shape_recheck,  # noqa: F401
                                   one_torch_thread)  # (both autouse)
from tests.torch_port_util import jax_cmp, jit_fast
from tests.test_torch_train import _train_args, _write_clips


def _dense_flow(h=96, w=128, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fx = 5 * np.sin(yy / 17.0) + (xx > w // 2) * 8
    fy = 3 * np.cos(xx / 23.0)
    return np.stack([fx, fy], -1) + rng.randn(h, w, 2).astype(np.float32) * 0.1


@pytest.mark.parametrize("strategy", [("grid",), ("uniform",), ("gradnms",),
                                      ("watershed",), ("single",), ("full",),
                                      ("specified",), ("grid", "watershed")])
def test_flow_sampler_matches_jax(strategy):
    """Each strategy (and the stage-2 pair): the sparse flow and mask equal
    JAX's bit for bit, and both RandomStates end in the same state; with
    max_num_guide the same subset is kept."""
    flow = _dense_flow()
    guide = np.asarray([[5, 7], [100, 60], [30, 90]])
    kw = dict(bg_ratio=1 / 400, nms_ks=9, guidepoint=guide)
    for extra in ({}, {"max_num_guide": 5}):
        ra, rb = np.random.RandomState(3), np.random.RandomState(3)
        got = fs.flow_sampler(flow, strategy, rng=ra, **kw, **extra)
        want = jfs.flow_sampler(flow, strategy, rng=rb, **kw, **extra)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert ra.randint(1 << 30) == rb.randint(1 << 30)
    assert got[1].sum() > 0


def test_clip_sample_mask_and_helpers_match_jax():
    """clip_sample_mask over a batch of clips (each clip's last frame,
    broadcast over t), sobel_edge, square_nms and eliminate_neighbors."""
    flows = np.stack([np.stack([_dense_flow(seed=s + t) * (t + 1) for t in range(3)])
                      for s in range(2)])
    got = fs.clip_sample_mask(flows, rng=np.random.RandomState(4))
    want = jfs.clip_sample_mask(flows, rng=np.random.RandomState(4))
    np.testing.assert_array_equal(got, want)
    assert got.shape == flows.shape and (got[:, 0] == got[:, -1]).all()
    flow = _dense_flow()
    np.testing.assert_array_equal(fs.sobel_edge(flow), jfs.sobel_edge(flow))
    score = np.random.RandomState(5).rand(20, 30)
    np.testing.assert_array_equal(fs.square_nms(score, 5), jfs.square_nms(score, 5))
    r, c = np.random.RandomState(6).randint(0, 40, (2, 50))
    a = fs.eliminate_neighbors(r, c, 4, np.random.RandomState(7))
    b = jfs.eliminate_neighbors(r, c, 4, np.random.RandomState(7))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def tiny_cmp():
    cmp = init_random_cmp_(CMP(TINY_CMP_CONFIG), torch.Generator().manual_seed(3)).eval()
    return cmp.requires_grad_(False)


def test_stage2_control_flow_matches_jax(tiny_cmp):
    """One clip of 3 frames at 64x64 (two flows), the tiny CMP: the same
    host mask as JAX's for one seed, the dense flow at the train size
    within 1e-5 of its scale; the bf16 CMP within 0.05 of it (the bound of
    the JAX package's own bf16 test)."""
    rng = np.random.RandomState(8)
    px = rng.rand(1, 3, 64, 64, 3).astype(np.float32)
    flows = np.stack([np.stack([_dense_flow(64, 64, s) * (s + 1) for s in range(2)])])
    jm, jp = jax_cmp(J_TINY_CMP, tiny_cmp)
    want, want_mask = j_stage2_control_flow(jm, jp, px, flows, (48, 48),
                                            rng=np.random.RandomState(9))
    want = np.asarray(want)
    got, mask = stage2_control_flow(tiny_cmp, torch.from_numpy(px), flows, (48, 48),
                                    rng=np.random.RandomState(9))
    np.testing.assert_array_equal(mask, want_mask)
    assert got.shape == want.shape == (1, 2, 48, 48, 2)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
    bf16 = init_random_cmp_(CMP(TINY_CMP_CONFIG), torch.Generator().manual_seed(3))
    bf16 = bf16.to(torch.bfloat16).eval()
    half, _ = stage2_control_flow(bf16, torch.from_numpy(px), flows, (48, 48),
                                  rng=np.random.RandomState(9))
    assert half.dtype == torch.float32 and torch.isfinite(half).all()
    assert np.abs(half.numpy() - want).max() <= 0.05 * (scale + 1e-3)


class _StandInCMP(torch.nn.Module):
    """A cheap stand-in for CMP (image, sparse, mask) -> flow."""

    def __init__(self):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.tensor(1.5), requires_grad=False)

    def forward(self, image, sparse, mask):
        return sparse * self.weight + image[..., :2] * 0.1 + mask


def test_stage2_input_pipeline_equals_sequential(tmp_path):
    """Three clips through Stage2InputPipeline equal the sequential teacher
    -> mask -> CMP path fed the same clips and seed, bit for bit (the
    lookahead reorders work, not draws); with a flow cache, the first pass
    writes every clip and a second pass reads them back (fp16 storage)
    without calling the teacher. Stand-ins for the teacher (flows from the
    frames' differences) and CMP: the pipeline only orders their calls."""
    teacher = lambda px: (px[:, 1:, ..., :2] - px[:, :1, ..., :2]) * 20.0
    tiny_cmp = _StandInCMP()
    rng = np.random.RandomState(10)
    clips = [torch.from_numpy(rng.rand(1, 3, 32, 48, 3).astype(np.float32))
             for _ in range(3)]
    seq_rng = np.random.RandomState(11)
    want = [stage2_control_flow(tiny_cmp, px, teacher(px).numpy(), (32, 48),
                                rng=seq_rng)[0] for px in clips]
    pipe = Stage2InputPipeline(teacher, tiny_cmp, (32, 48), rng=np.random.RandomState(11))
    got = list(pipe.run(iter(clips), lambda b: b["flows"]))
    assert len(got) == 3 and set(pipe.times) == {"mask_s", "cmp_s"}
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    cache = TeacherFlowCache(str(tmp_path / "fc"), "stand-in teacher")
    keyed = [([f"clip:{i}"], px) for i, px in enumerate(clips)]
    pipe = Stage2InputPipeline(teacher, tiny_cmp, (32, 48), rng=np.random.RandomState(11),
                               flow_cache=cache)
    first = list(pipe.run(iter(keyed), lambda b: b["flows"]))
    assert len(cache) == 3
    for a, b in zip(first, want):
        assert torch.equal(a, b)
    calls = []
    pipe = Stage2InputPipeline(lambda px: calls.append(px), tiny_cmp, (32, 48),
                               rng=np.random.RandomState(11), flow_cache=cache)
    again = list(pipe.run(iter(keyed), lambda b: b["flows"]))
    seq_rng = np.random.RandomState(11)
    cached = [stage2_control_flow(tiny_cmp, px, cache.get_batch(k), (32, 48),
                                  rng=seq_rng)[0] for k, px in keyed]
    assert calls == []
    for a, b in zip(again, cached):
        assert torch.equal(a, b)


# ------------------------------------------------ the factored optimizer

class _Tree(torch.nn.Module):
    """Factored and unfactored leaves: a conv kernel (Flax [3, 3, 130, 160]:
    factored over its last two axes), a dense kernel of 140 x 200
    (factored), one of 20 x 300 (20 < 128: a full second moment), 1-D
    biases, and a frozen layer."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(130, 160, 3)
        self.lin = torch.nn.Linear(140, 200)
        self.small = torch.nn.Linear(20, 300)
        self.frozen = torch.nn.Linear(150, 150)


def _flax(named) -> dict:
    """{module: {kernel|bias}} numpy copies, Flax layouts (copies: JAX may
    alias a numpy buffer that torch later writes in place)."""
    out = {}
    for name, t in named:
        mod, leaf = name.split(".")
        v = t.detach().numpy().copy()
        if leaf == "weight":
            v, leaf = (v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T), "kernel"
        out.setdefault(mod, {})[leaf] = v
    return out


def _both(lr, wd, grads_fn, steps):
    """The port's TrainState(memory_lean) and the JAX package's chain over
    `steps` updates of the same gradients; returns (port params, JAX
    params) as Flax trees."""
    rng = np.random.RandomState(12)
    m = _Tree()
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.1))
    params = jax.tree_util.tree_map(jnp.asarray, _flax(m.named_parameters()))
    tx = j_make_optimizer(lr=lr, weight_decay=wd, frozen_patterns=("frozen",),
                          params=params, memory_lean=True)
    opt = tx.init(params)
    update = jit_fast(tx.update)
    state = TrainState(m, lr=lr, weight_decay=wd, frozen_patterns=("frozen",),
                       memory_lean=True)
    assert isinstance(state.optimizer, FactoredRMS)
    for k in range(steps):
        grads = {n: grads_fn(k, p.shape) for n, p in m.named_parameters()}
        for n, p in m.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(grads[n].copy())
        state.apply_gradients()
        g = jax.tree_util.tree_map(jnp.asarray, _flax(
            (n, torch.from_numpy(v)) for n, v in grads.items()))
        upd, opt = update(g, opt, params)
        params = optax.apply_updates(params, upd)
    return _flax(m.named_parameters()), jax.tree_util.tree_map(np.asarray, params), state


def test_factored_optimizer_matches_optax_adafactor():
    """3 updates of gradients growing in scale: every leaf within 1e-6 of
    the JAX chain's (clip_by_global_norm, adafactor, the freeze mask), the
    frozen layer untouched; the factored axes are optax's on the Flax
    layout; the state holds factored moments where optax does."""
    rng = np.random.RandomState(13)
    got, want, state = _both(1e-2, 1e-2, lambda k, s: rng.randn(*s).astype(np.float32)
                             * (k + 1), 3)
    for mod in want:
        for leaf in want[mod]:
            np.testing.assert_allclose(got[mod][leaf], want[mod][leaf], rtol=0, atol=1e-6)
    assert state.optimizer.dims == [(1, 0), None, (1, 0), None, None, None]
    assert factored_dims("conv.weight", (160, 130, 3, 3)) == (1, 0)
    assert factored_dims("x.weight", (300, 20)) is None
    assert state.optimizer.param_groups[0]["count"] == 3


def test_factored_optimizer_weight_decay_is_not_scaled_by_lr():
    """optax's adafactor adds weight_decay * param after the learning rate
    (ROADMAP Queue 3 item 8): with zero gradients one update takes 1e-2 of
    every trainable weight at lr 1e-3, as the JAX chain does, not 1e-5."""
    got, want, _ = _both(1e-3, 1e-2, lambda k, s: np.zeros(s, np.float32), 1)
    before, _, _ = _both(1e-3, 1e-2, lambda k, s: np.zeros(s, np.float32), 0)
    for mod in ("conv", "lin", "small"):
        for leaf in want[mod]:
            np.testing.assert_allclose(got[mod][leaf], want[mod][leaf], rtol=0, atol=1e-7)
            np.testing.assert_allclose(got[mod][leaf], before[mod][leaf] * (1 - 1e-2),
                                       rtol=1e-6)
    np.testing.assert_array_equal(got["frozen"]["kernel"], before["frozen"]["kernel"])


# ------------------------------------------------ the app, stage 2

@pytest.fixture(scope="module")
def stage2_runs(tmp_path_factory):
    """`train_app --stage 2 --tiny --device cpu` for 2 steps: A sequential
    with AdamW; B with --overlap_inputs --use_8bit_adam; B resumed from its
    checkpoint 1."""
    tmp = str(tmp_path_factory.mktemp("stage2"))
    csv_path, folder = _write_clips(tmp, h=64, w=80)
    args = lambda out, *extra: _train_args(tmp, csv_path, folder, os.path.join(tmp, out),
                                           "--stage", "2", *extra)
    a = train_app.run(args("a"))
    b = train_app.run(args("b", "--overlap_inputs", "--use_8bit_adam"))
    resumed = train_app.run(args("b", "--use_8bit_adam", "--overlap_inputs",
                                 "--resume_from_checkpoint", "1"))
    return tmp, a, b, resumed


def test_train_app_stage2_sequential_and_overlapped(stage2_runs):
    """Both runs: finite losses; step 1's loss, gradient norm and control
    flow equal (the same clip, masks and draws; no optimizer step yet), step
    2's apart (AdamW against the factored optimizer); checkpoints 1 and 2
    written; the overlapped run times the host's mask sampling, not the
    teacher."""
    _, a, b, _ = stage2_runs
    for run in (a, b):
        assert [r["step"] for r in run.records] == [1, 2]
        assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in run.records)
        steps = CheckpointManager(os.path.join(run.args.output_dir, "checkpoints"))
        assert steps.all_steps() == [1, 2]
    ra, rb = a.records[0], b.records[0]
    assert (ra["loss"], ra["grad_norm"], ra["control_sums"]) == \
        (rb["loss"], rb["grad_norm"], rb["control_sums"])
    assert a.records[1]["loss"] != b.records[1]["loss"]
    assert ra["teacher_s"] >= 0 and "teacher_s" not in rb and rb["mask_s"] >= 0
    assert isinstance(b.state.optimizer, FactoredRMS)
    assert isinstance(a.state.optimizer, torch.optim.AdamW)


def test_train_app_stage2_frozen_modules_and_resume(stage2_runs):
    """The flow encoder and the conditioning embedding (STAGE2_FROZEN) stay
    at their seeded setup values bit for bit in both runs and are outside
    the optimizer, while the rest of the adapter moves; B resumed from
    checkpoint 1 gives step 2's loss, control flow and final state bit for
    bit, the factored moments and their count restored."""
    _, a, b, resumed = stage2_runs
    init = load_bundle(None, None, device="cpu", seed=3, unet_cfg=MICRO_UNET_CONFIG,
                       vae_cfg=TINY_VAE_CONFIG, clip_cfg=TINY_CLIP_CONFIG).controlnet
    for run in (a, b):
        cn = run.state.model
        for name in ("flow_encoder", "controlnet_cond_embedding"):
            assert train_app.module_digest(getattr(cn, name)) == \
                train_app.module_digest(getattr(init, name))
            assert not any(n.startswith(name) for n in run.state.names)
        assert train_app.module_digest(cn.down_blocks) != \
            train_app.module_digest(init.down_blocks)
    assert [r["step"] for r in resumed.records] == [2]
    assert resumed.records[0]["loss"] == b.records[1]["loss"]
    assert resumed.records[0]["control_sums"] == b.records[1]["control_sums"]
    for x, y in zip(resumed.state.params, b.state.params):
        assert torch.equal(x, y)
    sa, sb = resumed.state.optimizer.state_dict(), b.state.optimizer.state_dict()
    assert sa["param_groups"][0]["count"] == sb["param_groups"][0]["count"] == 2
    for i in sb["state"]:
        for k, v in sb["state"][i].items():
            assert torch.equal(sa["state"][i][k], v)
