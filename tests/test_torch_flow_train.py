"""The port's CMP and GMFlow trainers against the JAX package, on the CPU.

- CMP: `CMP.logits` for each valid encoder / decoder / sparse-encoder
  combination (Flax params carried by mofa_tpu's converter, back by
  `state_dict_from_flax`); every loss, warp and the step schedule; one SGD
  step with the BatchNorm statistics trained as parameters, as the JAX
  step trains them; `cmp_config_from_yaml` (no PyYAML) against the JAX
  reader (PyYAML);
- GMFlow: `flow_loss` and its metrics; AdamW with the one-cycle schedule
  against optax's on the tiny model's gradients, and the schedule where
  optax divides by an empty warmup (ROADMAP Queue 3 item 10);
- the flow datasets: every layout and reader against the JAX package's;
- `train_cmp_app`, `train_flow_app` and `eval_flow_app` with `--tiny
  --device cpu`.

(`return_preds` is held to JAX in tests/test_torch_train.py, on the one
JAX GMFlow forward that file runs.)
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mofa_tpu.models.cmp import train as jtrain
from mofa_tpu.models.cmp.model import CMP as JCMP
from mofa_tpu.models.cmp.model import TINY_CMP_CONFIG as J_TINY_CMP
from mofa_tpu.models.cmp.model import cmp_config_from_yaml as j_cmp_config_from_yaml
from mofa_tpu.models.gmflow.train import flow_loss as j_flow_loss
from mofa_tpu.models.weights import convert_cmp_state_dict
from mofa_tpu.ops.flow_viz import write_flo as j_write_flo
from mofa_tpu.train import flow_datasets as jfd

from mofa_tpu_torch.apps import eval_flow_app, train_cmp_app, train_flow_app
from mofa_tpu_torch.apps.loaders import init_random_cmp_, load_cmp
from mofa_tpu_torch.models.cmp import train as ptrain
from mofa_tpu_torch.models.cmp.model import (CMP, TINY_CMP_CONFIG, bn_stats_as_parameters,
                                             cmp_config_from_yaml, parse_yaml_subset)
from mofa_tpu_torch.models.gmflow.model import GMFlow, TINY_GMFLOW_CONFIG
from mofa_tpu_torch.models.gmflow.train import (cosine_onecycle_schedule, flow_loss,
                                                make_flow_optimizer)
from mofa_tpu_torch.models.weights import state_dict_from_flax
from mofa_tpu_torch.pipelines.common import init_random_
from mofa_tpu_torch.train import flow_datasets as pfd
from tests.torch_port_util import (flax_apply_without_shape_recheck,  # noqa: F401
                                   one_torch_thread)  # (both autouse)
from tests.torch_port_util import jit_fast, sd_np, template


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(np.array(x))


# ------------------------------------------------------------------ CMP

COMBOS = [("resnet50", "shallownet8x", "MotionDecoderSkipLayer", True, 64),
          ("resnet50", "shallownet8x", "MotionDecoderPlain", False, 64),
          ("resnet50", "shallownet8x", "MotionDecoderFlowNet", False, 64),
          ("alexnet_fcn_8x", "shallownet8x", "MotionDecoderPlain", False, 64),
          ("alexnet_fcn_32x", "shallownet32x", "MotionDecoderPlain", False, 128)]


def _cmp_pair(cfg_kw: dict, size: int, seed: int = 3):
    """The port's CMP at TINY_CMP_CONFIG with `cfg_kw`, seeded (BatchNorm
    statistics too), and its Flax twin's params through mofa_tpu's
    converter (strict)."""
    cfg = dataclasses.replace(TINY_CMP_CONFIG, **cfg_kw)
    jcfg = dataclasses.replace(J_TINY_CMP, **cfg_kw)
    port = init_random_cmp_(CMP(cfg), torch.Generator().manual_seed(seed)).eval()
    z = lambda c: jnp.zeros((1, size, size, c))
    tree = template(lambda: JCMP(jcfg).init(jax.random.PRNGKey(0), z(3), z(2), z(2)))
    sd = {k: v for k, v in sd_np(port).items() if not k.endswith("num_batches_tracked")}
    return port, JCMP(jcfg), convert_cmp_state_dict(tree, sd, strict=True), sd


def _cmp_inputs(n: int, size: int, seed: int):
    rng = np.random.RandomState(seed)
    return ((rng.rand(n, size, size, 3) * 2 - 1).astype(np.float32),
            (rng.randn(n, size, size, 2) * 5).astype(np.float32),
            (rng.rand(n, size, size, 2) > 0.9).astype(np.float32))


@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: "-".join(map(str, c[:3])))
def test_cmp_logits_match_jax(combo):
    """CMP.logits (each of the FlowNet decoder's four scales) within 1e-5
    of their scale of Flax's on the same weights, and `state_dict_from_flax`
    of the Flax tree gives the port's state dict back (the new modules'
    names: AlexNet's conv1 ... fc7, the decoders' branches, the transposed
    convs' flipped kernels)."""
    enc, sparse_enc, dec, skip, size = combo
    port, jm, params, sd = _cmp_pair(dict(image_encoder=enc, sparse_encoder=sparse_enc,
                                          flow_decoder=dec, skip_layer=skip), size)
    back = state_dict_from_flax(params, "cmp")
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    x = _cmp_inputs(1, size, 4)
    with torch.no_grad():
        got = port.logits(*map(_t, x))
    want = jit_fast(lambda p, *a: jm.apply(p, *a, method=JCMP.logits))(params, *x)
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want) == (4 if dec == "MotionDecoderFlowNet" else 1)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def _jax_losses_and_warps(logits, target, ml, m, lv, pred, img, grid, flow, fflow):
    return (jtrain.discrete_flow_loss(logits, target, 9, 50.0),
            *(jtrain.multi_discrete_flow_loss(ml, target, quantize_strategy=q,
                                              xy_weight=(1.0, 0.5))
              for q in ("linear", "quadratic")),
            jtrain.kld_loss(m, lv), jtrain.edge_aware_loss(pred, target),
            *(jtrain.grid_sample_norm(img, grid, ac) for ac in (False, True)),
            jtrain.warp_backward(img, flow),
            *jtrain.warp_forward_sorted(img, fflow, ret_mask=True))


def test_cmp_losses_warps_and_schedule_match_jax():
    """discrete_flow_loss (resized logits, the bins >= nbins clamp),
    multi_discrete_flow_loss (linear, quadratic), kld_loss,
    edge_aware_loss, grid_sample_norm (both corner modes), warp_backward,
    warp_forward_sorted (collisions, holes; exact) and step_lr_schedule
    (the shipped milestones; a warmup) against the JAX functions (one
    program)."""
    rng = np.random.RandomState(5)
    logits = rng.randn(2, 6, 8, 2 * 9).astype(np.float32) * 3
    target = (rng.randn(2, 12, 16, 2) * 30).astype(np.float32)
    target[0, 0, 0] = 70.0
    ml = rng.randn(2, 12, 16, 2 * 19).astype(np.float32)
    m, lv = rng.randn(4, 8).astype(np.float32), rng.randn(4, 8).astype(np.float32) * 0.1
    pred = (rng.randn(2, 6, 8, 2) * 4).astype(np.float32)
    img = rng.rand(2, 9, 11, 3).astype(np.float32)
    grid = (rng.rand(2, 5, 7, 2) * 2.4 - 1.2).astype(np.float32)
    flow = (rng.randn(2, 9, 11, 2) * 2).astype(np.float32)
    fflow = np.round(rng.randn(2, 9, 11, 2) * 1.5).astype(np.float32)
    fflow[0, 0, 0], fflow[0, 0, 3] = (1.0, 0.0), (-2.0, 0.0)
    want = jit_fast(_jax_losses_and_warps)(logits, target, ml, m, lv, pred, img, grid,
                                           flow, fflow)
    T = _t
    got = (ptrain.discrete_flow_loss(T(logits), T(target), 9, 50.0),
           *(ptrain.multi_discrete_flow_loss(T(ml), T(target), quantize_strategy=q,
                                             xy_weight=(1.0, 0.5))
             for q in ("linear", "quadratic")),
           ptrain.kld_loss(T(m), T(lv)), ptrain.edge_aware_loss(T(pred), T(target)),
           *(ptrain.grid_sample_norm(T(img), T(grid), ac) for ac in (False, True)),
           ptrain.warp_backward(T(img), T(flow)),
           *ptrain.warp_forward_sorted(T(img), T(fflow), ret_mask=True))
    assert len(got) == len(want) == 10
    for a, b in zip(got[:-2], want[:-2]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
    for a, b in zip(got[-2:], want[-2:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for args, kw in (((0.04, (24000, 36000), (0.1, 0.1)), {}),
                     ((0.1, (100,), (0.1,)), dict(warmup_lr=(0.4,), warmup_steps=(10,)))):
        ps, js = ptrain.step_lr_schedule(*args, **kw), jtrain.step_lr_schedule(*args, **kw)
        for step in (0, 3, 5, 9, 10, 99, 100, 23999, 24000, 36000, 50000):
            assert ps(step) == pytest.approx(float(js(step)), rel=1e-6)


def test_cmp_sgd_step_trains_bn_statistics_as_jax():
    """Two steps of the tiny CMP at 64x64 with the BatchNorm statistics as
    parameters, make_cmp_optimizer at lr 0.4 and weight decay 1e-2 (both
    above the shipped config's, so the decay and the momentum show):
    each step's loss within 1e-5 and every parameter after the steps (the
    running means and variances included, which receive gradients and
    move) within 1e-5 of their scale of the JAX steps' (one jit at XLA's
    default optimisation: at level 0 its fp32 sums round differently); the
    trained state dict loads strictly into the inference CMP
    (nn.BatchNorm2d), the reference's names."""
    port, jm, params, _ = _cmp_pair({}, 64, seed=6)
    image, sparse, mask = _cmp_inputs(2, 64, 7)
    target = (np.random.RandomState(8).randn(2, 64, 64, 2) * 10).astype(np.float32)
    batch = dict(image=image, sparse=sparse, mask=mask, target_flow=target)
    tx = jtrain.make_cmp_optimizer(0.4, weight_decay=1e-2)
    j_step = jax.jit(jtrain.make_cmp_train_step(jm, tx, nbins=9, fmax=50.0))
    new, opt_state, losses = params, tx.init(params), []
    for _ in range(2):
        new, opt_state, metrics = j_step(new, opt_state, batch)
        losses.append(float(metrics["loss"]))
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, new), "cmp")

    model = bn_stats_as_parameters(port).requires_grad_(True)
    opt = ptrain.make_cmp_optimizer(model.parameters(), 0.4, weight_decay=1e-2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = ptrain.make_cmp_train_step(model, opt, nbins=9, fmax=50.0)
    for want_loss in losses:
        got = step({k: _t(v) for k, v in batch.items()})
        assert float(got["loss"]) == pytest.approx(want_loss, rel=1e-5)
    sd = model.state_dict()
    assert sd.keys() == want.keys()
    for k, v in want.items():
        v = v.numpy()
        np.testing.assert_allclose(sd[k].detach().numpy(), v, rtol=0,
                                   atol=1e-5 * np.abs(v).max(), err_msg=k)
    stats = [(n, p) for n, p in model.named_parameters()
             if n.endswith(("running_mean", "running_var"))]
    assert stats and all(p.grad is not None and bool(p.grad.abs().sum() > 0)
                         and not torch.equal(p.detach(), before[n]) for n, p in stats)
    fresh = CMP(TINY_CMP_CONFIG).eval()
    fresh.load_state_dict(sd, strict=True)             # the inference module's names
    for k, v in sd.items():
        assert torch.equal(fresh.state_dict()[k], v.detach()), k


def test_cmp_config_from_yaml_matches_jax(tmp_path):
    """A config.yaml in the reference's form (nested mappings, inline and
    block lists, comments, quoted strings): the port's reader gives
    PyYAML's tree and the JAX package's CMPConfig fields; an unsupported
    construct raises."""
    text = """model:
    arch: CMP
    lr_steps: [24000, 36000]
    warmup_lr: []
    module:
        image_encoder: alexnet_fcn_32x   # the 32x encoder
        sparse_encoder: 'shallownet32x'
        flow_decoder: "MotionDecoderPlain"
        skip_layer: False
        img_enc_dim: 128
        decoder_combo: [1, 2]
        nbins: 49
        fmax: 25.5
data:
    data_mean: [123.675, 116.28, 103.53] # RGB
    train_source:
        - data/a.txt
        - data/b.txt
"""
    path = tmp_path / "config.yaml"
    path.write_text(text)
    import yaml
    assert parse_yaml_subset(text) == yaml.safe_load(text)
    assert dataclasses.asdict(cmp_config_from_yaml(str(path))) == \
        dataclasses.asdict(j_cmp_config_from_yaml(str(path)))
    with pytest.raises(ValueError, match="unsupported"):
        parse_yaml_subset("a: |\n  text\n")


# ------------------------------------------------------------------ GMFlow

def test_flow_loss_and_metrics_match_jax():
    """The gamma-weighted L1 over three predictions, validity and the
    max_flow cut, and the EPE / 1 / 3 / 5 px rates, against JAX's."""
    rng = np.random.RandomState(9)
    preds = [rng.randn(2, 8, 10, 2).astype(np.float32) * 3 for _ in range(3)]
    gt = rng.randn(2, 8, 10, 2).astype(np.float32) * 3
    gt[0, 0, 0] = 500.0
    valid = (rng.rand(2, 8, 10) > 0.3).astype(np.float32)
    loss, m = flow_loss([_t(p) for p in preds], _t(gt), _t(valid))
    jl, jm_ = j_flow_loss([_j(p) for p in preds], _j(gt), _j(valid))
    assert float(loss) == pytest.approx(float(jl), rel=1e-6)
    for k in ("epe", "1px", "3px", "5px"):
        assert float(m[k]) == pytest.approx(float(jm_[k]), rel=1e-6, abs=1e-7)


def test_adamw_onecycle_step_matches_optax():
    """Two AdamW steps on the tiny GMFlow's own gradients (flow_loss over
    its predictions at 64x96; the last prediction, past the detached
    refinement inputs, reaches no propagation weight) against optax.adamw on
    cosine_onecycle_schedule at the update count (40 steps, 5% warmup):
    every parameter within 1e-6 of its scale; the schedule equals optax's at
    every count; at 10 steps, where optax's warmup has no step and its
    schedule is NaN, the port's skips the interval (ROADMAP Queue 3 item
    10)."""
    model = init_random_(GMFlow(TINY_GMFLOW_CONFIG), torch.Generator().manual_seed(4))
    rng = np.random.RandomState(10)
    img0, img1 = (_t(rng.rand(1, 64, 96, 3).astype(np.float32) * 255) for _ in range(2))
    gt = _t(rng.randn(1, 64, 96, 2).astype(np.float32))
    _, preds = model(img0, img1, return_preds=True)
    assert len(preds) == TINY_GMFLOW_CONFIG.num_scales + TINY_GMFLOW_CONFIG.num_reg_refine
    # the JAX package stops the gradient at each refinement's input flow, so
    # the last prediction reaches no propagation weight
    prop = list(model.feature_flow_attn.parameters())
    assert all(g is None for g in torch.autograd.grad(
        preds[-1].sum(), prop, retain_graph=True, allow_unused=True))
    flow_loss(preds, gt, torch.ones(1, 64, 96))[0].backward()
    assert all(p.grad is not None for p in prop)
    names = [n for n, p in model.named_parameters() if p.grad is not None]
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters() if n in names}
    params = {n: p.detach().numpy().copy() for n, p in model.named_parameters() if n in names}
    opt = make_flow_optimizer([p for n, p in model.named_parameters() if n in names],
                              lr=4e-4, weight_decay=1e-4, total_steps=40)
    tx = optax.adamw(optax.cosine_onecycle_schedule(40, 4e-4, pct_start=0.05),
                     weight_decay=1e-4)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    state = tx.init(jp)
    update = jit_fast(tx.update)
    for _ in range(2):
        opt.step()
        u, state = update({n: jnp.asarray(g) for n, g in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, u)
    got = dict(model.named_parameters())
    for n in names:
        want = np.asarray(jp[n])
        np.testing.assert_allclose(got[n].detach().numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(), err_msg=n)
    ours, theirs = cosine_onecycle_schedule(40, 4e-4, 0.05), \
        optax.cosine_onecycle_schedule(40, 4e-4, pct_start=0.05)
    for k in range(45):
        assert ours(k) == pytest.approx(float(theirs(k)), rel=1e-5, abs=1e-12)
    short, optax_short = cosine_onecycle_schedule(10, 4e-4, 0.05), \
        optax.cosine_onecycle_schedule(10, 4e-4, pct_start=0.05)
    assert np.isnan(float(optax_short(0)))
    assert short(0) == pytest.approx(4e-4) and short(10) == pytest.approx(4e-4 / 25 / 1e4)


# ------------------------------------------------------------------ datasets

def _img(path, h=8, w=10, seed=0):
    cv2.imwrite(str(path), np.random.RandomState(seed).randint(0, 255, (h, w, 3), np.uint8))


def _write_layout(root, layout: str):
    """A small dataset in `layout`, written by the JAX package's writers
    (images by cv2)."""
    zeros = lambda v: np.full((8, 10, 2), v, np.float32)
    if layout == "triples":
        for n in ("a", "b"):
            _img(root / f"{n}_img1.png", seed=1)
            _img(root / f"{n}_img2.png", seed=2)
            j_write_flo(zeros(1.5), str(root / f"{n}_flow.flo"))
    elif layout == "chairs":
        for i in (1, 2):
            for j in (1, 2):
                _img(root / f"{i:05d}_img{j}.ppm", seed=i * 2 + j)
            flow = zeros(float(i))
            flow[0, 0] = 2000.0                 # an invalid pixel
            j_write_flo(flow, str(root / f"{i:05d}_flow.flo"))
    elif layout == "sintel":
        frames = root / "training" / "clean" / "alley"
        flows = root / "training" / "flow" / "alley"
        frames.mkdir(parents=True)
        flows.mkdir(parents=True)
        for i in range(3):
            _img(frames / f"frame_{i + 1:04d}.png", seed=i)
        for i in range(2):
            j_write_flo(zeros(float(i)), str(flows / f"frame_{i + 1:04d}.flo"))
    elif layout == "kitti":
        img2, occ = root / "training" / "image_2", root / "training" / "flow_occ"
        img2.mkdir(parents=True)
        occ.mkdir(parents=True)
        _img(img2 / "000000_10.png")
        _img(img2 / "000000_11.png", seed=1)
        jfd.write_flow_kitti(str(occ / "000000_10.png"), zeros(1.25))
    else:                                        # things
        idir = root / "frames_cleanpass" / "TRAIN" / "A" / "0000" / "left"
        idir.mkdir(parents=True)
        for d in ("into_future", "into_past"):
            fdir = root / "optical_flow" / "TRAIN" / "A" / "0000" / d / "left"
            fdir.mkdir(parents=True)
            for i in range(3):
                jfd.write_pfm(str(fdir / f"{i:04d}.pfm"), zeros(float(i)))
        for i in range(3):
            _img(idir / f"{i:04d}.png", seed=i)


@pytest.mark.parametrize("layout", ["triples", "chairs", "sintel", "kitti", "things"])
def test_flow_dataset_layouts_match_jax(tmp_path, layout):
    """Discovery (auto-sniffed and named) gives the JAX package's samples,
    and `load_sample` (cv2) the same images, flow and validity as its
    (PIL)."""
    _write_layout(tmp_path, layout)
    got = pfd.discover_flow_samples(str(tmp_path))
    want = jfd.discover_flow_samples(str(tmp_path))
    assert [dataclasses.astuple(s) for s in got] == [dataclasses.astuple(s) for s in want]
    assert [dataclasses.astuple(s) for s in pfd.discover_flow_samples(str(tmp_path), layout)] \
        == [dataclasses.astuple(s) for s in got]
    for a, b in zip(got, want):
        for x, y in zip(pfd.load_sample(a), jfd.load_sample(b)):
            np.testing.assert_array_equal(x, y)


def test_flow_readers_and_writers_match_jax(tmp_path):
    """The KITTI 16-bit PNG and PFM codecs: each package's writer read back
    by the other's reader, equal."""
    rng = np.random.RandomState(11)
    flow = np.round(rng.randn(6, 7, 2).astype(np.float32) * 64) / 64
    pfd.write_flow_kitti(str(tmp_path / "p.png"), flow)
    jfd.write_flow_kitti(str(tmp_path / "j.png"), flow)
    for a, b in zip(pfd.read_flow_kitti(str(tmp_path / "j.png")),
                    jfd.read_flow_kitti(str(tmp_path / "p.png"))):
        np.testing.assert_array_equal(a, b)
    pfm = rng.randn(6, 9, 2).astype(np.float32) * 10
    pfd.write_pfm(str(tmp_path / "p.pfm"), pfm)
    jfd.write_pfm(str(tmp_path / "j.pfm"), pfm)
    np.testing.assert_array_equal(pfd.read_pfm(str(tmp_path / "j.pfm")), pfm)
    np.testing.assert_array_equal(jfd.read_pfm(str(tmp_path / "p.pfm")), pfm)


# ------------------------------------------------------------------ the apps

def test_cmp_and_flow_apps_on_the_cpu(tmp_path):
    """train_cmp_app (tiny, 2 steps): finite losses, a checkpoint that
    `load_cmp` reads strictly and bit-equal; train_flow_app (tiny, 2
    steps): finite losses and EPE, a checkpoint eval_flow_app reads and
    scores; --mesh_data exits naming its ROADMAP item."""
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.RandomState(12)
    for n in ("a", "b"):
        for tag in ("img1", "img2"):
            cv2.imwrite(str(data / f"{n}_{tag}.png"), rng.randint(0, 255, (64, 64, 3), np.uint8))
        j_write_flo(rng.randn(64, 64, 2).astype(np.float32) * 4, str(data / f"{n}_flow.flo"))
    common = ["--data_dir", str(data), "--tiny", "--device", "cpu", "--num_steps", "2",
              "--batch_size", "2", "--save_every", "2", "--log_every", "1"]
    cmp_run = train_cmp_app.main(common + ["--output_dir", str(tmp_path / "cmp"),
                                           "--crop_size", "64"])
    assert all(np.isfinite(r["loss"]) for r in cmp_run.records)
    loaded = load_cmp(cmp_run.checkpoints[-1], "cpu", cfg=TINY_CMP_CONFIG)
    want = cmp_run.model.state_dict()
    for k, v in loaded.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    flow_run = train_flow_app.main(common + ["--output_dir", str(tmp_path / "flow"),
                                             "--image_height", "64", "--image_width", "64"])
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["epe"]) for r in flow_run.records)
    means = eval_flow_app.main(["--data_dir", str(data), "--tiny", "--device", "cpu",
                                "--gmflow_ckpt", flow_run.checkpoints[-1],
                                "--inference_height", "64", "--inference_width", "64"])
    assert set(means) == {"epe", "1px", "3px", "5px"}
    assert all(np.isfinite(v) for v in means.values())
    for app in (train_cmp_app, train_flow_app):
        with pytest.raises(SystemExit, match="ROADMAP Queue 1 item 13"):
            app.main(common + ["--output_dir", str(tmp_path / "x"), "--mesh_data", "2"])
