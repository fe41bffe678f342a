"""CMP (Conditional Motion Propagation) training CLI, on the card.

Counterpart of mofa_tpu/apps/train_cmp_app.py (the reference's CMP
trainer, models/cmp/main.py + models/cmp/models/cmp.py:9-64): SGD with the
step schedule (lr 0.1, steps [24000, 36000] x 0.1 in the shipped
resnet50_vip+mpii_liteflow/config.yaml:3-7), the discrete loss over 99
bins a component, sparse hints sampled every step with (grid, watershed)
(config.yaml:31-34), images normalised by the reference's RGB mean / div
(config.yaml:27-28).

    python -m mofa_tpu_torch.apps.train_cmp_app --data_dir flows/ \
        --config config.yaml --output_dir runs/cmp
    python -m mofa_tpu_torch.apps.train_cmp_app --data_dir flows/ --tiny \
        --device cpu --num_steps 2 --batch_size 2 --crop_size 64

Data: any layout `train/flow_datasets.py` discovers; each sample gives
(img1, flow). Every `--save_every` steps (and at the last) it writes
`cmp_<step>.pth.tar`: {"step", "state_dict"} under the reference's key
names, which `apps/loaders.py::load_cmp` reads strictly, so a CMP trained
here feeds stage 2 through `train_app --cmp_ckpt`. The BatchNorm
statistics train by gradient, as in the JAX package (ROADMAP Queue 3 item
9). `--mesh_data` above 1 exits naming ROADMAP Queue 1 item 13. It runs
on the CUDA device unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mofa_tpu_torch.utils.logging import get_logger

logger = get_logger("train_cmp")

DATA_MEAN = (123.675, 116.28, 103.53)  # config.yaml:27 (RGB, 0-255)
DATA_DIV = (58.395, 57.12, 57.375)     # config.yaml:28


def build_parser():
    p = argparse.ArgumentParser(description="CMP training (PyTorch)")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--layout", default="auto",
                   choices=["auto", "triples", "chairs", "sintel", "kitti"])
    p.add_argument("--output_dir", default="./runs/cmp")
    p.add_argument("--device", default="cuda")
    p.add_argument("--config", default=None,
                   help="the reference CMP config.yaml, for the module's dims")
    p.add_argument("--resume", default=None,
                   help="a CMP checkpoint (.pth.tar) to start from")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--lr_steps", type=int, nargs="*", default=[24000, 36000])
    p.add_argument("--lr_mults", type=float, nargs="*", default=[0.1, 0.1])
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_steps", type=int, default=42000)
    p.add_argument("--crop_size", type=int, default=384)
    p.add_argument("--bg_ratio", type=float, default=5.74e-5)
    p.add_argument("--nms_ks", type=int, default=41)
    p.add_argument("--save_every", type=int, default=5000)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--tiny", action="store_true")
    return p


def _resize(array: np.ndarray, size: int) -> np.ndarray:
    """[H, W, C] -> [size, size, C], bilinear with align_corners."""
    from mofa_tpu_torch.ops.resize import resize_nhwc
    return resize_nhwc(torch.from_numpy(array)[None], (size, size), "bilinear",
                       True)[0].numpy()


def make_batch(pairs, idx, size, bg_ratio, nms_ks, rng) -> dict:
    """The samples `idx` resized to the crop, normalised, with sparse hints
    sampled from their flow (in the order of idx, one draw each): numpy
    image [N, S, S, 3], sparse, mask, target_flow [N, S, S, 2]."""
    from mofa_tpu_torch.train.flow_sampler import flow_sampler
    mean = np.asarray(DATA_MEAN, np.float32)
    div = np.asarray(DATA_DIV, np.float32)
    imgs, sparses, masks, flows = [], [], [], []
    for i in idx:
        img, flow = pairs[i]
        h, w = img.shape[:2]
        im = _resize(img, size)
        fl = _resize(flow, size) * np.asarray([size / w, size / h], np.float32)
        sparse, mask = flow_sampler(fl, ("grid", "watershed"), bg_ratio=bg_ratio,
                                    nms_ks=nms_ks, rng=rng)
        imgs.append((im - mean) / div)
        sparses.append(sparse)
        masks.append(mask.astype(np.float32))
        flows.append(fl)
    return {"image": np.stack(imgs), "sparse": np.stack(sparses),
            "mask": np.stack(masks), "target_flow": np.stack(flows)}


def save_checkpoint(cmp, step: int, path: str) -> None:
    """{"step", "state_dict"}: the trained CMP under the reference's names
    (BatchNorm statistics as running_mean / running_var)."""
    sd = {k: v.detach().cpu().clone() for k, v in cmp.state_dict().items()}
    tmp = path + ".tmp"
    torch.save({"step": step, "state_dict": sd}, tmp)
    os.replace(tmp, path)


class Result:
    """What `run` returns: the trained CMP (BatchNorm statistics as
    parameters), one record a step, the checkpoints written."""

    def __init__(self, model, cfg):
        self.model, self.cfg = model, cfg
        self.records: list = []
        self.checkpoints: list = []


def run(args) -> Result:
    from mofa_tpu_torch.apps.loaders import load_cmp
    from mofa_tpu_torch.apps.traj_app import resolve_device
    from mofa_tpu_torch.models.cmp.model import (CMP, TINY_CMP_CONFIG, CMPConfig,
                                                 bn_stats_as_parameters,
                                                 cmp_config_from_yaml)
    from mofa_tpu_torch.models.cmp.train import make_cmp_optimizer, make_cmp_train_step
    from mofa_tpu_torch.pipelines.common import init_random_
    from mofa_tpu_torch.train.flow_datasets import discover_flow_samples, load_sample

    if args.mesh_data > 1:
        raise SystemExit("train_cmp_app: --mesh_data is not ported to the PyTorch "
                         "package yet: ROADMAP Queue 1 item 13 (the multi-GPU layer)")
    dev = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    if args.config:
        cfg = cmp_config_from_yaml(args.config)
    else:
        cfg = TINY_CMP_CONFIG if args.tiny else CMPConfig()
    size = args.crop_size

    pairs = []
    for s in discover_flow_samples(args.data_dir, args.layout):
        img1, _, flow, _ = load_sample(s)
        if flow is not None:
            pairs.append((img1, flow))
    if not pairs:
        raise SystemExit(f"train_cmp_app: no (image, flow) samples in {args.data_dir}")
    logger.info(f"{len(pairs)} training samples from {args.data_dir}")

    if args.resume:
        model = load_cmp(args.resume, dev, cfg=cfg)
        logger.info(f"resumed from {args.resume}")
    else:
        with torch.device(dev):
            model = CMP(cfg)
        init_random_(model, torch.Generator(device=dev).manual_seed(args.seed))
    model = bn_stats_as_parameters(model).train().requires_grad_(True)
    opt = make_cmp_optimizer(model.parameters(), args.lr, args.momentum,
                             args.weight_decay, milestones=tuple(args.lr_steps),
                             lr_mults=tuple(args.lr_mults))
    step_fn = make_cmp_train_step(model, opt, nbins=cfg.nbins, fmax=cfg.fmax)

    result = Result(model, cfg)
    rng = np.random.RandomState(args.seed)
    t_start = time.perf_counter()
    for step in range(1, args.num_steps + 1):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        idx = rng.randint(0, len(pairs), size=args.batch_size)
        host = make_batch(pairs, idx, size, args.bg_ratio, args.nms_ks, rng)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        t1 = time.perf_counter()
        metrics = step_fn(batch)
        loss = float(metrics["loss"])
        t2 = time.perf_counter()
        rec = {"step": step, "loss": loss, "batch_s": t1 - t0, "step_s": t2 - t1,
               "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                            if dev.type == "cuda" else None)}
        result.records.append(rec)
        if step % args.log_every == 0 or step == args.num_steps:
            logger.info(f"step {step}: loss {loss:.4f} batch {rec['batch_s']:.3f} s "
                        f"step {rec['step_s']:.3f} s ({t2 - t_start:.1f} s)")
        if step % args.save_every == 0 or step == args.num_steps:
            path = os.path.join(args.output_dir, f"cmp_{step:07d}.pth.tar")
            save_checkpoint(model, step, path)
            result.checkpoints.append(path)
            logger.info(f"saved {path}")
    return result


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
