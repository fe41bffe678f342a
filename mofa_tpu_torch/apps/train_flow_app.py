"""Optical-flow (GMFlow / UniMatch) training CLI, on the card.

Counterpart of mofa_tpu/apps/train_flow_app.py (the reference's
standalone trainer, Training/train_utils/unimatch/main_flow.py:188-470):
AdamW with the one-cycle schedule (main_flow.py:209-210, 391-396), the
gamma-weighted sequence loss (loss/flow_loss.py:4-37), checkpoints every
`--save_every` steps and at the last.

    python -m mofa_tpu_torch.apps.train_flow_app --data_dir flows/
    python -m mofa_tpu_torch.apps.train_flow_app --data_dir flows/ --tiny \
        --device cpu --num_steps 2 --batch_size 2 --image_height 32 \
        --image_width 32

Data discovery is `train/flow_datasets.py`'s (shared with
`eval_flow_app`). Samples are resized to the training resolution
(bilinear, align_corners, the flow scaled per axis; the validity mask
nearest). A checkpoint is `gmflow_<step>.pth`, {"model": UniMatch-named
state dict, "step"}, which `load_gmflow` / `eval_flow_app --gmflow_ckpt`
read. `--mesh_data` above 1 exits naming ROADMAP Queue 1 item 13. It runs
on the CUDA device unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mofa_tpu_torch.utils.logging import get_logger

logger = get_logger("train_flow")


def build_parser():
    p = argparse.ArgumentParser(description="GMFlow training (PyTorch)")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--layout", default="auto",
                   choices=["auto", "triples", "chairs", "sintel", "kitti"])
    p.add_argument("--output_dir", default="./runs/flow")
    p.add_argument("--device", default="cuda")
    p.add_argument("--resume", default=None, help="a GMFlow checkpoint to start from")
    p.add_argument("--lr", type=float, default=4e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--gamma", type=float, default=0.9)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_steps", type=int, default=100_000)
    p.add_argument("--image_height", type=int, default=384)
    p.add_argument("--image_width", type=int, default=512)
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--seed", type=int, default=326)  # main_flow.py's default
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--tiny", action="store_true")
    return p


def load_pairs(data_dir: str, layout: str = "auto") -> list:
    """(img1, img2, flow, valid) of every sample with ground truth."""
    from mofa_tpu_torch.train.flow_datasets import discover_flow_samples, load_sample
    out = []
    for s in discover_flow_samples(data_dir, layout):
        img1, img2, flow, valid = load_sample(s)
        if flow is not None:               # test splits carry no ground truth
            out.append((img1, img2, flow, valid))
    if not out:
        raise SystemExit(f"no ground-truth samples in {data_dir}")
    return out


def make_batch(pairs, idx, ih: int, iw: int) -> dict:
    """The samples `idx` at (ih, iw): images and flow bilinear
    (align_corners), the flow scaled per axis, the validity mask nearest (a
    half-valid bilinear pixel is not valid). CPU tensors."""
    from mofa_tpu_torch.ops.resize import resize_nhwc
    i0, i1, fl, va = [], [], [], []
    for i in idx:
        a, b, f, v = (torch.from_numpy(x) for x in pairs[i])
        h, w = a.shape[:2]
        i0.append(resize_nhwc(a[None], (ih, iw), "bilinear", True)[0])
        i1.append(resize_nhwc(b[None], (ih, iw), "bilinear", True)[0])
        fl.append(resize_nhwc(f[None], (ih, iw), "bilinear", True)[0]
                  * torch.tensor([iw / w, ih / h], dtype=torch.float32))
        va.append(resize_nhwc(v[None, ..., None], (ih, iw), "nearest")[0, ..., 0])
    return {"img0": torch.stack(i0), "img1": torch.stack(i1),
            "flow": torch.stack(fl), "valid": torch.stack(va)}


class Result:
    """What `run` returns: the trained model, one record a step, the
    checkpoints written."""

    def __init__(self, model):
        self.model = model
        self.records: list = []
        self.checkpoints: list = []


def run(args) -> Result:
    from mofa_tpu_torch.apps.traj_app import resolve_device
    from mofa_tpu_torch.models.gmflow.model import (GMFlow, GMFlowConfig,
                                                    TINY_GMFLOW_CONFIG, load_gmflow)
    from mofa_tpu_torch.models.gmflow.train import make_flow_optimizer, make_flow_train_step
    from mofa_tpu_torch.models.weights import load_torch_checkpoint
    from mofa_tpu_torch.pipelines.common import init_random_

    if args.mesh_data > 1:
        raise SystemExit("train_flow_app: --mesh_data is not ported to the PyTorch "
                         "package yet: ROADMAP Queue 1 item 13 (the multi-GPU layer)")
    dev = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    with torch.device(dev):
        model = GMFlow(TINY_GMFLOW_CONFIG if args.tiny else GMFlowConfig())
    if args.resume:
        load_gmflow(model, load_torch_checkpoint(args.resume))
        logger.info(f"resumed from {args.resume}")
    else:
        init_random_(model, torch.Generator(device=dev).manual_seed(args.seed))
    model.train().requires_grad_(True)
    ih, iw = args.image_height, args.image_width
    pairs = load_pairs(args.data_dir, args.layout)
    logger.info(f"{len(pairs)} training pairs from {args.data_dir}")
    opt = make_flow_optimizer(model.parameters(), args.lr, args.weight_decay,
                              total_steps=args.num_steps)
    step_fn = make_flow_train_step(model, opt, gamma=args.gamma)

    result = Result(model)
    rng = np.random.RandomState(args.seed)
    t_start = time.perf_counter()
    for step in range(1, args.num_steps + 1):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        idx = rng.randint(0, len(pairs), size=args.batch_size)
        batch = {k: v.to(dev) for k, v in make_batch(pairs, idx, ih, iw).items()}
        t1 = time.perf_counter()
        m = {k: float(v) for k, v in step_fn(batch).items()}
        t2 = time.perf_counter()
        rec = {"step": step, **m, "batch_s": t1 - t0, "step_s": t2 - t1,
               "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                            if dev.type == "cuda" else None)}
        result.records.append(rec)
        if step % args.log_every == 0 or step == args.num_steps:
            logger.info(f"step {step}: loss {m['loss']:.4f} epe {m['epe']:.3f} "
                        f"batch {rec['batch_s']:.3f} s step {rec['step_s']:.3f} s "
                        f"({t2 - t_start:.1f} s)")
        if step % args.save_every == 0 or step == args.num_steps:
            path = os.path.join(args.output_dir, f"gmflow_{step:07d}.pth")
            tmp = path + ".tmp"
            torch.save({"model": {k: v.detach().cpu().clone()
                                  for k, v in model.state_dict().items()},
                        "step": step}, tmp)
            os.replace(tmp, path)
            result.checkpoints.append(path)
            logger.info(f"saved {path}")
    return result


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
