"""Optical-flow evaluation CLI (EPE and outlier rates), on the card.

Counterpart of mofa_tpu/apps/eval_flow_app.py (the metric loop of the
reference's Training/train_utils/unimatch/evaluate_flow.py): the GMFlow
model on each image pair of a flow dataset at the inference size, its flow
resized back (bilinear, align_corners, scaled per axis) and scored against
the ground truth by `flow_epe` (EPE, > 1 / 3 / 5 px); the means over the
pairs are printed and returned.

    python -m mofa_tpu_torch.apps.eval_flow_app --data_dir flows/ \
        --gmflow_ckpt runs/flow/gmflow_0100000.pth

Data discovery is `train/flow_datasets.py`'s. Without `--gmflow_ckpt` the
model has seeded random weights. It runs on the CUDA device unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mofa_tpu_torch.utils.logging import get_logger

logger = get_logger("eval_flow")


def build_parser():
    p = argparse.ArgumentParser(description="GMFlow evaluation (EPE), PyTorch")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--layout", default="auto",
                   choices=["auto", "triples", "chairs", "sintel", "kitti"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--gmflow_ckpt", default=None)
    p.add_argument("--inference_height", type=int, default=384)
    p.add_argument("--inference_width", type=int, default=512)
    p.add_argument("--tiny", action="store_true")
    return p


@torch.no_grad()
def run(args) -> dict:
    from mofa_tpu_torch.apps.traj_app import resolve_device
    from mofa_tpu_torch.models.gmflow.model import (GMFlow, GMFlowConfig,
                                                    TINY_GMFLOW_CONFIG, load_gmflow)
    from mofa_tpu_torch.models.weights import load_torch_checkpoint
    from mofa_tpu_torch.ops.resize import resize_nhwc
    from mofa_tpu_torch.pipelines.common import init_random_
    from mofa_tpu_torch.train.flow_datasets import discover_flow_samples, load_sample
    from mofa_tpu_torch.train.sampler import flow_epe

    dev = resolve_device(args.device)
    with torch.device(dev):
        model = GMFlow(TINY_GMFLOW_CONFIG if args.tiny else GMFlowConfig())
    if args.gmflow_ckpt:
        load_gmflow(model, load_torch_checkpoint(args.gmflow_ckpt))
    else:
        logger.warning("no --gmflow_ckpt: evaluating random weights")
        init_random_(model, torch.Generator(device=dev).manual_seed(0))
    model.eval()
    ih, iw = args.inference_height, args.inference_width
    samples = [s for s in discover_flow_samples(args.data_dir, args.layout)
               if s.flow_path is not None]
    if not samples:
        raise SystemExit(f"no ground-truth flow samples in {args.data_dir}")
    totals = {"epe": [], "1px": [], "3px": [], "5px": []}
    for sample in samples:
        img1, img2, gt, valid = load_sample(sample)
        h, w = img1.shape[:2]
        a, b = (resize_nhwc(torch.from_numpy(x)[None].to(dev), (ih, iw), "bilinear", True)
                for x in (img1, img2))
        flow = resize_nhwc(model(a, b), (h, w), "bilinear", True)
        flow = flow * torch.tensor([w / iw, h / ih], dtype=flow.dtype, device=dev)
        m = flow_epe(flow[0].cpu().numpy(), gt, valid)
        for k in totals:
            totals[k].append(m[k])
        logger.info(f"{os.path.basename(sample.img1_path)}: epe {m['epe']:.3f}")
    means = {k: float(np.mean(v)) for k, v in totals.items()}
    print({"num_pairs": len(samples), **means})
    return means


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
