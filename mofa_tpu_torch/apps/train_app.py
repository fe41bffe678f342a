"""MOFA-Adapter training CLI, stages 1 and 2, on the card.

Counterpart of mofa_tpu/apps/train_app.py (the reference's
Training/train_stage{1,2}.py training loops and train_stage{1,2}.sh's
arguments): WebVid-style clips -> the GMFlow teacher's dense flows
(optionally from a teacher-flow cache) -> stage 1: those flows; stage 2:
(grid, watershed) hints sampled from each clip's last flow, completed by
CMP (`--cmp_ckpt`, `--cmp_bf16`), with the adapter's flow encoder and
conditioning embedding frozen -> the EDM step on the FlowControlNet
against the frozen SVD UNet (AdamW, or with `--use_8bit_adam` the
factored optimizer; global-norm clipping, EMA) -> checkpoints, validation
renders and the exported adapter. With `--overlap_inputs` (stage 2,
gradient_accumulation_steps 1) the next batch's teacher runs on the card
while the host samples this batch's masks (`Stage2InputPipeline`).

    python -m mofa_tpu_torch.apps.train_app --csv_path clips.csv \
        --video_folder videos --gradient_checkpointing --use_ema
    python -m mofa_tpu_torch.apps.train_app --csv_path clips.csv \
        --video_folder videos --device cpu --tiny --sample_size 64 \
        --sample_n_frames 4 --num_train_steps 2 --checkpointing_steps 1
    python -m mofa_tpu_torch.apps.train_app --stage 2 --controlnet_resume \
        runs/mofa/adapter_final --cmp_ckpt ckpt_iter_42000.pth.tar \
        --csv_path clips.csv --video_folder videos --overlap_inputs \
        --use_8bit_adam --gradient_checkpointing --use_ema

It runs on the CUDA device unless `--device cpu` is given, and raises when
there is none. Everything trains in fp32, as the JAX package does; on the
card PyTorch's defaults hold: float32 matmuls in full fp32
(`allow_tf32` False), cuDNN convolutions in TF32. The mesh options exit
naming the ROADMAP item that holds them. With `--tiny` stage 2 runs the
tiny CMP (the JAX app keeps the full one). `run(args)` returns the
`Trainer` after training, with one record per step; each step's loss,
grad norm, sigma mean and wall time are also appended to
`<output_dir>/metrics.jsonl` (`utils/logging.py::MetricsWriter`).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mofa_tpu_torch import kernels
from mofa_tpu_torch.apps.loaders import load_bundle, write_video
from mofa_tpu_torch.apps.traj_app import resolve_device
from mofa_tpu_torch.models.weights import init_adapter_from_unet, load_torch_checkpoint
from mofa_tpu_torch.utils.logging import MetricsWriter, get_logger

logger = get_logger("train")

# options the JAX CLI has and this one does not take yet: flag -> ROADMAP item
NOT_PORTED = {
    "mesh": "ROADMAP Queue 1 item 13 (the multi-GPU layer)",
}


def build_parser():
    p = argparse.ArgumentParser(description="MOFA adapter training (PyTorch)")
    p.add_argument("--stage", type=int, choices=(1, 2), default=1)
    p.add_argument("--csv_path", required=True)
    p.add_argument("--video_folder", required=True)
    p.add_argument("--output_dir", default="./runs/mofa")
    p.add_argument("--device", default="cuda")
    p.add_argument("--svd_dir", default=None)
    p.add_argument("--controlnet_resume", default=None,
                   help="an exported adapter (.safetensors or its directory) "
                        "to start from")
    p.add_argument("--gmflow_ckpt", default=None)
    p.add_argument("--cmp_ckpt", default=None)
    # train_stage1.sh defaults
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--sample_size", type=int, default=384)
    p.add_argument("--sample_stride", type=int, default=4)
    p.add_argument("--sample_n_frames", type=int, default=25)
    p.add_argument("--num_train_steps", type=int, default=100_000)
    p.add_argument("--checkpointing_steps", type=int, default=2500)
    p.add_argument("--checkpoints_total_limit", type=int, default=10)
    p.add_argument("--validation_steps", type=int, default=2500)
    p.add_argument("--conditioning_dropout_prob", type=float, default=0.1)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--overlap_inputs", action="store_true")
    p.add_argument("--cmp_bf16", action="store_true")
    p.add_argument("--flow_cache", default=None,
                   help="directory of precomputed teacher flows; hits skip the "
                        "teacher, misses are computed and written back; a "
                        "cache another teacher filled raises")
    p.add_argument("--precompute_flows", action="store_true",
                   help="replay the seeded clip schedule, write every clip's "
                        "teacher flows into --flow_cache, and exit")
    p.add_argument("--teacher_bf16", action="store_true",
                   help="run the GMFlow teacher in bf16")
    p.add_argument("--use_8bit_adam", action="store_true")
    p.add_argument("--seed", type=int, default=23123134)
    p.add_argument("--resume_from_checkpoint", default=None,
                   help="'latest' or a step number")
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--mesh_frames", type=int, default=1)
    p.add_argument("--tiny", action="store_true",
                   help="micro model configs (and the tiny teacher at 64x96)")
    return p


def refuse_unported(args) -> None:
    """SystemExit naming the ROADMAP item for an option not ported yet."""
    chosen = {"mesh": args.mesh_data * args.mesh_model * args.mesh_frames > 1}
    for flag, on in chosen.items():
        if on:
            raise SystemExit(f"train_app: --{flag} is not ported to the PyTorch "
                             f"package yet: {NOT_PORTED[flag]}")


def _sync(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def module_digest(module: torch.nn.Module) -> tuple:
    """Two integers that change when any bit of any parameter or buffer
    changes: the wrapped int64 sums of each tensor's 32-bit words and of
    the words weighted by their positions (computed where the tensors lie)."""
    total, weighted = 0, 0
    for t in module.state_dict().values():
        words = t.detach().contiguous().reshape(-1)
        width = {4: torch.int32, 2: torch.int16}.get(words.element_size(),
                                                     torch.uint8)
        words = words.view(width).to(torch.int64)
        idx = torch.arange(1, words.numel() + 1, device=words.device)
        total += int(words.sum())
        weighted += int((words * idx).sum())
    return total & (2 ** 64 - 1), weighted & (2 ** 64 - 1)


def setup_gmflow(args, dev):
    """The teacher (random weights unless --gmflow_ckpt) and its inference
    size; in bf16 with --teacher_bf16."""
    from mofa_tpu_torch.models.gmflow.model import (GMFlow, GMFlowConfig,
                                                    TINY_GMFLOW_CONFIG, load_gmflow)
    from mofa_tpu_torch.pipelines.common import init_random_
    cfg = TINY_GMFLOW_CONFIG if args.tiny else GMFlowConfig()
    size = (64, 96) if args.tiny else (384, 512)
    with torch.device(dev):
        gmflow = GMFlow(cfg)
    if args.gmflow_ckpt:
        load_gmflow(gmflow, load_torch_checkpoint(args.gmflow_ckpt))
    else:
        logger.warning("no --gmflow_ckpt: the teacher runs with random weights")
        init_random_(gmflow, torch.Generator(device=dev).manual_seed(0))
    dtype = torch.bfloat16 if args.teacher_bf16 else torch.float32
    return gmflow.to(dtype).eval().requires_grad_(False), size


class Teacher:
    """Dense teacher flows of a batch: the flow cache's clips where it has
    them, the GMFlow teacher (pairs in chunks of 8) otherwise, written back."""

    def __init__(self, args, dev):
        from mofa_tpu_torch.train.flow_cache import TeacherFlowCache, teacher_fingerprint
        self.gmflow, self.size = setup_gmflow(args, dev)
        self.dtype = next(self.gmflow.parameters()).dtype
        self.cache = None
        if args.flow_cache:
            fp = teacher_fingerprint(self.gmflow, self.gmflow.cfg, str(self.dtype),
                                     self.size)
            self.cache = TeacherFlowCache(args.flow_cache, fp)

    def flows(self, px: torch.Tensor) -> torch.Tensor:
        """The teacher's fp32 flows of the clips px, on their device."""
        from mofa_tpu_torch.train.inputs import make_stage1_batch
        return make_stage1_batch(self.gmflow, px.to(self.dtype), self.size,
                                 pair_chunk=8)["flows"].float()

    def __call__(self, px: torch.Tensor, keys=None) -> torch.Tensor:
        if self.cache is not None and keys is not None:
            hit = self.cache.get_batch(keys)
            if hit is not None:
                return torch.from_numpy(hit).to(px.device)
        flows = self.flows(px)
        if self.cache is not None and keys is not None:
            self.cache.put_batch(keys, flows.cpu().numpy())
        return flows


def rng_state(rng: np.random.RandomState) -> dict:
    """A RandomState's state as tensors and numbers (a checkpoint loads
    with weights_only=True)."""
    _, keys, pos, has_gauss, gauss = rng.get_state()
    return {"keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
            "has_gauss": int(has_gauss), "gauss": float(gauss)}


def set_rng_state(rng: np.random.RandomState, st: dict) -> None:
    rng.set_state(("MT19937", st["keys"].numpy().astype(np.uint32), st["pos"],
                   st["has_gauss"], st["gauss"]))


class Trainer:
    """Training as `train_app.run` drives it: `setup` in the constructor,
    `train()` for the steps, `export()` for the adapter."""

    def __init__(self, args):
        from mofa_tpu_torch.models.clip_vision import TINY_CLIP_CONFIG
        from mofa_tpu_torch.models.svd_unet import MICRO_UNET_CONFIG
        from mofa_tpu_torch.models.vae import TINY_VAE_CONFIG
        from mofa_tpu_torch.train.checkpoint import CheckpointManager, import_adapter
        from mofa_tpu_torch.train.data import Prefetcher, ResumableBatches, WebVidDataset
        from mofa_tpu_torch.train.stage import make_train_step
        from mofa_tpu_torch.train.state import STAGE2_FROZEN, TrainState

        refuse_unported(args)
        self.args = args
        self.dev = dev = resolve_device(args.device)
        os.makedirs(args.output_dir, exist_ok=True)
        cfg_kw = (dict(unet_cfg=MICRO_UNET_CONFIG, vae_cfg=TINY_VAE_CONFIG,
                       clip_cfg=TINY_CLIP_CONFIG) if args.tiny else {})
        self.bundle = load_bundle(args.svd_dir, None, device=dev,
                                  dtype=torch.float32, seed=args.seed, **cfg_kw)
        cn = self.bundle.controlnet
        if args.controlnet_resume:
            import_adapter(cn, args.controlnet_resume)
        elif args.stage == 1:
            # stage-1 adapters start from the frozen UNet's trunk
            # (FlowControlNet.from_unet, controlnet_sdv.py:617-627)
            init_adapter_from_unet(cn, self.bundle.unet)
        self.teacher = Teacher(args, dev)
        self.cmp = None
        if args.stage == 2:
            from mofa_tpu_torch.apps.loaders import load_cmp
            from mofa_tpu_torch.models.cmp.model import TINY_CMP_CONFIG, CMPConfig
            self.cmp = load_cmp(args.cmp_ckpt, dev,
                                dtype=torch.bfloat16 if args.cmp_bf16 else torch.float32,
                                cfg=TINY_CMP_CONFIG if args.tiny else CMPConfig(),
                                seed=args.seed)
        self.state = TrainState(cn, lr=args.learning_rate, ema=args.use_ema,
                                frozen_patterns=STAGE2_FROZEN if args.stage == 2 else (),
                                memory_lean=args.use_8bit_adam)
        self.generator = torch.Generator(device=dev).manual_seed(args.seed)
        self.rng = np.random.RandomState(args.seed)      # stage 2's mask draws
        self.accum = max(1, args.gradient_accumulation_steps)
        self.step_fn = make_train_step(
            self.bundle, self.state, self.generator,
            cond_dropout_prob=args.conditioning_dropout_prob,
            remat=args.gradient_checkpointing, accum_steps=self.accum)
        self.ckpt = CheckpointManager(os.path.join(args.output_dir, "checkpoints"),
                                      max_to_keep=args.checkpoints_total_limit,
                                      save_interval_steps=args.checkpointing_steps)
        self.start_step = 0
        if args.resume_from_checkpoint:
            step = (self.ckpt.latest_step() if args.resume_from_checkpoint == "latest"
                    else int(args.resume_from_checkpoint))
            if step is not None:
                extra = self.ckpt.restore(self.state, step)
                self.generator.set_state(extra["generator"])
                if "rng" in extra:           # stage-1 checkpoints before the mask draws
                    set_rng_state(self.rng, extra["rng"])
                self.start_step = self.state.step
                logger.info(f"resumed from step {self.start_step}")
        ds = WebVidDataset(args.csv_path, args.video_folder,
                           sample_size=args.sample_size,
                           sample_stride=args.sample_stride,
                           sample_n_frames=args.sample_n_frames, seed=args.seed)
        self.batch_size = args.batch_size * self.accum
        self.loader = Prefetcher(
            iter(ResumableBatches(ds, self.batch_size, args.num_train_steps,
                                  args.seed, start=self.start_step)),
            depth=2, pin=dev.type == "cuda")
        self.pipeline = None
        if args.stage == 2 and args.overlap_inputs and self.accum == 1:
            from mofa_tpu_torch.train.inputs import Stage2InputPipeline
            self.pipeline = Stage2InputPipeline(
                self.teacher.flows, self.cmp, (args.sample_size, args.sample_size),
                rng=self.rng, flow_cache=self.teacher.cache)
        self.records: list = []
        self.digests_at_setup = self.digests()

    def digests(self) -> dict:
        """`module_digest` of each bundle part (the adapter included): the
        frozen parts' must not change in training, the adapter's must."""
        return {name: module_digest(m) for name, m in self.bundle.modules().items()}

    def _batch(self, px, flows) -> dict:
        batch = {"pixel_values01": px, "flows": flows}
        if self.accum > 1:
            bs = self.args.batch_size
            batch = {k: v.reshape((self.accum, bs) + v.shape[1:])
                     for k, v in batch.items()}
        return batch

    def train(self) -> list:
        """Run the steps; each step's scalars are also appended to
        <output_dir>/metrics.jsonl (the reference's scalar reporting,
        train_stage1.py:1174)."""
        try:
            with MetricsWriter(self.args.output_dir) as self.metrics:
                if self.pipeline is not None:
                    self._train_overlapped()
                else:
                    for step_no in range(self.start_step, self.args.num_train_steps):
                        self.records.append(self._one_step(step_no))
        finally:
            self.loader.close()
        return self.records

    def _next_clip(self):
        b = next(self.loader)
        return b, b["pixel_values01"].to(self.dev, non_blocking=True)

    def _control(self, px, flows, times: dict, sync: bool):
        """Stage 1: the teacher's flows; stage 2: CMP's completion of hints
        sampled from them (flows on the device, or on the host as numpy)."""
        from mofa_tpu_torch.train.inputs import stage2_control_flow
        if self.cmp is None:
            return flows
        host = flows if isinstance(flows, np.ndarray) else flows.cpu().numpy()
        dense, _ = stage2_control_flow(self.cmp, px, host, px.shape[2:4], rng=self.rng,
                                       times=times, sync=sync)
        return dense

    def _one_step(self, step_no: int) -> dict:
        dev = self.dev
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        before = kernels.launch_counts()
        t0 = _sync(dev)
        b, px = self._next_clip()
        t1 = _sync(dev)
        flows = self.teacher(px, b.get("clip_key"))
        t2 = _sync(dev)
        times = {"batch_s": t1 - t0, "teacher_s": t2 - t1}
        flows = self._control(px, flows, times, sync=True)
        metrics = self.step_fn(self._batch(px, flows))
        return self._finish(step_no, metrics, times, before, t0, px, flows)

    def _train_overlapped(self) -> None:
        """Stage 2 through Stage2InputPipeline: batch i's masks are sampled
        while batch i+1's teacher runs; one record a step (teacher and CMP
        run overlapped, so only the host's mask seconds are timed apart)."""
        cache = self.teacher.cache
        box = {"t0": _sync(self.dev), "times": {}}

        def clips():
            for _ in range(self.start_step, self.args.num_train_steps):
                t = time.perf_counter()
                b, px = self._next_clip()
                box["times"] = {"batch_s": time.perf_counter() - t}
                keys = b.get("clip_key")
                yield (keys, px) if cache is not None and keys is not None else px

        def step(batch):
            if self.dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.dev)
            before = kernels.launch_counts()
            metrics = self.step_fn(batch)
            box["times"].update(self.pipeline.times)
            rec = self._finish(self.start_step + len(self.records), metrics, box["times"],
                               before, box["t0"], batch["pixel_values01"], batch["flows"])
            box["t0"] = time.perf_counter()
            return rec

        for rec in self.pipeline.run(clips(), step):
            self.records.append(rec)

    def _finish(self, step_no, metrics, times, before, t0, px, flows) -> dict:
        """The step's record (printed), its checkpoint and render. The
        record keeps the control flow's sum and sum of squares (float64),
        which tell two runs' inputs apart."""
        args, dev = self.args, self.dev
        after = kernels.launch_counts()
        wall = _sync(dev) - t0
        f64 = flows.detach().double()
        rec = {"step": step_no + 1, "loss": float(metrics["loss"]),
               "control_sums": (float(f64.sum()), float((f64 * f64).sum())),
               "grad_norm": float(metrics["grad_norm"]),
               "sigma_mean": float(metrics["sigma_mean"]),
               **times, "fwd_bwd_s": metrics["fwd_bwd_s"],
               "optimizer_s": metrics["optimizer_s"], "wall_s": wall,
               "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                            if dev.type == "cuda" else None),
               "launches": {k: after[k] - before[k] for k in after
                            if after[k] != before[k]}}
        parts = " ".join(f"{k[:-2]} {rec[k]:.3f} s" for k in
                         ("batch_s", "teacher_s", "mask_s", "cmp_s", "fwd_bwd_s",
                          "optimizer_s", "wall_s") if rec.get(k) is not None)
        peak = rec["peak_gib"]
        self.metrics.write(rec["step"], loss=rec["loss"], grad_norm=rec["grad_norm"],
                           sigma_mean=rec["sigma_mean"], wall_s=wall)
        logger.info(f"step {rec['step']} loss {rec['loss']:.6f} grad_norm "
                    f"{rec['grad_norm']:.6f} {parts} peak "
                    f"{peak if peak is None else round(peak, 2)} GiB launches "
                    f"{rec['launches']}")
        self.ckpt.save(step_no + 1, self.state,
                       extra={"generator": self.generator.get_state(),
                              "rng": rng_state(self.rng)})
        if (step_no + 1) % args.validation_steps == 0:
            self.render_validation(px, flows, step_no + 1)
        return rec

    @torch.no_grad()
    def render_validation(self, px, flows, step_no: int) -> str:
        """The EMA weights (the trained ones without EMA) through
        TrajPipeline, 4 steps, on the batch's first clip and flows
        (train_stage1.py:1210-1306); written as val_<step>.mp4."""
        from mofa_tpu_torch.pipelines.traj import TrajPipeline
        with self.state.ema_weights():
            frames, _ = TrajPipeline(self.bundle)(
                px[0:1, 0], flows.reshape((-1,) + flows.shape[-4:])[0:1],
                num_inference_steps=4,
                generator=torch.Generator(device=self.dev).manual_seed(42))
        path = os.path.join(self.args.output_dir, f"val_{step_no}.mp4")
        write_video(frames[0], path, fps=7)
        logger.info(f"validation render -> {path}")
        return path

    def export(self) -> str:
        from mofa_tpu_torch.train.checkpoint import export_adapter
        path = export_adapter(self.state, os.path.join(self.args.output_dir,
                                                       "adapter_final"))
        logger.info(f"adapter -> {path}")
        return path


def precompute_flows(args) -> int:
    """Replay the seeded clip schedule and write each clip's teacher flows
    into --flow_cache (clips already there skipped); no SVD part is built.
    Returns the number of clips written."""
    from mofa_tpu_torch.train.data import ResumableBatches, WebVidDataset
    refuse_unported(args)
    if not args.flow_cache:
        raise SystemExit("train_app: --precompute_flows needs --flow_cache DIR")
    dev = resolve_device(args.device)
    teacher = Teacher(args, dev)
    ds = WebVidDataset(args.csv_path, args.video_folder, sample_size=args.sample_size,
                       sample_stride=args.sample_stride,
                       sample_n_frames=args.sample_n_frames, seed=args.seed)
    eff = args.batch_size * max(1, args.gradient_accumulation_steps)
    done = 0
    for b in ResumableBatches(ds, eff, args.num_train_steps, args.seed):
        keys = [str(k) for k in b["clip_key"]]
        if all(teacher.cache.contains(k) for k in keys):
            continue
        teacher(torch.from_numpy(b["pixel_values01"]).to(dev), keys)
        done += len(keys)
    logger.info(f"precompute: {done} clips written, {len(teacher.cache)} in "
                f"{args.flow_cache}")
    return done


def run(args):
    """Train per `args`; returns the Trainer (its `records`, one a step)
    after exporting the adapter, or the number of clips written by
    --precompute_flows."""
    if args.precompute_flows:
        return precompute_flows(args)
    trainer = Trainer(args)
    trainer.train()
    trainer.export()
    return trainer


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
