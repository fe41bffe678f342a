"""A/B of this checkout against another tree of the port on one NVIDIA GPU.

    python3 chip_ab.py --other build/parent               # both parts
    python3 chip_ab.py --other build/parent --part train  # one part

`--other` is a directory holding another tree of the repository (unpack a
commit there with `git archive <commit> | tar -x -C build/parent`; `build/`
is git-ignored). Each measurement runs in a process of its own, in the
order other, this, this, other, so that both trees meet the same card in
turns. A process imports that tree's own `chip_smoke` and `mofa_tpu_torch`
and builds that tree's kernels. Parts:

- "videos": the bf16 short-attention kernels (tmajor [50, 9216, 320] and
  classic [18432, 25, 5, 64]: CUDA-event milliseconds of one call and of
  a call queued behind others), then the traj, hybrid and keypoint videos
  through chip_smoke's runners (host seconds around each, and the median
  denoise step);
- "train": the fp32 short-attention forward at the stage-1 training site
  in both layouts ([25, 2304, 320] and [2304, 25, 5, 64]), then five
  stage-1 training steps through `train_app` (chip_smoke's clips and
  arguments, remat), each step's forward + backward seconds.

Prints one line "AB {json}" a run, then one "AB_SUMMARY {json}" line with
each number's values by tree. Exits non-zero, printing no result, when
there is no CUDA device or a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _time(cs, fn) -> list:
    import torch
    with torch.no_grad():
        return [cs.time_ms(fn), cs.time_queued_ms(fn)]


def measure(root: str, part: str) -> dict:
    """One run of `part` with the tree at `root` (in this process)."""
    import shutil

    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    from mofa_tpu_torch.kernels import _build
    from mofa_tpu_torch.kernels.short_attention import (short_attention,
                                                        short_attention_tmajor)
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false")
    _build.build()
    _build.library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    if part == "videos":
        bf = torch.bfloat16
        q, k, v = (torch.randn(50, 9216, 320, generator=g, device=dev).to(bf)
                   for _ in range(3))
        out["tmajor_bf16_ms"] = _time(cs, lambda: short_attention_tmajor(q, k, v, 25, 5))
        q, k, v = (torch.randn(18432, 25, 5, 64, generator=g, device=dev).to(bf)
                   for _ in range(3))
        out["classic_bf16_ms"] = _time(cs, lambda: short_attention(q, k, v))
        del q, k, v
        torch.cuda.empty_cache()
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
        torch.backends.cudnn.allow_tf32 = True
        import time
        bundle = cs.random_bundle(dev, 0, bf)
        t0 = time.perf_counter()
        r = cs.run_video(bundle, dev, "tmajor", cs.MAIN["steps"])
        out["traj_s"] = [time.perf_counter() - t0, r["median_step"]]
        del bundle
        torch.cuda.empty_cache()
        r = cs.run_hybrid_video(dev, card)
        out["hybrid_s"] = [r["total"], r["median_step"]]
        torch.cuda.empty_cache()
        r = cs.run_keypoint_video(dev, card)
        out["keypoint_s"] = [r["total"], r["median_step"]]
        return out
    q, k, v = (torch.randn(25, 2304, 320, generator=g, device=dev) for _ in range(3))
    out["tmajor_fp32_ms"] = _time(cs, lambda: short_attention_tmajor(q, k, v, 25, 5))
    q, k, v = (x.reshape(2304, 25, 5, 64) for x in (q, k, v))
    out["classic_fp32_ms"] = _time(cs, lambda: short_attention(q, k, v))
    del q, k, v
    torch.cuda.empty_cache()
    work = os.path.join(root, "build", "ab_train")
    shutil.rmtree(work, ignore_errors=True)
    csv_path, folder = cs.write_clips(work, seed=11)
    trainer = cs.train_without_export(cs.train_args(
        csv_path, folder, os.path.join(work, "a"), 5, "--gradient_checkpointing",
        "--checkpointing_steps", "1000"))
    out["fwd_bwd_s"] = [r["fwd_bwd_s"] for r in trainer.records]
    shutil.rmtree(work, ignore_errors=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="the other tree's directory")
    ap.add_argument("--part", choices=("videos", "train", "all"), default="all")
    ap.add_argument("--run", nargs=3, metavar=("ROOT", "LABEL", "PART"),
                    help=argparse.SUPPRESS)   # one measurement, in this process
    args = ap.parse_args()
    if args.run:
        root, label, part = args.run
        print("AB " + json.dumps({"tree": label, "part": part,
                                  **measure(os.path.abspath(root), part)}), flush=True)
        return
    if not args.other or not os.path.isfile(os.path.join(args.other, "chip_smoke.py")):
        sys.exit("--other must name a directory holding another tree of the repository")
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this A/B needs a CUDA GPU")
    trees = (("other", args.other), ("this", HERE), ("this", HERE), ("other", args.other))
    parts = ("videos", "train") if args.part == "all" else (args.part,)
    summary: dict = {}
    for part in parts:
        for label, root in trees:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--run",
                                   os.path.abspath(root), label, part],
                                  capture_output=True, text=True)
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
            if proc.returncode != 0 or not lines:
                sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
                sys.exit(f"the {label} run of {part} failed ({proc.returncode})")
            print(lines[-1], flush=True)
            for key, value in json.loads(lines[-1][3:]).items():
                if key not in ("tree", "part"):
                    summary.setdefault(key, {}).setdefault(label, []).append(value)
    if "fwd_bwd_s" in summary:
        summary["fwd_bwd_median_after_first"] = {
            label: [statistics.median(run[1:]) for run in runs]
            for label, runs in summary["fwd_bwd_s"].items()}
    print("AB_SUMMARY " + json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
