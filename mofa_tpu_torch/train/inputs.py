"""Stage-1 training inputs: the GMFlow teacher's dense flow as the control.

Counterpart of the stage-1 half of mofa_tpu/train/inputs.py
(`make_stage1_batch`, `scale_flow_to`; the reference's
Training/train_stage1.py:113-143). Stage 2's sparse sampling and CMP
completion are not ported (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import torch

from mofa_tpu_torch.models.gmflow.model import get_optical_flows
from mofa_tpu_torch.ops.flow import rescale_flow


def scale_flow_to(flow: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The reference's F.interpolate default (nearest) with each component
    scaled by the size ratio (train_stage2.py:133-137)."""
    return rescale_flow(flow, height, width)


def make_stage1_batch(gmflow, pixel_values01: torch.Tensor,
                      inference_size=(384, 512),
                      pair_chunk: int | None = None) -> dict:
    """{pixel_values01, flows}: the clip and its frame 0 -> frame i GMFlow
    flows [B, T-1, H, W, 2], the pairs run `pair_chunk` at a time."""
    flows = get_optical_flows(gmflow, pixel_values01, inference_size=inference_size,
                              pair_chunk=pair_chunk)
    return {"pixel_values01": pixel_values01, "flows": flows}
