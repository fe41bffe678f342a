"""Flow-field transforms (PyTorch).

Counterpart of mofa_tpu/ops/flow.py. Flows are [..., H, W, 2] channel-last;
channel 0 = dx (columns), channel 1 = dy (rows).
"""

from __future__ import annotations

import torch

from mofa_tpu_torch.ops.resize import resize_nhwc


def flow_pyramid(flow: torch.Tensor, scales=(8, 16, 32, 64)) -> dict:
    """Multi-scale flow pyramid for the MOFA adapter: nearest-downsample by
    1/scale (F.interpolate's default mode) and divide the values by scale."""
    h, w = flow.shape[-3], flow.shape[-2]
    return {s: resize_nhwc(flow, (h // s, w // s), method="nearest") / s
            for s in scales}


def rescale_flow(flow: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Nearest-resize a [..., h, w, 2] flow to (height, width), then dx *=
    width / w and dy *= height / h (the reference's Drag.get_flow)."""
    h, w = flow.shape[-3], flow.shape[-2]
    if (h, w) == (height, width):
        return flow
    f = resize_nhwc(flow, (height, width), method="nearest")
    scale = torch.tensor([width / w, height / h], dtype=f.dtype, device=f.device)
    return f * scale


def merge_flows(flow_inmask: torch.Tensor, flow_outmask: torch.Tensor) -> torch.Tensor:
    """Brush-in / brush-out merge: the in-brush flow where BOTH of its
    components are nonzero, else the out-brush flow."""
    nonzero = (flow_inmask != 0).all(dim=-1, keepdim=True)
    return torch.where(nonzero, flow_inmask, flow_outmask)
