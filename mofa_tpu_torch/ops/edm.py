"""EDM training noise schedule and loss scalings.

Counterpart of mofa_tpu/ops/edm.py (the reference's
`rand_cosine_interpolated` / `stratified_uniform` and the c_out / c_skip
parameterisation of its training loss, Training/train_stage1.py:158-204,
1142-1155). The uniform draws come from a `torch.Generator` or are passed
in, so a test can hand both packages the same numbers.
"""

from __future__ import annotations

import math

import torch

# training constants (train_stage1.py:199-204)
MIN_VALUE = 0.002
MAX_VALUE = 700.0
IMAGE_D = 64.0
NOISE_D_LOW = 32.0
NOISE_D_HIGH = 64.0
SIGMA_DATA = 0.5


def _logsnr_schedule_cosine(t, logsnr_min, logsnr_max):
    t_min = math.atan(math.exp(-0.5 * logsnr_max))
    t_max = math.atan(math.exp(-0.5 * logsnr_min))
    return -2.0 * torch.log(torch.tan(t_min + t * (t_max - t_min)))


def _logsnr_shifted(t, image_d, noise_d, logsnr_min, logsnr_max):
    shift = 2.0 * math.log(noise_d / image_d)
    return _logsnr_schedule_cosine(t, logsnr_min - shift, logsnr_max - shift) + shift


def rand_cosine_interpolated(shape, generator: torch.Generator | None = None,
                             uniform: torch.Tensor | None = None, device=None,
                             image_d=IMAGE_D, noise_d_low=NOISE_D_LOW,
                             noise_d_high=NOISE_D_HIGH, sigma_data=SIGMA_DATA,
                             min_value=MIN_VALUE,
                             max_value=MAX_VALUE) -> torch.Tensor:
    """Training sigmas of `shape` from the interpolated cosine logSNR
    schedule, fp32: stratified uniforms (arange(n) + U) / n over the last
    axis, U drawn from `generator` or given as `uniform`."""
    logsnr_min = -2.0 * math.log(min_value / sigma_data)
    logsnr_max = -2.0 * math.log(max_value / sigma_data)
    if uniform is None:
        dev = device if device is not None else (
            generator.device if generator is not None else None)
        uniform = torch.rand(shape, generator=generator, device=dev)
    n = shape[-1]
    offsets = torch.arange(n, dtype=torch.float32, device=uniform.device)
    u = (offsets + uniform.float()) / n
    lo = _logsnr_shifted(u, image_d, noise_d_low, logsnr_min, logsnr_max)
    hi = _logsnr_shifted(u, image_d, noise_d_high, logsnr_min, logsnr_max)
    logsnr = lo + u * (hi - lo)
    return torch.exp(-logsnr / 2.0) * sigma_data


def edm_scalings(sigmas: torch.Tensor):
    """(c_out, c_skip, weighting, c_in, timesteps) of the EDM loss:
    denoised = model_pred * c_out + c_skip * noisy, loss weight
    (1 + s^2) / s^2, model input scaled by c_in = 1 / sqrt(s^2 + 1),
    timestep 0.25 * log(s)."""
    c_out = -sigmas / torch.sqrt(sigmas ** 2 + 1.0)
    c_skip = 1.0 / (sigmas ** 2 + 1.0)
    weighting = (1.0 + sigmas ** 2) * sigmas ** -2.0
    c_in = 1.0 / torch.sqrt(sigmas ** 2 + 1.0)
    timesteps = 0.25 * torch.log(sigmas)
    return c_out, c_skip, weighting, c_in, timesteps
