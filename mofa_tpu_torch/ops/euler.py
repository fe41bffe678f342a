"""Euler-discrete scheduler (karras-fix variant) as pure functions.

Counterpart of mofa_tpu/ops/euler.py: the numpy table code is the same
(scaled-linear betas, sigma = sqrt((1-ac)/ac), linear sigma interpolation
over "leading" timesteps, Karras rho-7 re-spacing with the config's
sigma_min/sigma_max), and the step math runs in fp32 on torch tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

SVD_SCHEDULER_CONFIG = dict(
    num_train_timesteps=1000,
    beta_start=0.00085,
    beta_end=0.012,
    beta_schedule="scaled_linear",
    interpolation_type="linear",
    prediction_type="v_prediction",
    sigma_min=0.002,
    sigma_max=700.0,
    timestep_spacing="leading",
    steps_offset=1,
    use_karras_sigmas=True,
)


@dataclasses.dataclass(frozen=True)
class EulerSchedule:
    sigmas: np.ndarray          # [num_steps + 1], trailing 0.0
    timesteps: np.ndarray       # [num_steps]
    init_noise_sigma: float
    prediction_type: str
    train_sigmas: np.ndarray    # [num_train_timesteps]
    num_train_timesteps: int


def _training_sigmas(cfg) -> np.ndarray:
    n = cfg["num_train_timesteps"]
    if cfg["beta_schedule"] == "scaled_linear":
        betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5, n,
                            dtype=np.float64) ** 2
    elif cfg["beta_schedule"] == "linear":
        betas = np.linspace(cfg["beta_start"], cfg["beta_end"], n, dtype=np.float64)
    else:
        raise NotImplementedError(cfg["beta_schedule"])
    # torch fp32 accumulation of cumprod
    ac = np.cumprod((1.0 - betas).astype(np.float32)).astype(np.float64)
    return np.sqrt((1 - ac) / ac)


def _sigma_to_t(sigma: np.ndarray, log_sigmas: np.ndarray) -> np.ndarray:
    log_sigma = np.log(np.maximum(sigma, 1e-10))
    dists = log_sigma - log_sigmas[:, None]
    low_idx = np.cumsum(dists >= 0, axis=0).argmax(axis=0).clip(max=log_sigmas.shape[0] - 2)
    high_idx = low_idx + 1
    low, high = log_sigmas[low_idx], log_sigmas[high_idx]
    w = np.clip((low - log_sigma) / (low - high), 0, 1)
    return (1 - w) * low_idx + w * high_idx


def make_euler_schedule(num_inference_steps: int, config: dict | None = None) -> EulerSchedule:
    cfg = dict(SVD_SCHEDULER_CONFIG)
    if config:
        cfg.update(config)
    train_sigmas = _training_sigmas(cfg)
    log_sigmas = np.log(train_sigmas)

    spacing = cfg["timestep_spacing"]
    n_train = cfg["num_train_timesteps"]
    if spacing == "linspace":
        timesteps = np.linspace(0, n_train - 1, num_inference_steps, dtype=np.float32)[::-1].copy()
    elif spacing == "leading":
        step_ratio = n_train // num_inference_steps
        timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.float32)
        timesteps += cfg["steps_offset"]
    elif spacing == "trailing":
        step_ratio = n_train / num_inference_steps
        timesteps = np.arange(n_train, 0, -step_ratio).round().astype(np.float32) - 1
    else:
        raise ValueError(spacing)

    if cfg["interpolation_type"] == "linear":
        sigmas = np.interp(timesteps, np.arange(len(train_sigmas)), train_sigmas)
    elif cfg["interpolation_type"] == "log_linear":
        sigmas = np.exp(np.linspace(np.log(train_sigmas[-1]), np.log(train_sigmas[0]),
                                    num_inference_steps + 1))
    else:
        raise ValueError(cfg["interpolation_type"])

    if cfg["use_karras_sigmas"]:
        sigma_min = cfg["sigma_min"] if cfg["sigma_min"] is not None else sigmas[-1]
        sigma_max = cfg["sigma_max"] if cfg["sigma_max"] is not None else sigmas[0]
        rho = 7.0
        ramp = np.linspace(0, 1, num_inference_steps)
        min_inv_rho = sigma_min ** (1 / rho)
        max_inv_rho = sigma_max ** (1 / rho)
        sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
        timesteps = _sigma_to_t(sigmas, log_sigmas)

    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    timesteps = timesteps.astype(np.float32)

    max_sigma = sigmas.max()
    init = max_sigma if spacing in ("linspace", "trailing") else float((max_sigma**2 + 1) ** 0.5)
    return EulerSchedule(
        sigmas=sigmas,
        timesteps=timesteps,
        init_noise_sigma=float(init),
        prediction_type=cfg["prediction_type"],
        train_sigmas=train_sigmas.astype(np.float32),
        num_train_timesteps=n_train,
    )


def scale_model_input(sample: torch.Tensor, sigma) -> torch.Tensor:
    div = torch.sqrt(torch.as_tensor(sigma, dtype=torch.float32) ** 2 + 1)
    return sample / div.to(sample.dtype).to(sample.device)


def euler_step(model_output: torch.Tensor, sample: torch.Tensor, sigma, sigma_next,
               prediction_type: str = "v_prediction"):
    """One Euler ODE step (s_churn=0 path). Returns (prev_sample, pred_x0), fp32."""
    sample = sample.float()
    model_output = model_output.float()
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=sample.device)
    sigma_next = torch.as_tensor(sigma_next, dtype=torch.float32, device=sample.device)
    if prediction_type == "epsilon":
        pred_x0 = sample - sigma * model_output
    elif prediction_type == "v_prediction":
        pred_x0 = model_output * (-sigma / torch.sqrt(sigma**2 + 1)) + sample / (sigma**2 + 1)
    elif prediction_type in ("sample", "original_sample"):
        pred_x0 = model_output
    else:
        raise ValueError(prediction_type)
    derivative = (sample - pred_x0) / sigma
    prev_sample = sample + derivative * (sigma_next - sigma)
    return prev_sample, pred_x0
