"""Resampling ops with torch `F.interpolate` index rules, as small matmuls.

Counterpart of mofa_tpu/ops/resize.py. The bilinear / bicubic and blur
matrices are the same numpy tables (so the two packages agree exactly);
here they are contracted with `torch.einsum` in fp32. The nearest resize
is an index gather on torch's legacy rule, which the JAX package's
one-hot matrix encodes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def interp_matrix(in_size: int, out_size: int, method: str = "bilinear",
                  align_corners: bool = False) -> np.ndarray:
    """[out_size, in_size] matrix M with (M @ signal) == torch interpolate
    (bilinear or bicubic)."""
    if align_corners:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        src = np.arange(out_size, dtype=np.float64) * scale
    else:
        scale = in_size / out_size
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5

    m = np.zeros((out_size, in_size), dtype=np.float64)
    if method == "bilinear":
        if not align_corners:
            src = np.maximum(src, 0.0)  # torch clamps the source index first
        i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
        i1 = np.minimum(i0 + 1, in_size - 1)
        frac = src - np.floor(src)
        frac = np.where(i0 == i1, 0.0, frac)
        np.add.at(m, (np.arange(out_size), i0), 1.0 - frac)
        np.add.at(m, (np.arange(out_size), i1), frac)
    elif method == "bicubic":
        # torch cubic convolution, A = -0.75; border taps clamped
        A = -0.75

        def cc2(x):  # |x| in [1, 2)
            return ((A * x - 5 * A) * x + 8 * A) * x - 4 * A

        def cc1(x):  # |x| in [0, 1)
            return ((A + 2) * x - (A + 3)) * x * x + 1

        i1 = np.floor(src).astype(np.int64)
        t = src - i1
        for tap, w in enumerate([cc2(t + 1.0), cc1(t), cc1(1.0 - t), cc2(2.0 - t)]):
            idx = np.clip(i1 - 1 + tap, 0, in_size - 1)
            np.add.at(m, (np.arange(out_size), idx), w)
    else:
        raise ValueError(method)
    return m.astype(np.float32)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """torch legacy 'nearest': src = floor(dst * in / out)."""
    scale = in_size / out_size
    return np.minimum((np.arange(out_size) * scale).astype(np.int64), in_size - 1)


def _acc(x: torch.Tensor) -> torch.dtype:
    """fp32 math, float64 for float64 inputs."""
    return torch.promote_types(x.dtype, torch.float32)


def _matrix(in_size, out_size, method, align_corners, like: torch.Tensor):
    m = interp_matrix(in_size, out_size, method, align_corners)
    return torch.from_numpy(m).to(like.device, _acc(like))


def resize_hw(x: torch.Tensor, size: tuple[int, int], method: str = "bilinear",
              align_corners: bool = False) -> torch.Tensor:
    """Resize the trailing (H, W) axes of x to `size` (bilinear or bicubic)."""
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = size
    if (h, w) == (oh, ow):
        return x
    mh = _matrix(h, oh, method, align_corners, x)
    mw = _matrix(w, ow, method, align_corners, x)
    y = torch.einsum("Hh,...hw,Ww->...HW", mh, x.to(_acc(x)), mw)
    return y.to(x.dtype)


def resize_nhwc(x: torch.Tensor, size: tuple[int, int], method: str = "bilinear",
                align_corners: bool = False) -> torch.Tensor:
    """Resize (..., H, W, C) to (..., *size, C)."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = size
    if (h, w) == (oh, ow):
        return x
    if method == "nearest":
        ih = torch.from_numpy(_nearest_index(h, oh)).to(x.device)
        iw = torch.from_numpy(_nearest_index(w, ow)).to(x.device)
        return x.index_select(-3, ih).index_select(-2, iw)
    mh = _matrix(h, oh, method, align_corners, x)
    mw = _matrix(w, ow, method, align_corners, x)
    y = torch.einsum("Hh,...hwc,Ww->...HWc", mh, x.to(_acc(x)), mw)
    return y.to(x.dtype)


def _gaussian_kernel1d(ks: int, sigma: float) -> np.ndarray:
    x = np.arange(ks, dtype=np.float64) - ks // 2
    if ks % 2 == 0:
        x = x + 0.5
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _blur_matrix(size: int, ks: int, sigma: float) -> np.ndarray:
    """[size, size] matrix of reflect-padded 1-D gaussian filtering."""
    g = _gaussian_kernel1d(ks, sigma)
    pad_front = (ks - 1) // 2
    pad_rear = (ks - 1) - pad_front
    idx = np.abs(np.arange(-pad_front, size + pad_rear))
    idx = np.where(idx >= size, 2 * (size - 1) - idx, idx)
    m = np.zeros((size, size), dtype=np.float64)
    for o in range(size):
        for tap in range(ks):
            m[o, idx[o + tap]] += g[tap]
    return m.astype(np.float32)


def gaussian_blur_hw(x: torch.Tensor, ks: tuple[int, int],
                     sigma: tuple[float, float]) -> torch.Tensor:
    """Separable reflect-padded gaussian blur over the trailing (H, W)."""
    h, w = x.shape[-2], x.shape[-1]
    acc = _acc(x)
    mh = torch.from_numpy(_blur_matrix(h, int(ks[0]), float(sigma[0]))).to(x.device, acc)
    mw = torch.from_numpy(_blur_matrix(w, int(ks[1]), float(sigma[1]))).to(x.device, acc)
    y = torch.einsum("Hh,...hw,Ww->...HW", mh, x.to(acc), mw)
    return y.to(x.dtype)


def resize_antialias_hw(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """CLIP-preprocessing resize: gaussian blur + bicubic(align_corners=True),
    sigma from the skimage heuristic, kernel size max(4*sigma, 3) made odd."""
    h, w = x.shape[-2], x.shape[-1]
    factors = (h / size[0], w / size[1])
    sigmas = (max((factors[0] - 1.0) / 2.0, 0.001), max((factors[1] - 1.0) / 2.0, 0.001))
    ks = int(max(2.0 * 2 * sigmas[0], 3)), int(max(2.0 * 2 * sigmas[1], 3))
    if ks[0] % 2 == 0:
        ks = ks[0] + 1, ks[1]
    if ks[1] % 2 == 0:
        ks = ks[0], ks[1] + 1
    x = gaussian_blur_hw(x, ks, sigmas)
    return resize_hw(x, size, method="bicubic", align_corners=True)
