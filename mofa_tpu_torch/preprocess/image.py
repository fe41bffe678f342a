"""Image files in and out of numpy without PIL: read, resize and crop as Pillow does.

The inference CLIs' image handling, for installations that have cv2 but
no PIL:

- `read_image(path, mode)`: "RGB" -> uint8 [H, W, 3], "L" -> uint8
  [H, W], through `cv2.imread` (colour, EXIF orientation ignored, as
  PIL's `Image.open` ignores it). "L" is Pillow's RGB -> L conversion
  (ITU-R 601-2 luma in 16-bit fixed point, `Convert.c`'s L24) applied to
  the colour image, so it equals `Image.open(path).convert("L")`, not
  cv2's own grey conversion. PNG decodes to the same pixels in both
  libraries; JPEG decoders (libjpeg builds, IDCT and upsampling choices)
  may differ by a few LSB, which is outside this module's control.
  Alpha is dropped, as `convert("RGB")` drops it. `decode_image(data,
  mode)` does the same for an encoded image in memory (the browser UI's
  data URLs).
- `pil_resize(img, (w, h), filter)`: `Image.resize` for uint8 RGB or L
  images, bit for bit: NEAREST as Pillow's affine nearest (the source
  index floor of a position summed step by step in double precision),
  BILINEAR and BICUBIC (a = -0.5) as `Resample.c`: the filter's support
  widened by the downscale factor, each output pixel's weights
  normalised in double precision and then rounded to 22-bit fixed
  point, a horizontal then a vertical pass, each rounded (+2^21, >> 22)
  and clipped to uint8 (a pass is skipped where that axis keeps its
  size).
- `pil_crop(img, (left, upper, right, lower))`: `Image.crop`, zeros where
  the box reaches outside the image.
"""

from __future__ import annotations

import numpy as np

NEAREST, BILINEAR, BICUBIC = "nearest", "bilinear", "bicubic"
PRECISION_BITS = 32 - 8 - 2      # Resample.c's fixed point for 8-bit images


def read_image(path: str, mode: str = "RGB") -> np.ndarray:
    """An image file -> uint8 [H, W, 3] ("RGB") or [H, W] ("L")."""
    import cv2
    bgr = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    if bgr is None:
        raise FileNotFoundError(f"cannot read an image from {path!r}")
    return _from_bgr(bgr, mode)


def decode_image(data: bytes, mode: str = "RGB") -> np.ndarray:
    """An encoded image (PNG, JPEG, ... bytes) -> uint8 [H, W, 3] ("RGB")
    or [H, W] ("L"), decoded as `read_image` decodes a file."""
    import cv2
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8),
                       cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
    if bgr is None:
        raise ValueError(f"cannot decode an image from {len(data)} bytes")
    return _from_bgr(bgr, mode)


def _from_bgr(bgr: np.ndarray, mode: str) -> np.ndarray:
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    if mode == "RGB":
        return rgb
    if mode == "L":
        return rgb_to_l(rgb)
    raise ValueError(f"mode {mode!r}: 'RGB' or 'L'")


def rgb_to_l(rgb: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] -> [H, W], Pillow's L24: (R*19595 + G*38470 +
    B*7471 + 0x8000) >> 16."""
    c = rgb.astype(np.int64)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _bilinear(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x, a: float = -0.5):
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


_FILTERS = {BILINEAR: (_bilinear, 1.0), BICUBIC: (_bicubic, 2.0)}


def resample_weights(in_size: int, out_size: int, filt: str) -> np.ndarray:
    """Resample.c's precompute_coeffs + normalize_coeffs_8bpc: the integer
    weights [out_size, in_size] (22-bit fixed point) of one axis."""
    fn, support = _FILTERS[filt]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    w = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        k = fn((np.arange(xmin, xmax) - center + 0.5) * (1.0 / filterscale))
        total = np.add.accumulate(k)[-1] if len(k) else 0.0   # C's order
        w[xx, xmin:xmax] = k / total if total != 0.0 else k
    # C's (int)(x +- 0.5): round half away from zero
    return np.trunc(w * (1 << PRECISION_BITS) + np.where(w < 0, -0.5, 0.5))


def _pass(img: np.ndarray, weights: np.ndarray, axis: int) -> np.ndarray:
    """One rounded pass along `axis` (0 rows, 1 columns) of uint8 [H, W, C].

    The products and sums are integers below 2^53, so the float64 matmul
    is exact in any order; floor((s + 2^21) / 2^22) is the C pass's
    arithmetic shift."""
    x = np.moveaxis(img, axis, 0).astype(np.float64)
    s = np.tensordot(weights, x, axes=(1, 0))
    out = np.floor((s + (1 << (PRECISION_BITS - 1))) / (1 << PRECISION_BITS))
    return np.moveaxis(np.clip(out, 0, 255).astype(np.uint8), 0, axis)


def nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's NEAREST source index for each output index: floor((i + 0.5)
    * in / out), the position summed step by step in double precision as
    Pillow sums it (so 4.5 * 256/384 lands just below 3)."""
    step = in_size / out_size
    pos = np.add.accumulate(np.r_[0.5 * step, np.full(out_size - 1, step)])
    return np.minimum(pos.astype(np.int64), in_size - 1)


def pil_resize(img: np.ndarray, size, resample: str = BICUBIC) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] -> the same at size = (width, height), as
    Pillow's `Image.resize(size, resample)`."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"pil_resize takes uint8 images, not {img.dtype}")
    out_w, out_h = int(size[0]), int(size[1])
    in_h, in_w = img.shape[:2]
    if (out_w, out_h) == (in_w, in_h):
        return img.copy()
    if resample == NEAREST:
        return img[nearest_index(in_h, out_h)][:, nearest_index(in_w, out_w)]
    flat = img if img.ndim == 3 else img[..., None]
    if out_w != in_w:
        flat = _pass(flat, resample_weights(in_w, out_w, resample), 1)
    if out_h != in_h:
        flat = _pass(flat, resample_weights(in_h, out_h, resample), 0)
    return flat if img.ndim == 3 else flat[..., 0]


def pil_crop(img: np.ndarray, box) -> np.ndarray:
    """`Image.crop(box)`, box = (left, upper, right, lower) in pixels; the
    part outside the image is zero."""
    left, upper, right, lower = (int(v) for v in box)
    h, w = img.shape[:2]
    out = np.zeros((lower - upper, right - left) + img.shape[2:], img.dtype)
    y0, y1 = max(upper, 0), min(lower, h)
    x0, x1 = max(left, 0), min(right, w)
    if y1 > y0 and x1 > x0:
        out[y0 - upper:y1 - upper, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    return out
