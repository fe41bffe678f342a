"""ctypes binding of the native host library (`native/mofa_host.cpp`).

Counterpart of mofa_tpu/native.py. The C++ source is shared with the JAX
package as a file; this module builds its own copy, at first use, with

    g++ -O3 -shared -fPIC -ffp-contract=off native/mofa_host.cpp

into `build/libmofa_host_<hash>.so` at the repository root (beside the
CUDA kernels' library; the hash covers the source and the flags, and the
library is written under a temporary name and renamed, so a concurrent
build never loads half a file). `-ffp-contract=off` keeps the compiler
from fusing a multiply and an add, so every result equals its numpy
version bit for bit on any target.

The four entry points and their numpy versions:

- `rasterize_tracks`: `ops/rasterize.py::rasterize_trajectories`;
- `square_nms`: `train/flow_sampler.py::square_nms`;
- `neighbor_elim`: the pairwise loop of `neighbor_elim_numpy` (the coin
  flips passed in, so both agree bit for bit);
- `pchip_derivatives`: `ops/trajectory.py::_pchip_derivatives`.

Unlike the JAX binding, a failed build is not hidden: the entry points
raise `NativeLibraryError` with the compiler's message (`build_error()`
returns it, `available()` says whether the library loaded). There is no
switch to the numpy versions: a caller who wants them calls them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from mofa_tpu_torch.kernels._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "native" / "mofa_host.cpp"
FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")


class NativeLibraryError(RuntimeError):
    """The native library could not be built or loaded."""


_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libmofa_host_{h.hexdigest()[:16]}.so"


def _build() -> ctypes.CDLL:
    if not SOURCE.exists():
        raise NativeLibraryError(f"{SOURCE} not found")
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeLibraryError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeLibraryError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                                   f"{proc.stderr.strip()}")
        os.replace(tmp, out)
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        raise NativeLibraryError(f"cannot load {out}: {e}") from e
    _declare(lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded library, built on first use; raises NativeLibraryError
    (the same message on every later call) when it cannot be built."""
    global _lib, _error
    if _lib is None:
        if _error is not None:
            raise NativeLibraryError(_error)
        try:
            _lib = _build()
        except NativeLibraryError as e:
            _error = str(e)
            raise
    return _lib


def available() -> bool:
    """Whether the library built and loaded."""
    try:
        library()
    except NativeLibraryError:
        return False
    return True


def build_error() -> Optional[str]:
    """The message of the failed build, or None (not tried, or built)."""
    return _error


def _declare(lib: ctypes.CDLL) -> None:
    i64 = ctypes.c_int64
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.rasterize_tracks.argtypes = [f64p, i64, i64, i64, i64, ctypes.c_int, f64p, f64p]
    lib.square_nms.argtypes = [f32p, i64, i64, i64, f32p]
    lib.neighbor_elim.argtypes = [i64p, i64p, i64, ctypes.c_double, f32p, u8p]
    lib.pchip_derivatives.argtypes = [f64p, f64p, i64, f64p]
    for fn in (lib.rasterize_tracks, lib.square_nms, lib.neighbor_elim,
               lib.pchip_derivatives):
        fn.restype = None


def rasterize_tracks(tracks: np.ndarray, n_steps: int, H: int, W: int,
                     is_backward_flow: bool = False):
    """tracks [K, n_steps + 1, 2] (x, y) -> (sparse_flow [n_steps, H, W, 2],
    mask [n_steps, H, W]), float64; a track whose integer start lies outside
    the H x W canvas paints nothing."""
    tracks = np.ascontiguousarray(tracks, np.float64)
    if tracks.ndim != 3 or tracks.shape[1:] != (n_steps + 1, 2):
        raise ValueError(f"tracks {tracks.shape}: want [K, {n_steps + 1}, 2]")
    lib = library()
    flow = np.empty((n_steps, H, W, 2), np.float64)
    mask = np.empty((n_steps, H, W), np.float64)
    lib.rasterize_tracks(tracks, tracks.shape[0], n_steps, H, W,
                         int(is_backward_flow), flow, mask)
    return flow, mask


def square_nms(score: np.ndarray, ks: int) -> np.ndarray:
    """Zero every entry of the [h, w] score below its ks x ks local max."""
    if ks < 1 or ks % 2 != 1:
        raise ValueError(f"the NMS footprint must be odd, got {ks}")
    if np.ndim(score) != 2:
        raise ValueError(f"score {np.shape(score)}: want [h, w]")
    score = np.ascontiguousarray(score, np.float32)
    out = np.empty_like(score)
    library().square_nms(score, score.shape[0], score.shape[1], ks, out)
    return out


def neighbor_elim_numpy(rows: np.ndarray, cols: np.ndarray, d: float,
                        coins: np.ndarray) -> np.ndarray:
    """The keep mask of `neighbor_elim`, as a Python loop: for each ordered
    pair (i, j) closer than d in both axes the next coin is drawn, and while
    both are kept, i is dropped if the coin exceeds 0.5, else j."""
    keep = np.ones(len(rows), bool)
    flip = 0
    for i in range(len(rows)):
        for j in range(len(rows)):
            if abs(rows[i] - rows[j]) < d and abs(cols[i] - cols[j]) < d:
                if keep[i] and keep[j] and i != j:
                    if coins[flip] > 0.5:
                        keep[i] = False
                    else:
                        keep[j] = False
                flip += 1
    return keep


def neighbor_elim(rows: np.ndarray, cols: np.ndarray, d: float, coins: np.ndarray):
    """Randomly drop one of each point pair closer than d in both axes;
    coins: pre-drawn uniforms, at least len(rows)**2 of them. Returns the
    kept (rows, cols)."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    coins = np.ascontiguousarray(coins, np.float32)
    n = len(rows)
    if rows.shape != (n,) or cols.shape != (n,) or coins.size < n * n:
        raise ValueError(f"rows {rows.shape}, cols {cols.shape}, coins {coins.shape}: "
                         f"want [n], [n] and at least n * n coins")
    out = np.empty(n, np.uint8)
    library().neighbor_elim(rows, cols, n, float(d), coins.reshape(-1), out)
    keep = out.astype(bool)
    return rows[keep], cols[keep]


def pchip_derivatives(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """PCHIP slopes at the knots (x strictly increasing, at least 2)."""
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    if x.ndim != 1 or x.shape != y.shape or len(x) < 2:
        raise ValueError(f"x {x.shape}, y {y.shape}: want two [n] arrays, n >= 2")
    d = np.empty_like(x)
    library().pchip_derivatives(x, y, len(x), d)
    return d
