"""Build and load the package's CUDA kernels (nvcc -> shared library -> ctypes).

All sources under `mofa_tpu_torch/csrc/*.cu` compile in ONE nvcc call for
`sm_90a` into `build/libmofa_kernels_<hash>.so` at the repository root (the
hash covers every source, so an edited kernel never loads a stale build).
The library exposes a plain C interface: every pointer and the stream are
`void*`, every C entry returns `cudaGetLastError()` after its launch.

Nothing here runs at import: `library()` builds on first use, which only
happens when a wrapper receives a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"

_P, _I = ctypes.c_void_p, ctypes.c_int

# C entry points: name -> argtypes (restype is c_int = cudaError_t)
_SIGNATURES = {
    "mofa_softsplat_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "mofa_tmajor_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "mofa_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "mofa_ln_geglu_ffn": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmofa_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile every kernel source into the shared library (if absent)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-lineinfo", "-I", str(CSRC), "-o", str(tmp)]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += [str(s) for s in _sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, device, *args) -> None:
    """Call C entry `name` on `device` and its current stream; raise on a
    CUDA error."""
    import torch

    fn = getattr(library(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
