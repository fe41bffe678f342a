"""Build and load the package's CUDA kernels (nvcc -> shared library -> ctypes).

Every source under `mofa_tpu_torch/csrc/*.cu` compiles for `sm_90a` in its
own nvcc process, all started together, and one more nvcc links the objects
into `build/libmofa_kernels_<hash>.so` at the repository root (the hash
covers every source, so an edited kernel never loads a stale build).
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
    "mofa_softsplat": [_P] * 5 + [_I] * 6 + [_P],
    "mofa_softsplat_normalize": [_P] * 3 + [_I] * 4 + [_P],
    "mofa_tmajor_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "mofa_flash_attention": [_P] * 5 + [_I] * 6 + [_P],
    "mofa_ln_geglu_ffn": [_P] * 11 + [_I] * 5 + [_P],
    "mofa_geglu_ffn": [_P] * 7 + [_I] * 2 + [_P],
    "mofa_ffn_ln_rows": [_P] * 4 + [_I, _I, _P],
    "mofa_ffn_gemm_gate": [_P] * 4 + [_I] * 4 + [_P],
    "mofa_ffn_gemm_out": [_P] * 5 + [_I] * 2 + [_P],
    "mofa_short_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mofa_channel_sums": [_P, _P, _P, _I, _I, _I, _I, _P],
    "mofa_gn_silu_conv3x3": [_P] * 11 + [_I] * 6 + [_P],
    "mofa_gn_silu_act": [_P] * 4 + [_I] * 5 + [_P],
    "mofa_conv3x3_gemm": [_P] * 8 + [_I] * 5 + [_P],
    "mofa_tconv3_gemm": [_P] * 8 + [_I] * 5 + [_P],
    "mofa_gn_silu_tconv3": [_P] * 11 + [_I] * 6 + [_P],
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
    objdir = out.with_suffix(f".{os.getpid()}.objs")
    objdir.mkdir(parents=True, exist_ok=True)
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-lineinfo", "-I", str(CSRC)]
    if verbose:
        flags += ["-Xptxas", "-v"]
    nvcc = _nvcc()
    objs, procs = [], []
    for src in _sources():
        obj = objdir / f"{src.stem}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *flags, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{err}")
        elif verbose and err:
            print(f"--- {src.name}\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    shutil.rmtree(objdir, ignore_errors=True)
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
