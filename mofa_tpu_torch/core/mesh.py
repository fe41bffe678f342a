"""Device mesh and process-group set-up on torch.distributed.

Counterpart of mofa_tpu/core/mesh.py. The mesh has four named axes, laid
out outermost first as ("dcn", "data", "model", "frames"):

- "dcn":    data parallelism across hosts (outermost, so contiguous rank
            blocks are hosts);
- "data":   batch / data parallelism within a host;
- "model":  tensor parallelism;
- "frames": frame parallelism for inference: per-frame work runs on each
            rank's frames, and only the temporal layers communicate
            (parallel/activation.py).

Rank r sits where device r sits in the JAX mesh: the ranks in row-major
order reshaped to (dcn, data, model, frames). One process drives one
device. `init_distributed` sets up the default process group: from a
launcher's RANK / WORLD_SIZE / LOCAL_RANK (torchrun) or, with none, as a
world of one. NCCL on a CUDA device, gloo on the CPU; it never falls back
from NCCL to gloo.

`replicated`, `frame_sharded` and `data_sharded` name the part of a
[B, T, ...] tensor a rank holds: all of it, its frames, or its batch rows.
Shards are as even as the size allows (`split_sizes`): the first
`size % n` ranks hold one row more.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dcn: str = "dcn"
    data: str = "data"
    model: str = "model"
    frames: str = "frames"

    @property
    def batch(self) -> tuple[str, str]:
        """The axes a batch dim shards over jointly: outer x inner data
        parallelism (plain "data" when dcn is 1)."""
        return (self.dcn, self.data)

    @property
    def names(self) -> tuple[str, str, str, str]:
        return (self.dcn, self.data, self.model, self.frames)


AXES = MeshAxes()

# torch.distributed's init method when no launcher set MASTER_ADDR; a
# "file://" URL lets ranks started by other means (a test's processes)
# meet without a port
INIT_METHOD_ENV = "MOFA_INIT_METHOD"


def mesh_shape(world: int, data: int = 1, frames: int = -1, model: int = 1,
               dcn: int = 1) -> tuple[int, int, int, int]:
    """(dcn, data, model, frames) for `world` ranks; frames=-1 takes the
    rest. Raises ValueError when the product is not the world size."""
    if frames == -1:
        if world % (dcn * data * model):
            raise ValueError(f"mesh {dcn}x{data}x{model}x? does not divide "
                             f"{world}")
        frames = world // (dcn * data * model)
    if dcn * data * model * frames != world:
        raise ValueError(f"mesh {dcn}x{data}x{model}x{frames} != {world}")
    return dcn, data, model, frames


def rank_layout(world: int, data: int = 1, frames: int = -1, model: int = 1,
                dcn: int = 1) -> np.ndarray:
    """The ranks as a (dcn, data, model, frames) array: rank r at the
    position of device r in the JAX package's mesh."""
    return np.arange(world).reshape(mesh_shape(world, data, frames, model, dcn))


def make_mesh(data: int = 1, frames: int = -1, model: int = 1, dcn: int = 1,
              device_type: str | None = None):
    """A DeviceMesh with dims ("dcn", "data", "model", "frames") over the
    default process group (init_distributed first). device_type defaults
    to "cuda" under NCCL and "cpu" otherwise."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed first")
    layout = rank_layout(dist.get_world_size(), data, frames, model, dcn)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.from_numpy(layout),
                      mesh_dim_names=AXES.names)


def init_distributed(device) -> torch.device:
    """Join (or start) the default process group for `device` and return
    the device this rank drives.

    Under a launcher (RANK and WORLD_SIZE set) the rank, world size and
    LOCAL_RANK come from the environment, and a CUDA device becomes
    cuda:LOCAL_RANK. With none, this process is a world of one, met
    through a FileStore in a new temporary directory. The init method is
    `MOFA_INIT_METHOD` when set, else env:// under a launcher. The backend
    is NCCL for a CUDA device and gloo for the CPU."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"frame parallelism runs on cuda or cpu, not {device}")
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for NCCL")
        if launched:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        elif device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}; "
                               f"{device} needs {backend}")
        return device
    kw = {}
    if backend == "nccl":
        kw["device_id"] = device
    init = os.environ.get(INIT_METHOD_ENV)
    if launched:
        dist.init_process_group(backend, init_method=init or "env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]), **kw)
    elif init:
        dist.init_process_group(backend, init_method=init, rank=0,
                                world_size=1, **kw)
    else:
        path = os.path.join(tempfile.mkdtemp(prefix="mofa_pg_"), "store")
        dist.init_process_group(backend, store=dist.FileStore(path, 1),
                                rank=0, world_size=1, **kw)
    return device


def is_main_rank() -> bool:
    """True outside a process group and on its rank 0: the one rank that
    writes files and prints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def split_sizes(size: int, parts: int) -> list[int]:
    """`size` rows over `parts` ranks, as even as possible (the first
    size % parts ranks hold one more). Raises when a rank would hold none."""
    if parts > size:
        raise ValueError(f"{size} rows cannot be shared by {parts} ranks")
    q, r = divmod(size, parts)
    return [q + (i < r) for i in range(parts)]


def shard_range(size: int, parts: int, index: int) -> tuple[int, int]:
    """[start, stop) of shard `index` of `size` rows over `parts` ranks."""
    sizes = split_sizes(size, parts)
    start = sum(sizes[:index])
    return start, start + sizes[index]


def _axis_slice(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    parts, index = 1, 0
    for name in axes:
        sub = mesh[name]
        index = index * sub.size() + sub.get_local_rank()
        parts *= sub.size()
    start, stop = shard_range(x.shape[dim], parts, index)
    return x.narrow(dim, start, stop - start)


def replicated(mesh, x: torch.Tensor) -> torch.Tensor:
    """The whole tensor: every rank holds all of it."""
    del mesh
    return x


def frame_sharded(mesh, x: torch.Tensor, frame_axis: int = 1) -> torch.Tensor:
    """This rank's part of a [B, T, ...] tensor: its batch rows over the
    (dcn, data) axes and its frames over "frames"."""
    x = _axis_slice(x, mesh, AXES.batch, 0)
    return _axis_slice(x, mesh, (AXES.frames,), frame_axis)


def data_sharded(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's batch rows over the joint (dcn, data) axes."""
    return _axis_slice(x, mesh, AXES.batch, 0)
