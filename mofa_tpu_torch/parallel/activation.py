"""Frame-parallel inference: the context and its collectives.

Counterpart of mofa_tpu/parallel/activation.py. Inside `frame_parallel`
the UNet and the adapter trunk shard dim 0 of their [B*T, ...]
activations over the mesh's "frames" axis (the JAX package's "frames"
policy):

- per-frame work runs on each rank's own rows: convs, the spatial
  GroupNorms, spatial attention, the feed-forwards, the adapter's warp.
  Each rank launches the CUDA kernels on its own rows;
- the temporal layers need every frame of a spatial token, so each
  temporal site swaps the sharded axis: `frames_to_tokens` (the Ulysses
  all-to-all) gives each rank all B*T rows of its slice of the tokens,
  the temporal block runs there, and `tokens_to_frames` swaps back. The
  temporal resnet's GroupNorm pools over the sharded tokens, so its sums
  are reduced across the group (`all_reduce_stats`);
- the UNet gathers its output once (`all_gather_frames`).

Shards are uneven where the sizes do not divide (a CFG batch of 2 x 25
frames over 4 ranks is 13/13/12/12 rows): the all-to-all takes explicit
split sizes, so nothing is padded. A world larger than the rows raises.
A token count smaller than the world (a 1 x 1 latent at test widths) is
not split: every rank gathers all rows and runs that temporal site whole.

The JAX package's default "tokens" policy shards the spatial token dim
everywhere, which GSPMD needs because it replicates an uneven reshard.
By hand it would need halo exchanges in every 3x3 conv; it is not
ported (`frame_parallel(policy="tokens")` raises). The JAX package's
`sharded_execution` route-around of its kernels has no counterpart:
shards here are ordinary local tensors, so the kernels run on them.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist
import torch.nn as nn

from mofa_tpu_torch.core.mesh import AXES, shard_range, split_sizes

POLICIES = ("frames",)


@dataclasses.dataclass(frozen=True)
class FrameContext:
    policy: str
    group: object
    rank: int            # rank within the frames group
    size: int            # ranks in the frames group


@dataclasses.dataclass(frozen=True)
class TokenSlice:
    """The tokens [start, stop) of `total` a rank holds after
    `frames_to_tokens`; split False: every rank holds all of them."""
    start: int
    stop: int
    total: int
    split: bool


_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "mofa_frame_parallel", default=None)


@contextlib.contextmanager
def frame_parallel(mesh, axis: str = AXES.frames, policy: str = "frames"):
    """Shard the models' [B*T, ...] activations over `axis` of `mesh` (a
    DeviceMesh from core.mesh.make_mesh) while the context is open."""
    if policy not in POLICIES:
        raise ValueError(
            f"frame_parallel policy {policy!r} is not ported (the token "
            f"policy is ROADMAP Queue 1 item 13c); policies: {POLICIES}")
    sub = mesh[axis]
    ctx = FrameContext(policy, sub.get_group(), sub.get_local_rank(), sub.size())
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def frame_ctx_active() -> bool:
    """True inside a frame_parallel context."""
    return _CTX.get() is not None


def sharding_policy():
    """"frames" inside a frame_parallel context, else None."""
    ctx = _CTX.get()
    return None if ctx is None else ctx.policy


def current() -> FrameContext:
    ctx = _CTX.get()
    if ctx is None:
        raise RuntimeError("no frame_parallel context is open")
    return ctx


def row_range(total: int) -> tuple[int, int]:
    """This rank's rows [start, stop) of a [total, ...] frame batch."""
    ctx = current()
    return shard_range(total, ctx.size, ctx.rank)


def local_rows(x: torch.Tensor, total: int) -> torch.Tensor:
    """This rank's rows of a per-frame tensor: `x` holds all `total` rows
    (they are sliced) or already only this rank's (returned as is)."""
    start, stop = row_range(total)
    if x.shape[0] == total:
        return x[start:stop]
    if x.shape[0] == stop - start:
        return x
    raise ValueError(f"a per-frame tensor of {x.shape[0]} rows is neither "
                     f"the batch ({total}) nor this rank's {stop - start}")


def _per_token(x: torch.Tensor, dim: int) -> int:
    return x[0].numel() // x.shape[dim]


def all_gather_frames(x: torch.Tensor, total: int) -> torch.Tensor:
    """Every rank's rows of a [total, ...] batch, in order, on every rank."""
    ctx = current()
    rows = split_sizes(total, ctx.size)
    if x.shape[0] != rows[ctx.rank]:
        raise ValueError(f"rank {ctx.rank} holds {x.shape[0]} rows, not "
                         f"{rows[ctx.rank]} of {total}")
    most = rows[0]
    x = x.contiguous()
    if x.shape[0] < most:
        x = torch.cat([x, x.new_zeros((most - x.shape[0],) + x.shape[1:])])
    parts = [torch.empty_like(x) for _ in rows]
    dist.all_gather(parts, x, group=ctx.group)
    return torch.cat([p[:r] for p, r in zip(parts, rows)])


def token_slice(n_tok: int) -> TokenSlice:
    """The tokens of `n_tok` this rank holds after `frames_to_tokens`."""
    ctx = current()
    if n_tok < ctx.size:
        return TokenSlice(0, n_tok, n_tok, False)
    return TokenSlice(*shard_range(n_tok, ctx.size, ctx.rank), n_tok, True)


def frames_to_tokens(x: torch.Tensor, total: int, dim: int):
    """[rows_local, ...] (this rank's frames, all tokens along `dim`) ->
    ([total, ...] with this rank's tokens along `dim`, TokenSlice): one
    all-to-all over the frames group."""
    ctx = current()
    rows = split_sizes(total, ctx.size)
    n_tok = x.shape[dim]
    if x.shape[0] != rows[ctx.rank]:
        raise ValueError(f"rank {ctx.rank} holds {x.shape[0]} rows, not "
                         f"{rows[ctx.rank]} of {total}")
    tokens = token_slice(n_tok)
    if not tokens.split:
        return all_gather_frames(x, total), tokens
    toks = split_sizes(n_tok, ctx.size)
    per = _per_token(x, dim)
    send = torch.cat([p.contiguous().reshape(-1) for p in x.split(toks, dim)])
    out_splits = [r * per * toks[ctx.rank] for r in rows]
    recv = x.new_empty(sum(out_splits))
    dist.all_to_all_single(recv, send, out_splits,
                           [rows[ctx.rank] * per * t for t in toks],
                           group=ctx.group)
    shape = list(x.shape)
    shape[0], shape[dim] = total, toks[ctx.rank]
    return recv.reshape(shape), tokens


def tokens_to_frames(y: torch.Tensor, tokens: TokenSlice, dim: int) -> torch.Tensor:
    """The inverse of `frames_to_tokens`: [total, ...] with this rank's
    tokens -> [rows_local, ...] with all of them."""
    ctx = current()
    total = y.shape[0]
    if not tokens.split:
        start, stop = row_range(total)
        return y[start:stop]
    rows = split_sizes(total, ctx.size)
    toks = split_sizes(tokens.total, ctx.size)
    per = _per_token(y, dim)
    out_splits = [rows[ctx.rank] * per * t for t in toks]
    recv = y.new_empty(sum(out_splits))
    dist.all_to_all_single(recv, y.contiguous().reshape(-1), out_splits,
                           [r * per * toks[ctx.rank] for r in rows],
                           group=ctx.group)
    shape = list(y.shape)
    shape[0] = rows[ctx.rank]
    pieces = []
    for piece, t in zip(recv.split(out_splits), toks):
        shape[dim] = t
        pieces.append(piece.reshape(shape))
    return torch.cat(pieces, dim)


def all_reduce_stats(stats: torch.Tensor, tokens: TokenSlice) -> torch.Tensor:
    """Sum partial statistics (GroupNorm sums) over the ranks sharing the
    tokens; unchanged when the tokens were not split."""
    if tokens.split:
        dist.all_reduce(stats, group=current().group)
    return stats


def _group_src(group) -> int:
    return dist.get_global_rank(group, 0) if group is not None else 0


def broadcast_tensors_(tensors, group=None) -> None:
    """Overwrite each tensor with the group's first rank's copy."""
    src = _group_src(group)
    for t in tensors:
        dist.broadcast(t, src=src, group=group)


def broadcast_module_(module: nn.Module, group=None) -> nn.Module:
    """Give every rank the first rank's parameters and buffers, byte for
    byte (in place)."""
    with torch.no_grad():
        broadcast_tensors_([t.data for t in module.parameters()]
                           + [t for t in module.buffers()], group)
    return module


def replicate(x: torch.Tensor) -> torch.Tensor:
    """`x` as the frames group's first rank holds it (a copy on every rank
    of the same bytes; the latents and encodings a sharded call reads)."""
    y = x.contiguous().clone()
    broadcast_tensors_([y], current().group)
    return y
