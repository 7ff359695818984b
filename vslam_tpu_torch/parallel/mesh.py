"""One process per device under torch.distributed (port of
vslam_tpu/parallel/mesh.py).

The JAX package shards over a named device mesh inside one program
(shard_map); the port runs one process per device, every rank the same
engine on the same frames (SPMD, as jax.distributed runs the same program
on every host), and the sharded functions combine the ranks' partial
results with collectives.  A Mesh is this rank's index, the number of
ranks and their process group; None stands for one device, where every
caller takes its unsharded path.

The landmark and database row axis is split into contiguous blocks, one
a rank (shard_rows); the row count must divide by the mesh size
(pad_to_multiple).  The process group is created by the caller:
torch.distributed.init_process_group(backend, init_method=
"tcp://localhost:<port>", world_size=..., rank=...; launch.init).
Collectives run on the tensors' device, except that under gloo (two ranks
may share one card, which NCCL refuses) CUDA tensors go through an
explicit copy to the host, whichever reductions gloo's CUDA path covers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    rank: int
    size: int
    group: object  # a torch.distributed ProcessGroup


def make_mesh(n_devices: int | None = None) -> Mesh | None:
    """The mesh of the ranks 0 .. n-1 of the initialized process group (n
    = n_devices, capped at the world size; None: every rank).  Returns
    None when no group is initialized, when it holds one rank, and on a
    rank outside the mesh.  Every rank of the world must call it (a
    subgroup is created collectively)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    n = world if n_devices is None else min(int(n_devices), world)
    if n <= 1:
        return None
    group = dist.group.WORLD if n == world else dist.new_group(ranks=list(range(n)))
    rank = dist.get_rank()
    return Mesh(rank, n, group) if rank < n else None


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0, fill=0):
    """Pad `axis` of x up to a multiple of `multiple`; returns (padded,
    original length)."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    pad = torch.full(x.shape[:axis] + (target - n,) + x.shape[axis + 1:], fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=axis), n


def shard_rows(x: torch.Tensor, mesh: Mesh | None, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous block of `axis` (the whole of x without a
    mesh).  The axis length must divide by the mesh size."""
    if mesh is None:
        return x
    n = x.shape[axis]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide across {mesh.size} ranks")
    blk = n // mesh.size
    return x.narrow(axis, mesh.rank * blk, blk)


def _via_host(t: torch.Tensor, mesh: Mesh) -> bool:
    return t.device.type != "cpu" and dist.get_backend(mesh.group) == "gloo"


def all_reduce(t: torch.Tensor, op, mesh: Mesh) -> torch.Tensor:
    """A reduced copy of t over the mesh (op: dist.ReduceOp.SUM, MIN, ...)."""
    if _via_host(t, mesh):
        h = t.detach().cpu().clone()
        dist.all_reduce(h, op=op, group=mesh.group)
        return h.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out, op=op, group=mesh.group)
    return out


def all_gather_rows(t: torch.Tensor, mesh: Mesh, axis: int = 0) -> torch.Tensor:
    """Every rank's block of `axis`, concatenated in rank order (the
    inverse of shard_rows)."""
    src = t.detach().cpu().contiguous() if _via_host(t, mesh) else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts, dim=axis).to(t.device)
