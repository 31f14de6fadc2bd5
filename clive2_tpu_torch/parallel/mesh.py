"""Tile meshes for multi-GPU rendering over ``torch.distributed`` (port of
clive2_tpu/parallel/mesh.py).

The JAX package shards the pixel wavefront over a 1-D ``tiles`` mesh axis
and lets GSPMD insert the collectives.  Here one process drives each device
(``torchrun --nproc_per_node=N``): every rank builds the same scene, renders
one band of the frame's image rows (``tile_rows``) with the random numbers
those rows draw in the whole frame's sample, and the ranks sum their
outputs (``TileMesh.all_reduce_sum``; the splat image is the only output
that crosses bands besides the filter's one-row spill).  Frames of an
animation are split across processes by apps/movie.py instead.

``make_tile_mesh`` builds the mesh; pass it to ``Renderer(scene,
mesh=...)`` or ``integrator.render.make_sharded_render``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TileMesh:
    """The process group, this process's rank in it, its size, and the
    device this rank renders on."""

    group: object
    rank: int
    size: int
    device: torch.device

    def all_reduce_sum(self, tensors):
        """Sum each tensor over the ranks, in place; one collective per
        dtype.  Returns ``tensors``."""
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
            for t, part in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(part.view_as(t))
        return tensors

    def broadcast(self, tensors):
        """Overwrite each tensor with rank 0's.  Returns ``tensors``."""
        for t in tensors:
            dist.broadcast(t, src=0, group=self.group)
        return tensors

    def barrier(self):
        """Wait for every rank (a collective on this rank's device)."""
        dist.all_reduce(torch.zeros(1, device=self.device), group=self.group)

    def check_replicated(self, tree, label: str):
        """Raise unless every rank holds the same tensors in ``tree`` (a
        nested dict): a hash of their bytes, shapes and dtypes, compared
        across ranks.  Every rank builds its own scene, so this holds the
        host BVH build to bit-identical tables."""
        h = hashlib.blake2b(digest_size=8)

        def feed(node, path):
            if isinstance(node, dict):
                for k in sorted(node):
                    feed(node[k], f"{path}/{k}")
                return
            t = node.detach().reshape(-1).cpu().contiguous()
            h.update(f"{path}:{t.dtype}:{tuple(node.shape)}".encode())
            h.update(t.view(torch.uint8).numpy().tobytes())

        feed(tree, "")
        mine = int.from_bytes(h.digest(), "little", signed=True)
        both = torch.tensor([mine, -mine], dtype=torch.int64,
                            device=self.device)
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=self.group)
        if int(both[0]) != mine or int(both[1]) != -mine:
            raise RuntimeError(f"{label} differ across the mesh's ranks "
                               f"(rank {self.rank})")


def resolve_device(device) -> torch.device:
    """``device`` with its index: a CUDA device without one is the current
    card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("make_tile_mesh: CUDA is not available; pass "
                           "devices=['cpu'] to render on the CPU")
    local = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_tile_mesh(n_devices: int | None = None, devices=None) -> TileMesh:
    """1-D mesh over the pixel-tile axis: one rank per process.

    ``devices``: the device this rank renders on; by default the card
    ``cuda:LOCAL_RANK`` (raises without a card).  The default process
    group is the mesh's group.  Unless the caller has initialised it, it is
    initialised here from the environment that ``torchrun`` sets
    (``env://``): NCCL on a card, gloo on the CPU.  Two ranks on one card
    need a gloo group that the caller initialises (NCCL refuses them).
    ``n_devices``, when given, must equal the world size.
    """
    device = _default_device() if devices is None else torch.device(devices)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_tile_mesh: CUDA is not available")
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices}, but the process group has "
                         f"{size} ranks (one process per device)")
    return TileMesh(group=dist.group.WORLD, rank=dist.get_rank(), size=size,
                    device=device)


def tile_rows(mesh: TileMesh, height: int):
    """(row0, rows) of this rank's band of ``height`` image rows: rank r
    takes rows [r*H//k, (r+1)*H//k), so any height splits, unevenly where k
    does not divide it (a rank may get no rows)."""
    r = mesh.rank
    lo = r * height // mesh.size
    return lo, (r + 1) * height // mesh.size - lo
