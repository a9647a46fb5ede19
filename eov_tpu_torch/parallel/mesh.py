"""The ('data', 'frame') mesh over the ranks of the initialized world.

Counterpart of ``eov_tpu/parallel/mesh.py``. Axes:

    'data'  — clips / episodes (the embarrassingly parallel axis)
    'frame' — the segment frames of a clip (the sequence-parallel analog;
              usually 1)

'frame' is innermost: rank = data_index * n_frame + frame_index, so the
frame ranks of one data row are neighbours (one host's GPUs under
torchrun). Each rank is one process on one device; the mesh holds the
process groups its collectives run over: ``frame_group`` (the ranks of
this rank's data row) and ``data_group`` (the ranks with this rank's frame
index). Without an initialized process group the mesh is the world of one
(``1 x 1``) and its groups are None; the collectives of
``parallel.distributed`` are then the identity.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

DATA_AXIS = "data"
FRAME_AXIS = "frame"

__all__ = ["Mesh", "make_mesh", "DATA_AXIS", "FRAME_AXIS"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    n_data: int
    n_frame: int
    rank: int
    frame_group: object = None  # ProcessGroup of this data row, or None
    data_group: object = None   # ProcessGroup of this frame column, or None

    @property
    def size(self) -> int:
        return self.n_data * self.n_frame

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, FRAME_AXIS: self.n_frame}

    @property
    def data_index(self) -> int:
        return self.rank // self.n_frame

    @property
    def frame_index(self) -> int:
        return self.rank % self.n_frame


def make_mesh(n_data: int | None = None, n_frame: int = 1) -> Mesh:
    """('data', 'frame') mesh over every rank of the world.

    ``n_data`` defaults to world_size // n_frame; sizes that do not divide
    the world (or need more ranks than it has) are refused, as the
    reference's ``make_mesh`` refuses them for devices. Every rank must
    call this with the same sizes (it creates process groups).
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_frame < 1 or (n_data is not None and n_data < 1):
        raise ValueError(f"mesh sizes must be >= 1 (data={n_data}, "
                         f"frame={n_frame})")
    if n_data is None:
        if world % n_frame:
            raise ValueError(f"world of {world} ranks not divisible by "
                             f"n_frame={n_frame}")
        n_data = world // n_frame
    if n_data * n_frame != world:
        raise ValueError(f"mesh data={n_data} x frame={n_frame} needs "
                         f"{n_data * n_frame} ranks; the world has {world}")
    if world == 1:
        return Mesh(1, 1, 0)
    frame_group = data_group = None
    # Every rank creates every group, in the same order.
    for d in range(n_data):
        g = dist.new_group([d * n_frame + f for f in range(n_frame)])
        if d == rank // n_frame:
            frame_group = g
    for f in range(n_frame):
        g = dist.new_group([d * n_frame + f for d in range(n_data)])
        if f == rank % n_frame:
            data_group = g
    return Mesh(n_data, n_frame, rank, frame_group, data_group)
