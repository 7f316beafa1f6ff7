"""Device meshes — counterpart of ``monica_tpu/parallel/mesh.py``.

The classify step runs on a 2-D grid of devices:

* the ``data`` axis splits each read batch into row blocks, one per
  grid row;
* the ``index`` axis deals the index shards over the cells of a row
  (``pipeline.stack_mesh_shard_groups``); the cells' hits for the row's
  reads are gathered and merged (``dist.make_sharded_classifier``).

A :class:`Mesh` is a plain grid of ``torch.device``: a list of per-cell
tensors takes the place of one sharded array.  Devices may repeat (the
CPU in the tests, ``cuda:0`` several times on one card): each cell keeps
its own index rank, and cells on the same device share one copy of it.
In a multi-process run (``dist.multihost_init``) the grid spans every
process's devices in process order, as the JAX package's global mesh
does, and each cell records the process that holds it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.io import encode as enc
from monica_tpu_torch.parallel import dist

DATA_AXIS = "data"
INDEX_AXIS = "index"


@dataclass(frozen=True)
class Mesh:
    """An (n_data, n_index) grid of devices.  ``owners`` holds the
    process rank of each cell, ``rank`` and ``world_size`` this process's
    place in the run, ``backend`` the collective backend of the hit
    gather (None in one process) and ``row_groups`` the process group of
    each row whose cells lie in several processes (None otherwise)."""

    devices: tuple[tuple[torch.device, ...], ...]
    owners: tuple[tuple[int, ...], ...]
    rank: int = 0
    world_size: int = 1
    backend: str | None = None
    row_groups: tuple = field(default=(), compare=False, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices), INDEX_AXIS: len(self.devices[0])}

    def is_local(self, d: int, i: int) -> bool:
        return self.owners[d][i] == self.rank

    def local_cells(self, d: int) -> list[int]:
        """The index ranks of row ``d`` that this process holds."""
        return [i for i in range(len(self.devices[d])) if self.is_local(d, i)]

    def local_rows(self) -> list[int]:
        """The data rows with at least one cell in this process."""
        return [d for d in range(len(self.devices)) if self.local_cells(d)]

    def row_device(self, d: int) -> torch.device:
        """Where row ``d``'s hits are merged and counted: the device of
        its first local cell."""
        return self.devices[d][self.local_cells(d)[0]]


def make_mesh(n_data: int | None = None, n_index: int = 1, *, devices) -> Mesh:
    """A (data, index) mesh over ``devices``, this process's devices in
    the order they fill the grid (row-major).  ``n_data`` None takes
    every device; a grid smaller than the device list takes the first
    ones.  In a multi-process run every process calls it with its own
    devices: the grid is filled with process 0's devices, then process
    1's, and so on, and a row that spans processes gets a process group
    for its hit gather (created here, in the same order on every
    process)."""
    devices = [torch.device(d) for d in devices]
    rank, world = dist.process_index(), dist.process_count()
    if world > 1:
        everyone = dist.all_gather_object([str(d) for d in devices])
        cells = [(torch.device(d), p) for p, devs in enumerate(everyone) for d in devs]
    else:
        cells = [(d, 0) for d in devices]
    n = len(cells)
    if n_data is None:
        if n % n_index:
            raise ValueError(f"{n} devices not divisible by index={n_index}")
        n_data = n // n_index
    if n_data * n_index > n:
        raise ValueError(f"a ({n_data}, {n_index}) mesh needs {n_data * n_index} devices, "
                         f"{n} given")
    cells = cells[: n_data * n_index]
    grid = [cells[d * n_index : (d + 1) * n_index] for d in range(n_data)]
    groups = []
    for row in grid:
        procs = sorted({p for _, p in row})
        per = [sum(1 for _, p in row if p == q) for q in procs]
        if len(set(per)) > 1:
            raise ValueError(f"a mesh row must hold as many cells in each of its processes: {per}")
        # each process's cells of a row are contiguous, in process order, so
        # gathering by group rank keeps the index ranks in order
        groups.append(dist.new_group(procs) if len(procs) > 1 else None)
    return Mesh(
        devices=tuple(tuple(d for d, _ in row) for row in grid),
        owners=tuple(tuple(p for _, p in row) for row in grid),
        rank=rank, world_size=world,
        backend=dist.backend() if world > 1 else None,
        row_groups=tuple(groups),
    )


def upload(arr: np.ndarray, device) -> torch.Tensor:
    """Host array -> ``device``.  On a card the copy is non_blocking from
    pinned memory; PyTorch's pinned-memory allocator does not reuse the
    staging block before the copy has run, so dropping it here is safe."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


class ShardedReads(NamedTuple):
    """A read batch placed on a mesh: per local data row, per distinct
    device of the row's local cells, the row block's 2-bit packed codes
    (b, ceil(L/4)) uint8 and lengths (b,) int32."""

    blocks: dict[int, dict[torch.device, tuple[torch.Tensor, torch.Tensor]]]
    read_len: int


def shard_reads(mesh: Mesh, codes: np.ndarray, lengths: np.ndarray) -> ShardedReads:
    """Place a host read batch on the mesh: its rows split into one block
    per local data row, each block uploaded 2-bit packed (4 bases a byte,
    as the single-device path sends it) to the devices of its row.

    Host-batch contract (multi-process): each process passes only the
    rows of ITS data rows, the concatenation of their blocks in row
    order; the global batch is the process-order concatenation, and
    every process passes the same shape (pad the last batch: length-0
    rows are masked).  Processes that share a data row (an index axis
    across processes) pass the same rows for it."""
    rows = mesh.local_rows()
    if codes.shape[0] % len(rows):
        raise ValueError(f"{codes.shape[0]} rows do not split into {len(rows)} data rows")
    b = codes.shape[0] // len(rows)
    packed = enc.pack_codes_2bit(codes)
    lengths = np.asarray(lengths, dtype=np.int32)
    blocks = {}
    for k, d in enumerate(rows):
        sl = slice(k * b, (k + 1) * b)
        blocks[d] = {}
        for i in mesh.local_cells(d):
            dev = mesh.devices[d][i]
            if dev not in blocks[d]:
                blocks[d][dev] = (upload(packed[sl], dev), upload(lengths[sl], dev))
    return ShardedReads(blocks, codes.shape[1])


def shard_index(mesh: Mesh, shards) -> tuple[dict, int]:
    """Every local cell's index rank: ``stack_mesh_shard_groups`` builds
    each rank once, on the first local device of its index column, and a
    cell on another device gets a device copy of it.  Returns
    ({(d, i): tuple of stacked groups}, the common tag width)."""
    n_data, n_index = mesh.shape[DATA_AXIS], mesh.shape[INDEX_AXIS]
    local = [(d, i) for d in range(n_data) for i in mesh.local_cells(d)]
    first = [next((mesh.devices[d][j] for d, j in local if j == i), None)
             for i in range(n_index)]
    groups, tag_bits = pl.stack_mesh_shard_groups(shards, n_index, first)
    copies: dict[tuple[int, torch.device], tuple] = {}
    index = {}
    for d, i in local:
        dev = mesh.devices[d][i]
        if dev == first[i]:
            index[(d, i)] = tuple(g[i] for g in groups)
            continue
        if (i, dev) not in copies:
            copies[(i, dev)] = tuple(pl.DeviceIndexShard(*(t.to(dev) for t in g[i]))
                                     for g in groups)
        index[(d, i)] = copies[(i, dev)]
    return index, tag_bits
