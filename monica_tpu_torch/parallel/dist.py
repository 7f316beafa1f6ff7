"""The sharded classify step and the process group — counterpart of
``monica_tpu/parallel/dist.py``.

Every cell of a mesh row classifies the row's reads against its own index
shards; the row's hits are gathered over the index axis in rank-major
order (each rank's shards in size-class order, as the JAX package's
``all_gather`` lays them out), merged per read with ``merge_hits`` and
counted.  Cells in one process meet by ``.to(row device)`` and
``torch.stack``; cells of several processes by ``all_gather`` on the
row's process group.  The ``gloo`` backend moves CUDA tensors through
the host for that gather (by the backend's name: it is the route for two
processes on one card, which NCCL refuses).  Counts come back per data
row, each row's computed once: the JAX step's "index rank 0 mask, then
psum over the index axis".

``multihost_init`` starts ``torch.distributed`` with the backend the
caller names, plus one ``gloo`` group for the host-side control plane
(the batch schedule, the sample count and ``watch``'s idle flag), which
``process_allgather`` uses.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as tdist

from monica_tpu_torch.align import pipeline as pl

_STATE: dict = {"backend": None, "control": None}


def multihost_init(backend: str, init_method: str | None = None, world_size: int | None = None,
                   rank: int | None = None,
                   timeout: datetime.timedelta = datetime.timedelta(minutes=10)) -> None:
    """Join the process group: ``backend`` is ``nccl`` (CUDA cards, one a
    process) or ``gloo`` (the CPU, or several processes on one card);
    ``init_method`` e.g. ``tcp://host:port`` (None: the ``env://``
    variables MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).  A collective
    that waits longer than ``timeout`` fails instead of hanging."""
    tdist.init_process_group(backend, init_method=init_method,
                             world_size=-1 if world_size is None else world_size,
                             rank=-1 if rank is None else rank, timeout=timeout)
    _STATE["backend"] = backend
    _STATE["control"] = None if backend == "gloo" else tdist.new_group(backend="gloo",
                                                                       timeout=timeout)


def shutdown() -> None:
    if tdist.is_initialized():
        tdist.destroy_process_group()
    _STATE.update(backend=None, control=None)


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def backend() -> str | None:
    return _STATE["backend"]


def new_group(ranks: list[int]):
    """A process group of ``ranks`` on the run's backend.  Every process
    must call it, for every group, in the same order."""
    return tdist.new_group(ranks, backend=_STATE["backend"])


def all_gather_object(obj) -> list:
    """``obj`` of every process, in process order (control plane)."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    tdist.all_gather_object(out, obj, group=_STATE["control"])
    return out


def process_allgather(arr: np.ndarray) -> np.ndarray:
    """(n_processes, *arr.shape): ``arr`` of every process, in process
    order, over the control group (one process: ``arr[None]``)."""
    arr = np.ascontiguousarray(arr)
    if process_count() == 1:
        return arr[None]
    t = torch.from_numpy(arr)
    out = [torch.empty_like(t) for _ in range(process_count())]
    tdist.all_gather(out, t, group=_STATE["control"])
    return torch.stack(out).numpy()


def _pack_hits(h: pl.ShardHit) -> torch.Tensor:
    """A ShardHit of (S, B) fields as one (10, S, B) int32 tensor: float32
    fields bit-cast, the rest widened, so one collective carries them."""
    return torch.stack([f.view(torch.int32) if f.dtype == torch.float32 else f.to(torch.int32)
                        for f in h])


def _unpack_hits(t: torch.Tensor, like: pl.ShardHit) -> pl.ShardHit:
    return pl.ShardHit(*(x.view(torch.float32) if f.dtype == torch.float32
                         else x != 0 if f.dtype == torch.bool else x.to(f.dtype)
                         for x, f in zip(t, like)))


def gather_hits(hits: pl.ShardHit, group, backend_name: str) -> pl.ShardHit:
    """``all_gather`` a row's local hits over its process group and
    concatenate them in group-rank order on the shard axis.  With
    ``gloo`` a CUDA tensor goes through a host copy."""
    dev = hits.passed.device
    t = _pack_hits(hits)
    if backend_name == "gloo":
        t = t.cpu()
    out = [torch.empty_like(t) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(out, t, group=group)
    return _unpack_hits(torch.cat(out, dim=1).to(dev), hits)


def make_sharded_classifier(mesh, params: pl.ClassifyParams, n_accessions: int,
                            count_mode: int = pl.MODE_QUERY_LENGTH, index=None):
    """The mesh step: ``step(reads)`` for a ``mesh.ShardedReads`` ->
    ({data row: ReadResult}, {data row: (n_accessions,) int32 counts}),
    for this process's rows.  ``index`` is ``mesh.shard_index``'s
    {(row, rank): size-class groups}.

    For each local row: the sketch once per device of its cells, each
    local cell's groups classified by ``pipeline.classify_groups`` (cells
    in index-rank order), the hits moved to the row's device and
    concatenated, gathered from the row's other processes, then
    ``pipeline.merge_and_count`` there: the single-device grouped step
    with the gather between its two halves."""

    def step(reads):
        results, counts = {}, {}
        for d in mesh.local_rows():
            row_dev = mesh.row_device(d)
            sketches = {}
            hits = []
            for i in mesh.local_cells(d):
                dev = mesh.devices[d][i]
                if dev not in sketches:
                    packed, lengths = reads.blocks[d][dev]
                    codes = pl.unpack_codes(packed, reads.read_len)
                    sketches[dev] = (codes, lengths, pl.sketch_batch(codes, lengths, params))
                codes, lengths, sk = sketches[dev]
                hits.append(pl.classify_groups(index[(d, i)], codes, lengths, params, sketch=sk))
            row = pl.ShardHit(*(torch.cat([f.to(row_dev) for f in fs]) for fs in zip(*hits)))
            if mesh.row_groups and mesh.row_groups[d] is not None:
                row = gather_hits(row, mesh.row_groups[d], mesh.backend)
            results[d], counts[d] = pl.merge_and_count(row, reads.blocks[d][row_dev][1], params,
                                                       n_accessions, count_mode)
        return results, counts

    return step
