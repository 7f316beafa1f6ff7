"""Classification runtime — counterpart of ``monica_tpu/align/runtime.py``:
the ``Classifier`` (an index of any shard count, stacked by size class
on one device or dealt over a device mesh) and the streaming runtime.

* scan the query folder for non-empty ``*.fastq`` samples, consume and
  DELETE each after processing, so re-invoking a pass is idempotent;
* route every read to ``mapped/`` (id rewritten to its tax unit),
  ``unmapped/`` or ``ambiguous/`` FASTQs under the query folder, plus a
  copy to ``focus/`` when its tax unit is a focus species;
* count by mode (basic / query_length / matching) per accession and
  merge into the cross-pass accumulator (``alignment.npz``) in the
  output folder;
* quarantine a sample that fails to ``failed/`` and go on;
* signal progress with empty sentinel files for external watchers.

``run_once`` over several samples overlaps the host stages across
samples in a 3-stage thread pipeline (parse on workers, dispatch on the
caller thread, fetch and routing on workers); samples above
:data:`MAX_RESIDENT_BYTES` stream through bounded chunks instead.
Everything runs on the device's default stream, which every thread
shares, so a fetch on a worker thread is ordered after the work the
caller thread queued.  The rescue tier pick costs one device->host sync
per size-class group and batch (see ``pipeline.classify_group``), so
dispatch is not fully asynchronous as it is in the JAX package.

With a mesh that spans processes (``parallel.dist.multihost_init``),
every process runs its own query and output folders, and the processes
dispatch in lockstep: they agree on each pass's sample count (a process
with fewer runs inert filler samples) and on each sample's batch
schedule (``_sync_batch_schedule``), since every hit gather of a row
that spans processes is a collective.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.index.build import BuiltIndex
from monica_tpu_torch.io import encode as enc
from monica_tpu_torch.io import native
from monica_tpu_torch.io import seq as seqio
from monica_tpu_torch.parallel import dist
from monica_tpu_torch.parallel import mesh as pm
from monica_tpu_torch.stats.abundance import AbundanceState
from monica_tpu_torch.utils.metrics import Metrics, span

# routed-output folder names
MAPPED_DIR = "mapped"
UNMAPPED_DIR = "unmapped"
AMBIGUOUS_DIR = "ambiguous"
FOCUS_DIR = "focus"
# quarantine for samples that fail to parse or classify
FAILED_DIR = "failed"

# sentinel files: empty flags for external watchers
S_DATABASE_CREATED = "database_created"
S_ENTERED_INDEXER = "entered_indexer"
S_FINISHED_INDEXING = "finished_indexing"
S_GOING_TO_ALIGN = "going_to_enter_alignment"


def touch_sentinel(folder: str | os.PathLike, name: str) -> None:
    Path(folder).mkdir(parents=True, exist_ok=True)
    (Path(folder) / name).touch()


@dataclass
class RouteFolders:
    """Routed FASTQ output folders under the query folder."""

    mapped: Path
    unmapped: Path
    ambiguous: Path
    focus: Path | None

    @classmethod
    def create(cls, query_folder, with_focus: bool) -> "RouteFolders":
        q = Path(query_folder)
        f = cls(mapped=q / MAPPED_DIR, unmapped=q / UNMAPPED_DIR,
                ambiguous=q / AMBIGUOUS_DIR, focus=(q / FOCUS_DIR) if with_focus else None)
        for d in (f.mapped, f.unmapped, f.ambiguous, f.focus):
            if d is not None:
                d.mkdir(parents=True, exist_ok=True)
        return f


class Classifier:
    """Device-resident index + the classify step.

    On one device (``device``): the index, of one shard or many, is
    stacked by size class (``stack_device_shard_groups``) and classified
    by ``classify_batch_grouped_packed``.  On a mesh (``mesh``, a
    :class:`parallel.mesh.Mesh`): any number of shards is dealt over the
    index axis (``stack_mesh_shard_groups``) and each batch's rows over
    the data axis (``parallel.dist.make_sharded_classifier``).  One of
    the two is required; nothing picks a device."""

    def __init__(
        self,
        built: BuiltIndex,
        params: pl.ClassifyParams = pl.ClassifyParams(),
        count_mode: str = "query_length",
        *,
        device=None,
        mesh: pm.Mesh | None = None,
    ):
        if (device is None) == (mesh is None):
            raise TypeError("Classifier takes a device or a mesh")
        self.meta = built.meta
        self.count_mode = pl.COUNT_MODES[count_mode]
        self.mesh = mesh
        if self.count_mode == pl.MODE_MATCHING and params.extend:
            # 'matching' counts alignment mlen, so extension runs on
            # every read, not only on the rescue candidates
            params = params._replace(extend_mode="full")
        # a mesh's results are fetched from the device of its first local row
        self.device = (torch.device(device) if mesh is None
                       else mesh.row_device(mesh.local_rows()[0]))
        counts = {"shards": len(built.shards)}
        if mesh is None:
            # the stacked index: its size-class groups and device bytes
            classes = pl.size_classes(built.shards)
            counts.update(groups=len(classes), bytes=pl.stack_nbytes(classes))
        with span("index_upload", **counts):
            if mesh is not None:
                self.index, tag_bits = pm.shard_index(mesh, built.shards)
            else:
                self.index, tag_bits = pl.stack_device_shard_groups(built.shards, self.device)
        self.params = params._replace(
            tag_bits=tag_bits, k=built.meta.k, w=built.meta.w, frac=built.meta.frac
        )

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> the Classifier's device (``mesh.upload``)."""
        return pm.upload(arr, self.device)

    def _pack(self, codes: np.ndarray) -> torch.Tensor:
        """A batch's 2-bit wire as a host tensor.  On a card it is packed
        straight into pinned memory, the buffer the upload copies from;
        PyTorch's caching host allocator hands the block back once that
        copy has run, so it does not fault in again each batch."""
        B, L = codes.shape
        out = torch.empty((B, -(-L // 4)), dtype=torch.uint8,
                          pin_memory=self.device.type == "cuda")
        enc.pack_codes_2bit(codes, out=out.numpy())
        return out

    def classify(self, codes: np.ndarray, lengths: np.ndarray):
        """Classify one padded (B, L) uint8 batch; returns device
        (ReadResult, counts), on a mesh ({row: ReadResult}, {row:
        counts}) for this process's data rows.  Reads cross to the device
        2-bit packed (4 bases/byte; on a card packed into pinned memory,
        see ``_pack``) and are unpacked there.  Spans:
        ``monica.classify`` around ``monica.pack``, ``monica.upload`` and
        ``monica.pipeline`` (the eager dispatch)."""
        B, L = codes.shape
        with span("classify", rows=B, len=L):
            params = pl.params_for_bucket(self.params, L)
            if self.mesh is not None:
                step = dist.make_sharded_classifier(self.mesh, params, self.meta.n_accessions,
                                                    self.count_mode, self.index)
                reads = pm.shard_reads(self.mesh, codes, lengths)
                with span("pipeline"):
                    return step(reads)
            with span("pack"):
                packed = self._pack(codes)
            with span("upload"):
                packed = packed.to(self.device, non_blocking=True)
                lengths = self._upload(np.asarray(lengths, dtype=np.int32))
            with span("pipeline"):
                return pl.classify_batch_grouped_packed(self.index, packed, lengths, L, params,
                                                        self.meta.n_accessions, self.count_mode)

    def fetch(self, res, counts):
        """Blocking device->host fetch of one classified batch, for THIS
        process's rows: (status, acc_id, mlen) numpy int32 rows and the
        (n_accessions,) int64 counts of those rows, in one transfer.
        Spans: ``monica.fetch`` around ``monica.pack_results``,
        ``monica.copy`` and ``monica.split``."""
        with span("fetch"):
            return self.fetch_packed(self.dispatch_pack(res, counts))

    def _split_packed(self, arr: np.ndarray):
        """(status, acc_id, mlen, counts) from a pl.pack_results array,
        or from a mesh's (n_rows, 3 + R, b) stack of them (rows in data
        order, their counts summed)."""
        n_acc = self.meta.n_accessions
        if arr.ndim == 3:
            c = arr[:, 3:].reshape(arr.shape[0], -1)[:, :n_acc].sum(axis=0, dtype=np.int64)
            return arr[:, 0].reshape(-1), arr[:, 1].reshape(-1), arr[:, 2].reshape(-1), c
        c = arr[3:].reshape(-1)[:n_acc].astype(np.int64)
        return arr[0], arr[1], arr[2], c

    def dispatch_pack(self, res, counts):
        """Pack one batch's results into one int32 tensor on the device
        (queued behind its batch, no sync); a mesh's rows (this
        process's) are packed each on its device and stacked on the
        Classifier's."""
        with span("pack_results"):
            if self.mesh is None:
                return pl.pack_results(res, counts)
            return torch.stack([pl.pack_results(res[d], counts[d]).to(self.device)
                                for d in sorted(res)])

    def combine_packed(self, handles: list) -> torch.Tensor | None:
        """One device-side concat of a whole sample's packed batches, so
        the sample costs ONE device->host transfer; None for no batches
        (a lockstep filler whose slot every process left empty)."""
        return pl.concat_packed(handles) if handles else None

    def fetch_packed(self, handle: torch.Tensor):
        """Blocking counterpart of dispatch_pack."""
        with span("copy"):
            arr = handle.cpu().numpy()
        with span("split"):
            return self._split_packed(arr)

    def split_combined(self, combined: torch.Tensor, handles: list) -> list:
        """Fetch a combine_packed tensor (one transfer) and split it back
        into per-batch (status, acc_id, mlen, counts) tuples."""
        with span("copy"):
            flat = combined.cpu().numpy()
        out = []
        o = 0
        for h in handles:
            n = h.numel()
            out.append(self._split_packed(flat[o : o + n].reshape(tuple(h.shape))))
            o += n
        return out

    def batch_row_multiple(self) -> int:
        """Batches are padded to a multiple of the mesh's data axis."""
        return 1 if self.mesh is None else self.mesh.shape[pm.DATA_AXIS]


@dataclass
class SampleReport:
    sample: str
    n_reads: int = 0
    n_mapped: int = 0
    n_unmapped: int = 0
    n_ambiguous: int = 0
    n_focus: int = 0
    seconds: float = 0.0


# ---------------------------------------------------------------------------
# multi-process lockstep
# ---------------------------------------------------------------------------
#
# When the mesh spans processes, the hit gather of a row that spans them
# is a collective: every process must dispatch the same sequence of batch
# SHAPES or the run deadlocks.  Each process classifies its OWN sample
# files (separate query folders, per-process output tables whose union is
# the global result).  Shapes are agreed with one small all-gather per
# sample: per bucket, the slot-wise maximum of the processes' batch row
# counts, and every process pads its batches (with inert all-padding rows
# and batches) to that common schedule.

def _is_multiprocess(classifier: "Classifier") -> bool:
    return classifier.mesh is not None and classifier.mesh.world_size > 1


_MAX_SCHED_SLOTS = 512  # batches per sample in the all-gathered plan


def _sync_batch_schedule(batches: list) -> list:
    """Agree on a common dispatch schedule across processes and return
    this process's padded and extended lockstep batch list.

    Local plans are (bucket_len, rows) pairs; the global schedule takes,
    per bucket, the slot-wise maximum over processes (each process orders
    a bucket's batches by descending rows first, so maxima pair like with
    like).  A process missing a slot contributes an all-padding batch
    (length 0, idx -1), which the pipeline masks out."""
    per: dict[int, list] = {}
    for b in batches:
        per.setdefault(b.bucket_len, []).append(b)
    for v in per.values():
        v.sort(key=len, reverse=True)

    # one extra row carries this process's overflow count: a process whose
    # sample needs more than _MAX_SCHED_SLOTS batches must NOT raise before
    # the all-gather (its peers would hang in it); every process gathers
    # the counts first and then raises the same error together
    plan = np.zeros((_MAX_SCHED_SLOTS + 1, 2), np.int32)
    i = 0
    overflow = 0
    for blen in sorted(per):
        for b in per[blen]:
            if i >= _MAX_SCHED_SLOTS:
                overflow += 1
                continue
            plan[i] = (blen, len(b))
            i += 1
    plan[_MAX_SCHED_SLOTS] = (-1, overflow)
    all_plans = dist.process_allgather(plan)
    total_overflow = int(all_plans[:, _MAX_SCHED_SLOTS, 1].astype(np.int64).sum())
    if total_overflow:
        raise ValueError(
            f"a sample needs >{_MAX_SCHED_SLOTS} device batches "
            f"({total_overflow} over, across all processes); raise --max_batch"
        )

    sched: dict[int, list[int]] = {}
    for p in range(all_plans.shape[0]):
        per_p: dict[int, list[int]] = {}
        for blen, rows in all_plans[p, :_MAX_SCHED_SLOTS]:
            if blen > 0:
                per_p.setdefault(int(blen), []).append(int(rows))
        for blen, lst in per_p.items():
            lst.sort(reverse=True)
            cur = sched.setdefault(blen, [])
            for k, r in enumerate(lst):
                if k < len(cur):
                    cur[k] = max(cur[k], r)
                else:
                    cur.append(r)

    out = []
    for blen in sorted(sched):
        have = per.get(blen, [])
        for k, rows in enumerate(sched[blen]):
            b = have[k] if k < len(have) else enc.ReadBatch(
                np.zeros((0, blen), np.uint8), np.zeros(0, np.int32), np.zeros(0, np.int32))
            out.append(enc.pad_rows(b, target=rows))
    return out


# ---------------------------------------------------------------------------
# sample adapters: native (C span-indexed buffer) and pure Python
# ---------------------------------------------------------------------------

class _NativeSample:
    """Reads from a span-indexed raw buffer (io.native): encoding fills
    code matrices in C, routing writes raw record byte slices (the id
    rewritten in C on the mapped route)."""

    binary = True

    def __init__(self, view):
        self.view = view

    def __len__(self):
        return len(self.view)

    def batches(self, buckets, max_batch):
        lengths = self.view.lengths.astype(np.int64)
        batches = []
        for blen, rows in enc.window_plan(lengths, buckets, max_batch):
            r = np.asarray(rows, dtype=np.int64)  # (n, 3): idx, offset, wlen
            codes = np.full((len(r), blen), enc.PAD_CODE, dtype=np.uint8)
            self.view.encode_rows(r[:, 0], codes, offsets=r[:, 1], window_lens=r[:, 2])
            batches.append(enc.ReadBatch(codes, r[:, 2].astype(np.int32),
                                         r[:, 0].astype(np.int32)))
        return batches

    def read_length(self, i: int) -> int:
        return int(self.view.seq_len[i])

    def write_many(self, fh, indices, new_id: str | None = None):
        """One C concat + one fh.write for a whole route."""
        if not len(indices):
            return
        if new_id is None:
            fh.write(self.view.concat_records(indices))
        else:
            fh.write(self.view.concat_records_with_id(indices, new_id.encode()))


class _PySample:
    """Reads from the pure-Python parser (no C++ compiler)."""

    binary = False

    def __init__(self, records):
        self.records = records

    def __len__(self):
        return len(self.records)

    def batches(self, buckets, max_batch):
        return enc.bucketize_reads([r.seq for r in self.records], buckets, max_batch)

    def read_length(self, i: int) -> int:
        return len(self.records[i].seq)

    def write_many(self, fh, indices, new_id: str | None = None):
        for i in indices:
            seqio.write_fastq_record(fh, self.records[int(i)], new_id=new_id)


def _load_sample(sample_path) -> "_NativeSample | _PySample":
    if native.available():
        return _NativeSample(native.parse_fastq_file(sample_path))
    return _PySample(list(seqio.read_fastq(sample_path)))


# whole-file ingest above this size switches to bounded-chunk streaming
# (memory O(chunk), not O(file))
MAX_RESIDENT_BYTES = 256 << 20
CHUNK_BYTES = 64 << 20


def _ingest_bytes(path) -> int:
    """Estimated in-memory size of a sample: gzip expands ~4-8x."""
    sz = Path(path).stat().st_size
    return sz * 6 if str(path).endswith(".gz") else sz


def process_sample(
    classifier: Classifier,
    sample_path: str | os.PathLike,
    folders: RouteFolders,
    state: AbundanceState,
    focus_taxa: frozenset[str] = frozenset(),
    overnight: bool = False,
    buckets=enc.DEFAULT_BUCKETS,
    max_batch: int = 4096,
    delete: bool = True,
    metrics: Metrics | None = None,
    max_resident_bytes: int | None = None,  # None -> MAX_RESIDENT_BYTES
    chunk_bytes: int | None = None,  # None -> CHUNK_BYTES (at call time)
) -> SampleReport:
    """Classify one sample file end to end and route its reads: parse ->
    bucketized device batches -> fetch -> routing and counts -> delete
    the consumed file.  run_once overlaps these stages across samples;
    this is their serial composition.  A sample above
    ``max_resident_bytes`` streams through ~``chunk_bytes`` chunks (the
    native parser is needed for that), with identical results.

    ``sample_path=None`` is the multi-process lockstep filler: a process
    with fewer samples this pass still takes part in every collective
    dispatch (all-padding batches), touching no files and no state.  A
    mesh that spans processes parses whole files: the schedule is agreed
    per sample, not per chunk."""
    metrics = metrics or Metrics(verbose=False)
    if max_resident_bytes is None:
        max_resident_bytes = MAX_RESIDENT_BYTES
    if chunk_bytes is None:
        chunk_bytes = CHUNK_BYTES
    t0 = time.perf_counter()
    multiproc = _is_multiprocess(classifier)
    if (sample_path is not None and not multiproc
            and _ingest_bytes(sample_path) > max_resident_bytes and native.available()):
        return _process_sample_chunked(
            classifier, Path(sample_path), folders, state, focus_taxa, overnight,
            buckets, max_batch, delete, metrics, t0, chunk_bytes,
        )
    prepared = _prepare_sample(classifier, sample_path, buckets, max_batch, metrics)
    if not prepared.n_rows and not multiproc:
        if delete:
            Path(sample_path).unlink(missing_ok=True)
        return prepared.rep
    pending = _dispatch_sample(classifier, prepared, metrics, multiproc)
    return _finish_sample(classifier, prepared, pending, folders, state,
                          focus_taxa=focus_taxa, overnight=overnight, delete=delete,
                          metrics=metrics, t0=t0)


def _process_sample_chunked(
    classifier, sample_path: Path, folders, state, focus_taxa, overnight,
    buckets, max_batch, delete, metrics, t0, chunk_bytes,
) -> SampleReport:
    """Bounded-memory process_sample: each ~chunk_bytes slice of the
    file runs the whole parse -> dispatch -> fetch -> route cycle and is
    dropped.  Routed outputs append, the accumulator is monotone and
    records never split across chunks, so the routed record sets, the
    counts and the report equal the whole-file run's."""
    name = seqio.sample_name(sample_path)
    total = SampleReport(sample=name)
    mult = classifier.batch_row_multiple()
    for view in native.iter_fastq_file_views(sample_path, chunk_bytes):
        sample = _NativeSample(view)
        with metrics.stage(f"encode:{name}"):
            batches = [enc.pad_rows(b, mult) for b in sample.batches(buckets, max_batch)]
        prepared = _PreparedSample(sample_path, name, sample, batches, SampleReport(sample=name))
        prepared.rep.n_reads = len(sample)
        pending = _dispatch_sample(classifier, prepared, metrics)
        rep = _finish_sample(classifier, prepared, pending, folders, state,
                             focus_taxa=focus_taxa, overnight=overnight, delete=False,
                             metrics=metrics, t0=time.perf_counter())
        total.n_reads += rep.n_reads
        total.n_mapped += rep.n_mapped
        total.n_unmapped += rep.n_unmapped
        total.n_ambiguous += rep.n_ambiguous
        total.n_focus += rep.n_focus
    if delete:
        sample_path.unlink(missing_ok=True)
    total.seconds = time.perf_counter() - t0
    return total


@dataclass
class _PreparedSample:
    """Host stage 1 output: parsed and encoded, ready for dispatch
    (``sample_path`` None for a lockstep filler)."""

    sample_path: Path | None
    name: str
    sample: object
    batches: list
    rep: SampleReport

    @property
    def n_rows(self) -> int:
        return len(self.sample)


def _prepare_sample(classifier, sample_path, buckets, max_batch, metrics) -> _PreparedSample:
    """Parse + encode + bucketize one sample, each batch padded to the
    Classifier's row multiple (the C parser releases the GIL, so in
    run_once this overlaps other samples' device work)."""
    if sample_path is None:
        return _PreparedSample(None, "<lockstep-filler>", _PySample([]), [],
                               SampleReport(sample="<lockstep-filler>"))
    sample_path = Path(sample_path)
    name = seqio.sample_name(sample_path)
    rep = SampleReport(sample=name)
    with metrics.stage(f"parse:{name}"):
        sample = _load_sample(sample_path)
    rep.n_reads = len(sample)
    mult = classifier.batch_row_multiple()
    batches = ([enc.pad_rows(b, mult) for b in sample.batches(buckets, max_batch)]
               if len(sample) else [])
    return _PreparedSample(sample_path, name, sample, batches, rep)


@dataclass
class _Dispatched:
    """Device work for one sample: per-batch packed results and the
    whole sample's combined result tensor."""

    pending: list  # [(ReadBatch, packed result tensor)]
    combined: torch.Tensor | None  # None: no batches


def _dispatch_sample(classifier, prepared: _PreparedSample, metrics: Metrics,
                     multiproc: bool = False) -> _Dispatched:
    """Queue every batch on the device, pack each batch's results there
    and concatenate the sample's packed results, so the later fetch is
    one transfer per sample.  Timed as the ``dispatch:`` stage, which
    holds the host syncs of the rescue tier picks.  Across processes the
    batches first follow the agreed lockstep schedule."""
    batches = _sync_batch_schedule(prepared.batches) if multiproc else prepared.batches
    with metrics.stage(f"dispatch:{prepared.name}", items=prepared.n_rows):
        pending = [(b, classifier.dispatch_pack(*classifier.classify(b.codes, b.lengths)))
                   for b in batches]
        return _Dispatched(pending, classifier.combine_packed([h for _, h in pending]))


def _finish_sample(
    classifier,
    prepared: _PreparedSample,
    pending: _Dispatched,
    folders,
    state,
    focus_taxa=frozenset(),
    overnight=False,
    delete=True,
    metrics=None,
    t0=None,
    state_lock=None,
) -> SampleReport:
    """Fetch + window merge + count + route + delete (host stage 3)."""
    metrics = metrics or Metrics(verbose=False)
    t0 = t0 if t0 is not None else time.perf_counter()
    sample = prepared.sample
    sample_path = prepared.sample_path
    name = prepared.name
    rep = prepared.rep

    status = np.zeros(len(sample), np.int32)
    acc = np.full(len(sample), -1, np.int32)
    counts = np.zeros(classifier.meta.n_accessions, np.int64)
    n_bases = 0
    # ultra-long reads arrive as several window rows sharing one idx
    # (enc.window_plan); collect their per-window results for the merge
    rows_per_read = np.zeros(len(sample), np.int64)
    for b, _ in pending.pending:
        keep = b.idx >= 0
        np.add.at(rows_per_read, b.idx[keep], 1)
    chunked = rows_per_read > 1
    windows: dict[int, list[tuple[int, int, int, int]]] = {}
    with metrics.stage(f"classify:{name}", items=len(sample)):
        # one transfer for the whole sample
        fetched = ([] if pending.combined is None
                   else classifier.split_combined(pending.combined,
                                                  [h for _, h in pending.pending]))
        for (b, _), (st_all, ac_all, ml_all, cb) in zip(pending.pending, fetched):
            keep = b.idx >= 0
            idxs = b.idx[keep]
            st = st_all[keep]
            ac = ac_all[keep]
            counts += cb
            n_bases += int(b.lengths.sum())
            ch = chunked[idxs]
            status[idxs[~ch]] = st[~ch]
            acc[idxs[~ch]] = ac[~ch]
            if ch.any():
                ml = ml_all[keep]
                wl = b.lengths[keep]
                for i, s_, a_, m_, w_ in zip(idxs[ch], st[ch], ac[ch], ml[ch], wl[ch]):
                    windows.setdefault(int(i), []).append((int(s_), int(a_), int(m_), int(w_)))
    metrics.add("bases", 0.0, n_bases)

    # window merge: windows agreeing on one accession -> MAPPED, mapped
    # windows that disagree -> AMBIGUOUS.  The device counted each
    # window; retract those and add one whole-read contribution, so the
    # counts equal those of one unwindowed read of the same length.
    mode = classifier.count_mode
    for i, ws in windows.items():
        mapped_accs = {a for s_, a, _, _ in ws if s_ == pl.MAPPED}
        for s_, a, m, w in ws:
            if s_ == pl.MAPPED:
                counts[a] -= 1 if mode == pl.MODE_BASIC else w if mode == pl.MODE_QUERY_LENGTH else m
        if len(mapped_accs) == 1:
            a = mapped_accs.pop()
            status[i] = pl.MAPPED
            acc[i] = a
            counts[a] += (
                1 if mode == pl.MODE_BASIC
                else sample.read_length(i) if mode == pl.MODE_QUERY_LENGTH
                else sum(m for s_, aa, m, _ in ws if s_ == pl.MAPPED and aa == a)
            )
        elif len(mapped_accs) > 1 or any(s_ == pl.AMBIGUOUS for s_, *_ in ws):
            status[i] = pl.AMBIGUOUS
        else:
            status[i] = pl.UNMAPPED

    if sample_path is None:
        rep.seconds = time.perf_counter() - t0
        return rep  # filler: no files to route, nothing to accumulate

    if state_lock is not None:
        with state_lock:
            state.update(name, counts)
    else:
        state.update(name, counts)

    tax_units = classifier.meta.tax_units
    wmode = "ab" if sample.binary else "a"
    with metrics.stage(f"route:{name}", items=len(sample)):
        # status-sorted batched writes: one span concat + one write per
        # route, and per accession on the mapped route, whose read ids
        # are rewritten to the tax unit
        mapped_idx = np.where(status == pl.MAPPED)[0]
        amb_idx = np.where(status == pl.AMBIGUOUS)[0]
        unm_idx = np.where((status != pl.MAPPED) & (status != pl.AMBIGUOUS))[0]
        rep.n_mapped = len(mapped_idx)
        rep.n_ambiguous = len(amb_idx)
        rep.n_unmapped = len(unm_idx)
        with open(folders.unmapped / sample_path.name, wmode) as fh:
            sample.write_many(fh, unm_idx)
        with open(folders.ambiguous / sample_path.name, wmode) as fh:
            sample.write_many(fh, amb_idx)
        focus_sel: list[np.ndarray] = []
        with open(folders.mapped / sample_path.name, wmode) as fh:
            for a in np.unique(acc[mapped_idx]):
                sel = mapped_idx[acc[mapped_idx] == a]
                tax = tax_units[int(a)]
                if folders.focus is not None and tax in focus_taxa:
                    focus_sel.append(sel)
                if overnight:
                    tax = tax.split("_")[0]  # genus collapse
                sample.write_many(fh, sel, new_id=tax)
        if folders.focus is not None:
            fsel = np.sort(np.concatenate(focus_sel)) if focus_sel else np.zeros(0, np.int64)
            rep.n_focus = len(fsel)
            with open(folders.focus / sample_path.name, wmode) as fh:
                sample.write_many(fh, fsel)  # original ids (raw copy)

    if delete:
        sample_path.unlink(missing_ok=True)
    rep.seconds = time.perf_counter() - t0
    return rep


def run_once(
    classifier: Classifier,
    query_folder: str | os.PathLike,
    output_folder: str | os.PathLike,
    focus_taxa: frozenset[str] = frozenset(),
    overnight: bool = False,
    delete: bool = True,
    metrics: Metrics | None = None,
    max_batch: int = 4096,
) -> list[SampleReport]:
    """One pass: process every sample now in the query folder and
    persist the accumulator (also after a failure mid-pass: the counts
    belong to inputs already consumed).

    Across processes (a mesh that spans them): each process passes its
    OWN query and output folders; the processes agree on the pass's
    sample count (those with fewer run inert lockstep fillers), so every
    collective dispatch lines up.  The per-process tables' union is the
    global result."""
    query_folder = Path(query_folder)
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    samples: list = list(seqio.list_sample_files(query_folder))
    multiproc = _is_multiprocess(classifier)
    if multiproc:
        n_all = dist.process_allgather(np.array([len(samples)], np.int32))
        samples += [None] * (int(n_all.max()) - len(samples))
    if not samples:
        return []
    touch_sentinel(query_folder, S_GOING_TO_ALIGN)
    folders = RouteFolders.create(query_folder, with_focus=bool(focus_taxa))
    state = AbundanceState.load(output_folder, classifier.meta.n_accessions)
    try:
        if multiproc:
            return _run_lockstep(classifier, samples, folders, state, query_folder,
                                 focus_taxa, overnight, delete, metrics, max_batch)
        return _run_once_samples(classifier, samples, folders, state, query_folder,
                                 focus_taxa, overnight, delete, metrics, max_batch)
    finally:
        state.save(output_folder)


def _run_lockstep(classifier, samples, folders, state, query_folder,
                  focus_taxa, overnight, delete, metrics, max_batch) -> list[SampleReport]:
    """The samples one at a time, in lockstep with the other processes.
    Only the stage before the collectives (parse and encode) may be
    quarantined: an inert filler takes a failed sample's place, so every
    process's collective sequence stays aligned.  A failure after
    dispatch (routing I/O, a device error) is not recoverable per sample,
    as the peers' collectives for the slot are already in flight: it
    propagates, and the run dies loudly rather than deadlocking."""
    reports: list[SampleReport] = []
    mt = metrics or Metrics(verbose=False)
    for s in samples:
        try:
            prepared = _prepare_sample(classifier, s, enc.DEFAULT_BUCKETS, max_batch, mt)
        except Exception as e:
            _quarantine_sample(query_folder, s, e)
            prepared = _prepare_sample(classifier, None, enc.DEFAULT_BUCKETS, max_batch, mt)
        t0 = time.perf_counter()
        pending = _dispatch_sample(classifier, prepared, mt, True)
        rep = _finish_sample(classifier, prepared, pending, folders, state,
                             focus_taxa=focus_taxa, overnight=overnight, delete=delete,
                             metrics=mt, t0=t0)
        if prepared.sample_path is not None:
            reports.append(rep)
    return reports


def _run_once_samples(classifier, samples, folders, state, query_folder,
                      focus_taxa, overnight, delete, metrics, max_batch) -> list[SampleReport]:
    """Several samples that fit in memory go through the pipeline;
    oversized ones (and a lone small one) then run serially through
    process_sample, which streams the oversized ones in chunks."""
    reports: list[SampleReport] = []
    small = [s for s in samples if _ingest_bytes(s) <= MAX_RESIDENT_BYTES]
    big = [s for s in samples if _ingest_bytes(s) > MAX_RESIDENT_BYTES]
    if len(small) > 1:
        reports += _run_pipelined(classifier, small, folders, state, query_folder,
                                  focus_taxa, overnight, delete,
                                  metrics or Metrics(verbose=False), max_batch)
        small = []
    for s in small + big:
        try:
            reports.append(process_sample(classifier, s, folders, state, focus_taxa=focus_taxa,
                                          overnight=overnight, delete=delete, metrics=metrics,
                                          max_batch=max_batch))
        except Exception as e:  # quarantine, keep the run alive
            _quarantine_sample(query_folder, s, e)
    return reports


def _quarantine_sample(query_folder: Path, s, e: BaseException) -> None:
    """Move a failed sample to ``failed/`` and report it with its
    traceback on stderr."""
    s = Path(s)
    failed = query_folder / FAILED_DIR
    failed.mkdir(parents=True, exist_ok=True)
    target = failed / s.name
    try:
        s.replace(target)
    except OSError:
        pass
    traceback.print_exception(e, file=sys.stderr)
    print(f"sample {s.name} failed ({e}); quarantined to {target}", file=sys.stderr)


def _run_pipelined(classifier, samples, folders, state, query_folder: Path, focus_taxa,
                   overnight, delete, metrics: Metrics, max_batch: int) -> list[SampleReport]:
    """A 3-stage pipeline over samples: parse and encode on two worker
    threads (prefetching two samples), dispatch on the caller thread,
    fetch and routing on two more workers, with at most two samples
    between dispatch and routing.  Per-sample Metrics stage names are
    unique and the shared AbundanceState is updated under a lock."""
    state_lock = threading.Lock()
    reports: list[SampleReport] = []
    PREFETCH = 2
    MAX_IN_FLIGHT = 2  # samples dispatched but not yet routed
    with ThreadPoolExecutor(max_workers=2) as parse_pool, \
            ThreadPoolExecutor(max_workers=2) as route_pool:
        parse_futs = [
            parse_pool.submit(_prepare_sample, classifier, s, enc.DEFAULT_BUCKETS,
                              max_batch, metrics)
            for s in samples[:PREFETCH]
        ]
        route_futs: list = []

        def drain_oldest():
            s_done, f_done = route_futs.pop(0)
            try:
                reports.append(f_done.result())
            except Exception as e:
                _quarantine_sample(query_folder, s_done, e)

        for i, s in enumerate(samples):
            try:
                prepared = parse_futs[i].result()
            except Exception as e:
                _quarantine_sample(query_folder, s, e)
                prepared = None
            nxt = i + PREFETCH
            if nxt < len(samples):
                parse_futs.append(parse_pool.submit(
                    _prepare_sample, classifier, samples[nxt], enc.DEFAULT_BUCKETS,
                    max_batch, metrics))
            if prepared is None:
                continue
            if not prepared.n_rows:
                if delete:
                    prepared.sample_path.unlink(missing_ok=True)
                reports.append(prepared.rep)
                continue
            while len(route_futs) >= MAX_IN_FLIGHT:
                drain_oldest()
            t0 = time.perf_counter()
            try:
                pending = _dispatch_sample(classifier, prepared, metrics)
            except Exception as e:  # bad batch shapes, device errors
                _quarantine_sample(query_folder, s, e)
                continue
            route_futs.append((s, route_pool.submit(
                _finish_sample, classifier, prepared, pending, folders, state, focus_taxa,
                overnight, delete, metrics, t0, state_lock)))
        while route_futs:
            drain_oldest()
    return reports


def watch(
    classifier: Classifier,
    query_folder,
    output_folder,
    poll_s: float = 5.0,
    max_idle_polls: int | None = None,
    on_batch=None,
    **kwargs,
) -> list[SampleReport]:
    """Real-time loop: run_once every ``poll_s`` seconds.
    ``on_batch(reports)`` runs after each non-empty pass (a table
    export, say).  Stops after ``max_idle_polls`` empty polls in a row
    (None = run forever).

    Across processes run_once is a collective whenever ANY process has
    samples, so every process keeps calling it at the same cadence: a
    pass counts as idle only if no process got samples, and all reach
    ``max_idle_polls``, and exit, together."""
    all_reports: list[SampleReport] = []
    multiproc = _is_multiprocess(classifier)
    idle = 0
    while True:
        reports = run_once(classifier, query_folder, output_folder, **kwargs)
        any_got = bool(reports)
        if multiproc:
            any_got = bool(dist.process_allgather(np.array([any_got], np.int32)).max())
        if reports:
            all_reports.extend(reports)
            if on_batch is not None:
                on_batch(reports)
        if any_got:
            idle = 0
        else:
            idle += 1
            if max_idle_polls is not None and idle >= max_idle_polls:
                return all_reports
            time.sleep(poll_s)
