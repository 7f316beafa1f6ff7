"""Classification pipeline on torch tensors — counterpart of
``monica_tpu/align/pipeline.py``.  Every index, one shard or many, is a
tuple of size-class groups of stacked shards (``stack_device_shard_groups``;
a one-shard index is one group of one), and one step classifies a batch
against it (``classify_batch_grouped``, ``classify_batch_grouped_packed``
on the 2-bit wire): ``classify_group``, one batched pass over a group's
stacked shards, then ``merge_and_count`` (``finalize_single`` for one
shard, ``merge_hits`` across several; ``count_reads``), and the packed
result transfer (``pack_results``, ``concat_packed``).

A read batch moves sketch -> seed lookup -> diagonal vote chaining ->
budgeted banded-SW rescue -> finalize (one shard) or cross-shard merge
-> per-accession counts.  PyTorch runs eagerly, so there is no jit;
every tensor lives on the device of the index it is classified against.
``stack_mesh_shard_groups`` deals the shards over the index axis of a
device mesh (``monica_tpu_torch.parallel``).

Each stage opens a ``utils.metrics.span`` (``monica.sketch``,
``monica.lookup``, ``monica.chain``, ``monica.rescue_pick``,
``monica.rescue``, ``monica.extend``, ``monica.merge``, ``monica.count``,
``monica.unpack``, ``monica.shard`` a group), so a profile puts the
host's time and the launches on a stage; stacking a shard opens
``monica.stack.copy`` (its arrays' copies to the device) and
``monica.stack.fill`` (its hash table's fill there).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from monica_tpu_torch.index import minimizer as mz
from monica_tpu_torch.index.build import IndexShard
from monica_tpu_torch.ops import chain as ch
from monica_tpu_torch.ops import extend as ex
from monica_tpu_torch.ops import lookup as lk
from monica_tpu_torch.utils.metrics import span

# read status codes
UNMAPPED = 0
MAPPED = 1
AMBIGUOUS = 2

# count modes
MODE_BASIC = 0
MODE_QUERY_LENGTH = 1
MODE_MATCHING = 2
COUNT_MODES = {"basic": MODE_BASIC, "query_length": MODE_QUERY_LENGTH, "matching": MODE_MATCHING}


class DeviceIndexShard(NamedTuple):
    """A size-class group of S index shards stacked as device tensors."""

    mz_rows: torch.Tensor  # (S, 2^rbits, ROW_SLOTS) int32 bit pattern of u32 entries
    pos_acc: torch.Tensor  # (S, T) int32 position -> accession id
    ref_codes: torch.Tensor  # (S, T) uint8 packed reference


def stack_device_shards(shards: list[IndexShard], device, tag_bits: int,
                        dims_of: list[IndexShard] | None = None) -> DeviceIndexShard:
    """Shards padded to common sizes and stacked on a leading axis:
    every shard gets the widest row-index width of the set and the tag
    width ``tag_bits`` (that of the largest packed reference of the
    whole index, so one ClassifyParams covers every group).  ``dims_of``
    (default: ``shards``) is the set whose widest table and longest
    reference fix the padded sizes.
    Table padding is all-zero rows (empty slots), ``pos_acc`` pads with
    0 and ``ref_codes`` with PAD (4).  Each shard's sorted minimizer
    arrays go to the device, where ``lookup.fill_hash_rows`` writes its
    table into the stack; its positions and codes are copied straight
    in, so the host never holds the stack."""
    if not shards:
        raise ValueError("cannot stack an empty shard list")
    T, rbits = _stack_dims(shards if dims_of is None else dims_of)
    S = len(shards)
    out = DeviceIndexShard(
        mz_rows=torch.empty((S, 1 << rbits, lk.ROW_SLOTS), dtype=torch.int32, device=device),
        pos_acc=torch.zeros((S, T), dtype=torch.int32, device=device),
        ref_codes=torch.full((S, T), 4, dtype=torch.uint8, device=device),
    )
    for i, sh in enumerate(shards):
        # one span each a shard: its copies, then its table's fill
        mz = (np.ascontiguousarray(sh.mz_hash, np.uint32).view(np.int32),
              np.ascontiguousarray(sh.mz_pos, np.int32),
              np.ascontiguousarray(sh.mz_strand, np.uint8))
        pos = np.asarray(sh.pos_accession_id, np.int32)
        ref = np.ascontiguousarray(sh.ref_codes, np.uint8)
        with span("stack.copy", bytes=sum(a.nbytes for a in (*mz, pos, ref))):
            mz = [torch.from_numpy(a).to(device) for a in mz]
            out.pos_acc[i, : len(pos)].copy_(torch.from_numpy(pos))
            out.ref_codes[i, : len(ref)].copy_(torch.from_numpy(ref))
        with span("stack.fill", shards=1):
            out.mz_rows[i].copy_(lk.fill_hash_rows(*mz, tag_bits, rbits))
    return out


def _stack_dims(shards: list[IndexShard]) -> tuple[int, int]:
    """(padded reference length, row-index width) of a stack of ``shards``."""
    return (max(len(s.ref_codes) for s in shards),
            max(lk.row_bits_for(s.n_minimizers) for s in shards))


def _size_class(n: int) -> int:
    """Power-of-2 size class for shard grouping."""
    return 1 << max(int(n) - 1, 0).bit_length()


def size_classes(shards: list[IndexShard]) -> list[list[IndexShard]]:
    """The shards by power-of-2 size class of their packed reference,
    in ascending class order (the groups a stacked index is made of)."""
    by_class: dict[int, list[IndexShard]] = {}
    for s in shards:
        by_class.setdefault(_size_class(len(s.ref_codes)), []).append(s)
    return [by_class[c] for c in sorted(by_class)]


def stack_nbytes(classes: list[list[IndexShard]]) -> int:
    """Device bytes that ``stack_device_shard_groups`` will allocate for
    ``size_classes(shards)``, from the shards' sizes alone (the same sum
    as ``stacked_nbytes`` of its result)."""
    total = 0
    for c in classes:
        T, rbits = _stack_dims(c)
        total += len(c) * ((1 << rbits) * lk.ROW_SLOTS * 4 + T * (4 + 1))
    return total


def stack_device_shard_groups(shards: list[IndexShard],
                              device) -> tuple[tuple[DeviceIndexShard, ...], int]:
    """Shards stacked by power-of-2 size class of their packed
    reference, in ascending class order, so one oversized shard does
    not pad every other shard to its size.  The tag width is common to
    all groups (sized for the largest reference), so one ClassifyParams
    covers every group.  Returns (stacked groups, common tag width)."""
    if not shards:
        raise ValueError("cannot stack an empty shard list")
    tag_bits = lk.tag_bits_for(max(len(s.ref_codes) for s in shards))
    groups = tuple(stack_device_shards(c, device, tag_bits) for c in size_classes(shards))
    return groups, tag_bits


def _empty_shard() -> IndexShard:
    """A padding shard that can never produce a hit: an empty hash table
    (all-zero rows, the empty-slot sentinel) over a 1-base reference.
    It evens out the shard counts of the index ranks of a mesh."""
    return IndexShard(
        ref_codes=np.full(1, 4, np.uint8),
        seq_starts=np.zeros(0, np.int64),
        seq_lengths=np.zeros(0, np.int64),
        seq_accession_id=np.zeros(0, np.int32),
        mz_hash=np.zeros(0, np.uint32),
        mz_pos=np.zeros(0, np.int32),
        mz_strand=np.zeros(0, np.uint8),
        pos_accession_id=np.zeros(1, np.uint16),
    )


def stack_mesh_shard_groups(
    shards: list[IndexShard], n_index: int, devices,
) -> tuple[tuple[tuple[DeviceIndexShard | None, ...], ...], int]:
    """Any number of shards stacked for an index axis of ``n_index``
    ranks, several shards a rank when there are more shards than ranks.
    Per power-of-2 size class (ascending), the shards are dealt largest
    first onto the rank with the fewest bases so far (LPT), each rank is
    padded with inert ``_empty_shard``s to the class's most shards per
    rank, and each rank's shards are stacked on ``devices[r]`` at the
    sizes of the whole class, so rank r's stack equals rows
    ``[r*S_c, (r+1)*S_c)`` of the JAX package's rank-major stack.  A rank
    whose device is None is skipped (another process holds it).  Returns
    (classes -> ranks -> stacked shards, the common tag width)."""
    if not shards:
        raise ValueError("cannot stack an empty shard list")
    tag_bits = lk.tag_bits_for(max(len(s.ref_codes) for s in shards))
    groups = []
    for members in size_classes(shards):
        ranks: list[list[IndexShard]] = [[] for _ in range(n_index)]
        loads = np.zeros(n_index, np.int64)
        for s in sorted(members, key=lambda s: -len(s.ref_codes)):
            r = int(np.argmin(loads))
            ranks[r].append(s)
            loads[r] += len(s.ref_codes)
        s_c = max(len(r) for r in ranks)
        ranks = [r + [_empty_shard() for _ in range(s_c - len(r))] for r in ranks]
        every = [s for r in ranks for s in r]
        groups.append(tuple(None if dev is None
                            else stack_device_shards(rank, dev, tag_bits, dims_of=every)
                            for rank, dev in zip(ranks, devices)))
    return tuple(groups), tag_bits


def stacked_nbytes(groups) -> int:
    """Device bytes of a stacked group or a tuple of them.  ``pos_acc``
    is int32 here (4 B/base; the JAX package keeps it as uint16)."""
    total = 0
    for g in groups if isinstance(groups, tuple) else (groups,):
        total += sum(t.numel() * t.element_size() for t in g)
    return total


class ClassifyParams(NamedTuple):
    """Pipeline parameters; same fields and defaults as the reference's
    ``ClassifyParams`` (see there for the rationale of each default)."""

    k: int = mz.K_DEFAULT
    w: int = mz.W_DEFAULT
    frac: float = mz.FRAC_DEFAULT  # scaled winnowing; must match the index
    n_slots: int = 128  # minimizer slots per read
    mapping_quality: float = 60.0
    min_votes: int = 3
    tag_bits: int = 8  # packed-entry tag width (stack_device_shard_groups returns it)
    extend: bool = True  # banded-SW extension / rescue
    band: int = 64
    extend_impl: str = "auto"  # "cuda" | "torch" | "auto" (by tensor device)
    extend_mode: str = "rescue"  # "full": SW on every read
    rescue_frac: float = 0.125  # first rescue slot budget as batch fraction
    rescue_nm_rate: float = 0.35
    rescue_min_cov: float = 0.5
    rescue_min_votes: int = 1
    anchors_per_seed: int = 2
    tie_rel_tol: float = 0.10  # cross-shard near-tie band on merge_cost
    vote_tie_sd: float = 1.0  # cross-shard tie band in vote space (0 = off)


class ShardHit(NamedTuple):
    """Per-read best candidate within one index shard."""

    acc_id: torch.Tensor  # (B,) int32
    inv_identity: torch.Tensor  # (B,) f32 NM/mlen analog
    merge_cost: torch.Tensor  # (B,) f32 vote-statistical cost
    mlen: torch.Tensor  # (B,) int32
    mapq: torch.Tensor  # (B,) f32
    votes: torch.Tensor  # (B,) int32
    passed: torch.Tensor  # (B,) bool
    rc: torch.Tensor  # (B,) bool
    ref_pos: torch.Tensor  # (B,) int32
    tied: torch.Tensor  # (B,) bool


def params_for_bucket(params: ClassifyParams, bucket_len: int) -> ClassifyParams:
    """Buckets > 512 bp run 64 seed slots, shorter ones keep 128."""
    if bucket_len > 512 and params.n_slots > 64:
        return params._replace(n_slots=64)
    return params


def sketch_batch(codes: torch.Tensor, lengths: torch.Tensor, params: ClassifyParams):
    """Read sketch with slots beyond each read's true length masked;
    shard-independent, so the multi-shard step computes it once."""
    with span("sketch"):
        qh, qp, qs, qv = mz.sketch_reads(codes, params.n_slots, params.k, params.w,
                                         frac=params.frac)
        qv = qv & (qp < (lengths[:, None] - params.k + 1))
        return qh, qp, qs, qv


# Widest lookup intermediate of one chunk of shards, in int64 entries
# (S_chunk * B * n_slots * ROW_SLOTS; 512 MiB): a larger stack is looked
# up and chained a chunk of shards at a time.
LOOKUP_ENTRIES = 1 << 26
# Window bases a banded-SW call extracts (rows * (L + band); 256 MiB of
# each uint8 window tensor): a larger extension runs in several calls.
SW_WINDOW_BASES = 1 << 28


def classify_group(group: DeviceIndexShard, codes: torch.Tensor, lengths: torch.Tensor,
                   params: ClassifyParams, sketch=None) -> ShardHit:
    """Best hit of every read against every shard of a stacked group
    (``stack_device_shards``: (S, ...) tensors) in one batched pass: one
    table gather over the stack, one chain over the S·B (shard, read)
    rows, one rescue tier picked over that pool and one banded-SW call
    on it.  Returns a ShardHit of (S, B) fields; row s is what shard s
    alone gives, since every (shard, read) row is independent and the
    tier always holds every candidate."""
    B, L = codes.shape
    S = group.mz_rows.shape[0]
    qh, qp, qs, qv = sketch if sketch is not None else sketch_batch(codes, lengths, params)
    per = max(1, LOOKUP_ENTRIES // (qh.numel() * lk.ROW_SLOTS))
    chains = []
    for s0 in range(0, S, per):
        with span("lookup"):
            anchors = lk.lookup_anchors(
                group.mz_rows[s0 : s0 + per], qh, qp, qs, qv, tag_bits=params.tag_bits,
                bucket_len=L, anchors_per_seed=params.anchors_per_seed,
            )
        with span("chain"):
            chains.append(ch.chain_votes(*(a.reshape(-1, a.shape[-1]) for a in anchors),
                                         max_run=min(128, params.n_slots)))
    res = ch.ChainResult(*((f[0] if len(f) == 1 else torch.cat(f)).view(S, B)
                           for f in zip(*chains)))
    mapq = ch.mapq_from_votes(res.f1, res.f2)

    # anchor-count identity estimate: votes/slots ~ id^k
    n_valid = torch.clamp(qv.sum(dim=-1), min=1).to(torch.float32)
    frac = torch.clamp(res.f1.to(torch.float32) / n_valid, 1e-6, 1.0)
    identity = torch.exp(torch.log(frac) / params.k)
    lf = lengths.to(torch.float32)
    mlen = torch.clamp(identity * lf, min=1.0)
    inv_identity = (1.0 - identity) / torch.clamp(identity, min=1e-6)
    stat_cost = inv_identity

    passed = (mapq >= params.mapping_quality) & (res.f1 >= params.min_votes) & (lengths > 0)

    if params.extend and params.extend_mode == "full":
        with span("extend", rows=S * B):
            ext = _extend_rows(group, codes, lengths.expand(S, B).reshape(-1), res, None,
                               params)
        mlen = ext.mlen.view(S, B).to(torch.float32)
        inv_identity = ext.inv_identity.view(S, B)
        rescued = (
            (res.f1 >= params.rescue_min_votes)
            & (res.f2 * 2 <= res.f1)
            & (inv_identity <= params.rescue_nm_rate)
            & (mlen >= params.rescue_min_cov * lf)
            & (lengths > 0)
        )
        passed = passed | rescued
    elif params.extend and params.extend_mode == "rescue":
        # budgeted rescue: SW only on unique-locus (shard, read) rows that
        # failed the vote gate, compacted into N/8, N/2 or N slots of the
        # group's N = S·B rows by the candidate count.  The reference
        # picks the tier with nested lax.conds on the device; here
        # int(n_cand) decides on the host, which costs one device->host
        # sync per batch and group.  A slot past the candidates runs its
        # SW at length 0: its answer is masked out.
        cand = ~passed & (res.f1 >= params.rescue_min_votes) & (res.f2 * 2 <= res.f1) & (lengths > 0)
        with span("rescue_pick"):
            n_cand = int(cand.sum())
        if n_cand > 0:
            N = S * B
            n8 = max(int(N * params.rescue_frac), 1)
            n2 = max(N // 2, 1)
            n_slots = n8 if n_cand <= n8 else n2 if n_cand <= n2 else N
            with span("rescue", cand=n_cand, slots=n_slots):
                run_len = torch.where(cand, lengths, 0).reshape(-1)
                cand = cand.reshape(-1)
                order = torch.argsort(torch.where(cand, 0, 1), stable=True)
                idx = order[:n_slots]
                ext = _extend_rows(group, codes, run_len, res, idx, params)
                ok = (
                    cand[idx]
                    & (ext.inv_identity <= params.rescue_nm_rate)
                    & (ext.mlen.to(torch.float32)
                       >= params.rescue_min_cov * run_len[idx].to(torch.float32))
                )
                rescued = torch.zeros_like(cand).index_put_((idx,), ok).view(S, B)
                inv_sc = torch.zeros_like(inv_identity).view(-1).index_put_(
                    (idx,), torch.where(ok, ext.inv_identity, 0.0)).view(S, B)
                mlen_sc = torch.zeros_like(mlen).view(-1).index_put_(
                    (idx,), torch.where(ok, ext.mlen.to(mlen.dtype), 0.0)).view(S, B)
                passed = passed | rescued
                inv_identity = torch.where(rescued, inv_sc, inv_identity)
                mlen = torch.where(rescued, mlen_sc, mlen)

    T = group.pos_acc.shape[1]
    acc_id = torch.gather(group.pos_acc, 1, torch.clamp(res.rep_ref_pos, 0, T - 1).long())
    acc2 = torch.gather(group.pos_acc, 1, torch.clamp(res.rep2_ref_pos, 0, T - 1).long())
    tied = (res.f2 == res.f1) & (res.f1 >= params.min_votes) & (acc2 != acc_id) & (lengths > 0)
    return ShardHit(
        acc_id=acc_id.to(torch.int32),
        inv_identity=inv_identity,
        merge_cost=stat_cost,
        mlen=mlen.to(torch.int32),
        mapq=mapq,
        votes=res.f1,
        passed=passed & ~tied,
        rc=res.rc,
        ref_pos=res.rep_ref_pos,
        tied=tied,
    )


def _extend_rows(group: DeviceIndexShard, codes: torch.Tensor, run_len: torch.Tensor,
                 res: ch.ChainResult, idx: torch.Tensor | None,
                 params: ClassifyParams) -> ex.Extension:
    """Banded SW of a group's (shard, read) rows at their chained locus
    (``res``, (S, B) fields): ``idx`` indexes the rows flattened
    shard-major (None: all S·B in order), ``run_len`` (S·B,) is the
    length each row's SW runs to.  At most SW_WINDOW_BASES window bases
    a call."""
    S = group.ref_codes.shape[0]
    B, L = codes.shape
    n = S * B if idx is None else idx.shape[0]
    step = max(1, SW_WINDOW_BASES // (L + params.band))
    parts = []
    for lo in range(0, n, step):
        if idx is not None:
            i = idx[lo : lo + step]
        elif S == 1:
            i = slice(lo, lo + step)
        else:
            i = torch.arange(lo, min(n, lo + step), device=codes.device)
        read, shard, ref = (i, None, group.ref_codes[0]) if S == 1 else (
            i % B, i // B, group.ref_codes)
        parts.append(ex.extend_hits(
            ref, codes[read], run_len[i], res.rep_ref_pos.reshape(-1)[i],
            res.rep_read_pos.reshape(-1)[i], res.rc.reshape(-1)[i], k=params.k,
            p=ex.ExtendParams(band=params.band), impl=params.extend_impl, shard=shard,
        ))
    return parts[0] if len(parts) == 1 else ex.Extension(*(torch.cat(f) for f in zip(*parts)))


class ReadResult(NamedTuple):
    """Final per-read classification."""

    status: torch.Tensor  # (B,) int32 UNMAPPED/MAPPED/AMBIGUOUS
    acc_id: torch.Tensor  # (B,) int32 (-1 when not mapped)
    inv_identity: torch.Tensor  # (B,) f32
    mlen: torch.Tensor  # (B,) int32
    mapq: torch.Tensor  # (B,) f32
    rc: torch.Tensor  # (B,) bool


def finalize_single(hit: ShardHit) -> ReadResult:
    status = torch.where(hit.passed, MAPPED, torch.where(hit.tied, AMBIGUOUS, UNMAPPED))
    return ReadResult(
        status=status.to(torch.int32),
        acc_id=torch.where(hit.passed, hit.acc_id, -1),
        inv_identity=hit.inv_identity,
        mlen=torch.where(hit.passed, hit.mlen, 0),
        mapq=hit.mapq,
        rc=hit.rc,
    )


def merge_hits(hits: ShardHit, tie_rel_tol: float = ClassifyParams().tie_rel_tol,
               vote_tie_sd: float = ClassifyParams().vote_tie_sd) -> ReadResult:
    """Merge per-shard hits stacked on axis 0 (S, B): the best passing
    shard by merge_cost (the first one on an exact tie, as jnp.argmin
    picks it), AMBIGUOUS when another passing shard with a different
    accession lies within the cost band ``best * (1 + tie_rel_tol) +
    1e-6`` or within ``vote_tie_sd * sqrt(best_votes)`` votes of the
    best; with nothing passing, AMBIGUOUS when a shard reports an
    internal tie.  Both tolerances 0 give exact-tie semantics.

    The cost band is rounded once, as the JAX package computes it: XLA
    on the CPU contracts its multiply-add into an FMA.  The product
    of two float32 values is exact in float64, so the float64 sum
    rounded to float32 is that FMA (a double rounding can differ only
    in about one case in 2^28)."""
    S, B = hits.passed.shape
    dev = hits.passed.device

    def f32(v):  # a float32 constant made on the hits' device: no host copy
        return torch.full((), v, dtype=torch.float32, device=dev)

    cost = torch.where(hits.passed, hits.merge_cost, f32(1e9))
    best_s = mz.first_argmin(cost.T)  # (B,)

    def take(x):
        return torch.gather(x, 0, best_s[None, :])[0]

    best_cost = take(cost)
    any_pass = hits.passed.any(dim=0)
    is_best = torch.arange(S, device=dev)[:, None] == best_s[None, :]
    band = (best_cost.double() * float(np.float32(1.0 + tie_rel_tol))
            + float(np.float32(1e-6))).to(torch.float32)
    best_acc = take(hits.acc_id)
    near = cost <= band[None, :]
    if vote_tie_sd > 0.0:
        best_votes = take(hits.votes).to(torch.float32)
        vband = f32(vote_tie_sd) * torch.sqrt(torch.clamp(best_votes, min=1.0))
        dv = torch.abs(hits.votes.to(torch.float32) - best_votes[None, :])
        near = near | (dv <= vband[None, :])
    tie = (near & ~is_best & hits.passed & (hits.acc_id != best_acc[None, :])).any(dim=0)
    tied_inside = hits.tied.any(dim=0)
    status = torch.where(any_pass, torch.where(tie, AMBIGUOUS, MAPPED),
                         torch.where(tied_inside, AMBIGUOUS, UNMAPPED))
    mapped = status == MAPPED
    return ReadResult(
        status=status.to(torch.int32),
        acc_id=torch.where(mapped, take(hits.acc_id), -1),
        inv_identity=take(hits.inv_identity),
        mlen=torch.where(mapped, take(hits.mlen), 0),
        mapq=take(hits.mapq),
        rc=take(hits.rc),
    )


def count_reads(result: ReadResult, lengths: torch.Tensor, n_accessions: int,
                count_mode: int) -> torch.Tensor:
    """Per-accession int32 counts of this batch: basic = 1,
    query_length = read length, matching = mlen per mapped read.
    Unmapped reads go to an overflow bucket that is dropped."""
    if count_mode == MODE_BASIC:
        value = torch.ones_like(lengths)
    elif count_mode == MODE_QUERY_LENGTH:
        value = lengths
    else:
        value = result.mlen
    mapped = result.status == MAPPED
    seg = torch.where(mapped, result.acc_id, n_accessions).long()
    counts = torch.zeros(n_accessions + 1, dtype=torch.int32, device=lengths.device)
    counts.index_add_(0, seg, torch.where(mapped, value, 0).to(torch.int32))
    return counts[:n_accessions]


def classify_batch_grouped(groups: tuple[DeviceIndexShard, ...], codes: torch.Tensor,
                           lengths: torch.Tensor, params: ClassifyParams, n_accessions: int,
                           count_mode: int = MODE_QUERY_LENGTH):
    """The step over an index's size-class groups
    (stack_device_shard_groups): ``classify_groups``, then
    ``merge_and_count``."""
    return merge_and_count(classify_groups(groups, codes, lengths, params), lengths, params,
                           n_accessions, count_mode)


def classify_groups(groups: tuple[DeviceIndexShard, ...], codes: torch.Tensor,
                    lengths: torch.Tensor, params: ClassifyParams, sketch=None) -> ShardHit:
    """Every size-class group in one batched pass each
    (``classify_group``), with one sketch (``sketch``, else computed
    here): the hits as one ShardHit of (S, B) fields in group-then-shard
    order."""
    sk = sketch_batch(codes, lengths, params) if sketch is None else sketch
    hits = []
    for gi, g in enumerate(groups):
        with span("shard", group=gi, shards=g.mz_rows.shape[0]):
            hits.append(classify_group(g, codes, lengths, params, sketch=sk))
    return hits[0] if len(hits) == 1 else ShardHit(*(torch.cat(f) for f in zip(*hits)))


def merge_and_count(hits: ShardHit, lengths: torch.Tensor, params: ClassifyParams,
                    n_accessions: int, count_mode: int = MODE_QUERY_LENGTH):
    """The (S, B) hits of a batch merged per read and counted:
    (ReadResult, (n_accessions,) counts).  One shard's hits are final
    (``finalize_single``, what ``merge_hits`` gives at S = 1 in fewer
    launches); several go through ``merge_hits``.  The merge's span
    counts the S shards it merges."""
    S = hits.acc_id.shape[0]
    with span("merge", shards=S):
        result = (finalize_single(ShardHit(*(f[0] for f in hits))) if S == 1
                  else merge_hits(hits, params.tie_rel_tol, params.vote_tie_sd))
    with span("count"):
        return result, count_reads(result, lengths, n_accessions, count_mode)


def unpack_codes(packed: torch.Tensor, read_len: int) -> torch.Tensor:
    """Inverse of ``io.encode.pack_codes_2bit``: (B, ceil(L/4)) uint8
    wire bytes -> (B, L) uint8 base codes."""
    B, P = packed.shape
    with span("unpack"):
        shifts = torch.arange(4, dtype=torch.uint8, device=packed.device) * 2
        c = (packed[:, :, None] >> shifts[None, None, :]) & 3
        return c.reshape(B, P * 4)[:, :read_len].contiguous()


def classify_batch_grouped_packed(groups, packed, lengths, read_len, params, n_accessions,
                                  count_mode=MODE_QUERY_LENGTH):
    """classify_batch_grouped on 2-bit packed wire input."""
    return classify_batch_grouped(groups, unpack_codes(packed, read_len), lengths, params,
                                  n_accessions, count_mode)


def concat_packed(arrs) -> torch.Tensor:
    """A whole sample's pack_results tensors as ONE flat int32 tensor on
    the device, so the sample costs a single device->host transfer."""
    return torch.cat([a.reshape(-1) for a in arrs])


def pack_results(result: ReadResult, counts: torch.Tensor) -> torch.Tensor:
    """Everything the host consumes in ONE int32 tensor (one transfer):
    rows [status, acc_id, mlen], then ceil(n_acc/B) rows of the
    zero-padded count vector."""
    B = result.status.shape[0]
    counts = counts.reshape(-1)
    n_acc = counts.shape[0]
    rows = -(-n_acc // B)
    cpad = torch.zeros(rows * B, dtype=torch.int32, device=counts.device)
    cpad[:n_acc] = counts
    return torch.cat([
        result.status[None].to(torch.int32),
        result.acc_id[None].to(torch.int32),
        result.mlen[None].to(torch.int32),
        cpad.reshape(rows, B),
    ])
