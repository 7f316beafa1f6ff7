"""Reference-executed end-to-end parity harness — counterpart of
``monica_tpu/parity.py`` for the port.

The reference's routing, counting and accumulation code (``aligner()``,
``multi_threaded_aligner``, ``alignment_update``, ``normalizer``,
``alignment_to_data_frame`` of its ``monica/genomes/aligner.py``) touches
mappy only through ``index.map(seq)``.  So the reference's own code runs
end to end offline:

* its source is read from the reference checkout at run time and exec'd
  (never copied into the repo): ``reference_aligner_path`` takes it from
  ``$MONICA_REFERENCE`` (the checkout's root), or a caller passes it;
* ``mappy`` is replaced by a stub whose ``Aligner.map(seq)`` replays
  scripted hits keyed by the exact read sequence;
* ``Bio.SeqIO`` is replaced by a minimal FASTQ reader and writer with
  biopython's title rule (after ``record.id = tax_unit`` the written
  header is ``@<tax_unit> <original description>``);
* the module's import-time ``~/.monica/.root`` read is redirected into a
  sandbox directory.

The reference needs pandas for its tables; nothing else here does, and
it is imported only inside the functions that run the reference.  The
same reads (identical FASTQ bytes) go through the port's product path
(``build_index_from_arrays`` -> ``runtime.Classifier`` on a device or a
mesh -> ``run_once``), and the two sides are diffed: per-read route,
mapped-read id rewrite, count tables per mode, and the tables cell by
cell (``diff_tables`` reads the port's CSVs without pandas).
"""

from __future__ import annotations

import contextlib
import os
import sys
import types
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from monica_tpu_torch.evaluation import simulate_read_codes

_PKG = "_monica_refexec"

BASES = "ACGT"


def reference_aligner_path() -> Path | None:
    """The reference's ``monica/genomes/aligner.py`` under
    ``$MONICA_REFERENCE``, or None when the variable is not set."""
    root = os.environ.get("MONICA_REFERENCE")
    return Path(root) / "monica" / "genomes" / "aligner.py" if root else None


def reference_available(aligner: str | os.PathLike | None = None) -> bool:
    aligner = Path(aligner) if aligner is not None else reference_aligner_path()
    return aligner is not None and aligner.exists()


# ---------------------------------------------------------------------------
# stub dependency modules
# ---------------------------------------------------------------------------

def _make_mappy_stub() -> types.ModuleType:
    """A ``mappy`` module whose Aligner replays scripted hits.

    The reference reads ``hit.is_primary``, ``hit.mapq``, ``hit.ctg``,
    ``hit.NM``, ``hit.mlen`` (`aligner.py:193-195`); ``Aligner`` is
    constructed from an index path (`aligner.py:45,59`) and must be
    truthy (`aligner.py:47,60`)."""
    m = types.ModuleType("mappy")

    class Hit:
        __slots__ = ("ctg", "NM", "mlen", "is_primary", "mapq")

        def __init__(self, ctg, NM, mlen, is_primary=True, mapq=60):
            self.ctg = ctg
            self.NM = int(NM)
            self.mlen = int(mlen)
            self.is_primary = bool(is_primary)
            self.mapq = int(mapq)

        def __repr__(self):
            return f"Hit({self.ctg}, NM={self.NM}, mlen={self.mlen})"

    registry: dict[str, dict[str, list]] = {}

    class Aligner:
        def __init__(self, fn_idx_in=None, preset=None, best_n=None, fn_idx_out=None):
            # indexer() registers under fn_idx_out; index_loader opens
            # fn_idx_in (aligner.py:45-46,59)
            self._table = registry.get(str(fn_idx_in or fn_idx_out), {})

        def __bool__(self):
            return True

        def map(self, seq):
            return list(self._table.get(seq, ()))

    m.Hit = Hit
    m.Aligner = Aligner
    m._registry = registry
    return m


class _StubSeq(str):
    """str with reverse-complement-free Seq surface: the reference only
    calls ``str(record.seq)`` and ``len(record.seq)``."""


class _StubRecord:
    __slots__ = ("id", "description", "seq", "qual")

    def __init__(self, rid, description, seq, qual):
        self.id = rid
        self.description = description
        self.seq = _StubSeq(seq)
        self.qual = qual


def _fastq_title(record: _StubRecord) -> str:
    """biopython's as_fastq/as_fasta title rule (Bio.SeqIO.QualityIO):
    keep the description if its first token is still the id, otherwise
    prepend the (rewritten) id."""
    id_ = record.id or ""
    desc = record.description or ""
    if desc and desc.split(None, 1)[0] == id_:
        return desc
    if desc:
        return f"{id_} {desc}"
    return id_


def _make_bio_stub() -> tuple[types.ModuleType, types.ModuleType]:
    bio = types.ModuleType("Bio")
    seqio = types.ModuleType("Bio.SeqIO")

    def parse(source, fmt):
        assert fmt == "fastq", fmt
        fh = open(source) if isinstance(source, (str, os.PathLike)) else source
        try:
            while True:
                header = fh.readline()
                if not header:
                    return
                header = header.rstrip("\n")
                if not header:
                    continue
                assert header.startswith("@"), header
                seq = fh.readline().rstrip("\n")
                plus = fh.readline()
                assert plus.startswith("+"), plus
                qual = fh.readline().rstrip("\n")
                desc = header[1:]
                rid = desc.split(None, 1)[0] if desc.split() else ""
                yield _StubRecord(rid, desc, seq, qual)
        finally:
            if isinstance(source, (str, os.PathLike)):
                fh.close()

    def write(records, handle, fmt):
        assert fmt == "fastq", fmt
        if isinstance(records, _StubRecord):
            records = [records]
        n = 0
        for r in records:
            handle.write(f"@{_fastq_title(r)}\n{r.seq}\n+\n{r.qual}\n")
            n += 1
        return n

    seqio.parse = parse
    seqio.write = write
    bio.SeqIO = seqio
    return bio, seqio


@contextlib.contextmanager
def reference_aligner(sandbox: str | os.PathLike, aligner: str | os.PathLike | None = None):
    """Exec the reference's aligner module inside a sandbox and yield it.

    The module reads ``~/.monica/.root`` at import (`aligner.py:15-16`)
    and resolves ``GENOMES_PATH`` from its sibling fetcher module
    (`aligner.py:13`); both are redirected under ``sandbox``.  The
    yielded module exposes the reference's real functions plus
    ``_mappy`` (the stub, for registering scripted hit tables).
    ``aligner`` defaults to :func:`reference_aligner_path`."""
    aligner = Path(aligner) if aligner is not None else reference_aligner_path()
    if aligner is None or not aligner.exists():
        raise FileNotFoundError(f"the reference's aligner.py: {aligner}")
    sandbox = Path(sandbox)
    home = sandbox / "home"
    (home / ".monica").mkdir(parents=True, exist_ok=True)
    monica_root = sandbox / "monica_root"
    monica_root.mkdir(exist_ok=True)
    (home / ".monica" / ".root").write_text(str(monica_root))
    genomes_path = sandbox / "genomes"
    genomes_path.mkdir(exist_ok=True)

    mappy_stub = _make_mappy_stub()
    bio_stub, seqio_stub = _make_bio_stub()
    pkg = types.ModuleType(_PKG)
    pkg.__path__ = []
    gen = types.ModuleType(f"{_PKG}.genomes")
    gen.__path__ = []
    fetch = types.ModuleType(f"{_PKG}.genomes.fetcher")
    fetch.GENOMES_PATH = str(genomes_path)

    injected = {
        "mappy": mappy_stub,
        "Bio": bio_stub,
        "Bio.SeqIO": seqio_stub,
        _PKG: pkg,
        f"{_PKG}.genomes": gen,
        f"{_PKG}.genomes.fetcher": fetch,
    }
    saved = {k: sys.modules.get(k) for k in injected}
    sys.modules.update(injected)

    mod = types.ModuleType(f"{_PKG}.genomes.aligner")
    mod.__package__ = f"{_PKG}.genomes"
    mod.__file__ = str(aligner)
    real_expanduser = os.path.expanduser

    def fake_expanduser(p):
        if p == "~" or p.startswith("~/"):
            return str(home) + p[1:]
        return real_expanduser(p)

    os.path.expanduser = fake_expanduser
    try:
        exec(compile(aligner.read_text(), str(aligner), "exec"), mod.__dict__)
    finally:
        os.path.expanduser = real_expanduser
    mod._mappy = mappy_stub
    try:
        yield mod
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


# ---------------------------------------------------------------------------
# fixture: genomes + reads with truth + scripted hit evidence
# ---------------------------------------------------------------------------

@dataclass
class ReadSpec:
    rid: str
    seq: str
    kind: str  # clean | shared | random | focus
    true_genome: int  # -1 for random
    # per-index scripted hits: list over indexes of [(ctg, NM, mlen,
    # is_primary, mapq), ...]
    hits: list[list[tuple]]


@dataclass
class ParityFixture:
    genomes: list[np.ndarray]
    tax_units: list[str]
    accessions: list[str]
    # genome id -> stub index number (the reference's database chunks)
    index_of: list[int]
    n_indexes: int
    # passes -> sample name -> list[ReadSpec]
    passes: list[dict[str, list[ReadSpec]]]
    focus_taxa: tuple[str, ...] = ()

    def ctg(self, g: int) -> str:
        # database.py:59 rewrites every record id to species:accession
        return f"{self.tax_units[g]}:{self.accessions[g]}"


def _codes_to_str(codes: np.ndarray) -> str:
    return "".join(BASES[c] for c in codes)


def make_fixture(
    seed: int = 7,
    n_passes: int = 2,
    samples_per_pass: int = 2,
    clean_per_sample: int = 120,
    shared_per_sample: int = 20,
    random_per_sample: int = 20,
    focus_per_sample: int = 20,
    genome_len: int = 240_000,
    read_len: int = 1000,
    error: tuple[float, float, float] = (0.02, 0.01, 0.01),
) -> ParityFixture:
    """Mock community with a genus pair, a shared (conserved) block, a
    focus species, and scripted hit evidence per read.

    Scripting rules (what a truthful aligner reports):
    * clean/focus read from genome g -> one primary hit on g's ctg with
      NM ~= the injected error count; one third also carry a worse-NM
      decoy hit on another ctg (exercises the reference's ``best_hit``
      min-scan, `aligner.py:328-339`) and one sixth a mapq-30 decoy
      (exercises the mapq>=60 filter, `aligner.py:194,216`);
    * shared-block read -> two byte-identical (NM, mlen) hits on both
      carrier ctgs: the reference's exact tie -> ambiguous
      (`aligner.py:336-337`);
    * random read -> no hits -> unmapped.
    """
    rng = np.random.default_rng(seed)
    tax_units = [
        "Escherichia_coli",
        "Escherichia_fergusonii",  # same genus: overnight collapse pair
        "Salmonella_enterica",
        "Bacillus_subtilis",
    ]
    accessions = ["GCF_000001.1", "GCF_000002.1", "GCF_000003.1", "GCF_000004.1"]
    genomes = [
        rng.integers(0, 4, genome_len).astype(np.uint8) for _ in range(4)
    ]
    # conserved block carried by the genus pair (identical bytes)
    shared_len = 3200
    s0, s1 = 50_000, 130_000
    block = rng.integers(0, 4, shared_len).astype(np.uint8)
    genomes[0][s0 : s0 + shared_len] = block
    genomes[1][s1 : s1 + shared_len] = block
    shared_span = {0: (s0, s0 + shared_len), 1: (s1, s1 + shared_len)}

    index_of = [0, 0, 1, 1]  # two stub database chunks
    sub, ins, dele = error
    err_rate = sub + ins + dele
    focus_genome = 2
    focus_taxa = (tax_units[focus_genome],)

    def clean_start(g: int, L: int) -> int:
        """Start of a window avoiding the shared block (+margin)."""
        while True:
            st = int(rng.integers(0, genome_len - L - 64))
            if g in shared_span:
                a, b = shared_span[g]
                if st + L + 600 > a and st < b + 600:
                    continue
            return st

    def sim_from(g: int, start_hint: int | None = None) -> tuple[str, bool]:
        rc = bool(rng.random() < 0.5)
        if start_hint is None:
            st = clean_start(g, read_len + 64)
        else:
            st = start_hint
        window = genomes[g][st : st + read_len + 64]
        codes = simulate_read_codes(
            rng, window, read_len, sub, ins, dele, rc
        )
        return _codes_to_str(codes), rc

    def scripted_nm(L: int) -> int:
        return max(int(round(err_rate * L)), 1)

    n_idx = 2
    passes: list[dict[str, list[ReadSpec]]] = []
    uid = 0
    for p in range(n_passes):
        batch: dict[str, list[ReadSpec]] = {}
        for snum in range(samples_per_pass):
            sample = f"sample{snum}"
            reads: list[ReadSpec] = []

            def empty_hits():
                return [[] for _ in range(n_idx)]

            for _ in range(clean_per_sample):
                g = int(rng.integers(0, 4))
                seq, _rc = sim_from(g)
                nm = scripted_nm(len(seq))
                hits = empty_hits()
                hits[index_of[g]].append((g, nm, len(seq) - nm, True, 60))
                r = rng.random()
                if r < 1 / 3:  # worse-NM decoy on a different genome
                    d = int((g + 1 + rng.integers(0, 3)) % 4)
                    hits[index_of[d]].append(
                        (d, nm * 3 + 5, len(seq) - nm, True, 60)
                    )
                elif r < 1 / 2:  # sub-threshold decoy (filtered out)
                    d = int((g + 1 + rng.integers(0, 3)) % 4)
                    hits[index_of[d]].append(
                        (d, nm, len(seq) - nm, True, 30)
                    )
                reads.append(ReadSpec(f"read{uid:06d}", seq, "clean", g, hits))
                uid += 1

            for _ in range(focus_per_sample):
                g = focus_genome
                seq, _rc = sim_from(g)
                nm = scripted_nm(len(seq))
                hits = empty_hits()
                hits[index_of[g]].append((g, nm, len(seq) - nm, True, 60))
                reads.append(ReadSpec(f"read{uid:06d}", seq, "focus", g, hits))
                uid += 1

            for _ in range(shared_per_sample):
                # fully inside the shared block with >=700 bases margin
                off = int(rng.integers(700, shared_len - read_len - 64 - 700))
                g = int(rng.integers(0, 2))
                st = shared_span[g][0] + off
                seq, _rc = sim_from(g, start_hint=st)
                nm = scripted_nm(len(seq))
                hits = empty_hits()
                # byte-identical evidence on both carriers -> exact tie
                hits[index_of[0]].append((0, nm, len(seq) - nm, True, 60))
                hits[index_of[1]].append((1, nm, len(seq) - nm, True, 60))
                reads.append(ReadSpec(f"read{uid:06d}", seq, "shared", g, hits))
                uid += 1

            for _ in range(random_per_sample):
                seq = _codes_to_str(
                    rng.integers(0, 4, read_len).astype(np.uint8)
                )
                reads.append(
                    ReadSpec(f"read{uid:06d}", seq, "random", -1, empty_hits())
                )
                uid += 1

            rng.shuffle(reads)
            batch[sample] = reads
        passes.append(batch)

    return ParityFixture(
        genomes=genomes,
        tax_units=tax_units,
        accessions=accessions,
        index_of=index_of,
        n_indexes=n_idx,
        passes=passes,
        focus_taxa=focus_taxa,
    )


def write_sample_fastq(path: Path, reads: list[ReadSpec]) -> None:
    with open(path, "w") as fh:
        for r in reads:
            fh.write(f"@{r.rid} parity\n{r.seq}\n+\n{'I' * len(r.seq)}\n")


# ---------------------------------------------------------------------------
# run the reference
# ---------------------------------------------------------------------------

@dataclass
class RouteTable:
    """Per-sample read routes parsed back from the routed folders."""

    # sample -> read id -> (route, tax_unit-or-None)
    routes: dict[str, dict[str, tuple[str, str | None]]] = field(
        default_factory=dict
    )
    # sample -> set of focus read ids
    focus: dict[str, set[str]] = field(default_factory=dict)
    # sample -> read id -> read length (for query_length counting)
    lengths: dict[str, dict[str, int]] = field(default_factory=dict)


def _parse_routed(query_folder: Path, samples: list[str]) -> RouteTable:
    """Parse mapped/unmapped/ambiguous/focus folders back into routes.

    Mapped headers are ``@<tax_unit> <orig_id> ...`` (id rewrite +
    biopython title rule); the other routes keep the original header."""
    out = RouteTable()
    for sample in samples:
        routes: dict[str, tuple[str, str | None]] = {}
        lengths: dict[str, int] = {}
        fname = f"{sample}.fastq"
        for route in ("mapped", "unmapped", "ambiguous"):
            p = query_folder / route / fname
            if not p.exists():
                continue
            for rid, tax, L in _iter_fastq_routes(p, mapped=route == "mapped"):
                routes[rid] = (route, tax)
                lengths[rid] = L
        fset: set[str] = set()
        p = query_folder / "focus" / fname
        if p.exists():
            for rid, _tax, _L in _iter_fastq_routes(p, mapped=False):
                fset.add(rid)
        out.routes[sample] = routes
        out.focus[sample] = fset
        out.lengths[sample] = lengths
    return out


def _iter_fastq_routes(path: Path, mapped: bool):
    with open(path) as fh:
        while True:
            header = fh.readline()
            if not header:
                return
            header = header.rstrip("\n")
            if not header:
                continue
            seq = fh.readline().rstrip("\n")
            fh.readline()  # +
            fh.readline()  # qual
            toks = header[1:].split()
            if mapped:
                tax, rid = toks[0], toks[1]
            else:
                tax, rid = None, toks[0]
            yield rid, tax, len(seq)


def run_reference(
    mod,
    fixture: ParityFixture,
    work: Path,
    mode: str = "basic",
    overnight: bool = False,
    with_focus: bool = True,
) -> tuple[RouteTable, dict, dict]:
    """Run the reference's multi_threaded_aligner over every pass.

    Returns (routes, final alignment dict, genomes_length dict)."""
    work = Path(work)
    qdir = work / "query"
    outdir = work / "out"
    qdir.mkdir(parents=True, exist_ok=True)
    outdir.mkdir(parents=True, exist_ok=True)

    # register scripted hit tables, one per stub index chunk
    idx_paths = [str(work / f"index{i}.mmi") for i in range(fixture.n_indexes)]
    for i, path in enumerate(idx_paths):
        table: dict[str, list] = {}
        for batch in fixture.passes:
            for reads in batch.values():
                for r in reads:
                    hs = [
                        mod._mappy.Hit(fixture.ctg(g), nm, ml, pr, mq)
                        for (g, nm, ml, pr, mq) in r.hits[i]
                    ]
                    if hs:
                        table[r.seq] = hs
        mod._mappy._registry[path] = table

    samples = sorted({s for batch in fixture.passes for s in batch})
    focus = list(fixture.focus_taxa) if with_focus else []
    cwd = os.getcwd()
    alignment: dict = {}
    try:
        for batch in fixture.passes:
            for sample, reads in batch.items():
                write_sample_fastq(qdir / f"{sample}.fastq", reads)
            alignment = mod.multi_threaded_aligner(
                str(qdir),
                idx_paths,
                mode=mode,
                mapping_quality=60,
                overnight=overnight,
                n_threads=2,
                focus_species=focus,
                output_folder=str(outdir),
            )
    finally:
        os.chdir(cwd)
    routes = _parse_routed(qdir, samples)
    glens = {
        fixture.accessions[g]: len(fixture.genomes[g]) for g in range(4)
    }
    return routes, alignment, glens


# ---------------------------------------------------------------------------
# run the port on the identical reads
# ---------------------------------------------------------------------------

def run_ours(
    fixture: ParityFixture,
    work: Path,
    mode: str = "basic",
    overnight: bool = False,
    with_focus: bool = True,
    n_shards: int = 2,
    *,
    device=None,
    mesh=None,
):
    """Classify the same reads through the port's product path on
    ``device`` (or ``mesh``; the index is built on the host for a mesh,
    else on ``device``); returns (routes, AbundanceState, BuiltIndex)."""
    from monica_tpu_torch.align import pipeline as pl
    from monica_tpu_torch.align import runtime as rt
    from monica_tpu_torch.index.build import build_index_from_arrays
    from monica_tpu_torch.stats.abundance import AbundanceState

    work = Path(work)
    qdir = work / "query"
    outdir = work / "out"
    qdir.mkdir(parents=True, exist_ok=True)
    outdir.mkdir(parents=True, exist_ok=True)

    built = build_index_from_arrays(
        fixture.genomes,
        tax_units=fixture.tax_units,
        accessions=fixture.accessions,
        n_shards=n_shards,
        device="cpu" if mesh is not None else device,
    )
    clf = rt.Classifier(built, pl.ClassifyParams(), count_mode=mode, device=device, mesh=mesh)
    focus = frozenset(fixture.focus_taxa) if with_focus else frozenset()
    samples = sorted({s for batch in fixture.passes for s in batch})
    for batch in fixture.passes:
        for sample, reads in batch.items():
            write_sample_fastq(qdir / f"{sample}.fastq", reads)
        rt.run_once(clf, qdir, outdir, focus_taxa=focus, overnight=overnight, delete=True)
    state = AbundanceState.load(outdir, built.meta.n_accessions)
    return _parse_routed(qdir, samples), state, built


# ---------------------------------------------------------------------------
# diffing
# ---------------------------------------------------------------------------

def diff_routes(ref: RouteTable, ours: RouteTable) -> dict:
    """Per-read route agreement: same route AND (when mapped) the same
    written tax unit, plus focus-copy agreement."""
    n = agree = 0
    confusion: Counter = Counter()
    focus_n = focus_agree = 0
    for sample, ref_routes in ref.routes.items():
        our_routes = ours.routes.get(sample, {})
        for rid, (r_route, r_tax) in ref_routes.items():
            o_route, o_tax = our_routes.get(rid, ("missing", None))
            n += 1
            same = r_route == o_route and (r_route != "mapped" or r_tax == o_tax)
            agree += same
            if not same:
                confusion[f"{r_route}:{r_tax}->{o_route}:{o_tax}"] += 1
        rf, of = ref.focus.get(sample, set()), ours.focus.get(sample, set())
        focus_n += len(rf | of)
        focus_agree += len(rf & of)
    return dict(
        n_reads=n,
        n_agree=agree,
        agreement=agree / max(n, 1),
        disagreements=dict(confusion.most_common(20)),
        focus_union=focus_n,
        focus_intersection=focus_agree,
    )


def expected_alignment_from_routes(
    routes: RouteTable,
    fixture: ParityFixture,
    mode: str,
    overnight: bool,
) -> dict:
    """Reference-rule count dict derived from a side's routed outputs:
    mapped read -> counter[tax_unit][accession] += 1 | len
    (`aligner.py:247-257`; matching mode is not reconstructable from
    routes alone).  With ``overnight`` the written tax unit is already
    the genus; accession resolves via the fixture's species->accession
    bijection from the route's tax unit at species level, so overnight
    reconstruction keys on genus but still needs species routes —
    callers pass overnight=False routes for that case."""
    assert mode in ("basic", "query_length")
    tax_to_acc = dict(zip(fixture.tax_units, fixture.accessions))
    out: dict = {}
    for sample, rr in routes.routes.items():
        sa: dict = {}
        for rid, (route, tax) in rr.items():
            if route != "mapped":
                continue
            acc = tax_to_acc[tax]
            key = tax.split("_")[0] if overnight else tax
            val = 1 if mode == "basic" else routes.lengths[sample][rid]
            sa.setdefault(key, Counter())[acc] += val
        out[sample] = sa
    return out


def state_to_alignment(state, meta, overnight: bool = False) -> dict:
    """Our AbundanceState -> the reference's nested alignment dict
    shape {sample: {tax_unit: Counter({accession: count})}} with the
    overnight genus collapse applied at the tax-unit key
    (`aligner.py:237-239,247-263`)."""
    out: dict = {}
    for sample, counts in state.samples.items():
        sa: dict = {}
        for i, c in enumerate(counts):
            if c:
                tax = meta.tax_units[i]
                if overnight:
                    tax = tax.split("_")[0]
                sa.setdefault(tax, Counter())[meta.accessions[i]] += int(c)
        out[sample] = sa
    return out


def diff_alignment_dicts(a: dict, b: dict) -> dict:
    """Exact nested-dict comparison; returns {equal, mismatches}."""
    mism = []
    for sample in sorted(set(a) | set(b)):
        sa, sb = a.get(sample, {}), b.get(sample, {})
        for tax in sorted(set(sa) | set(sb)):
            ca, cb = Counter(sa.get(tax, {})), Counter(sb.get(tax, {}))
            if ca != cb:
                mism.append(
                    dict(sample=sample, tax=tax, a=dict(ca), b=dict(cb))
                )
    return dict(equal=not mism, mismatches=mism[:10], n_mismatches=len(mism))


def reference_tables(mod, alignment: dict, glens: dict, outdir: Path):
    """Run the reference's own normalizer + alignment_to_data_frame on
    an alignment dict (the golden table path, `aligner.py:305-325`)."""
    import copy

    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    raw_df = mod.alignment_to_data_frame(
        copy.deepcopy(alignment), output_folder=str(outdir),
        filename="raw_monica.dataframe",
    )
    norm = mod.normalizer(copy.deepcopy(alignment), genomes_length=glens)
    norm_df = mod.alignment_to_data_frame(
        norm, output_folder=str(outdir), filename="monica.dataframe"
    )
    return norm_df, raw_df


def _table_parts(t):
    """(row labels, column labels, float values) of a pandas DataFrame
    with a 2-level row index (duck-typed: pandas is not imported) or of
    the port's ``stats.abundance.Table``, rows sorted by label."""
    if hasattr(t, "to_numpy"):
        index, columns, values = list(t.index), list(t.columns), t.to_numpy(dtype=float)
    else:
        index, columns, values = list(t.index), list(t.samples), np.asarray(t.values, float)
    index = [tuple(str(x) for x in row) for row in index]
    order = sorted(range(len(index)), key=lambda i: index[i])
    return [index[i] for i in order], [str(c) for c in columns], values[order]


def diff_tables(ref_df, our_df, rtol: float = 1e-9) -> dict:
    """Structural and cellwise comparison of two tables of (tax_unit,
    accession) rows by sample columns: the reference's DataFrames, or the
    port's tables as ``read_dataframe`` reads its CSVs.  Row-label NAMES
    are ignored (the reference emits unnamed levels, the export names
    them tax_unit and accession)."""
    ri, rc, a = _table_parts(ref_df)
    oi, oc, b = _table_parts(our_df)
    same_rows = ri == oi
    same_cols = rc == oc
    cell_ok = False
    max_rel = None
    if same_rows and same_cols:
        both_nan = np.isnan(a) & np.isnan(b)
        denom = np.maximum(np.abs(a), 1e-300)
        rel = np.abs(a - b) / denom
        rel[both_nan] = 0.0
        nan_mismatch = np.isnan(a) != np.isnan(b)
        cell_ok = bool(not nan_mismatch.any() and (not rel.size or np.nanmax(rel) <= rtol))
        max_rel = float(np.nanmax(rel)) if rel.size else 0.0
    return dict(same_rows=same_rows, same_cols=same_cols, cells_equal=cell_ok,
                max_rel_err=max_rel)
