"""End-to-end orchestration — counterpart of ``monica_tpu/orchestrate.py``:
fetch -> build or load the cached index groups -> classify -> tables
-> barplot -> the focus second pass.

* the guests (G_), per-host (H_) and focus (F_) index groups are cached
  under ``<root>/indexes/<group_string>`` as artifacts in the JAX
  package's format, rebuilt only when the fetched genome set changed;
* the groups merge into one index (``merge_built``) and one
  ``Classifier`` on the configured device;
* the focus pass re-classifies ``<query>/focus`` against the
  strain-level F_ index into ``<output>/focus``.

Every build and every ``Classifier`` runs on ``AnalysisConfig.device``,
or on a mesh of the visible CUDA cards (``resolve_mesh``) when
``n_data`` asks for more than one device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path

import torch

from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.align import runtime as rt
from monica_tpu_torch.data import fetcher as gfetcher
from monica_tpu_torch.data import tables as gtables
from monica_tpu_torch.data.taxonomy import Taxonomy
from monica_tpu_torch.index import artifact
from monica_tpu_torch.index.build import BuiltIndex, build_index, merge_built
from monica_tpu_torch.parallel import dist
from monica_tpu_torch.parallel import mesh as pm
from monica_tpu_torch.plots import barplot
from monica_tpu_torch.stats.abundance import AbundanceState, export_tables
from monica_tpu_torch.utils import root as rootutil
from monica_tpu_torch.utils.metrics import Metrics


@dataclass
class DataContext:
    """Everything the fetch layer needs; the transports are injectable so
    tests and air-gapped deployments run offline."""

    root: Path
    taxonomy: Taxonomy
    downloader: gtables.Downloader = gtables.urllib_downloader
    genome_downloader: gtables.Downloader | None = None
    genomes_dir_override: Path | None = None  # -g/--genomes_folder

    @property
    def tables_dir(self) -> Path:
        return rootutil.tables_dir(self.root)

    @property
    def genomes_dir(self) -> Path:
        if self.genomes_dir_override is not None:
            return Path(self.genomes_dir_override)
        return rootutil.genomes_dir(self.root)

    def gdl(self) -> gtables.Downloader:
        return self.genome_downloader or self.downloader


def expand_species_args(values: list[str] | None) -> list[str]:
    """Species CLI values may be files listing one taxon per line."""
    names: list[str] = []
    for v in values or []:
        if os.path.exists(v):
            names += [l for l in open(v).read().splitlines() if l.strip()]
        else:
            names.append(v)
    return names


def group_string(
    prefix: str, species: list[str], mode: str, n_shards: int, k: int, w: int,
    frac: float = 1.0,
) -> str:
    """Cache key of an index group: the G_/H_/F_ prefix, the species, the
    selection mode and the build parameters."""
    fs = "" if frac == 1.0 else f"f{frac:g}"
    return f"{prefix}_{'_'.join(species)}_m_{mode}_k{k}w{w}s{n_shards}{fs}"


def _display_names(species: list[str]) -> list[str]:
    return [" ".join(s.split("_")) for s in species]


def resolve_group_index(
    ctx: DataContext,
    prefix: str,
    species: list[str],
    mode: str,
    n_shards: int,
    k: int,
    w: int,
    max_shard_bytes: int | None = None,
    extra_index_dirs: list[str] | None = None,
    format_genomes=None,
    keep_genomes: bool = True,
    fetch_mode: str | None = None,
    metrics: Metrics | None = None,
    frac: float = 1.0,
    *,
    device,
) -> BuiltIndex | None:
    """Fetch the genomes of one species group and return its index:
    the cached artifact when the genome set did not change, else a new
    build on ``device``, saved over the cache."""
    if not species:
        return None
    metrics = metrics or Metrics(verbose=False)
    gs = group_string(prefix, species, mode, n_shards, k, w, frac)
    idir = rootutil.indexes_dir(ctx.root)

    # cache resolution order: explicit dirs > outside registry > inside
    candidates = []
    for d in extra_index_dirs or []:
        if Path(d).name == gs:
            candidates.append(Path(d))
    candidates += [p for p in artifact.list_indexes(idir, ctx.root) if p.name == gs]

    with metrics.stage(f"fetch:{gs}"):
        table = gfetcher.ftp_selector(
            fetch_mode or mode, _display_names(species), ctx.taxonomy,
            ctx.tables_dir, ctx.downloader,
        )
        if prefix == "F":
            genomes, updated = gfetcher.focus_fetcher(
                table, ctx.genomes_dir, keep_genomes=keep_genomes, downloader=ctx.gdl(),
            )
        else:
            genomes, updated = gfetcher.fetcher(
                table, ctx.genomes_dir, keep_genomes=keep_genomes,
                format_genomes=format_genomes, downloader=ctx.gdl(),
            )

    if candidates and not updated:
        with metrics.stage(f"load_index:{gs}"):
            return artifact.load_index(candidates[-1])

    if not genomes:
        return None
    target = candidates[-1] if candidates else idir / gs
    rt.touch_sentinel(ctx.root, rt.S_ENTERED_INDEXER)
    with metrics.stage(f"build_index:{gs}", items=len(genomes)):
        built = build_index(
            genomes, n_shards=n_shards, max_shard_bytes=max_shard_bytes, k=k, w=w,
            frac=frac, device=device,
        )
        artifact.save_index(built, target)
    rt.touch_sentinel(ctx.root, rt.S_FINISHED_INDEXING)
    rt.touch_sentinel(ctx.root, rt.S_DATABASE_CREATED)
    return built


@dataclass
class AnalysisConfig:
    query_folder: str
    output_folder: str | None = None
    guests: list[str] = field(default_factory=list)
    hosts: list[str] = field(default_factory=list)
    focus: list[str] = field(default_factory=list)
    mode: str = "single"  # database selection mode
    alignment_mode: str = "query_length"  # count mode
    n_shards: int = 1
    max_shard_bytes: int | None = None  # -im byte budget per shard
    k: int = 15
    w: int = 10
    frac: float = 1.0  # scaled-winnowing fraction (index and query side)
    extend: bool = True
    band: int = 64
    reads_threshold: float = 0.0
    show_legend: bool = True
    auto_open: bool = False
    keep_genomes: bool = True
    format_genomes: str | None = None
    indexes: list[str] = field(default_factory=list)
    overnight: bool = False
    watch: bool = False
    poll_s: float = 5.0
    max_idle_polls: int | None = 1
    max_batch: int = 4096
    # data-parallel axis size: 1 = one device, -1 = every device, N > 1 =
    # exactly N; the device need is n_data x the index axis
    n_data: int = 1
    device: str = "cuda"  # where every index build and Classifier runs


def resolve_mesh(n_data: int, n_shards: int, device):
    """The ('data', 'index') mesh a run needs, or None for one device.
    The index axis is sized as in the JAX package: the largest divisor of
    the device count that is <= n_shards when n_data is 'auto' (every
    device used, data parallelism kept: 5 shards on 8 devices give
    (data=2, index=4), not (1, 5)), else min(n_shards, devices //
    n_data).  The devices are the visible CUDA cards of every process
    (a CPU device counts as one); the policy never repeats a device, as
    repeated devices are a library and test tool, not a CLI route.  A
    multi-process mesh must span every process's devices."""
    if not n_data or n_data == 1:
        return None
    local = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
             if torch.device(device).type == "cuda" else [torch.device(device)])
    n_dev = len(local) * dist.process_count()
    if n_data == -1:
        n_index = max(d for d in range(1, n_dev + 1)
                      if n_dev % d == 0 and d <= max(n_shards, 1))
        n_data = n_dev // n_index
    else:
        if n_data > n_dev:
            raise SystemExit(
                f"--n_data {n_data} needs {n_data} devices, but only {n_dev} are available"
            )
        n_index = min(max(n_shards, 1), n_dev // n_data)
    need = n_data * n_index
    if need == 1:
        return None
    if dist.process_count() > 1 and need != n_dev:
        # a mesh over a subset can leave a process without data rows,
        # breaking the per-process feed contract: refuse, not deadlock
        raise SystemExit(
            f"a multi-process mesh must span all {n_dev} devices, but n_data={n_data} x "
            f"n_index={n_index} = {need}; adjust --n_data/-n (or use --n_data auto)"
        )
    return pm.make_mesh(n_data, n_index, devices=local)


def _classifier(built: BuiltIndex, params: pl.ClassifyParams, cfg: AnalysisConfig):
    """The run's Classifier: on the mesh ``resolve_mesh`` gives, else on
    ``cfg.device``."""
    mesh = resolve_mesh(cfg.n_data, len(built.shards), cfg.device)
    return rt.Classifier(built, params, count_mode=cfg.alignment_mode,
                         device=None if mesh else cfg.device, mesh=mesh)


def run_analysis(ctx: DataContext, cfg: AnalysisConfig, metrics: Metrics | None = None):
    """The default run: resolve the index groups, classify every sample
    in the query folder (once, or polling with ``watch``), write the
    tables and the barplot, then the focus second pass."""
    metrics = metrics or Metrics()
    query = Path(cfg.query_folder)
    output = Path(cfg.output_folder or query / "monica_output")
    output.mkdir(parents=True, exist_ok=True)
    rootutil.dump_params(ctx.root, vars(cfg))

    guests = expand_species_args(cfg.guests)
    hosts = expand_species_args(cfg.hosts)
    focus = expand_species_args(cfg.focus)
    if cfg.mode == "overnight":
        cfg.overnight = True

    # a fresh run starts from an empty accumulator
    AbundanceState.clear(output)

    parts = []
    g_built = resolve_group_index(
        ctx, "G", guests, cfg.mode, cfg.n_shards, cfg.k, cfg.w,
        max_shard_bytes=cfg.max_shard_bytes,
        extra_index_dirs=cfg.indexes, format_genomes=cfg.format_genomes,
        keep_genomes=cfg.keep_genomes, metrics=metrics, frac=cfg.frac, device=cfg.device,
    )
    if g_built:
        parts.append(g_built)
    for host in hosts:
        h_built = resolve_group_index(
            ctx, "H", [host], "single", 1, cfg.k, cfg.w,
            extra_index_dirs=cfg.indexes, format_genomes=cfg.format_genomes,
            keep_genomes=cfg.keep_genomes, fetch_mode="single", metrics=metrics,
            frac=cfg.frac, device=cfg.device,
        )
        if h_built:
            parts.append(h_built)
    if not parts:
        print("No indexes available — nothing to align against")
        return None

    built = merge_built(parts)
    params = pl.ClassifyParams(extend=cfg.extend, band=cfg.band)
    classifier = _classifier(built, params, cfg)

    focus_units = frozenset("_".join(f.split(" ")) for f in focus)

    def export_and_plot(_reports):
        state = AbundanceState.load(output, built.meta.n_accessions)
        if not state.samples:
            return
        # overnight: genus-collapsed tax units in the exported tables
        norm, raw = export_tables(state, built.meta, output, overnight=cfg.overnight)
        barplot.plotter(
            norm, raw, output,
            reads_threshold=cfg.reads_threshold,
            hosts=hosts, guests=guests, mode=cfg.mode,
            show_legend=cfg.show_legend, auto_open=cfg.auto_open,
        )

    run_kwargs = dict(focus_taxa=focus_units, overnight=cfg.overnight,
                      metrics=metrics, max_batch=cfg.max_batch)
    if cfg.watch:
        reports = rt.watch(classifier, query, output, poll_s=cfg.poll_s,
                           max_idle_polls=cfg.max_idle_polls, on_batch=export_and_plot,
                           **run_kwargs)
    else:
        reports = rt.run_once(classifier, query, output, **run_kwargs)
        export_and_plot(reports)

    if not reports:
        print("Mapping on selected database did not produce any result")
        return reports

    # the focus second pass
    if focus:
        f_built = resolve_group_index(
            ctx, "F", focus, "focus", 1, cfg.k, cfg.w,
            extra_index_dirs=cfg.indexes, keep_genomes=cfg.keep_genomes,
            fetch_mode="focus", metrics=metrics, frac=cfg.frac, device=cfg.device,
        )
        focus_query = query / rt.FOCUS_DIR
        if f_built and focus_query.exists():
            print("Entering focus mode")
            focus_out = output / "focus"
            focus_out.mkdir(parents=True, exist_ok=True)
            AbundanceState.clear(focus_out)
            f_clf = _classifier(f_built, params, cfg)
            f_reports = rt.run_once(f_clf, focus_query, focus_out, metrics=metrics,
                                    max_batch=cfg.max_batch)
            if f_reports:
                f_state = AbundanceState.load(focus_out, f_built.meta.n_accessions)
                f_norm, f_raw = export_tables(f_state, f_built.meta, focus_out)
                barplot.plotter(
                    f_norm, f_raw, focus_out, reads_threshold=0,
                    guests=focus, mode="focus",
                    show_legend=cfg.show_legend, auto_open=cfg.auto_open,
                )
            else:
                print("Mapping on selected database to focus on did not produce any result")
    return reports


def build_index_only(
    ctx: DataContext, cfg: AnalysisConfig, indexes_folder: str | None = None,
    metrics: Metrics | None = None,
) -> list[Path]:
    """Fetch, build and cache every configured group without classifying
    (``build_index``); ``indexes_folder`` saves and registers them
    outside the root.  Prints and returns the index folders."""
    metrics = metrics or Metrics()
    built_paths: list[Path] = []
    guests = expand_species_args(cfg.guests)
    hosts = expand_species_args(cfg.hosts)
    focus = expand_species_args(cfg.focus)
    idir = rootutil.indexes_dir(ctx.root)
    groups = []
    if guests:
        groups.append(("G", guests, cfg.mode, cfg.n_shards, cfg.mode))
    for h in hosts:
        groups.append(("H", [h], "single", 1, "single"))
    if focus:
        groups.append(("F", focus, "focus", 1, "focus"))
    for prefix, species, mode, n_shards, fetch_mode in groups:
        built = resolve_group_index(
            ctx, prefix, species, mode, n_shards, cfg.k, cfg.w,
            keep_genomes=cfg.keep_genomes, format_genomes=cfg.format_genomes,
            fetch_mode=fetch_mode, metrics=metrics, frac=cfg.frac, device=cfg.device,
        )
        if built is None:
            continue
        gs = group_string(prefix, species, mode, n_shards, cfg.k, cfg.w, cfg.frac)
        target = idir / gs
        if indexes_folder:
            outside = Path(indexes_folder) / gs
            if not artifact.is_index_dir(outside):
                artifact.save_index(built, outside)
            artifact.register_outside_index(ctx.root, outside)
            built_paths.append(outside)
        else:
            built_paths.append(target)
    for p in built_paths:
        print(p)
    return built_paths
