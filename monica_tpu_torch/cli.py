"""monica_tpu_torch command-line interface — counterpart of
``monica_tpu/cli.py``, with the same flag groups, subcommands and aliases:
the default analysis run, ``build_index`` (``index``, ``build``),
``list_indexes`` (``list``, ``indexes``), ``plot_only`` (``plot``) and
``initialize`` (``init``), species values that may be files listing
taxa, the ``human_readable`` memory type and the offline transports
(``--offline_tables``, ``--taxdump``, ``--offline_genomes``).

One flag is new: ``--device`` (default ``cuda``), where every index
build and classification runs.  Without a card, ``--device cuda``
exits with an error; the CLI never moves a run to the CPU.  ``--n_data``
other than 1 classifies on a mesh of the visible cards, and
``--multihost`` joins a ``torch.distributed`` process group first (NCCL
with ``--device cuda``, gloo with ``--device cpu``); there is no
compilation cache to enable.

    python -m monica_tpu_torch.cli --root R build_index -G "Escherichia coli" \\
        --taxdump T --offline_tables S S --offline_genomes D
    python -m monica_tpu_torch.cli --root R -q query/ -G "Escherichia coli" ...
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

import torch

from monica_tpu_torch import __version__
from monica_tpu_torch.utils import root as rootutil
from monica_tpu_torch.utils.units import human_readable


class SmartFormatter(argparse.HelpFormatter):
    """'R|' prefix: help text printed with its own line breaks."""

    def _split_lines(self, text, width):
        if text.startswith("R|"):
            return text[2:].splitlines()
        return super()._split_lines(text, width)


def _common_parser() -> argparse.ArgumentParser:
    """Flags shared by the default run and ``build_index`` (a parents=
    parser, so they are valid after the subcommand too)."""
    p = argparse.ArgumentParser(add_help=False)
    io = p.add_argument_group("I/O parameters", "input and output handling")
    inp = io.add_mutually_exclusive_group()
    inp.add_argument("-q", "--query_folder", help="folder with *.fastq sample files")
    inp.add_argument("-f5", "--fast5_folder", help="accepted for parity; treated as a fastq folder")
    io.add_argument("-o", "--output_folder", help="defaults to <query>/monica_output")
    io.add_argument("-i", "--indexes", nargs="*", default=[], help="extra index folders to use")
    io.add_argument("-g", "--genomes_folder", help="genome cache folder")
    io.add_argument("-k", "--keep_genomes", choices=["yes", "no"], default="yes")
    io.add_argument("--format_genomes", help="folder of pre-downloaded *.fna.gz genomes")

    db = p.add_argument_group("Database parameters", "species composition of the database")
    db.add_argument("-G", "--guest_species", nargs="*", help="species names or files listing them")
    db.add_argument("-H", "--host_species", nargs="*")
    db.add_argument("-F", "--focus_species", nargs="*")
    db.add_argument("-m", "--mode", choices=["single", "all", "overnight"], default="single")

    al = p.add_argument_group("Alignment parameters")
    al.add_argument("-a", "--alignment_mode", default="query_length",
                    choices=["basic", "query_length", "matching"])
    al.add_argument("--extend", action=argparse.BooleanOptionalAction, default=True,
                    help="banded Smith-Waterman refinement + low-seed rescue "
                         "(CUDA kernel; --no-extend for the seed-vote-only fast path)")
    al.add_argument("--band", type=int, default=64,
                    help="extension band width (<=64 uses the two-reads-per-row kernel)")
    al.add_argument("--frac", type=float, default=1.0,
                    help="scaled-winnowing fraction (0<f<=1): subsample minimizers on "
                         "BOTH index and query sides")

    pt = p.add_argument_group("Plotting parameters")
    pt.add_argument("--not_auto_open_plot", action="store_true")
    pt.add_argument("--not_show_legend", action="store_true")
    pt.add_argument("-R", "--reads_threshold", type=float, default=0)

    comp = p.add_argument_group("Computational parameters")
    comp.add_argument("--device", default="cuda",
                      help="torch device of every index build and classification "
                           "(default cuda; cpu runs the plain PyTorch versions)")
    comp.add_argument("-n", "--n_shards", type=int, default=1, help="index shards")
    comp.add_argument("--n_data", type=lambda v: -1 if v == "auto" else int(v), default=1,
                      help="data-parallel mesh axis size: the run spans n_data × "
                           "n_shards devices; 'auto' (or -1) uses every visible card; "
                           "1 = single device")
    comp.add_argument("-im", "--indexing_memory", type=human_readable,
                      help="per-shard byte budget, e.g. 4G (alternative to -n)")
    comp.add_argument("-t", "--threads", type=int, default=3,
                      help="accepted for parity; device batching replaces thread fan-out")
    comp.add_argument("--max_batch", type=int, default=4096, help="reads per device batch")
    comp.add_argument("--watch", action="store_true", help="keep polling the query folder")
    comp.add_argument("--poll", type=float, default=5.0, dest="poll_s")
    comp.add_argument("--max_idle_polls", type=int, default=None)
    comp.add_argument("--profile_dir", help="write a torch.profiler Chrome trace here")

    mh = p.add_argument_group(
        "Multi-host parameters",
        "R|torch.distributed wiring: run one monica_tpu_torch process per host\n"
        "with --multihost; the ('data','index') mesh then spans every process's\n"
        "cards.  Per-process contract: each process passes its OWN -q/-o\n"
        "folders and classifies its own sample files (lockstep dispatch handles\n"
        "shape agreement); the per-process output tables' union is the global\n"
        "result.  The backend follows --device: nccl for cuda, gloo for cpu.\n"
        "Without --coordinator the env:// variables (MASTER_ADDR, MASTER_PORT,\n"
        "WORLD_SIZE, RANK) are read.",
    )
    mh.add_argument("--multihost", action="store_true",
                    help="join a torch.distributed process group before building the mesh")
    mh.add_argument("--coordinator", help="host:port of process 0 (omit for env://)")
    mh.add_argument("--num_processes", type=int)
    mh.add_argument("--process_id", type=int)

    off = p.add_argument_group("Offline / transport parameters")
    off.add_argument("--offline_tables", nargs=2, metavar=("REFSEQ_TSV", "GENBANK_TSV"),
                     help="use local assembly-summary TSVs instead of NCBI")
    off.add_argument("--taxdump", help="local NCBI taxdump dir (nodes.dmp/names.dmp)")
    off.add_argument("--offline_genomes",
                     help="serve genome downloads from this folder by URL basename")

    p.add_argument("--root", help="state root override (else $MONICA_TPU_ROOT / ~/.monica_tpu)")
    return p


def build_parser() -> argparse.ArgumentParser:
    common = _common_parser()
    p = argparse.ArgumentParser(
        prog="monica_tpu_torch",
        description="real-time quantitative metagenomics on a CUDA card (PyTorch port)",
        formatter_class=SmartFormatter,
        parents=[common],
    )
    p.add_argument("--version", action="version", version=f"%(prog)s {__version__}")

    sub = p.add_subparsers(dest="command")
    bi = sub.add_parser("build_index", aliases=["index", "build"],
                        formatter_class=SmartFormatter, parents=[common],
                        help="fetch genomes and build indexes without aligning")
    bi.add_argument("--indexes_folder", help="write/register indexes outside the root")
    bi.set_defaults(command="build_index")
    li = sub.add_parser("list_indexes", aliases=["list", "indexes"],
                        help="list cached and registered index folders")
    li.add_argument("--root", default=argparse.SUPPRESS)
    li.set_defaults(command="list_indexes")
    po = sub.add_parser("plot_only", aliases=["plot"], help="re-plot from saved dataframes")
    po.add_argument("-d", "--data_frame", required=True,
                    help="path to monica.dataframe (raw_monica.dataframe is looked up next to it)")
    po.add_argument("--root", default=argparse.SUPPRESS)
    po.add_argument("--not_auto_open_plot", action="store_true")
    po.add_argument("--not_show_legend", action="store_true")
    po.add_argument("-R", "--reads_threshold", type=float, default=0)
    po.set_defaults(command="plot_only")
    ini = sub.add_parser("initialize", aliases=["init"], help="relocate the state root")
    ini.add_argument("-r", "--monica_root_folder", required=True)
    ini.add_argument("--root", default=argparse.SUPPRESS)
    ini.set_defaults(command="initialize")
    return p


def _load_taxonomy(root: Path, taxdump: str | None, downloader=None):
    from monica_tpu_torch.data.taxonomy import Taxonomy

    tax_dir = rootutil.subdir(root, "taxonomy")
    if taxdump:
        t = Taxonomy.from_taxdump(Path(taxdump) / "nodes.dmp", Path(taxdump) / "names.dmp")
        t.save(tax_dir)
        return t
    # the cached taxonomy, refreshed every 14 days through the transport;
    # an offline transport leaves the cache in place
    t = Taxonomy.ensure(tax_dir, downloader=downloader)
    if t is not None:
        return t
    raise SystemExit(
        "no taxonomy available: pass --taxdump <dir with nodes.dmp/names.dmp> "
        "once (it is cached and auto-refreshed under the root afterwards)"
    )


def _make_context(args, root: Path):
    from monica_tpu_torch.data import tables as tb
    from monica_tpu_torch.orchestrate import DataContext

    downloader = tb.urllib_downloader
    if args.offline_tables:
        downloader = tb.fixture_downloader({
            tb.REFSEQ_SUMMARY_URL: args.offline_tables[0],
            tb.GENBANK_SUMMARY_URL: args.offline_tables[1],
        })
    genome_downloader = None
    if args.offline_genomes:
        folder = Path(args.offline_genomes)

        def genome_downloader(url, out):  # noqa: F811
            src = folder / url.rsplit("/", 1)[-1]
            if not src.exists():
                raise FileNotFoundError(url)
            shutil.copyfile(src, out)

    taxonomy = _load_taxonomy(root, args.taxdump, downloader=downloader)
    return DataContext(root=root, taxonomy=taxonomy, downloader=downloader,
                       genome_downloader=genome_downloader,
                       genomes_dir_override=args.genomes_folder)


def _device(name: str) -> str:
    """The --device value, refused when it names CUDA on a machine
    without a card."""
    if torch.device(name).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {name}: torch.cuda.is_available() is false on this machine "
            "(pass --device cpu to run the plain PyTorch versions on the CPU)"
        )
    return name


def _make_config(args):
    from monica_tpu_torch.orchestrate import AnalysisConfig

    query = args.query_folder or args.fast5_folder
    max_shard_bytes = None
    if args.indexing_memory:
        # the index takes ~3-4 bytes per reference base on the device;
        # a quarter of the budget bounds the FASTA bases per shard
        max_shard_bytes = int(args.indexing_memory / 4)
    return AnalysisConfig(
        query_folder=query,
        output_folder=args.output_folder,
        guests=args.guest_species or [],
        hosts=args.host_species or [],
        focus=args.focus_species or [],
        mode=args.mode,
        alignment_mode=args.alignment_mode,
        n_shards=args.n_shards,
        max_shard_bytes=max_shard_bytes,
        extend=args.extend,
        band=args.band,
        frac=args.frac,
        reads_threshold=args.reads_threshold,
        show_legend=not args.not_show_legend,
        auto_open=not args.not_auto_open_plot,
        keep_genomes=args.keep_genomes == "yes",
        format_genomes=args.format_genomes,
        indexes=args.indexes,
        watch=args.watch,
        poll_s=args.poll_s,
        max_idle_polls=args.max_idle_polls if args.watch else 1,
        max_batch=args.max_batch,
        n_data=args.n_data,
        device=_device(args.device),
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    root = rootutil.resolve_root(getattr(args, "root", None))
    command = getattr(args, "command", None)

    if getattr(args, "multihost", False):
        from monica_tpu_torch.parallel import dist

        device = torch.device(_device(args.device))
        dist.multihost_init(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://{args.coordinator}" if args.coordinator else None,
            world_size=args.num_processes, rank=args.process_id,
        )
        n_local = torch.cuda.device_count() if device.type == "cuda" else 1
        print(f"multihost: process {dist.process_index()}/{dist.process_count()}, "
              f"{n_local} local of {n_local * dist.process_count()} devices")

    if command == "initialize":
        new_root = rootutil.initialize(args.monica_root_folder)
        print(f"state root relocated to {new_root}")
        return 0

    if command == "list_indexes":
        from monica_tpu_torch.index import artifact

        for p in artifact.list_indexes(rootutil.indexes_dir(root), root):
            print(p)
        return 0

    if command == "plot_only":
        from monica_tpu_torch.plots import barplot
        from monica_tpu_torch.stats.abundance import RAW_DATAFRAME_FILENAME, read_dataframe

        norm_path = Path(args.data_frame)
        raw_path = norm_path.parent / RAW_DATAFRAME_FILENAME
        norm = read_dataframe(norm_path)
        if raw_path.exists():
            raw = read_dataframe(raw_path)
        else:
            # the normalized table as raw changes what -R filters on
            print(
                f"warning: {raw_path} not found; -R/--reads_threshold will "
                "filter on NORMALIZED abundances instead of raw counts",
                file=sys.stderr,
            )
            raw = norm
        out = barplot.plotter(
            norm, raw, norm_path.parent,
            reads_threshold=args.reads_threshold,
            show_legend=not args.not_show_legend,
            auto_open=not args.not_auto_open_plot,
        )
        print(out)
        return 0

    if command != "build_index" and not (args.query_folder or args.fast5_folder):
        build_parser().error("a query folder (-q) is required for an analysis run")
    cfg = _make_config(args)
    ctx = _make_context(args, root)

    if command == "build_index":
        from monica_tpu_torch.orchestrate import build_index_only

        build_index_only(ctx, cfg, indexes_folder=args.indexes_folder)
        return 0

    # default: full analysis run
    from monica_tpu_torch.orchestrate import run_analysis
    from monica_tpu_torch.utils.metrics import Metrics, profiler_trace

    metrics = Metrics()
    with profiler_trace(args.profile_dir):
        run_analysis(ctx, cfg, metrics=metrics)
    metrics.dump(Path(cfg.output_folder or Path(cfg.query_folder) / "monica_output") / "metrics.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
