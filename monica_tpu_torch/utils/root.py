"""Persistent-state root directory — counterpart of
``monica_tpu/utils/root.py``, with the same environment variable, home
folder and layout, so both packages share one root and each finds the
other's cached tables, genomes and indexes::

    <root>/.root            redirect file (absolute path of active root)
    <root>/genomes/         downloaded genome cache
    <root>/tables/          NCBI assembly summary cache
    <root>/indexes/         built index artifacts
    <root>/monica.params    last-run parameter dump
"""

from __future__ import annotations

import json
import os
from pathlib import Path

_ENV_VAR = "MONICA_TPU_ROOT"
_HOME_DIRNAME = ".monica_tpu"


def default_home() -> Path:
    return Path(os.path.expanduser("~")) / _HOME_DIRNAME


def resolve_root(explicit: str | os.PathLike | None = None) -> Path:
    """The active state root, created if needed.  Priority: explicit
    argument > $MONICA_TPU_ROOT > the ~/.monica_tpu/.root redirect >
    ~/.monica_tpu itself."""
    if explicit is not None:
        root = Path(explicit)
    elif _ENV_VAR in os.environ:
        root = Path(os.environ[_ENV_VAR])
    else:
        home = default_home()
        redirect = home / ".root"
        if redirect.exists():
            root = Path(redirect.read_text().splitlines()[0].strip())
        else:
            root = home
    root.mkdir(parents=True, exist_ok=True)
    return root


def initialize(new_root: str | os.PathLike) -> Path:
    """Relocate the state root: write the redirect file in the home
    location pointing at ``new_root``."""
    home = default_home()
    home.mkdir(parents=True, exist_ok=True)
    new_root = Path(new_root).absolute()
    new_root.mkdir(parents=True, exist_ok=True)
    (home / ".root").write_text(str(new_root))
    return new_root


def subdir(root: Path, name: str) -> Path:
    d = root / name
    d.mkdir(parents=True, exist_ok=True)
    return d


def genomes_dir(root: Path) -> Path:
    return subdir(root, "genomes")


def tables_dir(root: Path) -> Path:
    return subdir(root, "tables")


def indexes_dir(root: Path) -> Path:
    return subdir(root, "indexes")


def dump_params(root: Path, params: dict) -> None:
    """Parameter dump of the last run, for reproducibility."""
    with open(root / "monica.params", "w") as fh:
        json.dump({k: str(v) if isinstance(v, Path) else v for k, v in params.items()},
                  fh, indent=2, default=str)
