"""Build and bind the port's CUDA kernels (``ops/csrc/*.cu``).

At first use the package's ``.cu`` sources are compiled by ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, named
by a hash of the sources and flags, and loaded with ``ctypes``.  The
library goes to ``$MONICA_TORCH_BUILD_DIR`` when that is set, else to
``build/monica_tpu_torch/`` at the root of a source checkout, else (an
installed package) to ``monica_tpu_torch`` under the user's cache
directory.  A build failure raises: nothing falls back to the plain
PyTorch version.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current CUDA stream,
raises when the C entry returns a CUDA error, and adds one to its entry
in :data:`LAUNCHES` per launch (keyed by kernel and band width), so a
run can show which kernels it went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from monica_tpu_torch.ops.extend import ExtendParams, _gap_reach, packed_mbits

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
KERNEL_WIDTHS = (64, 128)  # band widths W the kernels are instantiated for

# launches per kernel instance (kernel and band width) since the last
# reset_launch_counts()
LAUNCHES = {f"banded_sw_{kind}_w{w}": 0 for kind in ("packed", "pairstate")
            for w in KERNEL_WIDTHS}

_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    """Where the kernel library is written (see the module docstring)."""
    if os.environ.get("MONICA_TORCH_BUILD_DIR"):
        return Path(os.environ["MONICA_TORCH_BUILD_DIR"])
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file():  # a source checkout
        return root / "build" / "monica_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "monica_tpu_torch"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); cannot build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"libmonica_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these exact sources is
    already built; returns its path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.monica_banded_sw_packed.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
        lib.monica_banded_sw_packed.restype = i32
        lib.monica_banded_sw_pairstate.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
        lib.monica_banded_sw_pairstate.restype = i32
        _lib = lib
    return _lib


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def banded_sw_cuda(q: torch.Tensor, refwin: torch.Tensor, lengths: torch.Tensor,
                   p: ExtendParams):
    """Banded SW on the card: the packed-state kernel when (score, mlen)
    fits int32 at this L (``packed_mbits``), the pair-state kernel
    otherwise.  q (B, L) uint8, refwin (B, L + W) uint8, lengths (B,)
    int32, all contiguous on one CUDA device -> (score, mlen) int32."""
    if not (q.is_cuda and refwin.is_cuda and lengths.is_cuda):
        raise ValueError("banded_sw_cuda needs CUDA tensors")
    if not (q.device == refwin.device == lengths.device):
        raise ValueError("banded_sw_cuda: tensors on different devices")
    if q.dtype != torch.uint8 or refwin.dtype != torch.uint8 or lengths.dtype != torch.int32:
        raise ValueError("banded_sw_cuda takes uint8 q/refwin and int32 lengths")
    B, L = q.shape
    W = p.band
    if W not in KERNEL_WIDTHS:
        raise ValueError(f"banded_sw_cuda: band {W} not in {KERNEL_WIDTHS}")
    if refwin.shape != (B, L + W) or lengths.shape != (B,):
        raise ValueError(
            f"banded_sw_cuda: shapes q {tuple(q.shape)}, refwin {tuple(refwin.shape)}, "
            f"lengths {tuple(lengths.shape)} do not fit (B, L), (B, L+W), (B,)"
        )
    if not (q.is_contiguous() and refwin.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("banded_sw_cuda needs contiguous tensors")
    score = torch.empty(B, dtype=torch.int32, device=q.device)
    mlen = torch.empty(B, dtype=torch.int32, device=q.device)
    if B == 0:
        return score, mlen
    lib = load()
    reach = _gap_reach(W, p.max_gap)
    mbits = packed_mbits(L, p)
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (q, refwin, lengths, score, mlen)]
        if mbits:
            name = f"banded_sw_packed_w{W}"
            err = lib.monica_banded_sw_packed(
                *ptrs, B, L, W, p.match, p.mismatch, p.gap, reach, mbits, stream)
        else:
            name = f"banded_sw_pairstate_w{W}"
            err = lib.monica_banded_sw_pairstate(
                *ptrs, B, L, W, p.match, p.mismatch, p.gap, reach, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return score, mlen
