"""Build and bind the port's CUDA kernels (``ops/csrc/*.cu``): the
banded-SW kernels and the ALU-ceiling kernel ``roofline_sw`` times.

At first use the package's ``.cu`` sources are compiled by ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface, named
by a hash of the sources and flags, and loaded with ``ctypes``.  The
library goes to ``$MONICA_TORCH_BUILD_DIR`` when that is set, else to
``build/monica_tpu_torch/`` at the root of a source checkout, else (an
installed package) to ``monica_tpu_torch`` under the user's cache
directory.  A build failure raises: nothing falls back to the plain
PyTorch version.

The build passes ``-Xptxas -v``; what ptxas printed (each kernel's
registers, shared memory and spills) is kept beside the library, with
the suffix ``.log``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` (``torch.zeros`` for the ALU-ceiling
kernel's sum, which it adds to), launches on the current CUDA stream,
raises when the C entry returns a CUDA error, and adds one to its entry
in :data:`LAUNCHES` per launch (keyed by kernel and band width), so a
run can show which kernels it went through, and to
:data:`LAUNCH_SHAPES` (keyed by kernel, B and L; for the ALU-ceiling
kernel, elements and unroll), so it can show at which shapes.
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
KERNEL_WIDTHS = (64, 128)  # band widths W the kernels are instantiated for
ALU_UNROLLS = (256, 512, 1024)  # the ALU-ceiling kernel's chain lengths
ALU_CHAINS = ("int32", "dpx")

# launches per kernel instance (kernel and band width) since the last
# reset_launch_counts()
LAUNCHES = {f"banded_sw_{kind}_w{w}": 0 for kind in ("packed", "pairstate")
            for w in KERNEL_WIDTHS}
LAUNCHES["alu_ceiling"] = 0
# launches per (kernel instance, B, L) since the last reset_launch_counts()
LAUNCH_SHAPES: dict[tuple[str, int, int], int] = {}

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
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
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
        lib.monica_alu_ceiling.argtypes = [ptr, i32, i32, i32, ptr, ptr]
        lib.monica_alu_ceiling.restype = i32
        _lib = lib
    return _lib


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SHAPES.clear()


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
    if p.gap < 0:
        raise ValueError("banded_sw_cuda takes a gap penalty >= 0")
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
    LAUNCH_SHAPES[name, B, L] = LAUNCH_SHAPES.get((name, B, L), 0) + 1
    return score, mlen


def alu_ceiling_cuda(x: torch.Tensor, unroll: int, chain: str) -> torch.Tensor:
    """The ALU-ceiling chain (``csrc/alu_ceiling.cu``) over every element
    of a contiguous int32 CUDA tensor ``x``: ``chain`` "int32" or "dpx",
    ``unroll`` steps (256, 512 or 1024), summed mod 2^32 -> a one-element
    int32 tensor holding the sum's low 32 bits (``ops.ceiling``)."""
    if not x.is_cuda:
        raise ValueError("alu_ceiling_cuda needs a CUDA tensor")
    if x.dtype != torch.int32 or not x.is_contiguous() or not 0 < x.numel() < 1 << 31:
        raise ValueError("alu_ceiling_cuda takes a contiguous, non-empty int32 tensor")
    if unroll not in ALU_UNROLLS or chain not in ALU_CHAINS:
        raise ValueError(f"alu_ceiling_cuda: unroll {unroll} not in {ALU_UNROLLS}, "
                         f"or chain {chain!r} not in {ALU_CHAINS}")
    out = torch.zeros(1, dtype=torch.int32, device=x.device)
    lib = load()
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        err = lib.monica_alu_ceiling(ctypes.c_void_p(x.data_ptr()), x.numel(), unroll,
                                     int(chain == "dpx"), ctypes.c_void_p(out.data_ptr()), stream)
    if err != 0:
        raise RuntimeError(f"alu_ceiling kernel launch failed: CUDA error {err}")
    LAUNCHES["alu_ceiling"] += 1
    LAUNCH_SHAPES["alu_ceiling", x.numel(), unroll] = (
        LAUNCH_SHAPES.get(("alu_ceiling", x.numel(), unroll), 0) + 1)
    return out
