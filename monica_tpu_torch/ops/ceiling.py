"""The card's integer ALU ceiling: the chain that
``scripts/roofline_sw.py:measure_vpu_ops_per_s`` times, as a function
of its own (no Pallas kernel; it is the yardstick the SW kernels are
measured against in ``roofline_sw``).

Two chains over every element x of an int32 array, ``unroll`` steps
each, summed:

* ``int32``: ``y = (y + x) ^ (y >> 1) ^ (2k + 1)`` from ``y = x``, the
  JAX script's chain (3 ops a step by its count);
* ``dpx``: ``y = max(y + a, b)`` from ``y = x`` with ``a = (x & 255) -
  128`` and ``b = -(x & 1023)``: one ``__viaddmax_s32`` a step, the DPX
  instruction the banded-SW kernels issue most.

:func:`alu_chain_torch` is the plain PyTorch version (it sums into
int64); the hand-written kernel ``csrc/alu_ceiling.cu`` (bound by
:mod:`monica_tpu_torch.ops._native`) sums mod 2^32, so the two agree in
the low 32 bits (:func:`low32`).  :func:`alu_chain` dispatches on the
tensor's device: a CPU tensor takes the plain version, a CUDA tensor
the kernel.  Nothing falls back.
"""

from __future__ import annotations

import re
import subprocess
from pathlib import Path

import numpy as np
import torch

CHAINS = ("int32", "dpx")
SIZE = (2048, 1024)  # the JAX script's 2M int32 lanes
MASK32 = 0xFFFFFFFF


def chain_input(size=SIZE, seed: int = 0) -> np.ndarray:
    """The JAX script's input: int32 values in [0, 2^30) from ``seed``."""
    return np.random.default_rng(seed).integers(0, 1 << 30, size, dtype=np.int32)


def alu_chain_torch(x: torch.Tensor, unroll: int, chain: str) -> torch.Tensor:
    """The chain in plain tensor ops on ``x`` (int32) -> the int64 sum."""
    if chain == "int32":
        y = x
        for i in range(unroll):
            y = (y + x) ^ (y >> 1) ^ (2 * i + 1)
    elif chain == "dpx":
        a, b = (x & 255) - 128, -(x & 1023)
        y = x
        for _ in range(unroll):
            y = torch.maximum(y + a, b)
    else:
        raise ValueError(f"unknown chain {chain!r} (int32 | dpx)")
    return y.sum()


def alu_chain(x: torch.Tensor, unroll: int, chain: str) -> torch.Tensor:
    """A CUDA tensor launches the kernel (a one-element int32 tensor of
    the sum mod 2^32), a CPU tensor runs :func:`alu_chain_torch`."""
    if x.is_cuda:
        from monica_tpu_torch.ops import _native

        return _native.alu_ceiling_cuda(x, unroll, chain)
    return alu_chain_torch(x, unroll, chain)


def low32(v: torch.Tensor | int) -> int:
    """The low 32 bits of a sum, unsigned."""
    return int(v) & MASK32


def sass_instructions(lib: Path) -> dict:
    """:func:`sass_per_step` of the kernel library's ``cuobjdump -sass``."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    return sass_per_step(subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                                        text=True, check=True).stdout)


def sass_per_step(sass: str) -> dict:
    """SASS instructions of each ALU-ceiling instance in a ``cuobjdump
    -sass`` listing: {"int32": {"instructions": {256: n, 1024: n},
    "per_step": s, "opcodes_per_step": {...}}, "dpx": ...}, a step's
    counts being the difference of the two instances' opcode counts over
    the difference of their unrolls."""
    ops: dict[tuple[str, int], dict] = {}
    key = None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            # e.g. _ZN..18alu_ceiling_kernelILi256ELb1EEEvPKiiPj: <unroll, dpx>
            k = re.search(r"alu_ceiling_kernelILi(\d+)ELb([01])E", head.group(1))
            key = (CHAINS[int(k.group(2))], int(k.group(1))) if k else None
            if key:
                ops[key] = {}
            continue
        ins = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if key and ins:
            ops[key][ins.group(1)] = ops[key].get(ins.group(1), 0) + 1
    out = {}
    for chain in CHAINS:
        lo, hi = ops.get((chain, 256)), ops.get((chain, 1024))
        if lo is None or hi is None:
            continue
        step = {op: (hi.get(op, 0) - lo.get(op, 0)) / (1024 - 256) for op in set(lo) | set(hi)}
        out[chain] = {"instructions": {256: sum(lo.values()), 1024: sum(hi.values())},
                      "per_step": sum(step.values()),
                      "opcodes_per_step": {op: v for op, v in sorted(step.items()) if v}}
    return out
