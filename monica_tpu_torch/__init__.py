"""monica_tpu_torch — the PyTorch/CUDA port of monica_tpu.

The JAX package ``monica_tpu`` is the reference; this package mirrors
its layout (``index/``, ``ops/``, ``align/``) so each module's
counterpart is easy to find, and imports ``torch`` and never ``jax``
nor ``monica_tpu``: the host pieces it needs (FASTA reading, base
encoding and the 2-bit wire format, the synthetic community and read
simulators) have counterparts here (``io/``, ``evaluation.py``).

Conventions:

* every function that creates a tensor takes an explicit ``device``;
  nothing picks a device on the caller's behalf;
* 32-bit unsigned quantities (minimizer hashes, packed table entries)
  are held as ``int64`` masked to 32 bits (:mod:`._u32`), because
  torch has no usable ``uint32`` arithmetic and ``int32 >>`` is
  arithmetic, not logical;
* the banded Smith–Waterman hot loop is a hand-written CUDA kernel
  (``ops/csrc/banded_sw.cu``) with a plain PyTorch version beside it;
  a CPU tensor takes the plain version, a CUDA tensor the kernel.

Ported so far: the single-shard classify path (sketch -> lookup ->
chain -> rescue extension -> finalize/count), the host index build and
a single-shard ``Classifier``.  See ROADMAP.md for what comes next.
"""
