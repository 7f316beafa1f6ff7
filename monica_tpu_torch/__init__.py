"""monica_tpu_torch — the PyTorch/CUDA port of monica_tpu.

The JAX package ``monica_tpu`` is the reference; this package mirrors
its layout (``index/``, ``ops/``, ``align/``, ``io/``, ``stats/``,
``utils/``) so each module's counterpart is easy to find, and imports
``torch`` and never ``jax``, ``monica_tpu`` or pandas: the host pieces
it needs (FASTA/FASTQ reading, the native FASTQ parser, base encoding
and the 2-bit wire format, metrics, the abundance tables, the synthetic
communities and read simulators) have counterparts here.

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

The port covers all of the JAX package: the classify path (sketch ->
lookup -> chain -> rescue extension -> finalize, or the cross-shard
merge of a multi-shard index -> count), the index build (on the host, or
on the card for a CUDA device), the ``Classifier`` on one device or a
device mesh (``parallel/``), the streaming runtime (``run_once`` /
``watch``: a folder of FASTQ samples to routed reads and abundance
tables, in lockstep across ``torch.distributed`` processes), the product
path around it (index artifacts, the offline data layer ``data/``, the
barplot, ``orchestrate`` and the CLI, ``python -m monica_tpu_torch.cli``)
and the accuracy harnesses (``evaluation``, ``concordance``,
``parity``).  See ROADMAP.md for what comes next.
"""

__version__ = "0.1.0"
