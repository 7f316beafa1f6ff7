"""Classification runtime — counterpart of the single-shard,
single-device ``Classifier`` of ``monica_tpu/align/runtime.py``.

Only the ``mesh=None`` single-shard path is ported; the multi-shard
merge and the multi-device step are later ROADMAP items and raise
``NotImplementedError`` here.
"""

from __future__ import annotations

import numpy as np
import torch

from monica_tpu_torch.align import pipeline as pl
from monica_tpu_torch.index.build import BuiltIndex
from monica_tpu_torch.io import encode as enc


class Classifier:
    """Device-resident single-shard index + the classify step.

    ``device`` is required: the index lives there and every batch is
    classified there."""

    def __init__(
        self,
        built: BuiltIndex,
        params: pl.ClassifyParams = pl.ClassifyParams(),
        count_mode: str = "query_length",
        *,
        device,
        mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "multi-device classification is not ported yet "
                "(ROADMAP.md, modules to port: multi-device)"
            )
        if len(built.shards) != 1:
            raise NotImplementedError(
                "multi-shard classification is not ported yet "
                "(ROADMAP.md, modules to port: multi-shard merge)"
            )
        self.device = torch.device(device)
        self.meta = built.meta
        self.count_mode = pl.COUNT_MODES[count_mode]
        if self.count_mode == pl.MODE_MATCHING and params.extend:
            # 'matching' counts alignment mlen, so extension runs on
            # every read, not only on the rescue candidates
            params = params._replace(extend_mode="full")
        self.index, tag_bits = pl.device_shard(built.shards[0], self.device)
        self.params = params._replace(
            tag_bits=tag_bits, k=built.meta.k, w=built.meta.w, frac=built.meta.frac
        )

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def classify(self, codes: np.ndarray, lengths: np.ndarray):
        """Classify one padded (B, L) uint8 batch; returns device
        (ReadResult, counts).  Reads cross to the device 2-bit packed
        (4 bases/byte) from a pinned host buffer and are unpacked
        there."""
        params = pl.params_for_bucket(self.params, codes.shape[1])
        packed = self._upload(enc.pack_codes_2bit(codes))
        lens = self._upload(np.asarray(lengths, dtype=np.int32))
        return pl.classify_batch_packed(
            self.index, packed, lens, codes.shape[1], params,
            self.meta.n_accessions, self.count_mode,
        )

    def fetch(self, res: pl.ReadResult, counts: torch.Tensor):
        """Blocking device->host fetch in one transfer: (status, acc_id,
        mlen) numpy int32 rows and the (n_accessions,) int64 counts."""
        arr = pl.pack_results(res, counts).cpu().numpy()
        n_acc = self.meta.n_accessions
        return arr[0], arr[1], arr[2], arr[3:].reshape(-1)[:n_acc].astype(np.int64)
