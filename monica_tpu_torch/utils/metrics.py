"""Per-stage timers and throughput counters — counterpart of
``monica_tpu/utils/metrics.py``.  Stages report through one registry
that prints a line per stage and keeps machine-readable totals;
:func:`profiler_trace` wraps a block in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class StageStat:
    seconds: float = 0.0
    calls: int = 0
    items: int = 0  # stage-defined unit (reads, bases, files)


@dataclass
class Metrics:
    stages: dict[str, StageStat] = field(default_factory=dict)
    verbose: bool = True
    # the streaming runtime updates stages from worker threads
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.add(name, dt, items)
            if self.verbose:
                rate = f", {items / dt:,.0f}/s" if items and dt > 0 else ""
                print(f"[monica_tpu_torch] {name}: {dt:.3f}s{rate}")

    def add(self, name: str, seconds: float, items: int = 0) -> None:
        with self._lock:
            st = self.stages.setdefault(name, StageStat())
            st.seconds += seconds
            st.calls += 1
            st.items += items

    def rate(self, name: str) -> float:
        st = self.stages.get(name)
        return st.items / st.seconds if st and st.seconds > 0 else 0.0

    def summary(self) -> dict:
        return {
            name: {
                "seconds": round(st.seconds, 4),
                "calls": st.calls,
                "items": st.items,
                "per_s": round(st.items / st.seconds, 2) if st.seconds > 0 else None,
            }
            for name, st in self.stages.items()
        }

    def dump(self, path) -> None:
        with open(path, "w") as fh:
            json.dump(self.summary(), fh, indent=2)


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """Wrap a block in a ``torch.profiler`` trace of the host and, where
    a card is present, the device, written to ``logdir/trace.json`` as a
    Chrome trace; no-op when logdir is None."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))
