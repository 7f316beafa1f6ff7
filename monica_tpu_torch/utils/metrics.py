"""Per-stage timers, throughput counters and trace spans — counterpart
of ``monica_tpu/utils/metrics.py``.  Stages report through one registry
that prints a line per stage and keeps machine-readable totals;
:func:`profiler_trace` wraps a block in a ``torch.profiler`` trace.

:func:`span` names a piece of host work on the profiler's clock, the
clock of the device's kernels and copies: while a ``torch.profiler`` is
recording it opens ``record_function("monica.<name> key=value ...")``,
so counts travel in the span's name; otherwise it costs one check.
Every :meth:`Metrics.stage` opens one as ``monica.stage.<stage>``.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch
from torch.profiler import record_function

# every span's name starts with this; a profile's device-side copies of
# the spans (user annotations) carry it too
SPAN_PREFIX = "monica."
_OFF = contextlib.nullcontext()


def span(name: str, **counts):
    """A context manager: ``record_function`` under ``monica.<name>`` and
    `` key=value`` for each count while a profiler records, else a no-op.
    The counts are formatted only then, so pass values already on the
    host: a span never syncs, copies or launches."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return record_function(SPAN_PREFIX + name + "".join(f" {k}={v}" for k, v in counts.items()))


def is_span(event_name: str) -> bool:
    """Whether a profiler event is one of :func:`span`'s (on the host or,
    as an annotation, on the device's timeline)."""
    return event_name.startswith(SPAN_PREFIX)


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
        """Time a stage (``"parse:<sample>"``): the host clock into the
        registry, and the span ``monica.stage.parse of=<sample>``."""
        kind, _, of = name.partition(":")
        t0 = time.perf_counter()
        try:
            with span(f"stage.{kind}", **({"of": "_".join(of.split())} if of else {})):
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
    Chrome trace, with the :func:`span`s; no-op when logdir is None."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))
