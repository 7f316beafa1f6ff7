"""The program's own spans in a traced run's host events, for the metric
readers.

The program names its host work with ``torch.profiler.record_function``
under ``monica.<name>``, counts following the name as `` key=value``
pairs (``monica.rescue cand=37 slots=187``); the traced pass keeps each
host event as (name, start, duration) in ``record["trace"]["host"]``,
nanoseconds on the profiler's clock.  A program without the spans, or a
trace without the card's activity (a run on the CPU), gives no spans, so
the readers built on them report nothing.
"""

from __future__ import annotations

import re

PREFIX = "monica."
# the CUDA runtime calls in which the host waits for the card: the
# synchronize calls, and the copies, since a copy to pageable host memory
# (``.cpu()``) returns only once the card's queue before it has run (a
# runtime event may carry a version suffix, as in ``_v3020``)
SYNCS = re.compile(r"^(cudaStreamSynchronize|cudaDeviceSynchronize|cudaEventSynchronize"
                   r"|cudaMemcpy|cudaMemcpyAsync)(_v\d+)?$")


def parse(name: str) -> tuple[str, dict[str, str]] | None:
    """``"monica.rescue cand=37 slots=187"`` -> ``("rescue", {"cand": "37",
    "slots": "187"})``; None for an event that is not a program span."""
    if not name.startswith(PREFIX):
        return None
    head, *rest = name.split(" ")
    counts = {}
    for kv in rest:
        k, sep, v = kv.partition("=")
        if sep:
            counts[k] = v
    return head[len(PREFIX):], counts


def spans(record, name: str) -> list[tuple[int, int, dict[str, str]]] | None:
    """Every ``monica.<name>`` span of the traced pass as (start, duration,
    counts); None when the trace holds no program span at all or no
    device activity."""
    tr = record.get("trace")
    if not tr or not tr.get("device"):
        return None
    found, any_span = [], False
    for ev_name, start, dur in tr["host"]:
        p = parse(ev_name)
        if p is None:
            continue
        any_span = True
        if p[0] == name:
            found.append((start, dur, p[1]))
    return found if any_span else None


def syncs_inside(record, within: list[tuple[int, int, dict]]) -> list[tuple[int, int]]:
    """The blocking runtime calls (:data:`SYNCS`) that start inside any of
    the spans ``within``, as (start, duration)."""
    iv = sorted((s, s + d) for s, d, _ in within)
    out = []
    for ev_name, start, dur in record["trace"]["host"]:
        if SYNCS.match(ev_name) and any(lo <= start < hi for lo, hi in iv):
            out.append((start, dur))
    return out


def per_batch_ms(record, total_ns: float) -> float:
    """A nanosecond total of the traced pass as ms a batch."""
    return total_ns / record["trace"]["batches"] / 1e6
