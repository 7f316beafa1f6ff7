"""What the traced run reads from ``torch.profiler`` and torch's sync
debug mode, kept in plain lists for the metric readers.

The benchmark's own spans (``classify``, ``fetch``) are recorded with
``record_function`` around its calls into the program; the device's
kernels and copies come from the profiler's device activity.  Times are
nanoseconds on the profiler's clock.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import torch

SPANS = ("classify", "fetch")


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")() * 1000)


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def profile_pass(run_batch, batches, device) -> dict:
    """One pass over ``batches`` under the profiler: ``run_batch(b)``
    calls classify and fetch inside the benchmark's spans.  Returns the
    traced window's length, the batch count, the device events
    (name, kind, start, duration) and the host events (name, start,
    duration) that lie in it."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for b in batches:
            run_batch(b)
        if cuda:
            torch.cuda.synchronize(device)
    dev_events, host_events = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, dur = _ns(e, "start"), _ns(e, "duration")
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the spans appear on the device's timeline too, as annotations
            if name not in SPANS and not getattr(e, "is_user_annotation", lambda: False)():
                dev_events.append((name, _kind(name), start, dur))
        else:
            host_events.append((name, start, dur))
    # the window: from the first span's start to the last device event's end
    spans = [h for h in host_events if h[0] in SPANS]
    lo = min((h[1] for h in spans), default=0)
    hi = max([h[1] + h[2] for h in spans] + [d[2] + d[3] for d in dev_events], default=lo)
    return {"window_ns": hi - lo, "start_ns": lo, "batches": len(batches),
            "device": dev_events, "host": host_events}


def sync_sites(fn, device) -> list[str]:
    """Where ``fn()`` syncs the card with the host, as torch's sync
    debug mode reports it: one "file:line" a sync (a copy of
    ``monica_tpu_torch.bench.host_syncs``)."""
    if torch.device(device).type != "cuda":
        return []
    torch.cuda.synchronize(device)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(device)
    return [f"{Path(w.filename).name}:{w.lineno}" for w in seen
            if "synchronizing" in str(w.message)]


def merged_intervals(trace: dict) -> list[tuple[int, int]]:
    """The device's busy intervals (any kernel or copy running), merged,
    clipped to the traced window."""
    lo = trace["start_ns"]
    hi = lo + trace["window_ns"]
    iv = sorted((max(s, lo), min(s + d, hi)) for _, _, s, d in trace["device"] if s + d > lo)
    out: list[list[int]] = []
    for s, e in iv:
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(trace: dict) -> int:
    return sum(e - s for s, e in merged_intervals(trace))


def host_activity(trace: dict, t: int) -> str:
    """What the host was doing at ``t``: the benchmark's span around it
    and the innermost host event that covers it ("classify" alone is the
    host's own work in it, such as the numpy 2-bit pack)."""
    cover = [h for h in trace["host"] if h[1] <= t < h[1] + h[2]]
    span = next((h[0] for h in cover if h[0] in SPANS), "between batches")
    inner = [h for h in cover if h[0] not in SPANS]
    if not inner:
        return span
    return f"{span}: {min(inner, key=lambda h: h[2])[0]}"[:120]


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by what the host was doing halfway through each (a gap
    opens as a sync returns, so its start names the sync), in seconds."""
    per: dict[str, int] = {}
    for name, _, _, d in trace["device"]:
        per[name[:120]] = per.get(name[:120], 0) + d
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    lo = trace["start_ns"]
    edges = [lo] + [x for iv in merged_intervals(trace) for x in iv] + [lo + trace["window_ns"]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, d / 1e9] for n, d in ops],
            "idle_gaps": [[host_activity(trace, (s + e) // 2), (e - s) / 1e9] for s, e in gaps]}
