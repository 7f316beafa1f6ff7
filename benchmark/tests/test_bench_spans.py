"""The readers of the program's spans (``benchmark/spans.py`` and the
metrics built on it) on a synthetic traced record: nested spans, blocking
runtime calls inside and outside them, counts parsed from span names, and
no value where the spans or the card's activity are missing."""

from __future__ import annotations

from pathlib import Path

import pytest

from benchmark import run, spans

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000
NEW = ("pack_ms", "dispatch_ms", "sync_wait_ms", "rescue_slot_use")


def _record():
    """Two batches.  Batch 1 (0-100 ms): classify 0-60 holds pack 2-22,
    upload 22-25 and pipeline 25-58, in which the rescue pick waits on a
    4 ms stream sync and the rescue runs; fetch 60-100 holds the copy's
    stream sync 70-90.  Batch 2 (100-200 ms) likewise with other counts
    and lengths, and a plain cudaMemcpy of 1 ms in its pipeline.  The
    pick's cudaMemcpyAsync (0.1 ms) is a wait too; a stream sync outside
    every span (200-210) and a kernel launch are not."""
    host = []
    for o, pack, cand, slots, memcpy in ((0, 20, 37, 187, False), (100, 30, 5, 8, True)):
        host += [
            ("classify", o * MS, 60 * MS),
            ("monica.classify rows=1500 len=32768", o * MS, 60 * MS),
            ("monica.pack", (o + 2) * MS, pack * MS),
            ("monica.upload", (o + 22) * MS, 3 * MS),
            ("monica.pipeline", (o + 25) * MS, 33 * MS),
            ("monica.sketch", (o + 26) * MS, 10 * MS),
            ("monica.rescue_pick", (o + 40) * MS, 5 * MS),
            ("aten::item", (o + 40) * MS, 5 * MS),
            ("cudaMemcpyAsync", (o + 40) * MS, MS // 10),
            ("cudaStreamSynchronize", (o + 41) * MS, 4 * MS),
            (f"monica.rescue cand={cand} slots={slots}", (o + 46) * MS, 8 * MS),
            ("cudaLaunchKernel", (o + 47) * MS, 5000),
            ("fetch", (o + 60) * MS, 40 * MS),
            ("monica.fetch", (o + 60) * MS, 40 * MS),
            ("monica.copy", (o + 65) * MS, 30 * MS),
            ("cudaStreamSynchronize", (o + 70) * MS, 20 * MS),
        ]
        if memcpy:
            host.append(("cudaMemcpy", (o + 50) * MS, 1 * MS))
    host.append(("cudaStreamSynchronize", 200 * MS, 10 * MS))
    trace = {"window_ns": 210 * MS, "start_ns": 0, "batches": 2,
             "device": [("kernel", "kernel", 30 * MS, 5 * MS)], "host": host}
    return {"trace": trace}


def _read(name, rec):
    return run.metric_reader(ROOT / "benchmark", name)(rec)


def test_span_names_parse():
    assert spans.parse("monica.rescue cand=37 slots=187") == ("rescue",
                                                              {"cand": "37", "slots": "187"})
    assert spans.parse("monica.pack") == ("pack", {})
    assert spans.parse("monica.build.table") == ("build.table", {})
    assert spans.parse("classify") is None and spans.parse("aten::item") is None


def test_syncs_are_the_blocking_calls():
    for name in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                 "cudaMemcpy", "cudaMemcpyAsync", "cudaStreamSynchronize_v3020"):
        assert spans.SYNCS.match(name), name
    for name in ("cudaLaunchKernel", "cudaEventRecord", "cudaMemsetAsync", "monica.copy"):
        assert not spans.SYNCS.match(name), name


def test_readers_read_the_spans():
    rec = _record()
    # pack: (20 + 30) ms over 2 batches
    assert _read("pack_ms", rec) == pytest.approx(25.0)
    # pipeline: 2 x 33 ms less the two picks' 0.1 + 4 ms and the 1 ms cudaMemcpy
    assert _read("dispatch_ms", rec) == pytest.approx((66 - 8.2 - 1) / 2)
    # inside classify and fetch: 4.1 + 20, 4.1 + 1 + 20; not the one at 200 ms
    assert _read("sync_wait_ms", rec) == pytest.approx(49.2 / 2)
    assert _read("rescue_slot_use", rec) == pytest.approx(100 * 42 / 195)
    found = spans.spans(rec, "rescue")
    assert [c for _, _, c in found] == [{"cand": "37", "slots": "187"},
                                        {"cand": "5", "slots": "8"}]


def test_nothing_to_read_is_no_value():
    rec = _record()
    # the parent program: the benchmark's spans and torch's events only
    bare = {"trace": dict(rec["trace"], host=[h for h in rec["trace"]["host"]
                                              if not h[0].startswith("monica.")])}
    # a CPU run: the spans, but no activity of the card
    cpu = {"trace": dict(rec["trace"], device=[])}
    # matching counts: no rescue span, the rest present
    no_rescue = {"trace": dict(rec["trace"], host=[h for h in rec["trace"]["host"]
                                                   if not h[0].startswith("monica.rescue ")])}
    for name in NEW:
        assert _read(name, {"trace": None}) is None
        assert _read(name, bare) is None
        assert _read(name, cpu) is None
    assert _read("rescue_slot_use", no_rescue) is None
    assert _read("pack_ms", no_rescue) == pytest.approx(25.0)
