"""The check must fail what it exists to catch: the control (the
reference one precision lower) and the program broken underneath a whole
run — its state left unchanged from step to step, half of each batch
left out, an answer altered where it is produced.  (No cell spans chips,
so no exchange between chips can be left out.)"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from benchmark import control, run

SEED = 2**31 + 5


def _spec(tiny_bench):
    return json.loads((tiny_bench.parent / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", ["zymo.r9_query", "zymo.r9_matching",
                                  "zymo_sharded.r9_query", "zymo_sharded.r9_matching"])
def test_the_control_fails_every_cell(tiny_bench, cell):
    got = control.control_reading(_spec(tiny_bench), cell, SEED, "cpu", bench_dir=tiny_bench)
    assert got["correct"] is False
    assert got["check"]["read_mismatch"]["value"] > got["check"]["read_mismatch"]["limit"]


def _unchanged_state(monkeypatch, Classifier, pl):
    """Each step hands back the state before it: the previous batch's
    answers, and before the first an empty one (nothing mapped)."""
    fetch = Classifier.fetch
    last = {}

    def stale(self, res, counts):
        new = fetch(self, res, counts)
        old = last.get("out") or (np.zeros_like(new[0]), np.full_like(new[1], -1),
                                  np.zeros_like(new[2]), np.zeros_like(new[3]))
        last["out"] = new
        return old

    monkeypatch.setattr(Classifier, "fetch", stale)


def _half_left_out(monkeypatch, Classifier, pl):
    classify = Classifier.classify

    def half(self, codes, lengths):
        lengths = np.array(lengths, np.int32)
        lengths[len(lengths) // 2:] = 0
        return classify(self, codes, lengths)

    monkeypatch.setattr(Classifier, "classify", half)


def _answer_altered(monkeypatch, Classifier, pl):
    def altered(fn):
        def wrap(*a, **k):
            r = fn(*a, **k)
            return r._replace(mlen=torch.where(r.status == pl.MAPPED, r.mlen + 1, r.mlen))
        return wrap

    monkeypatch.setattr(pl, "finalize_single", altered(pl.finalize_single))
    monkeypatch.setattr(pl, "merge_hits", altered(pl.merge_hits))


@pytest.mark.parametrize("fault", [_unchanged_state, _half_left_out, _answer_altered])
@pytest.mark.parametrize("cell", ["zymo.r9_query", "zymo_sharded.r9_query"])
def test_a_broken_program_is_not_correct(tiny_bench, monkeypatch, cell, fault):
    from monica_tpu_torch.align import pipeline as pl
    from monica_tpu_torch.align.runtime import Classifier

    fault(monkeypatch, Classifier, pl)
    out = run.run_cell(_spec(tiny_bench), cell, SEED, 0.3, False, "cpu", time.time(),
                       bench_dir=tiny_bench)
    assert out["correct"] is False
    assert out["check"]["read_mismatch"]["value"] > 0


@pytest.mark.card
def test_the_control_fails_at_the_cells_size(card):
    got = control.control_reading(run.load_spec(), "zymo.r9_query", SEED, card)
    assert got["correct"] is False
