"""tools/eval_matrix.py row driver: per-complex checkpoint/resume.

Round 4: three straight 48-complex rerank-row attempts died mid-row to
device worker faults and the whole matrix stalled, because rows only
checkpointed at row END.  eval_row must (a) checkpoint after every
complex via on_progress, (b) resume from a partial row without
re-docking finished complexes, (c) produce rows in canonical complex
order regardless of the resume split.
"""
import importlib.util
import json
import os
import sys

import pytest

_spec = importlib.util.spec_from_file_location(
    "eval_matrix", os.path.join(os.path.dirname(__file__), "..",
                                "tools", "eval_matrix.py"))
eval_matrix = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(eval_matrix)


class _FakeComplex:
    def __init__(self, name):
        self.name = name


@pytest.fixture()
def graded(monkeypatch):
    """grade_poses stub: dock_fn returns the graded rows directly."""
    monkeypatch.setattr(eval_matrix, "grade_poses", lambda c, p: p)


def _rows(names, hit):
    return {n: [dict(capri="acceptable" if hit(n) else "incorrect",
                     lrmsd=1.0 if hit(n) else 30.0)] for n in names}


def test_eval_row_progress_and_rates(graded):
    names = [f"c{i}" for i in range(6)]
    table = _rows(names, lambda n: n in ("c1", "c4"))
    calls, snapshots = [], []

    def dock_fn(c):
        calls.append(c.name)
        return table[c.name]

    out = eval_matrix.eval_row(dock_fn, [_FakeComplex(n) for n in names],
                               "t", on_progress=lambda r: snapshots.append(
                                   len(r)))
    assert calls == names
    assert snapshots == [1, 2, 3, 4, 5, 6]          # ckpt every complex
    assert out["top1"] == pytest.approx(2 / 6)
    assert [r["name"] for r in out["complexes"]] == names


def test_eval_row_resumes_partial(graded):
    names = [f"c{i}" for i in range(5)]
    table = _rows(names, lambda n: True)
    # Simulate a crash after c0, c1 — with c1 graded differently than
    # a re-dock would (proves the cached row is trusted, not re-run).
    partial = [dict(name="c0", hit_top1=True, hit_top10=True,
                    best_lrmsd=1.0),
               dict(name="c1", hit_top1=False, hit_top10=False,
                    best_lrmsd=25.0)]
    calls = []

    def dock_fn(c):
        calls.append(c.name)
        return table[c.name]

    out = eval_matrix.eval_row(dock_fn, [_FakeComplex(n) for n in names],
                               "t", partial=partial)
    assert calls == ["c2", "c3", "c4"]              # no re-dock
    assert out["top1"] == pytest.approx(4 / 5)       # c1 kept as miss
    assert [r["name"] for r in out["complexes"]] == names


def test_completed_row_fingerprint_guard():
    """Round-5 (round-4 ADVICE): finished rows are protocol-guarded.
    Same fingerprint -> reused; different -> discarded (recompute);
    legacy rows without a fingerprint -> kept."""
    fp_a = dict(n_rot=1536, grid=64, rank=0)
    fp_b = dict(n_rot=1536, grid=64, rank=2)
    row = dict(top1=0.5, top10=1.0, complexes=[], fingerprint=fp_a)

    results = {"learned_global": dict(row)}
    assert eval_matrix.completed_row_reusable(
        results, "learned_global", fp_a)
    assert "learned_global" in results

    results = {"learned_global": dict(row)}
    assert not eval_matrix.completed_row_reusable(
        results, "learned_global", fp_b)
    assert "learned_global" not in results            # discarded

    legacy = {"learned_global": dict(top1=0.5, top10=1.0, complexes=[])}
    assert eval_matrix.completed_row_reusable(
        legacy, "learned_global", fp_b)               # kept, warned
    assert "learned_global" in legacy

    assert not eval_matrix.completed_row_reusable({}, "missing", fp_a)


def test_fingerprint_agg_only_guards_rerank_rows():
    """EM_AGG changes row identity ONLY for the rerank row (whose key
    already encodes a non-default aggregator): adding a topmean rerank
    column to an existing matrix must not discard the agg-independent
    rows it shares the file with (round-5 review)."""
    fp_max = dict(n_rot=1536, grid=64, rank=0, agg="max")
    fp_topmean = dict(fp_max, agg="topmean")
    row = dict(top1=0.5, top10=1.0, complexes=[], fingerprint=fp_max)

    # Agg-independent row: reused across the agg change.
    results = {"shape_global": dict(row)}
    assert eval_matrix.completed_row_reusable(
        results, "shape_global", fp_topmean)
    assert "shape_global" in results

    # Rerank row: agg IS its identity -> discarded on mismatch.
    results = {"learned_rerank_global": dict(row)}
    assert not eval_matrix.completed_row_reusable(
        results, "learned_rerank_global", fp_topmean)
    assert "learned_rerank_global" not in results

    # Any OTHER knob still discards agg-independent rows.
    assert not eval_matrix.completed_row_reusable(
        {"shape_global": dict(row)}, "shape_global",
        dict(fp_max, rank=2))


def test_significance_pooled_bands(tmp_path):
    """'+'-joined row specs pool disjoint bands; overlap is an error."""
    _spec2 = importlib.util.spec_from_file_location(
        "significance", os.path.join(os.path.dirname(__file__), "..",
                                     "tools", "significance.py"))
    sig = importlib.util.module_from_spec(_spec2)
    _spec2.loader.exec_module(sig)

    def matrix(path, seeds, hits):
        rows = [dict(name=f"synth{s}", hit_top1=h, hit_top10=True)
                for s, h in zip(seeds, hits)]
        with open(path, "w") as f:
            json.dump({"learned": dict(top1=0, top10=0,
                                       complexes=rows)}, f)

    a, b = tmp_path / "a.json", tmp_path / "b.json"
    matrix(a, [100, 101], [True, False])
    matrix(b, [300, 301], [True, True])
    merged, label = sig.load_row(f"{a}:learned+{b}:learned", None)
    assert sorted(merged) == ["synth100", "synth101", "synth300",
                              "synth301"]
    assert label == "learned"
    assert sum(bool(r["hit_top1"]) for r in merged.values()) == 3

    with pytest.raises(SystemExit, match="overlap"):
        sig.load_row(f"{a}:learned+{a}:learned", None)


def test_eval_row_out_of_order_partial(graded):
    """Partial rows from a differently-ordered run still land in
    canonical complex order."""
    names = ["a", "b", "c"]
    table = _rows(names, lambda n: False)
    partial = [dict(name="c", hit_top1=False, hit_top10=True,
                    best_lrmsd=9.0)]
    out = eval_matrix.eval_row(lambda c: table[c.name],
                               [_FakeComplex(n) for n in names],
                               "t", partial=partial)
    assert [r["name"] for r in out["complexes"]] == names
    assert out["complexes"][2]["hit_top10"] is True


def test_seed_disjointness_guard(tmp_path, monkeypatch):
    """Bands overlapping the checkpoint's train/val seeds are refused.

    Round-5 near-miss: the flagship trained on seeds 200..1223
    (TF_SEEDS=1024), so the planned 'disjoint' second band at 300-347
    was inside the training set; synthetic_complex derives the whole
    structure from default_rng(seed), making seed overlap structural
    leakage even when residue counts differ."""
    ckpt = tmp_path / "model" / "best"
    ckpt.mkdir(parents=True)
    with open(tmp_path / "model" / "TRAINING.json", "w") as f:
        json.dump(dict(n_train=1024, train_seed0=200, n_val=32), f)

    # overlapping the training band -> refuse
    with pytest.raises(SystemExit, match="train seeds"):
        eval_matrix.check_seed_disjointness(str(ckpt), 300, 48)
    # overlapping the validation band -> refuse
    with pytest.raises(SystemExit, match="val seeds"):
        eval_matrix.check_seed_disjointness(str(ckpt), 60, 8)
    # disjoint bands pass
    eval_matrix.check_seed_disjointness(str(ckpt), 100, 48)
    eval_matrix.check_seed_disjointness(str(ckpt), 1300, 48)
    # explicit override downgrades to a warning
    monkeypatch.setenv("EM_ALLOW_TRAIN_OVERLAP", "1")
    eval_matrix.check_seed_disjointness(str(ckpt), 300, 48)
    monkeypatch.delenv("EM_ALLOW_TRAIN_OVERLAP")
    # no TRAINING.json (e.g. the shape baseline) -> no guard
    eval_matrix.check_seed_disjointness(str(tmp_path / "nope"), 300, 48)


def test_significance_split_pooled_plus_in_path():
    """File paths containing '+' parse correctly in pooled specs."""
    _s = importlib.util.spec_from_file_location(
        "significance2", os.path.join(os.path.dirname(__file__), "..",
                                      "tools", "significance.py"))
    sig = importlib.util.module_from_spec(_s)
    _s.loader.exec_module(sig)
    # path with '+' is rejoined, not mis-split
    assert sig._split_pooled("runs/v9p+fused/m.json:learned", None) \
        == ["runs/v9p+fused/m.json:learned"]
    assert sig._split_pooled("a.json:r1+b.json:r2", None) \
        == ["a.json:r1", "b.json:r2"]
    assert sig._split_pooled("x.json:row+dir+y.json:row", None) \
        == ["x.json:row", "dir+y.json:row"]
    # default-path form: bare row names split as-is
    assert sig._split_pooled("learned_local", "m.json") \
        == ["learned_local"]
    with pytest.raises(SystemExit, match="trailing fragment"):
        sig._split_pooled("a.json:r1+fragment", None)
