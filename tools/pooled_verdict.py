"""Pool every disjoint held-out band into one learned-vs-shape verdict.

The per-band matrices (``eval_matrix_48.json`` = seeds 100-147 plus
``eval_matrix_48_band<seed0>.json`` widening bands) each carry 48
complexes — too few to resolve a small hit-rate gap.  This tool
discovers all bands in a checkpoint directory, verifies they are
protocol-compatible and seed-disjoint, pools each row across bands,
and materializes the exact-McNemar verdict for every learned-vs-shape
pair as a JSON artifact (per-band breakdown included, platform
provenance preserved).

Pooling rules (what makes the statistic honest):
  * Only files matching the base matrix's protocol (everything except
    ``heldout_seeds``/``notes``) participate — the licensing columns
    (``_rank2``/``_fp32``/...) re-grade the SAME band under different
    knobs and must never be pooled as extra complexes.
  * A band contributes to a pair only when BOTH rows are complete in
    that band (McNemar is a paired test).
  * Bands must be seed-disjoint (duplicate complex names are an
    error, mirroring tools/significance.py).

Usage:
    python tools/pooled_verdict.py [MATRIX_DIR] [OUT.json]

Defaults: ``pretrained/synthetic-v9p`` and
``<MATRIX_DIR>/pooled_verdict.json``.
"""
from __future__ import annotations

import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from significance import binom_tail  # noqa: E402

PAIRS = [
    ("learned_local", "shape_local"),
    ("learned_global", "shape_global"),
    ("learned_rerank_global", "shape_global"),
]
METRICS = ("hit_top1", "hit_top10")


def _protocol_key(protocol: dict) -> dict:
    return {k: v for k, v in protocol.items()
            if k not in ("heldout_seeds", "notes")}


def discover(matrix_dir: str):
    """Base matrix + protocol-compatible ``_band*`` files, seed-sorted."""
    base = os.path.join(matrix_dir, "eval_matrix_48.json")
    paths = [base] if os.path.exists(base) else []
    paths += sorted(glob.glob(
        os.path.join(matrix_dir, "eval_matrix_48_band*.json")))
    if not paths:
        raise SystemExit(f"no eval_matrix files under {matrix_dir}")
    out, ref_proto = [], None
    for p in paths:
        with open(p) as f:
            d = json.load(f)
        proto = d.get("protocol")
        if proto is None:        # still being written (no complete row)
            continue
        key = _protocol_key(proto)
        if ref_proto is None:
            ref_proto = key
        elif key != ref_proto:
            print(f"[skip] {os.path.basename(p)}: protocol differs "
                  f"from base ({key} != {ref_proto})", file=sys.stderr)
            continue
        out.append((p, d))
    return out, ref_proto


def _row_fp_key(fp: dict) -> dict:
    """Row fingerprint minus the band-specific seed."""
    return {k: v for k, v in fp.items() if k != "seed0"}


def pool(files):
    """{row: {complex_name: record}} + per-row band/platform provenance.

    The top-level ``protocol`` dict does not record grading knobs
    (EM_DTYPE / EM_RANK / EM_AGG / EM_RESCORE); those live in each
    row's ``fingerprint``.  A band row whose fingerprint differs from
    the first-seen fingerprint for that row name (seed0 aside) is a
    licensing re-grade or a contaminated-env run, not extra complexes
    — it is skipped loudly.  Legacy rows without fingerprints (the
    pre-fingerprint base matrix) pool with a warning, mirroring
    eval_matrix's completed_row_reusable policy.
    """
    pooled: dict = {}
    prov: dict = {}
    ref_fp: dict = {}
    for path, d in files:
        band = os.path.basename(path)
        for row, v in d.items():
            if not (isinstance(v, dict) and "complexes" in v):
                continue
            fp = v.get("fingerprint")
            if fp is not None:
                key = _row_fp_key(fp)
                if row not in ref_fp:
                    ref_fp[row] = key
                elif key != ref_fp[row]:
                    print(f"[skip] {band}:{row}: row fingerprint "
                          f"differs from pooled bands "
                          f"({key} != {ref_fp[row]})", file=sys.stderr)
                    continue
            else:
                print(f"[warn] {band}:{row}: legacy row without "
                      f"fingerprint pooled unchecked", file=sys.stderr)
            dst = pooled.setdefault(row, {})
            for c in v["complexes"]:
                if c["name"] in dst:
                    raise SystemExit(
                        f"duplicate complex {c['name']} in row {row!r} "
                        f"({band}) — bands must be seed-disjoint")
                dst[c["name"]] = c
            prov.setdefault(row, []).append(
                dict(band=band, n=len(v["complexes"]),
                     platform=v.get("platform")))
    return pooled, prov


def mcnemar(a: dict, b: dict, metric: str) -> dict:
    names = sorted(set(a) & set(b))
    only_a = [n for n in names if a[n][metric] and not b[n][metric]]
    only_b = [n for n in names if b[n][metric] and not a[n][metric]]
    n_dis = len(only_a) + len(only_b)
    return dict(
        n=len(names),
        a_hits=sum(bool(a[n][metric]) for n in names),
        b_hits=sum(bool(b[n][metric]) for n in names),
        a_only=only_a, b_only=only_b,
        p_two_sided=binom_tail(len(only_a), n_dis) if n_dis else 1.0)


def platform_sensitivity(matrix_dir, files, proto, pooled):
    """Re-pool with CPU-recomputed band-100 rows substituted.

    Band 100 (``eval_matrix_48.json``) was graded on the original
    accelerator; the widening bands ran on CPU.  ``eval_matrix_48_cpu_parity.json``
    recomputes band-100's local rows on CPU under the identical
    protocol.  Pooling across platforms is only honest if the verdict
    is insensitive to which platform graded band 100 — this section
    materializes that check: per-decision flip counts plus the pooled
    local McNemar with the CPU rows substituted.
    """
    pp = os.path.join(matrix_dir, "eval_matrix_48_cpu_parity.json")
    if not os.path.exists(pp):
        return None
    with open(pp) as f:
        par = json.load(f)
    if _protocol_key(par.get("protocol", {})) != proto:
        return {"error": "parity file protocol differs; not comparable"}
    base = next((d for p, d in files
                 if os.path.basename(p) == "eval_matrix_48.json"), None)
    if base is None:
        return {"error": "base matrix not among pooled bands"}
    out = {"flips": {}, "pairs": {}}
    subst = {}
    for row, v in par.items():
        if not (isinstance(v, dict) and "complexes" in v):
            continue
        cpu_rows = {c["name"]: c for c in v["complexes"]}
        base_rows = {c["name"]: c for c in base.get(row, {})
                     .get("complexes", [])}
        flips = [
            dict(name=n, metric=m,
                 base=base_rows[n][m], cpu=cpu_rows[n][m])
            for n in sorted(set(cpu_rows) & set(base_rows))
            for m in METRICS if base_rows[n][m] != cpu_rows[n][m]]
        out["flips"][row] = dict(
            n_decisions=2 * len(set(cpu_rows) & set(base_rows)),
            n_flips=len(flips), detail=flips)
        subst[row] = cpu_rows
    for row_a, row_b in PAIRS:
        if row_a not in subst and row_b not in subst:
            continue
        a = dict(pooled.get(row_a, {}))
        b = dict(pooled.get(row_b, {}))
        if not a or not b:
            continue
        for row, dst in ((row_a, a), (row_b, b)):
            for name, rec in subst.get(row, {}).items():
                if name in dst:
                    dst[name] = rec
        shared = set(a) & set(b)
        entry = {}
        for metric in METRICS:
            m = mcnemar({k: a[k] for k in shared},
                        {k: b[k] for k in shared}, metric)
            entry[metric] = m
            print(f"[parity-substituted] {row_a} vs {row_b} "
                  f"[{metric}] n={m['n']}: {m['a_hits']} vs "
                  f"{m['b_hits']}  disagreements "
                  f"{len(m['a_only'])}:{len(m['b_only'])}  "
                  f"p={m['p_two_sided']:.4f}")
        out["pairs"][f"{row_a}_vs_{row_b}"] = entry
    return out


def main():
    matrix_dir = sys.argv[1] if len(sys.argv) > 1 else \
        "pretrained/synthetic-v9p"
    out_path = sys.argv[2] if len(sys.argv) > 2 else \
        os.path.join(matrix_dir, "pooled_verdict.json")
    files, proto = discover(matrix_dir)
    pooled, prov = pool(files)
    report = dict(protocol=proto,
                  bands=[os.path.basename(p) for p, _ in files],
                  pairs={})
    for row_a, row_b in PAIRS:
        a, b = pooled.get(row_a), pooled.get(row_b)
        if not a or not b:
            continue
        # Restrict to complexes where BOTH rows were graded (a band
        # with only shape_local done must not skew the paired test).
        shared = set(a) & set(b)
        if not shared:
            continue
        entry = dict(provenance={row_a: prov[row_a],
                                 row_b: prov[row_b]})
        for metric in METRICS:
            m = mcnemar({k: a[k] for k in shared},
                        {k: b[k] for k in shared}, metric)
            entry[metric] = m
            print(f"{row_a} vs {row_b} [{metric}] n={m['n']}: "
                  f"{m['a_hits']}/{m['n']} vs {m['b_hits']}/{m['n']}  "
                  f"disagreements {len(m['a_only'])}:"
                  f"{len(m['b_only'])}  p={m['p_two_sided']:.4f}")
        report["pairs"][f"{row_a}_vs_{row_b}"] = entry
    sens = platform_sensitivity(matrix_dir, files, proto, pooled)
    if sens is not None:
        report["platform_sensitivity"] = sens
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=2)
    os.replace(tmp, out_path)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
