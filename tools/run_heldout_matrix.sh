#!/bin/sh
# Held-out report matrix: 48 polymer-backbone unbound complexes.
#
# Bands (second arg, default 100): seeds SEED0..SEED0+47. 100-147 is
# the round-3/4 report band; 1300-1347 is the round-5 second disjoint
# band (never used for tuning/selection). CAUTION: the flagship
# trained on seeds 200..1223 (TF_SEED0=200, TF_SEEDS=1024) and
# validates on 50..81 — synthetic_complex derives the structure from
# default_rng(seed), so any band inside those ranges is training-set
# evaluation (eval_matrix.py now refuses such bands). Pool bands for
# the combined McNemar with tools/significance.py's '+' row specs:
#   python tools/significance.py \
#     "$OUT/eval_matrix_48.json:learned_local+$OUT/eval_matrix_48_band1300.json:learned_local" \
#     "$OUT/eval_matrix_48.json:shape_local+$OUT/eval_matrix_48_band1300.json:shape_local"
#
# Columns (main band only; licensing columns don't need re-running per
# band — they license numerics, not protocols):
#   eval_matrix_48[_bandN].json  shape vs learned, global + local
#                                protocols, + two-stage rerank row
#   eval_matrix_48_rank2.json    coupling_rank=2 truncation (licensing)
#   eval_matrix_48_fp32.json     float32 sweep (licenses bf16 headline)
#
# Usage: sh tools/run_heldout_matrix.sh [ckpt_dir] [seed0]
set -e
CKPT=${1:-pretrained/synthetic-v9p/best}
SEED0=${2:-100}
OUT=$(dirname "$CKPT")
SUFFIX=""
[ "$SEED0" != "100" ] && SUFFIX="_band$SEED0"

base="EM_BACKBONE=1 EM_UNBOUND=1.2 EM_WIDEN=1 EM_COMPLEXES=48 \
EM_SEED0=$SEED0 EM_NROT=1536 EM_GRID=64"

# eval_matrix.py checkpoints per complex and resumes from its output
# file, so a device worker crash (observed round 4) costs one complex,
# not the run: retry each column up to 3 times.
run_col() {
    for attempt in 1 2 3; do
        if env $base "$@"; then return 0; fi
        echo "column failed (attempt $attempt), retrying..." >&2
        sleep 30
    done
    return 1
}

run_col EM_RERANK=1 \
    python tools/eval_matrix.py "$CKPT" "$OUT/eval_matrix_48$SUFFIX.json"
if [ -z "$SUFFIX" ]; then
    run_col EM_MODES=global EM_RANK=2 \
        python tools/eval_matrix.py "$CKPT" "$OUT/eval_matrix_48_rank2.json"
    run_col EM_MODES=global EM_DTYPE=float32 \
        python tools/eval_matrix.py "$CKPT" "$OUT/eval_matrix_48_fp32.json"
fi
