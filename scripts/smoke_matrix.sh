#!/bin/bash
# CLI smoke matrix: one run per flag-family combination (all drivers,
# all optimizers, partupdate, bf16, layouts, checkpoint/resume, profile,
# sparse, damping). Prints "rc=<code>" after each line; CSVs and
# checkpoints go to smoke_out/matrix/.
# Usage: bash scripts/smoke_matrix.sh   (from any directory)
cd "$(dirname "$0")/.."
OUT=smoke_out/matrix
mkdir -p "$OUT"
CLI="python -m pairwise_perturbation_tpu.cli"
run() { echo "### $*"; timeout 900 $CLI "$@" -quiet -filename "$OUT/smoke.csv" >/dev/null 2>&1; echo "rc=$?"; }
run test_als -model CP -tensor r -pp 0 -dim 4 -size 16 -rank 4 -maxiter 10
run test_als -model CP -tensor r -pp 1 -dim 4 -size 16 -rank 4 -maxiter 10 -device_loop 2
run test_als -model CP -tensor c -pp 2 -dim 4 -size 16 -rank 4 -maxiter 10 -update_percentage_pp 0.5
run test_als -model CP -tensor r2 -pp 1 -dim 4 -size 16 -rank 4 -maxiter 10 -layouts 1
run test_als -model CP -tensor p2 -pp 1 -dim 6 -size 6 -rank 3 -maxiter 10
run test_als -model Tucker -tensor r2 -pp 0 -dim 4 -size 16 -rank 4 -maxiter 8
run test_als -model Tucker -tensor r2 -pp 1 -dim 4 -size 16 -rank 4 -maxiter 8 -device_loop 2 -tucker_pp_skip 0.1
run test_als -model CP -tensor r -pp 1 -dim 4 -size 16 -rank 4 -maxiter 8 -dtype bfloat16 -device_loop 2
run test_als -model CP -tensor r -pp 1 -dim 4 -size 12 -rank 3 -maxiter 8 -checkpoint $OUT/smoke_ckpt
run test_als -model CP -tensor r -pp 1 -dim 4 -size 12 -rank 3 -maxiter 8 -resume $OUT/smoke_ckpt.npz
run run -tensor r -pp 0 -dim 4 -size 14 -rank 3 -maxiter 8
run run -tensor r -pp 1 -dim 4 -size 14 -rank 3 -maxiter 8 -device_loop 1
run run -tensor r -pp 2 -dim 4 -size 14 -rank 3 -maxiter 8 -updaterank 1
run run -tensor r -pp 3 -dim 4 -size 14 -rank 3 -maxiter 8 -updaterank 1 -randomsvd 1
run run -tensor r -pp 4 -dim 4 -size 14 -rank 3 -maxiter 8
run run -tensor r2 -pp 1 -dim 4 -size 14 -rank 3 -maxiter 8 -issparse 1
run pp_bench -model CP -tensor r -dim 4 -size 16 -rank 4 -maxiter 3
run pp_bench -model Tucker -tensor r2 -dim 4 -size 14 -rank 4 -maxiter 3
run test_als -model CP -tensor r -pp 1 -dim 4 -size 16 -rank 4 -maxiter 8 -profile 1
run test_als -model CP -tensor r -pp 1 -dim 3 -size 20 -rank 4 -maxiter 8 -lambda 0.01 -magni 0.8 -pp_res_tol 0.05
