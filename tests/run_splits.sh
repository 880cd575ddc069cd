#!/bin/bash
# Run the full test suite as four sequential pytest processes (see
# tests/SPLITS.md: a single process is killed by this rig at ~27-35 min).
# Usage: bash tests/run_splits.sh [extra pytest args]
set -u
cd "$(dirname "$0")/.."

SPLIT_A="tests/test_bring_up.py tests/test_cli.py tests/test_diagnostics.py tests/test_drift.py tests/test_ecm.py tests/test_fit_variants.py tests/test_inverter.py tests/test_io.py tests/test_matrices.py tests/test_ncp.py tests/test_nnls.py tests/test_nuts.py tests/test_nuts_drt.py"
SPLIT_M="tests/test_multidist.py"
SPLIT_B1="tests/test_outlier_cv.py tests/test_parallel.py tests/test_peaks.py tests/test_phase_offset.py tests/test_posterior_map.py tests/test_posterior_multidist.py tests/test_ridge.py"
SPLIT_B2="tests/test_reference_regression.py tests/test_ridge_options.py tests/test_round3.py tests/test_round4.py tests/test_round5.py tests/test_shmc_flat.py tests/test_sim.py tests/test_viz_persist.py tests/test_native_loader.py"

rc=0
for name in A M B1 B2; do
  var="SPLIT_$name"
  echo "=== split $name ==="
  start=$(date +%s)
  python -m pytest ${!var} -q "$@"
  r=$?
  echo "=== split $name done in $(( $(date +%s) - start ))s (rc=$r) ==="
  [ $r -ne 0 ] && rc=$r
done
exit $rc
