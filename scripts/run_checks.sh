#!/usr/bin/env bash
# All test lanes in one place.  Usage:
#
#   scripts/run_checks.sh            # default CPU suite        (~15 min)
#   scripts/run_checks.sh slow      # + RUN_SLOW statistical lane (~+5 min)
#   scripts/run_checks.sh all       # both, sequentially
#
# The GPU lane (tests marked `gpu`) runs on the card inside
# `python chip_smoke.py`; on the CPU those tests skip.
set -euo pipefail
cd "$(dirname "$0")/.."
lane="${1:-default}"

run_default() {
    echo "== default CPU suite (virtual 8-device mesh, x64) =="
    JAX_PLATFORMS=cpu python -m pytest tests/ -q -x
}

run_slow() {
    echo "== RUN_SLOW statistical lane (KSD SGLD-vs-LD ordering, ~4.5 min) =="
    RUN_SLOW=1 JAX_PLATFORMS=cpu python -m pytest tests/test_ksd_sgld_vs_ld.py -q -x
}

case "$lane" in
    default) run_default ;;
    slow)    run_slow ;;
    all)     run_default; run_slow ;;
    *) echo "unknown lane '$lane' (default|slow|all)"; exit 2 ;;
esac
