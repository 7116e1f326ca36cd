#!/usr/bin/env bash
# One-command release gate: the CPU suite (virtual 8-device mesh + real
# 2-process clusters), then, on a machine with an NVIDIA GPU, the card
# smoke test (chip_smoke.py: f64-reference parity, the main path end to
# end, tests_gpu/) and a headline bench sanity check.
#
# Usage: bash scripts/release_check.sh [--skip-gpu]
set -uo pipefail
cd "$(dirname "$0")/.."
SKIP_GPU="${1:-}"
fail=0

step() { echo; echo "=== $1"; }

step "CPU suite (tests/, includes multi-process clusters)"
JAX_PLATFORMS=cpu python -m pytest tests/ -q || fail=1

if [ "$SKIP_GPU" != "--skip-gpu" ]; then
    step "card smoke test (chip_smoke.py, phases A-D)"
    timeout 1200 python chip_smoke.py || fail=1

    step "headline bench sanity (one JSON line, finite value)"
    out="$(timeout 1800 python bench.py | tail -1)"
    echo "$out"
    python - "$out" <<'PYEOF' || fail=1
import json
import sys
d = json.loads(sys.argv[1])
assert d["value"] > 0 and d["metric"], d
print("bench OK:", d["metric"], "=", d["value"], d["unit"])
PYEOF
fi

echo
if [ "$fail" -eq 0 ]; then
    echo "RELEASE CHECK: PASS"
else
    echo "RELEASE CHECK: FAIL"
fi
exit $fail
