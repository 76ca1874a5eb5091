#!/bin/bash
# The LM dry-run's --all sweep on one pod (16 x 16, full configs), one
# process a cell, PROCS at a time, each cut at CELL_LIMIT seconds, then
# the roofline table of its records.  Run from the repository root:
#
#   CELL_LIMIT=1200 PROCS=8 bash scripts/lm_dryrun_sweep.sh [OUT]
#
# Records go to results/dryrun (what `bench.run --only roofline` reads)
# and are copied, with each cell's log, the card's name and power limit
# and the table, to OUT (default results/dryrun_sweep).
set -u
export PYTHONPATH=src
OUT=${1:-results/dryrun_sweep}
LIMIT=${CELL_LIMIT:-1200}
rm -rf "$OUT" results/dryrun
mkdir -p "$OUT/logs" results/dryrun
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$OUT/card.txt"
# the scan families' cells first: their traces are the longest
python - > "$OUT/jobs.txt" <<'PY'
from repro_torch.configs import registry
from repro_torch.launch import dryrun
jobs = [(registry.get_config(a).family not in ("ssm", "hybrid"), a, c)
        for a in registry.list_archs() for c in dryrun.cell_plan(a)]
for _, a, c in sorted(jobs, key=lambda j: j[0]):
    print(a, c)
PY
T0=$(date +%s)
xargs -P "${PROCS:-8}" -L 1 bash -c 'S=$(date +%s); timeout '"$LIMIT"' python -m repro_torch.launch.dryrun --arch $0 --cell $1 --out results/dryrun > '"$OUT"'/logs/$0__$1.log 2>&1; echo "rc=$? s=$(( $(date +%s) - S ))" >> '"$OUT"'/logs/$0__$1.log' < "$OUT/jobs.txt"
echo "sweep wall $(( $(date +%s) - T0 )) s" > "$OUT/wall.txt"
python -m repro_torch.bench.run --only roofline > "$OUT/roofline.csv" 2>&1
cp results/dryrun/*.json "$OUT/" 2>/dev/null
for f in "$OUT"/logs/*.log; do echo "$(basename "$f" .log) $(tail -1 "$f")"; done > "$OUT/cells.txt"
cat "$OUT/wall.txt" "$OUT/cells.txt"
