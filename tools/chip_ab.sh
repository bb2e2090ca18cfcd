#!/usr/bin/env bash
# Whole-script A/B of two checkouts of the repo on one card.
#
# Runs chip_smoke.py from each checkout in the order A B B A (or the
# order given as a sixth argument, a string of A and B), one after
# another, so that both see the same card and host, and prints each run's
# exit code, wall seconds and "phase seconds" line.  Each run's whole
# output goes to <log-dir>/ab_<label>_<n>.log.
#
#   bash tools/chip_ab.sh <label-a> <dir-a> <label-b> <dir-b> <log-dir> [order]
#
# Each directory is a checkout, e.g. `git archive <commit> | tar -x -C dir`.
set -u
if [ $# -ne 5 ] && [ $# -ne 6 ]; then
    echo "usage: $0 <label-a> <dir-a> <label-b> <dir-b> <log-dir> [order]" >&2
    exit 2
fi
order="${6:-ABBA}"
case "$order" in
    *[!AB]*|"") echo "order must be a string of A and B: $order" >&2; exit 2 ;;
esac
mkdir -p "$5"
out="$(cd "$5" && pwd)"
a="$1 $2"
b="$3 $4"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
status=0
n=0
for ((i = 0; i < ${#order}; i++)); do
    if [ "${order:i:1}" = A ]; then side="$a"; else side="$b"; fi
    set -- $side
    n=$((n + 1))
    log="$out/ab_${1}_${n}.log"
    start=$(date +%s%N)
    (cd "$2" && python3 chip_smoke.py) > "$log" 2>&1
    rc=$?
    ms=$(( ($(date +%s%N) - start) / 1000000 ))
    [ $rc -ne 0 ] && status=1
    printf 'run %d %s rc=%d wall_s=%d.%03d\n' "$n" "$1" "$rc" \
        $((ms / 1000)) $((ms % 1000))
    grep -a '^phase seconds' "$log" | tail -n 1
done
exit $status
