"""The spread of a cell's runs, as the bounds are set from it (never run by
the benchmark itself).

Each argument is a file with one run's standard output (its last line is
the result); the runs of one set share a ``--set`` label.  For each
end-to-end metric and set: the median and the spread, the distance
between the first and third quartiles of ``statistics.quantiles(values,
n=4)`` as a share of the median; the same without the run farthest from
the median; and over the sets, the mean of the trimmed spreads (how a
bound's tightness is judged) and the widest untrimmed spread (how its
looseness is judged, and what the bound is set from):

    python3 bench_port/tools/spread.py --set 1 a1.out a2.out ... --set 2 b1.out ...
"""

from __future__ import annotations

import json
import statistics
import sys
from typing import Dict, List


def spread(values: List[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values: List[float]) -> List[float]:
    """The values without the one farthest from their median."""
    m = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - m))
    return [v for i, v in enumerate(values) if i != far]


def last_result(path: str) -> dict:
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def main(argv: List[str]) -> int:
    sets: Dict[str, List[dict]] = {}
    label = "1"
    it = iter(argv)
    for a in it:
        if a == "--set":
            label = next(it)
            continue
        sets.setdefault(label, []).append(last_result(a))
    names = sorted({m for runs in sets.values() for r in runs for m in r["metrics"]})
    report = {}
    for m in names:
        per = {}
        for label, runs in sets.items():
            v = [r["metrics"][m]["value"] for r in runs if m in r["metrics"]]
            per[label] = {"n": len(v), "median": statistics.median(v), "spread": spread(v),
                          "spread_trimmed": spread(trimmed(v)),
                          "correct": sum(bool(r["correct"]) for r in runs)}
        report[m] = {"sets": per,
                     "tightness": statistics.mean(p["spread_trimmed"] for p in per.values()),
                     "widest": max(p["spread"] for p in per.values())}
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
