"""Run one cell several times, each run its own process as the benchmark's
command runs it, and give each metric's median and spread: the distance
between the first and third quartiles (``statistics.quantiles(n=4)``) as a
share of the median.

    python3 bench_torch/spread.py --workload enhance-4k.live \
        --seeds 11-16 --seconds 10 [--trace 1] [--out runs.jsonl]

Prints the card's name and power limit, each run's result line, and last a
JSON line of the medians and spreads.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench_torch.control import seeds  # noqa: E402


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench_torch" / "run.py"), "--workload",
         workload, "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        return {"seed": seed, "rc": proc.returncode,
                "stderr": proc.stderr[-3000:]}
    return {"seed": seed, "rc": 0, **json.loads(lines[-1]),
            "stderr_tail": proc.stderr.strip().splitlines()[-6:]}


def spreads(runs: list[dict]) -> dict:
    values: dict[str, list[float]] = {}
    for r in runs:
        for name, m in r.get("metrics", {}).items():
            values.setdefault(name, []).append(m["value"])
    out = {}
    for name, v in values.items():
        med = statistics.median(v)
        q = statistics.quantiles(v, n=4) if len(v) > 1 else [med] * 3
        out[name] = {"median": med, "q1": q[0], "q3": q[2],
                     "spread": (q[2] - q[0]) / med if med else None,
                     "n": len(v)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    print(f"card: {card()}", flush=True)
    runs = []
    for seed in a.seeds:
        r = one(a.workload, seed, a.seconds, a.trace)
        runs.append(r)
        print(json.dumps(r), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps({"workload": a.workload, **r}) + "\n")
    correct = sum(1 for r in runs if r.get("correct") is True)
    print(json.dumps({"workload": a.workload, "runs": len(runs),
                      "correct": correct, "spreads": spreads(runs)}),
          flush=True)
    return 0 if correct == len(runs) else 1


if __name__ == "__main__":
    sys.exit(main())
