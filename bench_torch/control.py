"""The readings that a cell's limits are set from, in one process on the
card: the program's over many seeds, and the control's, the plain reference
computed in bfloat16 (the nearest precision below the float32 the
configurations state) and put in the program's place, each over a short
window at the cell's own load.

    python3 bench_torch/control.py --workload enhance-4k.live \
        --seeds 101-112 --control-seeds 201-203 --seconds 1

Prints one JSON line per run and, last, the widest reading of each number
over the program's seeds and the smallest over the control's.
"""

import argparse
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CONTROL_DTYPE = "bfloat16"


def seeds(text: str) -> list[int]:
    """"1-3,7" -> [1, 2, 3, 7]."""
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += range(int(lo), int(hi or lo) + 1)
    return out


def control_entry(cell, dtype):
    return functools.partial(cell.module.reference, cell.config, dtype=dtype)


def readings(cell, seed: int, seconds: float, device, entry=None) -> dict:
    from bench_torch import harness

    result = harness.run_cell(cell, seed, seconds, False, device,
                              time.perf_counter(), entry=entry)
    return {name: c["value"] for name, c in result["checks"].items()}


def summary(program: list[dict], control: list[dict]) -> dict:
    names = program[0].keys() if program else control[0].keys()
    return {name: {"program_max": max((r[name] for r in program),
                                      default=None),
                   "control_min": min((r[name] for r in control),
                                      default=None)}
            for name in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control-seeds", type=seeds, required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    a = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from bench_torch import harness

    device = torch.device("cuda", 0)
    cell = harness.load_cell(a.workload)
    program, control = [], []
    for side, picked, entry in (
            ("program", a.seeds, None),
            ("control", a.control_seeds,
             control_entry(cell, getattr(torch, CONTROL_DTYPE)))):
        for seed in picked:
            got = readings(cell, seed, a.seconds, device, entry)
            (program if entry is None else control).append(got)
            print(json.dumps(harness.plain({"workload": a.workload,
                                            "side": side, "seed": seed,
                                            **got})), flush=True)
    print(json.dumps(harness.plain({"workload": a.workload, "summary":
                                    summary(program, control)})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
