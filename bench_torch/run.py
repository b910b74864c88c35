"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 bench_torch/run.py --workload enhance-4k.live --seed 7 \
        --seconds 10 --trace 0

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with the reference
beside its limit (also the last lines on standard error). Without a CUDA
card, or with fewer than the cell asks for, it exits with code 2 and prints
no result. It also exits with code 3 and prints no result if the process
has loaded JAX or the JAX package by the time the window has closed.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if a.workload not in chips:
        print(f"no workload {a.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < chips[a.workload]):
        print(f"{a.workload} needs {chips[a.workload]} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    sys.path.insert(0, str(ROOT))
    from bench_torch import harness

    torch.set_num_threads(1)
    cell = harness.load_cell(a.workload, bench)
    result = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace),
                              torch.device("cuda", 0), T_START)
    loaded = harness.foreign_modules()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}: the benchmark measures "
              f"the port alone", file=sys.stderr)
        return 3
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
