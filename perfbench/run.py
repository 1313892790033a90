"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``perfbench/`` and
the port under ``src/``. The run makes its inputs from the seed on the card,
warms up one study, measures closed-loop studies for ``--seconds``, judges
what the window produced against the plain reference and prints one JSON
line as the last line of standard output. Without a CUDA device, or with
fewer than the cell asks for, it prints no result and exits 2.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness
    return harness.main(ROOT, args, STARTED)


if __name__ == "__main__":
    sys.exit(main())
