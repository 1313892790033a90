"""The readings that the limits in ``limits/<workload>.json`` are set from.

    python3 perfbench/readings.py --workload <name> --seeds 1,2,3 [--studies 4] [--control]

For each seed, in one process: the cell's inputs, a warm-up study, then
``--studies`` studies through the port as a window runs them, judged by the
plain reference call by call. With ``--control``, each call is judged once
more with its control in the program's place: that call's reference one
precision below the configuration's fp32 with TF32 off, i.e. in TF32.
Each seed prints one JSON line; the lines are also written to
``chiprun_out/readings_<workload>.jsonl`` when that folder exists.

The benchmark's runs do not run this; it needs a CUDA device.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--studies", type=int, default=4)
    p.add_argument("--control", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import harness, manifest
    harness.check_device(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cell = manifest.resolve(manifest.load_json(ROOT / "BENCHMARK.json"),
                            args.workload, ROOT / "perfbench")
    out_dir = ROOT / "chiprun_out"
    sink = (out_dir / f"readings_{args.workload}.jsonl").open("a") \
        if out_dir.is_dir() else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        bench = harness.Bench(cell, seed, dev)
        bench.study(bench.plan.warmup_key)
        studies, _, _ = bench.window(0.0, count=args.studies)
        torch.cuda.empty_cache()
        line = {"workload": args.workload, "seed": seed,
                "program": bench.judge_calls(studies)}
        if args.control:
            line["control"] = bench.judge_calls(studies, control=True)
        line["seconds"] = time.perf_counter() - t0
        text = json.dumps(harness.finite(line))
        print(text, flush=True)
        if sink:
            sink.write(text + "\n")
        del bench, studies
        torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
