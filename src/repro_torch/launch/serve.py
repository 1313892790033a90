"""Serving launcher: the ``repro_torch.serve`` analysis front door, end to
end.

``python -m repro_torch.launch.serve --smoke``

The counterpart of ``repro/launch/serve.py``. Drives an
``AnalysisService`` through a synthetic multi-tenant workload: several
studies are uploaded (half feature tables, half the squares of feature
tables), a mixed bag of concurrent requests (the full battery — pcoa,
permanova, anosim, permdisp, mantel, partial_mantel — at mixed K) is
submitted, the coalescing tile loop drains them, and the
``serve_report()`` summary prints.

It runs on the card unless ``--device cpu`` is given. On the card it
builds the kernels before it opens the service, so that the ``nvcc``
build is counted in no request's latency or deadline. It exits non-zero
unless every request ends ``done``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.api.workspace import Workspace
from repro_torch.api.config import ExecConfig
from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.serve import AnalysisService, ServeConfig


def run(args) -> dict:
    device = resolve_device(args.device)
    if device.type == "cuda":
        _build.library()                 # build before any request's clock
    rng = np.random.default_rng(args.seed)
    svc = AnalysisService(ServeConfig(batch_size=args.batch,
                                      timeout_s=None,
                                      max_sessions=max(4, args.studies),
                                      device=args.device))

    # uploads: half feature-backed, half square-backed
    study_ids = [f"study{i}" for i in range(args.studies)]
    for i, sid in enumerate(study_ids):
        feats = rng.random((args.n, 8)).astype(np.float32)
        if i % 2:
            dm = Workspace.from_features(
                feats, config=ExecConfig(device=args.device)).dm.data
            svc.upload(sid, dm.cpu().numpy())
        else:
            svc.upload(sid, features=feats)

    grouping = np.arange(args.n) % 3
    methods = ("permanova", "anosim", "permdisp", "mantel",
               "partial_mantel", "pcoa")
    handles = []
    for r in range(args.requests):
        sid = study_ids[r % len(study_ids)]
        method = methods[r % len(methods)]
        kw = {"permutations": args.permutations // (1 + r % 3),
              "key": r}
        if method in ("permanova", "anosim", "permdisp"):
            kw["grouping"] = grouping
        if method in ("mantel", "partial_mantel"):
            kw["other"] = study_ids[(r + 1) % len(study_ids)]
        if method == "partial_mantel":
            kw["control"] = study_ids[(r + 2) % len(study_ids)]
        if method == "pcoa":
            kw = {"dimensions": 3}
        handles.append(svc.submit(sid, method, **kw))

    svc.run()
    report = svc.report()
    ok = sum(h.status == "done" for h in handles)
    g = report["gauges"]
    print(f"[serve] {ok}/{len(handles)} requests done on {device} | "
          f"{report['scheduler']['tiles_run']} tiles of B={args.batch} | "
          f"{report['pool']['sessions']} sessions, "
          f"{report['pool']['nbytes']} hoist bytes resident | "
          f"throughput {g['throughput_rps']:.1f} req/s")
    for h in handles[: args.show]:
        print(f"  {h.request_id:>4} {h.method:<14} {h.status:<8}"
              + (f" p={h.result.p_value:.4f}"
                 if getattr(h.result, "p_value", None) is not None else ""))
    if args.json:
        print(json.dumps({"gauges": g, "pool": report["pool"],
                          "scheduler": report["scheduler"]}, indent=2,
                         default=str))
    report["all_done"] = ok == len(handles)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="drive the repro_torch.serve analysis front door")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes (CI-friendly)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; the card otherwise")
    ap.add_argument("--studies", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--permutations", type=int, default=999)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--show", type=int, default=12,
                    help="per-request lines to print")
    ap.add_argument("--json", action="store_true",
                    help="dump the gauge/pool/scheduler sections as JSON")
    args = ap.parse_args(argv)
    if args.smoke:
        args.n = min(args.n, 32)
        args.permutations = min(args.permutations, 99)
    return 0 if run(args)["all_done"] else 1


if __name__ == "__main__":
    sys.exit(main())
