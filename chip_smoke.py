#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into
``build/repro_torch/``), then runs five phases and exits non-zero if any
check fails:

1. environment: the card's name and power limit, versions, build time;
2. every kernel against its plain PyTorch version on the card, at a ragged
   small shape (n = 1000) and at the main path's shape;
3. the main path at n = 16384 (a 1.07 GB fp32 matrix): two validated
   ``DistanceMatrix`` objects, ``pcoa(dimensions=10)`` matrix-free, and
   ``mantel(permutations=999)`` against a noisy copy, with the kernels'
   launch counts set to 0 just before and read just after;
4. checks of the answers (and of a small pipeline on the card against the
   CPU) and per-phase times; then pcoa's time taken apart: the main path's
   cold call beside warm calls, a warm call step by step, and the solver's
   first calls in a fresh process (``--solver-first-calls``, which the
   script runs itself);
5. one JSON line of per-kernel launches, errors, times and bounds.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
outside a checkout of the repository, it fails before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N = 16384            # samples on the main path
POINT_DIM = 8        # the samples are points in 8 dimensions: rank-8 spectrum
DIMS = 10            # PCoA dimensions (sketch width 20)
PERMUTATIONS = 999   # Mantel permutations: 32 tiles of 32
SMALL_N = 1000       # the ragged small shape of phase 2
SEED = 2021

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, no sparsity).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12           # CUDA cores, outside the tensor cores
FP64_FLOPS = 34e12           # CUDA cores, outside the tensor cores

KERNEL_TOL = "rtol 1e-5, atol 1e-5*max(scale,1)"


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around ``reps``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Hold a kernel's output against its plain version at the stated
    tolerance; return the max abs error."""
    got = got.double().cpu()
    want = want.double().cpu()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    err = (got - want).abs()
    scale = float(want.abs().max()) if want.numel() else 0.0
    limit = 1e-5 * max(scale, 1.0) + 1e-5 * want.abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / want.abs().clamp_min(1e-30)).max()) \
        if err.numel() else 0.0
    print(f"  {name}: max abs err {max_abs:.3e}, max rel err {max_rel:.3e} "
          f"(scale {scale:.4g}; {KERNEL_TOL})")
    check(bool((err <= limit).all()), f"{name}: outside {KERNEL_TOL}")
    return max_abs


def check_spectrum(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """The leading POINT_DIM eigenvalues agree to rtol 1e-4; the rest, which
    are numerically zero for rank-POINT_DIM data, to 1e-4 of the largest."""
    got, want = got.double().cpu(), want.double().cpu()
    lead = slice(0, POINT_DIM)
    rel = float(((got[lead] - want[lead]).abs() / want[lead].abs()).max())
    tail = float((got - want).abs().max() / want.abs().max())
    print(f"  {what}: leading {POINT_DIM} eigenvalues max rel err {rel:.2e} "
          f"(rtol 1e-4); all, relative to the largest, {tail:.2e} (1e-4)")
    check(rel <= 1e-4 and tail <= 1e-4, f"{what}: eigenvalues disagree")


def phase_environment() -> dict:
    print("== phase 1: environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: "
          f"{lib_path.relative_to(ROOT)}")
    for line in _build.build_log().splitlines():
        if "registers" in line or ("spill" in line
                                   and " 0 bytes spill" not in line):
            print("  " + line.strip())
    return {"card": card}


def symhollow_cases(d: torch.Tensor):
    n = d.shape[0]
    i, j = n // 3, n - 2
    yield "valid", d
    bad = d.clone()
    bad[i, j] += 1.0
    yield "asymmetric", bad
    bad = d.clone()
    bad[j, j] = 0.5
    yield "non-hollow", bad
    bad = d.clone()
    bad[i, j] = bad[j, i] = float("nan")
    yield "nan", bad


def phase_kernels(d_main: torch.Tensor, ynorm_main: torch.Tensor) -> dict:
    """Every kernel against its plain version; returns max abs errors at
    the main-path shape."""
    from repro_torch.core import random_distance_matrix
    from repro_torch.core.distance_matrix import (condensed_form,
                                                  triangle_coords)
    from repro_torch.kernels.center_matvec import center_matvec
    from repro_torch.kernels.center_matvec_ref import (center_corrections,
                                                       center_matvec_ref)
    from repro_torch.kernels.permute_reduce import (permute_reduce_finish,
                                                    permute_reduce_partials)
    from repro_torch.kernels.permute_reduce_ops import DEFAULT_CHUNK
    from repro_torch.kernels.permute_reduce_ref import (
        permute_reduce_finish_ref, permute_reduce_ref)
    from repro_torch.kernels.symhollow import symhollow
    from repro_torch.kernels.symhollow_ref import is_symmetric_and_hollow_ref
    from repro_torch.stats.engine import permutation_orders

    print("== phase 2: kernels against their plain versions on the card")
    errors = {}
    d_small = random_distance_matrix(SEED + 1, SMALL_N, device="cuda").data
    for label, d in (("n=1000", d_small), (f"n={N}", d_main)):
        n = d.shape[0]
        for case, mat in symhollow_cases(d):
            got = tuple(v == 1 for v in symhollow(mat).tolist())
            want = is_symmetric_and_hollow_ref(mat)
            print(f"  symhollow {label} {case}: kernel {got}, plain {want} "
                  f"(exact)")
            check(got == want, f"symhollow {label} {case}: {got} != {want}")
        errors["symhollow"] = 0.0

        gen = torch.Generator().manual_seed(SEED + n)
        x = torch.randn((n, DIMS + 10), generator=gen).cuda()
        row_means = -0.5 * torch.mean(d * d, dim=1)
        gm = torch.mean(row_means)
        colsum, corr = center_corrections(x, row_means, gm)
        errors["center_matvec"] = compare(
            f"center_matvec {label} k={DIMS + 10}",
            center_matvec(d, x, row_means, colsum, corr),
            center_matvec_ref(d, x, row_means, gm))

        xc = condensed_form(d)
        ii, jj = triangle_coords(n, device="cuda")
        orders = permutation_orders(SEED + 2, 32, n, "cuda")
        stacks = [("S=1", ynorm_main[None, :] if n == N else
                   torch.randn((1, xc.numel()), generator=gen).cuda())]
        if n == SMALL_N:
            stacks.append(("S=2", torch.randn((2, xc.numel()),
                                              generator=gen).cuda()))
        for rows_label, ys in stacks:
            partials = permute_reduce_partials(xc, ys, ii, jj, orders,
                                               chunk=DEFAULT_CHUNK)
            out = permute_reduce_finish(partials)
            errors["permute_reduce"] = compare(
                f"permute_reduce {label} {rows_label} B=32", out,
                permute_reduce_ref(xc, ys, ii, jj, orders, n, DEFAULT_CHUNK))
            errors["permute_reduce_finish"] = compare(
                f"permute_reduce_finish {label} {rows_label}", out,
                permute_reduce_finish_ref(partials))
        del xc, ii, jj
    return errors


def phase_main_path(dm0, d2) -> dict:
    from repro_torch.core import DistanceMatrix, mantel, pcoa
    from repro_torch.kernels import _build

    print(f"== phase 3: main path at n={N} (validate, pcoa dims={DIMS}, "
          f"mantel K={PERMUTATIONS})")
    sync()
    _build.reset_launches()
    t0 = time.perf_counter()
    dm = DistanceMatrix(dm0.data)
    dm2 = DistanceMatrix(d2)
    sync()
    t1 = time.perf_counter()
    res = pcoa(dm, dimensions=DIMS)
    sync()
    t2 = time.perf_counter()
    stat, p, size = mantel(dm, dm2, permutations=PERMUTATIONS)
    sync()
    t3 = time.perf_counter()
    launches = dict(_build.launches)
    times = {"validate_2x_s": t1 - t0, "pcoa_s": t2 - t1, "mantel_s": t3 - t2}
    print(f"  launches on the main path: {launches}")
    return {"dm": dm, "pcoa": res, "stat": stat, "p": p, "size": size,
            "launches": launches, "times": times}


def phase_checks(main: dict, card: str) -> None:
    from repro_torch.core import DistanceMatrix, mantel, pcoa
    from repro_torch.core.pcoa import sketch_width
    from repro_torch.stats.engine import permutation_orders

    print("== phase 4: checks and timings")
    res = main["pcoa"]
    ev = res.eigenvalues.cpu()
    print(f"  eigenvalues: {[round(float(v), 4) for v in ev]}")
    check(tuple(res.coordinates.shape) == (N, DIMS), "pcoa: coordinates shape")
    check(bool(torch.isfinite(res.coordinates).all()), "pcoa: non-finite")
    check(bool((ev[:POINT_DIM] > 0).all()),
          f"pcoa: one of the leading {POINT_DIM} eigenvalues is not > 0")
    check(bool((ev[POINT_DIM:].abs() <= 1e-4 * ev[0]).all()),
          f"pcoa: eigenvalues past the data's rank {POINT_DIM} are not ~0")
    # the same solve with F materialized by plain PyTorch (no kernel)
    mat = pcoa(main["dm"], dimensions=DIMS, materialize=True)
    check_spectrum(ev, mat.eigenvalues, "matrix-free vs materialized solve")
    p_want = float(np.float32(1) / np.float32(PERMUTATIONS + 1))
    print(f"  mantel: stat {main['stat']:.6f}, p {main['p']}, n {main['size']}")
    check(main["stat"] > 0.99, "mantel: stat <= 0.99")
    check(main["p"] == p_want, f"mantel: p != 1/{PERMUTATIONS + 1}")
    launches = main["launches"]
    tiles = -(-PERMUTATIONS // 32)
    check(launches["symhollow"] >= 2, "symhollow launched < 2 times")
    check(launches["center_matvec"] == 4, "center_matvec launches != 4")
    check(launches["permute_reduce"] == tiles,
          f"permute_reduce launches != {tiles}")
    check(launches["permute_reduce_finish"] == tiles,
          f"permute_reduce_finish launches != {tiles}")

    # a small pipeline on the card against the same pipeline on the CPU
    n = 512
    dm_cpu = DistanceMatrix(main["dm"].data[:n, :n].cpu(), device="cpu")
    noisy = (dm_cpu.data + 0.01 * torch.triu(torch.rand(
        (n, n), generator=torch.Generator().manual_seed(SEED)), 1))
    noisy = torch.triu(noisy, 1) + torch.triu(noisy, 1).T
    omega = torch.randn((n, sketch_width(DIMS, n)),
                        generator=torch.Generator().manual_seed(SEED))
    orders = permutation_orders(SEED, 99, n)
    out = {}
    for dev in ("cpu", "cuda"):
        a = DistanceMatrix(dm_cpu.data, device=dev)
        b = DistanceMatrix(noisy, device=dev)
        r = pcoa(a, dimensions=DIMS, omega=omega, device=dev)
        out[dev] = (r.eigenvalues.cpu(),
                    mantel(a, b, permutations=99, orders=orders, device=dev))
    check_spectrum(out["cuda"][0], out["cpu"][0],
                   f"n={n} pipeline, card vs CPU")
    print(f"  n={n} pipeline, card vs CPU: mantel {out['cuda'][1][:2]} vs "
          f"{out['cpu'][1][:2]}")
    check(out["cuda"][1][1] == out["cpu"][1][1],
          "small pipeline: p differs from the CPU")
    check(abs(out["cuda"][1][0] - out["cpu"][1][0]) <= 1e-5,
          "small pipeline: statistic differs from the CPU")
    for name, seconds in main["times"].items():
        print(f"  {name}: {seconds:.4f} ({card})")


def pcoa_steps(dm) -> dict:
    """One ``pcoa(dm, dimensions=DIMS)`` taken apart: its steps in the order
    ``core/pcoa.py`` runs them, each timed on the host clock between two
    synchronisations, so launches, library calls and host syncs count where
    they fall. Returns ms per step (repeated steps summed)."""
    from repro_torch.core.operators import CenteredGramOperator
    from repro_torch.core.pcoa import DEFAULT_SEED, POWER_ITERS, sketch_width
    from repro_torch.core.validation import ensure_finite

    steps = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        steps[name] = steps.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    def qr(y):
        return timed("qr, 3 calls", lambda: torch.linalg.qr(y)[0])

    def project(q, aq):
        t = q.T @ aq
        return 0.5 * (t + t.T)

    data = timed("copy (validation cached)", lambda: dm.copy().data)
    timed("ensure_finite", lambda: ensure_finite(data))
    omega = timed("omega (CPU draw, copy to the card)", lambda: torch.randn(
        (N, sketch_width(DIMS, N)), dtype=torch.float32,
        generator=torch.Generator().manual_seed(DEFAULT_SEED)).cuda())
    op = timed("hoist row means", lambda: CenteredGramOperator.from_distance(
        data))
    q = qr(timed("center_matvec, 4 calls", lambda: op.matvec(omega)))
    for _ in range(POWER_ITERS):
        q = qr(timed("center_matvec, 4 calls", lambda: op.matvec(q)))
    aq = timed("center_matvec, 4 calls", lambda: op.matvec(q))
    t = timed("project Q^T A Q", lambda: project(q, aq))
    evals, evecs = timed("eigh (p x p)", lambda: torch.linalg.eigh(t))

    def finish():
        order = torch.argsort(-evals)[:DIMS]
        pos = torch.clamp_min(evals[order], 0.0)
        coords = (q @ evecs)[:, order] * torch.sqrt(pos)[None, :]
        total = op.trace()
        return coords, torch.where(total > 0, pos / total,
                                   torch.zeros_like(pos))
    timed("lift, trace, proportions", finish)
    return steps


def solver_first_calls() -> dict:
    """ms of the first and of a second ``torch.linalg.qr`` of an (N, p)
    block and ``torch.linalg.eigh`` of a (p, p) matrix on the card, in this
    process, after the CUDA context exists: the first call's excess is the
    solver library's one-time set-up."""
    from repro_torch.core.pcoa import sketch_width

    p = sketch_width(DIMS, N)
    y = torch.randn((N, p), device="cuda")
    t = y[:p].T @ y[:p]
    out = {}
    for name, fn in (("qr", lambda: torch.linalg.qr(y)),
                     ("eigh", lambda: torch.linalg.eigh(t))):
        for call in ("first", "second"):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            out[f"{name}_{call}_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def phase_pcoa_split(main: dict, card: str) -> None:
    """The main path's cold ``pcoa`` next to warm calls, a warm call taken
    apart, and the solver's first-call set-up from a fresh process."""
    from repro_torch.core import pcoa

    print(f"== phase 4b: where pcoa's time goes ({card})")
    print(f"  cold (the main path's call, first solver calls of the "
          f"process): {main['times']['pcoa_s'] * 1e3:.4f} ms")
    for rep in range(3):
        sync()
        t0 = time.perf_counter()
        pcoa(main["dm"], dimensions=DIMS)
        sync()
        print(f"  warm call {rep + 1}: "
              f"{(time.perf_counter() - t0) * 1e3:.4f} ms")
    steps = pcoa_steps(main["dm"])
    for name, ms in steps.items():
        print(f"  warm step {name}: {ms:.4f} ms")
    print(f"  warm steps in all: {sum(steps.values()):.4f} ms")
    fresh = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--solver-first-calls"],
        capture_output=True, text=True, timeout=300)
    check(fresh.returncode == 0,
          f"solver first-call probe failed: {fresh.stderr[-2000:]}")
    first = json.loads(fresh.stdout.strip().splitlines()[-1])
    print(f"  solver first calls in a fresh process (ms): {first}")


def phase_kernel_line(main: dict, errors: dict, d: torch.Tensor,
                      ynorm: torch.Tensor, card: str) -> None:
    from repro_torch.core.distance_matrix import (condensed_form,
                                                  triangle_coords)
    from repro_torch.kernels.center_matvec import center_matvec
    from repro_torch.kernels.center_matvec_ref import (center_corrections,
                                                       center_matvec_ref)
    from repro_torch.kernels.permute_reduce import (permute_reduce_finish,
                                                    permute_reduce_partials)
    from repro_torch.kernels.permute_reduce_ops import DEFAULT_CHUNK
    from repro_torch.kernels.permute_reduce_ref import (
        permute_reduce_finish_ref, permute_reduce_ref)
    from repro_torch.kernels.symhollow import symhollow
    from repro_torch.kernels.symhollow_ref import is_symmetric_and_hollow_ref
    from repro_torch.stats.engine import permutation_orders

    print(f"== phase 5: kernel times at the main path's shapes ({card})")
    n, k, perms, rows = N, DIMS + 10, 32, 1
    m = n * (n - 1) // 2
    kernels = []

    def entry(name, source, replaces, ms, plain_ms, bytes_, flops, peak,
              library_ms=None, **yardsticks):
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main["launches"][name],
            "max_abs_err": errors[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, **yardsticks})

    entry("symhollow", "src/repro_torch/csrc/symhollow.cu",
          "src/repro/kernels/symhollow.py:50",
          cuda_ms(lambda: symhollow(d), reps=20),
          cuda_ms(lambda: is_symmetric_and_hollow_ref(d), reps=5),
          4 * n * n + 8, n * n, FP32_FLOPS)

    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((n, k), generator=gen).cuda()
    row_means = -0.5 * torch.mean(d * d, dim=1)
    gm = torch.mean(row_means)
    colsum, corr = center_corrections(x, row_means, gm)
    e = -0.5 * d * d
    matmul_ms = cuda_ms(lambda: torch.matmul(e, x), reps=20)
    del e
    entry("center_matvec", "src/repro_torch/csrc/center_matvec.cu",
          "src/repro/kernels/center_matvec.py:59",
          cuda_ms(lambda: center_matvec(d, x, row_means, colsum, corr),
                  reps=20),
          cuda_ms(lambda: center_matvec_ref(d, x, row_means, gm), reps=5),
          4 * (n * n + 2 * n * k + n + 2 * k), 2 * n * n * k + 2 * n * n,
          FP32_FLOPS, yardstick_matmul_preformed_e_ms=matmul_ms)

    xc = condensed_form(d)
    ii, jj = triangle_coords(n, device="cuda")
    orders = permutation_orders(SEED + 3, perms, n, "cuda")
    ys = ynorm[None, :]
    chunks = -(-m // DEFAULT_CHUNK)
    partials = permute_reduce_partials(xc, ys, ii, jj, orders,
                                       chunk=DEFAULT_CHUNK)
    entry("permute_reduce", "src/repro_torch/csrc/permute_reduce.cu",
          "src/repro/kernels/permute_reduce.py:90",
          cuda_ms(lambda: permute_reduce_partials(
              xc, ys, ii, jj, orders, chunk=DEFAULT_CHUNK), reps=5),
          cuda_ms(lambda: permute_reduce_ref(
              xc, ys, ii, jj, orders, n, DEFAULT_CHUNK), reps=2),
          4 * m * (1 + rows + 2) + 4 * perms * n + 8 * chunks * rows * perms,
          2 * m * perms * rows, FP64_FLOPS)
    # Analytic models, not timings: the Pallas design's traffic, xc gathered
    # once per permutation, at 4-byte and at 32-byte-sector granularity.
    design_bytes = 4 * m * (perms + 3) + 4 * perms * n
    sector_bytes = 4 * m * 3 + 32 * m * perms + 4 * perms * n
    print(f"  permute_reduce traffic models (analytic, not timed): "
          f"{design_bytes / 1e9:.2f} GB = "
          f"{design_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms at 4-byte "
          f"granularity, {sector_bytes / 1e9:.2f} GB = "
          f"{sector_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms in 32-byte sectors")
    entry("permute_reduce_finish", "src/repro_torch/csrc/permute_reduce.cu",
          "src/repro/kernels/permute_reduce.py:90",
          cuda_ms(lambda: permute_reduce_finish(partials), reps=20),
          cuda_ms(lambda: permute_reduce_finish_ref(partials), reps=20),
          8 * chunks * rows * perms + 4 * rows * perms,
          chunks * rows * perms, FP64_FLOPS,
          library_ms=cuda_ms(lambda: torch.sum(partials, dim=0), reps=20))
    for kern in kernels:
        print(f"  {kern['name']}: {kern['ms']:.4f} ms, plain "
              f"{kern['plain_ms']:.4f} ms, bound {kern['bound_ms']:.4f} ms "
              f"({kern['bound_by']}), {kern['launches']} launches")
    print(json.dumps({"kernels": kernels}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:] == ["--solver-first-calls"]:     # phase 4b's fresh process
        torch.zeros(1, device="cuda")
        print(json.dumps(solver_first_calls()))
        return 0
    from repro_torch.core import random_distance_matrix
    from repro_torch.core.mantel import condensed_moments

    t_start = time.perf_counter()
    env = phase_environment()
    card = env["card"]

    dm0 = random_distance_matrix(SEED, N, dim=POINT_DIM)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    noise = torch.triu(0.01 * torch.randn((N, N), generator=gen,
                                          device="cuda").abs_(), 1)
    d2 = dm0.data + noise + noise.T
    del noise
    ynorm = condensed_moments(d2, N)["hat"]
    sync()

    errors = phase_kernels(dm0.data, ynorm)
    main_path = phase_main_path(dm0, d2)
    phase_checks(main_path, card)
    phase_pcoa_split(main_path, card)
    phase_kernel_line(main_path, errors, dm0.data, ynorm, card)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
