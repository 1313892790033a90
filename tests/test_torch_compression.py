"""``repro_torch.optim.compression`` against ``repro.optim.compression``.

``quantize_int8``, ``dequantize_int8`` and ``init_error_state`` equal the
reference's on the same numpy inputs. ``compressed_psum`` runs in a spawned
gloo group of 8 ranks in the reference's ``(2, 2, 2)`` mesh, over "pod"
(each pod's ranks hold that pod's gradient row), two calls with the error
state carried, at 8 and 16 bits; it is held against the exact mean (the
reference's 0.05, ``tests/test_distributed.py`` scenario 7) and against the
reference's own function on the same rows (``jax.vmap`` with the axis
name "pod" bound, which runs its ``psum`` and ``all_gather``): the synced
values to 1e-6 (the same int8 values and scales, two peers' products
added in another order at most) and the error state bitwise; every rank
holds the same bits. The spawn has its own timeout and kills its ranks.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.optim import compression as ref
from repro_torch.optim import compression

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 120


def _rows(seed=11):
    return np.random.default_rng(seed).standard_normal((2, 64)).astype(
        np.float32)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_quantize_matches_reference(scale):
    x = _rows()[0] * scale
    x[3] = 127.5 * (np.abs(x).max() / 127.0)       # a tie at the rounding
    q, s = compression.quantize_int8(torch.from_numpy(x))
    rq, rs = ref.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    np.testing.assert_array_equal(
        compression.dequantize_int8(q, s).numpy(),
        np.asarray(ref.dequantize_int8(rq, rs)))


def test_error_state_is_zero_fp32():
    g = {"a": torch.ones(3, 2, dtype=torch.bfloat16)}
    e = compression.init_error_state(g)
    assert e["a"].dtype == torch.float32 and not e["a"].any()
    with pytest.raises(ValueError, match="8 or 16"):
        compression.compressed_psum(g, e, None, "pod", bits=4)


_WORKER = r'''
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, store, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=8, timeout=datetime.timedelta(seconds=60))
from repro_torch.launch.mesh import axis_index, gather_stack, make_host_mesh
from repro_torch.optim.compression import compressed_psum, init_error_state

mesh = make_host_mesh((2, 2, 2), ("pod", "data", "model"),
                      device_type="cpu")
rows = np.load(f"{tmp}/rows.npy")
g = {"g": torch.from_numpy(rows[axis_index(mesh, "pod")])}
out = {}
for bits in (8, 16):
    err = init_error_state(g)
    for call in range(2):
        synced, err = compressed_psum(g, err, mesh, "pod", bits=bits)
        for name, t in (("synced", synced["g"]), ("err", err["g"])):
            stack = gather_stack(t, mesh, ("pod", "data", "model"))
            same = all(torch.equal(stack[0], x) for x in stack) \
                if name == "synced" else True
            out[f"{bits}_{call}_{name}"] = t.numpy().tolist()
            out[f"{bits}_{call}_{name}_same"] = same
if rank in (0, 4):                 # a rank of each pod
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(out, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compression")
    np.save(tmp / "rows.npy", _rows())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(rank),
                               str(tmp / "store"), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in range(8)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=SPAWN_TIMEOUT_S))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=SPAWN_TIMEOUT_S)
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks exited {codes}\n"
                           + "\n".join(err[-2000:] for _, err in outputs))
    return {rank: json.loads((tmp / f"rank{rank}.json").read_text())
            for rank in (0, 4)}


def _reference(bits):
    """The reference's two calls on the two pods' rows (vmap binds
    "pod")."""
    rows = jnp.asarray(_rows())
    f = jax.vmap(lambda g, e: ref.compressed_psum({"g": g}, {"g": e}, "pod",
                                                  bits=bits),
                 axis_name="pod")
    err = jnp.zeros_like(rows)
    out = []
    for _ in range(2):
        synced, err = f(rows, err)
        out.append((np.asarray(synced["g"]), np.asarray(err["g"])))
        err = err["g"]
    return out


@pytest.mark.parametrize("bits", [8, 16])
def test_compressed_psum_on_a_2x2x2_mesh(spawned, bits):
    want = _reference(bits)
    mean = _rows().mean(axis=0)
    for pod, rank in ((0, 0), (1, 4)):
        got = spawned[rank]
        for call in range(2):
            synced = np.array(got[f"{bits}_{call}_synced"], np.float32)
            err = np.array(got[f"{bits}_{call}_err"], np.float32)
            assert got[f"{bits}_{call}_synced_same"]
            assert np.abs(synced - mean).max() < 0.05
            np.testing.assert_allclose(synced, want[call][0][pod], rtol=0,
                                       atol=1e-6)
            np.testing.assert_array_equal(err, want[call][1][pod])
