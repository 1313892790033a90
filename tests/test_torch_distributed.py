"""Port parity of the distributed analysis paths: ``repro_torch`` on a
``torch.distributed`` device mesh against ``repro`` on a ``jax.sharding``
mesh, and against the port's own single-process functions.

* In this process, a one-rank gloo group: the reference's
  ``center_distance_matrix_distributed``, ``centered_gram_matvec_distributed``,
  ``pcoa(centering_impl="distributed")``, ``mantel_distributed`` and
  ``permutation_test_distributed`` on a one-device ``Mesh`` (as
  ``tests/test_operators.py`` runs them) against the port on the same
  numpy inputs. The reference's orders and sketch are passed in
  (``orders=``, ``omega=``): the port's seeds draw other numbers.
  Tolerances: centering 2e-4 (the reference's fp32 gate), the matvec
  rtol/atol 1e-4 (``tests/test_operators.py``), eigenvalues rtol 1e-4, the
  Mantel null rtol 1e-5, statistics 1e-5, p-values equal.
* Spawned gloo groups of 8 ranks, in the reference's ``(4, 2)`` and
  ``(2, 2, 2)`` meshes (``tests/test_distributed.py``): one spawn a mesh
  runs every scenario and rank 0 prints a verdict line for each. Held
  against the port's single-process functions: centering 2e-4, the
  matvec 1e-4, eigenvalues rtol 1e-4; the engine's null for Mantel and
  ANOSIM bitwise the single-process engine's on the same orders (every
  tile is padded to B either way), PERMANOVA 1e-5 with equal p-values (on
  the CPU its batched product is a library call whose bits may follow the
  column's place in the product); ``mantel_distributed`` rtol 1e-5 with
  equal p-values; every rank holding the same bits; K or n that does not
  divide, and a generator key, refused. Each spawn has its own timeout and
  kills its ranks, so a hung collective fails in seconds.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_distributed.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.core import DistanceMatrix as JaxDistanceMatrix
from repro.core.centering import \
    center_distance_matrix_distributed as jax_center_distributed
from repro.core.mantel import MantelStatistic as JaxMantelStatistic
from repro.core.mantel import hat_square as jax_hat_square
from repro.core.mantel import mantel_distributed as jax_mantel_distributed
from repro.core.operators import \
    centered_gram_matvec_distributed as jax_matvec_distributed
from repro.core.pcoa import pcoa as jax_pcoa
from repro.stats.anosim import AnosimStatistic as JaxAnosimStatistic
from repro.stats.engine import encode_grouping as jax_encode_grouping
from repro.stats.engine import permutation_orders as jax_orders
from repro.stats.engine import \
    permutation_test_distributed as jax_permutation_test_distributed
from repro.stats.permanova import PermanovaStatistic as JaxPermanovaStatistic
from repro_torch.core import (CenteredGramOperator, DistanceMatrix,
                              center_distance_matrix,
                              center_distance_matrix_distributed,
                              centered_gram_matvec_distributed, hat_square,
                              mantel_distributed, materialized_gram, pcoa)
from repro_torch.core.mantel import MantelStatistic, mantel_null_distributed
from repro_torch.core.pcoa import sketch_width
from repro_torch.launch import make_host_mesh, make_production_mesh, mesh_chips
from repro_torch.launch.mesh import (all_gather_tiled, axis_index, full_tensor,
                                     psum)
from repro_torch.stats import rank_orders
from repro_torch.stats.anosim import AnosimStatistic, rank_transform_condensed
from repro_torch.stats.engine import (encode_grouping, hoist_and_observe,
                                      permutation_test_distributed, rank_seed)
from repro_torch.stats.permanova import PermanovaStatistic

ROOT = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(5)
CPU = torch.device("cpu")


def _dm(seed, n):
    """A valid distance matrix from numpy: Euclidean distances of n points
    in 4 dimensions, exactly symmetric and hollow in fp32."""
    pts = np.random.default_rng(seed).normal(size=(n, 4))
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    d = 0.5 * (d + d.T)
    np.fill_diagonal(d, 0.0)
    return d.astype(np.float32)


def _grouping(n, k=4):
    return np.array([i % k for i in range(n)])


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo group in this process, as a (1, 1) mesh."""
    return make_host_mesh((1, 1), device_type="cpu")


@pytest.fixture(scope="module")
def jax_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


# --------------------------------------------------------------------------
# one rank against the reference on a one-device mesh
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n", [64, 77])
def test_centering_matches_reference(mesh, jax_mesh, n):
    d = _dm(n, n)
    want = np.asarray(jax_center_distributed(d, jax_mesh))
    got = center_distance_matrix_distributed(torch.from_numpy(d), mesh)
    np.testing.assert_allclose(full_tensor(got).numpy(), want, rtol=2e-4,
                               atol=2e-4)
    # one rank computes exactly what the square path computes
    assert torch.equal(full_tensor(got),
                       center_distance_matrix(torch.from_numpy(d)))
    assert torch.equal(got.full_tensor(), full_tensor(got))


@pytest.mark.parametrize("n,k", [(32, 3), (64, 20)])
def test_matvec_matches_reference(mesh, jax_mesh, n, k):
    d = _dm(n + k, n)
    x = np.random.default_rng(k).normal(size=(n, k)).astype(np.float32)
    want = np.asarray(jax_matvec_distributed(d, x, jax_mesh))
    got = centered_gram_matvec_distributed(torch.from_numpy(d),
                                           torch.from_numpy(x), mesh)
    assert got.placements[0].is_shard(0)
    np.testing.assert_allclose(full_tensor(got).numpy(), want, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("method,materialize", [("eigh", False),
                                                ("fsvd", False),
                                                ("fsvd", True)])
def test_pcoa_distributed_matches_reference(mesh, jax_mesh, method,
                                            materialize):
    n, k = 64, 4
    d = _dm(3, n)
    want = jax_pcoa(JaxDistanceMatrix(d), dimensions=k, method=method,
                    centering_impl="distributed", mesh=jax_mesh,
                    materialize=materialize)
    omega = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(42), (n, sketch_width(k, n)))))
    got = pcoa(DistanceMatrix(torch.from_numpy(d), device="cpu"),
               dimensions=k, method=method, centering_impl="distributed",
               mesh=mesh, materialize=materialize, omega=omega, device="cpu")
    np.testing.assert_allclose(got.eigenvalues.numpy(),
                               np.asarray(want.eigenvalues), rtol=1e-4)
    np.testing.assert_allclose(got.proportion_explained.numpy(),
                               np.asarray(want.proportion_explained),
                               rtol=1e-4, atol=1e-6)


def test_pcoa_refuses_distributed_without_the_square(mesh):
    dm = DistanceMatrix(torch.from_numpy(_dm(4, 32)), device="cpu")
    op = CenteredGramOperator.from_distance(dm.data)
    with pytest.raises(ValueError, match="distributed"):
        pcoa(None, dimensions=3, operator=op, centering_impl="distributed",
             mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        pcoa(dm, dimensions=3, centering_impl="distributed", device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        materialized_gram(dm.data, "distributed")


def test_hat_square_matches_reference():
    n = 24
    hat = np.random.default_rng(1).normal(size=n * (n - 1) // 2).astype(
        np.float32)
    np.testing.assert_array_equal(
        hat_square({"hat": torch.from_numpy(hat)}, n).numpy(),
        np.asarray(jax_hat_square({"hat": hat}, n)))


@pytest.mark.parametrize("alternative", ["two-sided", "greater", "less"])
def test_mantel_distributed_matches_reference(mesh, jax_mesh, alternative):
    n, k = 32, 64
    x, y = _dm(1, n), _dm(2, n)
    s_ref, p_ref, _ = jax_mantel_distributed(
        JaxDistanceMatrix(x), JaxDistanceMatrix(y), jax_mesh,
        permutations=k, key=KEY, alternative=alternative)
    ref_orders = np.array(jax_orders(jax.random.fold_in(KEY, 0), k, n))
    tx = DistanceMatrix(torch.from_numpy(x), device="cpu")
    ty = DistanceMatrix(torch.from_numpy(y), device="cpu")
    orders = torch.from_numpy(ref_orders)
    s, p, size = mantel_distributed(tx, ty, mesh, permutations=k,
                                    alternative=alternative, orders=orders)
    assert abs(s - float(s_ref)) < 1e-5
    assert p == float(p_ref) and size == n
    # the null against the reference statistic's draws on those orders
    stat = JaxMantelStatistic(x, y, n)
    inv = stat.hoist()
    want = np.array([stat.per_perm(inv, o) for o in ref_orders])
    _, null = mantel_null_distributed(tx, ty, mesh, k, orders=orders)
    np.testing.assert_allclose(null.numpy(), want, rtol=1e-5, atol=1e-7)


def _statistics(method, n):
    """The reference's and the port's statistic of one test on the same
    numpy inputs."""
    d, g = _dm(19, n), _grouping(n)
    if method == "mantel":
        y = _dm(20, n)
        return (JaxMantelStatistic(d, y, n),
                MantelStatistic(torch.from_numpy(d), torch.from_numpy(y), n),
                "two-sided")
    codes, k = encode_grouping(g)
    jcodes, _ = jax_encode_grouping(g)
    if method == "permanova":
        return (JaxPermanovaStatistic(d, jcodes, n, k),
                PermanovaStatistic(torch.from_numpy(d),
                                   torch.from_numpy(codes), n, k), "greater")
    from repro.stats.anosim import rank_transform_condensed as jax_ranks
    iu = np.triu_indices(n, k=1)
    return (JaxAnosimStatistic(None, jcodes, n, k,
                               pre=jax_ranks(d[iu])),
            AnosimStatistic(None, torch.from_numpy(codes), n, k,
                            pre=rank_transform_condensed(
                                torch.from_numpy(d[iu]))),
            "greater")


@pytest.mark.parametrize("method", ["mantel", "anosim", "permanova"])
def test_engine_distributed_matches_reference(mesh, jax_mesh, method):
    n, k = 32, 64
    jstat, stat, alternative = _statistics(method, n)
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1), ("data",))
    want = jax_permutation_test_distributed(jstat, jmesh, permutations=k,
                                            key=KEY, alternative=alternative)
    orders = torch.from_numpy(np.array(
        jax_orders(jax.random.fold_in(KEY, 0), k, n)))
    got = permutation_test_distributed(stat, mesh, permutations=k,
                                       alternative=alternative,
                                       orders=orders, method=method)
    assert abs(got.statistic - want.statistic) < 1e-5
    assert got.p_value == want.p_value
    assert got.permutations == k and got.sample_size == n
    assert got.key is None


def test_engine_draws_by_the_rank_seed(mesh):
    """Rank ``dev`` draws ``permutation_orders(rank_seed(key, dev))``; a
    result carries its int key; a generator key is refused by name."""
    _, stat, _ = _statistics("mantel", 32)
    by_key = permutation_test_distributed(stat, mesh, permutations=40,
                                          key=9)
    given = permutation_test_distributed(
        stat, mesh, permutations=40,
        orders=rank_orders(9, mesh, ("data",), 40, 32))
    assert (by_key.statistic, by_key.p_value) == (given.statistic,
                                                  given.p_value)
    assert by_key.key == 9
    assert rank_seed(9, 0) != rank_seed(9, 1) != rank_seed(10, 0)
    with pytest.raises(TypeError, match="Generator"):
        permutation_test_distributed(stat, mesh, permutations=8,
                                     key=torch.Generator())
    dm = DistanceMatrix(torch.from_numpy(_dm(1, 32)), device="cpu")
    with pytest.raises(TypeError, match="Generator"):
        mantel_distributed(dm, dm, mesh, permutations=8,
                           key=torch.Generator())
    with pytest.raises(ValueError, match="alternative"):
        permutation_test_distributed(stat, mesh, permutations=8,
                                     alternative="bogus")


def test_tensor_off_the_mesh_device_is_refused(mesh):
    d = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="meta tensor on a cpu mesh"):
        center_distance_matrix_distributed(d, mesh)


def test_mesh_construction_and_collectives(mesh):
    assert mesh.mesh_dim_names == ("data", "model")
    assert mesh_chips(mesh) == 1
    assert axis_index(mesh, "data") == axis_index(mesh, ("data", "model"))
    t = torch.arange(6.0)
    assert torch.equal(psum(t, mesh, ("data", "model")), t)
    assert torch.equal(all_gather_tiled(t, mesh, "model"), t)
    # a second call reuses the group this process already has
    assert make_host_mesh((1,), ("data",), device_type="cpu").size() == 1
    with pytest.raises(ValueError, match="needs 4 ranks.*has 1"):
        make_host_mesh((2, 2), device_type="cpu")
    with pytest.raises(ValueError, match="needs 256 ranks.*has 1"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        make_host_mesh((1, 1), ("data",), device_type="cpu")


# --------------------------------------------------------------------------
# 8 ranks in the reference's meshes against the single-process functions
# --------------------------------------------------------------------------
_WORKER = r'''
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, spec = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            sys.argv[4])
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))

from repro_torch.core import (CenteredGramOperator, DistanceMatrix,
                              center_distance_matrix,
                              center_distance_matrix_distributed,
                              centered_gram_matvec_distributed, mantel,
                              mantel_distributed, pcoa)
from repro_torch.core.mantel import MantelStatistic, mantel_null_distributed
from repro_torch.core.pcoa import sketch_width
from repro_torch.launch import make_host_mesh
from repro_torch.launch.mesh import full_tensor, gather_stack, placements
from repro_torch.stats import rank_orders
from repro_torch.stats.anosim import AnosimStatistic, rank_transform_condensed
from repro_torch.stats.engine import (encode_grouping, hoist_and_observe,
                                      null_distribution,
                                      null_distribution_distributed,
                                      permutation_test,
                                      permutation_test_distributed)
from repro_torch.stats.permanova import PermanovaStatistic
from torch.distributed.tensor import DTensor

if spec == "4x2":
    mesh = make_host_mesh((4, 2), ("data", "model"), device_type="cpu")
    perm_axes = ("data",)
else:
    mesh = make_host_mesh((2, 2, 2), ("pod", "data", "model"),
                          device_type="cpu")
    perm_axes = ("pod", "data")


def verdict(name, ok, detail=""):
    if rank == 0:
        print(json.dumps({"name": name, "ok": bool(ok),
                          "detail": str(detail)}), flush=True)


def same_on_every_rank(t):
    stack = gather_stack(t.reshape(-1), mesh, mesh.mesh_dim_names)
    return all(torch.equal(stack[0], s) for s in stack)


def dm(seed, n):
    pts = np.random.default_rng(seed).normal(size=(n, 4))
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    d = 0.5 * (d + d.T)
    np.fill_diagonal(d, 0.0)
    return torch.from_numpy(d.astype(np.float32))


def close(got, want, rtol, atol):
    err = (got.double() - want.double()).abs()
    return bool((err <= atol + rtol * want.double().abs()).all()), \
        float(err.max())


def scenario(name, fn):
    try:
        ok, detail = fn()
    except Exception as e:                      # a verdict, not a hang
        ok, detail = False, repr(e)
    verdict(name, ok, detail)


n = 64
d = dm(0, n)


def centering():
    want = center_distance_matrix(d)
    got = center_distance_matrix_distributed(d, mesh)
    ok, err = close(full_tensor(got), want, 2e-4, 2e-4)
    # a DTensor input, each rank's block sliced locally, is centred alike
    r, c = got.to_local().shape
    i0 = r * mesh.get_local_rank("data")
    j0 = c * mesh.get_local_rank("model")
    blocks = DTensor.from_local(d[i0:i0 + r, j0:j0 + c].contiguous(), mesh,
                                got.placements, run_check=False,
                                shape=(n, n), stride=(n, 1))
    again = center_distance_matrix_distributed(blocks, mesh)
    ok &= torch.equal(again.to_local(), got.to_local())
    ok &= same_on_every_rank(full_tensor(got))
    return ok, err


def matvec():
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(n, 20)).astype(np.float32))
    want = CenteredGramOperator.from_distance(d).matvec(x)
    got = full_tensor(centered_gram_matvec_distributed(d, x, mesh))
    ok, err = close(got, want, 1e-4, 1e-4)
    return ok and same_on_every_rank(got), err


def pcoa_both():
    dmat = DistanceMatrix(d, device="cpu")
    omega = torch.from_numpy(np.random.default_rng(2).normal(
        size=(n, sketch_width(4, n))).astype(np.float32))
    errs, ok = [], True
    for method in ("eigh", "fsvd"):
        want = pcoa(dmat, 4, method=method, omega=omega, device="cpu")
        got = pcoa(dmat, 4, method=method, omega=omega, device="cpu",
                   centering_impl="distributed", mesh=mesh)
        good, err = close(got.eigenvalues, want.eigenvalues, 1e-4, 0.0)
        ok &= good and same_on_every_rank(got.eigenvalues)
        errs.append(err)
    return ok, errs


nm, k = 32, 64
x, y = dm(1, nm), dm(2, nm)
orders = rank_orders(5, mesh, perm_axes, k, nm)


def mantel_vs_single():
    tx, ty = DistanceMatrix(x, device="cpu"), DistanceMatrix(y, device="cpu")
    s, p, _ = mantel_distributed(tx, ty, mesh, permutations=k,
                                 perm_axes=perm_axes, key=5)
    s1, p1, _ = mantel(tx, ty, permutations=k, orders=orders, device="cpu")
    _, null = mantel_null_distributed(tx, ty, mesh, k, perm_axes=perm_axes,
                                      orders=orders)
    stat = MantelStatistic(x, y, nm)
    inv, _ = hoist_and_observe(stat, torch.device("cpu"))
    ok, err = close(null, null_distribution(stat, inv, orders, 32), 1e-5,
                    1e-7)
    return (ok and p == p1 and abs(s - s1) < 1e-5
            and same_on_every_rank(null)), (s, s1, p, p1, err)


g = np.array([i % 4 for i in range(nm)])
codes, groups = encode_grouping(g)
iu = np.triu_indices(nm, k=1)
STATS = {
    "mantel": (MantelStatistic(x, y, nm), "two-sided"),
    "anosim": (AnosimStatistic(None, torch.from_numpy(codes), nm, groups,
                               pre=rank_transform_condensed(
                                   x[iu[0], iu[1]])), "greater"),
    "permanova": (PermanovaStatistic(x, torch.from_numpy(codes), nm,
                                     groups), "greater"),
}


def engine(method, batch):
    stat, alternative = STATS[method]
    inv, _ = hoist_and_observe(stat, torch.device("cpu"))
    got = null_distribution_distributed(stat, inv, mesh, k, perm_axes=perm_axes,
                                        batch_size=batch, orders=orders)
    want = null_distribution(stat, inv, orders, batch)
    a = permutation_test_distributed(stat, mesh, k, key=5,
                                     alternative=alternative,
                                     perm_axes=perm_axes, batch_size=batch)
    b = permutation_test(stat, k, orders=orders, alternative=alternative,
                         batch_size=batch, device="cpu")
    same = (a.statistic, a.p_value) == (b.statistic, b.p_value)
    if method == "permanova":
        ok, err = close(got, want, 1e-5, 1e-5)
        ok &= a.p_value == b.p_value and abs(a.statistic - b.statistic) < 1e-5
    else:
        ok, err = torch.equal(got, want) and same, float(
            (got - want).abs().max())
    return ok and same_on_every_rank(got), err


def refusals():
    raised = []
    for fn in (lambda: mantel_distributed(
                   DistanceMatrix(x, device="cpu"),
                   DistanceMatrix(y, device="cpu"), mesh, permutations=30,
                   perm_axes=perm_axes),
               lambda: permutation_test_distributed(
                   STATS["mantel"][0], mesh, 30, perm_axes=perm_axes),
               lambda: center_distance_matrix_distributed(dm(3, 33), mesh),
               lambda: centered_gram_matvec_distributed(
                   dm(3, 33), torch.zeros((33, 2)), mesh)):
        try:
            fn()
            raised.append(None)
        except ValueError as e:
            raised.append(str(e))
    try:
        permutation_test_distributed(STATS["mantel"][0], mesh, 32,
                                     key=torch.Generator(),
                                     perm_axes=perm_axes)
        raised.append(None)
    except TypeError as e:
        raised.append(str(e))
    return all(raised) and "divide" in raised[0], raised


scenario("centering", centering)
scenario("matvec", matvec)
scenario("pcoa", pcoa_both)
scenario("mantel_distributed", mantel_vs_single)
for method in STATS:
    for batch in (8, 32):
        scenario(f"engine_{method}_b{batch}", lambda: engine(method, batch))
scenario("refusals", refusals)
dist.destroy_process_group()
'''

MESHES = {"4x2": 8, "2x2x2": 8}
SCENARIOS = (["centering", "matvec", "pcoa", "mantel_distributed"]
             + [f"engine_{m}_b{b}" for m in ("mantel", "anosim", "permanova")
                for b in (8, 32)] + ["refusals"])
SPAWN_TIMEOUT_S = 240


def _spawn(spec: str, world: int, tmp: Path) -> dict:
    """Run the worker on ``world`` gloo ranks (file-store rendezvous in
    ``tmp``); kill every rank past the timeout. Returns rank 0's verdicts."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    store = tmp / f"store_{spec}"
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(rank),
                               str(world), str(store), spec], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in range(world)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=SPAWN_TIMEOUT_S))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=SPAWN_TIMEOUT_S)
    verdicts = {}
    for line in outputs[0][0].splitlines():
        try:
            v = json.loads(line)
            verdicts[v["name"]] = v
        except (json.JSONDecodeError, KeyError):
            continue
    codes = [p.returncode for p in procs]
    if any(codes) or not verdicts:
        raise RuntimeError(f"{spec}: ranks exited {codes}\n"
                           + "\n".join(err[-2000:] for _, err in outputs))
    return verdicts


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    return {spec: _spawn(spec, world, tmp)
            for spec, world in MESHES.items()}


@pytest.mark.parametrize("spec", sorted(MESHES))
@pytest.mark.parametrize("name", SCENARIOS)
def test_eight_ranks_match_the_single_process_functions(spawned, spec, name):
    verdicts = spawned[spec]
    assert name in verdicts, f"{spec}: scenario {name} did not report"
    assert verdicts[name]["ok"], f"{spec} {name}: {verdicts[name]['detail']}"
