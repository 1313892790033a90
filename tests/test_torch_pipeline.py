"""Port parity of the paper's pipeline as
``tests/test_system.py::test_microbiome_pipeline_end_to_end`` drives it:
a streamed distance matrix → validation → PCoA (4 dimensions) → Mantel
against a perturbed matrix (K = 49), through the reference and the port
on the same inputs. The reference's sketch and orders are passed in. The
p-values must be equal, the statistics agree to 1e-5 and the eigenvalues
to rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.core import DistanceMatrix as JaxDM
from repro.core import mantel as jax_mantel
from repro.core import pcoa as jax_pcoa
from repro.data.distance import DistanceTileStream
from repro.stats.engine import permutation_orders as jax_orders
from repro_torch.convert import from_reference
from repro_torch.core import DistanceMatrix, mantel, pcoa
from repro_torch.core.pcoa import sketch_width


def test_microbiome_pipeline_matches_reference():
    n, dims, permutations = 96, 4, 49
    d = np.array(DistanceTileStream(n=n, tile=32, seed=0, dim=4).dense())
    noise = 0.01 * np.abs(np.random.default_rng(0).normal(size=(n, n)))
    noise = np.triu(noise, 1)
    d2 = d + noise + noise.T

    jdm, jdm2 = JaxDM(jnp.asarray(d)), JaxDM(jnp.asarray(d2))
    want_pcoa = jax_pcoa(jdm, dimensions=dims, method="fsvd")
    want_stat, want_p, _ = jax_mantel(jdm, jdm2, permutations=permutations)

    state = from_reference({
        "data": d,
        "omega": np.array(jax.random.normal(
            jax.random.PRNGKey(42), (n, sketch_width(dims, n)))),
        "orders": np.array(jax_orders(jax.random.PRNGKey(0), permutations,
                                      n))}, device="cpu")
    dm = DistanceMatrix(state["data"], device="cpu")     # validates
    dm2 = DistanceMatrix(d2, device="cpu")
    res = pcoa(dm, dimensions=dims, method="fsvd", omega=state["omega"],
               device="cpu")
    assert res.coordinates.shape == (n, dims)
    assert bool((res.eigenvalues > 0).all())
    np.testing.assert_allclose(res.eigenvalues.numpy(),
                               np.asarray(want_pcoa.eigenvalues), rtol=1e-4)

    stat, p, size = mantel(dm, dm2, permutations=permutations,
                           orders=state["orders"], device="cpu")
    assert size == n
    assert stat > 0.99 and p <= 0.04
    assert p == want_p
    assert abs(stat - float(want_stat)) <= 1e-5


def test_pipeline_runs_on_its_own_draws():
    """Without the reference's sketch and orders the port draws its own
    (seeded, not key-compatible with JAX) and reaches the same verdict."""
    d = np.array(DistanceTileStream(n=64, tile=32, seed=1, dim=4).dense())
    dm = DistanceMatrix(d, device="cpu")
    a = pcoa(dm, dimensions=3, device="cpu")
    b = pcoa(dm, dimensions=3, device="cpu")
    assert torch.equal(a.eigenvalues, b.eigenvalues) and a.key == 42
    stat, p, _ = mantel(dm, dm, permutations=19, device="cpu")
    assert abs(stat - 1.0) <= 1e-5 and p == np.float32(1 / 20)
