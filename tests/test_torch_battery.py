"""Port parity: the whole statistics battery on one study, end to end.

One simulated community study (numpy-seeded: 4 treatment groups, two
measurements of the same samples and a confounding gradient, n = 96) goes
through the reference's ``repro.stats`` and ``repro.core`` functions,
called as the legacy example in ``examples/community_analysis.py`` calls
them (``test(dm, grouping, permutations, key)``), and through the port's on
the CPU with the reference's orders and sketch. Every statistic agrees to
the reference's tolerance (relative above 1) and every p-value is equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.core import DistanceMatrix as JaxDM
from repro.core import mantel as jax_mantel
from repro.stats import anosim as jax_anosim
from repro.stats import engine as jax_engine
from repro.stats import partial_mantel as jax_partial_mantel
from repro.stats import permanova as jax_permanova
from repro.stats import permdisp as jax_permdisp
from repro_torch.core import DistanceMatrix, mantel
from repro_torch.core.pcoa import resolve_dimensions, sketch_width
from repro_torch.kernels.mantel_corr_ops import mantel_corr_op
from repro_torch.stats import (anosim, partial_mantel, permanova, permdisp,
                               permutation_orders)

N, GROUPS, PERMUTATIONS = 96, 4, 49
KEY = jax.random.PRNGKey(11)


def _square(table):
    d = np.sqrt(((table[:, None] - table[None]) ** 2).sum(-1))
    d = d.astype(np.float32)
    d = 0.5 * (d + d.T)
    np.fill_diagonal(d, 0.0)
    return d


def _study(seed=2021, dim=8):
    """Measurement A, its re-measurement B and the gradient C, as in the
    example's ``simulate_study``."""
    rng = np.random.default_rng(seed)
    grouping = np.arange(N) % GROUPS
    centroids = 2.0 * rng.normal(size=(GROUPS, dim))
    gradient = rng.normal(size=(N, 1))
    a = centroids[grouping] + 1.5 * gradient + rng.normal(size=(N, dim))
    b = a + 0.5 * rng.normal(size=(N, dim))
    return grouping, [_square(t) for t in (a, b, gradient)]


def test_battery_matches_the_reference_end_to_end():
    grouping, mats = _study()
    ja, jb, jc = (JaxDM(jnp.asarray(m)) for m in mats)
    a, b, c = (DistanceMatrix(m, device="cpu") for m in mats)
    orders = torch.from_numpy(np.array(jax_engine.permutation_orders(
        KEY, PERMUTATIONS, N)))
    omega = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(42),
        (N, sketch_width(resolve_dimensions(None, N), N)))))
    common = {"orders": orders, "device": "cpu"}

    pairs = {
        "permanova": (jax_permanova(ja, grouping, PERMUTATIONS, KEY),
                      permanova(a, grouping, PERMUTATIONS, **common)),
        "permdisp": (jax_permdisp(ja, grouping, PERMUTATIONS, KEY),
                     permdisp(a, grouping, PERMUTATIONS, omega=omega,
                              **common)),
        "anosim": (jax_anosim(ja, grouping, PERMUTATIONS, KEY),
                   anosim(a, grouping, PERMUTATIONS, **common)),
        "partial_mantel": (jax_partial_mantel(ja, jb, jc, PERMUTATIONS, KEY),
                           partial_mantel(a, b, c, PERMUTATIONS, **common)),
    }
    for name, (want, got) in pairs.items():
        # the reference's tolerances (1e-5; PERMDISP 1e-4), relative once the
        # statistic passes 1: this study's F is about 30, where 1e-5 is
        # under 3 fp32 ulps
        tol = (1e-4 if name == "permdisp" else 1e-5) * max(
            abs(want.statistic), 1.0)
        assert abs(got.statistic - want.statistic) < tol, name
        assert abs(got.p_value - want.p_value) < 1e-9, name
        assert got.sample_size == N, name

    s_want, p_want, _ = jax_mantel(ja, jb, PERMUTATIONS, KEY)
    s_got, p_got, _ = mantel(a, b, PERMUTATIONS, **common)
    assert abs(s_got - s_want) < 1e-5 and p_got == p_want
    # the materialized baseline on the same orders: the same null draws
    draws = mantel_corr_op(a.data, b.data, orders, perm_batch=7)
    count = int(torch.sum(draws.abs() >= abs(s_got)))
    assert np.float32(count + 1) / np.float32(PERMUTATIONS + 1) == p_got
    # the study's structure shows: groups differ, A and B agree beyond C
    assert pairs["permanova"][1].p_value == np.float32(1) / np.float32(50)
    assert pairs["partial_mantel"][1].statistic > 0.5


def test_battery_default_orders_are_the_port_engine_draw():
    """Without ``orders`` every test draws the engine's seeded orders: the
    same key gives the same p-value across tests of one matrix."""
    grouping, mats = _study(seed=5)
    a = DistanceMatrix(mats[0], device="cpu")
    orders = permutation_orders(3, PERMUTATIONS, N)
    for test in (permanova, anosim):
        seeded = test(a, grouping, PERMUTATIONS, key=3, device="cpu")
        given = test(a, grouping, PERMUTATIONS, orders=orders, device="cpu")
        assert seeded.p_value == given.p_value
        assert seeded.statistic == given.statistic
        assert seeded.key == 3 and given.key is None
