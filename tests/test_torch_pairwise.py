"""Port parity: the pairwise-panel kernel's plain versions.

The same numpy tables go through the reference's Pallas kernel
(``pairwise_panel_pallas``, in interpret mode on the CPU) and its naive
oracle ``pairwise_ref``, and through the port's wrapper on a CPU tensor
(the plain chunked panel) and its oracle. Tolerance rtol 1e-5 / atol 1e-6,
the reference's own (``tests/test_dist.py::test_pairwise_kernel_matches_ref``):
the features are summed in chunks, in another order.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import get_metric as jax_get_metric
from repro.kernels.pairwise_ops import pairwise_panel_pallas
from repro.kernels.pairwise_ref import pairwise_ref as jax_pairwise_ref
from repro_torch.dist import METRICS, get_metric
from repro_torch.kernels.pairwise_ops import pairwise_panel_op
from repro_torch.kernels.pairwise_ref import pairwise_ref

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _table(seed, n, d):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(size=(n, d)))
    x[rng.random(size=x.shape) < 0.2] = 0.0
    return x.astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("metric", sorted(METRICS))
@pytest.mark.parametrize("n,d,block,fb", [(30, 11, 8, 4), (17, 7, 16, 16),
                                          (32, 12, 8, 5)])
def test_plain_panel_matches_pallas_kernel(metric, n, d, block, fb):
    x = _table(3, n, d)
    want = pairwise_panel_pallas(jnp.asarray(x[:10]), jnp.asarray(x),
                                 metric=jax_get_metric(metric),
                                 block_n=block, feature_block=fb)
    got = pairwise_panel_op(torch.from_numpy(x[:10]), torch.from_numpy(x),
                            metric)
    _close(got, want)
    _close(got, jax_pairwise_ref(jnp.asarray(x[:10]), jnp.asarray(x),
                                 metric))


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_oracle_matches_reference_oracle(metric):
    x = _table(4, 19, 13)
    y = _table(5, 11, 13)
    _close(pairwise_ref(torch.from_numpy(x), torch.from_numpy(y), metric),
           jax_pairwise_ref(jnp.asarray(x), jnp.asarray(y), metric))


def test_panel_edges():
    """A panel of no rows, and a table of no features (every distance 0)."""
    x = torch.from_numpy(_table(6, 9, 4))
    assert pairwise_panel_op(x[:0], x).shape == (0, 9)
    empty = torch.zeros((5, 0))
    for metric in sorted(METRICS):
        assert torch.equal(pairwise_panel_op(empty[:2], empty, metric),
                           torch.zeros(2, 5))


def test_kinds_agree_with_the_kernel_enum():
    """``Metric.kind`` selects the kernel's template: the two numberings
    must be the same."""
    text = (CSRC / "pairwise.cu").read_text()
    enum = dict(re.findall(r"k(\w+) = (\d)", text.split("enum Kind {")[1]
                           .split("};")[0]))
    names = {"Euclidean": "euclidean", "Cityblock": "cityblock",
             "Canberra": "canberra", "BrayCurtis": "braycurtis",
             "Jaccard": "jaccard"}
    assert {names[k]: int(v) for k, v in enum.items()} == \
        {name: m.kind for name, m in METRICS.items()}


def test_wrapper_checks_operands():
    x = torch.from_numpy(_table(7, 6, 3))
    with pytest.raises(ValueError, match="tables"):
        pairwise_panel_op(x[:2, :2], x)
    with pytest.raises(TypeError, match="float32"):
        pairwise_panel_op(x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        pairwise_panel_op(x[:, ::2].T.contiguous().T, x[:, :2])
    with pytest.raises(ValueError, match="unknown metric"):
        pairwise_panel_op(x, x, "chebyshev")
    assert get_metric("braycurtis").kind == 3
