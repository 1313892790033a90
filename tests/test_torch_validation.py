"""Port parity: validation and ``DistanceMatrix`` admission.

The same numpy inputs go through the reference (JAX on the CPU, the Pallas
``symhollow`` kernel in interpret mode) and the port on the CPU (the
kernel's plain version). Results are booleans, so they must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.core import validation as jax_validation
from repro.core.distance_matrix import DistanceMatrix as JaxDistanceMatrix
from repro.core.distance_matrix import DistanceMatrixError as JaxDMError
from repro.kernels.symhollow_ops import is_symmetric_and_hollow_pallas
from repro_torch.core import validation
from repro_torch.core.distance_matrix import (DistanceMatrix,
                                              DistanceMatrixError)

CASES = ["valid", "asym", "nonhollow", "nan_off", "nan_diag", "negzero_diag",
         "both"]


def _case(n, case, seed=0):
    rng = np.random.default_rng(seed + n)
    pts = rng.normal(size=(n, 5))
    d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))
    d = d.astype(np.float32)
    d = 0.5 * (d + d.T)
    np.fill_diagonal(d, 0.0)
    i, j = n // 3, n - 2
    if case == "asym":
        d[i, j] += 1.0
    elif case == "nonhollow":
        d[j, j] = 0.25
    elif case == "nan_off":
        d[i, j] = d[j, i] = np.nan
    elif case == "nan_diag":
        d[j, j] = np.nan
    elif case == "negzero_diag":
        d[j, j] = -0.0
    elif case == "both":
        d[i, j] += 1.0
        d[i, i] = 3.0
    return d


@pytest.mark.parametrize("n", [33, 70])
@pytest.mark.parametrize("case", CASES)
def test_fused_check_matches_reference(n, case):
    d = _case(n, case)
    want_pallas = is_symmetric_and_hollow_pallas(jnp.asarray(d), block=32,
                                                 interpret=True)
    want_fused = jax_validation.is_symmetric_and_hollow(jnp.asarray(d))
    got = validation.is_symmetric_and_hollow(torch.from_numpy(d))
    assert got == tuple(bool(v) for v in want_pallas)
    assert got == tuple(bool(v) for v in want_fused)


@pytest.mark.parametrize("case", ["valid", "asym", "nonhollow", "both"])
def test_eager_and_blocked_checks_match_reference(case):
    d = _case(64, case)
    t = torch.from_numpy(d)
    assert validation.is_symmetric_and_hollow_ref(t) == \
        jax_validation.is_symmetric_and_hollow_ref(jnp.asarray(d))
    want = tuple(bool(v) for v in
                 jax_validation.is_symmetric_and_hollow_blocked(
                     jnp.asarray(d), block=16))
    assert validation.is_symmetric_and_hollow_blocked(t, block=16) == want
    # a ragged n falls back to the fused pass, as in the reference
    assert validation.is_symmetric_and_hollow_blocked(t, block=24) == \
        validation.is_symmetric_and_hollow(t)


@pytest.mark.parametrize("case,message", [
    ("asym", "not symmetric"), ("nonhollow", "not hollow"),
    ("nan_off", "not symmetric"), ("both", "not symmetric")])
def test_distance_matrix_rejects_like_reference(case, message):
    d = _case(40, case)
    with pytest.raises(JaxDMError, match=message):
        JaxDistanceMatrix(jnp.asarray(d))
    with pytest.raises(DistanceMatrixError, match=message):
        DistanceMatrix(d, device="cpu")


def test_distance_matrix_shape_and_ids_errors():
    with pytest.raises(DistanceMatrixError, match="square"):
        DistanceMatrix(np.zeros((3, 4), np.float32), device="cpu")
    with pytest.raises(DistanceMatrixError, match="ids"):
        DistanceMatrix(np.zeros((3, 3), np.float32), ids=("a", "b"),
                       device="cpu")
    dm = DistanceMatrix(_case(5, "valid"), ids="abcde", device="cpu")
    assert dm.ids == tuple("abcde") and len(dm) == 5 and dm.shape == (5, 5)
    assert dm.data.dtype == torch.float32


def test_validation_is_cached(monkeypatch):
    calls = []
    real = validation.is_symmetric_and_hollow

    def counting(mat):
        calls.append(mat.shape)
        return real(mat)

    monkeypatch.setattr(validation, "is_symmetric_and_hollow", counting)
    dm = DistanceMatrix(_case(30, "valid"), device="cpu")
    assert len(calls) == 1
    dm.copy()
    dm.permute(np.arange(30)[::-1])
    DistanceMatrix(_case(30, "asym"), validate=False, device="cpu")
    assert len(calls) == 1                 # none of these re-validates
    assert dm.copy()._validated


def test_ensure_finite():
    validation.ensure_finite(torch.zeros(3, 3))
    for bad in (float("nan"), float("inf")):
        t = torch.zeros(3, 3)
        t[1, 2] = bad
        with pytest.raises(ValueError, match="non-finite"):
            validation.ensure_finite(t)
