"""The port's data layer (``repro_torch.data``) against ``repro.data``.

``tests/test_runtime.py``'s four pipeline cases and its tile-stream case,
through the port; the port's tile arithmetic against the reference's on
the reference's own points (``DistanceTileStream._points``). The port's
batches and points are made from other random bits than the reference's
(``jax.random.fold_in`` has no torch counterpart; ROADMAP.md, queue 3), so
what is compared across the packages is structure and arithmetic, not
bits.

Tolerances: the tile-stream cases at the reference's atol 1e-5 (symmetry,
a tile against the dense matrix) and 1e-6 (the diagonal); the tile
arithmetic at rtol 1e-5 / atol 1e-5 against the reference's (the same
formula in fp32, a product summed in another order), and in bf16 within
one unit in the last place (one rounding of those fp32 values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.data.distance import DistanceTileStream as RefStream
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro_torch.configs import SHAPES, get_arch
from repro_torch.data import (DistanceTileStream, TokenPipeline,
                              distance_tile, make_batch_specs)
from repro_torch.data.distance import hashed_normals
from repro_torch.kernels.rmsnorm_ref import bf16_ulp_distance


def test_pipeline_deterministic_by_step():
    p1 = TokenPipeline(vocab=97, seq_len=16, global_batch=4, seed=3)
    p2 = TokenPipeline(vocab=97, seq_len=16, global_batch=4, seed=3)
    b1, b2 = p1.batch(7), p2.batch(7)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(p1.batch(8)["tokens"], b1["tokens"])
    assert not torch.equal(TokenPipeline(97, 16, 4, seed=4).batch(7)[
        "tokens"], b1["tokens"])


def test_pipeline_host_sharding_partitions_global_batch():
    full = TokenPipeline(vocab=97, seq_len=8, global_batch=8, seed=1)
    parts = [TokenPipeline(vocab=97, seq_len=8, global_batch=8, seed=1,
                           process_index=i, process_count=4) for i in range(4)]
    got = torch.cat([p.batch(5)["tokens"] for p in parts])
    assert torch.equal(got, full.batch(5)["tokens"])
    with pytest.raises(ValueError, match="divide"):
        TokenPipeline(vocab=97, seq_len=8, global_batch=6, process_count=4)


def test_pipeline_targets_are_shifted_tokens():
    p = TokenPipeline(vocab=31, seq_len=12, global_batch=2, seed=0)
    b = p.batch(0)
    assert torch.equal(b["tokens"][:, 1:], b["targets"][:, :-1])


@pytest.mark.parametrize("mode", ["structured", "uniform"])
def test_pipeline_batches_have_the_references_shapes_and_range(mode):
    ours = TokenPipeline(vocab=50, seq_len=24, global_batch=6, seed=2,
                         mode=mode).batch(3)
    ref = RefPipeline(vocab=50, seq_len=24, global_batch=6, seed=2,
                      mode=mode).batch(3)
    for key in ("tokens", "targets"):
        assert ours[key].dtype == torch.int32
        assert tuple(ours[key].shape) == tuple(np.asarray(ref[key]).shape)
        assert 0 <= int(ours[key].min()) and int(ours[key].max()) < 50


def test_pipeline_structure_is_learnable():
    """Structured mode: > 60% of transitions follow the affine rule, as in
    the reference (at noise 0.1, about 90% follow it in both)."""
    p = TokenPipeline(vocab=101, seq_len=256, global_batch=2, seed=0,
                      noise=0.1)
    toks = p.batch(0)["tokens"][0].numpy()
    follows = np.mean((31 * toks[:-1] + 17) % 101 == toks[1:])
    assert follows > 0.6
    ref = np.asarray(RefPipeline(vocab=101, seq_len=256, global_batch=2,
                                 seed=0, noise=0.1).batch(0)["tokens"][0])
    ref_follows = np.mean((31 * ref[:-1] + 17) % 101 == ref[1:])
    assert abs(follows - ref_follows) < 0.08
    uniform = TokenPipeline(vocab=101, seq_len=256, global_batch=2,
                            mode="uniform").batch(0)["tokens"][0].numpy()
    assert np.mean((31 * uniform[:-1] + 17) % 101 == uniform[1:]) < 0.1


def test_batch_specs_are_meta_stand_ins():
    specs = make_batch_specs(get_arch("llama3.2-3b"), SHAPES["train_4k"])
    for spec in specs.values():
        assert spec.device.type == "meta" and spec.dtype == torch.int32
        assert tuple(spec.shape) == (256, 4096)


def test_distance_tile_stream_consistency():
    ds = DistanceTileStream(n=70, tile=32, seed=5, device="cpu")
    dense = ds.dense().numpy()
    assert dense.shape == (70, 70)
    np.testing.assert_allclose(dense, dense.T, atol=1e-5)
    np.testing.assert_allclose(np.diag(dense), 0.0, atol=1e-6)
    t = ds.tile_at(32, 0).numpy()
    np.testing.assert_allclose(t, dense[32:64, 0:32], atol=1e-5)


def test_points_are_a_function_of_seed_and_row_alone():
    a = DistanceTileStream(n=100, tile=16, seed=9, device="cpu")
    b = DistanceTileStream(n=100, tile=64, seed=9, device="cpu")
    assert torch.equal(a._points(40, 30), b._points(40, 30))
    assert torch.equal(a._points(40, 30)[5:], b._points(45, 25))
    c = DistanceTileStream(n=100, tile=16, seed=10, device="cpu")
    assert not torch.equal(a._points(0, 4), c._points(0, 4))
    z = hashed_normals(0, 0, 200_000)
    assert abs(z.mean()) < 0.01 and abs(z.std() - 1.0) < 0.01
    assert torch.equal(a.dense(), b.dense())


@pytest.mark.parametrize("i,j", [(0, 0), (32, 0), (64, 32), (64, 64)])
def test_tile_arithmetic_matches_reference_on_its_points(i, j):
    ref = RefStream(n=70, tile=32, seed=5, dim=16)
    ti, tj = min(32, 70 - i), min(32, 70 - j)
    a = torch.from_numpy(np.array(ref._points(i, ti)))
    b = torch.from_numpy(np.array(ref._points(j, tj)))
    got = distance_tile(a, b, i == j)
    want = torch.from_numpy(np.array(ref.tile_at(i, j)))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if i == j:
        assert bool((torch.diagonal(got) == 0).all())
    bf = distance_tile(a, b, i == j, torch.bfloat16)
    want_bf = torch.from_numpy(np.array(RefStream(
        n=70, tile=32, seed=5, dim=16, dtype="bfloat16").tile_at(i, j).astype(
        jnp.float32)))
    assert bf.dtype == torch.bfloat16
    assert int(bf16_ulp_distance(bf, want_bf).max()) <= 1
