"""``repro_torch.launch.inputs`` against ``repro.launch.inputs``: for every
arch and every ``ShapeConfig``, the port's stand-ins (``meta`` tensors)
have the reference's keys, shapes and dtypes; for a decode shape the
token and every cache leaf (the reference's stacked leaves unstacked, one
a layer, as ``tests/test_torch_sharding.py`` names them; its device
position scalar is the port's host int), and the batch ``_cache_batch``
reads off the cache."""

import jax
import numpy as np
import pytest

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.launch.inputs import input_specs as ref_input_specs
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch.inputs import input_specs
from repro_torch.runtime.serve import _cache_batch
from repro_torch.sharding.rules import cache_leaves


def _dt(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _ref_cache(cfg, cache) -> dict:
    """``{port name: (shape, dtype)}`` of the reference's cache tree."""
    period = len(cfg.pattern)
    n_full = cfg.n_layers // period
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        keys = [str(getattr(e, "key", getattr(e, "idx", e))) for e in path]
        shape, dt = tuple(leaf.shape), str(np.dtype(leaf.dtype))
        if keys == ["pos"]:
            continue
        if keys[0] == "dec":
            rest = ["self_attn" if k == "self" else k for k in keys[1:]]
            for i in range(cfg.n_layers):
                out[".".join(["dec", str(i), *rest])] = (shape[1:], dt)
        elif keys[0] == "blocks":
            for i in range(n_full):
                out[".".join(["blocks", str(i * period + int(keys[1])),
                              *keys[2:]])] = (shape[1:], dt)
        else:
            out[".".join(["blocks", str(n_full * period + int(keys[1])),
                          *keys[2:]])] = (shape, dt)
    return out


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_match_reference(arch, shape):
    got = input_specs(ARCHS[arch], SHAPES[shape])
    want = ref_input_specs(REF_ARCHS[arch], REF_SHAPES[shape])
    if SHAPES[shape].kind != "decode":
        assert set(got) == set(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape), _dt(t)) == (
                tuple(want[k].shape), str(np.dtype(want[k].dtype))), k
        return
    (token, cache), (ref_token, ref_cache) = got, want
    assert token.device.type == "meta"
    assert (tuple(token.shape), _dt(token)) == (
        tuple(ref_token.shape), str(np.dtype(ref_token.dtype)))
    have = {name: (tuple(getattr(o, f).shape), _dt(getattr(o, f)))
            for name, o, f in cache_leaves(cache)}
    assert all(getattr(o, f).device.type == "meta"
               for _, o, f in cache_leaves(cache))
    assert have == _ref_cache(REF_ARCHS[arch], ref_cache)
    assert cache.pos == 0
    assert _cache_batch(cache) == SHAPES[shape].global_batch
