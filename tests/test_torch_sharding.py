"""The sharding rules: ``repro_torch.sharding`` against ``repro.sharding``.

For every arch on the abstract production meshes, (16, 16) and (2, 16,
16), the port's ``param_specs`` equal the reference's leaf for leaf, under
FSDP rules and DP/TP rules (the moments' specs under ``zero1`` are the
FSDP ones): each reference leaf is named as ``repro_torch.convert`` names
it, a stacked leaf's spec ``P(None, *s)`` being ``s`` on each of the port's
per-layer leaves. ``cache_specs`` likewise for the archs of
``tests/test_sharding.py``'s cache test, at its batch and depth. Then the
cases of ``tests/test_sharding.py``: ``_fit``, divisibility, the deep
cache's sequence axis, ``batch_spec``, the MoE expert axis; and
``named``'s placements on a mesh. Pure spec logic: no rank is needed
beyond a one-rank group for ``named``.
"""

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as RefAbstractMesh
from jax.sharding import PartitionSpec as RefP
from torch.distributed.tensor import Replicate, Shard

import torch_threads  # noqa: F401  (this process's share of the cores)
from repro.configs import ARCHS as REF_ARCHS
from repro.runtime.serve import abstract_cache as ref_abstract_cache
from repro.runtime.train import abstract_train_state as ref_abstract_state
from repro.sharding.rules import cache_specs as ref_cache_specs
from repro.sharding.rules import make_rules as ref_make_rules
from repro.sharding.rules import param_specs as ref_param_specs
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime.serve import abstract_cache
from repro_torch.runtime.train import abstract_train_state
from repro_torch.sharding import (AbstractMesh, ShardingRules, batch_spec,
                                  cache_specs, make_rules, named,
                                  param_specs)
from repro_torch.sharding.rules import P, _fit, spec_dims

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _rules(shape=(16, 16), axes=("data", "model"), fsdp=True):
    return make_rules(AbstractMesh(shape, axes), fsdp=fsdp)


def _ref_rules(shape=(16, 16), axes=("data", "model"), fsdp=True):
    return ref_make_rules(RefAbstractMesh(shape, axes), fsdp=fsdp)


def _key(e) -> str:
    return str(getattr(e, "key", getattr(e, "idx", e)))


def _layout(cfg):
    period = len(cfg.pattern)
    return period, cfg.n_layers // period


def _ref_param_names(cfg, specs) -> dict:
    """``{port name: spec tuple}`` of the reference's spec tree: stacked
    groups unstacked as ``convert._lm_leaves`` does."""
    period, n_full = _layout(cfg)
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, RefP))[0]
    for path, spec in flat:
        keys = [_key(e) for e in path]
        top, spec = keys[0], tuple(spec)
        if top in ("enc_blocks", "dec_blocks"):
            n = cfg.n_enc_layers if top == "enc_blocks" else cfg.n_layers
            for i in range(n):
                out[".".join([top, str(i), *keys[1:]])] = spec[1:]
        elif top == "blocks":
            j = int(keys[1])
            for i in range(n_full):
                out[".".join(["blocks", str(i * period + j), *keys[2:]])] = \
                    spec[1:]
        elif top == "rem":
            r = int(keys[1])
            out[".".join(["blocks", str(n_full * period + r),
                          *keys[2:]])] = spec
        else:
            out[".".join(keys)] = spec
    return out


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "dp_tp"])
@pytest.mark.parametrize("mesh_shape,axes", MESHES,
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(arch, mesh_shape, axes, fsdp):
    ref_params, _ = ref_abstract_state(REF_ARCHS[arch])
    want = _ref_param_names(REF_ARCHS[arch], ref_param_specs(
        REF_ARCHS[arch], ref_params, _ref_rules(mesh_shape, axes, fsdp)))
    model, opt = abstract_train_state(ARCHS[arch])
    rules = _rules(mesh_shape, axes, fsdp)
    got = param_specs(ARCHS[arch], model, rules)
    assert set(got) == set(want)
    bad = {k: (tuple(got[k]), want[k]) for k in got
           if tuple(got[k]) != want[k]}
    assert not bad, list(bad.items())[:5]
    # the moments take the same specs (the reference's o_p_specs)
    assert param_specs(ARCHS[arch], opt["m"], rules) == got
    # every spec divides its leaf
    shapes = dict((k, p.shape) for k, p in model.named_parameters())
    for name, spec in got.items():
        for d, ax in spec_dims(spec).items():
            assert shapes[name][d] % rules.axis_size(ax) == 0, (name, spec)


def _ref_cache_names(cfg, specs) -> dict:
    period, n_full = _layout(cfg)
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, RefP))[0]
    for path, spec in flat:
        keys = [_key(e) for e in path]
        spec = tuple(spec)
        if keys == ["pos"]:
            continue                     # the port's position is a host int
        if keys[0] == "dec":
            rest = ["self_attn" if k == "self" else k for k in keys[1:]]
            for i in range(cfg.n_layers):
                out[".".join(["dec", str(i), *rest])] = spec[1:]
        elif keys[0] == "blocks":
            j = int(keys[1])
            for i in range(n_full):
                out[".".join(["blocks", str(i * period + j), *keys[2:]])] = \
                    spec[1:]
        else:
            r = int(keys[1])
            out[".".join(["blocks", str(n_full * period + r),
                          *keys[2:]])] = spec
    return out


@pytest.mark.parametrize("mesh_shape,axes", MESHES,
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-1.3b",
                                  "recurrentgemma-9b", "seamless-m4t-medium"])
def test_cache_specs_match_reference(arch, mesh_shape, axes):
    enc = 8192 if ARCHS[arch].is_encdec else 0
    want = _ref_cache_names(REF_ARCHS[arch], ref_cache_specs(
        REF_ARCHS[arch], ref_abstract_cache(REF_ARCHS[arch], 128, 32768,
                                            enc_len=enc),
        _ref_rules(mesh_shape, axes)))
    cache = abstract_cache(ARCHS[arch], 128, 32768, enc_len=enc)
    got = cache_specs(ARCHS[arch], cache, _rules(mesh_shape, axes))
    assert set(got) == set(want)
    bad = {k: (tuple(got[k]), want[k]) for k in got
           if tuple(got[k]) != want[k]}
    assert not bad, list(bad.items())[:5]


def test_fit_prefers_full_group_then_truncates():
    r = _rules((2, 16, 16), ("pod", "data", "model"))
    assert _fit(64, ("pod", "data"), r) == ("pod", "data")
    assert _fit(16, ("pod", "data"), r) == "data"      # 16 % 32 != 0
    assert _fit(7, ("pod", "data"), r) is None
    assert _fit(32, "model", r) == "model"
    assert _fit(24, "model", r) is None                # llama heads


def test_deep_cache_is_sequence_sharded():
    """A 32768-slot full-attention cache shards its sequence over
    "model"."""
    cfg = ARCHS["qwen3-8b"]
    specs = cache_specs(cfg, abstract_cache(cfg, 128, 32768), _rules())
    kv = [s for k, s in specs.items() if k.endswith((".k", ".v"))]
    assert len(kv) == 2 * cfg.n_layers
    assert all(s == P("data", "model", None, None) for s in kv)


def test_batch_spec_handles_indivisible_batch():
    rules = _rules()
    assert batch_spec(rules, 256) == P("data", None)
    assert batch_spec(rules, 1) == P(None, None)       # long_500k B=1
    assert batch_spec(rules, 24, rank=3) == P(None, None, None)
    assert batch_spec(rules, 48, rank=3) == P("data", None, None)
    assert batch_spec(_rules((2, 16, 16), ("pod", "data", "model")), 64) \
        == P(("pod", "data"), None)


def test_moe_expert_axis_choice():
    """granite (32 experts) → experts on "model"; grok (8) → the expert
    FFN's hidden dim instead; the fp32 router FSDP on its rows."""
    rules = _rules()
    granite = param_specs(ARCHS["granite-moe-1b-a400m"], abstract_train_state(
        ARCHS["granite-moe-1b-a400m"])[0], rules)
    grok = param_specs(ARCHS["grok-1-314b"], abstract_train_state(
        ARCHS["grok-1-314b"])[0], rules)
    assert granite["blocks.0.moe.w_up"] == P("model", "data", None)
    assert granite["blocks.0.moe.w_down"] == P("model", None, "data")
    assert grok["blocks.0.moe.w_up"] == P(None, "data", "model")
    assert grok["blocks.0.moe.w_down"] == P(None, "model", "data")
    assert granite["blocks.0.moe.router"] == P("data", None)


def test_rules_refuse_a_mesh_of_other_axes():
    rules = make_rules(AbstractMesh((4,), ("model",)))
    assert rules.dp == () and rules.fsdp == ()
    assert isinstance(rules, ShardingRules)
    assert _fit(8, rules.dp, rules) is None
    with pytest.raises(ValueError, match="differ in length"):
        AbstractMesh((2, 2), ("data",))


def test_named_gives_dtensor_placements():
    """A dim over two axes is split outermost-first; the others
    replicate."""
    mesh = make_host_mesh((1, 1), device_type="cpu")
    assert named(mesh, P("model", "data")) == [Shard(1), Shard(0)]
    assert named(mesh, P(None, None)) == [Replicate(), Replicate()]
    assert named(mesh, {"a": P("data")}) == {"a": [Shard(0), Replicate()]}
    with pytest.raises(ValueError, match="shards two dims"):
        named(mesh, P("data", "data"))
    with pytest.raises(ValueError, match="mesh's order"):
        named(mesh, P(("model", "data")))
    assert torch.distributed.is_initialized()
