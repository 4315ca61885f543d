"""The port's model-internal sharding against the reference's, in one
process.

  * Specs: for every arch of ``configs.registry.ARCHS`` (smoke and full
    configs), the port's ``param_specs`` equal the reference's spec tree
    name for name through ``convert``'s name map (a stacked block's
    leading layer entry, None in the reference, dropped); likewise the
    optimizer's ``state_specs`` (AdamW float32 and int8 moments), the
    caches' ``cache_specs`` and the attention, FFN and MoE specs.
  * Resolution: ``Sharder.resolve`` of every full-width parameter at the
    reference's production meshes (16, 16) and (2, 16, 16), taken as
    ``MeshShape``s, equals the reference's ``Sharder.resolve`` given a
    stand-in mesh with the same axis names and device grid (all it reads).
    The reference writes a one-axis entry of a multi-axis rule as a
    1-tuple; the comparison reads both as the set of axes, in order.
  * The grouped MoE: the port's ``moe_apply`` against the reference's,
    each given a stand-in sharder whose ``num_shards("tokens", T)`` is g
    and whose constraint is the identity (the only two methods either
    calls), at g = 1, 2 and 4 and capacity factors 1.0 (drops) and 16.0
    (none), in one and in several expert blocks: output and grads within
    atol = rtol = 2e-5 (forward) and 5e-5 (grads), the aux loss within
    rtol 1e-5, and the kept assignments exactly.

Full configs are built only as shapes: the port's modules under a
``FakeTensorMode`` (nothing allocated).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import registry as jax_registry
from repro.dist.sharding import Sharder as JaxSharder
from repro.models import colpali as jax_colpali
from repro.models import gnn as jax_gnn
from repro.models import layers as jax_layers
from repro.models import recsys as jax_recsys
from repro.models import transformer as jax_transformer
from repro.optim import optimizer as jax_opt
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.dist.sharding import MeshShape, Sharder
from repro_torch.launch import cells
from repro_torch.models import colpali, gnn, layers, recsys
from repro_torch.models import transformer as T
from repro_torch.optim import optimizer as opt

ARCH_IDS = sorted(registry.ARCHS)
PRODUCTION = {"single": (("data", "model"), (16, 16)),
              "multi": (("pod", "data", "model"), (2, 16, 16))}


def _configs(arch_id, smoke):
    """(the reference's model config, the port's) of an arch; PNA's at its
    first cell's widths, as the cells build it."""
    jspec, tspec = jax_registry.get(arch_id), registry.get(arch_id)
    jc = jspec.smoke_config if smoke else jspec.config
    tc = tspec.smoke_config if smoke else tspec.config
    if tspec.family == "colpali":
        return jc.encoder, tc.encoder
    if tspec.family == "gnn":
        tc = cells.pna_config(tspec, tspec.shapes[0], smoke)
        jc = dataclasses.replace(jc, d_feat=tc.d_feat,
                                 n_classes=tc.n_classes, task=tc.task)
    return jc, tc


def _specs(family, jc, tc):
    """(the reference's spec tree, the port's flat specs)."""
    if family == "lm":
        return jax_transformer.param_specs(jc), T.param_specs(tc)
    if family == "colpali":
        return jax_colpali.param_specs(jc), colpali.param_specs(tc)
    if family == "recsys":
        return jax_recsys.param_specs(jc), recsys.param_specs(tc)
    return jax_gnn.param_specs(jc), gnn.param_specs(tc)


def _is_spec(x):
    return type(x) is tuple and all(e is None or isinstance(e, str)
                                    for e in x)


def _flat(tree, prefix=""):
    """A spec tree -> {"a/b/0/c": spec}, lists keyed by their index."""
    if _is_spec(tree):
        return {prefix.rstrip("/"): tree}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        tree = {str(i): v for i, v in enumerate(tree)}
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


def _port_as_reference(port_specs, ref_flat):
    """The port's flat specs mapped onto the reference's keys: a block's
    spec gains the reference's layer entry (which must be None)."""
    out = {}
    for name, spec in port_specs.items():
        key, layer = convert._reference_path(name)
        if layer is not None:
            assert ref_flat[key][0] is None, (key, ref_flat[key])
            spec = (None,) + tuple(spec)
        assert out.get(key, spec) == spec, (name, key)
        out[key] = tuple(spec)
    return out


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_param_specs_match_the_reference(arch_id, smoke):
    family = registry.get(arch_id).family
    jc, tc = _configs(arch_id, smoke)
    jspecs, tspecs = _specs(family, jc, tc)
    ref = _flat(jspecs)
    assert _port_as_reference(tspecs, ref) == ref


@pytest.mark.parametrize("moments", ["fp32", "int8"])
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_state_specs_match_the_reference(arch_id, moments):
    family = registry.get(arch_id).family
    jc, tc = _configs(arch_id, True)
    jspecs, tspecs = _specs(family, jc, tc)
    jst = jax_opt.state_specs(jspecs, jax_opt.AdamWConfig(
        moment_dtype=moments))
    tst = opt.state_specs(tspecs, opt.AdamWConfig(moment_dtype=moments))
    assert tst.step == jst.step == ()
    for jm, tm in ((jst.m, tst.m), (jst.v, tst.v)):
        if moments == "fp32":
            ref = _flat(jm)
            assert _port_as_reference(tm, ref) == ref
            continue
        for field in ("q", "scale"):
            ref = {k[:-len("/" + field)]: v for k, v in _flat(jm).items()
                   if k.endswith("/" + field)}
            got = {n: getattr(m, field) for n, m in tm.items()}
            assert all(isinstance(m, opt.QMoment) for m in tm.values())
            assert _port_as_reference(got, ref) == ref


def test_cache_attn_ffn_moe_specs_match_the_reference():
    assert tuple(T.cache_specs()) == tuple(jax_transformer.cache_specs())
    for bias in (False, True):
        assert layers.attn_specs(bias) == jax_layers.attn_specs(bias)
    assert layers.ffn_specs() == jax_layers.ffn_specs()
    for n_shared in (0, 1):
        ref = {k.replace("/", "."): v for k, v in
               _flat(jax_layers.moe_specs(n_shared)).items()}
        assert layers.moe_specs(n_shared) == ref


# ---------------------------------------------------------------------------
# resolution at the production meshes
# ---------------------------------------------------------------------------

class _StandInMesh:
    """What the reference's Sharder reads of a mesh."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape)


def _full_shapes(arch_id):
    """{port name: shape} of the full config, built on fake tensors."""
    spec = registry.get(arch_id)
    _, tc = _configs(arch_id, False)
    with FakeTensorMode():
        if spec.family == "lm":
            model = T.Transformer(tc, device="cpu")
        elif spec.family == "colpali":
            model = colpali.ColPaliEncoder(tc, device="cpu")
        elif spec.family == "recsys":
            model = recsys.RecsysModel(tc, device="cpu")
        else:
            model = gnn.PNAModel(tc, device="cpu")
        return {n: tuple(p.shape) for n, p in model.named_parameters()}


def _axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@pytest.mark.parametrize("mesh", sorted(PRODUCTION))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_resolve_at_production_meshes_matches_the_reference(arch_id, mesh):
    names, shape = PRODUCTION[mesh]
    port = Sharder(MeshShape(names, shape))
    ref = JaxSharder(_StandInMesh(names, shape))
    family = registry.get(arch_id).family
    jc, tc = _configs(arch_id, False)
    jspecs, tspecs = _specs(family, jc, tc)
    ref_flat = _flat(jspecs)
    shapes = _full_shapes(arch_id)
    assert set(shapes) == set(tspecs)
    for name, spec in tspecs.items():
        key, layer = convert._reference_path(name)
        got = port.resolve(spec, shapes[name])
        if layer is None:
            want = tuple(ref.resolve(ref_flat[key], shapes[name]))
        else:
            n_layers = jc.backbone.n_layers if family == "colpali" \
                else jc.n_layers
            want = tuple(ref.resolve(ref_flat[key],
                                     (n_layers,) + shapes[name]))[1:]
        assert [_axes(e) for e in got] == [_axes(e) for e in want], name


# ---------------------------------------------------------------------------
# the grouped MoE against the reference's, through stand-in sharders
# ---------------------------------------------------------------------------

class _JaxGroups:
    """The reference's sharder as ``moe_apply`` sees it on a mesh whose
    token axes shard g ways."""

    def __init__(self, g):
        self.g = g

    def num_shards(self, name, dim):
        return self.g if name == "tokens" and dim % self.g == 0 else 1

    def constraint(self, x, *spec):
        return x


class _PortGroups(_JaxGroups):
    """The same for the port (no mesh: plain tensors throughout)."""
    mesh = None

    def scope(self):
        return contextlib.nullcontext()


# (label, D, F, E, top_k, n_shared, tokens): kimi-k2-smoke's and
# llama4-scout-smoke's MoE widths, and the reference EP test's
MOE_CASES = [("kimi_smoke", 64, 32, 8, 2, 0, 64),
             ("scout_smoke", 64, 96, 4, 1, 1, 64),
             ("ep_test", 16, 24, 8, 2, 0, 64)]


def _moe_inputs(d, f, e, n_shared, t, seed=0):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    if n_shared:
        p["shared"] = {"w_gate": rng.standard_normal((d, f)) / np.sqrt(d),
                       "w_up": rng.standard_normal((d, f)) / np.sqrt(d),
                       "w_down": rng.standard_normal((f, d)) / np.sqrt(f)}
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    x = rng.standard_normal((t, d)).astype(np.float32)
    return p, x


def _port_moe(p, d, f, e, k, n_shared):
    mod = layers.MoE(d, f, e, n_shared, k, torch.float32,
                     torch.device("cpu"))
    with torch.no_grad():
        for name, t in mod.named_parameters():
            node = p
            for part in name.split("."):
                node = node[part]
            t.copy_(torch.from_numpy(node))
    return mod


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("cf", [1.0, 16.0])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_grouped_moe_matches_the_reference(case, g, cf, chunks):
    _, d, f, e, k, n_shared, t = case
    p, x = _moe_inputs(d, f, e, n_shared, t, seed=g)

    def jax_loss(pp, xx):
        out, aux = jax_layers.moe_apply(pp, xx, top_k=k, capacity_factor=cf,
                                        shd=_JaxGroups(g),
                                        expert_chunks=chunks)
        return jnp.sum(out ** 2) + aux, (out, aux)

    (_, (want, want_aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    mod = _port_moe(p, d, f, e, k, n_shared)
    xt = torch.from_numpy(x).requires_grad_(True)
    got, aux = layers.moe_apply(mod, xt, top_k=k, capacity_factor=cf,
                                expert_chunks=chunks, remat=chunks > 1,
                                shd=_PortGroups(g))
    (torch.sum(got ** 2) + aux).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=5e-5,
                               rtol=5e-5)
    for name, t_ in mod.named_parameters():
        node = gp
        for part in name.split("."):
            node = node[part]
        np.testing.assert_allclose(t_.grad.numpy(), np.asarray(node),
                                   atol=5e-5, rtol=5e-5, err_msg=name)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_grouped_moe_keeps_the_references_assignments(g):
    """The kept (token, expert) pairs at capacity factor 1.0, read from the
    reference through probe experts whose down-projection writes only the
    expert's own column: exact. Capacity is per group, so g changes the
    kept set, and g = 1 is the single-group result."""
    d, f, e, k, t = 16, 8, 8, 2, 64
    p, x = _moe_inputs(d, f, e, 0, t, seed=10)
    x = np.abs(x)
    p["w_gate"] = np.abs(p["w_gate"])
    p["w_up"] = np.abs(p["w_up"])
    down = np.zeros((e, f, d), np.float32)
    for i in range(e):
        down[i, :, i] = 1.0
    p["w_down"] = down
    want, _ = jax_layers.moe_apply(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x), top_k=k,
                                   capacity_factor=1.0, shd=_JaxGroups(g))
    want_kept = np.asarray(want)[:, :e] != 0
    mod = _port_moe(p, d, f, e, k, 0)
    r = layers.moe_route(mod, torch.from_numpy(x).view(g, t // g, d), k,
                         1.0)
    kept = np.zeros((g, t // g, e), bool)
    for i in range(g):
        kept[i, r.sorted_token[i][r.keep[i]], r.sorted_expert[i][r.keep[i]]] \
            = True
    np.testing.assert_array_equal(kept.reshape(t, e), want_kept)
    assert r.capacity == layers.moe_capacity(t // g, e, k, 1.0)
