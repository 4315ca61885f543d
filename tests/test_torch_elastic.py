"""Logical-axis specs and checkpoints across meshes, against the reference.

  * ``Sharder.resolve`` on a shape-only mesh (``MeshShape``) equal, entry
    by entry, to the reference's ``Sharder(jax.make_mesh(...)).resolve``
    for every ``DEFAULT_RULES`` name (and an unknown one, and None) over
    one- and two-dim specs and shapes that do and don't divide, on
    (1, 1), (2, 4) and (2, 16, 16) meshes; the reference runs in a
    subprocess with 512 virtual CPU devices;
  * ``reshard_plan`` equal to the reference's on the same spec tree and
    shapes, between (2, 4) and (4, 2) and between (2, 4) and (2, 16, 16);
  * bfloat16 across the packages: a bf16 param tree through ``convert``
    both ways bit for bit (LM and recsys), a reference-written bf16
    checkpoint restored by the port bit for bit, and the port's bf16
    checkpoint written as the reference writes one (the reference cannot
    restore one: caveat C10 of ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jax_ck
from repro.configs import lm_archs as jax_lm_archs
from repro.configs import recsys_archs as jax_recsys_archs
from repro.models import recsys as jax_recsys
from repro.models import transformer as jax_transformer
from repro_torch import convert
from repro_torch.ckpt import checkpoint as ck
from repro_torch.configs import lm_archs, recsys_archs
from repro_torch.dist.sharding import DEFAULT_RULES, MeshShape, Sharder
from repro_torch.train import elastic
from tests.conftest import run_subprocess

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
NAMES = sorted(DEFAULT_RULES) + ["unknown", None]
DIMS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 256, 512, 1000)
DIMS_2D = (2, 8, 12, 32, 512, 1000)
PLAN_SPECS = {"blocks": {"w1": ("embed", "mlp"), "w2": ("mlp", "embed")},
              "embed": ("vocab", "embed"), "norm": (None,),
              "tokens": ("batch", "seq_sp"), "corpus": ("corpus", None)}
PLAN_SHAPES = {"blocks": {"w1": (64, 256), "w2": (6, 64)},
               "embed": (1000, 64), "norm": (64,), "tokens": (6, 512),
               "corpus": (4096, 16)}
PLANS = (("2x4", "4x2"), ("2x4", "2x16x16"))


def _cases():
    """(spec, shape) pairs, in the order both sides enumerate them."""
    out = [((a,), (d,)) for a in NAMES for d in DIMS]
    out += [((a, b), (d, e)) for a in NAMES for b in NAMES
            for d in DIMS_2D for e in DIMS_2D]
    return out


_REFERENCE = """
import json, jax, numpy as np
from repro.dist.sharding import Sharder
from repro.train import elastic
meshes, names, dims, dims2, specs, shapes, plans = json.loads({payload!r})
cases = [((a,), (d,)) for a in names for d in dims]
cases += [((a, b), (d, e)) for a in names for b in names
          for d in dims2 for e in dims2]

def entry(e):
    return list(e) if isinstance(e, tuple) else e

def tree(t, f):
    return {{k: tree(v, f) for k, v in t.items()}} if isinstance(t, dict) else f(t)

sharders = {{name: Sharder(jax.make_mesh(tuple(s), tuple(a)))
            for name, (s, a) in meshes.items()}}
out = {{"resolve": {{name: [[entry(e) for e in shd.resolve(tuple(sp), tuple(sh))]
                          for sp, sh in cases]
                   for name, shd in sharders.items()}}}}
spec_tree = tree(specs, tuple)
template = tree(shapes, lambda s: np.zeros(s, np.float32))
out["plans"] = {{f"{{a}}->{{b}}": {{k: [[entry(e) for e in o], [entry(e) for e in n]]
                                  for k, (o, n) in elastic.reshard_plan(
                                      sharders[a], sharders[b], spec_tree,
                                      template).items()}}
                for a, b in plans}}
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    payload = json.dumps([MESHES, NAMES, DIMS, DIMS_2D, PLAN_SPECS,
                          PLAN_SHAPES, PLANS])
    out = run_subprocess(_REFERENCE.format(payload=payload), n_devices=512,
                         timeout=300)
    line = [x for x in out.splitlines() if x.startswith("RESULT")][0]
    return json.loads(line[len("RESULT"):])


def _entry(e):
    return tuple(e) if isinstance(e, list) else e


def _sharder(name: str) -> Sharder:
    shape, axes = MESHES[name]
    return Sharder(MeshShape(axes, shape))


@pytest.mark.parametrize("mesh", ["1x1", "2x4", "2x16x16"])
def test_resolve_matches_the_reference(mesh, reference):
    shd = _sharder(mesh)
    want = reference["resolve"][mesh]
    bad = [(spec, shape, got, tuple(_entry(e) for e in ref))
           for (spec, shape), ref in zip(_cases(), want)
           for got in [shd.resolve(spec, shape)]
           if got != tuple(_entry(e) for e in ref)]
    assert len(want) == len(_cases()) and not bad, bad[:5]


@pytest.mark.parametrize("old,new", PLANS, ids=[f"{a}->{b}" for a, b in
                                                PLANS])
def test_reshard_plan_matches_the_reference(old, new, reference):
    def tree(t, f):
        return ({k: tree(v, f) for k, v in t.items()} if isinstance(t, dict)
                else f(t))
    template = tree(PLAN_SHAPES, lambda s: ck.ArraySpec(tuple(s),
                                                        np.float32))
    got = elastic.reshard_plan(_sharder(old), _sharder(new), PLAN_SPECS,
                               template)
    want = {k: tuple(tuple(_entry(e) for e in side) for side in v)
            for k, v in reference["plans"][f"{old}->{new}"].items()}
    assert got == want and want


def test_num_shards_and_conflicts():
    """A mesh axis serves one dim of a tensor; num_shards follows the
    divisibility fallback."""
    shd = _sharder("2x16x16")
    assert shd.resolve(("corpus", "batch"), (512, 64)) == (
        ("pod", "data", "model"), None)
    assert shd.num_shards("corpus", 4096) == 512
    assert shd.num_shards("corpus", 96) == 32
    assert shd.num_shards("mlp", 8) == 1


def test_a_mesh_of_another_device_type_raises():
    """No fallback between devices: CPU tensors on a cuda mesh raise."""
    import types
    from repro_torch.core import distributed as D
    from repro_torch.dist.sharding import NamedSharding, distribute
    mesh = types.SimpleNamespace(device_type="cuda", mesh_dim_names=("data",),
                                 shape=(1,), get_coordinate=lambda: [0],
                                 size=lambda i=None: 1)
    x = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="cuda mesh"):
        distribute(x, NamedSharding(mesh, ()))
    with pytest.raises(ValueError, match="cuda mesh"):
        D.sharded_quantize(mesh, x[:, None], torch.zeros((3, 2)),
                           torch.uint8)


# ---------------------------------------------------------------------------
# bfloat16 across the packages
# ---------------------------------------------------------------------------

def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    assert a.dtype.kind == "V" and a.dtype.itemsize == 2, a.dtype
    return a.view(np.uint16)


def _flat(tree):
    return dict(ck.leaves_with_paths(tree))


def test_bf16_lm_params_cross_convert_bit_for_bit():
    jcfg = dataclasses.replace(jax_lm_archs.QWEN2_1_5B.smoke_config,
                               param_dtype="bfloat16")
    tcfg = dataclasses.replace(lm_archs.QWEN2_1_5B.smoke_config,
                               param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_transformer.init(
        jax.random.PRNGKey(0), cfg=jcfg))
    model = convert.lm_params_from_numpy(tree, tcfg, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    back, want = _flat(convert.params_to_numpy(model)), _flat(tree)
    assert sorted(back) == sorted(want)
    n_bf16 = 0
    for key, arr in want.items():
        if arr.dtype == jnp.bfloat16:
            np.testing.assert_array_equal(_bits(back[key]), _bits(arr))
            n_bf16 += 1
        else:
            np.testing.assert_array_equal(back[key], arr)
    assert n_bf16 >= 5


def test_bf16_recsys_params_cross_convert_bit_for_bit():
    jcfg = dataclasses.replace(jax_recsys_archs.DLRM_MLPERF.smoke_config,
                               param_dtype="bfloat16")
    tcfg = dataclasses.replace(recsys_archs.DLRM_MLPERF.smoke_config,
                               param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_recsys.init(jax.random.PRNGKey(1),
                                                    cfg=jcfg))
    model = convert.recsys_params_from_numpy(tree, tcfg, device="cpu")
    assert model.tables[0].dtype == torch.bfloat16
    back = _flat(convert.params_to_numpy(model))
    for key, arr in _flat(tree).items():
        if arr.dtype == jnp.bfloat16:
            np.testing.assert_array_equal(_bits(back[key]), _bits(arr))
        else:
            np.testing.assert_array_equal(back[key], arr)


def _bf16_tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"h": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
            "m": rng.standard_normal((2,)).astype(np.float32),
            "s": [rng.standard_normal((4,)).astype(ml_dtypes.bfloat16)]}


def test_port_restores_a_reference_bf16_checkpoint(tmp_path):
    tree = _bf16_tree(2)
    path = jax_ck.save(str(tmp_path), 7, jax.tree.map(jnp.asarray, tree))
    specs = {"h": ck.ArraySpec((3, 5), ck.BF16_HOST),
             "m": ck.ArraySpec((2,), np.dtype(np.float32)),
             "s": [ck.ArraySpec((4,), ck.BF16_HOST)]}
    got = ck.restore(path, specs)
    np.testing.assert_array_equal(_bits(got["h"]), _bits(tree["h"]))
    np.testing.assert_array_equal(_bits(got["s"][0]), _bits(tree["s"][0]))
    np.testing.assert_array_equal(got["m"], tree["m"])
    tensors = ck.restore(path, {"h": torch.zeros((3, 5), dtype=torch.bfloat16),
                                "m": torch.zeros(2),
                                "s": [torch.zeros(4, dtype=torch.bfloat16)]})
    assert tensors["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tensors["h"].view(torch.int16).numpy().view(np.uint16),
        _bits(tree["h"]))
    # a bf16 leaf restored into a float32 template is widened exactly
    wide = ck.restore(path, {"h": torch.zeros((3, 5)), "m": torch.zeros(2),
                             "s": [torch.zeros(4)]})
    np.testing.assert_array_equal(wide["h"].numpy(),
                                  tree["h"].astype(np.float32))


def test_port_writes_bf16_checkpoints_as_the_reference_does(tmp_path):
    tree = _bf16_tree(3)
    ref = jax_ck.save(str(tmp_path / "ref"), 1, jax.tree.map(jnp.asarray,
                                                             tree))
    port_tree = {"h": torch.from_numpy(tree["h"].view(np.int16)).view(
        torch.bfloat16), "m": torch.from_numpy(tree["m"]),
        "s": [torch.from_numpy(tree["s"][0].view(np.int16)).view(
            torch.bfloat16)]}
    port = ck.save(str(tmp_path / "port"), 1, port_tree)
    metas = [json.loads((Path(p) / "meta.json").read_text())["leaves"]
             for p in (ref, port)]
    for key in metas[0]:
        for field in ("shape", "dtype", "crc32"):
            assert metas[0][key][field] == metas[1][key][field], key
    assert metas[1]["['h']"]["dtype"] == "bfloat16"
    with np.load(Path(ref) / "arrays.npz") as a, \
            np.load(Path(port) / "arrays.npz") as b:
        for key in a.files:
            assert a[key].dtype == b[key].dtype
            assert a[key].tobytes() == b[key].tobytes()
    back = ck.restore(port, port_tree)
    for key in ("h", "m"):
        assert torch.equal(back[key], port_tree[key])
    assert torch.equal(back["s"][0], port_tree["s"][0])
