"""The port's sharding rules (``repro_torch.sharding.specs``) against the
reference's ``PartitionSpec``s, read as tuples, at the production meshes.

The reference's rules read only ``mesh.axis_names`` and
``mesh.devices.shape``, and the port's only ``mesh.mesh_dim_names`` and
``mesh.shape``, so both take a stand-in mesh here: no devices and no
process group are needed to hold them leaf for leaf on the ten full
configs.  ``placements`` and ``make_shard_fn`` are held on a fake
process group of 8 ranks in a subprocess (it must not meet the other
tests' groups).
"""

import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec

from repro.configs import registry as jregistry
from repro.configs import shapes as jshapes
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.sharding import specs as jspecs
from repro_torch.configs import registry as tregistry
from repro_torch.configs import shapes as tshapes
from repro_torch.models import transformer as ttf
from repro_torch.sharding import specs as tspecs

REPO = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    return (types.SimpleNamespace(axis_names=axes, devices=np.empty(shape)),
            types.SimpleNamespace(mesh_dim_names=axes, shape=shape))


def _ref_specs(tree):
    """{path: spec as a tuple} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, PartitionSpec))
    name = lambda e: str(getattr(e, "key", getattr(e, "name", e)))
    return {"/".join(name(e) for e in path): tuple(s) for path, s in flat}


def _port_specs(tree, prefix=""):
    """{path: spec} of a port spec tree (dicts and NamedTuples)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = [(k, v) for k, v in zip(tree._fields, tree) if v is not None]
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_port_specs(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


ARCHS = jregistry.list_archs()


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_equal_reference(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    jshapes_ = jtf.param_shapes(jregistry.get(arch))
    tshapes_ = ttf.param_shapes(tregistry.get(arch))
    jp, tp = jspecs.param_specs(jshapes_, jmesh), tspecs.param_specs(tshapes_, tmesh)
    want, got = _ref_specs(jp), _port_specs(tp)
    assert len(want) == len(got) > 0
    assert got == want
    assert (_port_specs(tspecs.zero1_specs(tp, tshapes_, tmesh))
            == _ref_specs(jspecs.zero1_specs(jp, jshapes_, jmesh)))
    # AdamW's state tree as the dry run places it
    jo = jadamw.AdamWState(step=PartitionSpec(), mu=jp, nu=jp)
    assert len(_ref_specs(jo)) == 2 * len(want) + 1


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", list(jshapes.ALL_SHAPES))
def test_input_specs_equal_reference(shape, mesh):
    jmesh, tmesh = _meshes(mesh)
    for arch in ARCHS:
        jcfg, tcfg = jregistry.get(arch), tregistry.get(arch)
        jin = jshapes.token_inputs(jcfg, jshapes.ALL_SHAPES[shape])
        tin = tshapes.token_inputs(tcfg, tshapes.ALL_SHAPES[shape])
        assert (_port_specs(tspecs.input_specs_tree(tin, tmesh))
                == _ref_specs(jspecs.input_specs_tree(jin, jmesh))), arch


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_cache_specs_equal_reference(shape, ring, mesh):
    jmesh, tmesh = _meshes(mesh)
    s = jshapes.ALL_SHAPES[shape]
    checked = 0
    for arch in ARCHS:
        jcfg, tcfg = jregistry.get(arch), tregistry.get(arch)
        if not jshapes.applicable(jcfg, s):
            continue
        jc = jtf.cache_shapes(jcfg, s.global_batch, s.seq_len, ring=ring)
        tc = ttf.cache_shapes(tcfg, s.global_batch, s.seq_len, ring=ring)
        want = _ref_specs(jspecs.cache_specs(jc, jmesh))
        assert _port_specs(tspecs.cache_specs(tc, tmesh)) == want, arch
        checked += 1
    assert checked >= 5


def test_moe_fallback_and_expert_parallelism():
    _, tmesh = _meshes("pod16x16")
    mixtral = tspecs.param_specs(ttf.param_shapes(tregistry.get("mixtral-8x7b")), tmesh)
    moe = mixtral["layers"]["moe"]
    # E = 8 does not divide model 16: the experts' d_ff is split instead
    assert moe["w_gate"] == moe["w_up"] == (None, None, None, "model")
    assert moe["w_down"] == (None, None, "model", None)
    qwen = tspecs.param_specs(ttf.param_shapes(tregistry.get("qwen3-moe-30b-a3b")), tmesh)
    moe = qwen["layers"]["moe"]
    # E = 128 divides 16: expert parallelism
    assert moe["w_gate"] == moe["w_up"] == moe["w_down"] == (None, "model", None, None)
    assert moe["router"] == ()


@pytest.mark.parametrize("mesh", MESHES)
def test_activation_rule_divisibility_guard(mesh):
    _, tmesh = _meshes(mesh)
    baxes = tspecs.batch_axes(tmesh)
    b = baxes if len(baxes) > 1 else baxes[0]
    # batch-1 decode: nothing divides, the hook leaves the tensor alone
    assert tspecs.activation_spec((1, 1, 2048), "decode_activation", tmesh) is None
    assert tspecs.activation_spec((1, 1, 256000), "decode_logits", tmesh) == (
        None, None, "model")
    assert tspecs.activation_spec((128, 1, 2048), "decode_activation", tmesh) == (b, None, None)
    assert tspecs.activation_spec((32, 128, 40, 2048), "moe_buf", tmesh) == (
        b, "model", None, None)
    assert tspecs.activation_spec((32, 8, 40, 2048), "moe_buf", tmesh) == (
        b, None, None, None)
    assert tspecs.activation_spec((32, 4096), "no_such_rule", tmesh) is None


def test_local_bytes_of_a_stand_in_mesh():
    _, tmesh = _meshes("pod2x16x16")
    spec = (("pod", "data"), None, "model")
    assert tspecs.local_shape((64, 7, 32), spec, tmesh) == (2, 7, 2)
    assert tspecs.local_shape((64, 7, 32), (), tmesh) == (64, 7, 32)


PLACEMENTS = r"""
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.sharding import specs
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
assert specs.placements((("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0), Shard(2))
assert specs.placements((), mesh) == (Replicate(),) * 3
assert specs.placements((None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
shard = specs.make_shard_fn(mesh)
assert shard.mesh is mesh
x = DTensor.from_local(torch.zeros(8, 3, 4), mesh, (Replicate(),) * 3, run_check=False)
y = shard(x, "activation")
assert y.placements == (Shard(0), Shard(0), Replicate()), y.placements
assert shard(torch.zeros(8, 3, 4), "activation").shape == (8, 3, 4)  # a plain tensor passes
one = DTensor.from_local(torch.zeros(1, 1, 4), mesh, (Replicate(),) * 3, run_check=False)
assert shard(one, "decode_activation") is one
dist.destroy_process_group()
print("PLACEMENTS_OK")
"""


def test_placements_and_shard_hook_on_a_fake_group():
    proc = subprocess.run([sys.executable, "-c", PLACEMENTS], capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PLACEMENTS_OK" in proc.stdout
