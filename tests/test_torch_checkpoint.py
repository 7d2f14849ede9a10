"""The port's checkpoints (``repro_torch.checkpoint.io``) against the
reference's ``repro.checkpoint.io``, on the CPU.

The two packages write the same files: the same npz array names in the
same order, the same JSON manifest, equal arrays.  A float32 checkpoint
written by either restores in the other bit for bit.  A bfloat16 leaf is
stored as the reference stores it (``|V2``, its 16 bits); the port
restores it bit for bit, from its own files and the reference's, where
the reference's own ``restore`` raises (pinned below, not fixed).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import io as tckpt
from repro_torch.configs import registry as tregistry
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw as tadamw
from test_torch_models import reference_params, to_numpy



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several workers on a
    few cores, where torch's default of one thread a core makes them
    contend (the 40-step training run then takes minutes, not seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _port_leaves(trees):
    """[(name::path, tensor)] of the port's trees, in the files' order."""
    return [(f"{name}::{path}", t) for name, tree in trees.items()
            for path, t in tckpt._items(tree)]


def _assert_bit_equal(got, want):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b), key


def test_checkpoint_roundtrip(tmp_path):
    cfg = tregistry.get("mamba2-370m").reduced()
    params = ttf.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    opt = tadamw.init(params)
    path = tckpt.save(str(tmp_path), 7, {"params": params, "opt": opt})
    assert os.path.exists(path)
    assert tckpt.latest_step(str(tmp_path)) == 7
    restored = tckpt.restore(str(tmp_path), 7, {"params": params, "opt": opt})
    assert isinstance(restored["opt"], tadamw.AdamWState)
    _assert_bit_equal(_port_leaves(restored), _port_leaves({"params": params, "opt": opt}))


def _state(arch):
    """The reference's and the port's (params, AdamW state after one update
    on stand-in gradients), equal leaf for leaf."""
    jcfg, tcfg, jp, tp = reference_params(arch)
    grads = jax.tree_util.tree_map(lambda p: jnp.cos(p * 7.0).astype(p.dtype), jp)
    jp, js, _ = jadamw.update(jadamw.AdamWConfig(), grads, jadamw.init(jp), jp)
    ts = tadamw.AdamWState(torch.tensor(int(js.step), dtype=torch.int32),
                           ttf.params_from_numpy(tcfg, to_numpy(js.mu), device="cpu"),
                           ttf.params_from_numpy(tcfg, to_numpy(js.nu), device="cpu"))
    return (jp, js), (ttf.params_from_numpy(tcfg, to_numpy(jp), device="cpu"), ts)


@pytest.mark.parametrize("arch", ["gemma-2b-reduced", "mamba2-370m-reduced"])
def test_files_equal_the_references(arch, tmp_path):
    (jp, js), (tp, ts) = _state(arch)
    jpath = jckpt.save(str(tmp_path / "ref"), 3, {"params": jp, "opt": js})
    tpath = tckpt.save(str(tmp_path / "port"), 3, {"params": tp, "opt": ts})
    assert os.path.basename(jpath) == os.path.basename(tpath) == "ckpt_00000003.npz"
    with np.load(jpath) as want, np.load(tpath) as got:
        assert got.files == want.files
        assert "opt::step" in got.files and "opt::mu/embed/table" in got.files
        for k in want.files:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    manifests = [json.loads(open(p[:-len(".npz")] + ".json").read()) for p in (jpath, tpath)]
    assert manifests[0] == manifests[1]
    assert manifests[1]["step"] == 3 and sorted(manifests[1]["trees"]) == ["opt", "params"]


@pytest.mark.parametrize("arch", ["gemma-2b-reduced", "mamba2-370m-reduced"])
def test_float32_checkpoints_cross_both_ways(arch, tmp_path):
    (jp, js), (tp, ts) = _state(arch)
    jckpt.save(str(tmp_path / "ref"), 5, {"params": jp, "opt": js})
    tckpt.save(str(tmp_path / "port"), 5, {"params": tp, "opt": ts})
    assert tckpt.latest_step(str(tmp_path / "ref")) == jckpt.latest_step(str(tmp_path / "port")) == 5

    templates = {"params": ttf.tree_map(torch.zeros_like, tp), "opt": tadamw.init(tp)}
    into_port = tckpt.restore(str(tmp_path / "ref"), 5, templates)
    _assert_bit_equal(_port_leaves(into_port), _port_leaves({"params": tp, "opt": ts}))

    into_ref = jckpt.restore(str(tmp_path / "port"), 5,
                             {"params": jp, "opt": jadamw.init(jp)})
    for tree, want in ((into_ref["params"], jp), (into_ref["opt"], js)):
        got_l, want_l = jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(want)
        assert len(got_l) == len(want_l)
        for a, b in zip(got_l, want_l):
            assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))


def _bf16_trees(arch="gemma-2b-reduced"):
    (jp, js), (tp, ts) = _state(arch)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = ttf.tree_map(lambda t: t.to(torch.bfloat16), tp)
    return (jp, js), (tp, ts)


def test_bfloat16_roundtrip_on_the_port(tmp_path):
    _, (tp, ts) = _bf16_trees()
    path = tckpt.save(str(tmp_path), 2, {"params": tp, "opt": ts})
    with np.load(path) as data:
        assert data["params::embed/table"].dtype == np.dtype("V2")
        assert data["opt::mu/embed/table"].dtype == np.float32
    templates = {"params": ttf.tree_map(torch.zeros_like, tp), "opt": tadamw.init(tp)}
    back = tckpt.restore(str(tmp_path), 2, templates)
    _assert_bit_equal(_port_leaves(back), _port_leaves({"params": tp, "opt": ts}))


def test_port_reads_the_references_bfloat16_file(tmp_path):
    """The reference writes a bfloat16 leaf as ``|V2``; its own restore
    cannot cast that back (``ValueError: No cast function available``),
    and the port restores it bit for bit.  The first assertion pins the
    reference's behaviour: if it starts to pass, the reference was fixed."""
    (jp, js), (tp, ts) = _bf16_trees()
    path = jckpt.save(str(tmp_path), 4, {"params": jp, "opt": js})
    with np.load(path) as data:
        assert data["params::embed/table"].dtype == np.dtype("V2")
    with pytest.raises(ValueError):
        jckpt.restore(str(tmp_path), 4, {"params": jp, "opt": js})
    cfg = dataclasses.replace(tregistry.get("gemma-2b-reduced"), dtype="bfloat16")
    back = tckpt.restore(str(tmp_path), 4,
                         {"params": ttf.param_shapes(cfg), "opt": tadamw.init(tp)})
    _assert_bit_equal(_port_leaves(back), _port_leaves({"params": tp, "opt": ts}))


def test_restore_places_on_one_device_and_refuses_a_mesh(tmp_path):
    cfg = tregistry.get("gemma-2b").reduced()
    params = ttf.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    tckpt.save(str(tmp_path), 1, {"params": params})
    templates = {"params": ttf.param_shapes(cfg)}
    placed = tckpt.restore(str(tmp_path), 1, templates, shardings={"params": "cpu"})
    assert all(t.device.type == "cpu" for _, t in ttf.tree_leaves(placed["params"]))
    _assert_bit_equal(_port_leaves(placed), _port_leaves({"params": params}))
    with pytest.raises(TypeError):  # placements come as (mesh, specs): test_torch_multidevice.py
        tckpt.restore(str(tmp_path), 1, templates, shardings={"params": {"embed": object()}})
    tckpt.save(str(tmp_path / "bf16"), 1,
               {"params": ttf.tree_map(lambda t: t.to(torch.bfloat16), params)})
    with pytest.raises(ValueError):  # a bfloat16 file into a float32 template
        tckpt.restore(str(tmp_path / "bf16"), 1, templates)
    assert tckpt.latest_step(str(tmp_path / "missing")) is None
