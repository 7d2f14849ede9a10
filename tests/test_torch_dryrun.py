"""The port's dry run (``repro_torch.launch.dryrun``): the ``build_*``
steps on reduced configs under a fake (2, 4) mesh, their arguments' bytes
per device against the reference's specs, and one production combo
through the module's command line.

Each run starts a fake process group, so each runs in a subprocess: no
other test sees the group.  The reference's side needs no devices: its
rules read only the mesh's axis names and shape (a stand-in mesh).
"""

import dataclasses
import json
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
from repro.roofline import report as jreport
from repro.sharding import specs as jspecs

REPO = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")

# (arch, step kind, MoE dispatch) on the reduced configs: a dense, an
# expert-parallel MoE (4 experts over model 4), an SSM, an MLA and a
# multimodal (mrope) arch, across the three step kinds
COMBOS = [("gemma-2b", "train", None), ("qwen3-moe-30b-a3b", "train", "dropping"),
          ("mamba2-370m", "prefill", None), ("minicpm3-4b", "decode", None),
          ("qwen2-vl-7b", "decode", None)]
SEQ, BATCH = 64, 8

BUILD = r"""
import dataclasses, json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import registry, shapes as shp
from repro_torch.launch import dryrun

dryrun.start_fake_group(8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
out = []
for arch, kind, impl in json.loads(sys.argv[1]):
    cfg = registry.get(arch).reduced()
    if impl:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl=impl))
    shape = shp.InputShape(kind, int(sys.argv[2]), int(sys.argv[3]), kind)
    fn, args = getattr(dryrun, "build_" + kind)(cfg, shape, mesh)
    arg_bytes = dryrun.local_bytes(args)
    result, counter, notes = dryrun.run_step(fn, args)
    cost = counter.cost()
    out.append(dict(arch=arch, kind=kind, arg_bytes=arg_bytes, flops=cost.flops,
                    coll_by_kind=cost.coll_by_kind, peak=counter.peak_bytes, notes=notes,
                    outputs=len(result)))
dryrun.dist.destroy_process_group()
print("BUILT " + json.dumps(out))
"""


def _stand_in(shape, axes):
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _local_bytes(tree, specs, mesh):
    """Bytes of one device's shards of ``tree`` (shape/dtype leaves) under
    the reference's ``specs``."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda s: isinstance(s, PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        shape = list(leaf.shape)
        for i, entry in enumerate(spec):
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None:
                    shape[i] //= sizes[axis]
        total += int(np.prod(shape, dtype=np.int64)) * np.dtype(leaf.dtype).itemsize
    return total


def reference_arg_bytes(cfg, shape, mesh):
    """The dry run's arguments per device, from the reference's specs:
    (params, AdamW state, batch) for train, (params, batch) for prefill,
    (params, cache, batch) for decode, as its ``build_*`` place them."""
    params = jtf.param_shapes(cfg)
    p_specs = jspecs.param_specs(params, mesh)
    batch = jshapes.token_inputs(cfg, shape)
    total = _local_bytes(params, p_specs, mesh)
    if shape.kind == "train":
        opt = jax.eval_shape(jadamw.init, params)
        o_specs = jadamw.AdamWState(step=PartitionSpec(), mu=p_specs, nu=p_specs)
        total += _local_bytes(opt, o_specs, mesh)
    if shape.kind == "decode":
        cache = jtf.cache_shapes(cfg, shape.global_batch, shape.seq_len)
        total += _local_bytes(cache, jspecs.cache_specs(cache, mesh), mesh)
        batch = {k: v for k, v in batch.items() if k == "tokens" or (k == "positions" and cfg.mrope)}
    return total + _local_bytes(batch, jspecs.input_specs_tree(batch, mesh), mesh)


@pytest.fixture(scope="module")
def built():
    proc = subprocess.run([sys.executable, "-c", BUILD, json.dumps(COMBOS), str(SEQ),
                           str(BATCH)], capture_output=True, text=True, timeout=600, env=ENV)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("BUILT ")][0]
    return {(r["arch"], r["kind"]): r for r in json.loads(line[len("BUILT "):])}


@pytest.mark.parametrize("arch,kind,impl", COMBOS)
def test_build_on_a_fake_mesh(built, arch, kind, impl):
    rec = built[(arch, kind)]
    assert rec["flops"] > 0 and rec["peak"] > 0
    assert rec["outputs"] == (3 if kind == "train" else 2)
    # a train step reduces its gradients over data: an all-reduce or a
    # reduce-scatter of the partial sums
    if kind == "train":
        assert rec["coll_by_kind"]["all-reduce"] + rec["coll_by_kind"]["reduce-scatter"] > 0
    if impl == "dropping":  # the expert-parallel combine's sum over model
        assert rec["coll_by_kind"]["all-reduce"] > 0


@pytest.mark.parametrize("arch,kind,impl", COMBOS)
def test_argument_bytes_equal_reference_specs(built, arch, kind, impl):
    cfg = jregistry.get(arch).reduced()
    if impl:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl=impl))
    shape = jshapes.InputShape(kind, SEQ, BATCH, kind)
    mesh = _stand_in((2, 4), ("data", "model"))
    assert built[(arch, kind)]["arg_bytes"] == reference_arg_bytes(cfg, shape, mesh)


def test_production_combo_through_the_command_line(tmp_path):
    """mamba2-370m decode_32k on the (16, 16) production mesh, a fake
    group of 256 ranks: the record has the reference's keys, the report
    reads it, and its arguments' bytes are the reference specs' sum."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2-370m",
         "--shape", "decode_32k", "--mesh", "single", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=600, env=ENV)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "done: ok=1 skipped=0 errors=0" in proc.stdout
    rec = json.loads((tmp_path / "mamba2-370m__decode_32k__pod16x16.json").read_text())
    want_keys = {"arch", "shape", "mesh", "status", "chips", "lower_s", "compile_s", "cost",
                 "memory", "roofline", "hlo_bytes_len", "elapsed_s"}
    assert want_keys <= set(rec) and set(rec) - want_keys == {"notes"}
    assert rec["status"] == "ok" and rec["chips"] == 256
    row = rec["roofline"]
    assert set(row) == {"arch", "shape", "mesh", "chips", "compute_s", "memory_s",
                        "collective_s", "dominant", "hlo_flops", "hlo_bytes", "coll_bytes",
                        "coll_by_kind", "model_flops", "useful_ratio", "bytes_per_chip"}
    mesh = _stand_in((16, 16), ("data", "model"))
    cfg, shape = jregistry.get("mamba2-370m"), jshapes.ALL_SHAPES["decode_32k"]
    assert rec["memory"]["argument_size_in_bytes"] == reference_arg_bytes(cfg, shape, mesh)
    assert rec["memory"]["bytes_per_chip"] == row["bytes_per_chip"] > rec["memory"][
        "argument_size_in_bytes"]
    recs = jreport.load_records(str(tmp_path))
    assert jreport.summary(recs) == {"ok": 1, "skipped": 0, "error": 0}
    assert "| mamba2-370m | decode_32k |" in jreport.roofline_table(recs)
    # a second run reads the record back instead of running again
    again = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2-370m",
         "--shape", "decode_32k", "--mesh", "single", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=120, env=ENV)
    assert again.returncode == 0 and "done: ok=1" in again.stdout
