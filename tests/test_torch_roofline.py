"""The port's roofline layer against the reference's: the op census
(``roofline.op_cost``, the counterpart of ``hlo_cost``), ``flops_of_fn``
against ``flops_of_jaxpr``, the report and its tables, and the copy
guard on ``report``.

The census counts what one device runs.  Its restatement of
``tests/test_roofline.py``'s loop checks and the sharded matmul run on a
fake process group in a subprocess, so that no other test meets it.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs import shapes as jshapes
from repro.core import handmodel as jhm
from repro.core import objective as jobj
from repro.core import stages as jstages
from repro.core.camera import Camera as JCamera
from repro.roofline import analysis as janalysis
from repro.roofline import report as jreport
from repro_torch.configs import registry as tregistry
from repro_torch.configs import shapes as tshapes
from repro_torch.core import objective as tobj
from repro_torch.core import stages as tstages
from repro_torch.core.camera import Camera as TCamera
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline import op_cost
from repro_torch.roofline import report as treport
from test_roofline import dryrun_dir  # noqa: F401  (the reference's record fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]

CENSUS = r"""
import json
import torch, torch.distributed as dist
from torch.distributed import _functional_collectives as funcol
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.roofline import op_cost

out = {}
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
group = dist.group.WORLD
a, w = torch.ones(8, 16), torch.ones(16, 16) / 16

def loop(a, w):
    for _ in range(10):  # the reference's while loop, known_trip_count 10
        a = funcol.all_reduce(a @ w, "sum", group).wait()
    return a

_, cost = op_cost.op_cost(loop, a, w)
out["loop"] = [cost.flops, cost.coll_bytes, cost.coll_by_kind]
dist.destroy_process_group()

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
mesh = init_device_mesh("cpu", (16,), mesh_dim_names=("model",))
x = DTensor.from_local(torch.ones(64, 256), mesh, (Replicate(),), run_check=False)
w = DTensor.from_local(torch.ones(256, 1024 // 16), mesh, (Shard(1),), run_check=False,
                       shape=(256, 1024), stride=(1024, 1))
y, cost = op_cost.op_cost(torch.matmul, x, w)
out["sharded"] = [cost.flops, list(y.to_local().shape), cost.coll_bytes]
dist.destroy_process_group()
print("CENSUS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def census():
    proc = subprocess.run([sys.executable, "-c", CENSUS], capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("CENSUS ")][0]
    return json.loads(line[len("CENSUS "):])


def test_loop_dot_flops(census):
    # one dot: 2 * 8*16 out * 16 contract = 4096 flops, x10 iterations
    assert census["loop"][0] == 4096 * 10


def test_loop_collective_bytes(census):
    # all-reduce of f32[8,16] = 512 B, x10 iterations
    _, coll, by_kind = census["loop"]
    assert coll == 512 * 10
    assert by_kind["all-reduce"] == 5120
    assert sorted(by_kind) == sorted(janalysis._COLLECTIVE_KINDS)


def test_sharded_matmul_counts_one_device(census):
    """Above a DTensor the matmul shows its global (64,256)@(256,1024); the
    census counts the local product, 1/16 of it, and no collective."""
    flops, local_shape, coll = census["sharded"]
    assert local_shape == [64, 1024 // 16]
    assert flops == 2 * 64 * 256 * 1024 / 16
    assert coll == 0


def _cases():
    rng = np.random.default_rng(0)
    a, b = rng.random(1000, dtype=np.float32), rng.random(1000, dtype=np.float32)
    m1, m2 = rng.random((64, 128), dtype=np.float32), rng.random((128, 32), dtype=np.float32)
    return {
        "matmul": (lambda x, y: x @ y, lambda x, y: x @ y, (m1, m2)),
        "a*b+a": (lambda x, y: x * y + x, lambda x, y: x * y + x, (a, b)),
        "minimum": (jnp.minimum, torch.minimum, (a, b)),
        "sqrt": (jnp.sqrt, torch.sqrt, (a,)),
    }


@pytest.mark.parametrize("case", ["matmul", "a*b+a", "minimum", "sqrt"])
def test_flops_of_fn_equals_flops_of_jaxpr(case):
    jfn, tfn, args = _cases()[case]
    want = jstages.flops_of_jaxpr(jfn, *map(jnp.asarray, args))
    got = tstages.flops_of_fn(tfn, *map(torch.from_numpy, args))
    assert got == want
    assert want == {"matmul": 524288.0, "a*b+a": 2000.0, "minimum": 1000.0, "sqrt": 0.0}[case]


def test_sqrt_counts_transcendentals():
    _, cost = op_cost.op_cost(torch.sqrt, torch.ones(1000))
    assert cost.flops == 0 and cost.transcendentals == 1000


def test_population_evaluation_flops_within_ten_percent():
    """The plain objective at 24x24 with 8 particles: the reference's
    compiled count is 3,898,744; the census of the port's plain version
    came to 3,573,519 (ratio 0.9166) when this test was written.  XLA
    fuses and rewrites some elementwise work the eager ops spell out, and
    the other way round, so the two differ by a few percent."""
    cam = dict(width=24, height=24, fx=22.0, fy=22.0, cx=11.5, cy=11.5)
    jcam, tcam = JCamera(**cam), TCamera(**cam)
    h0 = jhm.default_pose(0.45)
    depth = jobj.render_depth(h0, jcam)
    lo, hi = jhm.parameter_lower_bounds(h0), jhm.parameter_upper_bounds(h0)
    hs = lo + jax.random.uniform(jax.random.PRNGKey(0), (8, 27)) * (hi - lo)
    want = jstages.flops_of_jaxpr(lambda h: jobj.batched_objective(h, depth, jcam), hs)
    d_o = torch.from_numpy(np.array(depth))
    got = tstages.flops_of_fn(lambda h: tobj.batched_objective(h, d_o, tcam),
                              torch.from_numpy(np.array(hs)))
    assert want == 3898744.0
    assert abs(got / want - 1) < 0.10, got / want


# --- analysis and report ---

REF_CHIP = tanalysis.Chip("TPU v5e (the reference's constants)", janalysis.PEAK_FLOPS,
                          janalysis.HBM_BW, janalysis.ICI_BW)


@pytest.mark.parametrize("arch", jregistry.list_archs())
def test_model_flops_for_equals_reference(arch):
    for name, shape in jshapes.ALL_SHAPES.items():
        assert (tanalysis.model_flops_for(tregistry.get(arch), tshapes.ALL_SHAPES[name])
                == janalysis.model_flops_for(jregistry.get(arch), shape))


def test_report_row_equals_reference_under_its_constants():
    fields = dict(arch="gemma-2b", shape="train_4k", mesh="pod16x16", chips=256,
                  hlo_flops=3.1e14, hlo_bytes=2.2e12, coll_bytes=4.5e10,
                  coll_by_kind={"all-gather": 4.0e10, "all-reduce": 5.0e9},
                  model_flops=1.5e16, bytes_per_chip=9.0e9)
    want = janalysis.RooflineReport(**fields)
    got = tanalysis.RooflineReport(**fields, chip=REF_CHIP)
    assert got.row() == want.row()
    assert got.step_time_s == want.step_time_s
    h100 = tanalysis.RooflineReport(**fields)
    assert h100.chip == tanalysis.H100_SXM
    assert h100.compute_s == fields["hlo_flops"] / 989e12
    assert h100.row().keys() == want.row().keys()


def test_analyze_reads_the_census():
    cfg, shape = tregistry.get("gemma-2b"), tshapes.ALL_SHAPES["decode_32k"]
    cost = op_cost.OpCost(1e12, 2e11, 3e9, {"all-reduce": 3e9, "all-gather": 0.0})
    rep = tanalysis.analyze(cfg, shape, "pod16x16", 256, cost, {"bytes_per_chip": 5})
    assert (rep.hlo_flops, rep.hlo_bytes, rep.coll_bytes) == (1e12, 2e11, 3e9)
    assert rep.coll_by_kind == {"all-reduce": 3000000000, "all-gather": 0}
    assert rep.bytes_per_chip == 5 and rep.dominant == "memory"


def test_report_tables_equal_reference(dryrun_dir):  # noqa: F811
    recs = treport.load_records(dryrun_dir)
    assert recs == jreport.load_records(dryrun_dir)
    assert treport.summary(recs) == jreport.summary(recs)
    for mesh in ("pod16x16", "pod2x16x16"):
        assert treport.roofline_table(recs, mesh) == jreport.roofline_table(recs, mesh)
    assert treport.dryrun_table(recs) == jreport.dryrun_table(recs)


def _code(path):
    """A module's syntax tree without its docstrings, ``repro_torch``
    imports read as ``repro`` and the port's record directory as the
    reference's."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.Constant) and node.value == "experiments/dryrun_torch":
            node.value = "experiments/dryrun"
    return ast.dump(tree)


@pytest.mark.parametrize("path", ["roofline/report.py"])
def test_copied_modules_differ_only_in_prose(path):
    assert _code(REPO / "src" / "repro_torch" / path) == _code(REPO / "src" / "repro" / path)
