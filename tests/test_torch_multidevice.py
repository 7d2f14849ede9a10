"""The port's multi-device path on two CPU processes (gloo), against the
JAX reference.

One spawn of two ranks, joined through a ``FileStore`` in the test's
temporary directory (no TCP port: several test workers run at once), runs
every check and writes its results; the reference's side is computed here.
It restates on the port the three checks of the reference's
``test_sharded_tracker_on_8_fake_devices``, and adds the expert-parallel
MoE combine, the data-parallel train step and ``restore`` by placements:

* ``pso.sharded_eval`` on a (1, 2) mesh against the reference's
  ``objective.batched_objective`` at rtol 2e-5 / atol 1e-6 (that test's
  tolerance);
* ``make_track_frame_sharded`` (24x24, 8 particles, 2 generations) on the
  reference's draws equal, bit for bit, to the port's unsharded step on
  the same draws, with an all-gather in its census and a finite score;
* the combine on reduced qwen3-moe (4 experts, dropping dispatch, model
  2) within 1e-5 of the reference's meshless ``moe_forward``;
* ``build_train_step`` on a (2, 1) data mesh over 3 steps against the
  reference's jitted step, within ``test_torch_train``'s bounds;
* ``checkpoint.io.restore`` by (mesh, specs): every leaf's shard is its
  slice of the saved tensor, bit for bit.
"""

import dataclasses
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
from repro.core import handmodel as jhm
from repro.core import objective as jobj
from repro.core.camera import Camera as JCamera
from repro.launch import train as jtrain
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import io as tckpt
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw as tadamw
from test_torch_models import reference_params, to_numpy
from test_torch_train import _check_state, _pipe

REPO = pathlib.Path(__file__).resolve().parents[1]
CAM = dict(width=24, height=24, fx=22.0, fy=22.0, cx=11.5, cy=11.5)
N, GENS, STEPS = 8, 2, 3
TIMEOUT = 300

WORKER = r"""
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed import FileStore
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.checkpoint import io as ckpt
from repro_torch.configs import registry
from repro_torch.core import objective, pso, tracker
from repro_torch.core.camera import Camera
from repro_torch.launch import mesh as lmesh, train
from repro_torch.models import moe, transformer
from repro_torch.optim import adamw
from repro_torch.roofline import op_cost
from repro_torch.sharding import specs

store_path, rank, world, io = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
dist.init_process_group("gloo", store=FileStore(store_path, world), rank=rank, world_size=world)
CPU = torch.device("cpu")
inp = np.load(f"{io}/inputs.npz")
out, res = {}, {}
t = lambda name: torch.from_numpy(inp[name])

# 1-2: the particle axis over 'model' on a (1, 2) mesh
pmesh = lmesh.make_host_mesh(1, 2, device_type="cpu")
cam = Camera(**json.loads(str(inp["camera"])))
depth = t("depth")
local_eval = lambda hs: objective.batched_objective(hs, depth, cam)
out["sharded_scores"] = pso.sharded_eval(local_eval, pmesh, "model")(t("hs")).numpy()

cfg = tracker.TrackerConfig(camera=cam, pso=pso.PSOConfig(num_particles=int(inp["n"]),
                                                         num_generations=int(inp["gens"])))
draws = ((inp["u_pos"], inp["u_vel"]),
         [(inp[f"r1_{g}"], inp[f"r2_{g}"]) for g in range(int(inp["gens"]))])
h_prev = t("h_prev")
with op_cost.OpCounter() as census:
    h1, s1 = tracker.make_track_frame_sharded(cfg, pmesh, "model", device=CPU)(
        None, h_prev, depth, draws=draws)
h0, s0 = tracker.make_track_frame(cfg, device=CPU)(None, h_prev, depth, draws=draws)
out.update(h_sharded=h1.numpy(), score_sharded=s1.numpy(), h_local=h0.numpy(),
           score_local=s0.numpy())
res["tracker_census"] = census.cost().coll_by_kind

# 3: the expert-parallel combine, experts over 'model'
mcfg = registry.get("qwen3-moe-30b-a3b").reduced()
mcfg = dataclasses.replace(mcfg, moe=dataclasses.replace(mcfg.moe, impl="dropping"))
# (the rules key on the path: a 'moe' node above the expert weights)
template = {"moe": {k: torch.empty(inp[f"moe_{k}_shape"].tolist())
                    for k in ("router", "w_gate", "w_up", "w_down")}}
mparams = ckpt.restore(f"{io}/moe", 0, template, shardings={
    "moe": (pmesh, specs.param_specs(template, pmesh)["moe"])})["moe"]
res["moe_placements"] = {k: str(v.placements) for k, v in mparams.items()}
x = specs.distribute(t("moe_x"), specs.input_specs_tree(t("moe_x"), pmesh), pmesh)
with op_cost.OpCounter() as census, implicit_replication():
    y, aux = moe.moe_forward(mparams, mcfg, x, shard=specs.make_shard_fn(pmesh))
out["moe_y"] = y.full_tensor().numpy()
out["moe_aux"] = aux.full_tensor().numpy() if isinstance(aux, DTensor) else aux.numpy()
res["moe_census"] = census.cost().coll_by_kind

# 4-5: the data-parallel train step on a (2, 1) mesh, from a checkpoint
dmesh = lmesh.make_host_mesh(device_type="cpu")
tcfg = registry.get("gemma-2b").reduced()
shapes = transformer.param_shapes(tcfg)
p_specs = specs.param_specs(shapes, dmesh)
params = ckpt.restore(f"{io}/init", 0, {"params": shapes},
                      shardings={"params": (dmesh, p_specs)})["params"]
full = ckpt.restore(f"{io}/init", 0, {"params": shapes})["params"]
res["restore_bit_equal"] = all(
    torch.equal(a.full_tensor().view(torch.int32), b.view(torch.int32))
    and tuple(a.to_local().shape) == specs.local_shape(tuple(b.shape), p_specs_leaf, dmesh)
    for (_, a), (_, b), (_, p_specs_leaf) in zip(transformer.tree_leaves(params),
                                                 transformer.tree_leaves(full),
                                                 transformer.tree_leaves(p_specs)))
state = adamw.init(params)
step = train.build_train_step(tcfg, adamw.AdamWConfig(), dmesh, adamw.cosine_schedule(300))
metrics = []
for i in range(int(inp["steps"])):
    host = {k[len(f"batch{i}_"):]: inp[k] for k in inp.files if k.startswith(f"batch{i}_")}
    batch = specs.distribute({k: torch.from_numpy(v) for k, v in host.items()},
                             specs.input_specs_tree(host, dmesh), dmesh)
    params, state, m = step(params, state, batch)
    metrics.append({k: float(v.full_tensor() if isinstance(v, DTensor) else v)
                    for k, v in m.items()})
res["train_metrics"] = metrics
res["train_batch_placements"] = str(batch["tokens"].placements)
ckpt.save(f"{io}/final{rank}", int(inp["steps"]), {"params": params, "opt": state})
np.savez(f"{io}/out{rank}.npz", **out)
with open(f"{io}/res{rank}.json", "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def _reference_draws(n, d, gens, seed=0):
    """The uniforms the reference's ``init_swarm`` and ``swarm_step`` draw
    from ``PRNGKey(seed)``, in their order."""
    key = jax.random.PRNGKey(seed)
    key, kpos, kvel = jax.random.split(key, 3)
    out = {"u_pos": jax.random.uniform(kpos, (n, d)), "u_vel": jax.random.uniform(kvel, (n, d))}
    for g in range(gens):
        key, k1, k2, _ = jax.random.split(key, 4)
        out[f"r1_{g}"] = jax.random.uniform(k1, (n, d))
        out[f"r2_{g}"] = jax.random.uniform(k2, (n, d))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    io = tmp_path_factory.mktemp("multidevice")
    inputs, want = {}, {}

    # the population and the frame (the reference test's 24x24 camera)
    jcam = JCamera(**CAM)
    h0 = jhm.default_pose(0.45)
    depth = jobj.render_depth(h0, jcam)
    lo, hi = jhm.parameter_lower_bounds(h0), jhm.parameter_upper_bounds(h0)
    hs = lo + jax.random.uniform(jax.random.PRNGKey(0), (N, 27)) * (hi - lo)
    want["scores"] = np.asarray(jobj.batched_objective(hs, depth, jcam))
    inputs.update(camera=json.dumps(CAM), depth=np.asarray(depth), hs=np.asarray(hs),
                  h_prev=np.asarray(h0.at[0].add(0.02)), n=N, gens=GENS, steps=STEPS,
                  **_reference_draws(N, 27, GENS))

    # the MoE block: reference parameters and input, its meshless output
    jcfg = jregistry.get("qwen3-moe-30b-a3b").reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, impl="dropping"))
    mp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    x = jax.random.normal(jax.random.PRNGKey(4), (2, 16, jcfg.d_model)) * 0.5
    y, aux = jmoe.moe_forward(mp, jcfg, x)
    want.update(moe_y=np.asarray(y), moe_aux=np.asarray(aux))
    tckpt.save(str(io / "moe"), 0, {"moe": to_numpy(mp)})
    inputs["moe_x"] = np.asarray(x)
    inputs.update({f"moe_{k}_shape": np.array(v.shape) for k, v in mp.items()})

    # the train step: reference parameters, 3 batches, the jitted step's states
    jcfg, tcfg, jp, _ = reference_params("gemma-2b-reduced")
    tckpt.save(str(io / "init"), 0, {"params": to_numpy(jp)})
    jstep = jtrain.build_train_step(jcfg, jadamw.AdamWConfig(), None,
                                    jadamw.cosine_schedule(300))
    jinit, js = to_numpy(jp), jadamw.init(jp)
    pipe, metrics = iter(_pipe(tcfg)), []
    for i in range(STEPS):
        batch = next(pipe)
        inputs.update({f"batch{i}_{k}": v for k, v in batch.items()})
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics.append(jm)
    want.update(jp=jp, js=js, jm=metrics, jinit=jinit, tcfg=tcfg)
    np.savez(io / "inputs.npz", **inputs)

    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(io / "store"), str(rank), "2", str(io)],
        env=env, cwd=str(io), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    logs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            logs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = [dict(np.load(io / f"out{r}.npz")) for r in range(2)]
    res = [json.loads((io / f"res{r}.json").read_text()) for r in range(2)]
    return io, want, got, res


def test_sharded_eval_matches_reference(spawned):
    _, want, got, _ = spawned
    for g in got:
        np.testing.assert_allclose(g["sharded_scores"], want["scores"], rtol=2e-5, atol=1e-6)


def test_sharded_tracker_equals_unsharded_step(spawned):
    """Each rank evaluates its 4 of the 8 particles; the plain objective
    scores a particle from its own row alone, so the gathered scores, and
    the whole step, are the unsharded step's bit for bit."""
    _, _, got, res = spawned
    for g, r in zip(got, res):
        assert g["h_sharded"].tobytes() == g["h_local"].tobytes()
        assert g["score_sharded"].tobytes() == g["score_local"].tobytes()
        assert np.isfinite(g["score_sharded"]) and g["h_sharded"].shape == (27,)
        # the scores' all-gather, once an evaluation: (1 + GENS) x N floats
        census = r["tracker_census"]
        assert census["all-gather"] == (1 + GENS) * N * 4
        assert sum(census.values()) == census["all-gather"]
    assert got[0]["h_sharded"].tobytes() == got[1]["h_sharded"].tobytes()


def test_expert_parallel_combine_matches_reference(spawned):
    _, want, got, res = spawned
    for g, r in zip(got, res):
        assert np.abs(g["moe_y"] - want["moe_y"]).max() <= 1e-5
        assert abs(float(g["moe_aux"]) - float(want["moe_aux"])) <= 1e-6
        # the experts over 'model', the partial outputs summed over it
        assert r["moe_placements"]["w_gate"] == "(Replicate(), Shard(dim=0))"
        assert r["moe_census"]["all-reduce"] >= want["moe_y"].nbytes


def test_data_parallel_train_step_matches_reference(spawned):
    io, want, _, res = spawned
    tcfg = want["tcfg"]
    templates = {"params": ttf.param_shapes(tcfg), "opt": tadamw.init(ttf.param_shapes(tcfg))}
    for rank, r in enumerate(res):
        assert r["train_batch_placements"] == "(Shard(dim=0), Replicate())"
        for tm, jm in zip(r["train_metrics"], want["jm"]):
            assert sorted(tm) == sorted(jm)
        back = tckpt.restore(str(io / f"final{rank}"), STEPS, templates)
        tm = {k: torch.tensor(v) for k, v in r["train_metrics"][-1].items()}
        _check_state(back["params"], back["opt"], tm, want["jp"], want["js"], want["jm"][-1],
                     want["jinit"])


def test_restore_places_by_specs(spawned):
    _, _, _, res = spawned
    assert all(r["restore_bit_equal"] for r in res)
