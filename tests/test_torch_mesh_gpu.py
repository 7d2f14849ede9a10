"""The port's multi-device path on one card: a one-rank NCCL group.

This file imports neither JAX nor the reference package, so the card's
machine runs it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_mesh_gpu.py

Elsewhere the tests skip with that reason.  Held, as phase 19 of
``chip_smoke.py`` holds them at full width: ``make_host_mesh()`` on the
card; the sharded tracker bit-equal to the unsharded step on the same
draws, with K1 and K2 run on the card as on the main path (N + 1 and N
a frame of N generations, by the profiler's kernel records); the reduced train step over the one-rank mesh
bit-equal to the meshless step.  The 2-rank checks against the reference
run on the CPU in ``tests/test_torch_multidevice.py``.
"""

import pytest
import torch

from repro_torch.core import pso, tracker
from repro_torch.core.camera import Camera
from repro_torch.data import rgbd
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.kernels import _build
from repro_torch.kernels import pso_update as pu
from repro_torch.kernels import render_score as rs
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import train
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.sharding import specs


@pytest.fixture
def mesh(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1, device_id=device)
    try:
        yield lmesh.make_host_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_host_mesh_on_the_card(mesh):
    assert mesh.device_type == "cuda"
    assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")


@pytest.mark.gpu
def test_sharded_tracker_on_the_card_equals_unsharded(mesh):
    cam = Camera(width=64, height=64, fx=60.0, fy=60.0, cx=31.5, cy=31.5)
    seq = rgbd.SequenceConfig(camera=cam, num_frames=4)
    frames, truth = rgbd.render_sequence(seq, device="cuda")
    cfg = tracker.TrackerConfig(camera=cam, pso=pso.PSOConfig(num_particles=32,
                                                              num_generations=10))
    steps = {"sharded": tracker.make_track_frame_sharded(cfg, mesh, "model", device="cuda"),
             "local": tracker.make_track_frame(cfg, device="cuda")}
    out, runs, launches = {}, {}, {}
    for name, step in steps.items():
        rs.launches = 0
        pu.launches = 0

        def track():
            gen = torch.Generator(device="cuda").manual_seed(0)
            h, got = truth[0], []
            for i in range(1, 4):
                h, score = step(gen, h, frames[i])
                got.append((h, score))
            return got

        out[name], runs[name] = _build.kernel_runs(track, ("render_score_kernel",
                                                           "pso_update_kernel"))
        launches[name] = (rs.launches, pu.launches)
    for (h, s), (hw, sw) in zip(out["sharded"], out["local"]):
        assert torch.equal(h, hw) and torch.equal(s, sw)
    # the sharded frame runs eagerly: each run on the card is a wrapper's
    # launch; the local frame is a graph, run by its warm-up and 3
    # replays, launched by the wrappers in the warm-up and the capture
    assert launches["sharded"] == (3 * 11, 3 * 10)
    assert runs["sharded"] == {"render_score_kernel": 3 * 11, "pso_update_kernel": 3 * 10}
    assert runs["local"] == {"render_score_kernel": 4 * 11, "pso_update_kernel": 4 * 10}
    assert launches["local"] == (2 * 11, 2 * 10)


@pytest.mark.gpu
def test_train_step_over_the_one_rank_mesh_equals_meshless(mesh):
    cfg = train.train_config("gemma-2b", seq=64)
    params = transformer.init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                                     device="cuda")
    placed = specs.distribute(transformer.tree_map(torch.clone, params),
                              specs.param_specs(params, mesh), mesh)
    state, placed_state = adamw.init(params), adamw.init(placed)
    opt_cfg, schedule = adamw.AdamWConfig(lr=1e-3), adamw.cosine_schedule(40)
    step = train.build_train_step(cfg, opt_cfg, None, schedule)
    mesh_step = train.build_train_step(cfg, opt_cfg, mesh, schedule)
    pipe = iter(TokenPipeline(TokenPipelineConfig(cfg.vocab_size, 64, 4, seed=1)))
    for _ in range(2):
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in next(pipe).items()}
        params, state, m = step(params, state, batch)
        placed, placed_state, pm = mesh_step(
            placed, placed_state,
            specs.distribute(batch, specs.input_specs_tree(batch, mesh), mesh))
        assert torch.equal(m["loss"], pm["loss"].full_tensor())
    for (path, got), (_, want) in zip(transformer.tree_leaves(placed),
                                      transformer.tree_leaves(params)):
        assert torch.equal(got.full_tensor(), want), path
