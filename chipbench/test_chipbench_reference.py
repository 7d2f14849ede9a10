"""The benchmark's frozen copies held against the program they were copied
from, on the CPU: forward kinematics, the clip, and the whole frame on
given draws at a reduced camera.  The tests may import the program; the
copies may not."""

import numpy as np
import pytest
import torch

from chipbench import clip
from chipbench.reference import frame, hand, render
from repro_torch.core import camera as pcamera
from repro_torch.core import handmodel, objective, pso, tracker
from repro_torch.data import rgbd

CAM = render.Camera(32, 24, 28.75, 28.75, 15.5, 11.5)
CLIP = clip.ClipConfig(12, 0.5, 0.06, 0.5, 0.9, (4, 8), 0.002)


def _cfg(particles=16, generations=4):
    return frame.FrameConfig(CAM, particles, generations, 0.7298, 1.49618, 1.49618, 0.5,
                             0.10, 0.25, 0.15, 0.25, 0.30, 10.0)


def _program(cfg):
    return tracker.make_track_frame(tracker.TrackerConfig(
        camera=pcamera.Camera(CAM.width, CAM.height, CAM.fx, CAM.fy, CAM.cx, CAM.cy),
        pso=pso.PSOConfig(cfg.num_particles, cfg.num_generations)), "cpu")


def _random_poses(n, seed):
    gen = torch.Generator().manual_seed(seed)
    h = torch.rand((n, 27), generator=gen) - 0.5
    h[:, 2] += 0.9
    return h


def test_forward_kinematics_equals_the_programs():
    h = _random_poses(40, 0)
    assert torch.equal(hand.spheres(h, hand.geometry("cpu")), handmodel.pack_spheres(h))
    assert torch.equal(hand.normalize_configuration(h), handmodel.normalize_configuration(h))
    lo, hi = hand.search_box(h[0], hand.geometry("cpu"), 0.1, 0.25)
    assert torch.equal(lo, handmodel.parameter_lower_bounds(h[0], 0.1, 0.25))
    assert torch.equal(hi, handmodel.parameter_upper_bounds(h[0], 0.1, 0.25))


def test_render_and_objective_equal_the_programs():
    h = _random_poses(6, 1)
    pcam = pcamera.Camera(CAM.width, CAM.height, CAM.fx, CAM.fy, CAM.cx, CAM.cy)
    rays = CAM.rays("cpu")
    assert torch.equal(rays, pcam.rays_flat("cpu"))
    geo = hand.geometry("cpu")
    assert torch.equal(render.sphere_depth(rays, hand.spheres(h, geo), 10.0),
                       objective.render_depth(h, pcam).reshape(6, -1))
    depth, truth = clip.make_clip(CLIP, CAM, 10.0, torch.Generator().manual_seed(3))
    e = render.Objective(rays, depth[2], truth[1][2], 0.25, 0.30, 10.0)
    mask = objective.bounding_box_mask(depth[2], truth[1][2], 0.25)
    torch.testing.assert_close(e(h, geo), objective.batched_objective(h, depth[2], pcam, mask),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        render.Objective(rays, torch.full_like(depth[2], float("nan")), truth[1][2], 0.25,
                         0.30, 10.0)


def test_clip_equals_the_programs_generator():
    seq = rgbd.SequenceConfig(num_frames=CLIP.num_frames, fast_burst=CLIP.fast_burst,
                              noise_std=0.0)
    assert np.array_equal(clip.truth_trajectory(CLIP), rgbd.truth_trajectory(seq))
    pcam = pcamera.Camera(CAM.width, CAM.height, CAM.fx, CAM.fy, CAM.cx, CAM.cy)
    noiseless = clip.ClipConfig(**{**CLIP.__dict__, "noise_std": 0.0})
    depth, truth = clip.make_clip(noiseless, CAM, 10.0, torch.Generator().manual_seed(0))
    want, _ = rgbd.render_sequence(rgbd.SequenceConfig(
        num_frames=CLIP.num_frames, camera=pcam, fast_burst=CLIP.fast_burst, noise_std=0.0),
        device="cpu")
    assert torch.equal(depth, want)
    noisy, _ = clip.make_clip(CLIP, CAM, 10.0, torch.Generator().manual_seed(0))
    again, _ = clip.make_clip(CLIP, CAM, 10.0, torch.Generator().manual_seed(0))
    assert torch.equal(noisy, again) and not torch.equal(noisy, depth)
    assert [clip.loop_index(i, 4) for i in range(8)] == [0, 1, 2, 3, 2, 1, 0, 1]


@pytest.mark.parametrize("generations", [1, 4])
def test_reference_frame_against_the_programs_eager_frame(generations):
    """Three chained frames on the same given draws: the program's eager
    CPU step and the frozen frame agree (they sum the box's pixels in
    another order, so not bit for bit)."""
    cfg = _cfg(generations=generations)
    ref = frame.Reference(cfg, "cpu")
    step = _program(cfg)
    depth, truth = clip.make_clip(CLIP, CAM, 10.0, torch.Generator().manual_seed(5))
    draws = torch.rand((4, *cfg.draws_shape), generator=torch.Generator().manual_seed(6))
    h = truth[0]
    for t in range(1, 4):
        u = draws[t]
        h_prog, s_prog = step(None, h, depth[t], ((u[0, 0], u[0, 1]), [tuple(g) for g in u[1:]]))
        h_ref, s_ref = ref.frame(h, depth[t], u)
        torch.testing.assert_close(h_ref, h_prog, rtol=0, atol=1e-5)
        torch.testing.assert_close(s_ref, s_prog, rtol=1e-5, atol=1e-7)
        h = h_prog


def test_solution_of_inverts_the_smoothing():
    gen = torch.Generator().manual_seed(7)
    for _ in range(20):
        g = hand.normalize_configuration(_random_poses(1, int(torch.randint(1 << 30, (1,),
                                                                              generator=gen)))[0])
        h_prev = hand.normalize_configuration(_random_poses(1, 99)[0])
        h_next = hand.normalize_configuration(0.85 * g + 0.15 * h_prev)
        torch.testing.assert_close(frame.solution_of(h_next, h_prev, 0.15).float(), g,
                                   rtol=0, atol=2e-6)


def test_the_frame_refuses_what_it_does_not_compute():
    cfg = {"camera": CAM.__dict__, "tracker": {"pos_range": 0.1, "quat_range": 0.25,
                                               "smoothing": 0.15, "bbox_half_width": 0.25},
           "pso": {"num_particles": 8, "num_generations": 2, "inertia": 0.7, "cognitive": 1.5,
                   "social": 1.5, "velocity_clip": 0.5, "restart_fraction": 0.0},
           "hand": {"num_params": 27, "num_spheres": 48, "clamp_t": 0.3,
                    "background_depth": 10.0}}
    assert frame.FrameConfig.from_file(cfg).draws_shape == (3, 2, 8, 27)
    with pytest.raises(ValueError):
        frame.FrameConfig.from_file({**cfg, "pso": {**cfg["pso"], "restart_fraction": 0.1}})
    with pytest.raises(ValueError):
        frame.FrameConfig.from_file({**cfg, "hand": {**cfg["hand"], "num_spheres": 40}})
    with pytest.raises(ValueError):
        frame.Reference(frame.FrameConfig.from_file(cfg), "cpu").frame(
            torch.zeros(27), torch.zeros(CAM.height, CAM.width), torch.zeros(2, 2, 8, 27))
