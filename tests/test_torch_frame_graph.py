"""The frame that the port captures into one CUDA graph, held on the CPU.

The card captures ``tracker._frame`` once and replays it a call, reading
its inputs from static buffers (``tracker.FrameInputs``).  Here, where
there is no card: the frame run on those buffers, filled by in-place
copies, equals the eager step bit for bit over chained frames; the eager
step equals the reference's stage composition on the reference's draws;
no op of the frame reads a device value on the host or makes a shape
that depends on one (what a capture forbids); the CPU refuses a capture;
and a caller's ``h`` survives the next frame.  The graph itself is held
on the card by ``tests/test_torch_frame_graph_gpu.py``.

Tolerance against the reference: 1e-5 (rtol and atol), as
``tests/test_torch_pso.py`` holds states after several generations.
"""

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import pso as jpso
from repro.core import tracker as jtracker
from repro.core.camera import Camera as JCamera
from repro_torch.core import pso as tpso
from repro_torch.core import tracker as ttracker
from repro_torch.core.camera import Camera as TCamera
from repro_torch.data import rgbd as trgbd

CPU = torch.device("cpu")
CAM_ARGS = dict(width=64, height=64, fx=60.0, fy=60.0, cx=31.5, cy=31.5)
N, GENS, D = 16, 3, 27
FRAMES = 4  # the first is the start pose, 3 are tracked
# Ops that read a device value on the host, or whose output shape depends
# on one: a CUDA graph cannot capture them.
HOST_READS = ("aten::_local_scalar_dense", "aten::item", "aten::nonzero",
              "aten::masked_select", "aten::unique", "aten::_unique", "aten::argwhere",
              "aten::repeat_interleave", "aten::equal", "aten::is_nonzero")


def _cfg(use_kernel=False):
    return ttracker.TrackerConfig(camera=TCamera(**CAM_ARGS),
                                  pso=tpso.PSOConfig(num_particles=N, num_generations=GENS),
                                  use_kernel=use_kernel)


@pytest.fixture(scope="module")
def clip():
    seq = trgbd.SequenceConfig(camera=TCamera(**CAM_ARGS), num_frames=FRAMES,
                               noise_std=0.001, fast_burst=(100, 101))
    return trgbd.render_sequence(seq, device=CPU)


def _draws(seed):
    """Draws of the reference's shapes: ((u_pos, u_vel), [(r1, r2)] a
    generation), each (N, D) float32."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(1 + GENS, 2, N, D)).astype(np.float32)
    return (u[0, 0], u[0, 1]), [(u[g, 0], u[g, 1]) for g in range(1, 1 + GENS)]


def _as_tensors(draws):
    spawn, gens = draws
    return (tuple(torch.from_numpy(u) for u in spawn),
            [tuple(torch.from_numpy(u) for u in g) for g in gens])


@pytest.mark.parametrize("draws_as", ["arrays", "tensors"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_frame_on_static_buffers_equals_eager_step(clip, use_kernel, draws_as):
    """Three chained frames: the frame body on FrameInputs' buffers (the
    captured graph's inputs, filled by in-place copies) gives the eager
    step's h and score bit for bit, its draws read through the flat
    buffer's views."""
    frames, truth = clip
    cfg = _cfg(use_kernel)
    eager = ttracker.make_track_frame(cfg, "cpu")
    inputs = None
    h_eager = h_static = truth[0]
    for t in range(1, FRAMES):
        draws = _draws(seed=t)
        if draws_as == "tensors":
            draws = _as_tensors(draws)
        if inputs is None:
            inputs = ttracker.FrameInputs(cfg, CPU, frames[t].shape, draws)
        h_eager, s_eager = eager(None, h_eager, frames[t], draws=draws)
        inputs.load(h_static, frames[t].numpy(), draws)
        h_static, s_static = inputs.run(None)
        assert torch.equal(h_static, h_eager), t
        assert torch.equal(s_static, s_eager), t
        assert torch.isfinite(h_static).all() and h_static.shape == (D,)


def _reference_draws(key):
    """The uniforms the reference's ``init_swarm`` and ``swarm_step`` draw
    from a frame's ``key``, in their order and as ``draws``."""
    key, kpos, kvel = jax.random.split(key, 3)
    spawn = tuple(np.array(jax.random.uniform(k, (N, D))) for k in (kpos, kvel))
    gens = []
    for _ in range(GENS):
        key, k1, k2, _ = jax.random.split(key, 4)
        gens.append(tuple(np.array(jax.random.uniform(k, (N, D))) for k in (k1, k2)))
    return spawn, gens


def test_eager_step_matches_reference_stage_composition(clip):
    """The eager step (the graph's body) on the reference's draws against
    the reference's jitted frame, its four stages composed, on the same
    key, frame by frame."""
    frames, truth = clip
    jcfg = jtracker.TrackerConfig(camera=JCamera(**CAM_ARGS),
                                  pso=jpso.PSOConfig(num_particles=N, num_generations=GENS))
    ref_step = jtracker.make_track_frame(jcfg)
    step = ttracker.make_track_frame(_cfg(), "cpu")
    for t in range(1, FRAMES):
        key = jax.random.PRNGKey(t)
        h_prev, depth = truth[t - 1].numpy(), frames[t].numpy()
        h_ref, s_ref = ref_step(key, h_prev, depth)
        h, s = step(None, h_prev, depth, draws=_reference_draws(key))
        np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(s), float(s_ref), rtol=1e-5, atol=1e-5)


class _Census(TorchDispatchMode):
    """Every op dispatched, and the boolean-mask indexing among them (a
    gather whose size depends on the mask's values)."""

    def __init__(self):
        super().__init__()
        self.ops, self.bool_indexing = set(), []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name()
        self.ops.add(name)
        if name.startswith(("aten::index", "aten::_index_put")) and len(args) > 1:
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in (args[1] if isinstance(args[1], (list, tuple)) else ())):
                self.bool_indexing.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("with_draws", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_frame_is_capture_safe(clip, use_kernel, with_draws):
    """No op of one frame (drawn from a generator, or given its draws;
    through the kernel wrappers or the plain objective) reads a device
    value on the host or has a data-dependent shape."""
    frames, truth = clip
    inputs = ttracker.FrameInputs(_cfg(use_kernel), CPU, frames[1].shape,
                                  _draws(0) if with_draws else None)
    inputs.load(truth[0], frames[1], _draws(0) if with_draws else None)
    with _Census() as census:
        h, _ = inputs.run(torch.Generator().manual_seed(0))
    assert torch.isfinite(h).all()
    assert len(census.ops) > 10
    read = sorted(op for op in census.ops if op.startswith(HOST_READS))
    assert not read, f"the frame runs {read}, which a CUDA graph cannot capture"
    assert not census.bool_indexing, f"boolean-mask indexing: {census.bool_indexing}"
    assert ("aten::rand.generator" in census.ops) != with_draws


def test_capture_on_the_cpu_raises():
    with pytest.raises(ValueError, match="CUDA device"):
        ttracker.make_track_frame(_cfg(), "cpu", capture=True)
    for capture in (None, False):  # the eager step
        assert not isinstance(ttracker.make_track_frame(_cfg(), "cpu", capture=capture),
                              ttracker.FrameGraphs)


def test_static_inputs_refuse_other_shapes(clip):
    """The buffers are a frame's shape: a depth, h or draws of another
    shape, or the other mode, raises instead of being reshaped."""
    frames, truth = clip
    inputs = ttracker.FrameInputs(_cfg(), CPU, frames[1].shape, _draws(0))
    with pytest.raises(ValueError, match="depth has shape"):
        inputs.load(truth[0], frames[1][:32], _draws(0))
    with pytest.raises(ValueError, match="h_prev has shape"):
        inputs.load(truth[0][:7], frames[1], _draws(0))
    spawn, gens = _draws(0)
    with pytest.raises(ValueError, match="draws of shapes"):
        inputs.load(truth[0], frames[1], (spawn, gens[:-1]))
    with pytest.raises(ValueError, match="given its draws"):
        inputs.load(truth[0], frames[1], None)


def test_callers_h_survives_the_next_frame(clip):
    """The h a caller keeps from frame t is unchanged after frame t + 1,
    through the eager step and through the static buffers, and no output
    aliases a buffer."""
    frames, truth = clip
    cfg = _cfg(use_kernel=True)
    eager = ttracker.make_track_frame(cfg, "cpu")
    inputs = ttracker.FrameInputs(cfg, CPU, frames[1].shape, _draws(1))
    for run in ("eager", "static"):
        h, kept = truth[0], []
        for t in range(1, FRAMES):
            if run == "eager":
                h, s = eager(None, h, frames[t], draws=_draws(t))
            else:
                inputs.load(h, frames[t], _draws(t))
                h, s = inputs.run(None)
                buffers = (inputs.h_prev, inputs.depth, inputs.flat)
                assert all(h.data_ptr() != b.data_ptr() for b in buffers)
            kept.append((h, h.clone(), s, s.clone()))
        for h, h_copy, s, s_copy in kept:
            assert torch.equal(h, h_copy) and torch.equal(s, s_copy), run
