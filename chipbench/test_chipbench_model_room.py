"""A configuration of another tracker model is added as new files: a root
that holds the benchmark's files as they are, plus a stand-in model of
another shape (one sphere, 4 parameters) with its own plain reference,
clip, mask rule and counts, its configuration, limits and traffic mix,
and the cell's entries in ``BENCHMARK.json``.  The harness runs it on
the CPU with no file of ``chipbench/`` edited: the stand-in's own
reference in the program's place is correct, a step that answers with
the state it was given is not."""

import hashlib
import json
import pathlib
import shutil
import time

import torch

from chipbench import harness, manifest
from chipbench.context import Context
from chipbench.control import ControlStep

ROOT = pathlib.Path(__file__).resolve().parents[1]

# One sphere (x, y, z, radius) under the particle swarm: its frame, its
# objective (the mean clamped depth error over the pixels within
# half_width of the previous pose's depth) and a clip of it circling.
MODEL = '''
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    width: int
    height: int
    focal: float
    num_particles: int
    num_generations: int
    inertia: float
    cognitive: float
    social: float
    box: float
    smoothing: float
    half_width: float
    clamp_t: float
    background: float

    @property
    def draws_shape(self):
        return (1 + self.num_generations, 2, self.num_particles, 4)


def frame_config(config):
    return FrameConfig(**config["camera"], **config["pso"], **config["tracker"],
                       **config["sphere"])


def rays(cfg, device, dtype=torch.float32):
    u = (torch.arange(cfg.width, dtype=dtype, device=device) - cfg.width / 2) / cfg.focal
    v = (torch.arange(cfg.height, dtype=dtype, device=device) - cfg.height / 2) / cfg.focal
    gu, gv = torch.meshgrid(u, v, indexing="xy")
    return torch.stack([gu, gv, torch.ones_like(gu)], dim=-1).reshape(-1, 3)


def sphere_depth(rays, h, background):
    """Depth along each ray (P, 3) of the spheres h (..., 4) -> (..., P)."""
    c, r = h[..., None, :3], h[..., None, 3]
    dc = torch.sum(rays * c, dim=-1)
    d2 = torch.sum(rays * rays, dim=-1)
    disc = dc * dc - d2 * (torch.sum(c * c, dim=-1) - r * r)
    t = (dc - torch.sqrt(torch.clamp(disc, min=0.0))) / d2
    return torch.where((disc >= 0) & (t > 1e-4), t, background)


def make_clip(traffic, cfg, generator):
    clip = traffic["clip"]
    device = generator.device
    phase = torch.arange(clip["num_frames"], dtype=torch.float32, device=device) / 6.0
    truth = torch.stack([0.03 * torch.sin(phase), 0.02 * torch.cos(phase),
                         0.5 + 0.02 * torch.sin(0.5 * phase), torch.full_like(phase, 0.1)], -1)
    depth = sphere_depth(rays(cfg, device), truth, cfg.background)
    depth = depth + clip["noise_std"] * torch.randn(depth.shape, generator=generator,
                                                    device=device)
    return depth.reshape(-1, cfg.height, cfg.width), truth


def kept_pixels(cfg, depth, h_prev):
    box = torch.abs(depth - h_prev[..., 2, None, None]) < cfg.half_width
    return box.flatten(-2).sum(-1)


class Reference:
    def __init__(self, cfg, device, dtype=torch.float32):
        self.cfg, self.dtype = cfg, dtype
        self.rays = rays(cfg, device, dtype)

    def _objective(self, h_prev, depth):
        c = self.cfg
        depth = depth.reshape(-1).to(self.dtype)
        keep = torch.abs(depth - h_prev[2].to(self.dtype)) < c.half_width
        rays, depth, count = self.rays[keep], depth[keep], max(int(keep.sum()), 1)

        def score(h):
            err = torch.abs(sphere_depth(rays, h, c.background) - depth)
            return torch.sum(torch.clamp(err, max=c.clamp_t), dim=-1) / count
        return score

    def frame(self, h_prev, depth, draws):
        c = self.cfg
        h_prev, draws = h_prev.to(self.dtype), draws.to(self.dtype)
        score = self._objective(h_prev, depth)
        lo, hi = h_prev - c.box, h_prev + c.box
        u_pos, u_vel = draws[0]
        x = torch.cat([h_prev[None], (lo + u_pos * (hi - lo))[1:]])
        v = (u_vel - 0.5) * (hi - lo) * 0.1
        pbest, pscore = x, score(x)
        best = torch.argmin(pscore)
        for r1, r2 in draws[1:]:
            v = (c.inertia * v + c.cognitive * r1 * (pbest - x)
                 + c.social * r2 * (pbest[best][None] - x))
            x = torch.minimum(torch.maximum(x + v, lo), hi)
            s = score(x)
            better = s < pscore
            pbest = torch.where(better[:, None], x, pbest)
            pscore = torch.where(better, s, pscore)
            best = torch.argmin(pscore)
        return (1.0 - c.smoothing) * pbest[best] + c.smoothing * h_prev, pscore[best]

    def score(self, h, h_prev, depth):
        return self._objective(h_prev.to(self.dtype), depth)(h.to(self.dtype))


def solution_of(cfg, h_next, h_prev):
    return (h_next.double() - cfg.smoothing * h_prev.double()) / (1.0 - cfg.smoothing)


def k1_ops(cfg, kept):
    return (1 + cfg.num_generations) * cfg.num_particles * kept * 15


def frame_ops(cfg, kept):
    return k1_ops(cfg, kept) + (1 + cfg.num_generations) * cfg.num_particles * 4
'''

# The stand-in's program: only what ``harness.build_step`` builds from the
# configuration's entry.  Each test puts a step of its own in its place.
PROGRAM = '''
import dataclasses


@dataclasses.dataclass(frozen=True)
class Camera:
    width: int
    height: int
    focal: float


@dataclasses.dataclass(frozen=True)
class PSO:
    num_particles: int
    num_generations: int
    inertia: float
    cognitive: float
    social: float


@dataclasses.dataclass(frozen=True)
class Config:
    camera: Camera
    pso: PSO
    box: float
    smoothing: float


def make_step(cfg, device):
    def step(generator, h_prev, depth, draws):
        raise NotImplementedError("the test puts a step in the program's place")
    return step
'''

CONFIG = {
    "name": "sphere-24x16", "source": "a test's stand-in", "precision": "float32",
    "model": "one_sphere",
    "entry": {"step": "sphere_program:make_step", "config": "sphere_program:Config",
              "groups": {"camera": "sphere_program:Camera", "pso": "sphere_program:PSO"}},
    "camera": {"width": 24, "height": 16, "focal": 30.0},
    "pso": {"num_particles": 8, "num_generations": 3, "inertia": 0.7298, "cognitive": 1.49618,
            "social": 1.49618},
    "tracker": {"box": 0.02, "smoothing": 0.15},
    "sphere": {"half_width": 0.25, "clamp_t": 0.3, "background": 10.0},
}
LIMITS = {"score_gap": 1e-4, "optimum_gap": 1e-4, "optimum_gap_mean": 1e-5}
TRAFFIC = {"clients": 1, "arrival": "periodic", "rate_hz": 30.0,
           "clip": {"num_frames": 12, "noise_std": 0.001},
           "draw_pool": 4, "warmup_frames": 2, "profile_frames": 2, "check_frames": 8}
CELL = "sphere.cam30"


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _room(tmp_path, monkeypatch):
    """The root with the stand-in added as files and entries; the stand-in
    program on the path.  Returns (root, the digests of the files that
    were there before)."""
    root = tmp_path / "root"
    shutil.copytree(ROOT / "chipbench", root / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digest(root)
    pkg = root / "chipbench"
    (pkg / "models/one_sphere.py").write_text(MODEL)
    (pkg / "configs/sphere-24x16.json").write_text(json.dumps(CONFIG))
    (pkg / "limits/sphere-24x16.json").write_text(json.dumps(LIMITS))
    (pkg / "traffic/sphere30.json").write_text(json.dumps(TRAFFIC))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sphere-24x16", "source": "a test's stand-in",
                             "file": "chipbench/configs/sphere-24x16.json", "reduced": [],
                             "why": "one sphere of 4 parameters"})
    bench["workloads"].append({"name": CELL, "config": "sphere-24x16", "traffic": "sphere30",
                               "chips": 1, "why": "one camera at 30 Hz on the stand-in"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "hand128.cam30" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    program = tmp_path / "program"
    program.mkdir()
    (program / "sphere_program.py").write_text(PROGRAM)
    monkeypatch.syspath_prepend(str(program))
    return root, before


def _run(cell, wrap):
    return harness.run_cell(cell, 2**31 + 41, 0.4, False, torch.device("cpu"),
                            time.perf_counter(), wrap=wrap)


def test_a_model_of_another_shape_is_added_as_files(tmp_path, monkeypatch):
    root, before = _room(tmp_path, monkeypatch)
    cell = manifest.load_cell(CELL, root)
    assert cell.model.__file__ == str(root / "chipbench/models/one_sphere.py")
    cfg = cell.model.frame_config(cell.config)
    assert cfg.draws_shape == (4, 2, 8, 4)
    assert {m["name"] for m in cell.end_to_end} == {"frame_p50_ms", "frame_p95_ms", "setup_s"}

    reference = ControlStep(cell.model, cfg, "cpu", torch.float32)
    sound = _run(cell, lambda step: reference)
    assert sound["correct"], sound["compared"]
    assert sound["attempted"] >= 12 and set(sound["metrics"]) == {"frame_p50_ms", "frame_p95_ms",
                                                                 "setup_s"}
    first = []

    def unchanged(gen, h_prev, depth, draws):
        if not first:
            first.append(reference(gen, h_prev, depth, draws)[1])
        return h_prev.clone(), first[0].clone()
    assert not _run(cell, lambda step: unchanged)["correct"]

    after = _digest(root)
    assert {p for p in before if before[p] != after.get(p)} == {pathlib.Path("BENCHMARK.json")}


def test_the_readers_count_the_stand_ins_work(tmp_path, monkeypatch):
    root, _ = _room(tmp_path, monkeypatch)
    cell = manifest.load_cell(CELL, root)
    cfg = cell.model.frame_config(cell.config)
    frames = [type("F", (), {"service_ms": 0.5})()] * 2
    ctx = Context(cfg, cell.model, frames, 0.0, 1.0, 1.0, kept=[100, 120],
                  peaks={"fp32_flops_per_s": 1e12})
    ops = 4 * 8 * (100 + 120) * 15 + 2 * 4 * 8 * 4
    assert manifest.reader("per_layer", "frame_mfu", root)(ctx) == 100.0 * ops / 1e12 / 1e-3
