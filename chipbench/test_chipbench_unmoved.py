"""Routing the harness through the configuration's model moved nothing:
at a test's size (16 particles x 4 generations, each configuration's
camera scaled down) each configuration's inputs, kept pixels, work
counts, compared numbers and reader values equal, bit for bit, the values
the harness gave before the model was a file of its own (frozen below
from that harness, on the CPU)."""

import dataclasses
import hashlib

import pytest
import torch

from chipbench import check, harness, loadgen, manifest, trace
from chipbench.context import Context
from chipbench.control import ControlStep
from chipbench.test_chipbench_faults import _small

# each configuration at its own camera scaled to a test's size: 128x128 at
# fx 110 to 32x32, 640x480 at fx 575 to 32x24 (the fault tests' camera)
CAMERAS = {"hand128.cam30": {"width": 32, "height": 32, "fx": 27.5, "fy": 27.5,
                             "cx": 15.5, "cy": 15.5},
           "kinect-vga.cam30": {"width": 32, "height": 24, "fx": 28.75, "fy": 28.75,
                                "cx": 15.5, "cy": 11.5}}
SEED = 2**31 + 29
FRAMES = 12
CPU = torch.device("cpu")

FROZEN = {
    "hand128.cam30": {
        "digests": {"depth": "434b6611a70f2f04259a925761cfee71106fe112918fdc9efdcc99f05c728c9d",
                    "truth": "fe043636f986e7eb7f1a2cec830d04ecb143846acd13e9eb48f2f00bfa7ba451",
                    "pool": "73eda2a259edb61af4500bbd45cc5174608cc4acc275364962cf8ddcfc5d0e87"},
        "poses": "879ac0c31de06341114502ebd424f550e652d16b08afe6ab8822d5213b169367",
        "kept": [48, 49, 50, 53, 50, 47, 45, 50, 48, 46, 44, 46],
        "k1_ops": [1862400, 1901200, 1940000, 2056400, 1940000, 1823600, 1746000, 1940000,
                   1862400, 1784800, 1707200, 1784800],
        "frame_ops": [2102400, 2141200, 2180000, 2296400, 2180000, 2063600, 1986000, 2180000,
                      2102400, 2024800, 1947200, 2024800],
        "compared": {"score_gap": 2.1606683731079102e-07, "optimum_gap": 1.1175870895385742e-07,
                     "optimum_gap_mean": -3.119930624961853e-08},
        "readers": {"k1_roofline": 0.6767847509440748, "frame_mfu": 0.010288230976266211},
    },
    "kinect-vga.cam30": {
        "digests": {"depth": "e697cd77102c4dafdf26c42f4657cdee92ad7b455a2e91379ae63c1f00af43dc",
                    "truth": "fe043636f986e7eb7f1a2cec830d04ecb143846acd13e9eb48f2f00bfa7ba451",
                    "pool": "4442bd86ffded49237ad32cdaf057a77c47a9ebc0263f6f87a63698232098953"},
        "poses": "958654f7e5da99623fa17d8ee1930e1155c3a54f5e761ba878487db96e6f1cba",
        "kept": [47, 52, 52, 52, 47, 48, 48, 50, 48, 45, 44, 48],
        "k1_ops": [1823600, 2017600, 2017600, 2017600, 1823600, 1862400, 1862400, 1940000,
                   1862400, 1746000, 1707200, 1862400],
        "frame_ops": [2063600, 2257600, 2257600, 2257600, 2063600, 2102400, 2102400, 2180000,
                      2102400, 1986000, 1947200, 2102400],
        "compared": {"score_gap": 2.7939677238464355e-07, "optimum_gap": 7.636845111846924e-08,
                     "optimum_gap_mean": 4.190951585769653e-09},
        "readers": {"k1_roofline": 0.6907390757058083, "frame_mfu": 0.010367343609819755},
    },
}


def _sha(t) -> str:
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def _cell(name):
    cell = _small(name)
    return dataclasses.replace(cell, config={**cell.config, "camera": CAMERAS[name]})


def _run(name):
    """The cell at the test size: its inputs, and FRAMES frames of its mix
    answered by the model's reference in float32."""
    cell = _cell(name)
    cfg = cell.model.frame_config(cell.config)
    depth, truth, pool = harness.make_inputs(cell, cfg, SEED, CPU)
    load = loadgen.Load(ControlStep(cell.model, cfg, CPU, torch.float32), cell.traffic, depth,
                        truth, pool)
    frames = load.run(None, frames=FRAMES, paced=False)
    return cell, cfg, (depth, truth, pool), frames


@pytest.mark.parametrize("name", CAMERAS)
def test_inputs_and_kept_pixels_unmoved(name):
    cell, cfg, (depth, truth, pool), frames = _run(name)
    frozen = FROZEN[name]
    assert {"depth": _sha(depth), "truth": _sha(truth), "pool": _sha(pool)} == frozen["digests"]
    poses = hashlib.sha256(b"".join(f.h_next.tobytes() for f in frames)).hexdigest()
    assert poses == frozen["poses"]
    assert harness.kept_pixels(cell.model, cfg, frames, depth) == frozen["kept"]


@pytest.mark.parametrize("name", CAMERAS)
def test_work_counts_unmoved(name):
    cell = _cell(name)
    cfg = cell.model.frame_config(cell.config)
    frozen = FROZEN[name]
    assert [cell.model.k1_ops(cfg, k) for k in frozen["kept"]] == frozen["k1_ops"]
    assert [cell.model.frame_ops(cfg, k) for k in frozen["kept"]] == frozen["frame_ops"]


@pytest.mark.parametrize("name", CAMERAS)
def test_compared_numbers_unmoved(name):
    cell, cfg, (depth, _, pool), frames = _run(name)
    values = check.numbers(frames, depth, pool, cell.model, cell.model.Reference(cfg, CPU))
    assert values == FROZEN[name]["compared"]


@pytest.mark.parametrize("name", CAMERAS)
def test_reader_values_unmoved(name):
    cell = _cell(name)
    cfg = cell.model.frame_config(cell.config)
    kept = FROZEN[name]["kept"]
    frames = [loadgen.Frame(0, i, 0, 0, None, None, 0.0, 0.0, 0.0, 0.0, 0.25 + 0.01 * i)
              for i in range(FRAMES)]
    segment = trace.Segment(frames[:2], [trace.Op("render_score_kernel", 100, 4100),
                                         trace.Op("pso_update_kernel", 4100, 4200),
                                         trace.Op("render_score_kernel", 5000, 9300)],
                            [], 0, 10000)
    ctx = Context(cfg, cell.model, frames, 0.0, 1.0, 1.0, kept=kept, segment=segment,
                  segment_kept=kept[:2], peaks={"fp32_flops_per_s": 67e12})
    readers = FROZEN[name]["readers"]
    assert {m: manifest.reader("per_layer", m)(ctx) for m in readers} == readers
