"""On the card, at the cells' own sizes: a short run of the program is
correct, and the control (the reference in bfloat16 in the program's
place) and the program's search cut to two thirds of its generations
are not.  ``readings.py`` makes the readings the limits were set
from; this keeps the separation as a test."""

import time

import pytest
import torch

from chipbench import harness, manifest
from chipbench.control import ControlStep


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["hand128.cam30", "kinect-vga.edge16"])
def test_program_correct_and_control_not_on_the_card(card, name):
    cell = manifest.load_cell(name)
    program = harness.run_cell(cell, 2**31 + 5, 2.0, False, card, time.perf_counter())
    assert program["correct"], program["compared"]
    control = ControlStep(cell.model, cell.model.frame_config(cell.config), card)
    broken = harness.run_cell(cell, 2**31 + 6, 2.0, False, card, time.perf_counter(),
                              wrap=lambda step: control)
    assert not broken["correct"], broken["compared"]
    generations = cell.config["pso"]["num_generations"] * 2 // 3
    cut = harness.run_cell(cell, 2**31 + 7, 2.0, False, card, time.perf_counter(),
                           wrap=lambda step: harness.truncated_step(cell.config, card, generations))
    assert not cut["correct"], cut["compared"]
