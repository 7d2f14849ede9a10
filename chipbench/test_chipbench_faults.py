"""The check that decides ``correct`` has to fail a broken program: a run
driven on the CPU (no look for a card) at a size a test can hold, with
the timed path broken underneath, comes out not correct, once for each
fault a cell of this benchmark can have, and the control (the reference
in bfloat16 in the program's place) comes out not correct too.  The
cells run on one card, so there is no exchange between cards to leave
out.  Of the faults, a search cut short ends each frame only a little
worse, which the mean gap over the sample catches and the worst does
not."""

import copy
import dataclasses
import time

import pytest
import torch

from chipbench import harness, manifest
from chipbench.control import ControlStep

CELLS = ("hand128.cam30", "hand128.edge16")
SEED = 2**31 + 11
SECONDS = 0.6  # 18 frames of a periodic mix; at least one round of a closed one


def _small(name):
    """The cell at a test's size: the same limits and code, a 32x24 camera,
    16 particles x 4 generations, 4 clients for a closed loop."""
    cell = manifest.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["camera"] = {"width": 32, "height": 24, "fx": 28.75, "fy": 28.75, "cx": 15.5, "cy": 11.5}
    cfg["pso"].update(num_particles=16, num_generations=4)
    traffic = copy.deepcopy(cell.traffic)
    traffic["clip"]["num_frames"] = 24
    traffic.update(draw_pool=8, warmup_frames=2, check_frames=8,
                   clients=min(traffic["clients"], 4))
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


def _unchanged(cell, step):
    """Answers with the state it was given, and the first frame's score."""
    first = []

    def broken(gen, h_prev, depth, draws):
        if not first:
            first.append(step(gen, h_prev, depth, draws)[1])
        return h_prev.clone(), first[0].clone()
    return broken


def _half_left_out(cell, step):
    """Scores the right half of the image only: the left half's pixels
    are left out of the box, and the mean is taken over the rest."""
    def broken(gen, h_prev, depth, draws):
        depth = depth.clone()
        depth[:, : depth.shape[1] // 2] = 10.0
        return step(gen, h_prev, depth, draws)
    return broken


def _altered(cell, step):
    """Every answer's pose moved 5 mm along x where it is produced."""
    def broken(gen, h_prev, depth, draws):
        h, score = step(gen, h_prev, depth, draws)
        h = h.clone()
        h[0] += 0.005
        return h, score
    return broken


def _cut_short(cell, step):
    """The program's own search on the first two thirds of the
    configuration's generations, as 20 of 30."""
    generations = cell.config["pso"]["num_generations"] * 2 // 3
    return harness.truncated_step(cell.config, "cpu", generations)


def _run(cell, wrap=None):
    return harness.run_cell(cell, SEED, SECONDS, False, torch.device("cpu"), time.perf_counter(),
                            wrap=wrap)


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_program_is_correct(name):
    cell = _small(name)
    result = _run(cell)
    assert result["correct"], result["compared"]
    assert result["attempted"] >= cell.traffic["clients"] and result["failed"] == 0
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _altered, _cut_short],
                         ids=["state_unchanged", "half_left_out", "answer_altered",
                              "search_cut_short"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    cell = _small(name)
    result = _run(cell, wrap=lambda step: fault(cell, step))
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = _small(name)
    control = ControlStep(cell.model, cell.model.frame_config(cell.config), "cpu")
    result = _run(cell, wrap=lambda step: control)
    assert not result["correct"], result["compared"]

