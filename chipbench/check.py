"""The comparison that decides ``correct``.

After the window has closed, a sample of its frames, drawn from the
seed, is judged against the plain reference of the configuration's
model (``chipbench/models/``), on the device, in the configuration's
precision.  For each sampled frame the reference takes what the client
handed the program (the previous pose, the depth map, the frame's
draws) and what the program answered (the new pose h_next and its
score):

* ``score_gap``: |score - E_D(g)|, where g is the swarm's best pose that
  the program's last step turned into h_next (``solution_of``) and
  E_D the reference's objective on the frame.  The program's score claims
  to be E_D of its best pose; this holds it to that, whatever path its
  search took.
* ``optimum_gap``: E_D(g) - E_D of the reference's own best pose, found
  by the reference's whole frame on the same inputs and draws.  It says
  how much worse the program's answer is than the reference's; rounding
  may send the two searches down different paths, so it is not 0.

``score_gap`` and ``optimum_gap`` are the worst over the sample, and
``optimum_gap_mean`` is ``optimum_gap``'s mean over it.  Where the two
searches part, either may end the better, so a sound program's mean
lies near 0; a search cut short ends worse on nearly every frame, each
by less than a sound run's worst, which only the mean catches.  A
non-finite answer, or a non-finite number, fails.
"""

from __future__ import annotations

import math
import random
import statistics
from typing import Dict, List, Sequence, Tuple

import torch

from chipbench.loadgen import Frame


def sample(frames: Sequence[Frame], count: int, seed: int) -> List[Frame]:
    """``count`` of the frames (all, if fewer), drawn from the seed."""
    ordered = sorted(frames, key=lambda f: (f.client, f.index))
    if len(ordered) <= count:
        return ordered
    return random.Random(seed).sample(ordered, count)


def numbers(frames: Sequence[Frame], depth: torch.Tensor, pool: torch.Tensor,
            model, ref) -> Dict[str, float]:
    """The compared numbers over ``frames``; ``ref`` is ``model``'s
    ``Reference``."""
    score_gaps, optimum_gaps = [], []
    for f in frames:
        h_prev = torch.as_tensor(f.h_prev, device=depth.device)
        h_next = torch.as_tensor(f.h_next, device=depth.device)
        d = depth[f.clip_index]
        _, ref_score = ref.frame(h_prev, d, pool[f.draw_index])
        e_prog = float(ref.score(model.solution_of(ref.cfg, h_next, h_prev), h_prev, d))
        score_gaps.append(abs(f.score - e_prog))
        optimum_gaps.append(e_prog - float(ref_score))
    if not all(math.isfinite(x) for x in score_gaps + optimum_gaps):
        return dict.fromkeys(("score_gap", "optimum_gap", "optimum_gap_mean"), math.nan)
    return {"score_gap": max(score_gaps), "optimum_gap": max(optimum_gaps),
            "optimum_gap_mean": statistics.fmean(optimum_gaps)}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(every number finite and within its limit, {name: {value, limit}})."""
    compared = {name: {"value": values[name], "limit": limits[name]} for name in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    return ok, compared


def nonfinite_answers(frames: Sequence[Frame]) -> int:
    """How many frames answered with a pose or a score that is not finite."""
    bad = 0
    for f in frames:
        bad += not (math.isfinite(f.score) and all(math.isfinite(x) for x in f.h_next))
    return bad
