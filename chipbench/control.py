"""The control: the reference put in the program's place, computed in the
precision below the configuration's (bfloat16 below float32: the frame
has no matrix product, so TF32 does not apply).  A check that cannot
tell it from the program is no check; ``readings.py`` runs it and the
tests hold ``correct`` false on it."""

from __future__ import annotations

import torch


class ControlStep:
    """The frame step's call signature, (generator, h_prev, depth, draws)
    -> (h_next, score), on ``model``'s plain frame in ``dtype``."""

    def __init__(self, model, cfg, device: torch.device | str,
                 dtype: torch.dtype = torch.bfloat16):
        self.ref = model.Reference(cfg, device, dtype)

    def __call__(self, generator, h_prev, depth, draws):
        (u_pos, u_vel), gens = draws
        u = torch.stack([torch.stack([u_pos, u_vel])] + [torch.stack(g) for g in gens])
        h, score = self.ref.frame(h_prev, depth, u)
        return h.float(), score.float()
