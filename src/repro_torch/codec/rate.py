"""Rate control: per-client codec operating points in the fleet.

A fixed codec wastes the trade space: when the scene barely moves the
delta frames are nearly empty (ship fewer keyframes), and when the
link degrades the client should trade depth fidelity for headroom
(fewer quantizer bits) rather than drop frames.  The
:class:`RateController` closes that loop per client, deterministically,
from two signals the fleet already produces:

* **scene motion** — the frame-to-frame pose delta of the tracked
  hand (``motion_profile`` over a ``data.rgbd`` ground-truth
  trajectory; wrist translation is the component that actually drags
  tiles across the depth map).  Motion maps to an estimated tile
  change density through a linear model calibrated against measured
  densities (:func:`calibrate_density_map` renders the sequence and
  regresses; the defaults are its output for the stock sequence), and
  density picks the keyframe interval — long intervals only pay when
  deltas are sparse.
* **link pressure** — an EWMA of the relative excess of observed leg
  latencies over what the client's plan charged (the same draws the
  drift detector watches).  Sustained excess escalates down the
  ``bits_ladder``: coarser depth on the wire buys latency headroom.

Every operating-point switch is a re-plan through the shared
``PlanCache`` — the :class:`~repro_torch.codec.model.CodecModel` is part of
the cache key, so clients at the same point share one plan and a
switch is a miss by construction.  Estimated densities snap to
``density_bins`` (ceiling) to keep the reachable key set small.

Hysteresis: a new point must survive ``min_dwell_frames`` since the
last switch, so jittery links cannot flap the codec frame to frame.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.codec.model import BITS_RAW, CodecModel, IDENTITY
from repro_torch.codec.ref import PACKABLE_BITS

# Linear motion -> change-density map, calibrated by
# ``calibrate_density_map`` on the stock ``data.rgbd`` sequence
# (least squares of measured per-transition tile density on wrist
# translation magnitude).
DEFAULT_DENSITY_GAIN = 4.0
DEFAULT_DENSITY_FLOOR = 0.145


def motion_profile(truth) -> Tuple[float, ...]:
    """Per-transition wrist-translation magnitude |Δposition| of a
    (T, 27) ground-truth trajectory — the scene-motion signal."""
    import numpy as np

    t = np.asarray(truth)
    return tuple(
        float(x) for x in np.linalg.norm(np.diff(t[:, :3], axis=0), axis=1)
    )


def sequence_motion(seq_cfg=None) -> Tuple[float, ...]:
    """Motion profile of a ``data.rgbd`` sequence config (the stock
    "pre-recorded video" when none is given)."""
    from repro_torch.data import rgbd

    cfg = seq_cfg if seq_cfg is not None else rgbd.SequenceConfig()
    return motion_profile(rgbd.truth_trajectory(cfg))


def calibrate_density_map(
    seq_cfg=None,
    *,
    threshold: float = 0.0,
    block_h: int = 8,
    block_w: int = 32,
    device="cuda",
) -> Tuple[float, float]:
    """Fit ``density ~= gain * motion + floor`` by least squares against
    densities measured by the delta encoder on the rendered sequence.
    Returns ``(gain, floor)``, the source of the module defaults.  The
    sequence renders and its densities are measured on ``device`` (K3b
    on the card); the fit is numpy on the host."""
    import numpy as np

    from repro_torch.codec import wire
    from repro_torch.data import rgbd

    cfg = seq_cfg if seq_cfg is not None else rgbd.SequenceConfig(
        num_frames=60, noise_std=0.0
    )
    frames, truth = rgbd.render_sequence(cfg, device=device)
    dens = wire.change_density(
        frames, threshold=threshold, block_h=block_h, block_w=block_w
    ).cpu().numpy()
    motion = np.asarray(motion_profile(truth.cpu()))
    a = np.stack([motion, np.ones_like(motion)], axis=1)
    (gain, floor), *_ = np.linalg.lstsq(a, dens, rcond=None)
    return float(gain), float(floor)


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Fleet-level codec arming: the base operating point plus the rate
    controller's ladders and thresholds.

    ``adapt=False`` pins every client to ``base`` forever (the fixed-
    codec and identity/off-switch modes); ``adapt=True`` lets each
    client's :class:`RateController` walk the ladders.  ``base``
    supplies the calibrated per-byte costs, header and payload gate —
    the controller only swaps ``quant_bits`` / ``keyframe_interval`` /
    ``change_density``.
    """

    base: CodecModel
    adapt: bool = True
    # fine -> coarse wire width as link pressure grows
    bits_ladder: Tuple[int, ...] = (16, 8)
    # short -> long keyframe spacing as estimated density falls;
    # density above cuts[i] selects interval_ladder[i] (cuts descend)
    interval_ladder: Tuple[int, ...] = (1, 4, 8, 15)
    density_cuts: Tuple[float, ...] = (0.35, 0.17, 0.10)
    # estimated densities snap UP to these (bounds the plan-cache keys)
    density_bins: Tuple[float, ...] = (0.1, 0.2, 0.4, 1.0)
    pressure_threshold: float = 0.25
    pressure_alpha: float = 0.2
    min_dwell_frames: int = 15
    # per-frame scene motion (cycled when shorter than the run)
    motion: Tuple[float, ...] = ()
    density_gain: float = DEFAULT_DENSITY_GAIN
    density_floor: float = DEFAULT_DENSITY_FLOOR
    # -- shared-cell fairness -------------------------------------------
    # cell_threshold (seconds of smoothed shared-medium wait per ladder
    # step) arms the contention signal: a client queuing on a congested
    # cell escalates down the bits ladder even when its leg draws look
    # clean (medium waits are structurally invisible to the pressure
    # EWMA — they are queueing, not jitter).  inf = off, the exact
    # pressure-only controller.  The EWMA weights each wait sample by
    # the client's CURRENT wire ratio, so the heaviest payload on the
    # cell feels the most pressure and backs off first (self-balancing
    # fairness).  cell_stagger spreads per-client thresholds
    # (thr_i = cell_threshold * (1 + stagger * client_id)) so equal
    # clients shed in a deterministic order instead of oscillating in
    # lockstep.
    cell_threshold: float = float("inf")
    cell_alpha: float = 0.3
    cell_stagger: float = 0.0
    # -- keyframe loss / resync -----------------------------------------
    # resync_bound > 0 couples observed frame drops back into keyframe
    # spacing: when the smoothed drop signal exceeds drop_threshold the
    # keyframe interval is clamped to resync_bound, so a decoder that
    # lost a reference is guaranteed a fresh keyframe within that many
    # frames.  0 = off (exact historical ladder).
    resync_bound: int = 0
    drop_alpha: float = 0.3
    drop_threshold: float = 0.5

    def __post_init__(self) -> None:
        if not self.bits_ladder or not self.interval_ladder:
            raise ValueError("ladders must be non-empty")
        for b in self.bits_ladder:
            if b != BITS_RAW and b not in PACKABLE_BITS:
                raise ValueError(f"quantizer bits {b} not packable")
        if len(self.density_cuts) != len(self.interval_ladder) - 1:
            raise ValueError(
                "need exactly len(interval_ladder) - 1 density cuts"
            )
        if list(self.density_cuts) != sorted(self.density_cuts, reverse=True):
            raise ValueError("density_cuts must descend")
        if not self.density_bins or any(
            b <= 0 for b in self.density_bins
        ) or list(self.density_bins) != sorted(self.density_bins):
            raise ValueError("density_bins must be positive and ascending")
        if self.density_bins[-1] < 1.0:
            # the ceiling snap must always have a bin to land on — a
            # short ladder would silently snap high densities DOWN and
            # underprice the wire
            raise ValueError("density_bins must end at >= 1.0")
        if not 0.0 < self.pressure_alpha <= 1.0:
            raise ValueError("pressure_alpha must be in (0, 1]")
        if self.pressure_threshold <= 0.0:
            raise ValueError("pressure_threshold must be > 0")
        if self.min_dwell_frames < 0:
            raise ValueError("min_dwell_frames must be >= 0")
        if self.cell_threshold <= 0.0:
            raise ValueError("cell_threshold must be > 0 (inf = off)")
        if not 0.0 < self.cell_alpha <= 1.0:
            raise ValueError("cell_alpha must be in (0, 1]")
        if self.cell_stagger < 0.0:
            raise ValueError("cell_stagger must be >= 0")
        if self.resync_bound < 0:
            raise ValueError("resync_bound must be >= 0 (0 = off)")
        if not 0.0 < self.drop_alpha <= 1.0:
            raise ValueError("drop_alpha must be in (0, 1]")
        if self.drop_threshold <= 0.0:
            raise ValueError("drop_threshold must be > 0")


def identity_config() -> CodecConfig:
    """The golden off-switch: every client pinned to the identity
    codec — the fleet must be event-for-event the raw fleet."""
    return CodecConfig(base=IDENTITY, adapt=False)


class RateController:
    """One client's codec operating point over time (deterministic)."""

    def __init__(self, cfg: CodecConfig, client_id: int = 0):
        self.cfg = cfg
        self.client_id = client_id
        self._pressure = 0.0
        # shared-cell wait EWMA, weighted by the current wire ratio
        # (heaviest payload feels the most pressure — see CodecConfig)
        self._cell = 0.0
        # smoothed frame-drop signal: EWMA of (frame-index gap - 1)
        self._drop = 0.0
        self._last_idx: Optional[int] = None
        self._frames_since_switch = 0
        self.switches = 0
        # ladder-transition log, one (frame_idx, old_bits, new_bits)
        # per switch — consumed by the fleet's telemetry (cluster.telemetry)
        self.transitions: list = []
        self.model: CodecModel = (
            cfg.base if not cfg.adapt else self._operating_point(0)
        )

    # -- signal mapping -----------------------------------------------------

    def _motion_at(self, frame_idx: int) -> float:
        m = self.cfg.motion
        return m[frame_idx % len(m)] if m else 0.0

    def _density_at(self, frame_idx: int) -> float:
        c = self.cfg
        est = c.density_floor + c.density_gain * self._motion_at(frame_idx)
        return min(max(est, 0.0), 1.0)

    def _binned(self, density: float) -> float:
        for b in self.cfg.density_bins:
            if density <= b:
                return b
        return self.cfg.density_bins[-1]

    def _interval_for(self, density: float) -> int:
        c = self.cfg
        interval = c.interval_ladder[-1]
        for i, cut in enumerate(c.density_cuts):
            if density > cut:
                interval = c.interval_ladder[i]
                break
        if c.resync_bound > 0 and self._drop > c.drop_threshold:
            # a lossy stream needs fresh references: clamp keyframe
            # spacing so the decoder resyncs within the bound
            interval = min(interval, c.resync_bound)
        return interval

    def _bits_for(self) -> int:
        c = self.cfg
        idx = int(self._pressure / c.pressure_threshold)
        if c.cell_threshold != float("inf"):
            if self._cell > 0.0:
                thr = c.cell_threshold * (
                    1.0 + c.cell_stagger * self.client_id
                )
                idx += int(self._cell / thr)
            # AIMD asymmetry: escalating coarser is immediate (the cell
            # is congested NOW), but recovery toward finer bits moves
            # one rung per switch — a client that backs off stops
            # feeling the cell (its weighted samples shrink with its
            # ratio), so unbounded recovery would slam the whole cohort
            # back to the finest point in lockstep and flap the cell.
            cur = getattr(self, "model", None)
            if cur is not None and cur.quant_bits in c.bits_ladder:
                cur_idx = c.bits_ladder.index(cur.quant_bits)
                if idx < cur_idx:
                    idx = cur_idx - 1
        return c.bits_ladder[min(max(idx, 0), len(c.bits_ladder) - 1)]

    def _operating_point(self, frame_idx: int) -> CodecModel:
        density = self._density_at(frame_idx)
        return dataclasses.replace(
            self.cfg.base,
            quant_bits=self._bits_for(),
            keyframe_interval=self._interval_for(density),
            change_density=self._binned(density),
        )

    # -- the loop -----------------------------------------------------------

    def observe(
        self, frame_idx: int, observed, plan, cell_wait: float = 0.0
    ) -> Optional[CodecModel]:
        """Feed one processed frame's observed leg draws (the same
        tuples the drift detector sees) against the plan that charged
        them.  Returns the new :class:`CodecModel` when the operating
        point switches, else None.

        ``cell_wait`` is the frame's shared-medium queue delay (0.0 on
        private spokes): contention is queueing, not jitter, so it never
        reaches the leg draws — this side channel is the only way the
        controller can see a congested cell.  The sample is weighted by
        the client's current wire ratio before entering the cell EWMA,
        so heavier payloads back off first.
        """
        if not self.cfg.adapt:
            return None
        charged = sum(leg.latency for leg in plan.legs)
        if charged > 0.0 and observed:
            drawn = sum(draw for _, draw in observed)
            excess = max(drawn / charged - 1.0, 0.0)
            a = self.cfg.pressure_alpha
            self._pressure = a * excess + (1.0 - a) * self._pressure
        if self.cfg.cell_threshold != float("inf"):
            ca = self.cfg.cell_alpha
            sample = cell_wait * self.model.ratio
            self._cell = ca * sample + (1.0 - ca) * self._cell
        if self.cfg.resync_bound > 0:
            gap = (
                frame_idx - self._last_idx - 1
                if self._last_idx is not None
                else 0
            )
            self._last_idx = frame_idx
            da = self.cfg.drop_alpha
            self._drop = da * gap + (1.0 - da) * self._drop
        self._frames_since_switch += 1
        proposal = self._operating_point(frame_idx)
        if (
            proposal != self.model
            and self._frames_since_switch >= self.cfg.min_dwell_frames
        ):
            self.transitions.append(
                (frame_idx, self.model.quant_bits, proposal.quant_bits)
            )
            self.model = proposal
            self._frames_since_switch = 0
            self.switches += 1
            return proposal
        return None
