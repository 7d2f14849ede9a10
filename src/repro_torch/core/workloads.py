"""Named multi-model workloads: branching stage-DAGs with distinct
compute/payload profiles.

Every real hand-tracking deployment this repo models after runs a
*family* of pipelines, not one: mediapipe-style trackers chain palm
detection into per-hand landmark models with a conditional re-detect
edge, gesture heads hang off the landmark features, and RGBD trackers
carry an order of magnitude more payload than RGB ones.  This registry
gives the fleet a vocabulary of such pipelines so `run_fleet` can admit
*mixed* traffic (``workloads=...`` cycles clients across them) and the
DAG-aware planner has real branching structure to exploit.

Each constructor returns a fresh :class:`StagedComputation`:

* ``solo_landmark``  — RGB single-hand: detect -> landmark.  A linear
  chain (the ``chain_dp`` planner's domain), lightest compute.
* ``multi_hand``     — RGB two-hand out-tree: palm detection fans out
  to per-hand landmark branches (the second hand present on a fraction
  of frames) plus a rare, expensive full-frame re-detect branch.  The
  ``tree_dp`` planner's domain.
* ``full_gesture``   — landmark chain with a gesture-classifier branch
  riding the landmark features; the pose result ships home from the
  *middle* of the graph, which already breaks the chain planner.
* ``rgbd_tracking``  — the paper-style RGBD pipeline: heavy 537.6 kB
  depth frames, the previous pose consumed by two stages (residency
  sharing), and a rare global re-seed branch joining from an earlier
  stage output — a true DAG, the planners' general-case fallback.

Conditional branches are priced at expected cost through
``Stage.exec_prob`` (see ``core.costengine``); ``linearized()`` on any
of these forces every branch unconditional — the baseline arm of
``fleet_bench --mixed``.

Byte sizes: RGB frames are 320x240x3 (230,400 B), RGBD frames reuse the
paper's 537,600 B acquisition size, ROI crops are 128x128 patches.
FLOP counts are sized against ``sim.hardware.paper_staged`` (~22 GFLOP
per frame) so the same fleet stars saturate at comparable client
counts.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from repro_torch.core.stages import CLIENT, DataItem, Stage, StagedComputation

# RGB camera frame: 320 x 240 x 3 channels
RGB_FRAME_BYTES = 320 * 240 * 3
# RGBD acquisition, the paper's wire size (320 x 240 x (3 + 2B depth))
RGBD_FRAME_BYTES = 537_600
# 128 x 128 x 3 ROI crop handed to a landmark model
ROI_BYTES = 128 * 128 * 3
# 21 landmarks x (x, y, z) float32 + handedness score
LANDMARKS_BYTES = 21 * 3 * 4 + 4

# branch execution probabilities (mediapipe-style tracking loop):
# the second hand is in frame well under half the time, re-detection
# fires only on tracking loss, the gesture head runs when a hand is
# confidently tracked
P_SECOND_HAND = 0.4
P_REDETECT = 0.12
P_GESTURE = 0.8
P_RESEED = 0.08


def solo_landmark() -> StagedComputation:
    """RGB single-hand landmark pipeline — a linear chain."""
    sources = (DataItem("frame", RGB_FRAME_BYTES, CLIENT),)
    stages = (
        Stage(
            name="detect",
            flops=2.6e9,
            inputs=("frame",),
            outputs=(DataItem("roi", ROI_BYTES),),
            parallel_fraction=0.96,
        ),
        Stage(
            name="landmark",
            flops=5.2e9,
            inputs=("roi",),
            outputs=(DataItem("lm", LANDMARKS_BYTES),),
            parallel_fraction=0.97,
        ),
    )
    return StagedComputation("solo_landmark", sources, stages, ("lm",))


def multi_hand() -> StagedComputation:
    """RGB two-hand out-tree: palm detect fans out per hand, plus a
    rare full-frame re-detect branch (fires on tracking loss)."""
    sources = (DataItem("frame", RGB_FRAME_BYTES, CLIENT),)
    stages = (
        Stage(
            name="palm_detect",
            flops=6.0e9,
            inputs=("frame",),
            outputs=(
                DataItem("roi_l", ROI_BYTES),
                DataItem("roi_r", ROI_BYTES),
                DataItem("det_map", 24 * 32 * 4),
            ),
            parallel_fraction=0.96,
        ),
        Stage(
            name="landmark_l",
            flops=4.4e9,
            inputs=("roi_l",),
            outputs=(DataItem("lm_l", LANDMARKS_BYTES),),
            parallel_fraction=0.97,
        ),
        Stage(
            name="landmark_r",
            flops=4.4e9,
            inputs=("roi_r",),
            outputs=(DataItem("lm_r", LANDMARKS_BYTES),),
            parallel_fraction=0.97,
            exec_prob=P_SECOND_HAND,
        ),
        Stage(
            name="redetect",
            flops=7.5e9,
            inputs=("det_map",),
            outputs=(DataItem("redet_box", 4 * 4),),
            parallel_fraction=0.95,
            exec_prob=P_REDETECT,
        ),
    )
    return StagedComputation(
        "multi_hand", sources, stages, ("lm_l", "lm_r", "redet_box")
    )


def full_gesture() -> StagedComputation:
    """Landmark chain with a gesture head riding the features; the pose
    result leaves the graph mid-chain (tree, not chain, territory)."""
    sources = (DataItem("frame", RGB_FRAME_BYTES, CLIENT),)
    stages = (
        Stage(
            name="detect",
            flops=2.6e9,
            inputs=("frame",),
            outputs=(DataItem("roi", ROI_BYTES),),
            parallel_fraction=0.96,
        ),
        Stage(
            name="landmark",
            flops=5.2e9,
            inputs=("roi",),
            outputs=(
                DataItem("lm", LANDMARKS_BYTES),
                DataItem("feat", 128 * 4),
            ),
            parallel_fraction=0.97,
        ),
        Stage(
            name="gesture",
            flops=3.2e9,
            inputs=("feat",),
            outputs=(DataItem("g_label", 16),),
            parallel_fraction=0.94,
            exec_prob=P_GESTURE,
        ),
    )
    return StagedComputation(
        "full_gesture", sources, stages, ("lm", "g_label")
    )


def rgbd_tracking() -> StagedComputation:
    """Paper-style RGBD pipeline: heavy frames, the previous pose
    consumed twice, a rare global re-seed joining from an early output
    — a general DAG (neither chain nor out-tree)."""
    sources = (
        DataItem("frame_rgbd", RGBD_FRAME_BYTES, CLIENT),
        DataItem("h_prev", 108, CLIENT),
    )
    stages = (
        Stage(
            name="preprocess",
            flops=1.4e8,
            inputs=("frame_rgbd", "h_prev"),
            outputs=(DataItem("roi_d", 96 * 96 * 2),),
            parallel_fraction=0.6,
        ),
        Stage(
            name="optimize",
            flops=9.5e9,
            inputs=("roi_d",),
            outputs=(DataItem("pose_raw", 21_368),),
            parallel_fraction=0.98,
        ),
        Stage(
            name="refine",
            flops=2.4e8,
            inputs=("pose_raw", "h_prev"),
            outputs=(DataItem("h_next", 108),),
            parallel_fraction=0.3,
        ),
        Stage(
            name="reseed",
            flops=6.0e9,
            inputs=("roi_d",),
            outputs=(DataItem("seed_box", 4 * 4),),
            parallel_fraction=0.95,
            exec_prob=P_RESEED,
        ),
    )
    return StagedComputation(
        "rgbd_tracking", sources, stages, ("h_next", "seed_box")
    )


# constructor registry, insertion order = the default mixed-traffic cycle
WORKLOADS: Dict[str, Callable[[], StagedComputation]] = {
    "solo_landmark": solo_landmark,
    "multi_hand": multi_hand,
    "full_gesture": full_gesture,
    "rgbd_tracking": rgbd_tracking,
}

# workload name -> SLO class name (resolved by the reference's
# repro.cluster.slo, which owns the SLOClass definitions — kept as
# strings here so the core registry stays import-free of the cluster
# layer).  The tracking
# pipelines are *interactive*: a user's hand is on screen and the paper's
# real-time deadline applies.  The gesture head is *best-effort*
# analytics riding the same features — late labels degrade gracefully.
WORKLOAD_SLO: Dict[str, str] = {
    "solo_landmark": "interactive",
    "multi_hand": "interactive",
    "full_gesture": "best_effort",
    "rgbd_tracking": "interactive",
}


def workload_suite(
    names: Tuple[str, ...] = tuple(WORKLOADS),
) -> Tuple[StagedComputation, ...]:
    """Materialize (and validate) the named workloads, default all."""
    comps = tuple(WORKLOADS[n]() for n in names)
    for c in comps:
        c.validate()
    return comps
