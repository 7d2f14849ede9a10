"""What a metric's reader is handed: the run's measurements, read-only."""

from __future__ import annotations

import dataclasses
from types import ModuleType
from typing import List, Optional

from chipbench.loadgen import Frame
from chipbench.trace import Segment


@dataclasses.dataclass(frozen=True)
class Context:
    cfg: object  # the model's frame configuration
    model: ModuleType  # the cell's model (chipbench/models/), which counts the work
    frames: List[Frame]  # the measured window's, unprofiled
    start: float  # the window on the host clock: the first frame's due time
    end: float  # the last pose on the host
    setup_s: float  # process start to the window's start
    kept: Optional[List[int]] = None  # kept pixels of each window frame (traced runs)
    segment: Optional[Segment] = None  # the profiled frames (traced runs)
    segment_kept: Optional[List[int]] = None  # kept pixels of each profiled frame
    peaks: Optional[dict] = None  # this card's row of peaks.json, if it has one
