"""Simulated real-time clock and frame-drop accounting (paper Fig. 3).

"A real-time framerate of 30 fps means that every frame acquired by a
camera has to be consumed/processed in less than 33 milliseconds" — and
because the tracker has a serial frame dependency (category A in Fig. 3),
a loop slower than the acquisition period forces frames to be *dropped*:
"for a hypothetical slower 150 ms processing loop time, the system must
skip processing two consecutive frames for each received frame".

``FrameLoop`` replays exactly that accounting: frames arrive on a fixed
period; the client is busy for each frame's loop time; frames that arrive
while busy are discarded except the most recent one (the tracker always
wants the freshest observation). It reports achieved fps, drop counts and
the *gap* distribution — the number of acquisition periods between
consecutively processed frames, which is what widens the PSO search space
and degrades tracking under slow loops.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Optional

CAMERA_FPS = 30.0
FRAME_PERIOD = 1.0 / CAMERA_FPS
FRAME_BUDGET = FRAME_PERIOD  # the 33 ms real-time budget


@dataclasses.dataclass
class FrameEvent:
    index: int  # camera frame index
    arrival: float  # arrival wall-clock time
    start: float  # processing start
    finish: float  # processing finish
    gap: int  # camera periods since the previously processed frame


@dataclasses.dataclass
class LoopStats:
    processed: List[FrameEvent]
    total_frames: int
    duration: float

    @property
    def achieved_fps(self) -> float:
        if not self.processed or self.duration <= 0:
            return 0.0
        return len(self.processed) / self.duration

    @property
    def dropped(self) -> int:
        return self.total_frames - len(self.processed)

    @property
    def drop_rate(self) -> float:
        return self.dropped / max(self.total_frames, 1)

    @property
    def mean_gap(self) -> float:
        gaps = [e.gap for e in self.processed[1:]]
        return sum(gaps) / len(gaps) if gaps else 1.0

    def loop_times(self) -> List[float]:
        """Per-processed-frame loop times (finish - start).  A method
        rather than inline comprehensions at the call sites so array-
        backed stats (the reference's ``fastfleet.ArrayLoopStats``) can compute them
        without materializing ``FrameEvent`` objects."""
        return [e.finish - e.start for e in self.processed]

    @property
    def mean_loop_time(self) -> float:
        times = self.loop_times()
        return sum(times) / len(times) if times else 0.0

    @property
    def realtime(self) -> bool:
        return self.mean_loop_time <= FRAME_BUDGET


class FrameLoop:
    """Drive a serially-dependent per-frame step against a 30 Hz camera.

    ``loop_time_fn(frame_index, gap) -> seconds`` supplies the processing
    time of each frame (from the offload cost model, possibly jittered;
    the ``gap`` argument lets callers model search-space widening after
    drops — a larger gap needs a larger optimization budget).
    """

    def __init__(self, camera_fps: float = CAMERA_FPS):
        self.period = 1.0 / camera_fps

    def run(
        self,
        loop_time_fn: Callable[[int, int], float],
        num_frames: int,
    ) -> LoopStats:
        events: List[FrameEvent] = []
        t = 0.0  # client free at time t
        last_processed = -1
        i = 0
        while i < num_frames:
            arrival = i * self.period
            start = max(arrival, t)
            # Frames arriving while busy are superseded: jump to the
            # newest frame available at `start`.
            newest = min(int(start / self.period), num_frames - 1)
            if newest > i:
                i = newest
                arrival = i * self.period
                start = max(arrival, t)
            gap = i - last_processed
            loop_time = loop_time_fn(i, gap)
            finish = start + loop_time
            events.append(FrameEvent(i, arrival, start, finish, gap))
            last_processed = i
            t = finish
            i += 1
        duration = events[-1].finish if events else 0.0
        return LoopStats(events, num_frames, duration)
