"""The general load generator: it reads a traffic mix's parameters and
drives the program's frame step with them.

A mix names its clients and how their frames arrive:

* ``"arrival": "periodic"``: an open loop at ``rate_hz`` a client, as a
  camera sends.  Each client's frame k is due at t0 + k / rate_hz; the
  loop waits until a frame is due, calls the step, and reads the pose
  back, the one synchronization.  A frame that waits behind a
  late one counts that wait: its latency runs from its due time.
* ``"arrival": "closed"``: every client waits for its pose before it
  sends its next frame, in rounds: a round submits each client's next
  frame through the one step and then reads all the poses with one
  synchronization; the next round starts at once.

Every client tracks the same clip from its own place in the
forward-backward loop, starting from the known pose there, and takes
its frames' PSO draws from a pool made on the device from the seed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from chipbench import clip as clip_mod


@dataclasses.dataclass
class Frame:
    """One frame as the client saw it: what went in, what came back and
    when (host clock, seconds)."""

    client: int
    index: int  # the client's frame count since its start
    clip_index: int
    draw_index: int
    h_prev: np.ndarray  # (P,) float32, P the model's parameters
    h_next: np.ndarray  # (P,) float32
    score: float
    due: float
    start: float  # the call into the step
    done: float  # the pose on the host
    service_ms: float  # the frame's share of the time the step served it


def wait_until(t: float) -> None:
    """Spin until the host clock reads t.  A sleep can wake the host
    several ms late (up to 10 ms seen on an H100 host), which would count
    in the frame's latency."""
    while time.perf_counter() < t:
        pass


class Load:
    """The clients of one traffic mix in front of the program's step.

    ``step(generator, h_prev, depth, draws)`` is the program's frame on
    given draws; ``depth`` (T, H, W) and ``truth`` (T, P) the clip on the
    device, P the model's parameters; ``pool`` (draw_pool, 1 + G, 2, N, P)
    the draws."""

    def __init__(self, step: Callable, traffic: dict, depth: torch.Tensor,
                 truth: torch.Tensor, pool: torch.Tensor):
        self.step, self.traffic = step, traffic
        self.depth, self.pool = depth, pool
        self.device = depth.device
        self.clients = int(traffic["clients"])
        self.num_frames = depth.shape[0]
        period = 2 * self.num_frames - 2
        self.starts = [c * period // self.clients for c in range(self.clients)]
        self.h0 = [truth[clip_mod.loop_index(s, self.num_frames)].clone() for s in self.starts]
        # the draws as the step takes them: views of the pool, built once
        self.draws = [((u[0, 0], u[0, 1]), [(g[0], g[1]) for g in u[1:]]) for u in pool]
        cuda = self.device.type == "cuda"
        self.host = torch.zeros((self.clients, pool.shape[-1] + 1), dtype=torch.float32,
                                pin_memory=cuda)
        self.reset()

    def reset(self) -> None:
        """Every client back at its start pose, at its first frame."""
        self.h = list(self.h0)
        self.h_host = [h.cpu().numpy().copy() for h in self.h0]
        self.count = [0] * self.clients

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _submit(self, c: int):
        """Client c's next frame into the step; its pose and score copied
        to the host row c without waiting.  Returns the frame's inputs."""
        k = self.count[c]
        clip_index = clip_mod.loop_index(self.starts[c] + 1 + k, self.num_frames)
        pool = self.pool.shape[0]
        draw_index = (k + c * pool // self.clients) % pool
        h, score = self.step(None, self.h[c], self.depth[clip_index], self.draws[draw_index])
        self.host[c, :-1].copy_(h, non_blocking=True)
        self.host[c, -1].copy_(score, non_blocking=True)
        self.h[c] = h
        self.count[c] = k + 1
        return k, clip_index, draw_index

    def _record(self, c, inputs, due, start, done, service_ms) -> Frame:
        row = self.host[c].numpy().copy()
        frame = Frame(c, *inputs, h_prev=self.h_host[c], h_next=row[:-1], score=float(row[-1]),
                      due=due, start=start, done=done, service_ms=service_ms)
        self.h_host[c] = frame.h_next
        return frame

    def periodic(self, seconds: Optional[float], count: Optional[int] = None,
                 rate_hz: Optional[float] = None) -> List[Frame]:
        """The open loop: the frames due in ``seconds`` at ``rate_hz`` (the
        mix's rate by default), or ``count`` frames back to back when
        ``rate_hz`` is 0."""
        rate_hz = self.traffic["rate_hz"] if rate_hz is None else rate_hz
        frames: List[Frame] = []
        t0 = time.perf_counter() + 1e-3
        i = 0
        while count is None or i < count:
            k, c = divmod(i, self.clients)
            due = t0 + k / rate_hz if rate_hz else time.perf_counter()
            if seconds is not None and due >= t0 + seconds:
                break
            wait_until(due)
            start = time.perf_counter()
            inputs = self._submit(c)
            self._sync()
            done = time.perf_counter()
            frames.append(self._record(c, inputs, due, start, done, (done - start) * 1e3))
            i += 1
        return frames

    def closed(self, seconds: Optional[float], rounds: Optional[int] = None) -> List[Frame]:
        """The closed loop in rounds: the rounds started within ``seconds``,
        or ``rounds`` of them."""
        frames: List[Frame] = []
        t0 = time.perf_counter()
        r = 0
        while rounds is None or r < rounds:
            start = time.perf_counter()
            if seconds is not None and start >= t0 + seconds:
                break
            inputs = [self._submit(c) for c in range(self.clients)]
            self._sync()
            done = time.perf_counter()
            share = (done - start) * 1e3 / self.clients
            frames.extend(self._record(c, inputs[c], start, start, done, share)
                          for c in range(self.clients))
            r += 1
        return frames

    def run(self, seconds: Optional[float], frames: Optional[int] = None,
            paced: bool = True) -> List[Frame]:
        """The mix's loop for ``seconds``, or for about ``frames`` frames;
        ``paced=False`` sends a periodic mix's frames back to back."""
        if self.traffic["arrival"] == "periodic":
            return self.periodic(seconds, frames, None if paced else 0.0)
        if self.traffic["arrival"] == "closed":
            rounds = None if frames is None else max(1, -(-frames // self.clients))
            return self.closed(seconds, rounds)
        raise ValueError(f"unknown arrival {self.traffic['arrival']!r}")


def window(frames: Sequence[Frame]) -> tuple:
    """(first due, last pose on the host) of a window's frames."""
    return min(f.due for f in frames), max(f.done for f in frames)
