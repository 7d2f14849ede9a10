"""Discrete-event primitives for the fleet simulator.

The paper's experiment is one client against a dedicated server; the
fleet simulator replays N copies of that client against *shared* edge
servers, so per-request latency depends on who else is in the queue.
Three primitives make that exact and deterministic:

* :class:`EventQueue` — a time-ordered event heap.  Ties are broken by
  scheduling order (a monotone sequence number), so a run is a pure
  function of its inputs and seeds; there is no wall-clock anywhere.
* :class:`SlotServer` — a FIFO service resource with ``capacity``
  identical slots (the virtualized-accelerator model: an edge box that
  can serve ``capacity`` tracker requests concurrently at full speed).
  Because the event queue pops in time order, offering admissions at
  their arrival events yields exact FIFO-c queueing, not an averaged
  queueing formula.
* :class:`BatchingSlotServer` — the fused-launch variant: compatible
  requests arriving within a ``gather_window`` accumulate into one
  batch, which then occupies a single slot for the
  :class:`~repro_torch.core.costengine.BatchServiceModel` batch time (fixed
  launch overhead + sublinear per-item cost) and completes as a whole.
  A non-positive gather window degenerates to per-request batches of
  one served synchronously — exactly :class:`SlotServer`, event for
  event (the golden equivalence test in tests/test_batching.py).
* :class:`LinkTable` — the mutable ground-truth network conditions.
  Requests resample every :class:`~repro_torch.core.costengine.LatencyLeg`
  the cost engine recorded for their plan against the *current* table,
  so per-request latencies are exact draws, and injected link drift
  makes observed legs deviate from the plan's predictions — the signal
  the plan cache's drift detector watches.

``LinkTable.sample_plan_latency`` intentionally replicates the exact
floating-point operation order of ``PlanReport.jittered_total`` so that
an undrifted single-client fleet reproduces ``sim.runtime.analytic_run``
bit-for-bit (asserted in tests/test_cluster.py).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.costengine import BatchServiceModel, PlanReport
from repro_torch.core.topology import Link, Topology, sample_latency


@dataclasses.dataclass(order=True)
class _Event:
    time: float
    seq: int
    fn: Callable[[], None] = dataclasses.field(compare=False)


class EventQueue:
    """Deterministically ordered event heap with a simulated clock.

    ``processed`` counts popped events — the denominator of the
    events/sec throughput number the reference's ``fleet_bench
    --events`` reports, and
    a structural invariant the vectorized engine must reproduce exactly
    (same event count, not just same results).
    """

    def __init__(self) -> None:
        self._heap: List[_Event] = []
        self._seq = 0
        self.now = 0.0
        self.processed = 0

    def schedule(self, time: float, fn: Callable[[], None]) -> None:
        # clamp ulp-level rounding of canonical finish times (see
        # fleet.finish) so events never land microscopically in the past
        heapq.heappush(self._heap, _Event(max(time, self.now), self._seq, fn))
        self._seq += 1

    def run(self) -> None:
        while self._heap:
            ev = heapq.heappop(self._heap)
            self.now = ev.time
            self.processed += 1
            ev.fn()


class SlotServer:
    """A FIFO resource with ``capacity`` identical service slots.

    Admissions MUST be offered in nondecreasing time order (the event
    queue guarantees this when callers admit at their arrival events);
    each admitted request occupies one slot for exactly its service
    time.  Tracks queue depth and utilization for dispatch policies and
    reports.
    """

    def __init__(self, name: str, capacity: int):
        self.name = name
        self.capacity = max(int(capacity), 1)
        self._slots = [0.0] * self.capacity  # slot free times (min-heap)
        heapq.heapify(self._slots)
        self._finishes: List[float] = []  # in-flight request finish times
        self.admitted = 0
        self.batches = 0  # uniform stats with BatchingSlotServer: never fuses
        self.busy_time = 0.0
        self.total_wait = 0.0
        self.peak_load = 0  # max concurrent in-flight seen at an admission
        self._last_admit = float("-inf")
        # optional repro_torch.cluster.telemetry.Telemetry sink (occupancy
        # timeline samples, batch-size histograms); None is the golden
        # default
        self.telemetry = None
        # live service-time multiplier (thermal throttling injected by
        # fleet.ServiceDrift); 1.0 multiplies bit-exactly, so the
        # undrifted server is unchanged.  Plans never see this — only
        # measured waits do, which is what the migration controller's
        # wait-EWMA calibration exists to track.
        self.service_scale = 1.0

    def load(self, now: float) -> int:
        """Requests admitted but not yet finished at ``now``."""
        while self._finishes and self._finishes[0] <= now:
            heapq.heappop(self._finishes)
        return len(self._finishes)

    def admit(self, arrival: float, service: float) -> Tuple[float, float]:
        """Queue one request; returns (service_start, service_finish)."""
        if arrival < self._last_admit:
            raise ValueError(
                f"{self.name}: admissions out of order "
                f"({arrival} < {self._last_admit})"
            )
        self._last_admit = arrival
        service = service * self.service_scale
        free = heapq.heappop(self._slots)
        start = max(arrival, free)
        finish = start + service
        heapq.heappush(self._slots, finish)
        heapq.heappush(self._finishes, finish)
        self.admitted += 1
        self.busy_time += service
        self.total_wait += start - arrival
        ld = self.load(arrival)
        if ld > self.peak_load:
            self.peak_load = ld
        if self.telemetry is not None:
            self.telemetry.occupancy_sample(self.name, arrival, ld)
            self.telemetry.wait_sample(self.name, arrival, start - arrival)
        return start, finish

    @property
    def mean_wait(self) -> float:
        return self.total_wait / self.admitted if self.admitted else 0.0

    @property
    def mean_batch_size(self) -> float:
        return 0.0

    # --- uniform service API (shared with BatchingSlotServer) -----------

    def submit(
        self,
        arrival: float,
        service: float,
        done: Callable[[float, float], None],
        key=None,
    ) -> None:
        """Admit one request and invoke ``done(start, finish)``.

        Unbatched servers serve immediately, so the callback fires
        synchronously — callers schedule their continuation events from
        inside it, which keeps the event ordering identical to the
        historical ``admit``-then-schedule pattern.
        """
        del key  # no batching: compatibility is irrelevant
        start, finish = self.admit(arrival, service)
        done(start, finish)

    def open_batch_size(self, key=None) -> int:
        return 0


@dataclasses.dataclass(frozen=True)
class AdaptiveWindow:
    """Adaptive gather-window sizing for :class:`BatchingSlotServer`.

    A fixed gather window is pure added latency when an edge is idle:
    with one client per window there is nothing to fuse, yet every frame
    still dwells the full window before launch.  The adaptive policy
    sizes the window from a per-edge EWMA of observed inter-arrival
    times: when requests arrive densely (EWMA <= ``idle_factor`` x the
    configured window) fusing is profitable and the full window is
    kept; when arrivals are sparser than that, a newly opening batch
    serves immediately (window 0) — a batch of one, bit-for-bit the
    FIFO path — instead of paying the window as dead time.

    ``alpha`` — EWMA smoothing of each new inter-arrival sample.
    ``idle_factor`` — density threshold in units of the configured
    window (1.0: gather only while arrivals land inside one window).

    Joining an already-open batch is unaffected (its close event is
    scheduled); adaptivity only decides how long a *new* batch gathers.
    ``adaptive=None`` on the server is the exact off-switch: the fixed
    window is used unconditionally and no EWMA state is touched
    (golden-tested in tests/test_batching.py).
    """

    alpha: float = 0.25
    idle_factor: float = 1.0

    def __post_init__(self) -> None:
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        if self.idle_factor <= 0.0:
            raise ValueError("idle_factor must be > 0")


class BatchingSlotServer:
    """A slot server that fuses compatible requests into batch launches.

    Requests arriving within ``gather_window`` of the first request of
    an open batch (per compatibility ``key``) accumulate; when the
    window closes the whole batch occupies ONE service slot for
    ``model.batch_time`` of its members' solo service times, and every
    member finishes at the batch finish — the event-level realization of
    the cost engine's batch-aware pricing.  Everything is scheduled on
    the shared :class:`EventQueue`, so runs remain pure functions of
    their inputs: batch closes fire in time order, members are served in
    arrival order, and no wall-clock exists anywhere.

    A non-positive ``gather_window`` serves each request synchronously
    as a batch of one — with ``batch_time([t]) == t`` by construction,
    that is bit-for-bit the FIFO :class:`SlotServer`.
    """

    def __init__(
        self,
        name: str,
        capacity: int,
        queue: EventQueue,
        model: Optional[BatchServiceModel] = None,
        gather_window: float = 0.0,
        adaptive: Optional[AdaptiveWindow] = None,
    ):
        self.name = name
        self.capacity = max(int(capacity), 1)
        self.model = model if model is not None else BatchServiceModel()
        self.gather_window = gather_window
        self.adaptive = adaptive
        self._ia_ewma: Optional[float] = None  # inter-arrival EWMA (adaptive)
        self._prev_arrival: Optional[float] = None
        self._queue = queue
        self._slots = [0.0] * self.capacity  # slot free times (min-heap)
        heapq.heapify(self._slots)
        self._finishes: List[float] = []  # in-flight request finish times
        # key -> gathering [(arrival, service, done), ...]
        self._open: Dict[object, List[Tuple[float, float, Callable]]] = {}
        self.admitted = 0
        self.batches = 0
        self.busy_time = 0.0
        self.total_wait = 0.0
        self.peak_load = 0  # max concurrent in-flight seen at an admission
        self._last_admit = float("-inf")
        # optional repro_torch.cluster.telemetry.Telemetry sink (occupancy
        # timeline samples, batch-size histograms); None is the golden
        # default
        self.telemetry = None
        self.service_scale = 1.0  # same live throttle hook as SlotServer

    def load(self, now: float) -> int:
        """Requests admitted but not yet finished at ``now`` (both the
        gathering and the in-service ones)."""
        while self._finishes and self._finishes[0] <= now:
            heapq.heappop(self._finishes)
        gathering = sum(len(items) for items in self._open.values())
        return len(self._finishes) + gathering

    def open_batch_size(self, key=None) -> int:
        """Members of the currently gathering batch(es) — what a batch-
        affinity dispatcher wants to join."""
        if key is None:
            return sum(len(items) for items in self._open.values())
        return len(self._open.get(key, ()))

    def submit(
        self,
        arrival: float,
        service: float,
        done: Callable[[float, float], None],
        key=None,
    ) -> None:
        """Queue one request; ``done(service_start, service_finish)``
        fires when its batch is placed (synchronously for a zero
        window, at batch close otherwise)."""
        if arrival < self._last_admit:
            raise ValueError(
                f"{self.name}: admissions out of order "
                f"({arrival} < {self._last_admit})"
            )
        self._last_admit = arrival
        self.admitted += 1
        if self.adaptive is not None:
            # per-edge inter-arrival EWMA; fed on every admission, read
            # only when a NEW batch opens (joins are unaffected)
            if self._prev_arrival is not None:
                dt = arrival - self._prev_arrival
                a = self.adaptive.alpha
                self._ia_ewma = (
                    dt
                    if self._ia_ewma is None
                    else a * dt + (1.0 - a) * self._ia_ewma
                )
            self._prev_arrival = arrival
        # the throttle applies per ADMISSION (same semantics as
        # SlotServer): an item submitted before a ServiceDrift keeps
        # its nominal time even if its batch closes after the drift
        service = service * self.service_scale
        items = self._open.get(key) if self.gather_window > 0.0 else None
        if items is not None:
            items.append((arrival, service, done))
        else:
            window = self._effective_window()
            if window <= 0.0:
                self._serve(arrival, [(arrival, service, done)])
            else:
                self._open[key] = [(arrival, service, done)]
                self._queue.schedule(
                    arrival + window, lambda k=key: self._close(k)
                )
        ld = self.load(arrival)
        if ld > self.peak_load:
            self.peak_load = ld
        if self.telemetry is not None:
            self.telemetry.occupancy_sample(self.name, arrival, ld)

    def _effective_window(self) -> float:
        """Gather window for a batch opening now: the configured window,
        or 0 when adaptivity judges the edge too idle to fuse."""
        if self.adaptive is None or self._ia_ewma is None:
            return self.gather_window
        if self._ia_ewma <= self.adaptive.idle_factor * self.gather_window:
            return self.gather_window
        return 0.0

    def _close(self, key) -> None:
        self._serve(self._queue.now, self._open.pop(key))

    def _serve(
        self, ready: float, items: List[Tuple[float, float, Callable]]
    ) -> None:
        # member times were scaled at submit; the fused launch prices
        # them as-is (scale 1.0 is a bit-exact no-op throughout)
        batch_t = self.model.batch_time([svc for _, svc, _ in items])
        if self.telemetry is not None:
            self.telemetry.batch_sample(self.name, len(items))
        free = heapq.heappop(self._slots)
        start = max(ready, free)
        finish = start + batch_t
        heapq.heappush(self._slots, finish)
        self.batches += 1
        self.busy_time += batch_t
        for arrival, _, done in items:
            heapq.heappush(self._finishes, finish)
            self.total_wait += start - arrival
            if self.telemetry is not None:
                self.telemetry.wait_sample(self.name, arrival, start - arrival)
            done(start, finish)

    @property
    def mean_wait(self) -> float:
        return self.total_wait / self.admitted if self.admitted else 0.0

    @property
    def mean_batch_size(self) -> float:
        return self.admitted / self.batches if self.batches else 0.0


class SharedLink:
    """A contended shared transmission medium (cell sector / backhaul).

    The :class:`SlotServer` idea generalized to links: every wire leg
    crossing a link that names this medium occupies one of ``capacity``
    transmission slots for its full wire time.  Unlike a slot server,
    admissions are offered at each transmission's *uncontended
    completion time* (``due`` — the engines already charge the wire
    time inside the plan's sampled total), in event-pop order, and dues
    are NOT required to be monotone (downlink dues are finish times,
    which interleave).  :meth:`admit` returns the *extra* delay beyond
    ``due``:

    * a free slot can still complete the transmission by its due time
      (``free + service <= due``, i.e. the medium was idle when the
      transmission would have started) — the slot is held until ``due``
      and the extra delay is exactly ``0.0``, so the caller's untouched
      arithmetic path is bit-for-bit the private-spoke fleet;
    * otherwise the transmission serializes behind the queue: it
      completes at ``free + service`` and the difference is returned.

    ``capacity == 0`` is the *unlimited* medium: occupancy is counted
    (``admitted`` / ``busy_time``) but no slot state exists and the
    extra delay is always ``0.0`` — the off-switch golden in
    tests/test_contention.py.
    """

    def __init__(self, name: str, capacity: int = 0):
        self.name = name
        self.capacity = max(int(capacity), 0)
        self._slots = [0.0] * self.capacity  # slot free times (min-heap)
        heapq.heapify(self._slots)
        self.admitted = 0  # transmissions offered to the medium
        self.contended = 0  # transmissions that had to queue
        self.busy_time = 0.0  # total wire seconds carried
        self.total_wait = 0.0  # total extra delay imposed
        # optional repro_torch.cluster.telemetry.Telemetry sink; None is the
        # golden default (hook sites guarded like the slot servers')
        self.telemetry = None

    def queue_delay(self, now: float) -> float:
        """Extra delay a transmission due now would see — the live
        occupancy signal dispatch and the migration predictor read."""
        if not self._slots:
            return 0.0
        free = self._slots[0]
        return free - now if free > now else 0.0

    def admit(self, due: float, service: float) -> float:
        """Offer one transmission of ``service`` wire seconds that
        would complete uncontended at ``due``; returns the extra delay
        (exactly ``0.0`` whenever the medium is uncontended)."""
        if service <= 0.0:
            return 0.0
        self.admitted += 1
        self.busy_time += service
        if not self._slots:  # unlimited: counted, never queued
            return 0.0
        free = self._slots[0]
        if free + service <= due:
            # idle slot: hold it through the transmission's own window
            # and return a literal 0.0 — no float round-trip via
            # (due - service) + service, which would not equal due
            heapq.heapreplace(self._slots, due)
            if self.telemetry is not None:
                self.telemetry.occupancy_sample(f"link.{self.name}", due, 0.0)
            return 0.0
        completion = free + service
        heapq.heapreplace(self._slots, completion)
        wait = completion - due
        self.contended += 1
        self.total_wait += wait
        if self.telemetry is not None:
            self.telemetry.occupancy_sample(f"link.{self.name}", due, wait)
        return wait

    @property
    def mean_wait(self) -> float:
        return self.total_wait / self.admitted if self.admitted else 0.0


def build_media(topo: Topology) -> Dict[str, SharedLink]:
    """One :class:`SharedLink` per distinct medium name the topology
    declares (insertion order; first declaration fixes the capacity).
    Empty on every private-spoke topology — the engines skip the whole
    contention path, which is what keeps it a zero-cost feature when
    off."""
    media: Dict[str, SharedLink] = {}
    for link in topo.links.values():
        if link.medium and link.medium not in media:
            media[link.medium] = SharedLink(link.medium, link.medium_capacity)
    return media


# one (link name, drawn latency) pair per plan leg — what a client
# actually observed, fed to the drift detector
ObservedLegs = Tuple[Tuple[str, float], ...]


class LinkTable:
    """Mutable ground-truth link conditions, seeded from a topology.

    Drift events overwrite entries in place; plan sampling and
    re-planning both read the current state, so a re-planned client is
    calibrated against the conditions it will actually experience.
    """

    def __init__(self, topo: Topology):
        self._links: Dict[str, Link] = {
            link.name: link for link in topo.links.values()
        }
        # bumped on every mutation: lets the vectorized engine's sampler
        # invalidate its pre-transformed latency blocks without
        # comparing Link values per frame
        self.version = 0

    def get(self, name: str) -> Link:
        return self._links[name]

    def lookup(self, name: str) -> Optional[Link]:
        """Like :meth:`get` but None for links outside the table (plan
        legs can reference links the fleet topology does not carry)."""
        return self._links.get(name)

    def set(
        self,
        name: str,
        latency: Optional[float] = None,
        jitter: Optional[float] = None,
        bandwidth: Optional[float] = None,
    ) -> Link:
        old = self._links[name]
        # dataclasses.replace-style reconstruction: drift only touches
        # the wire parameters, shared-medium membership is preserved
        new = Link(
            name=name,
            bandwidth=old.bandwidth if bandwidth is None else bandwidth,
            latency=old.latency if latency is None else latency,
            jitter=old.jitter if jitter is None else jitter,
            medium=old.medium,
            medium_capacity=old.medium_capacity,
        )
        self._links[name] = new
        self.version += 1
        return new

    def sample_plan_latency(
        self, plan: PlanReport, rng
    ) -> Tuple[float, ObservedLegs]:
        """One request's latency: the plan total with every recorded leg
        re-drawn from current conditions.

        Replicates ``PlanReport.jittered_total``'s float operation order
        (subtract the charged latency, add the draw, leg by leg), so
        with undrifted links the result — and the rng consumption — is
        bit-identical to the analytic simulator's.

        A probabilistic leg (``LatencyLeg.weight`` < 1, from a
        conditional branch) contributes ``weight * draw`` to the total
        while the *observed* draw stays unscaled — drift detection and
        rate control compare draws against live link parameters, which
        know nothing of branch probabilities.
        """
        t = plan.total_time
        observed: List[Tuple[str, float]] = []
        for leg in plan.legs:
            link = self._links.get(leg.link)
            if link is None:
                lat, jit = leg.latency, leg.jitter
            else:
                lat, jit = link.latency, link.jitter
            draw = sample_latency(lat, jit, rng)
            if leg.weight == 1.0:
                t -= leg.latency
                t += draw
            else:
                t -= leg.weight * leg.latency
                t += leg.weight * draw
            observed.append((leg.link, draw))
        return t, tuple(observed)
