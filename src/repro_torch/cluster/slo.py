"""Online SLO monitoring + root-cause attribution (the "fleet doctor").

The fleet so far reports aggregate fps / drop / p99 *after* the run and
the telemetry's span traces are post-hoc artifacts a human must read.  This
module closes the loop: the fleet watches its own SLOs **online** —
inside the event loop, on both engines, event-for-event identically —
and when a service-level objective burns down it opens a timestamped
:class:`Incident` and *explains* it by diffing the incident window's
span/metric profile against the rolling healthy baseline.

Pieces:

* :class:`SLOClass` — a deadline/attainment objective attached to each
  ``core/workloads.py`` registry entry via ``WORKLOAD_SLO`` (interactive
  AR landmark tracking vs best-effort gesture analytics).
* :class:`WindowedQuantile` — deterministic streaming quantile over the
  last ``window`` observations using the same fixed-log-bucket
  discretization as :class:`~repro_torch.cluster.telemetry.Histogram`.
  Documented error bound (property-tested in tests/test_slo.py): for an
  exact sorted-window quantile ``v`` with ``lo < v <= top`` the estimate
  ``e`` satisfies ``v <= e <= v * growth``; values at or below ``lo``
  clamp to ``lo`` and values above the top bound clamp to it.
* :class:`BurnGauge` — streaming attainment over an SRE-style pair of
  windows (fast + slow).  The *burn rate* is the observed miss fraction
  divided by the error budget ``1 - target``; an incident opens when
  BOTH windows burn above their thresholds (fast catches the spike,
  slow filters blips) and closes with hysteresis when the fast window
  drops back under budget (burn < 1).  Dropped frames — holes in the
  per-client frame-index sequence — count as deadline misses, so a
  fault that *drops* frames (a migration flap's blackouts) breaches the
  SLO even though every processed frame's loop time looks healthy.
* :class:`SLOMonitor` — a :class:`~repro_torch.cluster.telemetry.Telemetry`
  subclass (``run_fleet(slo=SLOMonitor())``): same hooks, same spans,
  plus the online estimators, incident lifecycle, and the root-cause
  attributor.  ``slo=None`` is bit-for-bit the unmonitored fleet
  (every hook site is already guarded); and because both engines call
  the hooks with bit-identical inputs in the same order, the incident
  log — causes, timestamps, report bytes — is engine-independent
  (gated in the reference's ``fleet_bench --doctor``).
* ``FAULTS`` — the fault-injection catalog validating the doctor *by
  construction*: each :class:`FaultSpec` names the drift schedule that
  induces it and the cause label the doctor must rank first.

Root-cause model: every processed frame's span tuple is folded into
per-category seconds (see :data:`CATEGORIES` — queue-wait and
batch-gather merge into ``queueing``, uplink and downlink into
``network``, the shared-medium delay is carved out as ``cell``),
migration blackouts become a ``blackout`` pseudo-category (seconds per
frame, charged to the inter-frame gap), and per-edge / per-medium wait
samples localize the winning category to a locus —
``queueing@edge_1``, ``cell@cell0``, ``network@edge_0``.  Scores are
*per-frame excess seconds* vs the healthy baseline, so categories
compete in one unit.
"""

from __future__ import annotations

import dataclasses
import json
import math
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

from repro_torch.cluster.fleet import LinkDrift, ServiceDrift
from repro_torch.cluster.migration import MigrationConfig
from repro_torch.cluster.telemetry import SPAN_ORDER, Telemetry
from repro_torch.core.workloads import WORKLOAD_SLO

__all__ = [
    "SLOClass",
    "INTERACTIVE",
    "BEST_EFFORT",
    "SLO_CLASSES",
    "slo_of",
    "WindowedQuantile",
    "BurnGauge",
    "Cause",
    "Incident",
    "SLOMonitor",
    "FaultSpec",
    "FAULTS",
    "DOCTOR_CLASSES",
    "doctor_verdict",
]


# ---------------------------------------------------------------------------
# SLO classes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A deadline/attainment objective for one traffic class.

    ``deadline_s`` — per-frame loop-time deadline.
    ``target`` — required fraction of frames meeting it (the error
    budget is ``1 - target``).
    ``window`` — slow attainment window, in frames (also the quantile
    estimator's window).  Until ``window`` frames arrive the slow ratio
    is taken over what has been seen — short CI runs must still alert.
    ``fast_window`` — spike-detection window, in frames; must not
    exceed ``window`` (the slow ring backs both sums).
    ``fast_burn`` / ``slow_burn`` — burn-rate thresholds (multiples of
    the error budget) both windows must exceed to open an incident.
    """

    name: str
    deadline_s: float
    target: float
    window: int = 256
    fast_window: int = 32
    fast_burn: float = 6.0
    slow_burn: float = 3.0

    def __post_init__(self) -> None:
        if not 0.0 < self.target < 1.0:
            raise ValueError("target must be in (0, 1)")
        if self.deadline_s <= 0.0:
            raise ValueError("deadline_s must be > 0")
        if not 1 <= self.fast_window <= self.window:
            raise ValueError("need 1 <= fast_window <= window")

    @property
    def budget(self) -> float:
        return 1.0 - self.target


# The paper's feasibility claim as an SLO: interactive hand tracking
# must hold camera-real-time deadlines; the gesture-analytics head is
# best-effort — late labels degrade gracefully, so its budget is wide.
INTERACTIVE = SLOClass("interactive", deadline_s=60e-3, target=0.95)
BEST_EFFORT = SLOClass("best_effort", deadline_s=120e-3, target=0.80)

SLO_CLASSES: Dict[str, SLOClass] = {
    c.name: c for c in (INTERACTIVE, BEST_EFFORT)
}


def slo_of(workload: str) -> SLOClass:
    """SLO class of a registry workload (interactive when unmapped —
    unknown pipelines get the strict deadline, not a free pass).

    Derived names — ``fused()`` / ``linearized()`` stamp a bracketed
    suffix on the pipeline name — resolve to their base workload's
    class: fusing a best-effort head does not promote it."""
    base = workload.split("[", 1)[0]
    return SLO_CLASSES[WORKLOAD_SLO.get(base, "interactive")]


# ---------------------------------------------------------------------------
# streaming estimators
# ---------------------------------------------------------------------------


class WindowedQuantile:
    """Deterministic streaming quantile over the last ``window`` values.

    Values are discretized into the telemetry histogram's fixed log
    buckets (``bisect_left``: bucket k covers
    ``(lo * growth**(k-1), lo * growth**k]``); a ring buffer of bucket
    indices retires the oldest observation exactly, so the estimate is
    a pure function of the last ``window`` inputs.

    Error bound (tests/test_slo.py property-tests it): with ``v`` the
    exact ceil-rank quantile of the sorted window,

    * ``lo < v <= bounds[-1]``  =>  ``v <= quantile(q) <= v * growth``
    * ``v <= lo``               =>  ``quantile(q) == lo``
    * ``v >  bounds[-1]``       =>  ``quantile(q) == bounds[-1]``

    The defaults cover 0.1 ms .. ~90 s at ``growth = 2**0.25`` (≤ 19%
    relative overestimate) — loop times live well inside that band.
    """

    __slots__ = ("bounds", "counts", "ring", "window", "n")

    def __init__(
        self,
        window: int,
        lo: float = 1e-4,
        growth: float = 2.0 ** 0.25,
        nbuckets: int = 80,
    ):
        if window < 1:
            raise ValueError("window must be >= 1")
        if lo <= 0.0 or growth <= 1.0 or nbuckets < 2:
            raise ValueError("need lo > 0, growth > 1, nbuckets >= 2")
        self.bounds = [lo * growth**k for k in range(nbuckets)]
        self.counts = [0] * (nbuckets + 1)  # +1 overflow
        self.ring = [0] * window
        self.window = window
        self.n = 0

    def observe(self, v: float) -> None:
        k = bisect_left(self.bounds, v)
        if k == len(self.bounds):  # overflow clamps to the top bucket
            k -= 1
        pos = self.n % self.window
        if self.n >= self.window:
            self.counts[self.ring[pos]] -= 1
        self.ring[pos] = k
        self.counts[k] += 1
        self.n += 1

    def quantile(self, q: float) -> float:
        """Upper bucket bound at ceil-rank quantile ``q`` (0 if empty)."""
        count = min(self.n, self.window)
        if not count:
            return 0.0
        rank = max(1, math.ceil(q * count))
        acc = 0
        for k, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                return self.bounds[k]
        return self.bounds[-1]


class BurnGauge:
    """Streaming SLO attainment over a fast + slow window pair.

    One ring of miss bits (1 = deadline missed or frame dropped) of
    length ``slo.window`` backs both running sums; the fast sum retires
    bits ``fast_window`` observations back.  Burn rate = miss fraction
    over the window divided by the error budget.  The slow ratio uses
    ``min(n, window)`` as its denominator so short runs still alert;
    the fast ratio requires a full fast window (no spike verdicts from
    a handful of frames).
    """

    __slots__ = ("slo", "ring", "n", "fast_sum", "slow_sum")

    def __init__(self, slo: SLOClass):
        self.slo = slo
        self.ring = [0] * slo.window
        self.n = 0
        self.fast_sum = 0
        self.slow_sum = 0

    def observe(self, miss: bool) -> None:
        w = self.slo.window
        fw = self.slo.fast_window
        pos = self.n % w
        if self.n >= w:
            self.slow_sum -= self.ring[pos]
        if self.n >= fw:
            self.fast_sum -= self.ring[(self.n - fw) % w]
        bit = 1 if miss else 0
        self.ring[pos] = bit
        self.slow_sum += bit
        self.fast_sum += bit
        self.n += 1

    @property
    def fast_ready(self) -> bool:
        return self.n >= self.slo.fast_window

    @property
    def fast_burn(self) -> float:
        fw = self.slo.fast_window
        if not self.n:
            return 0.0
        return (self.fast_sum / min(self.n, fw)) / self.slo.budget

    @property
    def slow_burn(self) -> float:
        if not self.n:
            return 0.0
        return (self.slow_sum / min(self.n, self.slo.window)) / self.slo.budget

    @property
    def alerting(self) -> bool:
        return (
            self.fast_ready
            and self.fast_burn >= self.slo.fast_burn
            and self.slow_burn >= self.slo.slow_burn
        )


# ---------------------------------------------------------------------------
# incidents + root-cause attribution
# ---------------------------------------------------------------------------

# attribution categories, folded from the span tuple so faults diagnose
# robustly: queue-wait and batch-gather merge into one ``queueing``
# category (FIFO and fused-launch edges present the same symptom), the
# uplink and downlink spans merge into ``network`` (a latency/jitter/
# bandwidth fault on a spoke inflates both directions — splitting them
# makes the winner a coin flip) minus the shared-medium queue delay,
# which becomes its own ``cell`` category (contention happens *on the
# medium*, not on a spoke), and migration blackouts become the
# ``blackout`` pseudo-category (downtime is inter-frame — invisible in
# loop spans, visible in drops).
CATEGORIES: Tuple[str, ...] = (
    "client",
    "network",
    "queueing",
    "decode",
    "compute",
    "cell",
    "blackout",
)

_N_CAT = len(CATEGORIES)

_I_CLIENT = SPAN_ORDER.index("client")
_I_UP = SPAN_ORDER.index("uplink")
_I_QW = SPAN_ORDER.index("queue-wait")
_I_BG = SPAN_ORDER.index("batch-gather")
_I_DEC = SPAN_ORDER.index("decode")
_I_COMP = SPAN_ORDER.index("compute")
_I_DOWN = SPAN_ORDER.index("downlink")


def _frame_categories(
    spans: Tuple[float, ...], link_wait: float
) -> Tuple[float, ...]:
    """Fold one frame's span tuple into per-category seconds.  The
    engines attribute the shared-medium wait to the uplink span
    (that is where the client feels it); here it is carved back out so
    ``network`` is pure wire/latency/jitter and ``cell`` is pure
    medium queueing."""
    return (
        spans[_I_CLIENT],
        spans[_I_UP] + spans[_I_DOWN] - link_wait,
        spans[_I_QW] + spans[_I_BG],
        spans[_I_DEC],
        spans[_I_COMP],
        link_wait,
        0.0,  # blackout: fed by the migration hook, not the spans
    )


class _Profile:
    """Accumulated per-category seconds + localization samples for one
    stretch of frames (the healthy baseline or one incident window)."""

    __slots__ = (
        "frames",
        "cat_s",
        "uplink_bytes",
        "edge_frames",
        "edge_cat_s",
        "edge_wait",
        "media_wait",
    )

    def __init__(self) -> None:
        self.frames = 0
        self.cat_s = [0.0] * _N_CAT
        self.uplink_bytes = 0
        # edge -> frame count / per-category seconds of frames served there
        self.edge_frames: Dict[str, int] = {}
        self.edge_cat_s: Dict[str, List[float]] = {}
        # edge -> [sum wait_s, samples] from the servers' wait hook
        self.edge_wait: Dict[str, List[float]] = {}
        # medium -> [sum wait_s, samples] from shared-link admissions
        self.media_wait: Dict[str, List[float]] = {}

    def add_frame(
        self,
        edge: str,
        spans: Tuple[float, ...],
        link_wait: float,
        uplink_bytes: int,
    ) -> None:
        self.frames += 1
        self.uplink_bytes += uplink_bytes
        cat = self.cat_s
        ecat = self.edge_cat_s.get(edge)
        if ecat is None:
            ecat = self.edge_cat_s[edge] = [0.0] * _N_CAT
            self.edge_frames[edge] = 0
        self.edge_frames[edge] += 1
        for c, d in enumerate(_frame_categories(spans, link_wait)):
            cat[c] += d
            ecat[c] += d

    def add_blackout(self, duration: float) -> None:
        self.cat_s[_N_CAT - 1] += duration

    def add_wait(self, edge: str, wait: float) -> None:
        rec = self.edge_wait.get(edge)
        if rec is None:
            rec = self.edge_wait[edge] = [0.0, 0.0]
        rec[0] += wait
        rec[1] += 1.0

    def add_media_wait(self, medium: str, wait: float) -> None:
        rec = self.media_wait.get(medium)
        if rec is None:
            rec = self.media_wait[medium] = [0.0, 0.0]
        rec[0] += wait
        rec[1] += 1.0

    def per_frame(self, c: int) -> float:
        return self.cat_s[c] / self.frames if self.frames else 0.0

    def edge_per_frame(self, edge: str, c: int) -> float:
        n = self.edge_frames.get(edge, 0)
        return self.edge_cat_s[edge][c] / n if n else 0.0

    def mean_wait(self, edge: str) -> float:
        rec = self.edge_wait.get(edge)
        return rec[0] / rec[1] if rec and rec[1] else 0.0

    def media_per_frame(self, medium: str) -> float:
        rec = self.media_wait.get(medium)
        return rec[0] / self.frames if rec and self.frames else 0.0

    def bytes_per_frame(self) -> float:
        return self.uplink_bytes / self.frames if self.frames else 0.0


@dataclasses.dataclass(frozen=True)
class Cause:
    """One ranked suspect: a category and (when localizable) a locus."""

    category: str
    locus: Optional[str]
    excess_s: float  # per-frame excess seconds vs the healthy baseline

    @property
    def label(self) -> str:
        return (
            f"{self.category}@{self.locus}" if self.locus else self.category
        )


@dataclasses.dataclass
class Incident:
    """One SLO breach: the burn-rate windows opened it, the attributor
    explains it at close."""

    workload: str
    slo: str
    t_open: float
    t_close: float = math.nan
    open_at_end: bool = False
    frames: int = 0  # processed frames inside the window
    misses: int = 0  # deadline misses + dropped frames inside it
    drops: int = 0  # the dropped-frame subset of ``misses``
    p99_est_s: float = 0.0  # streaming loop p99 estimate at close
    causes: Tuple[Cause, ...] = ()
    uplink_bytes_excess: float = 0.0  # bytes/frame vs baseline (signal,
    # not a ranked cause: bytes are not seconds)

    @property
    def top_cause(self) -> str:
        return self.causes[0].label if self.causes else "unknown"

    def summary(self) -> Dict:
        return {
            "workload": self.workload,
            "slo": self.slo,
            "t_open": self.t_open,
            "t_close": self.t_close,
            "open_at_end": self.open_at_end,
            "frames": self.frames,
            "misses": self.misses,
            "drops": self.drops,
            "p99_est_ms": 1e3 * self.p99_est_s,
            "causes": [
                {
                    "label": c.label,
                    "excess_ms_per_frame": 1e3 * c.excess_s,
                }
                for c in self.causes
            ],
            "uplink_bytes_excess_per_frame": self.uplink_bytes_excess,
        }


class _WorkloadState:
    """Per-workload online state: estimators, baseline, open incident."""

    __slots__ = (
        "slo",
        "quant",
        "burn",
        "baseline",
        "incident",
        "inc_profile",
    )

    def __init__(self, slo: SLOClass):
        self.slo = slo
        self.quant = WindowedQuantile(slo.window)
        self.burn = BurnGauge(slo)
        self.baseline = _Profile()
        self.incident: Optional[Incident] = None
        self.inc_profile: Optional[_Profile] = None


class SLOMonitor(Telemetry):
    """Online SLO monitor + fleet doctor (a drop-in Telemetry).

    ``run_fleet(slo=SLOMonitor())`` arms it on either engine; both call
    the hooks with bit-identical arguments in the same order, so the
    full incident log — open/close timestamps, ranked causes, report
    bytes — is engine-independent.

    ``classes`` overrides the workload -> :class:`SLOClass` mapping
    (default: ``core.workloads.WORKLOAD_SLO`` via :func:`slo_of`);
    workloads absent from the mapping get :data:`INTERACTIVE`.

    The attributor's localization rule: the winning category picks the
    edge with the largest per-frame excess of that category; for
    ``queueing`` the per-admission wait samples refine it (a throttled
    edge punishes exactly its own queue), and ``cell`` localizes to the
    shared medium with the largest queue-delay excess (wire legs
    contend *on the cell*, not at an edge).
    """

    def __init__(
        self,
        classes: Optional[Dict[str, SLOClass]] = None,
    ) -> None:
        super().__init__()
        self._classes = dict(classes) if classes else None
        self._wl: Dict[str, _WorkloadState] = {}
        self._last_idx: Dict[int, int] = {}
        self._last_t = 0.0
        self.incidents: List[Incident] = []

    # -- class resolution ---------------------------------------------------

    def _state(self, workload: str) -> _WorkloadState:
        st = self._wl.get(workload)
        if st is None:
            if self._classes is not None:
                # keys may be workload names (sharpest) or SLO class
                # names ("interactive") to retune a whole class at once
                slo = (
                    self._classes.get(workload)
                    or self._classes.get(slo_of(workload).name)
                    or slo_of(workload)
                )
            else:
                slo = slo_of(workload)
            st = self._wl[workload] = _WorkloadState(slo)
        return st

    # -- hook overrides (super() first: the trace must stay identical) -----

    def wait_sample(self, edge: str, t: float, wait: float) -> None:
        super().wait_sample(edge, t, wait)
        for st in self._wl.values():
            prof = st.inc_profile if st.incident is not None else st.baseline
            prof.add_wait(edge, wait)

    def occupancy_sample(self, edge: str, t: float, load: float) -> None:
        super().occupancy_sample(edge, t, load)
        if edge.startswith("link."):
            # shared-medium admissions report their imposed queue delay
            # as the sample value (0.0 when uncontended)
            medium = edge[5:]
            for st in self._wl.values():
                prof = (
                    st.inc_profile
                    if st.incident is not None
                    else st.baseline
                )
                prof.add_media_wait(medium, load)

    def migration(
        self, client: int, t0: float, duration: float, src: str, dst: str
    ) -> None:
        super().migration(client, t0, duration, src, dst)
        wl = self._client_workload.get(client, "?")
        st = self._state(wl)
        prof = st.inc_profile if st.incident is not None else st.baseline
        prof.add_blackout(duration)

    def frame_done(
        self,
        client: int,
        frame_idx: int,
        edge: str,
        start: float,
        fin: float,
        plan,
        draws: Tuple[float, ...],
        link_wait: float = 0.0,
    ) -> None:
        super().frame_done(
            client, frame_idx, edge, start, fin, plan, draws,
            link_wait=link_wait,
        )
        self._last_t = fin
        wl = self._client_workload.get(client, "?")
        st = self._state(wl)
        # dropped frames are holes in the per-client index sequence;
        # each is an SLO miss (the user saw no pose update) even though
        # no loop time exists for it
        last = self._last_idx.get(client, -1)
        self._last_idx[client] = frame_idx
        drops = frame_idx - last - 1
        for _ in range(drops):
            st.burn.observe(True)
            if st.incident is not None:
                st.incident.misses += 1
                st.incident.drops += 1
        loop = fin - start
        miss = loop > st.slo.deadline_s
        st.quant.observe(loop)
        st.burn.observe(miss)
        prof = st.inc_profile if st.incident is not None else st.baseline
        prof.add_frame(edge, self.frames[-1][7], link_wait, plan.uplink_bytes)
        if st.incident is not None:
            st.incident.frames += 1
            if miss:
                st.incident.misses += 1
            if st.burn.fast_burn < 1.0:  # hysteresis: budget restored
                self._close(wl, st, fin)
        elif st.burn.alerting:
            st.incident = Incident(
                workload=wl, slo=st.slo.name, t_open=fin
            )
            st.inc_profile = _Profile()

    def finish_run(self, result, rates=None) -> None:
        super().finish_run(result, rates)
        for wl in sorted(self._wl):
            st = self._wl[wl]
            if st.incident is not None:
                st.incident.open_at_end = True
                self._close(wl, st, self._last_t)

    # -- the doctor ---------------------------------------------------------

    def _close(self, wl: str, st: _WorkloadState, t: float) -> None:
        inc = st.incident
        prof = st.inc_profile
        st.incident = None
        st.inc_profile = None
        inc.t_close = t
        inc.p99_est_s = st.quant.quantile(0.99)
        inc.causes = self._attribute(st.baseline, prof)
        inc.uplink_bytes_excess = (
            prof.bytes_per_frame() - st.baseline.bytes_per_frame()
        )
        self.incidents.append(inc)

    def _attribute(
        self, base: _Profile, inc: _Profile
    ) -> Tuple[Cause, ...]:
        """Rank categories by per-frame excess seconds vs baseline and
        localize each to an edge/medium where a signal supports it."""
        causes: List[Cause] = []
        for c, name in enumerate(CATEGORIES):
            excess = inc.per_frame(c) - base.per_frame(c)
            if excess <= 0.0:
                continue
            causes.append(Cause(name, self._locus(c, name, base, inc), excess))
        causes.sort(key=lambda cs: (-cs.excess_s, cs.label))
        return tuple(causes)

    def _locus(
        self, c: int, name: str, base: _Profile, inc: _Profile
    ) -> Optional[str]:
        if name == "blackout":
            return None  # migration downtime has no single edge
        if name == "cell":
            # the contended medium with the largest per-frame queue
            # delay excess (the admissions' reported waits)
            best_m, best_mw = None, 0.0
            for m in sorted(inc.media_wait):
                mw = inc.media_per_frame(m) - base.media_per_frame(m)
                if mw > best_mw:
                    best_m, best_mw = m, mw
            return best_m
        if name == "queueing":
            # per-admission wait samples localize sharper than frame
            # placement (a throttled edge punishes exactly its queue)
            best_e, best_w = None, 0.0
            for e in sorted(inc.edge_wait):
                w = inc.mean_wait(e) - base.mean_wait(e)
                if w > best_w:
                    best_e, best_w = e, w
            if best_e is not None:
                return best_e
        best_e, best_x, second_x = None, 0.0, 0.0
        for e in sorted(inc.edge_frames):
            x = inc.edge_per_frame(e, c) - base.edge_per_frame(e, c)
            if x > best_x:
                best_e, best_x, second_x = e, x, best_x
            elif x > second_x:
                second_x = x
        if (
            name == "network"
            and second_x >= 0.35 * best_x
            and len(inc.media_wait) == 1
        ):
            # common-cause inference: wire time inflated on *every*
            # spoke, and all spokes ride one shared medium -> the cell
            # itself (not any single link) is the culprit
            return next(iter(inc.media_wait))
        return best_e

    # -- reporting ----------------------------------------------------------

    def attainment(self) -> Dict[str, Dict]:
        """Live per-workload SLO state (deterministic key order)."""
        out: Dict[str, Dict] = {}
        for wl in sorted(self._wl):
            st = self._wl[wl]
            out[wl] = {
                "slo": st.slo.name,
                "deadline_ms": 1e3 * st.slo.deadline_s,
                "target": st.slo.target,
                "observed": st.burn.n,
                "misses": st.burn.slow_sum,
                "fast_burn": st.burn.fast_burn,
                "slow_burn": st.burn.slow_burn,
                "p50_est_ms": 1e3 * st.quant.quantile(0.50),
                "p99_est_ms": 1e3 * st.quant.quantile(0.99),
                "incident_open": st.incident is not None,
            }
        return out

    def summary(self) -> Dict:
        """JSON-able doctor rollup (byte-stable across engines)."""
        return {
            "attainment": self.attainment(),
            "incidents": [i.summary() for i in self.incidents],
        }

    def summary_json(self) -> str:
        return json.dumps(self.summary(), sort_keys=True)

    def format_incident_report(self) -> str:
        """The doctor's verdict as a plain-text report."""
        lines: List[str] = []
        att = self.attainment()
        for wl, a in att.items():
            lines.append(
                f"== SLO [{wl} / {a['slo']}] deadline {a['deadline_ms']:.1f} ms "
                f"target {100 * a['target']:.0f}% — {a['observed']} observed, "
                f"{a['misses']} missed in window, "
                f"p99~{a['p99_est_ms']:.1f} ms =="
            )
        if not self.incidents:
            lines.append("no incidents: every SLO held within budget")
            return "\n".join(lines)
        for i, inc in enumerate(self.incidents):
            tail = " (open at end of run)" if inc.open_at_end else ""
            lines.append(
                f"incident {i}: [{inc.workload} / {inc.slo}] "
                f"t={inc.t_open:.3f}s -> {inc.t_close:.3f}s{tail} — "
                f"{inc.misses} misses ({inc.drops} drops) "
                f"over {inc.frames} frames"
            )
            for rank, cause in enumerate(inc.causes):
                lines.append(
                    f"  #{rank + 1} {cause.label}: "
                    f"+{1e3 * cause.excess_s:.3f} ms/frame vs baseline"
                )
            if inc.uplink_bytes_excess > 0.0:
                lines.append(
                    f"  signal: uplink "
                    f"+{inc.uplink_bytes_excess / 1e3:.1f} kB/frame vs baseline"
                )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# fault-injection catalog (the doctor's by-construction validation)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injectable fault and the verdict the doctor must reach.

    ``drifts`` are scheduled on the canonical doctor topology (a
    3-edge ``hetero_fleet_star`` over a shared cell — edges
    ``edge_0..2``, spokes ``5g_edge_0..2``, medium ``cell0``).
    ``migration`` overrides the fleet's migration config when the fault
    needs a pathological controller (the flap), else the bench default
    applies; ``disable_migration`` runs the fault with migration off
    entirely (a static-placement deployment — the lossy-link fault
    would otherwise be healed by draining the sick spoke, which is the
    *correct* adaptive response but leaves nothing to diagnose).
    ``expected`` is the cause label the doctor's verdict
    (:func:`doctor_verdict`) must match on both engines
    (the reference's `fleet_bench --doctor` gates on it).
    """

    name: str
    summary: str
    drifts: Tuple[object, ...]
    expected: str
    migration: Optional[MigrationConfig] = None
    disable_migration: bool = False


FAULTS: Dict[str, FaultSpec] = {
    "edge_throttle": FaultSpec(
        name="edge_throttle",
        summary="thermal throttle: edge_1 services inflate 8x mid-run "
        "(plan-invisible; lands in measured queueing)",
        drifts=(ServiceDrift(time=1.5, edge="edge_1", factor=8.0),),
        expected="queueing@edge_1",
    ),
    "cell_collapse": FaultSpec(
        name="cell_collapse",
        summary="cell collapse: every spoke of the shared cell degrades "
        "at once (bandwidth to a third, +25 ms radio latency) — wire "
        "time inflates on all edges, so the doctor's common-cause rule "
        "pins the shared medium, not any single spoke",
        drifts=tuple(
            LinkDrift(
                time=1.5,
                link=f"5g_edge_{i}",
                latency=0.025,
                bandwidth=20e6,
            )
            for i in range(3)
        ),
        expected="network@cell0",
    ),
    "lossy_keyframe": FaultSpec(
        name="lossy_keyframe",
        summary="lossy keyframe link: edge_0's spoke turns high-latency "
        "/ high-jitter (retransmitting keyframes); with placement "
        "pinned, the wire span inflates on that spoke alone",
        drifts=(
            LinkDrift(time=1.5, link="5g_edge_0", latency=0.030, jitter=0.015),
        ),
        expected="network@edge_0",
        disable_migration=True,
    ),
    "migration_flap": FaultSpec(
        name="migration_flap",
        summary="migration flap: a hair-trigger controller with a heavy "
        "tracker state (16 MB) chases an alternating throttle between "
        "edges; each move's state-transfer blackout drops frames",
        drifts=tuple(
            ServiceDrift(
                time=1.0 + 0.5 * k + 0.5 * phase,
                edge=f"edge_{k % 3}",
                factor=3.0 if phase == 0 else 1.0,
            )
            for k in range(14)
            for phase in (0, 1)
        ),
        expected="blackout",
        migration=MigrationConfig(
            min_dwell_frames=2,
            improvement_threshold=0.02,
            state_nbytes=16_000_000,
            wait_ewma_blend=1.0,
            wait_ewma_alpha=0.5,
            wait_ewma_half_life=0.5,
        ),
    ),
}

# SLO classes retuned for the doctor's scenario.  The canonical doctor
# fleet runs its camera at 12 fps (mixed workloads' healthy loops are
# 50-85 ms, so a 30 fps camera load-sheds *structurally* and every run
# looks sick); deadlines scale with the 83 ms frame period and the burn
# thresholds come down because a single-locus fault can only breach the
# fraction of a workload's clients parked on the sick edge (~1/2 here).
DOCTOR_CLASSES: Dict[str, SLOClass] = {
    "interactive": SLOClass(
        "interactive",
        deadline_s=100e-3,
        target=0.90,
        window=128,
        fast_window=24,
        fast_burn=4.0,
        slow_burn=2.0,
    ),
    "best_effort": SLOClass(
        "best_effort",
        deadline_s=200e-3,
        target=0.80,
        window=128,
        fast_window=24,
        fast_burn=4.0,
        slow_burn=2.0,
    ),
}


def doctor_verdict(
    monitor: "SLOMonitor",
) -> Tuple[Optional[str], Dict[str, float]]:
    """Aggregate a run's incidents into one ranked diagnosis.

    Each incident's causes are weighted by the incident's miss count
    (an incident that burned 250 frames of budget outranks a marginal
    one that opened on a transient), and excess seconds accumulate per
    cause label.  Returns ``(top_label_or_None, {label: score})`` —
    deterministic: ties break toward the lexicographically smallest
    label.
    """
    agg: Dict[str, float] = {}
    for inc in monitor.incidents:
        for cause in inc.causes:
            w = cause.excess_s * max(inc.misses, 1)
            agg[cause.label] = agg.get(cause.label, 0.0) + w
    if not agg:
        return None, agg
    top = max(sorted(agg), key=lambda k: agg[k])
    return top, agg
