"""Fleet simulation: N thin clients vs a star of contended edge servers.

Each client replays the paper's deployment — a 30 fps camera, a serially
dependent per-frame tracker step, an offload plan priced by the cost
engine — but the edge servers are *shared*: every offloaded stage
occupies a FIFO service slot (``events.SlotServer``) for exactly the
compute time its plan charged to that tier, so queueing delay emerges
from the event interleaving instead of an averaged formula.

Per-request latency is exact: the plan's recorded latency legs are
re-drawn against current link conditions (``events.LinkTable``), which
with undrifted links is bit-identical — in value and rng consumption —
to ``PlanReport.jittered_total``, so a single client against a
capacity-1 edge reproduces ``sim.runtime.analytic_run`` frame-for-frame
(the golden test in tests/test_cluster.py).

The adaptive loop: plans come from a shared ``plancache.PlanCache``
(N identical clients cost O(num_edges) plans); each client's
``plancache.DriftDetector`` watches the leg latencies its requests
actually drew, and when they drift past the threshold only that client
re-plans, against the drifted link — a cache miss by fingerprint,
leaving every other client's cached plan untouched.  With a
``migration.MigrationConfig`` armed, re-planning escalates to
*re-dispatch*: the client can move to a different edge mid-run, paying
a priced pose + swarm state transfer, under dwell/improvement
hysteresis (see ``cluster/migration.py``).

Timing model per processed frame (documented approximation): all
non-service time — home compute, wrapper, uplink/downlink wire and
latency — is charged *before* the request reaches its first contended
tier; the request then holds one slot per remote tier, in placement
order, until that tier releases it (its solo compute share on FIFO
edges; the fused batch finish on batching edges).  Total frame latency
is therefore ``resampled plan total + sum of queue waits + batch
inflation``, which keeps the uncontended/unbatched case exactly the
analytic model while keeping recorded finishes consistent with the
event timeline under batching.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.cluster.dispatch import (
    DispatchContext,
    edge_subtopology,
    make_dispatch,
)
from repro_torch.cluster.events import (
    AdaptiveWindow,
    BatchingSlotServer,
    EventQueue,
    LinkTable,
    SlotServer,
    build_media,
)
from repro_torch.cluster.migration import (
    MigrationConfig,
    MigrationController,
    MigrationStats,
)
from repro_torch.cluster.plancache import (
    DriftDetector,
    PlanCache,
    topology_fingerprint,
)
from repro_torch.codec.rate import CodecConfig, RateController
from repro_torch.core.costengine import BatchServiceModel, PlanReport
from repro_torch.core.offload import Policy, Topology
from repro_torch.core.stages import StagedComputation
from repro_torch.sim.clock import CAMERA_FPS, FrameEvent, LoopStats


@dataclasses.dataclass(frozen=True)
class LinkDrift:
    """Inject new conditions on one link at a simulated time.

    ``latency``/``jitter`` take effect on every subsequent request draw
    (the per-leg resampling reads the live link table).  ``bandwidth``
    only enters through *re-planning*: wire time is baked into a plan's
    total, so a bandwidth change is invisible until something (e.g. a
    simultaneous latency drift) triggers a re-plan against the updated
    link — at which point the new plan prices the new bandwidth."""

    time: float
    link: str
    latency: Optional[float] = None
    jitter: Optional[float] = None
    bandwidth: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ServiceDrift:
    """Inject a *service-side* slowdown on one edge at a simulated time
    (thermal throttling, a noisy co-tenant): every service admitted
    from ``time`` on runs ``factor`` times longer.

    Plans cannot see this — their compute terms price the tier's
    nominal rate — and neither can the link drift detector (nothing
    crossed the wire differently).  The inflation lands entirely in
    *measured waits*, which is exactly the signal the migration
    controller's ``wait_ewma_blend`` calibration tracks."""

    time: float
    edge: str
    factor: float


@dataclasses.dataclass
class ClientResult:
    client: int
    edge: str  # final edge assignment (migration moves it over time)
    stats: LoopStats
    plan: PlanReport
    replans: int
    # summed non-plan time over processed frames: queue wait, plus on
    # batching edges gather-window dwell and batch service inflation
    # (EdgeLoad.mean_wait counts only the pre-service part)
    total_wait: float
    migrations: int = 0  # mid-run re-dispatches this client made
    rate_changes: int = 0  # codec operating-point switches this client made
    codec: Optional[object] = None  # final CodecModel (None = raw payloads)

    @property
    def mean_wait(self) -> float:
        n = len(self.stats.processed)
        return self.total_wait / n if n else 0.0


@dataclasses.dataclass
class EdgeLoad:
    name: str
    capacity: int
    clients: int  # clients assigned at the END of the run (post-migration)
    admitted: int
    busy_time: float
    mean_wait: float
    # fused-launch accounting (0 / 0.0 on non-batching edges)
    batches: int = 0
    mean_batch_size: float = 0.0
    peak_load: int = 0  # max concurrent in-flight seen at an admission


@dataclasses.dataclass
class LinkLoad:
    """Occupancy counters of one shared transmission medium
    (``events.SharedLink``): how much wire time it carried and how much
    extra delay contention imposed.  Empty ``FleetResult.links`` means
    the topology declared no shared media (every spoke private)."""

    name: str
    capacity: int  # transmission slots (0 = unlimited)
    admitted: int  # transmissions offered
    contended: int  # transmissions that queued
    busy_time: float  # wire seconds carried
    total_wait: float  # extra delay imposed

    @property
    def mean_wait(self) -> float:
        return self.total_wait / self.admitted if self.admitted else 0.0


@dataclasses.dataclass
class FleetResult:
    clients: List[ClientResult]
    edges: List[EdgeLoad]
    cache: PlanCache
    num_frames: int
    duration: float
    migration: Optional[MigrationStats] = None  # set when migration is armed
    # discrete events the engine processed — the denominator of the
    # events/sec number the reference's `fleet_bench --events` reports,
    # and a structural invariant the vectorized engine reproduces exactly
    events: int = 0
    # per-medium occupancy counters, in topology declaration order —
    # byte-identical between engines (engine-equivalence audit)
    links: List[LinkLoad] = dataclasses.field(default_factory=list)

    @property
    def drop_rate(self) -> float:
        total = sum(c.stats.total_frames for c in self.clients)
        dropped = sum(c.stats.dropped for c in self.clients)
        return dropped / total if total else 0.0

    @property
    def mean_achieved_fps(self) -> float:
        if not self.clients:
            return 0.0
        return sum(c.stats.achieved_fps for c in self.clients) / len(self.clients)

    @property
    def mean_loop_time(self) -> float:
        times = self._loop_times()
        return sum(times) / len(times) if times else 0.0

    @property
    def p99_loop_time(self) -> float:
        return self.loop_time_percentile(0.99)

    @property
    def total_replans(self) -> int:
        return sum(c.replans for c in self.clients)

    @property
    def total_migrations(self) -> int:
        return self.migration.count if self.migration is not None else 0

    @property
    def total_rate_changes(self) -> int:
        return sum(c.rate_changes for c in self.clients)

    @property
    def mean_uplink_bytes(self) -> float:
        """Mean per-frame uplink payload across clients' final plans —
        the codec's wire-side footprint (raw frame bytes when off)."""
        if not self.clients:
            return 0.0
        return sum(c.plan.uplink_bytes for c in self.clients) / len(self.clients)

    def _loop_times(self) -> List[float]:
        out: List[float] = []
        for c in self.clients:
            out.extend(c.stats.loop_times())
        return out

    def loop_time_percentile(self, q: float) -> float:
        times = sorted(self._loop_times())
        if not times:
            return 0.0
        idx = min(len(times) - 1, max(0, math.ceil(q * len(times)) - 1))
        return times[idx]


def plan_media(plan: PlanReport, media_of) -> Tuple[tuple, tuple]:
    """Aggregate a plan's per-hop wire seconds onto shared media:
    ``(up, down)`` where each is ``((SharedLink, wire_seconds), ...)``
    per distinct medium the plan's wire legs cross in that direction.
    Empty tuples when the fleet declares no shared media — the private-
    spoke fast path both engines take.  Shared by both engines so the
    aggregation (and its float summation order) cannot diverge."""
    if not media_of:
        return (), ()
    up: Dict[str, list] = {}
    down: Dict[str, list] = {}
    for lname, dwn, w in plan.wire_by_link:
        med = media_of.get(lname)
        if med is None or w <= 0.0:
            continue
        acc = down if dwn else up
        slot = acc.get(med.name)
        if slot is None:
            acc[med.name] = [med, w]
        else:
            slot[1] += w
    return (
        tuple((m, s) for m, s in up.values()),
        tuple((m, s) for m, s in down.values()),
    )


class _Client:
    """One thin client's frame loop, replaying ``sim.clock.FrameLoop``'s
    exact drop/supersede arithmetic against the shared event clock."""

    def __init__(
        self,
        idx: int,
        rng,
        edge: str,
        plan: PlanReport,
        home: str,
        plan_fp,
        rate: Optional[RateController] = None,
        tier=None,
        media_of=None,
        comp: Optional[StagedComputation] = None,
    ):
        self.idx = idx
        self.rng = rng
        self.edge = edge
        self.home = home
        self.tier = tier  # own hardware class (hetero fleets; None = default)
        self.comp = comp  # own workload (mixed fleets; set by run_fleet)
        self.media_of = media_of  # link name -> SharedLink (shared media)
        self.med_wait = 0.0  # shared-medium delay of the in-flight frame
        self.set_plan(plan, plan_fp)
        self.events: List[FrameEvent] = []
        self.t_free = 0.0
        self.last_processed = -1
        self.next_i = 0
        self.replans = 0
        self.migrations = 0
        self.total_wait = 0.0
        self.drifted = False
        self.rate = rate  # per-client codec rate controller (or None)
        self.rate_dirty = False  # operating point changed: re-plan next frame
        self.frames_since_probe = 0
        # in-flight frame: (index, arrival, start, sampled_total, observed)
        self.pending: Optional[Tuple[int, float, float, float, tuple]] = None

    @property
    def codec_model(self):
        """The CodecModel this client's plans are priced under."""
        return self.rate.model if self.rate is not None else None

    def set_plan(self, plan: PlanReport, plan_fp) -> None:
        self.plan = plan
        self.plan_fp = plan_fp  # link conditions the plan was priced under
        self.visits: Tuple[Tuple[str, float], ...] = tuple(
            (tier, t) for tier, t in plan.compute_by_tier if tier != self.home
        )
        self.service_total = sum(t for _, t in self.visits)
        # the wire seconds this plan offers each shared medium per frame
        self.up_media, self.down_media = plan_media(plan, self.media_of)


def run_fleet(
    topo: Topology,
    comp: StagedComputation,
    num_clients: int,
    num_frames: int = 300,
    policy: Policy = Policy.AUTO,
    dispatch: str = "round_robin",
    granularity: str = "single_step",
    planner: Optional[str] = None,
    seed: int = 0,
    camera_fps: float = CAMERA_FPS,
    cache: Optional[PlanCache] = None,
    drifts: Sequence[Union[LinkDrift, ServiceDrift]] = (),
    drift_threshold: float = 0.5,
    drift_window: int = 16,
    drift_min_samples: int = 8,
    probe_every: int = 30,
    batching: Optional[bool] = None,
    gather_window: float = 2e-3,
    migration: Optional[MigrationConfig] = None,
    codec: Optional[CodecConfig] = None,
    engine: str = "object",
    client_classes: Optional[Sequence[object]] = None,
    adaptive_window: Optional[AdaptiveWindow] = None,
    telemetry=None,
    workloads: Optional[Sequence[StagedComputation]] = None,
    slo=None,
) -> FleetResult:
    """Simulate ``num_clients`` identical clients sharing ``topo``'s edges.

    ``topo`` must be a star: every non-home tier one link from home (the
    hub models any one client's vantage point; the edge tiers and their
    service slots are shared across all of them).  Client ``c`` draws
    its request latencies from ``default_rng(seed + c)``, so client 0 of
    a ``seed``-seeded fleet consumes randomness exactly like
    ``analytic_run(..., seed=seed)``.

    A client running a fully-local plan sends nothing over the wire, so
    it cannot *observe* its link recover; every ``probe_every``
    processed frames such a client pings its edge link (compares current
    conditions against the fingerprint its plan was priced under) and
    re-plans on any change — otherwise a drift-then-recover sequence
    would strand it on the slow local plan forever.

    Batching: an edge tier declaring ``batching=True`` is served by a
    :class:`~repro_torch.cluster.events.BatchingSlotServer` — concurrent
    requests arriving within ``gather_window`` fuse into one launch with
    sublinear batch service time (``BatchServiceModel.from_tier``) —
    instead of a FIFO ``SlotServer``.  ``batching`` overrides the tiers'
    declarations fleet-wide (True forces fused serving on every edge,
    False forces plain FIFO); ``None`` respects each tier.  The trade:
    a wider gather window fuses more (cheaper service under load) but
    adds up to that much pre-service latency per frame.

    Migration: passing a :class:`~repro_torch.cluster.migration
    .MigrationConfig` arms a ``MigrationController`` — at every frame
    finish (and immediately on detected link drift) the client's
    placement is reconsidered against live queue depths and open
    batches, gated by the config's dwell/improvement hysteresis.  A
    migrating client drains its just-finished frame, pays the priced
    pose + swarm state transfer before its next frame starts, and
    re-plans against the new edge through the shared plan cache.
    ``migration=None`` (default) is bit-for-bit the static fleet.

    Codec: passing a :class:`~repro_torch.codec.rate.CodecConfig` arms a
    per-client :class:`~repro_torch.codec.rate.RateController` — every plan
    is priced under the client's current codec operating point
    (compressed payload bytes, encode/decode compute at the endpoints;
    the CodecModel is part of the plan-cache key, so clients at the
    same point share one plan), and at every frame finish the
    controller feeds observed link pressure and scene motion to the
    rate loop; an operating-point switch re-plans the client before
    its next frame (``ClientResult.rate_changes``).  ``codec=None``
    (default) ships raw payloads; the identity codec
    (``codec.rate.identity_config()``) is the golden off-switch —
    event-for-event the raw fleet.

    Engine: ``engine="vector"`` runs the same simulation through the
    array-backed hot loop in :mod:`repro_torch.cluster.fastfleet` — an order
    of magnitude faster at fleet scale, and event-for-event identical
    to the default ``"object"`` engine (property-tested in
    tests/test_engine_equivalence.py).

    Heterogeneity: ``client_classes`` is a sequence of client
    :class:`~repro_torch.core.offload.Tier` records; client ``c`` plans (and
    is dispatched, migrated and priced) against its own hardware class
    ``client_classes[c % len(client_classes)]`` instead of the star's
    nominal home tier.  ``None`` (default) keeps the homogeneous fleet.

    Adaptive batching: ``adaptive_window`` (an
    :class:`~repro_torch.cluster.events.AdaptiveWindow`) sizes each batching
    edge's gather window from its observed inter-arrival EWMA — idle
    edges stop paying the window as pure latency.  ``None`` (default)
    keeps the fixed window exactly.

    Mixed traffic: ``workloads`` is a sequence of
    :class:`~repro_torch.core.stages.StagedComputation` records (e.g. the
    registry in :mod:`repro_torch.core.workloads`); client ``c`` runs
    ``workloads[c % len(workloads)]`` instead of ``comp`` — it plans,
    dispatches, migrates, batches (fused launches only join under the
    same workload key) and re-plans against its own pipeline, on both
    engines event-for-event identically.  ``workloads=None`` (default)
    keeps the homogeneous fleet bit-for-bit, and ``workloads=(comp,)``
    is the golden off-switch — event-for-event the ``comp`` fleet.

    Telemetry: passing a :class:`~repro_torch.cluster.telemetry.Telemetry`
    records per-frame span traces (exact loop-time decomposition,
    Chrome-trace exportable), a metrics registry (cache, migration,
    codec, server occupancy/batch instruments), and the inputs of the
    latency-attribution report.  Purely observational: both engines
    record the identical trace, and ``telemetry=None`` (default) is
    bit-for-bit the uninstrumented fleet.

    SLO monitoring: passing an :class:`~repro_torch.cluster.slo.SLOMonitor`
    (``slo=SLOMonitor(...)``) arms *online* SLO tracking on top of the
    telemetry hooks — streaming windowed quantile/attainment estimators
    per (workload, SLO class), multi-window burn-rate alerting that
    opens :class:`~repro_torch.cluster.slo.Incident` records mid-run, and a
    root-cause attributor that diffs each incident window's span
    profile against the rolling healthy baseline.  An ``SLOMonitor``
    *is* a ``Telemetry`` (same hooks, strictly more bookkeeping), so
    ``slo=`` and ``telemetry=`` are mutually exclusive; ``slo=None``
    (default) is bit-for-bit the unmonitored fleet on both engines.
    """
    if num_clients < 1:
        raise ValueError("need at least one client")
    if slo is not None:
        if telemetry is not None:
            raise ValueError(
                "pass either slo= or telemetry=, not both — an SLOMonitor "
                "is a Telemetry and records the full trace itself"
            )
        telemetry = slo
    if granularity == "single_step":
        _prep = lambda cmp: cmp.fused()  # noqa: E731
    elif granularity == "multi_step":
        _prep = lambda cmp: cmp  # noqa: E731
    else:
        raise ValueError(granularity)
    comp_used = _prep(comp)
    if workloads is not None and not workloads:
        raise ValueError("workloads must be non-empty when provided")
    workloads_used = (
        tuple(_prep(w) for w in workloads) if workloads is not None else None
    )

    edges = [n for n in topo.tier_names() if n != topo.home]
    if not edges:
        raise ValueError("fleet topology has no edge tiers")
    for e in edges:
        if len(topo.path_tiers(topo.home, e)) != 2:
            raise ValueError(
                f"fleet topology must be a star; tier {e!r} is not "
                "directly linked to home"
            )
    if batching is not None and any(
        topo.tier(e).batching != batching for e in edges
    ):
        # the override changes the tiers the cost engine prices, so it
        # must be baked into the topology (and its cache fingerprints)
        topo = Topology(
            tiers={
                name: (
                    dataclasses.replace(t, batching=batching)
                    if name != topo.home
                    else t
                )
                for name, t in topo.tiers.items()
            },
            links=dict(topo.links),
            home=topo.home,
            wrapper=topo.wrapper,
            wrapped=topo.wrapped,
        )

    if engine not in ("object", "vector"):
        raise ValueError(
            f"unknown engine {engine!r}; choose 'object' or 'vector'"
        )
    classes = tuple(client_classes) if client_classes else None
    if engine == "vector":
        from repro_torch.cluster.fastfleet import run_fleet_vectorized

        return run_fleet_vectorized(
            topo=topo,
            comp_used=comp_used,
            edges=edges,
            num_clients=num_clients,
            num_frames=num_frames,
            policy=policy,
            dispatch=dispatch,
            planner=planner,
            seed=seed,
            camera_fps=camera_fps,
            cache=cache,
            drifts=drifts,
            drift_threshold=drift_threshold,
            drift_window=drift_window,
            drift_min_samples=drift_min_samples,
            probe_every=probe_every,
            gather_window=gather_window,
            adaptive_window=adaptive_window,
            migration=migration,
            codec=codec,
            client_classes=classes,
            telemetry=telemetry,
            workloads=workloads_used,
        )

    cache = cache if cache is not None else PlanCache()
    link_table = LinkTable(topo)
    # shared transmission media (cell/backhaul): one SharedLink per
    # declared medium, plus the link-name -> medium mapping clients use
    # to split their plans' wire legs.  Both stay empty on private-spoke
    # topologies, and every contention hook below is gated on that.
    media = build_media(topo)
    media_of = {
        link.name: media[link.medium]
        for link in topo.links.values()
        if link.medium
    }
    q = EventQueue()
    servers: Dict[str, object] = {}
    for e in edges:
        tier = topo.tier(e)
        if tier.batching:
            servers[e] = BatchingSlotServer(
                e,
                tier.capacity,
                queue=q,
                model=BatchServiceModel.from_tier(tier),
                gather_window=gather_window,
                adaptive=adaptive_window,
            )
        else:
            servers[e] = SlotServer(e, tier.capacity)
    tel = telemetry
    if tel is not None:
        # wire instrumentation before admission planning so the initial
        # cache misses are observed too (shared media carry the same
        # telemetry attribute as the slot servers)
        tel.attach(
            cache=cache, servers=list(servers.values()) + list(media.values())
        )
    detector = DriftDetector(
        threshold=drift_threshold,
        window=drift_window,
        min_samples=drift_min_samples,
    )
    period = 1.0 / camera_fps

    # every client's rate controller starts at the same deterministic
    # operating point, so admission-time dispatch prices with it too
    init_codec = RateController(codec).model if codec is not None else None
    ctx = DispatchContext(
        topo=topo,
        comp=comp_used,
        policy=policy,
        edges=edges,
        servers=servers,
        link_table=link_table,
        assignments={},
        codec=init_codec,
        media=media,
    )
    disp = make_dispatch(dispatch)
    nw = len(workloads_used) if workloads_used else 0
    clients: List[_Client] = []
    for c in range(num_clients):
        tier_c = classes[c % len(classes)] if classes else None
        comp_c = workloads_used[c % nw] if workloads_used else comp_used
        ctx.client_tier = tier_c
        ctx.comp = comp_c
        edge = disp.assign(c, ctx)
        ctx.assignments[edge] = ctx.assignments.get(edge, 0) + 1
        sub = edge_subtopology(topo, edge, link_table, client_tier=tier_c)
        rate = (
            RateController(codec, client_id=c) if codec is not None else None
        )
        plan, _ = cache.get_or_plan(
            comp_c,
            sub,
            policy,
            planner,
            codec=rate.model if rate is not None else None,
        )
        clients.append(
            _Client(
                c,
                np.random.default_rng(seed + c),
                edge,
                plan,
                topo.home,
                topology_fingerprint(sub),
                rate=rate,
                tier=tier_c,
                media_of=media_of,
                comp=comp_c,
            )
        )
    if tel is not None:
        home_cls = topo.tier(topo.home).name
        tel.register_clients(
            {
                c.idx: (c.tier.name if c.tier is not None else home_cls)
                for c in clients
            }
        )
        tel.register_workloads({c.idx: c.comp.name for c in clients})

    controller: Optional[MigrationController] = None
    if migration is not None:
        controller = MigrationController(
            migration,
            topo=topo,
            comp=comp_used,
            policy=policy,
            planner=planner,
            cache=cache,
            link_table=link_table,
            servers=servers,
            edges=edges,
            assignments=ctx.assignments,
            codec=init_codec,
            media=media,
        )

    # --- event handlers ---------------------------------------------------

    def replan(client: _Client, edge: str) -> None:
        """Re-plan ``client`` against ``edge`` under current link
        conditions AND its current codec operating point, resetting its
        adaptive-loop state (shared by the drift-replan, rate-switch
        and migration paths so they cannot diverge)."""
        sub = edge_subtopology(topo, edge, link_table, client_tier=client.tier)
        plan, _ = cache.get_or_plan(
            client.comp, sub, policy, planner, codec=client.codec_model
        )
        client.set_plan(plan, topology_fingerprint(sub))
        client.drifted = False
        client.rate_dirty = False
        client.frames_since_probe = 0
        detector.reset(client.idx)

    def start_frame(client: _Client) -> None:
        i = client.next_i
        if i >= num_frames:
            return
        if client.drifted or client.rate_dirty:
            if client.drifted:
                client.replans += 1
                if tel is not None:
                    tel.count("plan.replans.drift")
            elif tel is not None:
                tel.count("plan.replans.rate")
            replan(client, client.edge)
        arrival = i * period
        start = max(arrival, client.t_free)
        newest = min(int(start / period), num_frames - 1)
        if newest > i:
            i = newest
            arrival = i * period
            start = max(arrival, client.t_free)
        sampled, observed = link_table.sample_plan_latency(client.plan, client.rng)
        client.pending = (i, arrival, start, sampled, observed)
        client.med_wait = 0.0
        if client.visits:
            q.schedule(
                start + (sampled - client.service_total),
                lambda c=client: visit(c, 0, 0.0),
            )
        else:
            q.schedule(start + sampled, lambda c=client: finish(c, 0.0))

    def visit(
        client: _Client, vidx: int, wait_acc: float, up_paid: bool = False
    ) -> None:
        if vidx == 0 and client.up_media and not up_paid:
            # offer this frame's uplink wire time to its shared media at
            # the time it would have cleared them uncontended (this very
            # event).  A busy cell delays the request's arrival at the
            # edge: one rescheduled visit carrying the delay as wait.
            # An idle (or unlimited) medium returns a literal 0.0 and
            # the original path continues untouched — bit-for-bit the
            # private-spoke fleet.
            uw = 0.0
            for med, svc in client.up_media:
                uw += med.admit(q.now, svc)
            if uw > 0.0:
                client.med_wait += uw
                q.schedule(
                    q.now + uw,
                    lambda c=client, w=wait_acc + uw: visit(c, 0, w, True),
                )
                return
        tier, service = client.visits[vidx]
        arrived = q.now

        def placed(
            svc_start: float,
            svc_end: float,
            c=client,
            vidx=vidx,
            wait_acc=wait_acc,
            arrived=arrived,
            service=service,
        ) -> None:
            # wait has two parts: queue + gather-window dwell before the
            # slot (svc_start - arrived), and batch service inflation —
            # the member is occupied until the BATCH finish svc_end, not
            # its solo finish svc_start + service, and `finish` rebuilds
            # the frame time from the solo `sampled` total.  Kept as a
            # separate term (not folded into svc_start) because FIFO
            # serving and batches of one have svc_end == svc_start +
            # service by the same float ops, so the inflation is exactly
            # 0.0 and the zero-wait golden equivalences stay bit-for-bit.
            wait = wait_acc + (svc_start - arrived) + (
                svc_end - (svc_start + service)
            )
            if tel is not None:
                tel.visit_placed(
                    c.idx,
                    isinstance(servers[tier], BatchingSlotServer),
                    arrived,
                    svc_start,
                    svc_end,
                    service,
                )
            if vidx + 1 < len(c.visits):
                q.schedule(svc_end, lambda: visit(c, vidx + 1, wait))
            else:
                q.schedule(svc_end, lambda: finish(c, wait))

        # unbatched servers invoke `placed` synchronously (identical to
        # the historical admit-then-schedule path); batching servers
        # defer it to their gather-window close event
        servers[tier].submit(arrived, service, placed, key=client.comp.name)

    def finish(client: _Client, wait: float) -> None:
        i, arrival, start, sampled, observed = client.pending
        client.pending = None
        # canonical finish: waits appended after the resampled plan total,
        # so a zero-wait run is bit-identical to the analytic FrameLoop
        fin = (start + sampled) + wait
        if client.down_media or (client.up_media and not client.visits):
            # downlink legs (and uplink legs of visit-less plans, which
            # have no visit event to admit them at) clear their shared
            # media at the uncontended finish time; contention stretches
            # the frame synchronously.  mw == 0.0 leaves wait/fin exactly
            # untouched — the off-switch golden.
            mw = 0.0
            if not client.visits:
                for med, svc in client.up_media:
                    mw += med.admit(fin, svc)
            for med, svc in client.down_media:
                mw += med.admit(fin, svc)
            if mw > 0.0:
                client.med_wait += mw
                wait += mw
                fin += mw
        client.events.append(
            FrameEvent(i, arrival, start, fin, i - client.last_processed)
        )
        client.last_processed = i
        client.next_i = i + 1
        client.t_free = fin
        client.total_wait += wait
        if tel is not None:
            tel.frame_done(
                client.idx,
                i,
                client.edge,
                start,
                fin,
                client.plan,
                tuple(d for _, d in observed),
                link_wait=client.med_wait,
            )
        if observed:
            if detector.observe(client.idx, client.plan, observed):
                client.drifted = True
        else:
            # leg-less (fully local) plan: nothing crosses the wire, so
            # probe the link periodically to notice recovery/changes
            client.frames_since_probe += 1
            if client.frames_since_probe >= probe_every:
                client.frames_since_probe = 0
                sub = edge_subtopology(
                    topo, client.edge, link_table, client_tier=client.tier
                )
                if topology_fingerprint(sub) != client.plan_fp:
                    client.drifted = True
        if client.rate is not None:
            # feed the rate loop this frame's observed leg draws and
            # motion index; a switch re-plans (same codec-keyed cache)
            # before the next frame starts.  The controller's own
            # `switches` counter is the single source of truth.
            if (
                client.rate.observe(
                    i, observed, client.plan, cell_wait=client.med_wait
                )
                is not None
            ):
                client.rate_dirty = True
        if controller is not None and client.visits:
            # report the measured non-plan time to the predictor's
            # per-edge wait EWMA (read only when wait_ewma_blend > 0)
            controller.observe_wait(client.edge, wait, q.now)
        if controller is not None and client.next_i < num_frames:
            # the just-finished frame IS the drain: re-dispatch decisions
            # land only at frame boundaries, never with a frame in flight
            # (and never after the final frame — a client with nothing
            # left to serve must not record a phantom move)
            controller.frame_done(client.idx)
            move = controller.consider(
                client.idx,
                client.edge,
                q.now,
                # the warm state lives where the current plan computes:
                # the serving edge, or home for a fully-local plan
                state_src=(
                    client.visits[0][0] if client.visits else topo.home
                ),
                force=client.drifted,
                codec=client.codec_model,
                client_tier=client.tier,
                comp=client.comp,
            )
            if move is not None:
                target, mig_latency = move
                if tel is not None:
                    tel.migration(client.idx, fin, mig_latency, client.edge, target)
                client.edge = target
                client.migrations += 1
                # the state transfer blocks the client between frames;
                # the move is a re-dispatch, not a replan, so it counts
                # in ClientResult.migrations rather than replans
                client.t_free = fin + mig_latency
                replan(client, target)
        start_frame(client)

    for client in clients:
        q.schedule(0.0, lambda c=client: start_frame(c))
    for d in drifts:
        if isinstance(d, ServiceDrift):
            if d.edge not in servers:
                raise ValueError(f"ServiceDrift targets unknown edge {d.edge!r}")
            q.schedule(
                d.time,
                lambda d=d: setattr(servers[d.edge], "service_scale", d.factor),
            )
        else:
            q.schedule(
                d.time,
                lambda d=d: link_table.set(
                    d.link, latency=d.latency, jitter=d.jitter, bandwidth=d.bandwidth
                ),
            )
    q.run()

    client_results = []
    for client in clients:
        duration = client.events[-1].finish if client.events else 0.0
        client_results.append(
            ClientResult(
                client=client.idx,
                edge=client.edge,
                stats=LoopStats(client.events, num_frames, duration),
                plan=client.plan,
                replans=client.replans,
                total_wait=client.total_wait,
                migrations=client.migrations,
                rate_changes=(
                    client.rate.switches if client.rate is not None else 0
                ),
                codec=client.codec_model,
            )
        )
    edge_loads = [
        EdgeLoad(
            name=e,
            capacity=servers[e].capacity,
            clients=ctx.assignments.get(e, 0),
            admitted=servers[e].admitted,
            busy_time=servers[e].busy_time,
            mean_wait=servers[e].mean_wait,
            batches=servers[e].batches,
            mean_batch_size=servers[e].mean_batch_size,
            peak_load=servers[e].peak_load,
        )
        for e in edges
    ]
    result = FleetResult(
        clients=client_results,
        edges=edge_loads,
        cache=cache,
        num_frames=num_frames,
        duration=max((c.stats.duration for c in client_results), default=0.0),
        migration=controller.stats if controller is not None else None,
        events=q.processed,
        links=[
            LinkLoad(
                name=m.name,
                capacity=m.capacity,
                admitted=m.admitted,
                contended=m.contended,
                busy_time=m.busy_time,
                total_wait=m.total_wait,
            )
            for m in media.values()
        ],
    )
    if tel is not None:
        tel.finish_run(
            result,
            rates=(
                [c.rate for c in clients] if codec is not None else None
            ),
        )
        tel.detach(
            cache=cache, servers=list(servers.values()) + list(media.values())
        )
    return result


@dataclasses.dataclass
class SweepPoint:
    num_clients: int
    result: FleetResult

    @property
    def fps(self) -> float:
        return self.result.mean_achieved_fps

    @property
    def drop_rate(self) -> float:
        return self.result.drop_rate

    @property
    def p99(self) -> float:
        return self.result.p99_loop_time

    # migration stats surfaced per point (0 / 0.0 when migration is off)
    # so sweep reports never drop the controller's state between points
    @property
    def migrations(self) -> int:
        m = self.result.migration
        return m.count if m is not None else 0

    @property
    def mean_migration_latency(self) -> float:
        m = self.result.migration
        return m.mean_latency if m is not None else 0.0


def capacity_sweep(
    topo: Topology,
    comp: StagedComputation,
    client_counts: Sequence[int] = (1, 2, 4, 8, 16, 32),
    **kwargs,
) -> List[SweepPoint]:
    """The Fig. 3 accounting at fleet scale: clients vs achieved fps,
    drop rate and tail latency.  Each point is an independent seeded
    run, so adding clients never perturbs the smaller runs.

    One ``PlanCache`` is shared across every point (unless the caller
    passes their own): the sweep re-runs identical clients against
    identical link conditions, so point N's plans are point 1's cache
    hits — N identical clients cost O(num_edges) plans for the *whole*
    sweep, not per point (asserted in tests/test_cluster.py)."""
    if kwargs.get("cache") is None:
        kwargs["cache"] = PlanCache()
    return [
        SweepPoint(n, run_fleet(topo, comp, num_clients=n, **kwargs))
        for n in client_counts
    ]
