"""Live migration: mid-run client re-dispatch with hysteresis.

The paper's client picks an offload target once and lives with it — the
exact thing it flags as "to be improved for achieving even better
performance".  AVEC-style virtualized edge accelerators only stay
utilized when clients can be *re-homed* as load shifts, so this module
closes the loop the fleet simulator left open: placement becomes
placement-over-time.

:class:`MigrationController` watches, per considered client,

* **per-edge load** — live slot-server queue depth (``load(now)``) and
  open-batch occupancy (``open_batch_size(key)``), the same signals the
  dispatch policies read; and
* **per-client link drift** — surfaced by the fleet's existing
  :class:`~repro_torch.cluster.plancache.DriftDetector`: a drifted client is
  considered immediately (the dwell gate is waived via ``force=True``)
  because its link genuinely changed under it.

A re-dispatch decision has three parts, all deterministic:

1. **Target selection** (``target_policy``).  The default,
   ``"predicted"``, takes the argmin of the live predicted per-frame
   time over all edges — cached plan total (so a *slower* edge is worse
   even when its queue is short, which pure queue-count policies cannot
   see) plus the live queueing excess, minus a batch-affinity credit on
   edges gathering an open batch under the client's computation key:
   ``batch_affinity``'s steering, live.  Any dispatch policy name
   (``least_queue``, ``batch_affinity``, ...) can be used instead; the
   policies that reduced to striping at t=0 admission finally see real
   queue depths and forming batches here.
2. **Hysteresis** gates the move: the client must have *dwelled* at
   least ``min_dwell_frames`` processed frames on its current edge
   (unless drift-forced), and the predicted per-frame time on the
   target must beat the current edge's by more than
   ``improvement_threshold`` (relative).  Thresholds at infinity turn
   migration off exactly — the run is bit-for-bit the static fleet
   (golden-tested), and migration count is monotone non-increasing in
   the dwell (property-tested).
3. **State transfer** is priced like any other leg: the client's warm
   tracker state — hand-model pose + PSO swarm payload
   (:func:`tracker_state_nbytes`) — crosses from the tier that holds it
   (the old edge, or home for a fully-local plan) to the new edge via
   :meth:`~repro_torch.core.costengine.CostEngine.migration_time` (RPC
   envelope + serialization + wire over the current, possibly drifted,
   links).  The fleet charges that latency to the client before its
   next frame, and re-plans it through the shared
   :class:`~repro_torch.cluster.plancache.PlanCache`.

The *prediction* the hysteresis gate uses is the cached plan total for
the candidate edge, inflated by the cost engine's occupancy model for
the load ahead of us — committed clients (assignment counts) or live
queue depth, whichever is deeper; fused batch time on batching tiers —
minus a batch-affinity credit on edges gathering a compatible open
batch (joining skips part of the gather-window dwell a fresh batch
would pay).  Candidate scoring uses stats-neutral cache lookups so the
cache hit-rate keeps measuring actual per-client planning work.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.cluster.dispatch import (
    DISPATCH_POLICIES,
    DispatchContext,
    edge_subtopology,
    make_dispatch,
)
from repro_torch.cluster.events import LinkTable
from repro_torch.cluster.plancache import PlanCache
from repro_torch.core.costengine import BatchServiceModel, CostEngine
from repro_torch.core.offload import Policy, Topology
from repro_torch.core.stages import StagedComputation


def tracker_state_nbytes(
    num_particles: int = 64, pose_dims: int = 27, dtype_bytes: int = 4
) -> int:
    """The warm per-client state a migration must ship.

    Hand-model pose (27 f32 — the 108-byte ``h_prev`` the staged
    computation carries) plus the PSO swarm payload: per-particle
    position, velocity and personal best, and the swarm's global best.
    Defaults match the paper-scale tracker (64 particles, 27-dim pose).
    """
    swarm = num_particles * 3 * pose_dims
    return dtype_bytes * (pose_dims + swarm + pose_dims)


DEFAULT_STATE_NBYTES = tracker_state_nbytes()


@dataclasses.dataclass(frozen=True)
class MigrationConfig:
    """Hysteresis knobs and state-payload size for live migration.

    ``min_dwell_frames`` — processed frames a client must sit on its
    current edge before a (non-drift-forced) move is considered; the
    flap brake.  ``improvement_threshold`` — relative predicted-latency
    improvement the target must clear (0.15 = "15% better or stay");
    ``float('inf')`` disables migration exactly.  ``state_nbytes`` —
    the migrating pose + swarm payload.  ``target_policy`` — how the
    candidate edge is picked: ``"predicted"`` (default) is the argmin
    of :meth:`MigrationController.predicted_frame_time` (live load +
    batch affinity + per-edge plan cost), or a load-aware
    ``dispatch.DISPATCH_POLICIES`` name to run that policy live
    (``round_robin`` is rejected: its blind rotation is meaningless as
    a re-dispatch target).  ``wait_ewma_blend`` / ``wait_ewma_alpha`` —
    predictor calibration against *measured* per-edge waits (see
    :meth:`MigrationController.observe_wait`); the default blend of 0
    is the exact historical model-only predictor.
    """

    min_dwell_frames: int = 30
    improvement_threshold: float = 0.15
    state_nbytes: int = DEFAULT_STATE_NBYTES
    target_policy: str = "predicted"
    # predictor calibration: blend a per-edge EWMA of *measured* frame
    # waits into the occupancy term.  Plan totals + live queue depth
    # cannot see an edge whose service times drifted (thermal
    # throttling: the same queue drains slower) — measured waits can.
    # ``wait_ewma_blend`` is the measured share (0 = pure model, the
    # exact historical predictor; 1 = pure measurement);
    # ``wait_ewma_alpha`` the EWMA smoothing of each new wait sample.
    wait_ewma_blend: float = 0.0
    wait_ewma_alpha: float = 0.25
    # measured evidence ages: the blend weight halves every this many
    # simulated seconds since an edge's last wait sample, so a stale
    # measurement (e.g. an evacuated edge whose throttle may have
    # ended) gradually hands the prediction back to the model instead
    # of repelling clients forever.  inf freezes evidence (no decay).
    wait_ewma_half_life: float = 3.0

    def __post_init__(self) -> None:
        if self.min_dwell_frames < 0:
            raise ValueError("min_dwell_frames must be >= 0")
        if self.improvement_threshold < 0.0:
            raise ValueError("improvement_threshold must be >= 0")
        if self.state_nbytes < 0:
            raise ValueError("state_nbytes must be >= 0")
        if not 0.0 <= self.wait_ewma_blend <= 1.0:
            raise ValueError("wait_ewma_blend must be in [0, 1]")
        if not 0.0 < self.wait_ewma_alpha <= 1.0:
            raise ValueError("wait_ewma_alpha must be in (0, 1]")
        if self.wait_ewma_half_life <= 0.0:
            raise ValueError("wait_ewma_half_life must be > 0")
        # round_robin's stateful rotation carries no load/latency signal:
        # as a live re-dispatch target it proposes edges blindly in cycle
        valid = {"predicted"} | (set(DISPATCH_POLICIES) - {"round_robin"})
        if self.target_policy not in valid:
            raise ValueError(
                f"target_policy {self.target_policy!r} not usable for "
                f"live re-dispatch; choose one of {sorted(valid)}"
            )


@dataclasses.dataclass(frozen=True)
class MigrationRecord:
    """One completed re-dispatch."""

    client: int
    time: float
    src: str  # edge assignment before the move
    dst: str  # edge assignment after the move
    state_src: str  # tier the warm state shipped from (old edge or home)
    nbytes: int
    latency: float  # priced state-transfer time charged to the client


@dataclasses.dataclass
class MigrationStats:
    """What the controller did — returned in ``FleetResult.migration``
    and surfaced per sweep point by ``capacity_sweep``."""

    records: List[MigrationRecord] = dataclasses.field(default_factory=list)
    considered: int = 0  # considerations that passed the dwell gate
    # decision accounting (telemetry): dwell-gated asks, and post-dwell
    # considerations that found no target clearing the improvement
    # threshold (staying put counts — the best target failed to beat
    # the current edge by the hysteresis margin).  accepted == count.
    rejected_dwell: int = 0
    rejected_threshold: int = 0

    @property
    def count(self) -> int:
        return len(self.records)

    @property
    def total_bytes(self) -> int:
        return sum(r.nbytes for r in self.records)

    @property
    def total_latency(self) -> float:
        return sum(r.latency for r in self.records)

    @property
    def mean_latency(self) -> float:
        return self.total_latency / self.count if self.count else 0.0

    def per_client(self) -> Dict[int, int]:
        counts: Dict[int, int] = {}
        for r in self.records:
            counts[r.client] = counts.get(r.client, 0) + 1
        return counts


class MigrationController:
    """Decides, at frame boundaries, whether a client moves edges.

    Shares the fleet's live objects — servers, link table, plan cache,
    assignment counts — so its observations are exactly what the event
    engine measures.  All methods are deterministic; ties in target
    selection break on edge name through the dispatch policies.
    """

    def __init__(
        self,
        config: MigrationConfig,
        topo: Topology,
        comp: StagedComputation,
        *,
        servers: Dict[str, object],
        policy: Policy = Policy.AUTO,
        planner: Optional[str] = None,
        cache: Optional[PlanCache] = None,
        link_table: Optional[LinkTable] = None,
        edges: Optional[List[str]] = None,
        assignments: Optional[Dict[str, int]] = None,
        codec=None,
        media: Optional[Dict[str, object]] = None,
    ):
        self.config = config
        self.topo = topo
        self.comp = comp
        self.policy = policy
        self.planner = planner
        self.cache = cache if cache is not None else PlanCache()
        self.link_table = link_table if link_table is not None else LinkTable(topo)
        self.servers = servers
        self.edges = list(edges) if edges is not None else [
            n for n in topo.tier_names() if n != topo.home
        ]
        self.assignments = (
            assignments
            if assignments is not None
            else {e: 0 for e in self.edges}
        )
        self.home = topo.home
        self.key = comp.name
        # the CodecModel candidate plans are priced under (the fleet
        # passes each client's live operating point per `consider`; this
        # is the fleet-level default for direct use)
        self.codec = codec
        # shared-medium occupancy (medium name -> SharedLink).  The
        # per-edge spoke medium is resolved once; its live queue_delay
        # joins the prediction OUTSIDE the scoring memo (occupancy is a
        # time-varying signal, never part of a plan's identity).  With
        # no shared media both are empty and the predictor is exact.
        self.media = media if media is not None else {}
        self._edge_medium = {
            e: self.media.get(
                topo.link_between(topo.home, e).medium
            )
            for e in self.edges
        }
        self._disp = (
            None
            if config.target_policy == "predicted"
            else make_dispatch(config.target_policy)
        )
        self._ctx = DispatchContext(
            topo=topo,
            comp=comp,
            policy=policy,
            edges=self.edges,
            servers=self.servers,
            link_table=self.link_table,
            assignments=self.assignments,
            media=self.media or None,
        )
        self._dwell: Dict[int, int] = {}
        # per-edge (EWMA, last-sample time) of measured per-frame waits
        # (queue + gather dwell + batch/throttle service inflation) —
        # the calibration signal `wait_ewma_blend` mixes into the
        # occupancy term, down-weighted as the evidence ages
        self._wait_ewma: Dict[str, Tuple[float, float]] = {}
        # scoring memo: (edge, current Link value) -> (plan, remote
        # service).  Post-dwell the controller scores every edge at
        # every frame finish; the inputs only change when a link drifts
        # (a drifted link is a NEW frozen Link value, so stale entries
        # can never be hit), so memoizing skips the subtopology build +
        # fingerprint + cache lookup on the hot stay-put path.
        self._scores: Dict[Tuple, Tuple] = {}
        self._batch_models = {
            e: BatchServiceModel.from_tier(topo.tier(e))
            for e in self.edges
            if topo.tier(e).batching
        }
        self.stats = MigrationStats()

    # -- dwell bookkeeping --------------------------------------------------

    def frame_done(self, client: int) -> None:
        """One processed frame of dwell on the client's current edge."""
        self._dwell[client] = self._dwell.get(client, 0) + 1

    def dwell(self, client: int) -> int:
        return self._dwell.get(client, 0)

    # -- measured-wait calibration -------------------------------------------

    def observe_wait(self, edge: str, wait: float, now: float = 0.0) -> None:
        """Feed one processed frame's measured non-plan time on
        ``edge`` (the fleet reports every frame finish).  Maintains the
        per-edge EWMA that ``wait_ewma_blend`` mixes into the
        predictor; with the blend at 0 the samples are recorded but
        never read, so the default predictor is bit-for-bit unchanged."""
        a = self.config.wait_ewma_alpha
        prev = self._wait_ewma.get(edge)
        self._wait_ewma[edge] = (
            wait if prev is None else a * wait + (1.0 - a) * prev[0],
            now,
        )

    def wait_ewma(self, edge: str) -> float:
        entry = self._wait_ewma.get(edge)
        return entry[0] if entry is not None else 0.0

    # -- prediction ---------------------------------------------------------

    def predicted_frame_time(
        self,
        edge: str,
        now: float,
        current: Optional[str] = None,
        codec=None,
        client_tier=None,
        comp: Optional[StagedComputation] = None,
    ) -> float:
        """What one frame would cost a client placed on ``edge`` now.

        Cached plan total under current link conditions — so a *slower*
        edge prices worse even with a short queue — inflated by the
        cost engine's occupancy model for the load ahead of us: the
        clients committed to the edge (assignment count, the smooth
        steady-state signal) or the requests actually in flight
        (``load(now)``, which dominates while a drained edge's queue is
        still emptying), whichever is deeper.  Pass ``current`` (the
        asking client's edge) so the mover does not count against
        itself.  Batching tiers price occupancy as the fused batch time
        of occ+1 items (the cost engine's model), and an edge gathering
        a compatible open batch earns a strict credit — joining it
        skips part of the gather-window dwell a fresh batch would pay —
        which is what steers migrating clients into forming batches.

        ``codec`` prices candidate plans at the asking client's codec
        operating point (compressed payloads change which edge wins on
        asymmetric links).  With ``wait_ewma_blend > 0`` the occupancy
        excess is blended with the edge's measured-wait EWMA — the
        calibration that catches *service-side* drift (a throttled edge
        serves the same queue slower; plan totals and queue depth alone
        mispredict it, tested in tests/test_migration.py)."""
        if comp is None:
            comp = self.comp
        link = self.link_table.get(
            self.topo.link_between(self.topo.home, edge).name
        )
        # client_tier joins the memo key: a heterogeneous fleet scores
        # each hardware class against its own plans (frozen Tier values
        # hash directly, like the frozen Link / CodecModel entries).
        # comp name too: a mixed fleet scores each workload against its
        # own plans (names are unique within a registry, and the cached
        # plan itself is still keyed on the full comp signature).
        memo_key = (edge, link, codec, client_tier, comp.name)
        cached = self._scores.get(memo_key)
        if cached is None:
            sub = edge_subtopology(
                self.topo, edge, self.link_table, client_tier=client_tier
            )
            plan, _ = self.cache.get_or_plan(
                comp,
                sub,
                self.policy,
                self.planner,
                record_stats=False,
                codec=codec,
            )
            service = sum(
                t for tier, t in plan.compute_by_tier if tier != self.home
            )
            self._scores[memo_key] = cached = (plan, service)
        plan, service = cached
        t = plan.total_time
        srv = self.servers[edge]
        if service > 0.0:
            cap = max(int(srv.capacity), 1)
            others = self.assignments.get(edge, 0) - (1 if edge == current else 0)
            occ = max(others, srv.load(now), 0)
            model = self._batch_models.get(edge)
            credit = 0.0
            if model is not None:
                # co-assigned clients ride the same fused launch: price
                # occupancy as the cost engine does — the batch time of
                # occ+1 items — not as processor sharing.  The summed
                # remote service is treated as ONE launch; a multi-stage
                # remote plan would pay the fixed batch overhead per
                # stage under the engine's per-stage pricing (the
                # processor-sharing branch below has no such gap: its
                # inflation factor is linear, so stage-wise and summed
                # inflation agree exactly)
                excess = model.batch_time([service] * (occ + 1)) - service
                if srv.open_batch_size(comp.name) > 0:
                    # a compatible batch is gathering RIGHT NOW: joining
                    # it skips ~half the gather-window dwell a fresh
                    # batch would pay — a small strict credit that
                    # breaks equal-load ties toward forming batches
                    credit = 0.5 * getattr(srv, "gather_window", 0.0)
            else:
                # contention_factor semantics: occ+1 requests, cap slots
                excess = service * max(0.0, (occ + 1) / cap - 1.0)
            blend = self.config.wait_ewma_blend
            measured = self._wait_ewma.get(edge)
            if blend > 0.0 and measured is not None:
                # the model term and the measured EWMA estimate the SAME
                # quantity (per-frame non-plan time); the blend decides
                # whose evidence to trust, down-weighted by the sample's
                # age so an edge nobody visits anymore (e.g. evacuated
                # after a throttle) hands the prediction back to the
                # model instead of repelling clients forever.  Guarded
                # so blend == 0 keeps the exact historical arithmetic.
                value, t_obs = measured
                age = max(0.0, now - t_obs)
                w = blend * 0.5 ** (age / self.config.wait_ewma_half_life)
                excess = (1.0 - w) * excess + w * value
            t += excess
            t -= credit
        med = self._edge_medium.get(edge)
        if med is not None:
            # live shared-uplink backlog on this edge's spoke: a
            # congested cell repels movers exactly like a deep queue.
            # Deliberately outside the scoring memo (occupancy is not
            # plan identity) and exactly 0.0 on an idle medium.
            t += med.queue_delay(now)
        return t

    # -- state-transfer pricing ---------------------------------------------

    def migration_time(
        self, state_src: str, dst: str, codec=None
    ) -> float:
        """Price the pose + swarm transfer over *current* link
        conditions (drifted links charge their drifted latency).  With
        a codec the state ships at the engine's keyframe pricing — the
        destination has no reference to delta against."""
        live = Topology(
            tiers=dict(self.topo.tiers),
            links={
                pair: self.link_table.get(link.name)
                for pair, link in self.topo.links.items()
            },
            home=self.topo.home,
            wrapper=self.topo.wrapper,
            wrapped=self.topo.wrapped,
        )
        engine = CostEngine(
            live, codec=codec if codec is not None else self.codec
        )
        return engine.migration_time(self.config.state_nbytes, state_src, dst)

    # -- the decision -------------------------------------------------------

    def consider(
        self,
        client: int,
        current: str,
        now: float,
        state_src: Optional[str] = None,
        force: bool = False,
        codec=None,
        client_tier=None,
        comp: Optional[StagedComputation] = None,
    ) -> Optional[Tuple[str, float]]:
        """Should ``client`` move off ``current``?  Returns ``(target,
        state_transfer_latency)`` and records the migration, or None.

        ``force=True`` (link drift) waives the dwell gate — the link
        changed under the client, so its placement is stale evidence —
        but never the improvement threshold: hysteresis still decides.
        ``codec`` is the asking client's live operating point: candidate
        plans and the state transfer are priced under it (None falls
        back to the controller's fleet-level default).  ``client_tier``
        is the asking client's own hardware class in a heterogeneous
        fleet: candidate plans are priced against it.  ``comp`` is the
        asking client's own workload in a mixed fleet: candidate plans,
        batch-affinity credits and the live dispatch policies all see
        the client's actual pipeline (None falls back to the
        controller's fleet-level default).
        """
        if codec is None:
            codec = self.codec
        if comp is None:
            comp = self.comp
        if not force and self._dwell.get(client, 0) < self.config.min_dwell_frames:
            self.stats.rejected_dwell += 1
            return None
        self.stats.considered += 1
        if self._disp is not None:
            # run the configured dispatch policy live; the mover itself
            # must not count against its own current edge, and the
            # policy must price candidates under the SAME codec the
            # hysteresis check uses (latency_weighted plans through it)
            self._ctx.now = now
            self._ctx.codec = codec
            self._ctx.client_tier = client_tier
            self._ctx.comp = comp
            orig = self.assignments.get(current, 0)
            self.assignments[current] = max(0, orig - 1)
            try:
                target = self._disp.assign(client, self._ctx)
            finally:
                self.assignments[current] = orig
            if target == current:
                self.stats.rejected_threshold += 1
                return None
            cur_t = self.predicted_frame_time(
                current, now, current, codec, client_tier, comp
            )
            new_t = self.predicted_frame_time(
                target, now, current, codec, client_tier, comp
            )
        else:
            times = {
                e: self.predicted_frame_time(
                    e, now, current, codec, client_tier, comp
                )
                for e in self.edges
            }
            target = min(self.edges, key=lambda e: (times[e], e))
            if target == current:
                self.stats.rejected_threshold += 1
                return None
            cur_t, new_t = times[current], times[target]
        # strict inequality, and (1 - inf) * cur_t == -inf: an infinite
        # threshold can never be cleared, which is the exact off-switch
        if not new_t < cur_t * (1.0 - self.config.improvement_threshold):
            self.stats.rejected_threshold += 1
            return None
        src = state_src if state_src is not None else self.home
        latency = self.migration_time(src, target, codec)
        self.stats.records.append(
            MigrationRecord(
                client=client,
                time=now,
                src=current,
                dst=target,
                state_src=src,
                nbytes=self.config.state_nbytes,
                latency=latency,
            )
        )
        self._dwell[client] = 0
        self.assignments[current] = max(0, self.assignments.get(current, 0) - 1)
        self.assignments[target] = self.assignments.get(target, 0) + 1
        return target, latency
