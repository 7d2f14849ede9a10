"""Vectorized fleet engine: the discrete-event hot loop as flat arrays.

``fleet.run_fleet``'s object engine spends its time on pure-Python
object churn: a heapq of ``_Event`` dataclasses (whose generated
``__lt__`` dominates at depth), three closures allocated per frame, a
``FrameEvent`` dataclass per processed frame, per-leg scalar
``rng.normal`` draws and a drift-detector ring sum per leg per frame.
This module re-implements the *same simulation* — same control flow,
same tie-breaking, same servers, same seeded RNG streams — with the
churn removed:

* **Packed-payload event heap.**  Events are ``(time, seq, payload)``
  tuples on ``heapq``, where ``payload`` packs ``(id << 2) | kind`` into
  one int — no event objects, no ``__lt__`` dispatch, C-speed sifts.
  (A literal binary heap over preallocated NumPy arrays was measured
  ~8x *slower* per push/pop pair than C ``heapq`` at fleet depths —
  Python-level sift loops lose to the C implementation even counting
  tuple allocation — so "array-backed" here means the *state* lives in
  arrays while the ordering structure stays in C.)
* **Struct-of-arrays client state.**  Per-client scalars (frame
  counters, free times, accumulated waits, pending-frame slots) live in
  flat Python lists indexed by client id, reused every frame — the
  slab-allocation replacement for the object engine's per-frame tuple
  and ``FrameEvent`` allocations.  Processed-frame records append to
  per-client ``array('d')`` columns and materialize into ``FrameEvent``
  objects only if a caller actually reads ``stats.processed``
  (:class:`ArrayLoopStats`).
* **Inline FIFO admission.**  ``SlotServer.admit``'s slot-heap and
  stats arithmetic is inlined into the visit event over struct-of-
  arrays server state.  The slot and in-flight heaps *alias the
  server's own lists* (so ``MigrationController`` reads live load
  mid-run), while the scalar counters accumulate in flat lists and
  write back to the ``SlotServer`` objects after the loop.
  ``heapreplace`` substitutes for pop-then-push: both leave the same
  multiset of slot-free times, and a min-heap's pop sequence is a pure
  function of the multiset, so every admission sees the same ``free``
  value either way.  Batching servers keep their object path — fused
  launches are rare events, FIFO admissions are the hot path.
* **Block-drawn RNG.**  Each client keeps a buffer of *raw* standard
  normals (refilled via ``Generator.standard_normal(n)``, which
  consumes the stream exactly like n scalar draws) and transforms them
  lazily, a block of frames at a time, into per-leg latency draws with
  vectorized ``max(0, lat + jit * z)`` — bit-identical to the object
  engine's per-leg ``rng.normal(lat, jit)`` because NumPy computes
  exactly ``loc + scale * standard_normal()``.  Blocks invalidate on
  link-table mutation (``LinkTable.version``) or re-plan; unconsumed
  normals stay buffered so the stream position never diverges.
* **Precomputed drift decisions.**  The per-frame ``DriftDetector``
  ring sums are evaluated for the whole block at build time with a
  prefix-sum over [ring snapshot ++ block draws].  Prefix-sum means
  reassociate the float additions, so each decision carries a
  certainty margin ~1e-9 (about 100x the worst-case reassociation
  error at these window lengths, about 1e5x smaller than any physical
  latency signal): frames whose |deviation - tolerance| falls inside
  the margin are re-evaluated at finish time with the object engine's
  exact sequential-sum arithmetic.  Ring buffers themselves update
  lazily (``applied_upto``) — only at block boundaries, re-plans and
  exact re-evaluations — never per frame.
* **Cohort-batched admission.**  The t=0 cohort — one START event per
  client, always the same timestamp — is drained as a straight loop
  before entering the event loop (the heap never sees it), with
  sequence numbers reserved so everything scheduled during the cohort
  orders exactly as the object engine's heap would have ordered it.

What is deliberately NOT re-implemented: ``BatchingSlotServer``, the
``PlanCache``, the ``MigrationController`` and the ``RateController``
are the *same objects* the object engine uses, and the FIFO/detector
fast paths above are value-equivalent transformations of
``SlotServer.admit`` / ``DriftDetector.observe`` — semantics are
shared by construction or by float-op-order replication, not loosely
approximated.  The engines are asserted event-for-event identical
(results, stats, cache counters, event counts) in
tests/test_engine_equivalence.py.
"""

from __future__ import annotations

import gc
import heapq
from array import array
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cluster.dispatch import (
    DispatchContext,
    edge_subtopology,
    make_dispatch,
)
from repro_torch.cluster.events import (
    AdaptiveWindow,
    BatchingSlotServer,
    LinkTable,
    SlotServer,
    build_media,
)
from repro_torch.cluster.migration import MigrationConfig, MigrationController
from repro_torch.cluster.plancache import PlanCache, topology_fingerprint
from repro_torch.codec.rate import CodecConfig, RateController
from repro_torch.core.costengine import BatchServiceModel
from repro_torch.core.offload import Policy, Topology
from repro_torch.core.stages import StagedComputation
from repro_torch.sim.clock import FRAME_BUDGET, FrameEvent

# event kinds, packed into the low bits of the payload int
_K_VISIT = 0
_K_FINISH = 1
_K_CALLBACK = 2  # deferred callable (batch-close events from the servers)
_K_DRIFT = 3
_KIND_BITS = 2
_KIND_MASK = (1 << _KIND_BITS) - 1

# max frames per transformed latency block (sampling amortization unit);
# small enough that 10k clients' live blocks stay tens of MB
_BLOCK = 128


class ArrayLoopStats:
    """``sim.clock.LoopStats`` over parallel arrays.

    Field-for-field the same observables (same float arithmetic), but
    the per-frame records live in ``array('d')``/``array('q')`` columns;
    ``FrameEvent`` objects are materialized only if ``processed`` is
    actually read.  Arrivals and gaps are not even recorded — they are
    pure functions of the frame indices (``i * period`` with the exact
    expression the engine used, and consecutive-index differences), so
    the hot loop appends three columns, not five.
    """

    __slots__ = (
        "_idx",
        "_start",
        "_finish",
        "_period",
        "total_frames",
        "duration",
        "_events",
    )

    def __init__(self, idx, start, finish, total_frames, period):
        self._idx = idx
        self._start = start
        self._finish = finish
        self._period = period
        self.total_frames = total_frames
        self.duration = finish[-1] if len(finish) else 0.0
        self._events: Optional[List[FrameEvent]] = None

    @property
    def processed(self) -> List[FrameEvent]:
        if self._events is None:
            period = self._period
            last = -1
            events = []
            for i, s, f in zip(self._idx, self._start, self._finish):
                events.append(FrameEvent(i, i * period, s, f, i - last))
                last = i
            self._events = events
        return self._events

    def loop_times(self) -> List[float]:
        return [f - s for s, f in zip(self._start, self._finish)]

    @property
    def achieved_fps(self) -> float:
        n = len(self._finish)
        if not n or self.duration <= 0:
            return 0.0
        return n / self.duration

    @property
    def dropped(self) -> int:
        return self.total_frames - len(self._finish)

    @property
    def drop_rate(self) -> float:
        return self.dropped / max(self.total_frames, 1)

    @property
    def mean_gap(self) -> float:
        idx = self._idx
        n = len(idx) - 1
        return (idx[-1] - idx[0]) / n if n > 0 else 1.0

    @property
    def mean_loop_time(self) -> float:
        times = self.loop_times()
        return sum(times) / len(times) if times else 0.0

    @property
    def realtime(self) -> bool:
        return self.mean_loop_time <= FRAME_BUDGET


class _ShimQueue:
    """The ``EventQueue`` facade handed to :class:`BatchingSlotServer`.

    The servers only ever call ``schedule(time, fn)`` (their gather-
    window close) and read ``now``; the shim turns each close into a
    packed ``_K_CALLBACK`` event on the engine's tuple heap, sharing the
    engine's sequence counter so batch closes order against frame
    events exactly as they do on the object engine's queue.
    """

    __slots__ = ("now", "heap", "seq", "cbs")

    def __init__(self) -> None:
        self.now = 0.0
        self.heap: List[Tuple[float, int, int]] = []
        self.seq = 0
        self.cbs: List[object] = []

    def schedule(self, time, fn) -> None:
        cbs = self.cbs
        heapq.heappush(
            self.heap,
            (
                time if time > self.now else self.now,
                self.seq,
                (len(cbs) << _KIND_BITS) | _K_CALLBACK,
            ),
        )
        self.seq += 1
        cbs.append(fn)


def run_fleet_vectorized(
    *,
    topo: Topology,
    comp_used: StagedComputation,
    edges: List[str],
    num_clients: int,
    num_frames: int,
    policy: Policy,
    dispatch: str,
    planner: Optional[str],
    seed: int,
    camera_fps: float,
    cache: Optional[PlanCache],
    drifts: Sequence[object],
    drift_threshold: float,
    drift_window: int,
    drift_min_samples: int,
    probe_every: int,
    gather_window: float,
    adaptive_window: Optional[AdaptiveWindow],
    migration: Optional[MigrationConfig],
    codec: Optional[CodecConfig],
    client_classes: Optional[Tuple[object, ...]],
    telemetry=None,
    workloads: Optional[Tuple[StagedComputation, ...]] = None,
) -> "FleetResult":
    """The vectorized twin of ``fleet.run_fleet``'s event loop.

    Called by ``run_fleet(engine="vector")`` with an already-normalized
    topology (batching override baked in) and computation; do not call
    directly.  Every schedule call, RNG draw and server interaction
    happens in the same order as the object engine's, so results are
    event-for-event identical.
    """
    # imported here: fleet.py imports this module lazily inside
    # run_fleet, so a top-level back-import would be cycle-prone
    from repro_torch.cluster.fleet import (
        ClientResult,
        EdgeLoad,
        FleetResult,
        LinkLoad,
        ServiceDrift,
        plan_media,
    )

    N = num_clients
    cache = cache if cache is not None else PlanCache()
    link_table = LinkTable(topo)
    # shared media (contended cells / backhauls): one SharedLink per
    # distinct medium name; media_of maps link name -> SharedLink so
    # plan_media can resolve each plan's wire legs.  Empty on topologies
    # without shared media — every contention branch below is then dead.
    media = build_media(topo)
    media_of = {
        link.name: media[link.medium]
        for link in topo.links.values()
        if link.medium
    }
    q = _ShimQueue()
    heap = q.heap
    home = topo.home
    period = 1.0 / camera_fps
    last_frame = num_frames - 1
    min_samples = max(1, drift_min_samples)
    abs_floor = 1e-4  # DriftDetector's default (the fleet never overrides it)
    W = drift_window
    B = max(1, min(_BLOCK, num_frames))

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
    edge_index = {e: i for i, e in enumerate(edges)}
    server_list = [servers[e] for e in edges]
    tel = telemetry
    if tel is not None:
        # wire instrumentation before admission planning (counts the
        # initial cache misses); batching servers report occupancy and
        # batch sizes through the shared events.py code — only the
        # inlined FIFO path below needs explicit hook calls
        tel.attach(cache=cache, servers=server_list + list(media.values()))

    # --- struct-of-arrays server state (FIFO fast path) -------------------
    # the heaps ALIAS the SlotServer's own lists (mid-run load() reads by
    # the migration controller stay live); scalar stats accumulate here
    # and write back after the loop
    n_edges = len(edges)
    srv_fifo = [type(sv) is SlotServer for sv in server_list]
    srv_slots = [sv._slots for sv in server_list]
    srv_fins = [sv._finishes for sv in server_list]
    srv_scale = [sv.service_scale for sv in server_list]
    adm_l = [0] * n_edges
    busy_l = [0.0] * n_edges
    twl = [0.0] * n_edges
    peak_l = [0] * n_edges

    # --- struct-of-arrays client state -----------------------------------
    edge_i = [0] * N  # index into `edges`
    tier_of: List[object] = [None] * N  # own hardware class (hetero)
    # own workload (mixed fleets: workloads[c % nw]; else comp_used) and
    # its batch key — fused launches only join under the same workload
    nw = len(workloads) if workloads else 0
    comp_of: List[StagedComputation] = [comp_used] * N
    key_of: List[str] = [comp_used.name] * N
    rngs: List[object] = [None] * N
    rates: Optional[List[object]] = [None] * N if codec is not None else None
    t_free = [0.0] * N
    next_i = [0] * N
    replans_n = [0] * N
    migr_n = [0] * N
    twait = [0.0] * N
    drifted = [False] * N
    rate_dirty = [False] * N
    probe_n = [0] * N
    wait_acc = [0.0] * N
    vidx = [0] * N
    # shared-medium state: (SharedLink, wire seconds) tuples per plan
    # direction, the per-frame medium delay, and whether the in-flight
    # frame's uplink already cleared its media (one admission per frame)
    up_media: List[tuple] = [()] * N
    down_media: List[tuple] = [()] * N
    med_wait = [0.0] * N
    up_paid = [False] * N
    # pending in-flight frame (the object engine's per-frame tuple, as
    # recycled slots)
    pend_i = [0] * N
    pend_start = [0.0] * N
    pend_sampled = [0.0] * N
    pend_pos = [0] * N  # row of the client's block the pending frame drew
    # plan-derived state
    plan_obj: List[object] = [None] * N
    plan_fp_l: List[object] = [None] * N
    # [(is_fifo, server_index, service, tier_name, server), ...]
    visits: List[list] = [[]] * N
    nvis = [0] * N
    has_legs = [False] * N
    service_total = [0.0] * N
    legs_meta: List[list] = [[]] * N  # [(link, leg_lat, leg_jit, weight), ...]
    leg_links: List[tuple] = [()] * N
    # detector link groups: [(link, predicted, leg_columns, tolerance), ...]
    link_groups: List[list] = [[]] * N
    # latency sampling blocks
    blk_t: List[list] = [[]] * N  # per-frame plan totals (python floats)
    blk_D: List[object] = [None] * N  # per-frame per-leg draws, (B, n_legs)
    blk_fl: List[list] = [[]] * N  # per-frame drift flag: 0 no, 1 yes, 2 exact
    blk_pos = [0] * N
    blk_nj = [0] * N
    blk_ver = [-1] * N
    zbuf: List[object] = [None] * N  # raw standard normals (np arrays)
    zpos = [0] * N
    # drift-detector rings: per client, link -> [buffer, next_overwrite];
    # maintained lazily — applied_upto[c] counts block rows already fed in
    rings: List[dict] = [None] * N
    applied_upto = [0] * N
    # processed-frame record columns (arrival/gap derive from the index)
    rec_i = [array("q") for _ in range(N)]
    rec_start = [array("d") for _ in range(N)]
    rec_fin = [array("d") for _ in range(N)]

    seq = 0  # mirrors q.seq; synced around object-path calls

    def _set_plan(c: int, plan, fp) -> None:
        plan_obj[c] = plan
        plan_fp_l[c] = fp
        vis = []
        for t, s in plan.compute_by_tier:
            if t != home:
                sv = servers[t]
                vis.append(
                    (type(sv) is SlotServer, edge_index[t], s, t, sv)
                )
        visits[c] = vis
        nvis[c] = len(vis)
        service_total[c] = sum(v[2] for v in vis)
        legs = [
            (leg.link, leg.latency, leg.jitter, leg.weight)
            for leg in plan.legs
        ]
        legs_meta[c] = legs
        has_legs[c] = bool(legs)
        leg_links[c] = tuple(ln for ln, _, _, _ in legs)
        up_media[c], down_media[c] = plan_media(plan, media_of)
        pred_map: Dict[str, float] = {}
        cols_map: Dict[str, list] = {}
        for j, (ln, lat, _, _) in enumerate(legs):
            pred_map.setdefault(ln, lat)
            cols_map.setdefault(ln, []).append(j)
        link_groups[c] = [
            (ln, pred_map[ln], cols, max(drift_threshold * pred_map[ln], abs_floor))
            for ln, cols in cols_map.items()
        ]
        blk_ver[c] = -1  # force a block rebuild at next sample

    def _apply_rings(c: int, upto: int) -> None:
        """Feed block rows [applied_upto, upto) into the detector rings
        (chronological per link, legs in plan order within a frame) —
        exactly the appends ``DriftDetector.observe`` would have done."""
        a = applied_upto[c]
        if a >= upto or W <= 0:
            applied_upto[c] = upto
            return
        D = blk_D[c]
        rc = rings[c]
        for ln, _pred, cols, _tol in link_groups[c]:
            if len(cols) == 1:
                vals = D[a:upto, cols[0]].tolist()
            else:
                vals = D[a:upto, cols].ravel().tolist()
            ring = rc.get(ln)
            if ring is None:
                rc[ln] = ring = [[], 0]
            buf = ring[0]
            if len(vals) >= W:
                buf[:] = vals[-W:]
                ring[1] = 0
            else:
                p = ring[1]
                for v in vals:
                    if len(buf) < W:
                        buf.append(v)
                    else:
                        buf[p] = v
                        p += 1
                        if p == W:
                            p = 0
                ring[1] = p
        applied_upto[c] = upto

    def _exact_observe(c: int, pos: int) -> bool:
        """Re-evaluate one frame's drift decision with the object
        engine's exact sequential-sum arithmetic (the fallback for
        block decisions inside the certainty margin)."""
        _apply_rings(c, pos)
        row = blk_D[c][pos]
        rc = rings[c]
        fired = False
        for ln, pred, cols, tol in link_groups[c]:
            ring = rc.get(ln)
            if ring is None:
                rc[ln] = ring = [[], 0]
            buf = ring[0]
            for j in cols:
                draw = float(row[j])
                if len(buf) < W:
                    buf.append(draw)
                    n = len(buf)
                    if n < min_samples:
                        continue
                    s = sum(buf)
                else:
                    p = ring[1]
                    buf[p] = draw
                    p += 1
                    if p == W:
                        p = 0
                    ring[1] = p
                    n = W
                    s = sum(buf[p:] + buf[:p])
                mean = s / n
                dev = mean - pred
                if dev < 0.0:
                    dev = -dev
                if dev > tol:
                    fired = True
        applied_upto[c] = pos + 1
        return fired

    def _build_block(c: int) -> None:
        """Transform the next B frames' latency draws in one shot and
        precompute their drift-detector decisions."""
        _apply_rings(c, blk_pos[c])  # drain the old block into the rings
        legs = legs_meta[c]
        resolved = []
        nj = 0
        for ln, leg_lat, leg_jit, w in legs:
            link = link_table.lookup(ln)
            if link is None:
                lat, jit = leg_lat, leg_jit
            else:
                lat, jit = link.latency, link.jitter
            resolved.append((lat, jit, leg_lat, w))
            if jit > 0.0:
                nj += 1
        total = plan_obj[c].total_time
        Z = None
        if nj:
            need = B * nj
            zb = zbuf[c]
            zp = zpos[c]
            avail = len(zb) - zp
            if avail < need:
                zb = np.concatenate(
                    (zb[zp:], rngs[c].standard_normal(need - avail))
                )
                zbuf[c] = zb
                zpos[c] = zp = 0
            Z = zb[zp : zp + need].reshape(B, nj)
        T = np.full(B, total)
        cols = []
        zc = 0
        for lat, jit, leg_lat, w in resolved:
            # exact float-op order of LinkTable.sample_plan_latency:
            # subtract the charged latency, add the draw, leg by leg.
            # A probability-weighted leg (conditional-branch pricing,
            # weight < 1.0) swaps w-scaled terms into the SAME slots;
            # the detector/telemetry columns stay the unscaled draws,
            # exactly like the object engine's `observed`.
            if jit > 0.0:
                col = np.maximum(0.0, lat + jit * Z[:, zc])
                zc += 1
            else:
                col = np.full(B, lat)
            if w == 1.0:
                T = T - leg_lat
                T = T + col
            else:
                T = T - w * leg_lat
                T = T + w * col
            cols.append(col)
        blk_t[c] = T.tolist()
        if cols:
            D = np.column_stack(cols)
            blk_D[c] = D
            if W > 0:
                cfire_any = None
                unc_any = None
                rc = rings[c]
                for ln, pred, lcols, tol in link_groups[c]:
                    k = len(lcols)
                    newv = D[:, lcols[0]] if k == 1 else D[:, lcols].ravel()
                    ring = rc.get(ln)
                    if ring is None or not ring[0]:
                        seqa = newv
                        r0 = 0
                    else:
                        buf, p = ring
                        snap = buf if len(buf) < W else buf[p:] + buf[:p]
                        r0 = len(snap)
                        seqa = np.concatenate((np.asarray(snap), newv))
                    cs = np.empty(len(seqa) + 1)
                    cs[0] = 0.0
                    np.cumsum(seqa, out=cs[1:])
                    idx_end = np.arange(r0 + 1, r0 + 1 + B * k)
                    n = np.minimum(W, idx_end)
                    means = (cs[idx_end] - cs[idx_end - n]) / n
                    valid = n >= min_samples
                    diff = np.abs(means - pred) - tol
                    # certainty margin: ~100x the worst-case float error
                    # of the prefix-sum reassociation; inside it, defer
                    # to _exact_observe's bit-exact arithmetic
                    amax = float(np.max(np.abs(seqa)))
                    margin = 1e-9 * (1.0 + tol + amax)
                    cfire = valid & (diff > margin)
                    unc = valid & (np.abs(diff) <= margin)
                    if k > 1:
                        cfire = cfire.reshape(B, k).any(axis=1)
                        unc = unc.reshape(B, k).any(axis=1)
                    cfire_any = (
                        cfire if cfire_any is None else (cfire_any | cfire)
                    )
                    unc_any = unc if unc_any is None else (unc_any | unc)
                blk_fl[c] = (cfire_any + 2 * (unc_any & ~cfire_any)).tolist()
            else:
                blk_fl[c] = [0] * B
        else:
            blk_D[c] = None
            blk_fl[c] = [0] * B
        blk_nj[c] = nj
        blk_ver[c] = link_table.version
        blk_pos[c] = 0
        applied_upto[c] = 0

    def start_frame(c: int, now: float, heappush=heapq.heappush) -> None:
        nonlocal seq
        i = next_i[c]
        if i >= num_frames:
            return
        if drifted[c] or rate_dirty[c]:
            if drifted[c]:
                replans_n[c] += 1
                if tel is not None:
                    tel.count("plan.replans.drift")
            elif tel is not None:
                tel.count("plan.replans.rate")
            _replan(c, edge_i[c])
        arrival = i * period
        tf = t_free[c]
        start = arrival if arrival >= tf else tf
        newest = int(start / period)
        if newest > last_frame:
            newest = last_frame
        if newest > i:
            i = newest
            arrival = i * period
            start = arrival if arrival >= tf else tf
        pos = blk_pos[c]
        if pos >= B or blk_ver[c] != link_table.version:
            _build_block(c)
            pos = 0
        sampled = blk_t[c][pos]
        blk_pos[c] = pos + 1
        zpos[c] += blk_nj[c]
        pend_i[c] = i
        pend_start[c] = start
        pend_sampled[c] = sampled
        pend_pos[c] = pos
        wait_acc[c] = 0.0
        med_wait[c] = 0.0
        up_paid[c] = False
        if nvis[c]:
            vidx[c] = 0
            tm = start + (sampled - service_total[c])
            heappush(
                heap,
                (tm if tm > now else now, seq, (c << _KIND_BITS) | _K_VISIT),
            )
        else:
            tm = start + sampled
            heappush(
                heap,
                (tm if tm > now else now, seq, (c << _KIND_BITS) | _K_FINISH),
            )
        seq += 1

    def _replan(c: int, ei: int) -> None:
        """Same sequence as the object engine's ``replan`` +
        ``DriftDetector.reset``: shared by drift, rate-switch and
        migration paths."""
        sub = edge_subtopology(
            topo, edges[ei], link_table, client_tier=tier_of[c]
        )
        plan, _ = cache.get_or_plan(
            comp_of[c],
            sub,
            policy,
            planner,
            codec=rates[c].model if rates is not None else None,
        )
        _set_plan(c, plan, topology_fingerprint(sub))
        drifted[c] = False
        rate_dirty[c] = False
        probe_n[c] = 0
        rings[c].clear()
        # pending rows belonged to the old plan; the detector reset
        # discards their evidence exactly like DriftDetector.reset
        applied_upto[c] = blk_pos[c]

    def _make_done(c: int, j: int, w_acc: float, arrived: float, service: float):
        """Per-member completion for batching servers — the vectorized
        twin of the object engine's ``placed`` closure (FIFO members
        never allocate one; their math is inlined at the visit event)."""

        def done(s_start: float, s_end: float) -> None:
            wait = w_acc + (s_start - arrived) + (s_end - (s_start + service))
            if tel is not None:
                tel.visit_placed(c, True, arrived, s_start, s_end, service)
            now = q.now
            if j + 1 < nvis[c]:
                vidx[c] = j + 1
                wait_acc[c] = wait
                kind = _K_VISIT
            else:
                wait_acc[c] = wait
                kind = _K_FINISH
            heapq.heappush(
                heap,
                (
                    s_end if s_end > now else now,
                    q.seq,
                    (c << _KIND_BITS) | kind,
                ),
            )
            q.seq += 1

        return done

    # --- admission (same call sequence as the object engine) --------------
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
    # id-indexed admission memo: every client of one (edge, class,
    # workload) triple shares one plan/fingerprint; the object engine
    # re-derives them per client and counts a cache hit each time, so
    # the memo bumps the same counter to keep CacheStats identical
    admit_memo: Dict[Tuple, Tuple] = {}
    n_classes = len(client_classes) if client_classes else 0
    for c in range(N):
        tier_c = client_classes[c % n_classes] if n_classes else None
        tier_of[c] = tier_c
        comp_c = workloads[c % nw] if nw else comp_used
        comp_of[c] = comp_c
        key_of[c] = comp_c.name
        ctx.client_tier = tier_c
        ctx.comp = comp_c
        e = disp.assign(c, ctx)
        ctx.assignments[e] = ctx.assignments.get(e, 0) + 1
        rate = (
            RateController(codec, client_id=c) if codec is not None else None
        )
        if rates is not None:
            rates[c] = rate
        memo_key = (e, tier_c, c % nw if nw else 0)
        hit = admit_memo.get(memo_key)
        if hit is None:
            sub = edge_subtopology(topo, e, link_table, client_tier=tier_c)
            plan, _ = cache.get_or_plan(
                comp_c,
                sub,
                policy,
                planner,
                codec=rate.model if rate is not None else None,
            )
            fp = topology_fingerprint(sub)
            admit_memo[memo_key] = (plan, fp)
        else:
            plan, fp = hit
            cache.stats.hits += 1
            if cache.on_event is not None:
                cache.on_event("hit")
        edge_i[c] = edge_index[e]
        rngs[c] = np.random.default_rng(seed + c)
        zbuf[c] = np.empty(0)
        rings[c] = {}
        _set_plan(c, plan, fp)
    if tel is not None:
        home_cls = topo.tier(home).name
        tel.register_clients(
            {
                c: (tier_of[c].name if tier_of[c] is not None else home_cls)
                for c in range(N)
            }
        )
        tel.register_workloads({c: comp_of[c].name for c in range(N)})

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

    # --- drift injections (sequence numbers follow the admission cohort's
    # reserved block, exactly as the object engine assigns them) ----------
    seq = N
    for di, d in enumerate(drifts):
        if isinstance(d, ServiceDrift) and d.edge not in servers:
            raise ValueError(f"ServiceDrift targets unknown edge {d.edge!r}")
        heapq.heappush(
            heap,
            (
                d.time if d.time > 0.0 else 0.0,
                seq,
                (di << _KIND_BITS) | _K_DRIFT,
            ),
        )
        seq += 1

    # probe-path fingerprint memo (local-plan clients ping their edge
    # link every `probe_every` frames; the fingerprint only changes when
    # the link table mutates, so key on its version)
    probe_fp: Dict[Tuple, object] = {}

    # --- the hot loop -----------------------------------------------------
    # drain the t=0 admission cohort without touching the heap (each
    # START was one scheduled+popped event on the object engine — the
    # reserved seq block and the processed count keep parity exact)
    processed = N
    for c in range(N):
        start_frame(c, 0.0)

    heappush = heapq.heappush
    heappop = heapq.heappop
    heapreplace = heapq.heapreplace
    # the loop allocates only tuples that die in order (heap events) and
    # bounded per-client buffers: cyclic collection finds nothing here,
    # but gen-0 passes would scan the whole SoA state every ~700 allocs
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        while heap:
            now, _sq, payload = heappop(heap)
            processed += 1
            kind = payload & _KIND_MASK
            c = payload >> _KIND_BITS
            if kind == _K_VISIT:
                if vidx[c] == 0 and up_media[c] and not up_paid[c]:
                    # shared-uplink admission — the object engine's
                    # visit() head, one reschedule when the cell queues
                    up_paid[c] = True
                    uw = 0.0
                    for med, svc in up_media[c]:
                        uw += med.admit(now, svc)
                    if uw > 0.0:
                        med_wait[c] += uw
                        wait_acc[c] += uw
                        heappush(
                            heap,
                            (now + uw, seq, (c << _KIND_BITS) | _K_VISIT),
                        )
                        seq += 1
                        continue
                vis = visits[c][vidx[c]]
                if vis[0]:  # FIFO SlotServer: admit inline over SoA state
                    si = vis[1]
                    service = vis[2]
                    scaled = service * srv_scale[si]
                    slots = srv_slots[si]
                    free = slots[0]
                    s_start = now if now >= free else free
                    s_end = s_start + scaled
                    heapreplace(slots, s_end)
                    fins = srv_fins[si]
                    heappush(fins, s_end)
                    adm_l[si] += 1
                    busy_l[si] += scaled
                    twl[si] += s_start - now
                    while fins and fins[0] <= now:
                        heappop(fins)
                    ld = len(fins)
                    if ld > peak_l[si]:
                        peak_l[si] = ld
                    if tel is not None:
                        # same order as SlotServer.admit + placed:
                        # occupancy sample, wait sample, visit record
                        tel.occupancy_sample(edges[si], now, ld)
                        tel.wait_sample(edges[si], now, s_start - now)
                        tel.visit_placed(c, False, now, s_start, s_end, service)
                    wait = (
                        wait_acc[c]
                        + (s_start - now)
                        + (s_end - (s_start + service))
                    )
                    j = vidx[c] + 1
                    if j < nvis[c]:
                        vidx[c] = j
                        nk = _K_VISIT
                    else:
                        nk = _K_FINISH
                    wait_acc[c] = wait
                    heappush(
                        heap,
                        (
                            s_end if s_end > now else now,
                            seq,
                            (c << _KIND_BITS) | nk,
                        ),
                    )
                    seq += 1
                else:
                    q.now = now
                    q.seq = seq
                    vis[4].submit(
                        now,
                        vis[2],
                        _make_done(c, vidx[c], wait_acc[c], now, vis[2]),
                        key=key_of[c],
                    )
                    seq = q.seq
            elif kind == _K_FINISH:
                i = pend_i[c]
                start = pend_start[c]
                wait = wait_acc[c]
                fin = (start + pend_sampled[c]) + wait
                if down_media[c] or (up_media[c] and not nvis[c]):
                    # downlink (and visit-less uplink) shared-medium
                    # admission — the object engine's finish() head
                    mw = 0.0
                    if not nvis[c]:
                        for med, svc in up_media[c]:
                            mw += med.admit(fin, svc)
                    for med, svc in down_media[c]:
                        mw += med.admit(fin, svc)
                    if mw > 0.0:
                        med_wait[c] += mw
                        wait += mw
                        fin += mw
                rec_i[c].append(i)
                rec_start[c].append(start)
                rec_fin[c].append(fin)
                next_i[c] = i + 1
                t_free[c] = fin
                twait[c] += wait
                if tel is not None:
                    tel.frame_done(
                        c,
                        i,
                        edges[edge_i[c]],
                        start,
                        fin,
                        plan_obj[c],
                        (
                            tuple(blk_D[c][pend_pos[c]].tolist())
                            if has_legs[c]
                            else ()
                        ),
                        link_wait=med_wait[c],
                    )
                if has_legs[c]:
                    fl = blk_fl[c][pend_pos[c]]
                    if fl:
                        if fl == 1 or _exact_observe(c, pend_pos[c]):
                            drifted[c] = True
                else:
                    pn = probe_n[c] + 1
                    if pn >= probe_every:
                        probe_n[c] = 0
                        pkey = (edge_i[c], tier_of[c], link_table.version)
                        fp = probe_fp.get(pkey)
                        if fp is None:
                            fp = topology_fingerprint(
                                edge_subtopology(
                                    topo,
                                    edges[edge_i[c]],
                                    link_table,
                                    client_tier=tier_of[c],
                                )
                            )
                            probe_fp[pkey] = fp
                        if fp != plan_fp_l[c]:
                            drifted[c] = True
                    else:
                        probe_n[c] = pn
                if rates is not None:
                    obs = (
                        tuple(zip(leg_links[c], blk_D[c][pend_pos[c]].tolist()))
                        if has_legs[c]
                        else ()
                    )
                    if (
                        rates[c].observe(
                            i, obs, plan_obj[c], cell_wait=med_wait[c]
                        )
                        is not None
                    ):
                        rate_dirty[c] = True
                if controller is not None:
                    if nvis[c]:
                        controller.observe_wait(edges[edge_i[c]], wait, now)
                    if next_i[c] < num_frames:
                        controller.frame_done(c)
                        move = controller.consider(
                            c,
                            edges[edge_i[c]],
                            now,
                            state_src=(
                                visits[c][0][3] if nvis[c] else home
                            ),
                            force=drifted[c],
                            codec=(
                                rates[c].model if rates is not None else None
                            ),
                            client_tier=tier_of[c],
                            comp=comp_of[c],
                        )
                        if move is not None:
                            target, mig_latency = move
                            if tel is not None:
                                tel.migration(
                                    c, fin, mig_latency, edges[edge_i[c]], target
                                )
                            edge_i[c] = edge_index[target]
                            migr_n[c] += 1
                            t_free[c] = fin + mig_latency
                            _replan(c, edge_i[c])
                start_frame(c, now)
            elif kind == _K_CALLBACK:
                q.now = now
                q.seq = seq
                cb = q.cbs[c]
                q.cbs[c] = None  # recycle: closed-over members can be GC'd
                cb()
                seq = q.seq
            else:  # _K_DRIFT
                d = drifts[c]
                if isinstance(d, ServiceDrift):
                    sv = servers[d.edge]
                    sv.service_scale = d.factor
                    srv_scale[edge_index[d.edge]] = d.factor
                else:
                    link_table.set(
                        d.link,
                        latency=d.latency,
                        jitter=d.jitter,
                        bandwidth=d.bandwidth,
                    )


    finally:
        if gc_was_enabled:
            gc.enable()
    # --- write the SoA stats back onto the FIFO SlotServer objects --------
    for si, sv in enumerate(server_list):
        if srv_fifo[si]:
            sv.admitted = adm_l[si]
            sv.busy_time = busy_l[si]
            sv.total_wait = twl[si]
            sv.peak_load = peak_l[si]

    # --- results ----------------------------------------------------------
    client_results = []
    for c in range(N):
        client_results.append(
            ClientResult(
                client=c,
                edge=edges[edge_i[c]],
                stats=ArrayLoopStats(
                    rec_i[c],
                    rec_start[c],
                    rec_fin[c],
                    num_frames,
                    period,
                ),
                plan=plan_obj[c],
                replans=replans_n[c],
                total_wait=twait[c],
                migrations=migr_n[c],
                rate_changes=(
                    rates[c].switches if rates is not None else 0
                ),
                codec=(rates[c].model if rates is not None else None),
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
        events=processed,
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
            result, rates=list(rates) if rates is not None else None
        )
        tel.detach(cache=cache, servers=server_list + list(media.values()))
    return result
