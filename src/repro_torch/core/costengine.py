"""The unified cost engine: every cost in the system is computed here.

Historically the transfer/wrapper/compute arithmetic lived in three
places — ``offload.evaluate_plan``, ``net.transport.Transport`` and a
jitter-reconstruction hack in ``sim.runtime`` that divided latency back
out of an aggregate ``network_time``.  ``CostEngine`` owns all of it:

* :meth:`CostEngine.evaluate` prices a placement vector over any
  :class:`~repro_torch.core.topology.Topology` with exact residency tracking,
  and records every latency leg it charges in ``PlanReport.legs`` so
  jitter resampling (``PlanReport.jittered_total``) is *exact* rather
  than reverse-engineered.
* The scalar helpers (:meth:`transfer_scalar`, :meth:`envelope_scalar`,
  :meth:`marshal_scalar`, :meth:`compute_time`) are the same arithmetic
  exposed piecewise for planners (the chain-DP planner prices DP
  transitions with them, guaranteeing agreement with ``evaluate``).
* The module-level ``wire_time`` / ``serialization_time`` /
  ``envelope_time`` primitives serve ``net.transport`` so the executed
  simulator charges the identical formulas.

Cost semantics (unchanged from the calibrated two-tier model):

  compute  : Amdahl split — parallel_fraction at tier.accel_flops, the
             rest at tier.scalar_flops — plus tier.dispatch_overhead.
  wrapper  : fixed per-call cost plus bytes / serialization bandwidth on
             both ends of every remote transfer; local wrapped calls
             cross the (faster) JNI marshal path instead.
  network  : every remote stage invocation pays a request/response
             envelope of 2 x latency per link leg on the home->tier
             path; payloads pay wire time per leg.  A payload whose
             source lies on the request path piggybacks (no extra
             latency); pulling data against the request direction is an
             explicit fetch costing one latency per leg.  Result items
             ride the final response home (no extra latency).  Item
             residency is tracked so a frame uploaded once is not
             re-sent.
  codec    : with a ``repro_torch.codec.model.CodecModel`` armed, every payload the
             codec *applies to* (frame-sized items at a compressing
             operating point) ships its compressed byte estimate —
             serialization, wire time and uplink/downlink accounting
             all see codec-aware bytes — plus encode compute at the
             payload's source tier and decode compute at its
             destination (charged into ``compute_by_tier``, so a
             contended edge's decode work occupies its service slots in
             the fleet simulator; codec compute itself is not
             contention-inflated — it is microseconds against
             millisecond stages).  The identity codec never applies, so
             ``codec=None`` and the identity codec are bit-for-bit the
             same arithmetic.
  branches : a conditional stage (``Stage.exec_prob`` < 1) charges the
             *expected* value of every term it owns — compute, RPC
             envelope, input/output transfers, wire bytes — each
             multiplied by its exec_prob (and result ship-home by the
             producer's).  Latency legs record the probability as
             ``LatencyLeg.weight`` while keeping the link's unscaled
             latency/jitter, so jitter resampling and drift detection
             observe the real link and only total-time arithmetic is
             expectation-weighted.  ``exec_prob = 1`` everywhere is
             bit-for-bit the historical arithmetic (scaling by 1.0 is
             IEEE-exact).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.stages import CLIENT, DataItem, StagedComputation, Stage
from repro_torch.core.topology import Link, Topology, WrapperModel, sample_latency


# ---------------------------------------------------------------------------
# leg-level primitives (shared with net.transport)
# ---------------------------------------------------------------------------


def wire_time(nbytes: int, links: Sequence[Link]) -> float:
    """Pure bandwidth time for a payload crossing the given legs."""
    t = 0.0
    for link in links:
        t += nbytes / link.bandwidth
    return t


def serialization_time(nbytes: int, wrapper: WrapperModel) -> float:
    """Serialize at the source + deserialize at the destination."""
    return 2 * (nbytes / wrapper.serialization_bandwidth)


def envelope_time(
    links: Sequence[Link], wrapper: Optional[WrapperModel] = None, rng=None
) -> float:
    """Request + response wire latency (optionally jitter-sampled) plus
    proxy/skeleton call overhead for one remote invocation."""
    t = 0.0
    for link in links:
        for _ in range(2):
            t += link.transfer_time(0, rng)
    if wrapper is not None:
        t += 2 * wrapper.call_overhead
    return t


# ---------------------------------------------------------------------------
# batch service model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BatchServiceModel:
    """Service time of one *fused* accelerator launch over a batch.

    A tier that batches (``Tier.batching``) serves the concurrent
    requests it gathered as a single launch instead of time-slicing
    them.  Each item's solo service time already carries its own launch
    cost (``Tier.dispatch_overhead`` is inside ``compute_time``); fusing
    pays that once, plus:

    * ``launch_overhead`` — fixed extra bookkeeping of a multi-item
      launch (batch gather/scatter, ragged padding), charged only when
      the batch actually has more than one item, so a batch of one *is*
      the unbatched launch, bit for bit.
    * ``marginal_fraction`` — the fraction of its solo time each
      additional item adds.  Physically: the lone item leaves the
      accelerator's vector lanes underfilled, so co-scheduled items ride
      mostly-idle hardware; 1.0 degenerates to serial (no amortization),
      values < 1 make batch service time sublinear in batch size.

    Invariants (property-tested in tests/test_properties.py):
      ``batch_time(ts) >= max(ts)`` — a batch finishes no earlier than
      its largest member run alone;
      ``batch_time(ts) <= launch_overhead + sum(ts)`` — fusing never
      costs more than serializing the same launches (marginal <= 1);
      monotone in batch size.
    """

    launch_overhead: float = 0.0
    marginal_fraction: float = 0.35

    def __post_init__(self) -> None:
        if self.launch_overhead < 0.0:
            raise ValueError("launch_overhead must be >= 0")
        if not 0.0 <= self.marginal_fraction <= 1.0:
            raise ValueError("marginal_fraction must be in [0, 1]")

    def batch_time(self, item_times: Sequence[float]) -> float:
        """Fused service time for items with the given solo times."""
        if not item_times:
            return 0.0
        m = max(item_times)
        if len(item_times) == 1:
            return m
        rest = sum(item_times) - m
        return self.launch_overhead + m + self.marginal_fraction * rest

    def per_item_time(self, solo_time: float, batch_size: int) -> float:
        """Amortized share of a homogeneous batch (capacity planning)."""
        if batch_size <= 0:
            return 0.0
        return self.batch_time([solo_time] * batch_size) / batch_size

    @classmethod
    def from_tier(cls, tier) -> "BatchServiceModel":
        """The model a ``Tier`` declares via its flat batching fields."""
        return cls(
            launch_overhead=tier.batch_overhead,
            marginal_fraction=tier.batch_marginal,
        )

    @classmethod
    def from_roofline(
        cls,
        *,
        peak_flops: float,
        effective_flops: float,
        mem_bandwidth: float,
        flops_per_item: float,
        bytes_per_item: int,
        launch_overhead: float,
    ) -> "BatchServiceModel":
        """Calibrate the marginal fraction from roofline terms.

        ``effective_flops`` is the rate ONE client's swarm actually
        achieves (what a tier's ``accel_flops`` anchors: small
        populations leave the vector lanes underfilled — the v5e
        roofline table's single-stream utilization is ~8% of peak);
        ``peak_flops`` is the device ceiling.  A lone item therefore
        pays ``launch + flops/effective + bytes/bw`` end to end, while
        each *co-batched* item streams at the roofline proper —
        ``max(flops/peak, bytes/bw)`` — filling lanes the lone item
        leaves idle.  The marginal fraction is that ratio: roughly the
        lone item's utilization, which is exactly the amortization a
        fused launch buys back.
        """
        solo = (
            launch_overhead
            + flops_per_item / effective_flops
            + bytes_per_item / mem_bandwidth
        )
        marginal_t = max(flops_per_item / peak_flops, bytes_per_item / mem_bandwidth)
        marginal = marginal_t / solo if solo > 0 else 1.0
        return cls(
            launch_overhead=launch_overhead,
            marginal_fraction=min(1.0, marginal),
        )


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LatencyLeg:
    """One charged latency leg — the unit of exact jitter resampling.

    ``latency`` / ``jitter`` are the link's UNSCALED parameters — live
    lookups (drift detection, rate control) compare draws against them
    directly.  ``weight`` is the expected-cost multiplier of the leg
    (the ``exec_prob`` of the conditional stage that charged it; 1.0 for
    unconditional legs): total-time arithmetic applies ``weight`` to
    both the charged latency and any resampled draw, never to the
    stored parameters."""

    link: str
    latency: float
    jitter: float
    weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class PlanReport:
    placements: Tuple[str, ...]
    total_time: float
    compute_time: float
    wrapper_time: float
    network_time: float
    uplink_bytes: int
    downlink_bytes: int
    legs: Tuple[LatencyLeg, ...] = ()
    # per-tier compute breakdown in first-visit order — the fleet
    # simulator (the reference's repro.cluster) charges the remote
    # entries against a contended server's service slots instead of a
    # dedicated machine
    compute_by_tier: Tuple[Tuple[str, float], ...] = ()
    # span-attribution breakdown: (category, seconds) pairs partitioning
    # total_time by where the time is spent (compute_home/compute_remote,
    # encode/decode at each end, lat_up/lat_down, wire_up/wire_down,
    # wrapper) plus the pre-codec byte count shipped uplink
    # (raw_bytes_up).  Consumed by the reference's
    # repro.cluster.telemetry; every entry is accumulated in parallel
    # with the existing totals so arming it costs nothing and changes
    # nothing.
    breakdown: Tuple[Tuple[str, float], ...] = ()
    # up/down direction of every recorded latency leg, index-aligned
    # with ``legs`` (True = downlink-direction hop relative to home)
    leg_down: Tuple[bool, ...] = ()
    # per-hop wire occupancy: (link name, is_downlink, wire seconds) for
    # every wire crossing this plan charges — what the fleet engines
    # offer to a SharedLink when the link names a shared medium (the
    # same ``wire_n / bandwidth`` terms as the wire_up/wire_down
    # breakdown, kept per link so contention can be charged per medium)
    wire_by_link: Tuple[Tuple[str, bool, float], ...] = ()

    @property
    def fps(self) -> float:
        return 1.0 / self.total_time if self.total_time > 0 else float("inf")

    def jittered_total(self, rng) -> float:
        """Resample every recorded latency leg; exact by construction."""
        if not self.legs:
            return self.total_time
        base = self.total_time
        for leg in self.legs:
            if leg.weight == 1.0:
                base -= leg.latency
                base += sample_latency(leg.latency, leg.jitter, rng)
            else:
                # probabilistic leg: the draw stays unscaled (it is a
                # property of the link), the expectation weight applies
                # in the total only
                base -= leg.weight * leg.latency
                base += leg.weight * sample_latency(
                    leg.latency, leg.jitter, rng
                )
        return base


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class CostEngine:
    """Prices placements of a ``StagedComputation`` over a ``Topology``.

    ``occupancy`` maps tier names to the number of *other* requests
    currently in flight at that tier.  A tier with ``capacity`` slots
    shared by q+1 concurrent requests serves each at rate
    ``capacity / (q+1)`` once oversubscribed (processor sharing — the
    virtualized-accelerator model), so the engine inflates that tier's
    service time by ``max(1, (q+1) / capacity)``.  A tier that declares
    ``batching=True`` replaces processor sharing entirely: the q other
    requests ride the *same fused launch*, so the predicted service time
    is ``BatchServiceModel.batch_time`` of q+1 identical items — fixed
    launch overhead plus sublinear per-item cost — instead of an
    inflation factor.  With no occupancy recorded (the default) every
    tier prices as a dedicated machine and the arithmetic is bit-for-bit
    the uncontended model, batching or not.
    """

    def __init__(
        self,
        topology: Topology,
        occupancy: Optional[Dict[str, int]] = None,
        codec=None,
        link_backlog: Optional[Dict[str, float]] = None,
    ):
        self.topology = topology
        self.occupancy: Dict[str, int] = dict(occupancy) if occupancy else {}
        # a repro_torch.codec.model.CodecModel (or None): payload
        # compression priced into every transfer leg — see the module
        # docstring
        self.codec = codec
        # live shared-medium backlog (medium name -> seconds of queue
        # delay a transmission due now would see): wire legs crossing a
        # link with that medium charge it on top of their wire time.
        # None / empty (the default) is the exact uncontended model —
        # this is a probe-side knob (fleet dispatch), never cached.
        self.link_backlog: Dict[str, float] = (
            dict(link_backlog) if link_backlog else {}
        )

    # -- small shared pieces ------------------------------------------------

    def placement_tiers(self) -> Tuple[str, ...]:
        """Tier names a stage may be placed on (home only when native)."""
        topo = self.topology
        return topo.tier_names() if topo.wrapped else (topo.home,)

    def resolve_origin(self, item: DataItem) -> str:
        """Map an item's declared origin onto a tier name; the legacy
        ``"client"`` literal aliases the topology's home tier."""
        if item.origin in self.topology.tiers:
            return item.origin
        if item.origin == CLIENT:
            return self.topology.home
        raise ValueError(
            f"item {item.name!r} originates at unknown tier {item.origin!r}"
        )

    def contention_factor(self, tier_name: str) -> float:
        """Service-time inflation under the recorded occupancy."""
        occ = self.occupancy.get(tier_name, 0)
        if occ <= 0:
            return 1.0
        cap = max(self.topology.tier(tier_name).capacity, 1)
        return max(1.0, (occ + 1) / cap)

    def compute_time(self, stage: Stage, tier_name: str) -> float:
        tier = self.topology.tier(tier_name)
        par = stage.flops * stage.parallel_fraction
        ser = stage.flops - par
        accel = tier.accel_flops if tier.has_accelerator else tier.scalar_flops
        base = par / accel + ser / tier.scalar_flops + tier.dispatch_overhead
        occ = self.occupancy.get(tier_name, 0)
        if tier.batching and occ > 0:
            # the q concurrent requests fuse into this one's launch: the
            # whole batch finishes together, so this request's service
            # time is the fused batch time, not a time-sliced share
            return BatchServiceModel.from_tier(tier).batch_time(
                [base] * (occ + 1)
            )
        return base * self.contention_factor(tier_name)

    def _piggybacks(self, src: str, dst: str) -> bool:
        """A payload rides the pending RPC request when its source lies on
        the home->dst path; anything else is an explicit fetch."""
        return src in self.topology.path_tiers(self.topology.home, dst)

    def _codec_terms(self, nbytes: int, src: str, dst: str):
        """``(wire_nbytes, encode_t, decode_t)`` of one payload transfer
        under the armed codec — ``(nbytes, 0.0, 0.0)`` with no codec or
        when it does not apply (tiny payloads, identity codec)."""
        codec = self.codec
        if codec is None or not codec.applies(nbytes):
            return nbytes, 0.0, 0.0
        return (
            codec.wire_nbytes(nbytes),
            codec.encode_time(nbytes, self.topology.tier(src)),
            codec.decode_time(nbytes, self.topology.tier(dst)),
        )

    # -- scalar costs (used by planners; same arithmetic as evaluate) -------

    def envelope_scalar(self, tier_name: str) -> float:
        topo = self.topology
        if not topo.wrapped:
            return 0.0
        if tier_name == topo.home:
            return topo.wrapper.call_overhead
        t = 2 * topo.wrapper.call_overhead
        for link in topo.path_links(topo.home, tier_name):
            t += 2 * link.latency
        return t

    def marshal_scalar(self, nbytes: int, tier_name: str) -> float:
        """JNI marshal of an already-resident input of a wrapped home call."""
        topo = self.topology
        if topo.wrapped and tier_name == topo.home:
            return nbytes / topo.wrapper.jni_bandwidth
        return 0.0

    def _wire_scalar(
        self, wire_nbytes: int, src: str, dst: str, piggy: bool
    ) -> float:
        """Latency/serialization/wire arithmetic on ALREADY-encoded
        bytes (codec-free; shared by transfer and migration pricing)."""
        topo = self.topology
        links = topo.path_links(src, dst)
        t = 0.0
        if not piggy:
            for link in links:
                t += link.latency
        t += serialization_time(wire_nbytes, topo.wrapper)
        t += wire_time(wire_nbytes, links)
        if self.link_backlog:
            for link in links:
                if link.medium:
                    t += self.link_backlog.get(link.medium, 0.0)
        return t

    def transfer_scalar(
        self,
        nbytes: int,
        src: str,
        dst: str,
        piggyback: Optional[bool] = None,
    ) -> float:
        piggy = self._piggybacks(src, dst) if piggyback is None else piggyback
        wire_n, enc_t, dec_t = self._codec_terms(nbytes, src, dst)
        t = self._wire_scalar(wire_n, src, dst, piggy)
        if enc_t > 0.0 or dec_t > 0.0:
            # codec compute rides the transfer total so planners pricing
            # DP transitions with this scalar agree with `evaluate`
            t += enc_t + dec_t
        return t

    def migration_time(self, nbytes: int, src: str, dst: str) -> float:
        """Price a live-migration state transfer like any other leg.

        Moving a client's warm tracker state (hand-model pose + PSO
        swarm payload) from ``src`` to ``dst`` is an explicit fetch
        across the path — one propagation latency per link leg,
        serialization on both ends, wire time per leg, exactly what
        ``transfer_scalar(..., piggyback=False)`` charges — plus, on a
        wrapped stack, the RPC envelope of the transfer call itself
        (proxy/skeleton overhead and the response leg's latency).
        ``src == dst`` is a no-op (state already there).

        With a codec armed the state ships at *keyframe* pricing
        (quantizer only): the destination holds no reference frame to
        delta against, so the amortized delta ratio would overpromise.
        """
        if src == dst:
            return 0.0
        topo = self.topology
        codec = self.codec
        if codec is not None and codec.state_applies(nbytes):
            wire_n = codec.state_wire_nbytes(nbytes)
            t = self._wire_scalar(wire_n, src, dst, piggy=False)
            t += codec.state_encode_time(nbytes, topo.tier(src))
            t += codec.state_decode_time(nbytes, topo.tier(dst))
        else:
            t = self._wire_scalar(nbytes, src, dst, piggy=False)
        if topo.wrapped:
            t += 2 * topo.wrapper.call_overhead
            for link in topo.path_links(src, dst):
                t += link.latency  # the envelope's response leg
        return t

    # -- exact plan evaluation ---------------------------------------------

    def evaluate(
        self, comp: StagedComputation, placements: Sequence[str]
    ) -> PlanReport:
        """Exact cost of one placement vector with residency tracking."""
        comp.validate()
        topo = self.topology
        if len(placements) != len(comp.stages):
            raise ValueError(
                f"{len(placements)} placements for {len(comp.stages)} stages"
            )
        for p in placements:
            if p not in topo.tiers:
                raise ValueError(f"unknown tier {p!r} in placements")
        if not topo.wrapped and any(p != topo.home for p in placements):
            raise ValueError(
                "native (unwrapped) execution cannot offload — the paper's "
                "C++ baseline runs purely locally"
            )

        table = comp.item_table()
        # residency[name] -> set of tiers currently holding the item
        residency: Dict[str, Set[str]] = {
            i.name: {self.resolve_origin(i)} for i in comp.sources
        }

        compute_t = 0.0
        wrapper_t = 0.0
        network_t = 0.0
        up_bytes = 0
        down_bytes = 0
        legs: List[LatencyLeg] = []
        compute_by_tier: Dict[str, float] = {}  # insertion = first-visit order
        bd: Dict[str, float] = {}  # span-attribution breakdown
        leg_down: List[bool] = []  # direction flag per entry of `legs`
        wire_links: List[Tuple[str, bool, float]] = []  # per-hop wire time

        def _bd(key: str, v: float) -> None:
            bd[key] = bd.get(key, 0.0) + v

        def _ship(
            nbytes: int,
            src: str,
            dst: str,
            piggyback: Optional[bool],
            scale: float = 1.0,
        ) -> None:
            """Payload cost: codec encode/decode (when armed) + fetch
            legs + serialize/deserialize + wire, all on codec-aware
            bytes.  ``scale`` is the expectation weight of the transfer
            (the consuming/producing stage's ``exec_prob``); every term
            — compute, latency, serialization, wire, byte counters — is
            charged at ``scale`` times its unconditional value.
            ``scale * x`` is IEEE-exact at 1.0, so unconditional
            pipelines price bit-for-bit as before."""
            nonlocal compute_t, wrapper_t, network_t, up_bytes, down_bytes
            links = topo.path_links(src, dst)
            # hop direction relative to home (see the byte-accounting
            # comment below); link k crosses hops[k] -> hops[k+1]
            hops = topo.path_tiers(src, dst)
            downs = [
                b in topo.path_tiers(a, topo.home)
                for a, b in zip(hops, hops[1:])
            ]
            piggy = self._piggybacks(src, dst) if piggyback is None else piggyback
            wire_n, enc_t, dec_t = self._codec_terms(nbytes, src, dst)
            if enc_t > 0.0:  # encode where the payload lives...
                enc_t = scale * enc_t
                compute_t += enc_t
                compute_by_tier[src] = compute_by_tier.get(src, 0.0) + enc_t
                _bd("encode_home" if src == topo.home else "encode_remote", enc_t)
            if dec_t > 0.0:  # ...decode where it lands (slot work there)
                dec_t = scale * dec_t
                compute_t += dec_t
                compute_by_tier[dst] = compute_by_tier.get(dst, 0.0) + dec_t
                _bd("decode_home" if dst == topo.home else "decode_remote", dec_t)
            if not piggy:
                for link, dwn in zip(links, downs):
                    network_t += scale * link.latency
                    legs.append(
                        LatencyLeg(
                            link.name, link.latency, link.jitter, scale
                        )
                    )
                    leg_down.append(dwn)
                    _bd("lat_down" if dwn else "lat_up", scale * link.latency)
            ser_t = scale * serialization_time(wire_n, topo.wrapper)
            wrapper_t += ser_t
            _bd("wrapper", ser_t)
            network_t += scale * wire_time(wire_n, links)
            for link, dwn in zip(links, downs):
                w = scale * (wire_n / link.bandwidth)
                _bd("wire_down" if dwn else "wire_up", w)
                wire_links.append((link.name, dwn, w))
                if self.link_backlog and link.medium:
                    # live shared-medium occupancy: this transmission
                    # queues behind the backlog already committed to
                    # the medium (dispatch probes price with this; the
                    # cached per-client plans never carry it)
                    network_t += scale * self.link_backlog.get(link.medium, 0.0)
            # byte accounting is per wire hop relative to home (a payload
            # crossing two legs is counted on each): a hop whose far end
            # lies on its near end's route home is downlink — this keeps
            # star leaf->leaf traffic (down to the hub, then up a spoke)
            # honest, where any whole-transfer label would be wrong.
            # Probabilistic transfers count expected bytes; the integer
            # fast path keeps unconditional counters exact ints.
            for dwn in downs:
                if dwn:
                    down_bytes += wire_n if scale == 1.0 else scale * wire_n
                else:
                    up_bytes += wire_n if scale == 1.0 else scale * wire_n
                    _bd("raw_bytes_up", scale * float(nbytes))

        def _best_source(holders: Set[str], dst: str, nbytes: int) -> str:
            if len(holders) == 1:
                return next(iter(holders))
            return min(
                sorted(holders),
                key=lambda s: self.transfer_scalar(nbytes, s, dst),
            )

        # item -> probability it materializes (sources exist always;
        # stage outputs inherit the producer's exec_prob) — result
        # ship-home transfers are weighted by the producer's probability
        item_prob: Dict[str, float] = {i.name: 1.0 for i in comp.sources}

        for stage, dst in zip(comp.stages, placements):
            p = stage.exec_prob
            if topo.wrapped:
                if dst != topo.home:
                    # RPC envelope: proxy + skeleton call costs, request +
                    # response wire latency on every leg of the route.
                    wrapper_t += p * (2 * topo.wrapper.call_overhead)
                    _bd("wrapper", p * (2 * topo.wrapper.call_overhead))
                    for link in topo.path_links(topo.home, dst):
                        network_t += p * (2 * link.latency)
                        legs.append(LatencyLeg(link.name, link.latency, link.jitter, p))
                        legs.append(LatencyLeg(link.name, link.latency, link.jitter, p))
                        leg_down.append(False)  # request leg, away from home
                        leg_down.append(True)  # response leg, back home
                        _bd("lat_up", p * link.latency)
                        _bd("lat_down", p * link.latency)
                else:
                    # Local wrapped invocation still crosses the JNI boundary.
                    wrapper_t += p * topo.wrapper.call_overhead
                    _bd("wrapper", p * topo.wrapper.call_overhead)
            # --- move inputs to `dst` (piggybacked on the invocation) ---
            for name in stage.inputs:
                holders = residency[name]
                if dst not in holders:
                    item = table[name]
                    src = _best_source(holders, dst, item.nbytes)
                    _ship(item.nbytes, src, dst, piggyback=None, scale=p)
                    holders.add(dst)
                elif topo.wrapped and dst == topo.home:
                    # Already-local input of a wrapped home call marshals
                    # across JNI once (fast path: pinned arrays).
                    marshal_t = p * (
                        table[name].nbytes / topo.wrapper.jni_bandwidth
                    )
                    wrapper_t += marshal_t
                    _bd("wrapper", marshal_t)
            # --- compute (expected: a p-probability branch does its work
            # on p of the frames) ---
            ct = p * self.compute_time(stage, dst)
            compute_t += ct
            compute_by_tier[dst] = compute_by_tier.get(dst, 0.0) + ct
            _bd("compute_home" if dst == topo.home else "compute_remote", ct)
            for o in stage.outputs:
                residency[o.name] = {dst}
                item_prob[o.name] = p

        # --- results must land back home. If the producing stage was
        # remote this is the RPC response payload (no extra envelope);
        # residency tracking keeps it exact either way.
        for rname in comp.results:
            holders = residency[rname]
            if topo.home not in holders:
                item = table[rname]
                src = _best_source(holders, topo.home, item.nbytes)
                _ship(
                    item.nbytes,
                    src,
                    topo.home,
                    piggyback=True,
                    scale=item_prob.get(rname, 1.0),
                )
                holders.add(topo.home)

        total = compute_t + wrapper_t + network_t

        def _count(x):
            # unconditional pipelines keep exact int byte counters; an
            # expected count that happens to be integral canonicalizes
            # back to int so reports stay comparable across arms
            if isinstance(x, int):
                return x
            return int(x) if float(x).is_integer() else x

        return PlanReport(
            placements=tuple(placements),
            total_time=total,
            compute_time=compute_t,
            wrapper_time=wrapper_t,
            network_time=network_t,
            uplink_bytes=_count(up_bytes),
            downlink_bytes=_count(down_bytes),
            legs=tuple(legs),
            compute_by_tier=tuple(compute_by_tier.items()),
            breakdown=tuple(bd.items()),
            leg_down=tuple(leg_down),
            wire_by_link=tuple(wire_links),
        )
