"""Plan caching and drift-triggered incremental re-planning.

RAPID (the paper's decision engine) re-evaluates its offloading decision
continuously; re-planning from scratch per client per frame is exactly
what does not scale to a fleet.  Two pieces fix that:

* :class:`PlanCache` — memoizes ``offload.plan`` results keyed by
  (stage signature, topology fingerprint, policy, planner).  Every
  client of the same hardware class talking to the same edge over the
  same link conditions shares one cached ``PlanReport`` — a fleet of N
  identical thin clients costs O(num_edges) plans, not O(N).  A hit
  returns the stored report object itself, so it is bit-identical by
  construction.

* :class:`DriftDetector` — per (client, link) rolling means of the leg
  latencies each request actually observed, compared against the leg
  latencies the client's plan charged.  When the observed mean deviates
  beyond ``threshold`` (relative), only that client re-plans — against
  the *current* link conditions, which changes the topology fingerprint
  and therefore misses into a fresh cache entry.  Unaffected clients
  keep hitting their existing plans.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Deque, Dict, Optional, Tuple

from repro_torch.core import offload
from repro_torch.core.costengine import PlanReport
from repro_torch.core.offload import Policy, Topology
from repro_torch.core.stages import StagedComputation


def comp_signature(comp: StagedComputation) -> Tuple:
    """Hashable identity of a staged computation's cost-relevant fields."""
    return (
        comp.name,
        tuple((i.name, i.nbytes, i.origin) for i in comp.sources),
        tuple(
            (
                s.name,
                s.flops,
                s.parallel_fraction,
                s.inputs,
                tuple((o.name, o.nbytes, o.origin) for o in s.outputs),
                # appended LAST so positional consumers of older
                # signature tuples stay valid (see invalidate_link)
                s.exec_prob,
            )
            for s in comp.stages
        ),
        comp.results,
    )


# id-indexed memo for comp_signature: the fleet calls PlanCache.key with
# the SAME StagedComputation object millions of times (every replan,
# every migration probe), and walking the stage tuples each time
# dominates the lookup.  Keyed by id() with a weakref guard so a
# recycled id can never alias a dead computation's signature.
_SIG_MEMO: Dict[int, Tuple[object, Tuple]] = {}


def cached_comp_signature(comp: StagedComputation) -> Tuple:
    """``comp_signature`` with an id-indexed fast path for repeat calls
    on the same live object (the fleet hot loop's case)."""
    entry = _SIG_MEMO.get(id(comp))
    if entry is not None and entry[0]() is comp:
        return entry[1]
    sig = comp_signature(comp)
    try:
        ref = weakref.ref(comp)
    except TypeError:
        return sig
    _SIG_MEMO[id(comp)] = (ref, sig)
    return sig


def topology_fingerprint(topo: Topology) -> Tuple:
    """Hashable identity of everything the cost engine reads from a
    topology — tiers, links (including current latency/jitter), wrapper,
    home, wrapped.  Link drift changes the fingerprint, which is what
    makes re-planning after drift a cache *miss* by construction."""
    tiers = tuple(
        (
            pname,
            t.name,
            t.accel_flops,
            t.scalar_flops,
            t.dispatch_overhead,
            t.has_accelerator,
            t.capacity,
            t.batching,
            t.batch_overhead,
            t.batch_marginal,
        )
        for pname, t in topo.tiers.items()
    )
    links = tuple(
        # shared-medium fields ride at the END so positional consumers
        # (invalidate_link reads entry[2] == link name) stay valid
        (a, b, l.name, l.bandwidth, l.latency, l.jitter, l.medium,
         l.medium_capacity)
        for (a, b), l in topo.links.items()
    )
    w = topo.wrapper
    return (
        tiers,
        links,
        topo.home,
        topo.wrapped,
        (w.call_overhead, w.serialization_bandwidth, w.jni_bandwidth),
    )


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    invalidations: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


class PlanCache:
    """Memoized ``offload.plan`` keyed by computation + topology identity."""

    def __init__(self) -> None:
        self._plans: Dict[Tuple, PlanReport] = {}
        self.stats = CacheStats()
        # optional telemetry hook ``fn(kind, n=1)`` fired alongside
        # ``stats`` (kinds: "hit" / "miss" / "invalidation"); None (the
        # default) is a no-op — see repro_torch.cluster.telemetry
        self.on_event = None

    def __len__(self) -> int:
        return len(self._plans)

    @staticmethod
    def key(
        comp: StagedComputation,
        topo: Topology,
        policy: Policy,
        planner: Optional[str] = None,
        codec=None,
    ) -> Tuple:
        # the codec operating point is part of a plan's identity: a
        # frozen flat-field CodecModel hashes directly, so clients at
        # the same point share one plan and a rate-controller switch is
        # a miss by construction
        return (
            cached_comp_signature(comp),
            topology_fingerprint(topo),
            policy.value,
            planner,
            codec,
        )

    def get_or_plan(
        self,
        comp: StagedComputation,
        topo: Topology,
        policy: Policy = Policy.AUTO,
        planner: Optional[str] = None,
        record_stats: bool = True,
        codec=None,
    ) -> Tuple[PlanReport, bool]:
        """Returns (report, was_hit).  A hit is the stored object itself.

        ``record_stats=False`` keeps the lookup out of ``stats`` (the
        plan is still cached on a miss): the migration controller scores
        every candidate edge once per considered frame, and counting
        those probes would drown the hit-rate signal that measures
        actual per-client planning work."""
        key = self.key(comp, topo, policy, planner, codec)
        cached = self._plans.get(key)
        if cached is not None:
            if record_stats:
                self.stats.hits += 1
                if self.on_event is not None:
                    self.on_event("hit")
            return cached, True
        rep = offload.plan(comp, topo, policy, planner=planner, codec=codec)
        self._plans[key] = rep
        if record_stats:
            self.stats.misses += 1
            if self.on_event is not None:
                self.on_event("miss")
        return rep, False

    def invalidate_link(self, link_name: str) -> int:
        """Drop every cached plan whose topology includes ``link_name``.
        Returns the number of entries removed (hygiene hook for central
        eviction; the drift path usually relies on fingerprint misses)."""
        doomed = [
            key
            for key in self._plans
            if any(entry[2] == link_name for entry in key[1][1])
        ]
        for key in doomed:
            del self._plans[key]
        self.stats.invalidations += len(doomed)
        if doomed and self.on_event is not None:
            self.on_event("invalidation", len(doomed))
        return len(doomed)


class DriftDetector:
    """Flags clients whose observed leg latencies left their plan behind.

    ``observe(client, plan, observed_legs)`` feeds one request's drawn
    per-leg latencies; returns True when, for some link, the rolling
    mean of at least ``min_samples`` draws deviates from the plan's
    charged latency by more than ``threshold`` (relative to the charged
    latency, with an absolute floor to keep zero-latency links sane).
    ``reset(client)`` clears the window after a re-plan so the fresh
    plan is judged on fresh evidence.
    """

    def __init__(
        self,
        threshold: float = 0.5,
        window: int = 16,
        min_samples: int = 8,
        abs_floor: float = 1e-4,
    ):
        self.threshold = threshold
        self.window = window
        self.min_samples = max(1, min_samples)
        self.abs_floor = abs_floor
        self._obs: Dict[Tuple[int, str], Deque[float]] = {}

    def observe(self, client: int, plan: PlanReport, observed) -> bool:
        predicted: Dict[str, float] = {}
        for leg in plan.legs:
            predicted.setdefault(leg.link, leg.latency)
        drifted = False
        for link, draw in observed:
            dq = self._obs.get((client, link))
            if dq is None:
                dq = collections.deque(maxlen=self.window)
                self._obs[(client, link)] = dq
            dq.append(draw)
            if len(dq) < self.min_samples:
                continue
            pred = predicted.get(link)
            if pred is None:
                continue
            mean = sum(dq) / len(dq)
            tol = max(self.threshold * pred, self.abs_floor)
            if abs(mean - pred) > tol:
                drifted = True
        return drifted

    def reset(self, client: int) -> None:
        for key in [k for k in self._obs if k[0] == client]:
            del self._obs[key]
