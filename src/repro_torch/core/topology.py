"""Topology graph for multi-tier offloading.

The paper's deployment is one weak client and one strong server joined by
a single link.  Production edge systems (AVEC, arXiv:2103.04930) span a
*hierarchy* — device -> edge -> cloud chains, or a device star-connected
to several edge servers.  This module models that shape directly:

* ``Tier``     — a compute endpoint (accelerator + scalar FLOP/s).
* ``Link``     — a network edge (bandwidth, latency, jitter).
* ``Topology`` — named tiers joined by links, with a designated ``home``
  tier where sensor data originates and results must land.  Placements
  are tier *names*, so the two-tier special case keeps the historical
  ``"client"`` / ``"server"`` literals via :meth:`Topology.two_tier`.

Routing between non-adjacent tiers follows the fewest-hop path (BFS),
computed once and cached; the cost engine (``core.costengine``) charges
per-leg wire/latency costs along it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple


def sample_latency(latency: float, jitter: float, rng=None) -> float:
    """One latency draw: Gaussian around ``latency`` when jittered."""
    if rng is None or jitter <= 0.0:
        return latency
    return max(0.0, float(rng.normal(latency, jitter)))


@dataclasses.dataclass(frozen=True)
class Tier:
    """A compute tier (the paper's "server" / "laptop", or a TPU pod).

    ``capacity`` is the number of requests the tier can serve concurrently
    at full speed (virtualized-accelerator slots, AVEC-style).  The paper's
    dedicated server is capacity 1 with a single client, so nothing queues;
    a shared edge box saturates once more than ``capacity`` clients hit it
    simultaneously, and the cost engine / fleet simulator charge queueing
    delay beyond that point.

    ``batching`` declares that the tier fuses compatible concurrent
    requests into one accelerator launch instead of time-slicing them:
    service time becomes *sublinear* in the number of co-served requests
    (``costengine.BatchServiceModel``) rather than processor-sharing
    inflated.  ``batch_overhead`` is the fixed extra cost of a fused
    multi-item launch (gather/scatter bookkeeping, seconds) and
    ``batch_marginal`` the fraction of an item's solo service time each
    *additional* batched item costs (1.0 = no amortization; the floats
    live here rather than a nested model object so the tier stays a flat
    hashable record the plan-cache fingerprint can consume directly).
    """

    name: str
    accel_flops: float  # effective accelerator FLOP/s for this workload
    scalar_flops: float  # serial/CPU FLOP/s (the non-parallel fraction)
    dispatch_overhead: float = 50e-6  # per-stage launch cost, seconds
    has_accelerator: bool = True
    capacity: int = 1  # concurrent service slots
    batching: bool = False  # fuse concurrent requests into one launch
    batch_overhead: float = 0.0  # fixed cost per fused multi-item launch
    batch_marginal: float = 0.35  # per-extra-item fraction of solo time


@dataclasses.dataclass(frozen=True)
class Link:
    """A network link between tiers.

    ``medium`` names the shared physical medium (cell sector, backhaul
    trunk) this link's wire legs contend on: every link carrying the
    same non-empty medium name shares ``medium_capacity`` concurrent
    transmission slots (``cluster.events.SharedLink``).  The empty
    string is a private spoke — the historical model and the exact
    off-switch — and ``medium_capacity == 0`` with a medium name is an
    unlimited shared medium: occupancy is *counted* but nothing ever
    queues, which must be bit-for-bit the private fleet (golden-tested).
    """

    name: str
    bandwidth: float  # bytes / second
    latency: float  # one-way, seconds
    jitter: float = 0.0  # stddev of latency, seconds (Wi-Fi interference)
    medium: str = ""  # shared-medium name ("" = private spoke)
    medium_capacity: int = 0  # concurrent transmissions (0 = unlimited)

    def transfer_time(self, nbytes: int, rng=None) -> float:
        """One-way payload time; pass ``rng`` to draw a jittered latency."""
        return sample_latency(self.latency, self.jitter, rng) + nbytes / self.bandwidth


@dataclasses.dataclass(frozen=True)
class WrapperModel:
    """Container ("JNI/JVM") overhead model — see core/wrapper.py for the
    calibration of these constants.

    Two distinct marshalling paths, matching the Java stack the paper
    uses: a *local* wrapped call crosses JNI with pinned/direct buffers
    (fast), while a *remote* call must push the payload through Java
    object-stream serialization (slow). Conflating the two cannot
    reconcile Fig. 4 (modest local wrapper tax) with Fig. 5 (~10 fps
    offloaded => tens of ms of serialization per frame)."""

    call_overhead: float = 1.2e-3  # fixed cost per wrapped method call
    serialization_bandwidth: float = 20e6  # remote path, bytes/s
    jni_bandwidth: float = 60e6  # local JNI marshal path, bytes/s

    def cost(self, nbytes: int) -> float:
        return self.call_overhead + nbytes / self.serialization_bandwidth


@dataclasses.dataclass
class Topology:
    """Named tiers joined by links, with a ``home`` tier.

    ``tiers`` maps *placement names* (the strings used in plans) to
    ``Tier`` specs; a tier's ``name`` field is its hardware identity and
    need not equal its placement name (the two-tier shim maps the
    calibrated "laptop_gf670m" tier to placement name "client").
    ``links`` keys are unordered tier-name pairs.
    """

    tiers: Mapping[str, Tier]
    links: Mapping[Tuple[str, str], Link]
    home: str = "client"
    wrapper: WrapperModel = dataclasses.field(default_factory=WrapperModel)
    wrapped: bool = True

    def __post_init__(self) -> None:
        if self.home not in self.tiers:
            raise ValueError(f"home tier {self.home!r} not in topology")
        self._adj: Dict[str, Dict[str, Link]] = {n: {} for n in self.tiers}
        for (a, b), link in self.links.items():
            if a not in self.tiers or b not in self.tiers:
                raise ValueError(f"link {link.name!r} joins unknown tier ({a}, {b})")
            self._adj[a][b] = link
            self._adj[b][a] = link
        self._paths: Dict[Tuple[str, str], Tuple[str, ...]] = {}
        # connectivity check (BFS from home)
        seen = {self.home}
        frontier = [self.home]
        while frontier:
            cur = frontier.pop()
            for nxt in self._adj[cur]:
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        if seen != set(self.tiers):
            raise ValueError(f"topology is disconnected: {set(self.tiers) - seen}")

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def path_tiers(self, src: str, dst: str) -> Tuple[str, ...]:
        """Tier names visited from src to dst inclusive (fewest hops)."""
        key = (src, dst)
        if key in self._paths:
            return self._paths[key]
        # BFS with deterministic neighbor order (insertion order of links)
        parent: Dict[str, str] = {src: src}
        frontier = [src]
        while frontier and dst not in parent:
            nxt_frontier = []
            for cur in frontier:
                for nxt in self._adj[cur]:
                    if nxt not in parent:
                        parent[nxt] = cur
                        nxt_frontier.append(nxt)
            frontier = nxt_frontier
        if dst not in parent:
            raise ValueError(f"no path {src!r} -> {dst!r}")
        path = [dst]
        while path[-1] != src:
            path.append(parent[path[-1]])
        tiers = tuple(reversed(path))
        self._paths[key] = tiers
        return tiers

    def path_links(self, src: str, dst: str) -> Tuple[Link, ...]:
        """The link legs crossed going from src to dst."""
        tiers = self.path_tiers(src, dst)
        return tuple(self._adj[a][b] for a, b in zip(tiers, tiers[1:]))

    def link_between(self, a: str, b: str) -> Link:
        return self._adj[a][b]

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def tier(self, name: str) -> Tier:
        return self.tiers[name]

    def tier_names(self) -> Tuple[str, ...]:
        return tuple(self.tiers)

    def primary_remote(self) -> str:
        """Default FORCED target: the fastest non-home tier by effective
        speed (a tier without an accelerator computes at scalar rate)."""
        remotes = [n for n in self.tiers if n != self.home]
        if not remotes:
            return self.home

        def _effective(name: str) -> float:
            t = self.tiers[name]
            return t.accel_flops if t.has_accelerator else t.scalar_flops

        return max(remotes, key=_effective)

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------

    @classmethod
    def two_tier(
        cls,
        client: Tier,
        server: Tier,
        link: Link,
        wrapper: Optional[WrapperModel] = None,
        wrapped: bool = True,
    ) -> "Topology":
        """The paper's shape; placements keep the client/server literals."""
        return cls(
            tiers={"client": client, "server": server},
            links={("client", "server"): link},
            home="client",
            wrapper=wrapper if wrapper is not None else WrapperModel(),
            wrapped=wrapped,
        )

    @classmethod
    def chain(
        cls,
        tiers: Sequence[Tuple[str, Tier]],
        links: Sequence[Link],
        home: Optional[str] = None,
        wrapper: Optional[WrapperModel] = None,
        wrapped: bool = True,
    ) -> "Topology":
        """A linear device -> edge -> ... -> cloud hierarchy."""
        if len(links) != len(tiers) - 1:
            raise ValueError("chain needs exactly len(tiers)-1 links")
        names = [n for n, _ in tiers]
        return cls(
            tiers=dict(tiers),
            links={
                (names[i], names[i + 1]): link for i, link in enumerate(links)
            },
            home=home if home is not None else names[0],
            wrapper=wrapper if wrapper is not None else WrapperModel(),
            wrapped=wrapped,
        )

    @classmethod
    def star(
        cls,
        hub: Tuple[str, Tier],
        spokes: Sequence[Tuple[str, Tier, Link]],
        wrapper: Optional[WrapperModel] = None,
        wrapped: bool = True,
    ) -> "Topology":
        """A home hub connected to several edge servers."""
        hub_name, hub_tier = hub
        tiers = {hub_name: hub_tier}
        links = {}
        for name, tier, link in spokes:
            tiers[name] = tier
            links[(hub_name, name)] = link
        return cls(
            tiers=tiers,
            links=links,
            home=hub_name,
            wrapper=wrapper if wrapper is not None else WrapperModel(),
            wrapped=wrapped,
        )
