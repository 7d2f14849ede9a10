"""Dispatch policies: which edge box serves which client.

The fleet topology is a star — every client looks like the hub (the
paper's laptop), and several edge servers hang off it on their own
links.  Each client's *plan* is still the paper's two-machine problem:
home tier + one edge server; dispatch decides which edge that is.

Every policy runs in two regimes: once per client at admission (t=0),
and — when ``run_fleet(migration=...)`` arms the
:class:`~repro_torch.cluster.migration.MigrationController` — again at every
mid-run re-dispatch consideration, where the live server state finally
differs from the assignment counts.

* ``round_robin``      — static striping, the baseline every serving
  stack starts with.
* ``least_queue``      — pick the edge with the fewest in-flight plus
  assigned requests (join-the-shortest-queue).  At admission (t=0) the
  live ``SlotServer`` load term is still zero and this reduces to
  assignment-count striping; at mid-run re-dispatch the in-flight term
  is real and the policy follows the actual queues.
* ``latency_weighted`` — price a plan against every edge with the
  occupancy-aware cost engine (queueing inflation from current
  assignments; on a ``batching`` tier that inflation is the sublinear
  ``BatchServiceModel`` amortization instead of processor sharing) and
  take the argmin predicted step latency.  This is the paper's RAPID
  "should I offload?" decision extended to "offload *where*?".
* ``batch_affinity``   — prefer the edge currently *gathering* the
  largest open batch *compatible with this client's computation*
  (joining a forming batch amortizes its launch and adds no extra
  queueing; a foreign-key batch is just queue ahead of us), then fall
  back to join-the-shortest-queue.
  Whenever no batch is open the policy reduces to ``least_queue``
  exactly — which covers non-batching edges and all admission-time
  placement.  As the migration controller's target policy it is *live*:
  a migrating client is steered toward the edge gathering an open batch
  under its computation key (tested in tests/test_migration.py).

All ties break on edge name, so every policy is deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

from repro_torch.cluster.events import BatchingSlotServer, LinkTable, SlotServer
from repro_torch.core import offload
from repro_torch.core.offload import Policy, Topology
from repro_torch.core.stages import StagedComputation


def edge_subtopology(
    topo: Topology,
    edge_name: str,
    link_table: Optional[LinkTable] = None,
    client_tier=None,
) -> Topology:
    """The two-tier view one client plans against: home + one edge.

    With ``link_table`` the link reflects current (possibly drifted)
    conditions, so re-planning calibrates against what the client will
    actually experience.  ``client_tier`` substitutes a heterogeneous
    client's own hardware for the star's default home tier (the hub
    models *any one* client's vantage point; a weaker client plans —
    and fingerprints — against its own silicon, so each hardware class
    misses into its own plan-cache entries by construction).
    """
    link = topo.link_between(topo.home, edge_name)
    if link_table is not None:
        link = link_table.get(link.name)
    home_tier = topo.tier(topo.home) if client_tier is None else client_tier
    return Topology(
        tiers={
            topo.home: home_tier,
            edge_name: topo.tier(edge_name),
        },
        links={(topo.home, edge_name): link},
        home=topo.home,
        wrapper=topo.wrapper,
        wrapped=topo.wrapped,
    )


@dataclasses.dataclass
class DispatchContext:
    """What a policy may look at when placing a client."""

    topo: Topology
    comp: StagedComputation
    policy: Policy
    edges: List[str]
    servers: Dict[str, Union[SlotServer, BatchingSlotServer]]
    link_table: LinkTable
    assignments: Dict[str, int]  # edge -> clients currently assigned
    now: float = 0.0
    codec: object = None  # CodecModel the fleet's clients ship under
    client_tier: object = None  # the asking client's own hardware (hetero)
    # medium name -> SharedLink: live occupancy of shared uplinks (cell /
    # backhaul).  None or empty when every spoke is private.
    media: Optional[Dict[str, object]] = None


class RoundRobinDispatch:
    name = "round_robin"

    def __init__(self) -> None:
        self._next = 0

    def assign(self, client_id: int, ctx: DispatchContext) -> str:
        edge = ctx.edges[self._next % len(ctx.edges)]
        self._next += 1
        return edge


class LeastQueueDispatch:
    name = "least_queue"

    def assign(self, client_id: int, ctx: DispatchContext) -> str:
        return min(
            ctx.edges,
            key=lambda e: (
                ctx.servers[e].load(ctx.now) + ctx.assignments.get(e, 0),
                e,
            ),
        )


class LatencyWeightedDispatch:
    name = "latency_weighted"

    def assign(self, client_id: int, ctx: DispatchContext) -> str:
        # live queue delay of each shared medium, priced onto any wire
        # leg that crosses it (probe-side only: the plan cache never
        # keys on backlog, and with no shared media this is None — the
        # exact historical probe)
        backlog = (
            {m: med.queue_delay(ctx.now) for m, med in ctx.media.items()}
            if ctx.media
            else None
        )

        def predicted(edge: str) -> float:
            sub = edge_subtopology(
                ctx.topo, edge, ctx.link_table, client_tier=ctx.client_tier
            )
            rep = offload.plan(
                ctx.comp,
                sub,
                ctx.policy,
                occupancy={edge: ctx.assignments.get(edge, 0)},
                codec=ctx.codec,
                link_backlog=backlog,
            )
            return rep.total_time

        return min(ctx.edges, key=lambda e: (predicted(e), e))


class BatchAffinityDispatch:
    """Join the edge gathering the largest open batch, else the
    shortest queue.  Open batches only exist while requests are in
    flight, so at ``run_fleet``'s t=0 admission-time placement this is
    ``least_queue``; as the migration controller's target policy the
    affinity term fires for real — migrating clients are steered toward
    edges with a forming batch under their computation key."""

    name = "batch_affinity"

    def assign(self, client_id: int, ctx: DispatchContext) -> str:
        # keyed by the computation this client would submit (run_fleet
        # submits key=comp.name): only a *compatible* open batch can be
        # joined; a foreign-key batch is just queue ahead of us
        return min(
            ctx.edges,
            key=lambda e: (
                -ctx.servers[e].open_batch_size(ctx.comp.name),
                ctx.servers[e].load(ctx.now) + ctx.assignments.get(e, 0),
                e,
            ),
        )


DISPATCH_POLICIES = {
    cls.name: cls
    for cls in (
        RoundRobinDispatch,
        LeastQueueDispatch,
        LatencyWeightedDispatch,
        BatchAffinityDispatch,
    )
}


def make_dispatch(name: str):
    if name not in DISPATCH_POLICIES:
        raise ValueError(
            f"unknown dispatch policy {name!r}; choose from "
            f"{sorted(DISPATCH_POLICIES)}"
        )
    return DISPATCH_POLICIES[name]()
