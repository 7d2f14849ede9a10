"""Placement policies for staged computations across compute tiers.

This is the RAPID decision engine (paper §3.2) generalized from the
paper's hard-wired client/server pair to arbitrary N-tier topologies:
a :class:`~repro_torch.core.topology.Topology` names its tiers ("device",
"edge", "cloud", ...) and joins them with links; placements are tier
names; and every cost — compute, wrapper/serialization, per-leg network
latency and wire time — is priced by the single
:class:`~repro_torch.core.costengine.CostEngine` that ``net.transport`` and
``sim.runtime`` also delegate to.

Policies (paper Table 1, unchanged semantics):
  * LOCAL  — never offload: every stage at the topology's home tier
    (the "RAPID-enabled, no offloading" rows of Fig. 4).
  * FORCED — every stage on the fastest remote tier (models a client
    with no GPU).
  * AUTO   — argmin of expected step latency under the cost model,
    via a pluggable planner (``core.planners``): exhaustive search for
    small plan lattices (the oracle version of RAPID's heuristic), an
    exact O(n*k^2) dynamic program for long linear chains (per-layer
    LLM decode pipelines at 3+ tiers), and the single-crossing family
    as the general fallback.

The two-tier :class:`Environment` of the original implementation
survives as a thin shim over ``Topology.two_tier`` — placements keep the
historical ``"client"`` / ``"server"`` literals, and existing callers
(sim, serving, benchmarks, examples) work unchanged while new code
passes a ``Topology`` directly.  See ``core/costengine.py`` for the full
cost semantics (RPC envelopes, piggybacked payloads, residency
tracking, per-leg jitter records).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Sequence, Union

from repro_torch.core.costengine import (  # noqa: F401  (re-exported API)
    BatchServiceModel,
    CostEngine,
    LatencyLeg,
    PlanReport,
)
from repro_torch.core.planners import PLANNERS, auto_planner
from repro_torch.core.stages import StagedComputation
from repro_torch.core.topology import (  # noqa: F401  (re-exported API)
    Link,
    Tier,
    Topology,
    WrapperModel,
)


class Policy(enum.Enum):
    LOCAL = "local"
    FORCED = "forced"
    AUTO = "auto"


@dataclasses.dataclass(frozen=True)
class Environment:
    """Two-tier compatibility shim over :class:`Topology`.

    The paper's deployment shape: one client, one server, one link.
    ``as_topology()`` maps it onto the graph model with placement names
    "client" (home) and "server"."""

    client: Tier
    server: Tier
    link: Link
    wrapper: WrapperModel = dataclasses.field(default_factory=WrapperModel)
    # Native mode: no container at all (the C++ baseline of Fig. 4).
    wrapped: bool = True

    def as_topology(self) -> Topology:
        return Topology.two_tier(
            self.client, self.server, self.link, self.wrapper, self.wrapped
        )


EnvironmentLike = Union[Environment, Topology]


def as_topology(env: EnvironmentLike) -> Topology:
    if isinstance(env, Topology):
        return env
    return env.as_topology()


def evaluate_plan(
    comp: StagedComputation,
    placements: Sequence[str],
    env: EnvironmentLike,
    codec=None,
) -> PlanReport:
    """Exact cost of one placement vector with residency tracking."""
    return CostEngine(as_topology(env), codec=codec).evaluate(comp, placements)


def plan(
    comp: StagedComputation,
    env: EnvironmentLike,
    policy: Policy,
    max_exhaustive: int = 20,
    planner: Optional[str] = None,
    occupancy: Optional[Dict[str, int]] = None,
    codec=None,
    link_backlog: Optional[Dict[str, float]] = None,
) -> PlanReport:
    """Choose placements under a policy and return the cost report.

    ``max_exhaustive`` bounds the lattice AUTO may search exhaustively
    (k_tiers ** n_stages <= 2 ** max_exhaustive), but linear chains
    switch to the equally-exact O(n*k^2) DP once the lattice outgrows a
    few hundred plans — see ``planners.auto_planner``.  Pass
    ``planner`` ("exhaustive" | "single_crossing" | "chain_dp") to force
    a specific AUTO strategy.  ``occupancy`` (tier name -> concurrent
    requests already there) makes the engine charge queueing inflation
    on contended tiers — how a fleet dispatcher prices a loaded edge.
    ``codec`` (a ``repro_torch.codec.model.CodecModel``) makes every
    transfer leg codec-aware: compressed wire bytes plus encode/decode compute at
    the payload's endpoints — which can flip AUTO's decision on links
    where raw payloads drowned the offload win.  ``link_backlog``
    (shared-medium name -> seconds of live queue delay) prices wire
    legs against current link occupancy the same way ``occupancy``
    prices contended tiers; both are probe-side knobs — the plan cache
    never keys on them, so dispatchers pass them only on uncached
    probes.
    """
    topo = as_topology(env)
    engine = CostEngine(
        topo, occupancy=occupancy, codec=codec, link_backlog=link_backlog
    )
    n = len(comp.stages)
    if policy is Policy.LOCAL:
        return engine.evaluate(comp, (topo.home,) * n)
    if policy is Policy.FORCED:
        return engine.evaluate(comp, (topo.primary_remote(),) * n)

    if planner is not None:
        if planner not in PLANNERS:
            raise ValueError(
                f"unknown planner {planner!r}; choose from {sorted(PLANNERS)}"
            )
        chosen = PLANNERS[planner]
    else:
        chosen = auto_planner(comp, engine, max_candidates=2**max_exhaustive)
    return chosen.plan(comp, engine)


def compare_granularities(
    comp: StagedComputation, env: EnvironmentLike, policy: Policy
) -> Dict[str, PlanReport]:
    """The paper's Single-Step vs Multi-Step comparison for one setup."""
    return {
        "multi_step": plan(comp, env, policy),
        "single_step": plan(comp.fused(), env, policy),
    }
