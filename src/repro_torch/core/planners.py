"""Pluggable placement planners over the topology plan lattice.

Four strategies, all pricing candidates through the same
:class:`~repro_torch.core.costengine.CostEngine` so they agree exactly:

* ``ExhaustivePlanner``      — every tier^n assignment; the oracle for
  small lattices (the paper's 4-stage pipeline is 2^4 = 16 plans).
* ``SingleCrossingPlanner``  — home-prefix / remote-middle / home-suffix
  plans per remote tier, O(n^2 * k); the optimal family for pipelines
  whose transfer costs are monotone along the chain.
* ``ChainDPPlanner``         — exact O(n * k^2) dynamic program for
  *linear* computations (stage i fed by stage i-1 outputs and sources,
  results produced by the final stage).  A source consumed by several
  stages is priced exactly through a residency-augmented DP state (the
  holder set of each shared source), mirroring ``evaluate``'s residency
  tracking.  This is what makes per-layer-group LLM decode pipelines
  tractable at k > 2 tiers and n > 20 stages, where the lattice has
  k^n points.
* ``TreeDPPlanner``          — exact DP over branching *out-trees*
  (palm-detection fanning out to per-hand landmark branches): state =
  the tier of a stage, children combine by sum because the engine
  prices every inter-stage move independently when each item is
  consumed at most once.  General DAGs (join stages with several
  parents) fall back to a principled exact-cost local search: best
  uniform placement, then coordinate descent with full ``evaluate``
  pricing until 1-opt.

``auto_planner`` picks the cheapest applicable strategy for a given
lattice size (exhaustive -> chain DP -> tree DP -> single-crossing);
``PLANNERS`` exposes them by name for explicit override.  Conditional
stages (``Stage.exec_prob`` < 1) are priced at expected cost by every
planner, matching ``CostEngine.evaluate``'s expectation semantics.
"""

from __future__ import annotations

import itertools
from typing import Dict, FrozenSet, List, Optional, Tuple

from repro_torch.core.costengine import CostEngine, PlanReport
from repro_torch.core.stages import StagedComputation


class ExhaustivePlanner:
    """Argmin over the full tier^n plan lattice."""

    name = "exhaustive"

    def plan(self, comp: StagedComputation, engine: CostEngine) -> PlanReport:
        n = len(comp.stages)
        best: Optional[PlanReport] = None
        for placements in itertools.product(engine.placement_tiers(), repeat=n):
            rep = engine.evaluate(comp, placements)
            if best is None or rep.total_time < best.total_time:
                best = rep
        assert best is not None
        return best


class SingleCrossingPlanner:
    """home* remote* home* plans for each remote tier — O(n^2 * k).

    The all-home plan (the degenerate ``lo == hi`` window) is priced
    exactly once, up front: historically every empty window of every
    remote tier re-evaluated the identical plan — (k-1)·(n+1) redundant
    ``engine.evaluate`` calls per ``plan()`` that distorted
    ``topology_bench`` plans/sec without ever changing the argmin.
    """

    name = "single_crossing"

    def plan(self, comp: StagedComputation, engine: CostEngine) -> PlanReport:
        n = len(comp.stages)
        home = engine.topology.home
        remotes = [t for t in engine.placement_tiers() if t != home]
        # the one degenerate window: all stages at home
        best = engine.evaluate(comp, tuple(home for _ in range(n)))
        for remote in remotes:
            for lo in range(n):
                for hi in range(lo + 1, n + 1):
                    placements = tuple(
                        remote if lo <= i < hi else home for i in range(n)
                    )
                    rep = engine.evaluate(comp, placements)
                    if rep.total_time < best.total_time:
                        best = rep
        return best


class ChainDPPlanner:
    """Exact DP over linear chains: state = tier of the current stage.

    dp[i][t] = cost of stages 0..i with stage i on tier t, where each
    stage's term prices its envelope, compute, and source-item moves, and
    the transition prices moving the inter-stage activation t' -> t.  All
    terms come from the shared ``CostEngine`` scalar helpers, so the DP
    optimum matches exhaustive search wherever both apply.

    A source consumed by *several* stages (the tracker's ``h_prev``
    pattern) is handled exactly by augmenting the DP state with the
    holder set of each shared source: ``evaluate`` ships such an item
    once per new tier and serves later consumers from the cheapest
    holder, so the naive per-consumer transfer charge would overprice
    it.  With no shared sources the fast single-tier-state DP runs
    unchanged.  Conditional stages price at expected cost (terms scale
    by ``exec_prob``), matching ``evaluate``.
    """

    name = "chain_dp"

    @staticmethod
    def applicable(comp: StagedComputation) -> bool:
        """True iff the computation is a linear chain the DP prices
        exactly: stage i fed only by stage i-1 outputs and sources,
        every *stage output* consumed at most once (by the next stage),
        results produced by the final stage.  Sources may be consumed
        any number of times — the DP's residency-augmented state prices
        shared sources exactly (deciding admit-vs-reject by exactness
        against exhaustive: rejection was the wrong side)."""
        if not comp.stages:
            return False
        src_names = {i.name for i in comp.sources}
        consumed: Dict[str, int] = {}
        prev_outputs: set = set()
        for stage in comp.stages:
            for name in stage.inputs:
                consumed[name] = consumed.get(name, 0) + 1
                if name not in src_names and name not in prev_outputs:
                    return False
            prev_outputs = {o.name for o in stage.outputs}
        if any(
            v > 1 for name, v in consumed.items() if name not in src_names
        ):
            return False
        return set(comp.results) <= prev_outputs

    def plan(self, comp: StagedComputation, engine: CostEngine) -> PlanReport:
        if not self.applicable(comp):
            raise ValueError(
                f"computation {comp.name!r} is not a linear chain; use the "
                "tree, exhaustive or single-crossing planner"
            )
        topo = engine.topology
        tiers = engine.placement_tiers()
        stages = comp.stages
        n = len(stages)
        table = comp.item_table()
        src_names = {i.name for i in comp.sources}
        origin = {i.name: engine.resolve_origin(i) for i in comp.sources}
        consumed: Dict[str, int] = {}
        for s in stages:
            for name in s.inputs:
                consumed[name] = consumed.get(name, 0) + 1
        # sources consumed more than once need residency-set state
        shared = tuple(
            i.name for i in comp.sources if consumed.get(i.name, 0) > 1
        )
        # outputs of stage i-1 (chain feed of stage i)
        prev_out: List[set] = [set()] + [
            {o.name for o in s.outputs} for s in stages[:-1]
        ]

        def node_cost(i: int, t: str) -> float:
            """Envelope + compute + unshared-source moves of stage i at
            tier t, expectation-weighted (shared sources are priced in
            the transition, where the holder set lives)."""
            stage = stages[i]
            p = stage.exec_prob
            c = p * (
                engine.envelope_scalar(t) + engine.compute_time(stage, t)
            )
            for name in stage.inputs:
                if name in src_names and name not in shared:
                    nb = table[name].nbytes
                    o = origin[name]
                    if o == t:
                        c += p * engine.marshal_scalar(nb, t)
                    else:
                        c += p * engine.transfer_scalar(nb, o, t)
            return c

        def edge_cost(i: int, t_prev: str, t: str) -> float:
            p = stages[i].exec_prob
            c = 0.0
            for name in stages[i].inputs:
                if name in prev_out[i]:
                    nb = table[name].nbytes
                    if t_prev == t:
                        c += p * engine.marshal_scalar(nb, t)
                    else:
                        c += p * engine.transfer_scalar(nb, t_prev, t)
            return c

        def return_cost(t: str) -> float:
            if t == topo.home:
                return 0.0
            p = stages[-1].exec_prob
            # results ride the final RPC response home: no latency legs
            return sum(
                p
                * engine.transfer_scalar(
                    table[r].nbytes, t, topo.home, piggyback=True
                )
                for r in comp.results
            )

        if not shared:
            # fast path: the historical single-tier-state DP, unchanged
            dp = [{t: node_cost(0, t) for t in tiers}]
            parent: List[Dict[str, str]] = [{}]
            for i in range(1, n):
                row: Dict[str, float] = {}
                par: Dict[str, str] = {}
                for t in tiers:
                    base = node_cost(i, t)
                    best_c = None
                    best_p = None
                    for t_prev in tiers:
                        c = dp[i - 1][t_prev] + edge_cost(i, t_prev, t) + base
                        if best_c is None or c < best_c:
                            best_c = c
                            best_p = t_prev
                    row[t] = best_c
                    par[t] = best_p
                dp.append(row)
                parent.append(par)

            last = min(tiers, key=lambda t: dp[n - 1][t] + return_cost(t))
            placements = [last]
            for i in range(n - 1, 0, -1):
                placements.append(parent[i][placements[-1]])
            placements.reverse()
            return engine.evaluate(comp, tuple(placements))

        # --- residency-augmented DP for shared sources ------------------
        # State: (tier of stage i, holder-set tuple aligned with
        # `shared`).  Transitions replicate evaluate()'s residency walk:
        # a shared input already held at the stage's tier pays the JNI
        # marshal (wrapped home) or nothing; otherwise it ships from the
        # cheapest current holder and the tier joins the holder set.
        State = Tuple[str, Tuple[FrozenSet[str], ...]]

        def shared_cost_and_holders(
            i: int, t: str, holders: Tuple[FrozenSet[str], ...]
        ) -> Tuple[float, Tuple[FrozenSet[str], ...]]:
            p = stages[i].exec_prob
            c = 0.0
            hl = list(holders)
            for name in stages[i].inputs:
                if name not in shared:
                    continue
                idx = shared.index(name)
                nb = table[name].nbytes
                if t in hl[idx]:
                    c += p * engine.marshal_scalar(nb, t)
                else:
                    src = min(
                        sorted(hl[idx]),
                        key=lambda s: engine.transfer_scalar(nb, s, t),
                    )
                    c += p * engine.transfer_scalar(nb, src, t)
                    hl[idx] = hl[idx] | {t}
            return c, tuple(hl)

        init_holders = tuple(frozenset({origin[name]}) for name in shared)
        frontier: Dict[State, float] = {}
        parents: List[Dict[State, State]] = []
        par0: Dict[State, State] = {}
        for t in tiers:
            sc, hl = shared_cost_and_holders(0, t, init_holders)
            frontier[(t, hl)] = node_cost(0, t) + sc
        parents.append(par0)
        for i in range(1, n):
            nxt: Dict[State, float] = {}
            par: Dict[State, State] = {}
            for (t_prev, holders), cost_prev in frontier.items():
                for t in tiers:
                    sc, hl = shared_cost_and_holders(i, t, holders)
                    c = (
                        cost_prev
                        + edge_cost(i, t_prev, t)
                        + node_cost(i, t)
                        + sc
                    )
                    key: State = (t, hl)
                    if key not in nxt or c < nxt[key]:
                        nxt[key] = c
                        par[key] = (t_prev, holders)
            frontier = nxt
            parents.append(par)

        best_key = min(
            frontier, key=lambda k: frontier[k] + return_cost(k[0])
        )
        placements = [best_key[0]]
        key = best_key
        for i in range(n - 1, 0, -1):
            key = parents[i][key]
            placements.append(key[0])
        placements.reverse()
        return engine.evaluate(comp, tuple(placements))


class TreeDPPlanner:
    """Exact DP over out-trees; exact-cost local search on general DAGs.

    Domain of exactness (``applicable``): every item consumed at most
    once, every stage fed by at most one producing stage (an out-forest
    of branches), results pure sinks.  Under those conditions
    ``evaluate``'s residency tracking never shares an item between
    consumers, so the total plan cost decomposes into independent
    per-stage node terms plus one term per tree edge — children combine
    by *sum* because the engine prices each inter-stage move
    independently.  The DP state is the tier of a stage:

        cost[i][t] = node(i, t)
                   + sum over children c of min_tc(edge(i->c, t, tc)
                                                   + cost[c][tc])

    with node() = expected envelope + compute + source moves + result
    ship-home, and edge() the expected move of the consumed parent
    output (JNI marshal when colocated).  Roots minimize independently.
    O(n * k^2), exact bit-for-bit against exhaustive on its domain
    (property-tested on every lattice <= 512).

    A general DAG — a join stage consuming outputs of two different
    producers — couples parent tiers through the child's term; exact DP
    over trees no longer applies, so ``plan`` falls back to a principled
    exact-cost search: price every uniform placement, then coordinate
    descent (re-evaluate each stage at every tier, keep the argmin) with
    the full ``evaluate`` until a sweep makes no progress.  Monotone,
    exact pricing, 1-opt at convergence.
    """

    name = "tree_dp"

    _MAX_SWEEPS = 6  # DAG fallback: coordinate-descent sweep bound

    @staticmethod
    def applicable(comp: StagedComputation) -> bool:
        """Strict out-forest check — the domain where the DP is exact."""
        if not comp.stages:
            return False
        src_names = {i.name for i in comp.sources}
        produced: set = set()
        for s in comp.stages:
            for o in s.outputs:
                if o.name in produced or o.name in src_names:
                    return False  # ambiguous producer
                produced.add(o.name)
        consumed: Dict[str, int] = {}
        producer_stage = comp.producer_of()
        for s in comp.stages:
            parents = set()
            for name in s.inputs:
                consumed[name] = consumed.get(name, 0) + 1
                p = producer_stage.get(name)
                if p is not None:
                    parents.add(p)
            if len(parents) > 1:
                return False  # join stage: a DAG, not an out-tree
        if any(v > 1 for v in consumed.values()):
            return False  # shared item: residency would couple consumers
        for r in comp.results:
            if consumed.get(r, 0) > 0 and r in produced:
                return False  # result re-consumed: not a pure sink
            if r in src_names and consumed.get(r, 0) > 0:
                return False  # consumed passthrough source: holders grow
        return True

    @classmethod
    def dag_applicable(cls, comp: StagedComputation) -> bool:
        """The fallback's (much looser) domain: any non-empty stage DAG."""
        return bool(comp.stages)

    def plan(self, comp: StagedComputation, engine: CostEngine) -> PlanReport:
        if self.applicable(comp):
            return self._plan_tree(comp, engine)
        if self.dag_applicable(comp):
            return self._plan_dag(comp, engine)
        raise ValueError(
            f"computation {comp.name!r} has no stages to place"
        )

    # -- exact out-tree DP ----------------------------------------------

    def _plan_tree(
        self, comp: StagedComputation, engine: CostEngine
    ) -> PlanReport:
        topo = engine.topology
        tiers = engine.placement_tiers()
        stages = comp.stages
        n = len(stages)
        table = comp.item_table()
        src_names = {i.name for i in comp.sources}
        origin = {i.name: engine.resolve_origin(i) for i in comp.sources}
        results = set(comp.results)
        stage_idx = {s.name: i for i, s in enumerate(stages)}
        producer_stage = comp.producer_of()

        # children[i] = [(child index, consumed item names)], parent the
        # unique producing stage (applicable() guaranteed <= 1)
        children: List[List[Tuple[int, List[str]]]] = [[] for _ in range(n)]
        parent: List[Optional[int]] = [None] * n
        for ci, s in enumerate(stages):
            feeds: Dict[int, List[str]] = {}
            for name in s.inputs:
                p = producer_stage.get(name)
                if p is not None:
                    feeds.setdefault(stage_idx[p], []).append(name)
            for pi, names in feeds.items():
                parent[ci] = pi
                children[pi].append((ci, names))

        def node_cost(i: int, t: str) -> float:
            stage = stages[i]
            p = stage.exec_prob
            c = p * (
                engine.envelope_scalar(t) + engine.compute_time(stage, t)
            )
            for name in stage.inputs:
                if name in src_names:
                    nb = table[name].nbytes
                    o = origin[name]
                    if o == t:
                        c += p * engine.marshal_scalar(nb, t)
                    else:
                        c += p * engine.transfer_scalar(nb, o, t)
            # results this stage produces ship home from wherever it ran
            # (pure sinks: nothing else moves them first)
            if t != topo.home:
                for o in stage.outputs:
                    if o.name in results:
                        c += p * engine.transfer_scalar(
                            o.nbytes, t, topo.home, piggyback=True
                        )
            return c

        def edge_cost(names: List[str], ci: int, t_par: str, t: str) -> float:
            p = stages[ci].exec_prob
            c = 0.0
            for name in names:
                nb = table[name].nbytes
                if t_par == t:
                    c += p * engine.marshal_scalar(nb, t)
                else:
                    c += p * engine.transfer_scalar(nb, t_par, t)
            return c

        # leaf-up DP (stage order is topological: children after parents)
        cost: List[Dict[str, float]] = [{} for _ in range(n)]
        choice: List[Dict[str, Dict[int, str]]] = [{} for _ in range(n)]
        for i in range(n - 1, -1, -1):
            for t in tiers:
                c = node_cost(i, t)
                picks: Dict[int, str] = {}
                for ci, names in children[i]:
                    best_c = None
                    best_t = None
                    for tc in tiers:
                        cc = edge_cost(names, ci, t, tc) + cost[ci][tc]
                        if best_c is None or cc < best_c:
                            best_c = cc
                            best_t = tc
                    c += best_c
                    picks[ci] = best_t
                cost[i][t] = c
                choice[i][t] = picks

        placements: List[Optional[str]] = [None] * n
        for i in range(n):
            if parent[i] is None:  # each root minimizes independently
                placements[i] = min(tiers, key=lambda t: cost[i][t])
        for i in range(n):  # parents resolve before children (topological)
            t = placements[i]
            for ci, _names in children[i]:
                placements[ci] = choice[i][t][ci]
        return engine.evaluate(comp, tuple(placements))

    # -- general-DAG fallback: exact-cost coordinate descent -------------

    def _plan_dag(
        self, comp: StagedComputation, engine: CostEngine
    ) -> PlanReport:
        tiers = engine.placement_tiers()
        n = len(comp.stages)

        def descend(seed: PlanReport) -> PlanReport:
            best = seed
            for _ in range(self._MAX_SWEEPS):
                improved = False
                for i in range(n):
                    cur = best.placements[i]
                    for t in tiers:
                        if t == cur:
                            continue
                        cand = (
                            best.placements[:i]
                            + (t,)
                            + best.placements[i + 1 :]
                        )
                        rep = engine.evaluate(comp, cand)
                        if rep.total_time < best.total_time:
                            best = rep
                            improved = True
                if not improved:
                    break
            return best

        # descend from every uniform seed: different basins of the
        # placement landscape (all-home vs all-edge starts converge to
        # different 1-opt points on join-heavy DAGs)
        best: Optional[PlanReport] = None
        for t in tiers:
            rep = descend(engine.evaluate(comp, tuple(t for _ in range(n))))
            if best is None or rep.total_time < best.total_time:
                best = rep
        assert best is not None
        return best


PLANNERS = {
    p.name: p
    for p in (
        ExhaustivePlanner(),
        SingleCrossingPlanner(),
        ChainDPPlanner(),
        TreeDPPlanner(),
    )
}


# Above this many candidate plans a linear chain goes to the DP even
# inside the exhaustive budget — the DP is equally exact and O(n*k^2),
# while exhaustive evaluate() calls grow as k^n (3^12 is already ~a
# minute of planning).
_DP_PREFERRED_ABOVE = 512


def auto_planner(
    comp: StagedComputation, engine: CostEngine, max_candidates: int
):
    """Exhaustive while the lattice is tiny; exact DP for chains, then
    branching out-trees, as soon as exhaustive search would be slow; the
    single-crossing family as the general-case fallback."""
    k = len(engine.placement_tiers())
    n = len(comp.stages)
    lattice = k**n
    if lattice <= min(max_candidates, _DP_PREFERRED_ABOVE):
        return PLANNERS["exhaustive"]
    if ChainDPPlanner.applicable(comp):
        return PLANNERS["chain_dp"]
    if TreeDPPlanner.applicable(comp):
        return PLANNERS["tree_dp"]
    if lattice <= max_candidates:
        return PLANNERS["exhaustive"]
    return PLANNERS["single_crossing"]
