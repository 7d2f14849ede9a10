"""Staged computations with byte/FLOP annotations.

The paper's Fig. 2: the per-frame hand-tracking optimization consists of
four discrete steps that can be exposed to the offloading framework either
individually ("Multi-Step") or fused ("Single-Step"). This module gives
that structure a first-class representation the placement engine
(``core.offload``) can reason about: each stage declares its FLOPs and
the data items it consumes/produces, and each data item knows its size,
so plan cost (compute + serialization + network) is computable
analytically.

The same abstraction describes an LLM ``serve_step`` (embed -> blocks ->
head) — see the reference's ``repro/serving/edge.py`` — which is how the
paper's technique generalizes to the assigned architectures.

Branching pipelines: dependencies between stages are declared
through the data items themselves — a stage may consume any item
produced by *any* earlier stage, not just its immediate predecessor, so
the stage list describes an arbitrary DAG in topological order (a
linear chain is the special case where every stage consumes its
predecessor's output).  Conditional branches carry an execution
probability: ``Stage.exec_prob`` is the probability the stage runs on a
given frame (a mediapipe-style re-detect branch fires only when
tracking is lost), and the cost engine prices every term of a
probabilistic stage — compute, envelope, input/output transfers, wire
bytes — by its *expected* value (term × exec_prob).  ``validate()``
enforces coherence: a stage can never run more often than the branch
that feeds it (``exec_prob`` ≤ min over producers of its inputs).
``linearized()`` strips the probabilities (every branch forced
unconditional) — the baseline a DAG-aware planner is benchmarked
against in the reference's ``fleet_bench --mixed``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

CLIENT = "client"
SERVER = "server"


@dataclasses.dataclass(frozen=True)
class DataItem:
    """A named datum flowing between stages.

    ``origin`` is where the item first materializes: CLIENT for sensor
    inputs (camera frames, the previous-frame solution h_t) and stage
    outputs get their producer's placement at plan-evaluation time.
    """

    name: str
    nbytes: int
    origin: str = CLIENT


@dataclasses.dataclass(frozen=True)
class Stage:
    """One offloadable step.

    flops: arithmetic cost of the stage (population evaluation dominates).
    parallel_fraction: the portion of ``flops`` that scales with the
      executing tier's accelerator (the GPGPU part); the rest runs at
      scalar speed. The paper's 100x GPGPU speedup claim only applies to
      the parallel fraction — Amdahl bookkeeping matters for Fig. 4.
    exec_prob: probability the stage executes on a given frame (1.0 =
      unconditional, the historical behavior).  The cost engine prices a
      conditional stage at its expected cost: compute, envelope, input
      and output transfers all scale by ``exec_prob``.  Appended after
      ``fn`` so existing positional constructors are untouched.
    """

    name: str
    flops: float
    inputs: Tuple[str, ...]
    outputs: Tuple[DataItem, ...]
    parallel_fraction: float = 1.0
    fn: Optional[Callable] = None  # the actual callable, if bound
    exec_prob: float = 1.0


@dataclasses.dataclass(frozen=True)
class StagedComputation:
    """An ordered pipeline of stages with serial dependencies.

    ``results`` are item names that must reside at CLIENT when the pipeline
    finishes (the tracker must hand h_{t+1} back to the acquisition loop —
    paper Fig. 3 category A)."""

    name: str
    sources: Tuple[DataItem, ...]
    stages: Tuple[Stage, ...]
    results: Tuple[str, ...]

    def item_table(self) -> Dict[str, DataItem]:
        table: Dict[str, DataItem] = {i.name: i for i in self.sources}
        for s in self.stages:
            for o in s.outputs:
                table[o.name] = o
        return table

    def validate(self) -> None:
        known = {i.name for i in self.sources}
        # item -> probability it materializes (sources always exist)
        prob: Dict[str, float] = {i.name: 1.0 for i in self.sources}
        for s in self.stages:
            if not 0.0 < s.exec_prob <= 1.0:
                raise ValueError(
                    f"stage {s.name!r} exec_prob {s.exec_prob!r} "
                    "must be in (0, 1]"
                )
            for inp in s.inputs:
                if inp not in known:
                    raise ValueError(
                        f"stage {s.name!r} consumes unknown item {inp!r}"
                    )
                if s.exec_prob > prob[inp]:
                    # a branch cannot run more often than what feeds it
                    raise ValueError(
                        f"stage {s.name!r} exec_prob {s.exec_prob} exceeds "
                        f"the probability {prob[inp]} of its input {inp!r}"
                    )
            for o in s.outputs:
                known.add(o.name)
                prob[o.name] = s.exec_prob
        for r in self.results:
            if r not in known:
                raise ValueError(f"result item {r!r} never produced")

    # -- DAG structure helpers -----------------------------------------

    def producer_of(self) -> Dict[str, str]:
        """Item name -> producing stage name (sources absent)."""
        out: Dict[str, str] = {}
        for s in self.stages:
            for o in s.outputs:
                out[o.name] = s.name
        return out

    def consumer_counts(self) -> Dict[str, int]:
        """Item name -> number of times any stage consumes it."""
        counts: Dict[str, int] = {}
        for s in self.stages:
            for inp in s.inputs:
                counts[inp] = counts.get(inp, 0) + 1
        return counts

    def stage_parents(self) -> Dict[str, Tuple[str, ...]]:
        """Stage name -> distinct producing stages of its non-source
        inputs, in first-appearance order — the stage-level dependency
        DAG implied by the item flow."""
        producer = self.producer_of()
        parents: Dict[str, Tuple[str, ...]] = {}
        for s in self.stages:
            seen: List[str] = []
            for inp in s.inputs:
                p = producer.get(inp)
                if p is not None and p not in seen:
                    seen.append(p)
            parents[s.name] = tuple(seen)
        return parents

    def linearized(self) -> "StagedComputation":
        """The forced-unconditional variant: every branch's
        ``exec_prob`` reset to 1.0, as if conditional stages executed on
        every frame.  This is the baseline a DAG-aware planner is
        measured against (``fleet_bench --mixed``); on an already
        unconditional computation it is the identity."""
        if all(s.exec_prob == 1.0 for s in self.stages):
            return self
        stages = tuple(
            dataclasses.replace(s, exec_prob=1.0) for s in self.stages
        )
        return StagedComputation(self.name, self.sources, stages, self.results)

    def fused(self, fused_name: str = "single_step") -> "StagedComputation":
        """Single-Step variant: all stages fused into one offloadable unit.

        Intermediate items disappear from the network-visible surface —
        exactly why the paper's Single-Step beats Multi-Step: only the
        sources go up and only the results come down.

        Conditional stages fuse at their *expected* cost (flops weighted
        by ``exec_prob``) — the fused unit always runs, but on an
        average frame only the expected fraction of each branch's work
        executes inside it.  A passthrough result (a source name listed
        in ``results``) is NOT re-emitted as a fused-stage output: it
        already resides at its origin, and re-producing it would charge
        a bogus ship-home from wherever the fused stage lands.  A
        zero-flops pipeline fuses with ``parallel_fraction = 0.0`` (no
        parallel work exists, so none may be claimed)."""
        if not self.stages:
            raise ValueError(f"cannot fuse {self.name!r}: no stages")
        self.validate()
        table = self.item_table()
        total_flops = sum(s.exec_prob * s.flops for s in self.stages)
        wsum = sum(
            s.exec_prob * s.flops * s.parallel_fraction for s in self.stages
        )
        pfrac = wsum / total_flops if total_flops else 0.0
        src_names = tuple(i.name for i in self.sources)
        outputs = tuple(
            table[r] for r in self.results if r not in set(src_names)
        )
        fused_stage = Stage(
            name=fused_name,
            flops=total_flops,
            inputs=src_names,
            outputs=outputs,
            parallel_fraction=pfrac,
        )
        return StagedComputation(
            name=f"{self.name}[fused]",
            sources=self.sources,
            stages=(fused_stage,),
            results=self.results,
        )

    def total_flops(self) -> float:
        return sum(s.flops for s in self.stages)


def pytree_nbytes(tree) -> int:
    """Byte size of a tree (dicts, lists, tuples) of tensors or arrays —
    used to annotate stage boundaries from real signatures.  ``None`` is
    an empty tree; a leaf without a dtype (a Python scalar) counts 8."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(pytree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(pytree_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    dtype = getattr(tree, "dtype", None)
    if dtype is None:
        return 8
    shape = getattr(tree, "shape", ())
    return int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize


def flops_of_fn(fn: Callable, *args) -> float:
    """FLOPs of ``fn(*args)`` by the op census (``roofline.op_cost``),
    counted as XLA's cost analysis counts them: the port's counterpart of
    the reference's ``flops_of_jaxpr``.  ``fn`` runs once."""
    from repro_torch.roofline import op_cost

    return op_cost.op_cost(fn, *args)[1].flops
