"""Simulated transport of pytrees across a link, with byte accounting.

``Transport`` prices real trees of tensors or arrays between two logical
endpoints while charging simulated wall-clock time. The data stays where
it is (the same host and card), so executed simulations produce the
tracker's own output while the clock reflects the modeled network —
this is how sim/runtime.py runs the paper's experiments on one machine.

All arithmetic delegates to the leg-level primitives of
``core.costengine`` (the unified cost engine), so the executed path
charges exactly the formulas the analytic planner prices; the link's
jitter is drawn through ``Link.transfer_time(nbytes, rng)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch.core.costengine import envelope_time, serialization_time, wire_time
from repro_torch.core.topology import Link, WrapperModel
from repro_torch.core.stages import pytree_nbytes


@dataclasses.dataclass
class TransferRecord:
    nbytes: int
    seconds: float
    direction: str  # "up" | "down"


class Transport:
    """A link between client and server endpoints with an RNG for jitter."""

    def __init__(
        self,
        link: Link,
        wrapper: Optional[WrapperModel] = None,
        seed: int = 0,
    ):
        self.link = link
        self.wrapper = wrapper
        self.rng = np.random.default_rng(seed)
        self.log: list[TransferRecord] = []

    def rpc_envelope_time(self) -> float:
        """Request + response wire latency for one remote invocation."""
        return envelope_time((self.link,), self.wrapper, self.rng)

    def payload_time(self, tree: Any, direction: str = "up") -> float:
        """Time to ship a pytree payload (serialization + wire)."""
        nbytes = pytree_nbytes(tree)
        t = wire_time(nbytes, (self.link,))
        if self.wrapper is not None:
            t += serialization_time(nbytes, self.wrapper)
        self.log.append(TransferRecord(nbytes, t, direction))
        return t

    @property
    def total_bytes(self) -> int:
        return sum(r.nbytes for r in self.log)

    @property
    def total_seconds(self) -> float:
        return sum(r.seconds for r in self.log)
