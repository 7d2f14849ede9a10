"""Fleet-scale simulation: many thin clients vs contended edge servers.

The paper proves one weak client + one strong server works; this package
asks how many such clients a shared pool of edge servers sustains.  See
``fleet.run_fleet`` / ``fleet.capacity_sweep`` for the front-end,
``events`` for the discrete-event engine, ``dispatch`` for edge
selection policies, ``plancache`` for plan caching with drift-triggered
incremental re-planning, ``migration`` for mid-run client re-dispatch
with hysteresis (live migration), and ``fastfleet`` for the vectorized
event engine (``run_fleet(engine="vector")``) that runs the same
simulation event-for-event at a multiple of the object engine's
throughput — the 10k-client sweep path, and ``telemetry`` for the
opt-in observability layer (per-frame span traces, metrics registry,
latency attribution) both engines feed identically; ``slo`` builds the
online SLO monitor + fault-injected root-cause doctor on top of it
(``run_fleet(slo=SLOMonitor(...))``).
"""

from repro_torch.cluster.dispatch import (  # noqa: F401
    DISPATCH_POLICIES,
    edge_subtopology,
    make_dispatch,
)
from repro_torch.cluster.events import (  # noqa: F401
    AdaptiveWindow,
    BatchingSlotServer,
    EventQueue,
    LinkTable,
    SlotServer,
)
from repro_torch.cluster.fastfleet import (  # noqa: F401
    ArrayLoopStats,
    run_fleet_vectorized,
)
from repro_torch.cluster.fleet import (  # noqa: F401
    ClientResult,
    FleetResult,
    LinkDrift,
    ServiceDrift,
    SweepPoint,
    capacity_sweep,
    run_fleet,
)
from repro_torch.cluster.migration import (  # noqa: F401
    MigrationConfig,
    MigrationController,
    MigrationRecord,
    MigrationStats,
    tracker_state_nbytes,
)
from repro_torch.cluster.plancache import (  # noqa: F401
    DriftDetector,
    PlanCache,
    comp_signature,
    topology_fingerprint,
)
from repro_torch.cluster.slo import (  # noqa: F401
    BEST_EFFORT,
    DOCTOR_CLASSES,
    FAULTS,
    INTERACTIVE,
    SLO_CLASSES,
    FaultSpec,
    Incident,
    SLOClass,
    SLOMonitor,
    doctor_verdict,
    slo_of,
)
from repro_torch.cluster.telemetry import (  # noqa: F401
    SPAN_ORDER,
    MetricsRegistry,
    Telemetry,
)
