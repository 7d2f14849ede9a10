"""Fleet simulation walkthrough: from the paper's one client to a city.

Runs a capacity sweep of paper-style thin clients against two shared
metro-edge GPU boxes, compares dispatch policies, injects Wi-Fi-grade
latency drift on one spoke mid-run and shows that only the affected
clients re-plan (the RAPID adaptive loop at fleet scale), turns on
edge batching and shows the fused-launch capacity lift on a wired star,
arms live migration on a hotspot star — clients drain off the
saturated weak edge mid-run, carrying their pose + swarm state — and
finally arms the payload codec on the network-bound 5G star: the
rate-controlled delta+quantize stream cuts the 537.6 kB frame to tens
of kB and lifts every client back to camera rate.  Then the spokes
stop being private: every client's wire legs contend for one shared
5G cell (``hardware.shared_cell_star``), and the same codec is run
blind vs with the cell-fairness loop — the fair fleet backs off down
the bits ladder (heaviest payload first) and buys back the queueing
the blind fleet drowns in.  The fleet then stops being single-model:
clients cycle across the multi-model workload registry (solo landmark
chain, branching multi-hand tree, gesture head, RGBD DAG) and the
DAG-aware planner — pricing conditional branches at expected cost —
is raced against forced linearization.  A final pass reruns
the codec fleet with telemetry armed: per-frame span traces exported as
Chrome trace-event JSON (load ``fleet_trace.json`` in Perfetto or
``chrome://tracing``) and the latency-attribution table showing where
each millisecond of p50/p99 loop time went.  The closing act arms the
online SLO monitor on the doctor star and throttles one edge mid-run:
the burn-rate windows open a timestamped incident, the root-cause
attributor diffs the incident window against the healthy baseline, and
the printed report names the throttled edge's queue as the culprit.

  PYTHONPATH=src python -m repro_torch.examples.fleet_sim
"""

from __future__ import annotations

import dataclasses

from repro_torch.cluster import (
    DOCTOR_CLASSES,
    LinkDrift,
    MigrationConfig,
    SLOMonitor,
    Telemetry,
    capacity_sweep,
    doctor_verdict,
    run_fleet,
)
from repro_torch.cluster.fleet import ServiceDrift
from repro_torch.codec import CodecConfig, sequence_motion
from repro_torch.core.offload import Policy
from repro_torch.net import links
from repro_torch.sim import hardware


def main() -> None:
    comp = hardware.paper_staged()
    topo = hardware.fleet_star(num_edges=2, edge_capacity=4)

    print("== capacity sweep (round_robin) ==")
    print("clients  fps    drop    p99_ms  cache_hit")
    for p in capacity_sweep(topo, comp, (1, 2, 4, 8, 16, 32), num_frames=150):
        print(
            f"{p.num_clients:7d}  {p.fps:5.1f}  {p.drop_rate:6.3f}  "
            f"{p.p99 * 1e3:6.1f}  {p.result.cache.stats.hit_rate:9.2f}"
        )

    print("\n== dispatch policies at 16 clients ==")
    for dispatch in ("round_robin", "least_queue", "latency_weighted"):
        r = run_fleet(
            topo, comp, num_clients=16, num_frames=150, dispatch=dispatch
        )
        loads = ", ".join(f"{e.name}:{e.clients}" for e in r.edges)
        print(
            f"{dispatch:17s} fps={r.mean_achieved_fps:5.1f} "
            f"drop={r.drop_rate:.3f} p99={r.p99_loop_time * 1e3:6.1f}ms "
            f"assignment [{loads}]"
        )

    print("\n== drift: spoke 0 degrades to Wi-Fi latency at t=2s ==")
    r = run_fleet(
        topo,
        comp,
        num_clients=8,
        num_frames=200,
        policy=Policy.AUTO,
        drifts=[LinkDrift(time=2.0, link="5g_edge_0", latency=40e-3)],
    )
    for c in r.clients:
        print(
            f"client {c.client} on {c.edge}: replans={c.replans} "
            f"drop={c.stats.drop_rate:.3f} mean_wait={c.mean_wait * 1e3:.2f}ms"
        )
    s = r.cache.stats
    print(f"plan cache: {s.hits} hits / {s.misses} misses ({s.hit_rate:.0%})")

    print("\n== edge batching: FIFO vs fused launches (wired star) ==")
    print("clients  mode       fps    drop    mean_batch")
    for batching in (False, True):
        wired = hardware.fleet_star(
            num_edges=2,
            edge_capacity=1,
            base_link=links.GIGABIT_ETHERNET,
            batching=batching,
        )
        mode = "batched" if batching else "unbatched"
        for n in (8, 16, 32):
            r = run_fleet(wired, comp, num_clients=n, num_frames=150)
            mbs = max((e.mean_batch_size for e in r.edges), default=0.0)
            print(
                f"{n:7d}  {mode:9s}  {r.mean_achieved_fps:5.1f}  "
                f"{r.drop_rate:6.3f}  {mbs:10.1f}"
            )

    print("\n== live migration: hotspot star (edge_0 is 8x slower) ==")
    hotspot = hardware.hotspot_star(num_edges=3, edge_capacity=2)
    for mode, mig in (
        ("static", None),
        ("migrate", MigrationConfig(min_dwell_frames=10)),
    ):
        r = run_fleet(
            hotspot, comp, num_clients=9, num_frames=300,
            dispatch="least_queue", migration=mig,
        )
        loads = ", ".join(
            f"{e.name}:{e.clients}(peak {e.peak_load})" for e in r.edges
        )
        print(
            f"{mode:8s} fps={r.mean_achieved_fps:5.1f} "
            f"drop={r.drop_rate:.3f} p99={r.p99_loop_time * 1e3:6.1f}ms "
            f"[{loads}]"
        )
        if r.migration is not None:
            for rec in r.migration.records:
                print(
                    f"  client {rec.client}: {rec.src} -> {rec.dst} at "
                    f"t={rec.time:.2f}s, {rec.nbytes / 1e3:.1f} kB of "
                    f"state in {rec.latency * 1e3:.2f} ms"
                )

    print("\n== payload codec: raw vs delta+quantize on the 5G star ==")
    cfg = CodecConfig(base=hardware.codec_point(), motion=sequence_motion())
    for mode, codec in (("raw", None), ("codec", cfg)):
        r = run_fleet(topo, comp, num_clients=8, num_frames=150, codec=codec)
        point = r.clients[0].codec
        knobs = (
            f" [{point.quant_bits}-bit depth, keyframe every "
            f"{point.keyframe_interval}]" if point is not None else ""
        )
        print(
            f"{mode:6s} fps={r.mean_achieved_fps:5.1f} "
            f"drop={r.drop_rate:.3f} "
            f"uplink={r.mean_uplink_bytes / 1e3:6.1f} kB/frame "
            f"rate_changes={r.total_rate_changes}{knobs}"
        )

    print("\n== shared 5G cell: blind vs fair rate control ==")
    # one narrow radio cell, one transmission slot, 12 equal clients
    cell = hardware.shared_cell_star(
        num_edges=2,
        edge_capacity=4,
        base_link=dataclasses.replace(links.FIVE_G_EDGE, bandwidth=15e6),
        cell_capacity=1,
    )
    fair_cfg = CodecConfig(
        base=hardware.codec_point(entropy=True),  # entropy codec v2
        motion=sequence_motion(),
        bits_ladder=(16, 8, 4, 2),
        cell_threshold=0.1e-3,  # smoothed ratio-weighted wait per rung
        cell_stagger=0.05,  # deterministic shed order
        resync_bound=4,  # drops clamp keyframe spacing
    )
    blind_cfg = dataclasses.replace(fair_cfg, cell_threshold=float("inf"))
    for mode, codec in (("blind", blind_cfg), ("fair", fair_cfg)):
        r = run_fleet(
            cell, comp, num_clients=12, num_frames=150,
            dispatch="latency_weighted", codec=codec,
        )
        lk = r.links[0]
        served = [len(c.stats.processed) for c in r.clients]
        print(
            f"{mode:6s} fps={r.mean_achieved_fps:5.1f} "
            f"drop={r.drop_rate:.3f} "
            f"uplink={r.mean_uplink_bytes / 1e3:6.1f} kB/frame "
            f"cell wait={lk.mean_wait * 1e3:5.2f}ms/txn "
            f"served spread={max(served) / min(served):.2f}x"
        )

    print("\n== mixed multi-model traffic: DAG-aware vs linearized ==")
    # client c runs mix[c % 4]: chain / out-tree / gesture head / RGBD
    # DAG.  The linearized arm forces every conditional branch (second
    # hand, re-detect, re-seed) to run on every frame — what a
    # DAG-blind planner must assume; expected-cost pricing stops
    # paying for branches that rarely fire.
    mix = hardware.mixed_workloads()
    wired = hardware.fleet_star(
        num_edges=2, edge_capacity=2, base_link=links.GIGABIT_ETHERNET
    )
    for mode, suite in (
        ("linearized", tuple(w.linearized() for w in mix)),
        ("dag-aware", mix),
    ):
        r = run_fleet(
            wired, comp, num_clients=12, num_frames=150,
            policy=Policy.AUTO, dispatch="least_queue",
            granularity="multi_step", workloads=suite, engine="vector",
        )
        print(
            f"{mode:10s} fps={r.mean_achieved_fps:5.1f} "
            f"drop={r.drop_rate:.3f} p99={r.p99_loop_time * 1e3:6.1f}ms"
        )

    print("\n== telemetry: span traces + latency attribution ==")
    tel = Telemetry()
    run_fleet(
        topo, comp, num_clients=8, num_frames=150, codec=cfg, telemetry=tel,
    )
    # every frame's spans sum bit-for-bit to its loop time — the trace
    # is an exact decomposition, not a sampled approximation
    print(f"verified {tel.verify_exact()} frames span-exact")
    doc = tel.export_chrome_trace("fleet_trace.json")
    print(
        f"wrote fleet_trace.json ({len(doc['traceEvents'])} events) — "
        "open in Perfetto / chrome://tracing"
    )
    print(tel.format_attribution_table())

    print("\n== SLO doctor: edge_1 thermally throttles 8x at t=1.5s ==")
    # the canonical doctor star: 3 hetero edges behind one shared cell,
    # mixed registry workloads at a 12 fps camera — the scenario the
    # reference's fault-injection gate (fleet_bench --doctor) certifies
    # on both engines.  The monitor rides along as a Telemetry subclass; the
    # burn-rate windows open incidents online and the attributor
    # explains them against the rolling healthy baseline.
    dtopo, dclasses = hardware.doctor_star()
    mon = SLOMonitor(classes=DOCTOR_CLASSES)
    run_fleet(
        dtopo, comp, num_clients=8, num_frames=200,
        dispatch="least_queue", policy=Policy.AUTO,
        granularity="multi_step", client_classes=dclasses,
        workloads=hardware.mixed_workloads(),
        codec=CodecConfig(
            base=hardware.codec_point(entropy=True),
            motion=sequence_motion(), resync_bound=4,
        ),
        camera_fps=12, migration=MigrationConfig(), gather_window=2e-3,
        drifts=[ServiceDrift(time=1.5, edge="edge_1", factor=8.0)],
        slo=mon,
    )
    for wl, a in mon.attainment().items():
        print(
            f"  {wl:15s} [{a['slo']:11s}] observed={a['observed']:4d} "
            f"missed={a['misses']:3d} p99~{a['p99_est_ms']:6.1f}ms "
            f"slow_burn={a['slow_burn']:.2f}"
        )
    print(mon.format_incident_report())
    top, _scores = doctor_verdict(mon)
    print(f"doctor verdict: {top}")


if __name__ == "__main__":
    main()
