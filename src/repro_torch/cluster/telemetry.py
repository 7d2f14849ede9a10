"""Fleet telemetry: span traces, a metrics registry, and attribution.

The fleet simulator reports aggregate fps / drop / p99, which says
nothing about *where* a millisecond of tail latency went — wire vs
queue wait vs batch gather vs compute vs edge-side decode vs migration
blackout.  This module is the opt-in observability layer for both event
engines (``run_fleet(telemetry=Telemetry())``):

* **Span traces** — every processed frame is decomposed into the spans
  of :data:`SPAN_ORDER`, derived from the exact quantities the engines
  already compute: the plan's cost breakdown
  (``PlanReport.breakdown``), the per-leg jitter draws, and the
  per-visit queue/batch timestamps the slot servers report.  The spans
  of a frame sum *exactly* (bit for bit, left-to-right) to its recorded
  loop time ``finish - start`` — a residual ``"other"`` span absorbs
  float-summation slack and is driven to an exact identity by a short
  fix-point iteration (:func:`exact_spans`).  Traces export as Chrome
  trace-event JSON (:meth:`Telemetry.export_chrome_trace`), viewable in
  Perfetto / ``chrome://tracing``.
* **Metrics registry** — counters, gauges, and fixed-log-bucket
  histograms (:class:`MetricsRegistry`), fed by hooks in ``PlanCache``
  (hit / miss / invalidation), the migration controller (considered /
  rejected-dwell / rejected-threshold / accepted), the codec rate
  controller (ladder transitions, compressed-vs-raw uplink bytes), and
  the slot servers (occupancy timelines, batch-size histograms).
* **Latency attribution** — :meth:`Telemetry.attribution` decomposes
  p50 / p99 loop time per span and per client class; the reference's
  ``fleet_bench --trace`` prints the table and gates on engine
  equivalence of the whole trace.

Both engines call the same hooks with bit-identical inputs (that is the
engines' equivalence contract), so an armed ``Telemetry`` records the
identical trace on either engine — and ``telemetry=None``
leaves both engines bit-for-bit untouched (every hook site is behind an
``if tel is not None`` guard with no float or RNG side effects).

One ``Telemetry`` instance observes one run; reusing an instance across
runs accumulates counters/histograms (gauges overwrite) and concatenates
traces, which is occasionally useful but rarely what a report wants.
"""

from __future__ import annotations

import json
import math
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "SPAN_ORDER",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Telemetry",
    "exact_spans",
]

# Per-frame spans in chronological (and fold) order.  The left-to-right
# float fold of a frame's span tuple equals its loop time exactly:
#   client      home-side work: home compute, home encode/decode, every
#               wrapper cost (envelope, serialization, JNI marshal)
#   uplink      charged uplink-direction propagation + wire time, plus
#               the jitter delta of every uplink-direction leg draw
#   queue-wait  FIFO admission delay (incl. throttle inflation) at
#               non-batching edges
#   batch-gather  gather-window dwell + fused-launch inflation at
#               batching edges
#   decode      edge-side codec work (payload decode + result encode)
#   compute     remote stage compute
#   downlink    downlink-direction propagation/wire + jitter deltas
#   other       float-summation residual (typically < 1 ulp of the
#               loop time; exactness guard, not a physical phase)
SPAN_ORDER: Tuple[str, ...] = (
    "client",
    "uplink",
    "queue-wait",
    "batch-gather",
    "decode",
    "compute",
    "downlink",
    "other",
)

_N_PARTS = len(SPAN_ORDER) - 1  # physical spans, excluding "other"


def exact_spans(parts: Sequence[float], loop: float) -> Tuple[float, ...]:
    """Append a residual so the left-to-right fold equals ``loop`` exactly.

    ``parts`` are the physical span estimates; their float sum differs
    from ``loop`` by accumulated rounding.  Setting
    ``other = loop - sum(parts)`` is usually already exact; when it is
    not, a Newton-style fix-point (``other += loop - fold``) converges
    in a step or two.  If some adversarial rounding pattern defeats
    even that, the degenerate-but-exact answer (everything in
    ``other``) keeps the invariant absolute.
    """
    s = 0.0
    for d in parts:
        s += d
    other = loop - s
    for _ in range(6):
        t = s + other  # == fold(parts + [other]) since fold(parts) == s
        if t == loop:
            return tuple(parts) + (other,)
        other += loop - t
    return (0.0,) * len(parts) + (loop,)


def _pctile(sorted_vals: Sequence[float], q: float) -> float:
    """Percentile by rank (same ceil-rank convention as FleetResult)."""
    if not sorted_vals:
        return 0.0
    n = len(sorted_vals)
    idx = min(n - 1, max(0, math.ceil(q * n) - 1))
    return sorted_vals[idx]


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic count (ints or exact float byte totals)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Fixed-log-bucket histogram: bucket k covers
    ``(lo * growth**(k-1), lo * growth**k]``; values <= ``lo`` (including
    zeros/negatives) land in bucket 0, values past the last bound in the
    overflow bucket.  Deterministic and allocation-light: one bisect per
    observation."""

    __slots__ = ("bounds", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, lo: float = 1e-6, growth: float = 2.0, nbuckets: int = 40):
        if lo <= 0.0 or growth <= 1.0 or nbuckets < 2:
            raise ValueError("need lo > 0, growth > 1, nbuckets >= 2")
        self.bounds = [lo * growth**k for k in range(nbuckets)]
        self.counts = [0] * (nbuckets + 1)  # +1 overflow
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Upper bucket bound at quantile ``q`` in [0, 1] (0 if empty)."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        acc = 0
        for k, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                return self.bounds[min(k, len(self.bounds) - 1)]
        return self.bounds[-1]

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
            "p50": self.percentile(0.50),
            "p99": self.percentile(0.99),
        }


class MetricsRegistry:
    """Name -> instrument, created on first touch."""

    __slots__ = ("counters", "gauges", "histograms")

    def __init__(self) -> None:
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(
        self, name: str, lo: float = 1e-6, growth: float = 2.0, nbuckets: int = 40
    ) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(lo, growth, nbuckets)
        return h

    def snapshot(self) -> Dict[str, Dict]:
        """Deterministic (sorted) dump of every instrument."""
        return {
            "counters": {k: self.counters[k].value for k in sorted(self.counters)},
            "gauges": {k: self.gauges[k].value for k in sorted(self.gauges)},
            "histograms": {
                k: self.histograms[k].snapshot() for k in sorted(self.histograms)
            },
        }


# ---------------------------------------------------------------------------
# the telemetry object
# ---------------------------------------------------------------------------


class Telemetry:
    """Per-run observability sink both fleet engines feed.

    Engine-facing hooks (called only when armed; every call site is
    guarded so ``telemetry=None`` stays bit-for-bit golden):

    * :meth:`attach` / :meth:`detach` — wire/unwire the ``PlanCache``
      event hook and the slot servers' ``telemetry`` attribute.
    * :meth:`register_clients` — client index -> hardware-class label.
    * :meth:`register_workloads` — client index -> workload name.
    * :meth:`visit_placed` — one edge-server admission of one visit.
    * :meth:`frame_done` — one processed frame; builds its span tuple.
    * :meth:`migration` — one accepted move (the blackout interval).
    * :meth:`occupancy_sample` / :meth:`wait_sample` /
      :meth:`batch_sample` — slot-server load / imposed queue wait at
      admission / fused-launch batch size.
    * :meth:`count` / :meth:`cache_event` — counter bumps.
    * :meth:`finish_run` — end-of-run rollup from the ``FleetResult``.

    Reporting: :meth:`export_chrome_trace`, :meth:`attribution`,
    :meth:`format_attribution_table`, :meth:`verify_exact`.
    """

    def __init__(self) -> None:
        self.metrics = MetricsRegistry()
        # (client, class, workload, edge, frame_idx, start, fin, spans)
        # per frame, in engine finish-event order
        self.frames: List[
            Tuple[int, str, str, str, int, float, float, Tuple[float, ...]]
        ] = []
        # (client, t0, duration, src_edge, dst_edge) per accepted move
        self.blackouts: List[Tuple[int, float, float, str, str]] = []
        # edge name -> [(t, in_flight at admission)]
        self.occupancy: Dict[str, List[Tuple[float, float]]] = {}
        # edge name -> [(t, queue wait imposed on the admission at t)]
        self.waits: Dict[str, List[Tuple[float, float]]] = {}
        self._client_class: Dict[int, str] = {}
        self._client_workload: Dict[int, str] = {}
        # client -> visits of the in-flight frame:
        # (is_batch, arrived, svc_start, svc_end, solo_service)
        self._pending: Dict[int, List[Tuple[bool, float, float, float, float]]] = {}
        # id(plan) -> (plan, per-plan span bases); plans are interned by
        # the PlanCache so this hits once per distinct plan
        self._plan_base: Dict[int, Tuple[object, Tuple[float, ...]]] = {}

    # -- wiring -------------------------------------------------------------

    def attach(self, cache=None, servers: Iterable = ()) -> None:
        if cache is not None:
            cache.on_event = self.cache_event
        for sv in servers:
            sv.telemetry = self

    def detach(self, cache=None, servers: Iterable = ()) -> None:
        if cache is not None and cache.on_event == self.cache_event:
            cache.on_event = None
        for sv in servers:
            sv.telemetry = None

    def register_clients(self, classes: Dict[int, str]) -> None:
        self._client_class.update(classes)

    def register_workloads(self, workloads: Dict[int, str]) -> None:
        """Client index -> workload (pipeline) name, for per-workload
        attribution; both engines register before the first frame."""
        self._client_workload.update(workloads)

    # -- engine hooks -------------------------------------------------------

    def count(self, name: str, n=1) -> None:
        self.metrics.counter(name).inc(n)

    def cache_event(self, kind: str, n=1) -> None:
        """PlanCache hook target (kind in hit / miss / invalidation)."""
        self.metrics.counter(f"plancache.{kind}").inc(n)

    def occupancy_sample(self, edge: str, t: float, load: float) -> None:
        samples = self.occupancy.get(edge)
        if samples is None:
            samples = self.occupancy[edge] = []
        samples.append((t, load))

    def wait_sample(self, edge: str, t: float, wait: float) -> None:
        """One admission's imposed queue wait at ``edge`` (seconds) —
        the per-edge localization signal the SLO doctor's root-cause
        attributor reads (``repro_torch.cluster.slo``)."""
        samples = self.waits.get(edge)
        if samples is None:
            samples = self.waits[edge] = []
        samples.append((t, wait))

    def batch_sample(self, edge: str, size: int) -> None:
        self.metrics.histogram("batch.size", lo=1.0, growth=2.0, nbuckets=16).observe(
            size
        )
        self.metrics.histogram(
            f"batch.size.{edge}", lo=1.0, growth=2.0, nbuckets=16
        ).observe(size)

    def visit_placed(
        self,
        client: int,
        is_batch: bool,
        arrived: float,
        svc_start: float,
        svc_end: float,
        service: float,
    ) -> None:
        pend = self._pending.get(client)
        if pend is None:
            pend = self._pending[client] = []
        pend.append((is_batch, arrived, svc_start, svc_end, service))

    def migration(
        self, client: int, t0: float, duration: float, src: str, dst: str
    ) -> None:
        self.blackouts.append((client, t0, duration, src, dst))
        self.metrics.counter("migration.moves").inc()
        self.metrics.histogram("migration.blackout_s").observe(duration)

    def _bases(self, plan) -> Tuple[float, ...]:
        """Per-plan span bases (client, uplink, downlink, decode,
        compute, raw_up) from the cost-engine breakdown — cached per
        plan object since plans are cache-interned."""
        key = id(plan)
        hit = self._plan_base.get(key)
        if hit is not None:
            return hit[1]
        bd = dict(plan.breakdown)
        g = bd.get
        base = (
            # client: all home-side work incl. every wrapper cost
            g("compute_home", 0.0)
            + g("encode_home", 0.0)
            + g("decode_home", 0.0)
            + g("wrapper", 0.0),
            g("lat_up", 0.0) + g("wire_up", 0.0),  # uplink (charged)
            g("lat_down", 0.0) + g("wire_down", 0.0),  # downlink (charged)
            g("decode_remote", 0.0) + g("encode_remote", 0.0),  # edge codec
            g("compute_remote", 0.0),  # remote stage compute
            g("raw_bytes_up", 0.0),  # pre-codec uplink bytes
        )
        self._plan_base[key] = (plan, base)
        return base

    def frame_done(
        self,
        client: int,
        frame_idx: int,
        edge: str,
        start: float,
        fin: float,
        plan,
        draws: Tuple[float, ...],
        link_wait: float = 0.0,
    ) -> None:
        """Build the span tuple of one processed frame.

        ``draws`` are the frame's per-leg latency samples in
        ``plan.legs`` order (empty when the plan has no legs); both
        engines pass bit-identical floats, so the resulting spans are
        engine-independent by construction.  ``link_wait`` is the
        frame's shared-medium queue delay (contended cell / backhaul);
        it is attributed to the uplink span — that is where the client
        experiences it — and is 0.0 on private spokes.
        """
        client_b, up_b, down_b, dec_b, comp_b, raw_up = self._bases(plan)
        # jitter deltas: each leg's draw replaces its charged latency
        if draws:
            legs = plan.legs
            down_flags = plan.leg_down
            du = 0.0
            dd = 0.0
            for j, draw in enumerate(draws):
                delta = draw - legs[j].latency
                if legs[j].weight != 1.0:
                    # probabilistic leg: the loop total only felt the
                    # expectation-weighted share of this draw
                    delta = legs[j].weight * delta
                if down_flags[j]:
                    dd += delta
                else:
                    du += delta
            up = up_b + du
            down = down_b + dd
        else:
            up = up_b
            down = down_b
        if link_wait:
            up = up + link_wait
        # queue wait (FIFO, incl. throttle inflation) vs gather dwell +
        # fused-launch inflation (batching edges)
        q_w = 0.0
        g_w = 0.0
        pend = self._pending.pop(client, None)
        if pend:
            for is_batch, arrived, s0, s1, svc in pend:
                w = (s0 - arrived) + (s1 - (s0 + svc))
                if is_batch:
                    g_w += w
                else:
                    q_w += w
        loop = fin - start
        spans = exact_spans((client_b, up, q_w, g_w, dec_b, comp_b, down), loop)
        self.frames.append(
            (
                client,
                self._client_class.get(client, "?"),
                self._client_workload.get(client, "?"),
                edge,
                frame_idx,
                start,
                fin,
                spans,
            )
        )
        m = self.metrics
        m.histogram("frame.loop_s").observe(loop)
        for name, d in zip(SPAN_ORDER, spans):
            m.histogram(f"span.{name}_s").observe(d)
        m.counter("codec.uplink_wire_bytes").inc(plan.uplink_bytes)
        m.counter("codec.uplink_raw_bytes").inc(int(raw_up))

    def finish_run(self, result, rates: Optional[Sequence] = None) -> None:
        """End-of-run rollup: migration decision accounting, re-plan
        scope, codec ladder transitions, per-edge load gauges."""
        m = self.metrics
        mig = result.migration
        if mig is not None:
            m.counter("migration.considered").inc(mig.considered)
            m.counter("migration.rejected_dwell").inc(mig.rejected_dwell)
            m.counter("migration.rejected_threshold").inc(mig.rejected_threshold)
            m.counter("migration.accepted").inc(mig.count)
        replanned = 0
        replans = 0
        for c in result.clients:
            replans += c.replans
            if c.replans:
                replanned += 1
        m.counter("plan.replans").inc(replans)
        m.gauge("drift.clients_replanned").set(replanned)
        if rates:
            switches = 0
            for r in rates:
                if r is None:
                    continue
                switches += r.switches
                for _, old_bits, new_bits in r.transitions:
                    m.counter(f"codec.transition.q{old_bits}->q{new_bits}").inc()
            m.counter("codec.switches").inc(switches)
        for e in result.edges:
            m.gauge(f"edge.peak_load.{e.name}").set(e.peak_load)
            m.gauge(f"edge.busy_s.{e.name}").set(e.busy_time)
            m.gauge(f"edge.admitted.{e.name}").set(e.admitted)
        for lk in getattr(result, "links", ()) or ():
            m.gauge(f"link.busy_s.{lk.name}").set(lk.busy_time)
            m.gauge(f"link.admitted.{lk.name}").set(lk.admitted)
            m.gauge(f"link.contended.{lk.name}").set(lk.contended)
            m.gauge(f"link.total_wait_s.{lk.name}").set(lk.total_wait)

    # -- verification -------------------------------------------------------

    def verify_exact(self) -> int:
        """Assert every frame's span fold equals its loop time exactly;
        returns the number of frames checked."""
        for client, _cls, _wl, _edge, idx, start, fin, spans in self.frames:
            t = 0.0
            for d in spans:
                t += d
            if t != fin - start:
                raise AssertionError(
                    f"span sum {t!r} != loop {fin - start!r} "
                    f"(client {client}, frame {idx})"
                )
        return len(self.frames)

    # -- reporting ----------------------------------------------------------

    def export_chrome_trace(self, path: Optional[str] = None) -> Dict:
        """Chrome trace-event JSON (Perfetto / chrome://tracing).

        One track (tid) per client; each processed frame renders its
        spans as back-to-back complete ("X") events, each accepted
        migration as a ``migration-blackout`` event, and each edge's
        admission-time occupancy as a counter ("C") series.  Times are
        microseconds.  Spans with non-positive width (jitter deltas can
        drive a span slightly negative; "other" is a rounding residual)
        are kept in the data model but skipped for display.
        """
        events: List[Dict] = []
        events.append(
            {"name": "process_name", "ph": "M", "pid": 0, "args": {"name": "fleet"}}
        )
        for c in sorted(self._client_class):
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 0,
                    "tid": c,
                    "args": {"name": f"client {c} ({self._client_class[c]})"},
                }
            )
        for client, _cls, _wl, edge, idx, start, _fin, spans in self.frames:
            ts = start * 1e6
            for name, d in zip(SPAN_ORDER, spans):
                if d > 0.0:
                    events.append(
                        {
                            "name": name,
                            "ph": "X",
                            "ts": ts,
                            "dur": d * 1e6,
                            "pid": 0,
                            "tid": client,
                            "args": {"frame": idx, "edge": edge},
                        }
                    )
                    ts += d * 1e6
        for client, t0, dur, src, dst in self.blackouts:
            events.append(
                {
                    "name": "migration-blackout",
                    "ph": "X",
                    "ts": t0 * 1e6,
                    "dur": dur * 1e6,
                    "pid": 0,
                    "tid": client,
                    "args": {"src": src, "dst": dst},
                }
            )
        for edge in sorted(self.occupancy):
            for t, load in self.occupancy[edge]:
                events.append(
                    {
                        "name": f"occupancy {edge}",
                        "ph": "C",
                        "ts": t * 1e6,
                        "pid": 0,
                        "args": {"in_flight": load},
                    }
                )
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as fh:
                json.dump(doc, fh)
        return doc

    def attribution(self) -> Dict[str, Dict]:
        """Latency attribution per client class and per workload (plus
        ``"all"``).

        For each group: frame count, loop p50/p99, and per span its
        total share of loop time, mean, p50, p99, and its mean over the
        slowest 1% of frames (``tail_mean`` — where did the p99 go?).
        Workload groups are keyed ``wl:<name>`` to keep them disjoint
        from hardware-class labels; a dimension with a single distinct
        value collapses into ``"all"`` (which already tells its story).
        """
        groups: Dict[str, List[Tuple[float, Tuple[float, ...]]]] = {"all": []}
        cls_keys: List[str] = []
        wl_keys: List[str] = []
        for _c, cls, wl, _edge, _idx, start, fin, spans in self.frames:
            rec = (fin - start, spans)
            groups["all"].append(rec)
            if cls not in groups:
                cls_keys.append(cls)
            groups.setdefault(cls, []).append(rec)
            wk = f"wl:{wl}"
            if wk not in groups:
                wl_keys.append(wk)
            groups.setdefault(wk, []).append(rec)
        # a dimension with one distinct value duplicates "all" — drop it
        if len(cls_keys) == 1:
            del groups[cls_keys[0]]
        if len(wl_keys) == 1:
            del groups[wl_keys[0]]
        out: Dict[str, Dict] = {}
        for cls in sorted(groups, key=lambda k: (k != "all", k)):
            recs = groups[cls]
            loops = sorted(r[0] for r in recs)
            loop_total = sum(loops)
            p99 = _pctile(loops, 0.99)
            tail = [r for r in recs if r[0] >= p99] or recs
            spans_out = {}
            for k, name in enumerate(SPAN_ORDER):
                vals = sorted(r[1][k] for r in recs)
                total = sum(vals)
                spans_out[name] = {
                    "total_s": total,
                    "share": total / loop_total if loop_total else 0.0,
                    "mean_ms": 1e3 * total / len(vals) if vals else 0.0,
                    "p50_ms": 1e3 * _pctile(vals, 0.50),
                    "p99_ms": 1e3 * _pctile(vals, 0.99),
                    "tail_mean_ms": 1e3 * sum(r[1][k] for r in tail) / len(tail),
                }
            out[cls] = {
                "frames": len(recs),
                "loop_p50_ms": 1e3 * _pctile(loops, 0.50),
                "loop_p99_ms": 1e3 * p99,
                "spans": spans_out,
            }
        return out

    def format_attribution_table(self) -> str:
        """The reference's ``fleet_bench --trace`` report as a plain-text table."""
        att = self.attribution()
        lines: List[str] = []
        for cls, rep in att.items():
            lines.append(
                f"== latency attribution [{cls}] — {rep['frames']} frames, "
                f"loop p50 {rep['loop_p50_ms']:.3f} ms / "
                f"p99 {rep['loop_p99_ms']:.3f} ms =="
            )
            lines.append(
                f"  {'span':<14}{'share':>8}{'mean_ms':>10}{'p50_ms':>10}"
                f"{'p99_ms':>10}{'tail_ms':>10}"
            )
            for name in SPAN_ORDER:
                s = rep["spans"][name]
                lines.append(
                    f"  {name:<14}{100 * s['share']:>7.2f}%{s['mean_ms']:>10.3f}"
                    f"{s['p50_ms']:>10.3f}{s['p99_ms']:>10.3f}"
                    f"{s['tail_mean_ms']:>10.3f}"
                )
        if self.blackouts:
            durs = [b[2] for b in self.blackouts]
            lines.append(
                f"  migration-blackout: {len(durs)} moves, "
                f"mean {1e3 * sum(durs) / len(durs):.3f} ms "
                f"(inter-frame: delays the next start, outside loop time)"
            )
        return "\n".join(lines)
