"""The port's fleet (``repro_torch.cluster`` and its example program)
against the JAX reference's (``repro.cluster``).

The fleet is host code in both packages: Python and numpy, a discrete-
event engine (``engine="object"``) and a vectorized one
(``engine="vector"``).  The reference's contract between its two engines
is exact equality, and the port is held to the same contract across
packages: every result is compared with the reference's as plain values
(``plain``; the port's classes are not the reference's, so ``==``
between them is False), with inputs carried over by ``to_port``.

The reference's own engine-equivalence checks run on the port: their
file is loaded with every ``repro`` import (the lazy ones inside its
functions too) rewritten to ``repro_torch``.  ``chip_smoke.py``'s fleet
phase restates the golden configs and runs here on the CPU, with the
CPU's density fit and ``analytic_run``'s frames in place of the card's.
"""

import ast
import gc
import importlib.util
import json
import pathlib
import subprocess
import sys
import types

import pytest

from repro import cluster as jcluster
from repro.cluster import plancache as jplancache
from repro.core.offload import Environment as JEnvironment
from repro.core.offload import Policy as JPolicy
from repro.core.offload import Topology as JTopology
from repro.core.workloads import workload_suite as jworkload_suite
from repro.codec import rate as jrate
from repro.core import wrapper as jwrapper
from repro.net import links as jlinks
from repro.sim import hardware as jhardware
from repro.sim import runtime as jruntime
from repro_torch import cluster as tcluster
from repro_torch.cluster import events as tevents
from repro_torch.cluster import fastfleet as tfastfleet
from repro_torch.cluster import fleet as tfleet
from repro_torch.cluster import plancache as tplancache
from repro_torch.codec import rate as trate
from repro_torch.core.offload import Policy as TPolicy
from repro_torch.core.offload import Topology as TTopology
from repro_torch.core.workloads import workload_suite as tworkload_suite
from repro_torch.examples import edge_offload_serve as tserve
from repro_torch.examples import fleet_sim as tfleet_sim
from repro_torch.sim import clock as tclock
from repro_torch.sim import hardware as thardware
from repro_torch.sim import runtime as truntime
from test_torch_offload import _load_reference_tests, plain, to_port

TESTS = pathlib.Path(__file__).resolve().parent
REPO = TESTS.parent
ENGINES = ("object", "vector")
MODULES = ("__init__", "dispatch", "events", "fastfleet", "fleet", "migration",
           "plancache", "slo", "telemetry")


def _load_on_port(name):
    """A reference test module with every ``repro`` import, at module
    level and inside functions, rewritten to ``repro_torch``: its checks
    then run on the port."""
    path = TESTS / f"{name}.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module.split(".")[0] == "repro":
            node.module = "repro_torch" + node.module[len("repro"):]
        assert not (isinstance(node, ast.Import)
                    and any(a.name.split(".")[0] == "repro" for a in node.names))
    module = types.ModuleType(f"_port_{name}")
    module.__file__ = str(path)
    exec(compile(tree, str(path), "exec"), module.__dict__)
    return module


def _load_path(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF_EQ = _load_reference_tests("test_engine_equivalence")
PORT_EQ = _load_on_port("test_engine_equivalence")
CHIP_SMOKE = _load_path("chip_smoke", REPO / "chip_smoke.py")
GOLDEN = REF_EQ._golden_configs()


def _checks(module):
    """Each test of ``module`` with each of its parametrized values."""
    out = []
    for name in sorted(n for n in vars(module) if n.startswith("test_")):
        marks = [m for m in getattr(vars(module)[name], "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            out.append(pytest.param(name, {}, id=name))
            continue
        (mark,) = marks
        argname, values = mark.args
        out += [pytest.param(name, {argname: v}, id=f"{name}[{v}]") for v in values]
    return out


CHECKS = _checks(REF_EQ)


def _outcome(res):
    """A fleet result as plain values on every field the reference's
    ``_assert_equivalent`` compares (the vector engine's lazy
    ``ArrayLoopStats`` materialized by reading ``processed``)."""
    mig = res.migration
    return plain((
        res.events, res.duration,
        [(c.edge, c.replans, c.migrations, c.total_wait, c.rate_changes,
          c.stats.processed, c.stats.duration, c.codec) for c in res.clients],
        res.edges, res.links,
        (res.cache.stats.hits, res.cache.stats.misses, res.cache.stats.invalidations),
        None if mig is None else (
            mig.count, mig.considered, mig.rejected_dwell, mig.rejected_threshold,
            [(r.client, r.src, r.dst, r.time) for r in mig.records]),
    ))


_REF_RUNS = {}


def _reference(name):
    """The reference's object engine on golden config ``name`` (run once)."""
    if name not in _REF_RUNS:
        _REF_RUNS[name] = jcluster.run_fleet(engine="object", cache=jcluster.PlanCache(),
                                             **GOLDEN[name])
    return _REF_RUNS[name]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_config_matches_reference(name, engine):
    """Each port engine on each of the reference's 13 golden configs,
    carried over with ``to_port``, equals the reference's object engine."""
    kw = to_port(GOLDEN[name])
    assert type(kw["topo"]) is TTopology
    port = tcluster.run_fleet(engine=engine, cache=tcluster.PlanCache(), **kw)
    assert type(port.clients[0].stats) is (tclock.LoopStats if engine == "object"
                                           else tfastfleet.ArrayLoopStats)
    ref = _reference(name)
    assert port.events > 0
    assert _outcome(port) == _outcome(ref)


def test_reference_checks_are_rebound_to_the_port():
    """The reference's engine-equivalence file, loaded on the port, holds
    the port's classes and functions, its golden configs the port's
    objects, and picks up all 10 of its checks."""
    assert len({p.values[0] for p in CHECKS}) == 10
    assert len(CHECKS) == 10 + 2 * (len(GOLDEN) - 1)
    port = {"run_fleet": tcluster.run_fleet, "PlanCache": tcluster.PlanCache,
            "hardware": thardware, "crate": trate, "MigrationConfig": tcluster.MigrationConfig,
            "AdaptiveWindow": tevents.AdaptiveWindow, "LinkDrift": tfleet.LinkDrift,
            "ServiceDrift": tfleet.ServiceDrift, "ArrayLoopStats": tfastfleet.ArrayLoopStats,
            "FrameEvent": tclock.FrameEvent, "workload_suite": tworkload_suite}
    for name, value in port.items():
        assert getattr(PORT_EQ, name) is value, name
    configs = PORT_EQ._golden_configs()
    assert sorted(configs) == sorted(GOLDEN)
    assert type(configs["contended"]["topo"]) is TTopology
    assert type(configs["codec"]["codec"]) is trate.CodecConfig
    assert plain(configs) == plain(GOLDEN)
    kw = PORT_EQ._doctor_kwargs()
    assert kw["policy"] is TPolicy.AUTO and type(kw["codec"]) is trate.CodecConfig


@pytest.mark.parametrize("check,kwargs", CHECKS)
def test_reference_engine_checks_hold_on_the_port(check, kwargs):
    """tests/test_engine_equivalence.py's checks, each run on the port at
    the reference's own hypothesis settings."""
    getattr(PORT_EQ, check)(**kwargs)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("granularity", ["single_step", "multi_step"])
@pytest.mark.parametrize("net", ["gigabit_ethernet", "wifi_802.11"])
def test_single_client_matches_analytic_run_bit_for_bit(net, granularity, seed):
    """tests/test_cluster.py's golden limit on the port: one client
    against a capacity-1 edge that is the paper's server equals the
    port's ``analytic_run`` (plan, processed events, duration), and both
    equal the reference's as plain values."""
    def run(hw, links, wrapper, offload_env, topology, policy, cluster, runtime):
        comp, tiers = hw.paper_staged(), hw.paper_tiers()
        link = links.ALL_LINKS[net]
        env = offload_env(client=tiers["laptop"], server=tiers["server"], link=link,
                          wrapper=wrapper.paper_wrapper())
        star = topology.star(("client", tiers["laptop"]), [("server", tiers["server"], link)],
                             wrapper=wrapper.paper_wrapper())
        ref = runtime.analytic_run(comp, env, policy.AUTO, granularity, num_frames=300,
                                   seed=seed)
        (point,) = cluster.capacity_sweep(star, comp, client_counts=(1,), num_frames=300,
                                          policy=policy.AUTO, granularity=granularity,
                                          seed=seed)
        c = point.result.clients[0]
        assert c.plan == ref.plan
        assert c.stats.processed == ref.stats.processed
        assert (c.stats.duration, c.stats.dropped) == (ref.stats.duration, ref.stats.dropped)
        assert c.total_wait == 0.0
        return plain((c.plan, c.stats.processed, c.stats.duration, c.stats.dropped))

    from repro_torch.core import wrapper as twrapper
    from repro_torch.core.offload import Environment as TEnvironment
    from repro_torch.net import links as tlinks

    port = run(thardware, tlinks, twrapper, TEnvironment, TTopology, TPolicy, tcluster,
               truntime)
    ref = run(jhardware, jlinks, jwrapper, JEnvironment, JTopology, JPolicy, jcluster,
              jruntime)
    assert port == ref


@pytest.mark.parametrize("engine", ENGINES)
def test_telemetry_trace_and_attribution_match_reference(engine):
    """The ``codec`` golden config with telemetry armed: the Chrome trace
    document and the latency attribution equal the reference's byte for
    byte."""
    ref_tel, port_tel = jcluster.Telemetry(), tcluster.Telemetry()
    jcluster.run_fleet(engine="object", cache=jcluster.PlanCache(), telemetry=ref_tel,
                       **GOLDEN["codec"])
    tcluster.run_fleet(engine=engine, cache=tcluster.PlanCache(), telemetry=port_tel,
                       **to_port(GOLDEN["codec"]))
    assert port_tel.verify_exact() == ref_tel.verify_exact() > 0

    def dumps(doc):
        return json.dumps(doc, sort_keys=True)

    assert dumps(port_tel.export_chrome_trace()) == dumps(ref_tel.export_chrome_trace())
    assert dumps(port_tel.attribution()) == dumps(ref_tel.attribution())
    assert port_tel.format_attribution_table() == ref_tel.format_attribution_table()


def _doctor(cluster, hw, rate, policy, workload_suite, fault, engine):
    """tests/test_slo.py's doctor run at its CI size (160 frames) with
    ``fault`` injected, migration as the reference's benchmark arms it."""
    spec = cluster.FAULTS[fault]
    topo, classes = hw.doctor_star()
    mon = cluster.SLOMonitor(classes=cluster.DOCTOR_CLASSES)
    cluster.run_fleet(
        topo, hw.paper_staged(), num_clients=8, num_frames=160, dispatch="least_queue",
        policy=policy.AUTO, granularity="multi_step", client_classes=classes,
        workloads=workload_suite(),
        codec=rate.CodecConfig(base=hw.codec_point(entropy=True),
                               motion=rate.sequence_motion(), resync_bound=4),
        camera_fps=12, gather_window=2e-3, drifts=list(spec.drifts), slo=mon,
        migration=None if spec.disable_migration else (spec.migration
                                                       or cluster.MigrationConfig()),
        engine=engine, cache=cluster.PlanCache())
    return (json.dumps(plain(mon.incidents)), json.dumps(plain(cluster.doctor_verdict(mon))),
            mon.summary_json(), mon.format_incident_report())


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("fault", sorted(jcluster.FAULTS))
def test_doctor_matches_reference(fault, engine):
    """Every fault of the catalog on the doctor star at 160 frames: the
    incidents (open and close times, misses, causes), the verdict, the
    JSON rollup and the report equal the reference's byte for byte."""
    assert sorted(tcluster.FAULTS) == sorted(jcluster.FAULTS)
    ref = _doctor(jcluster, jhardware, jrate, JPolicy, jworkload_suite, fault, "object")
    port = _doctor(tcluster, thardware, trate, TPolicy, tworkload_suite, fault, engine)
    assert port == ref
    if fault == "edge_throttle":  # tests/test_slo.py's slice: one incident, named
        assert json.loads(port[1])[0] == "queueing@edge_1"


def test_capacity_sweep_matches_reference():
    """``capacity_sweep`` on a 2 x 4 star at 1, 2, 4 and 8 clients, 60
    frames: fps, drop rate, p99 and plan-cache hit rate equal."""
    def sweep(cluster, hw):
        points = cluster.capacity_sweep(hw.fleet_star(num_edges=2, edge_capacity=4),
                                        hw.paper_staged(), (1, 2, 4, 8), num_frames=60)
        return [(p.num_clients, p.fps, p.drop_rate, p.p99, p.result.cache.stats.hit_rate,
                 _outcome(p.result)) for p in points]

    assert sweep(tcluster, thardware) == sweep(jcluster, jhardware)


@pytest.mark.parametrize("engine", ENGINES)
def test_migration_stats_match_reference(engine):
    """The ``migration`` golden config's ``MigrationStats``, records with
    their state bytes and latencies included, equal the reference's."""
    port = tcluster.run_fleet(engine=engine, cache=tcluster.PlanCache(),
                              **to_port(GOLDEN["migration"]))
    ref = _reference("migration")
    assert ref.migration.count > 0
    assert plain(port.migration) == plain(ref.migration)


def test_fleet_sim_example_matches_reference(tmp_path, monkeypatch, capsys):
    """The reference's examples/fleet_sim.py and the port's
    ``repro_torch.examples.fleet_sim``, each in its own working
    directory: the same stdout, line for line, and the same trace file."""
    ref_sim = _load_path("_ref_fleet_sim", REPO / "examples" / "fleet_sim.py")
    out = {}
    for label, main in (("ref", ref_sim.main), ("port", tfleet_sim.main)):
        (tmp_path / label).mkdir()
        monkeypatch.chdir(tmp_path / label)
        main()
        out[label] = capsys.readouterr().out.splitlines()
    assert len(out["port"]) > 50
    assert out["port"] == out["ref"]
    trace = [(tmp_path / label / "fleet_trace.json").read_bytes() for label in out]
    assert trace[0] == trace[1]


def _code(path):
    """A module's syntax tree without its docstrings, ``repro_torch``
    imports read as ``repro``."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.ImportFrom) and node.module.split(".")[0] == "repro_torch":
            node.module = "repro" + node.module[len("repro_torch"):]
    return ast.dump(tree)


@pytest.mark.parametrize("path", [f"cluster/{m}.py" for m in MODULES] + ["fleet_sim.py"])
def test_port_sources_are_the_reference_with_port_imports(path):
    """Each cluster module, and the example, is the reference's code: only
    docstrings, comments and the package of its imports differ."""
    port = REPO / "src" / "repro_torch" / ("examples/" + path if path == "fleet_sim.py"
                                            else path)
    ref = REPO / ("examples/fleet_sim.py" if path == "fleet_sim.py" else "src/repro/" + path)
    assert "repro_torch" in port.read_text()
    assert _code(port) == _code(ref)


def test_package_state_stays_in_its_package():
    """The two packages in one process: the vector engine restores the
    process's garbage collector, and each plan cache's signature memo
    holds only its own package's computations."""
    kw = GOLDEN["mixed"]
    for enabled in (True, False):
        (gc.enable if enabled else gc.disable)()
        try:
            jcluster.run_fleet(engine="vector", cache=jcluster.PlanCache(), **kw)
            assert gc.isenabled() is enabled
            tcluster.run_fleet(engine="vector", cache=tcluster.PlanCache(), **to_port(kw))
            assert gc.isenabled() is enabled
        finally:
            gc.enable()
    assert jplancache._SIG_MEMO is not tplancache._SIG_MEMO
    for memo, package in ((jplancache._SIG_MEMO, "repro."), (tplancache._SIG_MEMO,
                                                               "repro_torch.")):
        live = [ref() for ref, _ in memo.values() if ref() is not None]
        assert live and all(type(c).__module__.startswith(package) for c in live)


def test_vector_engine_runs_without_the_reference():
    """A fresh interpreter runs the port's fleet on both engines (the
    vector engine's lazy import included) and loads neither JAX nor the
    reference package."""
    code = ("import sys\n"
            "from repro_torch.cluster import PlanCache, run_fleet\n"
            "from repro_torch.sim import hardware\n"
            "topo = hardware.fleet_star(num_edges=2, edge_capacity=2)\n"
            "runs = [run_fleet(topo, hardware.paper_staged(), num_clients=3, num_frames=10,\n"
            "                  engine=e, cache=PlanCache()).events for e in ('object', 'vector')]\n"
            "assert runs[0] == runs[1] > 0, runs\n"
            "assert 'repro_torch.cluster.fastfleet' in sys.modules\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO / "src",
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_chip_smoke_restates_the_golden_configs():
    """chip_smoke.py's restatement of the golden configs equals the
    reference's, so the card's check and this file's cannot drift apart;
    its outcome function reads the same fields as this file's."""
    restated = CHIP_SMOKE.fleet_golden_configs()
    assert sorted(restated) == sorted(GOLDEN)
    assert plain(restated) == plain(GOLDEN)
    res = tcluster.run_fleet(cache=tcluster.PlanCache(), **restated["everything"])
    assert plain(CHIP_SMOKE.fleet_outcome(res)) == _outcome(res)


def test_chip_smoke_fleet_phase_on_the_cpu(capsys):
    """chip_smoke.py's fleet phase, run here with the CPU's density fit in
    place of the card's and ``analytic_run``'s frames in place of the ones
    ``executed_run`` tracks on the card (which equal them: the card's
    phase 15 checks it)."""
    fit = trate.calibrate_density_map(device="cpu")
    comp = thardware.paper_staged()
    executed = {
        name: [e.index for e in truntime.analytic_run(
            comp, env, policy, gran, CHIP_SMOKE.GRID_FRAMES, seed=0).stats.processed]
        for name, env, policy, gran in tserve.deployments()}
    CHIP_SMOKE.phase_fleet(fit, fit, executed, "this CPU")
    log = capsys.readouterr().out
    assert "120 frames, 39072 events" in log
    assert log.count("object == vector") == 3 + len(GOLDEN)
    assert log.count("= executed_run's on this CPU") == len(executed) == 12
