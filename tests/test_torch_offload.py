"""The port's offload layer (cost engine, planners, offload front end,
workloads, links, transport, paper tiers) against the JAX reference.

The layer is deterministic Python arithmetic, so everything is held
equal exactly: each port object is compared with the reference's as
plain values (fields in order, as ``dataclasses.astuple``: the port's
classes are not the reference's, so ``==`` between them is False).  Inputs built by the
reference's own test helpers are carried over with ``to_port``.
"""

import dataclasses
import importlib
import importlib.util
import inspect
import pathlib
import random
import types

import numpy as np
import pytest
import torch

from repro.core import offload as joffload
from repro.core.costengine import CostEngine as JCostEngine
from repro.core import planners as jplanners
from repro.core import workloads as jworkloads
from repro.net import links as jlinks
from repro.net import transport as jtransport
from repro.sim import hardware as jhardware
from repro_torch.core import offload as toffload
from repro_torch.core import planners as tplanners
from repro_torch.core import workloads as tworkloads
from repro_torch.core.costengine import CostEngine as TCostEngine
from repro_torch.examples import edge_offload_serve as tserve
from repro_torch.net import links as tlinks
from repro_torch.net import transport as ttransport
from repro_torch.sim import hardware as thardware
from repro_torch.sim import runtime as truntime

TESTS = pathlib.Path(__file__).resolve().parent
POLICIES = ("local", "forced", "auto")
GRANULARITIES = ("single_step", "multi_step")


def _load_reference_tests(name):
    """A reference test module loaded under a private name, for its
    helpers and checks (pytest does not collect it twice)."""
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", TESTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF_PLANNER_TESTS = _load_reference_tests("test_planners_dag")
REF_CLAIMS = _load_reference_tests("test_paper_claims")
CLAIMS = sorted(n for n in vars(REF_CLAIMS) if n.startswith("test_"))


def plain(x):
    """Dataclasses, dicts and tuples as plain Python values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return tuple(plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    return x


def to_port(x):
    """A reference object rebuilt from the port's classes of the same name."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = type(x)
        module = importlib.import_module(cls.__module__.replace("repro.", "repro_torch.", 1))
        return getattr(module, cls.__name__)(**{f.name: to_port(getattr(x, f.name))
                                                for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {to_port(k): to_port(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(v) for v in x)
    return x


def outcome(fn, *args):
    """``plain(fn(*args))``, or the error it raises as (type name, message)."""
    try:
        return plain(fn(*args))
    except ValueError as err:
        return type(err).__name__, str(err)


def _environments(hw):
    return {
        "ethernet_wrapped": hw.paper_environment("gigabit_ethernet", True),
        "ethernet_native": hw.paper_environment("gigabit_ethernet", False),
        "wifi_wrapped": hw.paper_environment("wifi_802.11", True),
        "wifi_native": hw.paper_environment("wifi_802.11", False),
        "edge_tpu": hw.edge_tpu_environment(),
        "three_tier": hw.three_tier_environment(),
    }


ENVIRONMENTS = tuple(_environments(jhardware))


def _comp(hw, workload):
    if workload == "paper":
        return hw.paper_staged()
    registry = jworkloads if hw is jhardware else tworkloads
    return registry.WORKLOADS[workload]()


@pytest.mark.parametrize("workload", ("paper",) + tuple(jworkloads.WORKLOADS))
@pytest.mark.parametrize("env", ENVIRONMENTS)
def test_plans_match_reference(env, workload):
    """Every Policy x granularity on every environment, for the paper's
    tracker and every registry workload: equal PlanReports (and the same
    error where the reference refuses: a native environment cannot
    offload)."""
    j_env, t_env = _environments(jhardware)[env], _environments(thardware)[env]
    j_comp, t_comp = _comp(jhardware, workload), _comp(thardware, workload)
    assert plain(t_comp) == plain(j_comp)
    refused = set()
    for gran in GRANULARITIES:
        jc = j_comp.fused() if gran == "single_step" else j_comp
        tc = t_comp.fused() if gran == "single_step" else t_comp
        for policy in POLICIES:
            want = outcome(joffload.plan, jc, j_env, joffload.Policy(policy))
            got = outcome(toffload.plan, tc, t_env, toffload.Policy(policy))
            assert got == want, (gran, policy)
            if got[0] == "ValueError":
                refused.add(policy)
    assert refused == ({"forced"} if env.endswith("native") else set())
    for policy in POLICIES:
        assert (outcome(toffload.compare_granularities, t_comp, t_env, toffload.Policy(policy))
                == outcome(joffload.compare_granularities, j_comp, j_env,
                           joffload.Policy(policy)))


@pytest.mark.parametrize("env,policy,gran", [
    ("wifi_wrapped", "forced", "multi_step"), ("ethernet_wrapped", "auto", "single_step"),
    ("three_tier", "forced", "multi_step"), ("edge_tpu", "forced", "single_step")])
def test_jittered_totals_match_reference(env, policy, gran):
    j_comp, t_comp = jhardware.paper_staged(), thardware.paper_staged()
    if gran == "single_step":
        j_comp, t_comp = j_comp.fused(), t_comp.fused()
    want = joffload.plan(j_comp, _environments(jhardware)[env], joffload.Policy(policy))
    got = toffload.plan(t_comp, _environments(thardware)[env], toffload.Policy(policy))
    assert got.legs
    j_rng, t_rng = np.random.default_rng(7), np.random.default_rng(7)
    assert ([got.jittered_total(t_rng) for _ in range(64)]
            == [want.jittered_total(j_rng) for _ in range(64)])


@pytest.mark.parametrize("seed", range(6))
def test_planners_match_reference_on_random_graphs(seed):
    """Each planner on the reference's random out-trees and chains
    (``tests/test_planners_dag.py``'s helpers) and on the registry's
    true DAG: equal reports, and the same AUTO choice."""
    ref = REF_PLANNER_TESTS
    rnd = random.Random(seed)
    k, n = ref._case_dims(rnd)
    shape = rnd.choice(("chain", "star"))
    topo = ref._rand_topology(k, rnd, shape)
    cases = [(ref._tree_comp(n, rnd), ("exhaustive", "single_crossing", "tree_dp")),
             (ref._chain_comp(n, rnd, shared_source=seed % 2 == 1),
              ("exhaustive", "single_crossing", "chain_dp")),
             (jworkloads.rgbd_tracking(), ("exhaustive", "single_crossing", "tree_dp"))]
    j_engine, t_engine = JCostEngine(topo), TCostEngine(to_port(topo))
    for comp, names in cases:
        t_comp = to_port(comp)
        assert plain(t_comp) == plain(comp)
        for name in names:
            want = jplanners.PLANNERS[name].plan(comp, j_engine)
            got = tplanners.PLANNERS[name].plan(t_comp, t_engine)
            assert plain(got) == plain(want), name
        for cap in (16, 2**20):
            assert (type(tplanners.auto_planner(t_comp, t_engine, cap)).__name__
                    == type(jplanners.auto_planner(comp, j_engine, cap)).__name__)


def test_tiers_links_and_models_match_reference():
    assert plain(thardware.paper_tiers()) == plain(jhardware.paper_tiers())
    assert plain(thardware.CLIENT_CLASSES) == plain(jhardware.CLIENT_CLASSES)
    for name in ("TPU_V5E", "THIN_CLIENT_NO_GPU", "EDGE_GPU", "PAPER_FRAME_BYTES",
                 "SINGLE_STREAM_UTIL", "CLIENT_MEM_BW", "SERVER_NATIVE_FPS",
                 "LAPTOP_NATIVE_FPS"):
        assert plain(getattr(thardware, name)) == plain(getattr(jhardware, name)), name
    assert plain(tlinks.ALL_LINKS) == plain(jlinks.ALL_LINKS)
    assert plain(thardware.paper_wrapper()) == plain(jhardware.paper_wrapper())
    assert plain(thardware.mixed_workloads()) == plain(jhardware.mixed_workloads())
    assert plain(thardware.edge_batch_model()) == plain(jhardware.edge_batch_model())
    assert plain(thardware.edge_batch_model(thardware.LAPTOP_IGPU, thardware.paper_staged())) \
        == plain(jhardware.edge_batch_model(jhardware.LAPTOP_IGPU, jhardware.paper_staged()))


@pytest.mark.parametrize("entropy", [False, True])
@pytest.mark.parametrize("kwargs", [
    {}, dict(quant_bits=16, keyframe_interval=4, change_density=0.05),
    dict(quant_bits=4, change_density=0.6, client_tier="PHONE_NPU", edge_tier="TPU_V5E")])
def test_codec_point_matches_reference(kwargs, entropy):
    def point(hw):
        kw = {k: getattr(hw, v) if k.endswith("_tier") else v for k, v in kwargs.items()}
        return hw.codec_point(entropy=entropy, **kw)

    got, want = point(thardware), point(jhardware)
    assert plain(got) == plain(want)
    assert got.ratio == want.ratio and got.wire_nbytes(537_600) == want.wire_nbytes(537_600)


@pytest.mark.parametrize("make,kwargs", [
    ("fleet_star", {}), ("fleet_star", dict(num_edges=3, batching=True)),
    ("shared_cell_star", {}), ("shared_cell_star", dict(batching=True, cell_capacity=0)),
    ("hetero_fleet_star", dict(num_edges=8)), ("doctor_star", {}),
    ("hotspot_star", {}), ("hotspot_star", dict(weak_factor=3.0, batching=True)),
    ("three_tier_environment", {})])
def test_topologies_match_reference(make, kwargs):
    got, want = getattr(thardware, make)(**kwargs), getattr(jhardware, make)(**kwargs)
    assert plain(got) == plain(want)
    topo = got[0] if isinstance(got, tuple) else got
    ref = want[0] if isinstance(want, tuple) else want
    for policy in POLICIES:
        assert plain(toffload.plan(thardware.paper_staged().fused(), topo,
                                   toffload.Policy(policy))) == plain(
            joffload.plan(jhardware.paper_staged().fused(), ref, joffload.Policy(policy)))


def test_transport_matches_reference():
    """Envelope and payload times and byte accounting, on numpy trees in
    the reference and the same trees as tensors in the port."""
    rng = np.random.default_rng(3)
    tree = {"depth": rng.normal(size=(240, 320)).astype(np.float32),
            "h": [np.zeros(27, np.float32), (np.ones(4, np.int64), 2.0)], "none": None}
    as_tensors = {"depth": torch.from_numpy(tree["depth"]),
                  "h": [torch.zeros(27), (torch.ones(4, dtype=torch.int64), 2.0)],
                  "none": None}
    for link in ("gigabit_ethernet", "wifi_802.11", "5g_edge"):
        for wrapped in (False, True):
            j = jtransport.Transport(jlinks.ALL_LINKS[link],
                                     jhardware.paper_wrapper() if wrapped else None, seed=5)
            t = ttransport.Transport(tlinks.ALL_LINKS[link],
                                     thardware.paper_wrapper() if wrapped else None, seed=5)
            for direction in ("up", "down"):
                assert t.payload_time(as_tensors, direction) == j.payload_time(tree, direction)
                assert t.rpc_envelope_time() == j.rpc_envelope_time()
            assert plain(t.log) == plain(j.log)
            assert (t.total_bytes, t.total_seconds) == (j.total_bytes, j.total_seconds)


@pytest.fixture(scope="module")
def port_claims():
    return tserve.paper_claims()


@pytest.mark.parametrize("claim", CLAIMS)
def test_paper_claims_hold_on_the_port(claim, port_claims):
    """The reference's tests/test_paper_claims.py, each check run with its
    module's ``offload``, ``Policy``, ``hardware`` and ``runtime`` bound to
    the port's; and the port's own ``paper_claims`` entry of that name."""
    assert len(CLAIMS) == 12
    env = dict(vars(REF_CLAIMS), offload=toffload, Policy=toffload.Policy,
               hardware=thardware, runtime=truntime)
    for name, value in vars(REF_CLAIMS).items():
        if inspect.isfunction(value) and value.__module__ == REF_CLAIMS.__name__:
            env[name] = types.FunctionType(value.__code__, env, name,
                                           value.__defaults__, value.__closure__)
    fixtures = {"comp": thardware.paper_staged, "tiers": thardware.paper_tiers}
    check = env[claim]
    check(**{p: fixtures[p]() for p in inspect.signature(check).parameters})
    assert port_claims[claim.removeprefix("test_")] is True
