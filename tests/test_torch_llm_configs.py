"""The port's LLM configs (``repro_torch.configs``) and edge planner
(``repro_torch.serving.edge``) against the JAX reference's.

Host code: every result is compared with the reference's as plain
values.  ``base``, ``registry``, the ten arch files and ``serving/edge``
are the reference's code (an ``ast`` guard below holds that); ``shapes``
describes inputs as (shape, torch dtype) where the reference uses
``jax.ShapeDtypeStruct``, and its concrete inputs are drawn from numpy as
the reference draws them, so they are equal element for element.
"""

import ast
import dataclasses
import enum
import pathlib

import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs import shapes as jshapes
from repro.core.offload import Policy as JPolicy
from repro.serving import edge as jedge
from repro.sim import hardware as jhardware
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as tregistry
from repro_torch.configs import shapes as tshapes
from repro_torch.core.offload import Policy as TPolicy
from repro_torch.serving import edge as tedge
from repro_torch.sim import hardware as thardware

REPO = pathlib.Path(__file__).resolve().parent.parent
ARCHS = jregistry.list_archs()
COPIED = (["configs/base.py", "configs/registry.py", "serving/edge.py"]
          + [f"configs/{name}.py" for name in (
              "gemma3_4b", "gemma_2b", "mamba2_370m", "minicpm3_4b", "mixtral_8x7b",
              "qwen2_vl_7b", "qwen3_moe_30b_a3b", "seamless_m4t_large_v2",
              "starcoder2_3b", "zamba2_2_7b")])
ENVS = {"edge_tpu": "edge_tpu_environment", "three_tier": "three_tier_environment"}


def plain(x):
    """Dataclasses, enums, dicts and tuples as plain Python values."""
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return tuple(plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    return x


def _configs(arch):
    """(reference, port) configs for an arch name (``-reduced`` allowed)."""
    return jregistry.get(arch), tregistry.get(arch)


def _spec(s):
    """A reference ShapeDtypeStruct or a port TensorSpec as (shape, dtype name)."""
    return tuple(s.shape), str(s.dtype).replace("torch.", "")


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_values_match_reference(arch, reduced):
    jc, tc = _configs(arch + ("-reduced" if reduced else ""))
    assert isinstance(tc, tbase.ArchConfig)
    assert plain(tc) == plain(jc)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert tc.layer_window_sizes() == jc.layer_window_sizes()
    assert tc.supports_long_context() == jc.supports_long_context()
    assert (tc.resolved_head_dim, tc.is_decoder_only) == (jc.resolved_head_dim,
                                                          jc.is_decoder_only)


def test_registry_resolves_the_ports_configs():
    assert tregistry.list_archs() == jregistry.list_archs()
    assert all(m.startswith("repro_torch.configs.") for m in tregistry._MODULES.values())
    assert {k: v.replace("repro_torch.", "repro.", 1) for k, v in tregistry._MODULES.items()} \
        == jregistry._MODULES
    for name, cfg in tregistry.all_configs().items():
        assert type(cfg) is tbase.ArchConfig and type(cfg).__module__ == "repro_torch.configs.base"
        assert tregistry.get(name + "-reduced") == cfg.reduced()
    for bad in ("gpt-5", "gemma-2b-reduced-reduced-x"):
        with pytest.raises(KeyError) as port_err:
            tregistry.get(bad)
        with pytest.raises(KeyError) as ref_err:
            jregistry.get(bad)
        assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_token_inputs_match_reference(arch, reduced):
    jc, tc = _configs(arch + ("-reduced" if reduced else ""))
    assert sorted(tshapes.ALL_SHAPES) == sorted(jshapes.ALL_SHAPES)
    for name, jshape in jshapes.ALL_SHAPES.items():
        tshape = tshapes.ALL_SHAPES[name]
        assert plain(tshape) == plain(jshape)
        assert tshapes.applicable(tc, tshape) == jshapes.applicable(jc, jshape)
        want = {k: _spec(s) for k, s in jshapes.token_inputs(jc, jshape).items()}
        got = {k: _spec(s) for k, s in tshapes.token_inputs(tc, tshape).items()}
        assert got == want, name


@pytest.mark.parametrize("arch", ARCHS)
def test_concrete_token_inputs_equal_reference(arch):
    jc, tc = _configs(arch + "-reduced")
    for name, jshape in jshapes.ALL_SHAPES.items():
        want = jshapes.concrete_token_inputs(jc, jshape, seed=3)
        got = tshapes.concrete_token_inputs(tc, tshapes.ALL_SHAPES[name], seed=3, device="cpu")
        assert sorted(got) == sorted(want)
        for k, arr in want.items():
            t = got[k]
            assert str(t.dtype).replace("torch.", "") == str(arr.dtype), (name, k)
            ref = np.asarray(arr)
            if ref.dtype.name == "bfloat16":
                assert np.array_equal(t.view(torch.int16).numpy(), ref.view(np.int16)), (name, k)
            else:
                assert np.array_equal(t.numpy(), ref), (name, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_edge_plans_match_reference(arch):
    """decode_flops, cache_delta_bytes, build_decode_staged and plan_decode
    (Local/Forced/Auto x both granularities) on both environments."""
    jc, tc = _configs(arch)
    for batch in (1, 8):
        assert tedge.decode_flops(tc, batch) == jedge.decode_flops(jc, batch)
        assert tedge.cache_delta_bytes(tc, batch) == jedge.cache_delta_bytes(jc, batch)
        for groups in (1, 4, 16):
            assert plain(tedge.build_decode_staged(tc, batch, groups)) == plain(
                jedge.build_decode_staged(jc, batch, groups))
    for env_name, factory in ENVS.items():
        jenv, tenv = getattr(jhardware, factory)(), getattr(thardware, factory)()
        for policy in JPolicy:
            for gran in ("single_step", "multi_step"):
                for groups in (4, 16):
                    def outcome(mod, cfg, env, pol):
                        try:
                            return plain(mod.plan_decode(cfg, env, pol, 1, gran, groups))
                        except ValueError as err:
                            return "ValueError", str(err)

                    assert outcome(tedge, tc, tenv, TPolicy(policy.value)) == outcome(
                        jedge, jc, jenv, policy), (env_name, policy, gran, groups)


@pytest.mark.parametrize("env_name", sorted(ENVS))
def test_compare_archs_matches_reference(env_name):
    jenv = getattr(jhardware, ENVS[env_name])()
    tenv = getattr(thardware, ENVS[env_name])()
    for batch in (1, 4):
        want = jedge.compare_archs([jregistry.get(a) for a in ARCHS], jenv, batch)
        got = tedge.compare_archs([tregistry.get(a) for a in ARCHS], tenv, batch)
        assert repr(got) == repr(want)  # NaN rows compare equal as text


# --- the reference's integration checks on the LLM planner, on the port ---


def test_edge_planner_prefers_offload_for_thin_client():
    env = thardware.edge_tpu_environment()
    cfgs = [tregistry.get("gemma-2b"), tregistry.get("mamba2-370m")]
    rows = tedge.compare_archs(cfgs, env)
    for name, row in rows.items():
        assert row["forced"] > row["local"]
        assert row["auto"] >= max(row["forced"], row["local"]) - 1e-9


def test_mla_state_smaller_than_gqa_equivalent():
    mini = tregistry.get("minicpm3-4b")
    gqa_equiv_bytes = mini.num_layers * 2 * mini.num_kv_heads * 64 * 2
    mla_bytes = tedge.cache_delta_bytes(mini, 1)
    assert mla_bytes < gqa_equiv_bytes / 10


def test_decode_staged_llm_structure():
    cfg = tregistry.get("gemma-2b")
    comp = tedge.build_decode_staged(cfg, batch=1)
    comp.validate()
    names = [s.name for s in comp.stages]
    assert names[0] == "embed" and names[-1] == "head_sample"
    fused = comp.fused()
    assert fused.total_flops() == pytest.approx(comp.total_flops())


# --- the copies are the reference's code ---


def _code(path, registry_strings=False):
    """A module's syntax tree without its docstrings, ``repro_torch``
    imports read as ``repro``; with ``registry_strings``, string constants
    naming ``repro_torch.configs`` modules read as ``repro.configs`` too."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.ImportFrom) and node.module.split(".")[0] == "repro_torch":
            node.module = "repro" + node.module[len("repro_torch"):]
        if (registry_strings and isinstance(node, ast.Constant) and isinstance(node.value, str)
                and node.value.startswith("repro_torch.configs.")):
            node.value = "repro" + node.value[len("repro_torch"):]
    return ast.dump(tree)


@pytest.mark.parametrize("path", COPIED)
def test_port_sources_are_the_reference_with_port_imports(path):
    """Each copied module is the reference's code: only docstrings,
    comments, the package of its imports and (in ``registry``) the
    package of the module names it resolves differ."""
    port = REPO / "src" / "repro_torch" / path
    ref = REPO / "src" / "repro" / path
    assert "repro_torch" in port.read_text()
    strings = path == "configs/registry.py"
    assert _code(port, strings) == _code(ref, strings)
