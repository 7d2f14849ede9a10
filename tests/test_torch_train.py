"""The port's training path (``repro_torch.data.tokens``, ``optim.adamw``,
``launch.train`` and ``examples.train_lm``) against the reference's, on
the CPU.

Held:

* the token batches equal to the reference's bit for bit (the module is
  a copy: an ``ast`` guard holds that it differs only in docstrings);
* ``adamw.init``'s shapes and dtypes; ``global_norm`` and ``update`` over
  5 steps fed the reference's gradients, on float32 reduced gemma-2b and
  on a bfloat16 cast of it: moments (and float32 parameters) within 1e-6
  of the leaf's largest value, the step equal.  A float32 difference of
  1e-6 relative before the cast to bfloat16 crosses a rounding point of
  bfloat16 on at most 2e-6 * 2**8 of the elements a step, and then moves
  the element by one bfloat16 ulp: bfloat16 parameters are held to that;
* ``cosine_schedule`` within one float32 ulp;
* ``build_train_step`` against the reference's jitted one over 3 steps
  from the same parameters, and one step from a state at step 100;
* ``tests/test_integration.py``'s ``test_training_reduces_loss`` and
  ``test_token_pipeline_deterministic`` on the port; ``train.main``'s
  and ``train_lm``'s flags.
"""

import ast
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data import tokens as jtokens
from repro.launch import train as jtrain
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import io as tckpt
from repro_torch.data import tokens as ttokens
from repro_torch.examples import train_lm
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw as tadamw
from test_models_smoke import _batch
from test_torch_llm_configs import _code, plain
from test_torch_models import reference_params, to_numpy, to_torch

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-6  # AdamW on the same gradients
STEP_TOL = 1e-5  # the train step, whose gradients are held to 1e-5 (test_torch_grads.py)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several workers on a
    few cores, where torch's default of one thread a core makes them
    contend (the 40-step training run then takes minutes, not seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _leaves(tree):
    """{path: float64 numpy} of a port tree or of a reference tree."""
    pairs = ttf.tree_leaves(tree)
    if isinstance(pairs[0][1], torch.Tensor):
        return {p: t.detach().double().numpy() for p, t in pairs}
    return {p: np.asarray(jnp.asarray(a, jnp.float32), np.float64) for p, a in pairs}


def _worst(got, want):
    """The largest |got - want| over a leaf, over that leaf's largest |want|."""
    out = 0.0
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        out = max(out, np.abs(got[path] - w).max() / max(np.abs(w).max(), 1e-30))
    return out


# --- data/tokens ---


@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 32, 2, 0), (8192, 64, 4, 3)])
def test_token_batches_equal_reference(vocab, seq, batch, seed):
    jpipe = iter(jtokens.TokenPipeline(jtokens.TokenPipelineConfig(vocab, seq, batch, seed)))
    tpipe = iter(ttokens.TokenPipeline(ttokens.TokenPipelineConfig(vocab, seq, batch, seed)))
    for _ in range(3):
        want, got = next(jpipe), next(tpipe)
        assert sorted(got) == sorted(want) == ["loss_mask", "targets", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("path", ["data/tokens.py", "data/__init__.py"])
def test_token_module_is_the_reference_with_port_imports(path):
    assert _code(REPO / "src" / "repro_torch" / path) == _code(REPO / "src" / "repro" / path)


def test_token_pipeline_deterministic():
    cfg = ttokens.TokenPipelineConfig(vocab_size=512, seq_len=32, global_batch=2)
    a = next(iter(ttokens.TokenPipeline(cfg)))
    b = next(iter(ttokens.TokenPipeline(cfg)))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (2, 32)
    assert a["targets"].shape == (2, 32)


# --- optim/adamw ---


def test_adamw_config_and_state_match_reference():
    assert plain(tadamw.AdamWConfig()) == plain(jadamw.AdamWConfig())
    assert tadamw.AdamWState._fields == jadamw.AdamWState._fields


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_init_shapes_and_dtypes(dtype):
    _, tcfg, jp, tp = reference_params("gemma-2b-reduced")
    tp = ttf.tree_map(lambda t: t.to(getattr(torch, dtype)), tp)
    jp = jax.tree_util.tree_map(lambda a: a.astype(dtype), jp)
    want, got = jadamw.init(jp), tadamw.init(tp)
    assert got.step.dtype == torch.int32 and got.step.shape == () and int(got.step) == 0
    assert str(want.step.dtype) == "int32"
    for tree_t, tree_j in ((got.mu, want.mu), (got.nu, want.nu)):
        jl = dict(ttf.tree_leaves(to_numpy(tree_j)))
        tl = dict(ttf.tree_leaves(tree_t))
        assert sorted(tl) == sorted(jl)
        for path, t in tl.items():
            assert t.dtype == torch.float32 and str(jl[path].dtype) == "float32"
            assert tuple(t.shape) == jl[path].shape and not t.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """5 steps at lr_scale 1 on the reference's gradients at its own
    parameters (each step's gradients given to both optimizers)."""
    jcfg, _, jp, tp = reference_params("gemma-2b-reduced")
    tdtype = getattr(torch, dtype)
    jp = jax.tree_util.tree_map(lambda a: a.astype(dtype), jp)
    tp = ttf.tree_map(lambda t: t.to(tdtype), tp)
    batch = _batch(jcfg)
    grad_fn = jax.jit(jax.grad(lambda p: jtf.loss_fn(jcfg, p, batch)[0]))
    update = jax.jit(lambda g, s, p: jadamw.update(jadamw.AdamWConfig(), g, s, p))
    js, ts = jadamw.init(jp), tadamw.init(tp)
    for _ in range(5):
        g = grad_fn(jp)
        tg = ttf.tree_map(lambda a: to_torch(np.asarray(a, np.float32)).to(tdtype), to_numpy(
            jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), g)))
        assert abs(float(tadamw.global_norm(tg)) - float(jadamw.global_norm(g))) < (
            TOL * float(jadamw.global_norm(g)))
        jp, js, jm = update(g, js, jp)
        tp, ts, tm = tadamw.update(tadamw.AdamWConfig(), tg, ts, tp)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) < TOL * float(jm["grad_norm"])
    assert int(ts.step) == int(js.step) == 5 and ts.step.dtype == torch.int32
    assert _worst(_leaves(ts.mu), _leaves(js.mu)) < TOL
    assert _worst(_leaves(ts.nu), _leaves(js.nu)) < TOL
    got, want = _leaves(tp), _leaves(jp)
    for path, t in ttf.tree_leaves(tp):
        assert t.dtype == tdtype, path
    if dtype == "float32":
        assert _worst(got, want) < TOL
        return
    for path, w in want.items():
        g = got[path]
        differ = g != w
        # a step's flip moves an element one bfloat16 ulp (8 significand
        # bits, at the larger of the two values); 5 steps at most 5
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(g), np.abs(w)))) - 7)
        assert (np.abs(g - w)[differ] <= 5 * ulp[differ]).all(), path
        assert differ.mean() <= 5 * 2 * TOL * 2 ** 8, path


@pytest.mark.parametrize("base_steps", [300, 40])
def test_cosine_schedule_matches_reference(base_steps):
    want_fn, got_fn = jadamw.cosine_schedule(base_steps), tadamw.cosine_schedule(base_steps)
    for step in (0, 1, 50, 99, 100, 101, base_steps - 1):
        want = np.float32(want_fn(jnp.int32(step)))
        got = got_fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= np.spacing(np.abs(want)), step
    assert float(got_fn(torch.tensor(0, dtype=torch.int32))) == 0.0


# --- launch/train ---


def _pipe(cfg, seq=32, batch=2):
    return ttokens.TokenPipeline(ttokens.TokenPipelineConfig(cfg.vocab_size, seq, batch))


def _check_state(tp, ts, tm, jp, js, jm, jinit):
    for key in ("loss", "ce_loss", "aux_loss"):
        assert abs(float(tm[key]) - float(jm[key])) < STEP_TOL, key
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) < STEP_TOL * float(jm["grad_norm"])
    assert sorted(tm) == sorted(jm)
    assert int(ts.step) == int(js.step)
    assert _worst(_leaves(ts.mu), _leaves(js.mu)) < STEP_TOL
    # nu sums squares of gradients held to STEP_TOL
    assert _worst(_leaves(ts.nu), _leaves(js.nu)) < 2 * STEP_TOL
    # An Adam step is m/sqrt(v), +-1 on the first step whatever the
    # gradient's size, so only its direction's agreement bounds the
    # parameters: 1e-3 of the leaf's largest update, plus 1e-6 of its
    # largest |p| for the float32 rounding of p - lr * delta.
    got, want, start = _leaves(tp), _leaves(jp), _leaves(jinit)
    for path, w in want.items():
        bound = 1e-3 * np.abs(w - start[path]).max() + TOL * np.abs(w).max()
        assert np.abs(got[path] - w).max() <= bound, path


@pytest.mark.parametrize("arch", ["gemma-2b", "mixtral-8x7b", "mamba2-370m"])
def test_build_train_step_matches_reference(arch):
    jcfg, tcfg, jp, tp = reference_params(arch + "-reduced")
    jstep = jtrain.build_train_step(jcfg, jadamw.AdamWConfig(), None,
                                    jadamw.cosine_schedule(300))
    tstep = ttrain.build_train_step(tcfg, tadamw.AdamWConfig(), None,
                                    tadamw.cosine_schedule(300))
    js, ts = jadamw.init(jp), tadamw.init(tp)
    jinit = to_numpy(jp)
    pipe = iter(_pipe(tcfg))
    for _ in range(3):
        batch = next(pipe)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v) for k, v in batch.items()})
        _check_state(tp, ts, tm, jp, js, jm, jinit)

    # one step from the reference's state with its counter at 100 (lr_scale 1)
    js = js._replace(step=jnp.int32(100))
    ts = tadamw.AdamWState(torch.tensor(100, dtype=torch.int32),
                           ttf.params_from_numpy(tcfg, to_numpy(js.mu), device="cpu"),
                           ttf.params_from_numpy(tcfg, to_numpy(js.nu), device="cpu"))
    tp = ttf.params_from_numpy(tcfg, to_numpy(jp), device="cpu")
    jinit = to_numpy(jp)
    batch = next(pipe)
    jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
    tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(ts.step) == 101
    _check_state(tp, ts, tm, jp, js, jm, jinit)


def test_build_train_step_refuses_a_mesh():
    cfg = ttrain.train_config("gemma-2b")
    with pytest.raises(TypeError):  # a mesh is a DeviceMesh (test_torch_multidevice.py)
        ttrain.build_train_step(cfg, tadamw.AdamWConfig(), object(), tadamw.cosine_schedule(1))


class _Captured(Exception):
    pass


@pytest.mark.parametrize("arch", jregistry.list_archs())
def test_train_config_is_the_reference_runs(arch, monkeypatch):
    """The config ``run`` trains, reduced, big and at full width, equal to
    the one the reference's ``run`` builds (caught at its init_params)."""

    def catch(cfg, key):
        raise _Captured(cfg)

    monkeypatch.setattr(jtrain.transformer, "init_params", catch)
    for reduced, big in ((True, False), (True, True), (False, False)):
        with pytest.raises(_Captured) as caught:
            jtrain.run(arch, steps=1, seq=96, reduced=reduced, big=big)
        want = caught.value.args[0]
        assert plain(ttrain.train_config(arch, reduced, big, seq=96)) == plain(want)


def test_training_reduces_loss():
    result = ttrain.run(
        "gemma-2b", steps=40, batch=4, seq=64, reduced=True, lr=1e-3,
        log_every=39, device="cpu",
    )
    assert result["final_loss"] < result["first_loss"]
    assert result["params"] == 8_655_360 and result["arch"] == "gemma-2b-reduced"
    assert [s for s, _ in result["losses"]] == [0, 39]


def _flags(path):
    """The option strings a module's ``add_argument`` calls declare."""
    tree = ast.parse(path.read_text())
    return sorted(node.args[0].value for node in ast.walk(tree)
                  if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument")


@pytest.mark.parametrize("port,ref", [("src/repro_torch/launch/train.py", "src/repro/launch/train.py"),
                                      ("src/repro_torch/examples/train_lm.py", "examples/train_lm.py")])
def test_flags_are_the_references_plus_device(port, ref):
    assert _flags(REPO / port) == sorted(_flags(REPO / ref) + ["--device"])


def test_train_main_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "result.json"
    ttrain.main(["--arch", "mamba2-370m", "--steps", "2", "--batch", "2", "--seq", "16",
                 "--lr", "1e-3", "--ckpt-dir", str(tmp_path / "ckpt"), "--out", str(out),
                 "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split()[:2] for line in lines[:2]] == [["step", "0"], ["step", "1"]]
    summary = json.loads(lines[-1])
    assert summary["arch"] == "mamba2-370m-reduced" and summary["steps"] == 2
    assert "losses" not in summary and len(json.loads(out.read_text())["losses"]) == 2
    assert tckpt.latest_step(str(tmp_path / "ckpt")) == 2
    cfg = ttrain.train_config("mamba2-370m", seq=16)
    restored = tckpt.restore(str(tmp_path / "ckpt"), 2, {"params": ttf.param_shapes(cfg)})
    assert all(torch.isfinite(t).all() for _, t in ttf.tree_leaves(restored["params"]))


def test_train_lm_on_the_cpu(capsys):
    train_lm.main(["--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert "arch=gemma-2b-reduced params=8.7M" in out and "loss " in out


def test_entry_points_default_to_the_card():
    import inspect

    assert inspect.signature(ttrain.run).parameters["device"].default == "cuda"
    assert inspect.signature(ttf.init_params).parameters["device"].default == "cuda"
    args = []
    for mod in (ttrain, train_lm):
        tree = ast.parse(pathlib.Path(mod.__file__).read_text())
        args += [kw.value.value for node in ast.walk(tree) if isinstance(node, ast.Call)
                 and node.args and getattr(node.args[0], "value", None) == "--device"
                 for kw in node.keywords if kw.arg == "default"]
    assert args == ["cuda", "cuda"]
