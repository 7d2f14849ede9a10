"""The port's gradients (``torch.autograd.grad`` through
``repro_torch.models.transformer.loss_fn``) against the reference's
``jax.value_and_grad(loss_fn(..., remat=True))``, for all ten
architectures at their reduced configs, on the CPU.

Each arch runs once per package on the reference's parameters and
``tests/test_models_smoke.py``'s batch (B 2, S 32); the reference's
value-and-grad is jitted once per arch and its result shared.  Held:

* the loss within 1e-5, and every gradient leaf within 1e-5 of that
  leaf's largest |g| (the reduced configs are float32; the reference's
  own model tests hold its modules at 1e-4);
* ``remat`` on and off bit for bit (the layer bodies draw no random
  numbers, so the recomputation repeats the same operations), and remat
  really recomputing: fewer activation bytes saved by the forward;
* ``tests/test_models_smoke.py::test_reduced_train_step_no_nan`` on the
  port: one train step, a finite loss and grad norm, parameters moved.
"""

import functools
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import transformer as jtf
from repro_torch.launch import train
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw
from test_models_smoke import _batch
from test_torch_models import reference_params, to_numpy, to_torch

ARCHS = jregistry.list_archs()
REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-5



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch: the suite runs several workers on a
    few cores, where torch's default of one thread a core makes them
    contend (the 40-step training run then takes minutes, not seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def port_grads(cfg, params, batch, remat=True):
    """(loss, {path: gradient}) of the port's loss_fn."""
    (loss, _), grads = train.value_and_grad(cfg, params, batch, remat=remat)
    return loss, dict(ttf.tree_leaves(grads))


@functools.lru_cache(maxsize=None)
def run(arch):
    """Both packages' loss and gradients for one arch on the same
    parameters and batch; the port's config, parameters and batch."""
    jcfg, tcfg, jp, tp = reference_params(arch + "-reduced")
    jbatch = _batch(jcfg)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(jcfg, p, b, remat=True), has_aux=True))
    (jloss, _), jgrads = vg(jp, jbatch)
    batch = {k: to_torch(v) for k, v in jbatch.items()}
    loss, grads = port_grads(tcfg, tp, batch)
    return {"cfg": tcfg, "params": tp, "batch": batch, "loss": loss, "grads": grads,
            "ref_loss": float(jloss), "ref_grads": dict(ttf.tree_leaves(to_numpy(jgrads)))}


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch):
    r = run(arch)
    assert abs(float(r["loss"]) - r["ref_loss"]) < TOL
    assert sorted(r["grads"]) == sorted(r["ref_grads"])
    for path, want in r["ref_grads"].items():
        got = r["grads"][path].numpy()
        scale = np.abs(want).max()
        assert np.isfinite(got).all() and scale > 0, path  # every leaf is used
        assert np.abs(got.astype(np.float64) - want).max() < TOL * scale, path


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_value(arch):
    r = run(arch)
    loss, grads = port_grads(r["cfg"], r["params"], r["batch"], remat=False)
    assert torch.equal(loss, r["loss"])
    for path, g in grads.items():
        assert torch.equal(g, r["grads"][path]), path


def _saved_bytes(cfg, params, batch, remat):
    """Bytes the forward saves for the backward outside checkpointed
    regions (a region's own saved tensors are recomputed, not kept)."""
    nbytes = []

    def pack(t):
        nbytes.append(t.numel() * t.element_size())
        return t

    live = ttf.tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        ttf.loss_fn(cfg, live, batch, remat=remat)
    return sum(nbytes)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_saves_fewer_activations(arch):
    r = run(arch)
    with_remat = _saved_bytes(r["cfg"], r["params"], r["batch"], True)
    without = _saved_bytes(r["cfg"], r["params"], r["batch"], False)
    assert 0 < with_remat < without


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_train_step_no_nan(arch):
    """The reference's smoke train step on the port: the default AdamW at
    lr_scale 1 (the reference's ``adamw.update`` default)."""
    r = run(arch)
    params = ttf.tree_map(torch.clone, r["params"])
    before = ttf.tree_map(torch.clone, params)
    step = train.build_train_step(r["cfg"], adamw.AdamWConfig(), None, lambda s: 1.0)
    params2, opt2, metrics = step(params, adamw.init(params), r["batch"])
    assert not bool(torch.isnan(metrics["loss"]))
    gnorm = float(metrics["grad_norm"])
    assert gnorm > 0.0 and np.isfinite(gnorm)
    assert int(opt2.step) == 1
    delta = [float((a.float() - b.float()).abs().max())
             for (_, a), (_, b) in zip(ttf.tree_leaves(before), ttf.tree_leaves(params2))]
    assert max(delta) > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_batch_is_the_smoke_tests(arch):
    """chip_smoke.py's phase 18 (and tests/test_torch_train_gpu.py) feed
    the card ``tests/test_models_smoke.py``'s batch: the same keys, shapes
    and dtypes, the frontend inputs equal."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    r = run(arch)
    got = chip_smoke._train_batch(torch, r["cfg"], "cpu")
    assert sorted(got) == sorted(r["batch"])
    for k, want in r["batch"].items():
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
        if k not in ("tokens", "targets"):
            assert torch.equal(got[k], want), k
    assert torch.equal(got["targets"], torch.roll(got["tokens"], -1, dims=1))
