"""The port's training path on the card against the port's CPU path.

This file imports neither JAX nor the reference package, so the card's
machine, which has no JAX, runs it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_gpu.py

Elsewhere the tests skip with that reason.  The parameters are drawn
once on the CPU from a seeded ``torch.Generator`` and copied to the
card; the batches and the error helpers are ``chip_smoke.py``'s phase
18's.  The card runs in float32 with TF32 off.  Held: each reduced
arch's loss within 1e-5 of the CPU's and each gradient leaf within 1e-5
of its largest |g| (MoE's index_add_ sums duplicates in no fixed order
on the card); remat on against off on the card, the loss bit for bit and
the gradients within 1e-6; the reference's 40-step integration run
lowering its loss; a checkpoint written from the card restored on the
CPU bit for bit.  The port's CPU path is held to the reference in
``tests/test_torch_grads.py``, ``test_torch_train.py`` and
``test_torch_checkpoint.py``.
"""

import importlib.util
import pathlib

import pytest
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs import registry
from repro_torch.launch import train
from repro_torch.models import transformer
from repro_torch.optim import adamw

REPO = pathlib.Path(__file__).resolve().parent.parent
spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
CHIP_SMOKE = importlib.util.module_from_spec(spec)  # its phase 18's batches and checks
spec.loader.exec_module(CHIP_SMOKE)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _reduced(arch, cuda):
    cfg = registry.get(arch).reduced()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params, transformer.tree_map(lambda t: t.to(cuda), params)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", registry.list_archs())
def test_reduced_grads_on_the_card_match_cpu(arch, cuda):
    cfg, params, card = _reduced(arch, cuda)
    (want_loss, _), want = train.value_and_grad(cfg, params,
                                                CHIP_SMOKE._train_batch(torch, cfg, "cpu"))
    (loss, _), got = train.value_and_grad(cfg, card, CHIP_SMOKE._train_batch(torch, cfg, cuda))
    assert abs(float(loss) - float(want_loss)) < CHIP_SMOKE.TRAIN_TOL
    errs = CHIP_SMOKE._grad_errs(torch, transformer, got, want)
    assert len(errs) == len(transformer.tree_leaves(params))
    assert all(torch.isfinite(g).all() for _, g in transformer.tree_leaves(got))
    assert max(errs.values()) < CHIP_SMOKE.TRAIN_TOL, errs


@pytest.mark.gpu
@pytest.mark.parametrize("arch", registry.list_archs())
def test_remat_on_the_card_changes_no_value(arch, cuda):
    cfg, _, card = _reduced(arch, cuda)
    batch = CHIP_SMOKE._train_batch(torch, cfg, cuda)
    (loss, _), got = train.value_and_grad(cfg, card, batch, remat=True)
    (loss0, _), got0 = train.value_and_grad(cfg, card, batch, remat=False)
    assert torch.equal(loss, loss0)
    errs = CHIP_SMOKE._grad_errs(torch, transformer, got0, got)
    assert max(errs.values()) < CHIP_SMOKE.TRAIN_REMAT_TOL, errs


@pytest.mark.gpu
def test_training_reduces_loss_on_the_card(cuda):
    result = train.run("gemma-2b", steps=40, batch=4, seq=64, reduced=True, lr=1e-3,
                       log_every=39, device="cuda")
    assert result["final_loss"] < result["first_loss"]


@pytest.mark.gpu
def test_checkpoint_from_the_card_restores_on_the_cpu(cuda, tmp_path):
    cfg = train.train_config("mamba2-370m", seq=32)
    params = transformer.init_params(cfg, torch.Generator(device=cuda).manual_seed(2),
                                     device=cuda)
    state = adamw.init(params)
    step = train.build_train_step(cfg, adamw.AdamWConfig(), None, lambda s: 1.0)
    params, state, _ = step(params, state, {
        k: v.to(cuda) for k, v in CHIP_SMOKE._train_batch(torch, cfg, "cpu").items()})
    bf16 = transformer.tree_map(lambda t: t.to(torch.bfloat16), params)
    ckpt_io.save(str(tmp_path), 1, {"params": params, "opt": state, "bf16": bf16})
    assert ckpt_io.latest_step(str(tmp_path)) == 1
    shapes = transformer.param_shapes(cfg)
    back = ckpt_io.restore(str(tmp_path), 1, {
        "params": shapes, "opt": adamw.init(shapes),
        "bf16": transformer.tree_map(lambda t: t.to(torch.bfloat16), shapes)})
    assert int(back["opt"].step) == 1
    for got, want in ((back["params"], params), (back["opt"].mu, state.mu),
                      (back["opt"].nu, state.nu), (back["bf16"], bf16)):
        assert not CHIP_SMOKE._bit_equal_trees(torch, transformer, got, want)
        assert all(t.device.type == "cpu" for _, t in transformer.tree_leaves(got))
