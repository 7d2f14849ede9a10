"""The port's LLM serving path on the card against the port's CPU path.

This file imports neither JAX nor the reference package, so the card's
machine, which has no JAX, runs it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_llm_gpu.py

Elsewhere the tests skip with that reason.  The parameters are drawn once
on the CPU from a seeded ``torch.Generator`` and copied to the card; the
inputs and the run (forward, prefill, 10 decode steps) are
``chip_smoke.py``'s phase 17's.  The card runs in float32 with TF32 off,
and its logits are held to the CPU's within 1e-4 (the port's CPU path
is held to the reference in ``tests/test_torch_decode.py``).  The path
adds no kernel of its own: its products are ``torch.matmul``/``einsum``.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.models import transformer
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import Engine, Request

TOL = 1e-4
REPO = pathlib.Path(__file__).resolve().parent.parent
spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
CHIP_SMOKE = importlib.util.module_from_spec(spec)  # its phase 17's inputs and run
spec.loader.exec_module(CHIP_SMOKE)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", registry.list_archs())
def test_reduced_arch_on_the_card_matches_cpu(arch, cuda):
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = registry.get(arch).reduced()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = transformer.tree_map(lambda t: t.to(cuda), params)
    got = CHIP_SMOKE._llm_logits(torch, transformer, cfg, card, cuda)
    want = CHIP_SMOKE._llm_logits(torch, transformer, cfg, params, "cpu")
    assert sorted(got) == sorted(want) and len(got) == 12  # forward, prefill, 10 decode steps
    for key in want:
        assert torch.isfinite(got[key]).all(), key
        assert float((got[key] - want[key]).abs().max()) < TOL, key


@pytest.mark.gpu
def test_engines_on_the_card_match_cpu(cuda):
    """The example's 8 requests on gemma-2b reduced: the card's greedy
    tokens equal the CPU's, and the continuous engine's (4 slots) equal
    the static engine's for each request."""
    cfg = registry.get("gemma-2b").reduced()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = transformer.tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 16).astype(np.int32),
                    max_new_tokens=24) for i in range(8)]
    want = Engine(cfg, params, max_len=64).generate(reqs)
    got = Engine(cfg, card, max_len=64).generate(reqs)
    cont = ContinuousEngine(cfg, card, num_slots=4, max_len=64)
    for r in reqs:
        cont.submit(r)
    for g, w, c in zip(got, want, cont.run_to_completion()):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_array_equal(c.tokens, g.tokens)
