"""The port's transformer (``repro_torch.models.transformer``: forward,
prefill, decode_step and the caches) against the JAX reference's, for
all ten architectures at their reduced configs, on the CPU.

Each arch runs once per package on the reference's parameters and
inputs (``jax.random.PRNGKey(1)``, as ``tests/test_decode_consistency.py``
draws them): the forward over 20 tokens, the prefill of the first 10 and
10 decode steps.  The reference's functions are jitted once per arch and
its results shared between the tests.  Held:

* the port's logits equal the reference's within 1e-4 (forward, prefill
  and each decode step);
* the port's own decode equals its forward within the reference's 5e-5
  (the ten checks of ``tests/test_decode_consistency.py``: the eight text
  archs, qwen2-vl's M-RoPE and seamless' encoder-decoder);
* ``tests/test_models_smoke.py``'s forward and decode-step shapes, with
  no NaN, on the port.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import multimodal as jmm
from repro.models import transformer as jtf
from repro_torch.configs import registry as tregistry
from repro_torch.models import multimodal as tmm
from repro_torch.models import transformer as ttf
from test_torch_models import max_err, reference_params, to_numpy, to_torch

ARCHS = jregistry.list_archs()
B, S = 2, 20
P = S // 2
PARITY_TOL = 1e-4  # port against reference
ROUNDTRIP_TOL = 5e-5  # decode against forward, tests/test_decode_consistency.py


def _inputs(jcfg, tokens):
    """(forward batch, prefill kwargs, decode positions per step) for the
    reference, as tests/test_decode_consistency.py builds them."""
    if jcfg.mrope:
        f = jcfg.frontend_tokens
        fe = jmm.fake_frontend_embeds(jcfg, B)
        pos = jmm.mrope_positions(B, S, image_grid=(4, 4))
        return ({"tokens": tokens, "positions": pos, "frontend_embeds": fe},
                {"positions": pos[:, :, : f + P], "frontend_embeds": fe},
                [pos[:, :, f + t: f + t + 1] for t in range(P, S)])
    if jcfg.encoder_layers:
        enc = jmm.fake_frontend_embeds(jcfg, B)
        return ({"tokens": tokens, "encoder_tokens": enc}, {"encoder_tokens": enc},
                [None] * (S - P))
    return {"tokens": tokens}, {}, [None] * (S - P)


def _port(tree):
    """Reference inputs (arrays, dicts, lists, None) as CPU tensors."""
    if isinstance(tree, dict):
        return {k: _port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port(v) for v in tree]
    return None if tree is None else to_torch(tree)


@functools.lru_cache(maxsize=None)
def run(arch):
    """Both packages' forward, prefill and decode logits (numpy) for one
    arch, on the same parameters and inputs; and the port's final cache."""
    jcfg, tcfg, jp, tp = reference_params(arch + "-reduced", seed=1)
    key = jax.random.PRNGKey(1)
    tokens = jax.random.randint(key, (B, S), 0, jcfg.vocab_size)
    batch, pkw, dpos = _inputs(jcfg, tokens)
    fwd = jax.jit(lambda p, b: jtf.forward(jcfg, p, b))
    logits, _ = fwd(jp, batch)
    max_len = logits.shape[1] + 4  # frontend positions + S + 4
    pre = jax.jit(lambda p, t, kw: jtf.prefill(jcfg, p, t, max_len=max_len, **kw))
    dec = jax.jit(lambda p, c, t, pos: jtf.decode_step(jcfg, p, c, t, positions=pos))
    lp, cache = pre(jp, tokens[:, :P], pkw)
    ref = {"forward": np.asarray(logits), "prefill": np.asarray(lp), "decode": []}
    for t, pos in zip(range(P, S), dpos):
        ld, cache = dec(jp, cache, tokens[:, t: t + 1], pos)
        ref["decode"].append(np.asarray(ld))
    ref["cache"] = to_numpy(cache)

    tbatch, tpkw, tdpos = _port(batch), _port(pkw), _port(dpos)
    ttokens = to_torch(tokens)
    with torch.no_grad():
        tlogits, _ = ttf.forward(tcfg, tp, tbatch)
        tlp, tcache = ttf.prefill(tcfg, tp, ttokens[:, :P], max_len=max_len, **tpkw)
        port = {"forward": tlogits.numpy(), "prefill": tlp.numpy(), "decode": []}
        for t, pos in zip(range(P, S), tdpos):
            ld, tcache = ttf.decode_step(tcfg, tp, tcache, ttokens[:, t: t + 1], positions=pos)
            port["decode"].append(ld.numpy())
    port["cache"] = tcache
    return ref, port


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_reference(arch):
    ref, port = run(arch)
    assert port["forward"].shape == ref["forward"].shape
    assert not np.isnan(port["forward"]).any()
    assert max_err(port["forward"], ref["forward"]) < PARITY_TOL
    assert max_err(port["prefill"], ref["prefill"]) < PARITY_TOL
    assert len(port["decode"]) == 10
    for step, (got, want) in enumerate(zip(port["decode"], ref["decode"])):
        assert got.shape == want.shape
        assert max_err(got, want) < PARITY_TOL, step
    for name in ref["cache"]._fields:
        want, got = getattr(ref["cache"], name), getattr(port["cache"], name)
        assert (got is None) == (want is None), name
        if want is not None:
            assert tuple(got.shape) == want.shape, name
            assert max_err(got, want) < PARITY_TOL, name


@pytest.mark.parametrize("arch", ARCHS)
def test_port_decode_matches_its_forward(arch):
    """tests/test_decode_consistency.py on the port: prefill + decode ==
    the parallel forward, within the reference's 5e-5."""
    _, port = run(arch)
    offset = port["forward"].shape[1] - S  # frontend positions, if any
    errs = [max_err(port["prefill"], port["forward"][:, offset + P - 1])]
    for t, got in zip(range(P, S), port["decode"]):
        errs.append(max_err(got[:, 0], port["forward"][:, offset + t]))
    assert max(errs) < ROUNDTRIP_TOL


def _smoke_batch(cfg, mm, B=2, S=32):
    """tests/test_models_smoke.py's batch, drawn from numpy."""
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens}
    if cfg.mrope:
        batch["positions"] = np.broadcast_to(
            np.arange(S + cfg.frontend_tokens, dtype=np.int32)[None, None],
            (3, B, S + cfg.frontend_tokens)).copy()
        batch["frontend_embeds"] = mm(cfg, B)
    elif cfg.modality == "vision":
        batch["frontend_embeds"] = mm(cfg, B)
    if cfg.encoder_layers:
        batch["encoder_tokens"] = mm(cfg, B)
        batch.pop("frontend_embeds", None)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_forward_shapes_and_no_nan(arch):
    """tests/test_models_smoke.py's forward check on the port, and its
    logits and aux loss equal to the reference's."""
    jcfg, tcfg, jp, tp = reference_params(arch + "-reduced", seed=0)
    assert tcfg.num_layers <= 2 and tcfg.d_model <= 512
    if tcfg.moe:
        assert tcfg.moe.num_experts <= 4
    jbatch = _smoke_batch(jcfg, jmm.fake_frontend_embeds)
    tbatch = {k: to_torch(v) for k, v in
              _smoke_batch(tcfg, lambda c, b: tmm.fake_frontend_embeds(c, b, device="cpu"))
              .items()}
    with torch.no_grad():
        logits, aux = ttf.forward(tcfg, tp, tbatch)
    expect_s = 32 + (tcfg.frontend_tokens if tcfg.modality == "vision" else 0)
    assert logits.shape == (2, expect_s, tcfg.vocab_size)
    assert not bool(torch.isnan(logits).any()) and not bool(torch.isnan(aux))
    want, want_aux = jax.jit(lambda p, b: jtf.forward(jcfg, p, b))(
        jp, {k: jnp.asarray(v) for k, v in jbatch.items()})
    assert max_err(logits, want) < PARITY_TOL
    assert abs(float(aux) - float(want_aux)) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_decode_step_shapes(arch):
    tcfg = tregistry.get(arch).reduced()
    params = ttf.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    b = 2
    cache = ttf.init_cache(tcfg, b, 64, device="cpu")
    toks = torch.zeros((b, 1), dtype=torch.int32)
    pos = torch.zeros((3, b, 1), dtype=torch.int32) if tcfg.mrope else None
    with torch.no_grad():
        logits, cache2 = ttf.decode_step(tcfg, params, cache, toks, positions=pos)
    assert logits.shape == (b, 1, tcfg.vocab_size)
    assert not bool(torch.isnan(logits).any())
    assert int(cache2.position[0]) == 1
    assert int(cache.position[0]) == 0  # the cache passed in is left as it was
    want = jtf.cache_shapes(jregistry.get(arch).reduced(), b, 64)
    got = ttf.cache_shapes(tcfg, b, 64)
    for name in want._fields:
        w, g, real = getattr(want, name), getattr(got, name), getattr(cache2, name)
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.device.type == "meta"
            assert (tuple(g.shape), str(g.dtype)) == (w.shape, f"torch.{w.dtype}"), name
            assert (real.shape, real.dtype) == (g.shape, g.dtype), name
