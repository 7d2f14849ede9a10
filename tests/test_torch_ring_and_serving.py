"""The port's ring caches and serving path (``repro_torch.serving``:
``Engine``, ``ContinuousEngine``; ``repro_torch.launch.serve``; the
``llm_edge_decode`` example) against the JAX reference's, on the CPU.

The reference's ring-cache (3) and continuous-batching (2) checks, and
``test_integration.py``'s greedy-determinism check, are restated on the
port; the engines' greedy tokens equal the reference's on the same
(converted) parameters; the example's planning parts print what the
reference's example prints.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import serve as jserve
from repro.models import transformer as jtf
from repro.serving.continuous import ContinuousEngine as JContinuous
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs import registry as tregistry
from repro_torch.examples import llm_edge_decode as texample
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttf
from repro_torch.serving.continuous import ContinuousEngine
from repro_torch.serving.engine import Engine, Request
from test_torch_models import max_err, reference_params, to_numpy, to_torch

REPO = pathlib.Path(__file__).resolve().parent.parent
WINDOWED = ["gemma3-4b", "starcoder2-3b", "mixtral-8x7b"]
TOL = 5e-5  # tests/test_ring_cache.py


@pytest.fixture(scope="module")
def gemma():
    """gemma-2b reduced: the reference's parameters (PRNGKey(0)) in both
    packages."""
    return reference_params("gemma-2b-reduced", seed=0)


def _example_requests(vocab, request_cls):
    """The example's 8 requests: 16-token prompts, 24 new tokens."""
    rng = np.random.default_rng(0)
    return [request_cls(uid=i, prompt=rng.integers(0, vocab, 16).astype(np.int32),
                        max_new_tokens=24) for i in range(8)]


# --- ring caches: tests/test_ring_cache.py on the port ---


@pytest.mark.parametrize("arch", WINDOWED)
def test_ring_decode_matches_forward(arch):
    jcfg, cfg, _, params = reference_params(arch + "-reduced", seed=1)
    b, s = 2, 24
    tokens = to_torch(jax.random.randint(jax.random.PRNGKey(1), (b, s), 0, cfg.vocab_size))
    with torch.no_grad():
        logits_full, _ = ttf.forward(cfg, params, {"tokens": tokens})
        cache = ttf.init_cache(cfg, b, s + 4, ring=True, device="cpu")
        errs = []
        for t in range(s):
            ld, cache = ttf.decode_step(cfg, params, cache, tokens[:, t:t + 1])
            errs.append(max_err(ld[:, 0], logits_full[:, t]))
    assert max(errs) < TOL


def test_ring_decode_after_wraparound():
    """Past the window, ring slots are overwritten; results still match
    the full-cache decode, and the reference's ring decode."""
    jcfg = dataclasses.replace(jregistry.get("starcoder2-3b").reduced(), sliding_window=8)
    cfg = dataclasses.replace(tregistry.get("starcoder2-3b").reduced(), sliding_window=8)
    _, _, jp, params = reference_params(None, seed=2, jcfg=jcfg, tcfg=cfg)
    b, s = 1, 30  # s >> window: the ring wraps ~4x
    jtokens = jax.random.randint(jax.random.PRNGKey(2), (b, s), 0, cfg.vocab_size)
    tokens = to_torch(jtokens)
    full_cache = ttf.init_cache(cfg, b, s + 2, device="cpu")
    ring_cache = ttf.init_cache(cfg, b, s + 2, ring=True, device="cpu")
    jring = jtf.init_cache(jcfg, b, s + 2, ring=True)
    assert ring_cache.local_k.shape[2] == 8  # ring length == window
    dec = jax.jit(lambda p, c, t: jtf.decode_step(jcfg, p, c, t))
    errs, ref_errs = [], []
    with torch.no_grad():
        for t in range(s):
            lf, full_cache = ttf.decode_step(cfg, params, full_cache, tokens[:, t:t + 1])
            lr, ring_cache = ttf.decode_step(cfg, params, ring_cache, tokens[:, t:t + 1])
            jl, jring = dec(jp, jring, jtokens[:, t:t + 1])
            errs.append(max_err(lf, lr))
            ref_errs.append(max_err(lr, jl))
    assert max(errs) < TOL
    assert max(ref_errs) < 1e-4
    assert max_err(ring_cache.local_k, jring.local_k) < 1e-4


def test_ring_cache_memory_footprint():
    """The whole point: windowed layers store W, not S (gemma3-4b's full
    config, on the meta device)."""
    cfg = tregistry.get("gemma3-4b")
    s = 524288
    shapes = ttf.cache_shapes(cfg, 1, s, ring=True)
    assert shapes.local_k.device.type == "meta"
    assert shapes.local_k.shape[2] == cfg.sliding_window  # 1024
    assert shapes.attn_k.shape[2] == s  # global layers keep full length
    n_local = shapes.local_k.shape[0]
    n_global = shapes.attn_k.shape[0]
    assert n_local + n_global == cfg.num_layers
    assert n_global == 5  # 5:1 pattern over 34 layers

    full = ttf.cache_shapes(cfg, 1, s, ring=False)

    def nbytes(x):
        return np.prod(x.shape) * x.element_size()

    ring_total = nbytes(shapes.local_k) * 2 + nbytes(shapes.attn_k) * 2
    full_total = nbytes(full.attn_k) * 2
    assert ring_total < full_total * 0.2  # >5x smaller
    want = jtf.cache_shapes(jregistry.get("gemma3-4b"), 1, s, ring=True)
    for name in want._fields:
        w, g = getattr(want, name), getattr(shapes, name)
        assert (g is None) == (w is None)
        if w is not None:
            assert tuple(g.shape) == w.shape and str(g.dtype) == f"torch.{w.dtype}", name


# --- the engines against the reference ---


def test_engine_greedy_tokens_equal_reference(gemma):
    """The example's 8 requests on gemma-2b reduced, both engines."""
    jcfg, cfg, jp, params = gemma
    want = JEngine(jcfg, jp, max_len=64).generate(_example_requests(jcfg.vocab_size, JRequest))
    got = Engine(cfg, params, max_len=64).generate(_example_requests(cfg.vocab_size, Request))
    assert [c.uid for c in got] == [c.uid for c in want]
    for g, w in zip(got, want):
        assert g.prefill_len == w.prefill_len == 16
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
        assert len(g.tokens) == 24


def test_engine_left_pads_ragged_prompts_as_reference(gemma):
    """Prompts of different lengths: left-padded with token 0, which is
    attended, as in the reference."""
    jcfg, cfg, jp, params = gemma
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (3, 9, 6)]
    want = JEngine(jcfg, jp, max_len=32).generate(
        [JRequest(uid=i, prompt=p, max_new_tokens=4 + i) for i, p in enumerate(prompts)])
    got = Engine(cfg, params, max_len=32).generate(
        [Request(uid=i, prompt=p, max_new_tokens=4 + i) for i, p in enumerate(prompts)])
    for g, w in zip(got, want):
        assert g.prefill_len == w.prefill_len == 9
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


def test_serving_engine_greedy_deterministic(gemma):
    """tests/test_integration.py's check on the port."""
    _, cfg, _, params = gemma
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                    max_new_tokens=6) for i in range(3)]
    c1 = Engine(cfg, params, max_len=32).generate(reqs)
    c2 = Engine(cfg, params, max_len=32).generate(reqs)
    for a, b in zip(c1, c2):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert len(a.tokens) == 6


def test_engine_sampling_is_seeded(gemma):
    """At temperature 0.8 the draws come from the engine's generator: the
    same seed gives the same tokens, another seed other tokens."""
    _, cfg, _, params = gemma
    reqs = _example_requests(cfg.vocab_size, Request)

    def tokens(seed):
        out = Engine(cfg, params, max_len=64, temperature=0.8, seed=seed).generate(reqs)
        return np.stack([c.tokens for c in out])

    first = tokens(3)
    assert np.array_equal(first, tokens(3))
    assert not np.array_equal(first, tokens(4))
    assert ((first >= 0) & (first < cfg.vocab_size)).all()


def _isolated_greedy(cfg, params, prompt, n_new):
    toks = torch.as_tensor(prompt, dtype=torch.int32)[None, :]
    with torch.no_grad():
        logits, cache = ttf.prefill(cfg, params, toks, max_len=96)
        cur = int(torch.argmax(logits[0]))
        out = [cur]
        for _ in range(n_new - 1):
            step, cache = ttf.decode_step(cfg, params, cache,
                                          torch.tensor([[cur]], dtype=torch.int32))
            cur = int(torch.argmax(step[0, 0]))
            out.append(cur)
    return np.asarray(out, np.int32)


def test_continuous_matches_isolated(gemma):
    """tests/test_continuous_batching.py's check on the port."""
    _, cfg, _, params = gemma
    rng = np.random.default_rng(0)
    # different lengths + counts force slot reuse at different positions
    requests = [
        Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 4 + 3 * i).astype(np.int32),
                max_new_tokens=3 + (i % 4))
        for i in range(6)
    ]
    eng = ContinuousEngine(cfg, params, num_slots=2, max_len=96)
    for r in requests:
        eng.submit(r)
    completions = eng.run_to_completion()
    assert [c.uid for c in completions] == list(range(6))
    for r, c in zip(requests, completions):
        np.testing.assert_array_equal(c.tokens, _isolated_greedy(cfg, params, r.prompt,
                                                                 r.max_new_tokens))


def test_slot_reuse_count(gemma):
    _, cfg, _, params = gemma
    rng = np.random.default_rng(1)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 5).astype(np.int32),
                    max_new_tokens=2) for i in range(5)]
    eng = ContinuousEngine(cfg, params, num_slots=2, max_len=64)
    for r in reqs:
        eng.submit(r)
    out = eng.run_to_completion()
    assert len(out) == 5
    assert all(len(c.tokens) == 2 for c in out)


@pytest.mark.parametrize("arch", ["gemma-2b", "zamba2-2.7b", "minicpm3-4b"])
def test_continuous_engine_equals_reference_past_max_len(arch):
    """Completions and the final cache equal the reference's.  Request 0
    ends at its prefill; request 1 (a 20-token prompt) ends after one
    step, and its slot is then decoded free for 20 more steps while
    request 2 runs, its position running past max_len = 24, where the
    reference writes its KV at the last cache slot."""
    jcfg, cfg, jp, params = reference_params(arch + "-reduced", seed=0)
    rng = np.random.default_rng(2)
    spec = [(3, 1), (20, 2), (2, 21)]  # (prompt length, new tokens)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n, _ in spec]
    engines = {"ref": JContinuous(jcfg, jp, num_slots=2, max_len=24),
               "port": ContinuousEngine(cfg, params, num_slots=2, max_len=24)}
    out = {}
    for label, eng in engines.items():
        cls = JRequest if label == "ref" else Request
        for i, (p, (_, n)) in enumerate(zip(prompts, spec)):
            eng.submit(cls(uid=i, prompt=p, max_new_tokens=n))
        out[label] = eng.run_to_completion()
    assert [c.uid for c in out["port"]] == [c.uid for c in out["ref"]] == [0, 1, 2]
    for g, w in zip(out["port"], out["ref"]):
        assert g.prefill_len == w.prefill_len
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
    ref_cache, port_cache = to_numpy(engines["ref"].cache), engines["port"].cache
    assert int(port_cache.position.max()) > 24  # a free slot decoded past max_len
    np.testing.assert_array_equal(port_cache.position.numpy(), ref_cache.position)
    for name in ref_cache._fields:
        want = getattr(ref_cache, name)
        if want is not None and name != "position":
            assert max_err(getattr(port_cache, name), want) < 1e-4, name


# --- the driver and the example ---


def test_serve_run_returns_the_reference_keys():
    kw = dict(reduced=True, num_requests=2, prompt_len=8, max_new=4, seed=1)
    want = jserve.run("mamba2-370m", **kw)
    got = tserve.run("mamba2-370m", device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for key in ("arch", "requests", "new_tokens"):
        assert got[key] == want[key]
    assert got["seconds"] > 0 and got["tokens_per_second"] > 0
    assert len(got["sample"]) == 4
    assert all(isinstance(t, int) and 0 <= t < 512 for t in got["sample"])


def test_example_prints_the_references_planning_parts(capsys):
    spec = importlib.util.spec_from_file_location("_ref_llm_edge_decode",
                                                  REPO / "examples" / "llm_edge_decode.py")
    ref_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_example)
    ref_example.main()
    want = capsys.readouterr().out.splitlines()
    texample.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0].startswith("served 8 requests, 192 tokens in ")
    assert got[0].endswith(" tok/s on this CPU)")
    assert got[1].startswith("sample completion: [")
    part2 = want.index("") + 1  # parts 2-3 follow part 1's blank line
    assert len(want) - part2 > 20
    assert got[part2:] == want[part2:]
