"""The port's model substrate (``repro_torch.models``: layers, attention,
ssm, moe, multimodal and ``transformer.init_params``) against the JAX
reference's, module by module, on the CPU.

Inputs are drawn from numpy with a seed and given to both packages;
parameters are the reference's, carried across leaf for leaf.  Reduced
configs are float32, and the port is held to 1e-5 absolute against the
reference on single modules (the reference's own model tests hold its
modules at 1e-4 and its decode at 5e-5).  The reference's ``test_ssm.py``
and ``test_moe.py`` checks are restated here on the port.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import multimodal as jmm
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch.configs import registry as tregistry
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import multimodal as tmm
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf

ARCHS = jregistry.list_archs()
TOL = 1e-5


# --- helpers shared by the LLM test files ---


def to_numpy(tree):
    """A reference tree (dicts, NamedTuples, arrays) as numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, tree)


def to_torch(x):
    """A numpy array (or a reference array) as a CPU tensor."""
    return torch.from_numpy(np.array(x))


def reference_params(cfg_name, seed=0, jcfg=None, tcfg=None):
    """(reference cfg, port cfg, reference params, the same params on the
    port) for a registry name, or for the given configs."""
    jcfg = jcfg or jregistry.get(cfg_name)
    tcfg = tcfg or tregistry.get(cfg_name)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, ttf.params_from_numpy(tcfg, to_numpy(jp), device="cpu")


def max_err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.max(np.abs(got.astype(np.float64) - np.asarray(want, np.float64))))


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


# --- layers ---


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_kinds_match_reference(kind, rng):
    """Weights of scale 0.5 put the pre-activations where the GELU's tanh
    and erf forms differ (by up to 1e-3 near |x| = 2); held relative to
    the output's scale."""
    jp = {k: rand(rng, *v.shape, scale=0.5)
          for k, v in jlayers.init_mlp(jax.random.PRNGKey(1), 32, 48, kind).items()}
    tp = {k: to_torch(v) for k, v in jp.items()}
    x = rand(rng, 2, 5, 32)
    want = np.asarray(jlayers.mlp(jp, x, kind))
    assert max_err(tlayers.mlp(tp, to_torch(x), kind), want) < TOL * np.abs(want).max()
    with pytest.raises(ValueError):
        tlayers.mlp(tp, to_torch(x), "relu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(dtype, rng):
    x = rand(rng, 3, 4, 64, scale=3.0)
    for kind in ("rmsnorm", "layernorm"):
        jp = {k: v + 0.1 * rand(rng, *v.shape) for k, v in
              jlayers.init_norm(kind, 64).items()}
        tp = {k: to_torch(v) for k, v in jp.items()}
        jx = jnp.asarray(x, dtype)
        tx = to_torch(x).to(getattr(torch, dtype))
        got = tlayers.apply_norm(kind, tp, tx)
        assert got.dtype == tx.dtype
        want = np.asarray(jlayers.apply_norm(kind, jp, jx).astype(jnp.float32))
        assert max_err(got.float(), want) < (TOL if dtype == "float32" else 1e-2)


def test_rope_mrope_and_softcap_match_reference(rng):
    pos = np.arange(37, dtype=np.int32) * 3
    for theta in (1e4, 1e6):
        assert max_err(tlayers.rope_angles(to_torch(pos), 64, theta),
                       jlayers.rope_angles(pos, 64, theta)) < 1e-4 * pos.max()
    x = rand(rng, 2, 37, 4, 64)
    ang = jlayers.rope_angles(pos, 64, 1e4)
    assert max_err(tlayers.apply_rope(to_torch(x), to_torch(ang)),
                   jlayers.apply_rope(x, ang)) < TOL
    mpos = np.asarray(jmm.mrope_positions(2, 9, image_grid=(3, 4)))
    assert np.array_equal(tmm.mrope_positions(2, 9, image_grid=(3, 4), device="cpu").numpy(),
                          mpos)
    assert np.array_equal(tmm.mrope_positions(1, 5, device="cpu").numpy(),
                          np.asarray(jmm.mrope_positions(1, 5)))
    for sections in ((8, 12, 12), (16, 8, 8)):
        want = jlayers.mrope_angles(mpos, 64, 1e6, sections)
        got = tlayers.mrope_angles(to_torch(mpos), 64, 1e6, sections)
        assert got.shape == want.shape and max_err(got, want) < 1e-3
    y = rand(rng, 100, scale=80.0)
    for cap in (0.0, 30.0, 50.0):
        assert max_err(tlayers.softcap(to_torch(y), cap), jlayers.softcap(y, cap)) < 1e-4


def test_embed_reads_out_of_range_ids_as_reference(rng):
    table = rand(rng, 10, 6)
    ids = np.array([[0, 9, 10, 11, -1, -10], [-11, 3, 1 << 20, -(1 << 20), 5, 2]], np.int32)
    want = np.asarray(jlayers.embed({"table": table}, ids))
    got = tlayers.embed({"table": to_torch(table)}, to_torch(ids)).numpy()
    assert np.isnan(want).any()  # ids past the table read NaN rows
    np.testing.assert_array_equal(got, want)  # NaN positions equal too
    x = rand(rng, 3, 6)
    assert max_err(tlayers.unembed({"table": to_torch(table)}, to_torch(x)),
                   jlayers.unembed({"table": table}, x)) < TOL


# --- attention ---


@pytest.mark.parametrize("case", [
    dict(s=13, t=13, window=0, causal=True, softcap=0.0, dv=16),
    dict(s=13, t=13, window=4, causal=True, softcap=30.0, dv=16),
    dict(s=11, t=19, window=0, causal=False, softcap=0.0, dv=24),
    dict(s=17, t=17, window=3, causal=True, softcap=5.0, dv=8),
])
def test_attend_chunked_matches_reference(case, rng):
    """Chunk sizes that leave padded query and key chunks, windows whose
    first key chunk is fully masked, softcap and a V width of its own."""
    b, h, kvh, d = 2, 4, 2, 16
    q, k = rand(rng, b, case["s"], h, d), rand(rng, b, case["t"], kvh, d)
    v = rand(rng, b, case["t"], kvh, case["dv"])
    qpos = np.arange(case["s"], dtype=np.int32) + (case["t"] - case["s"])
    kpos = np.arange(case["t"], dtype=np.int32)
    for q_chunk, k_chunk in ((4, 3), (5, 8), (512, 1024)):
        kw = dict(window=case["window"], causal=case["causal"], q_chunk=q_chunk,
                  k_chunk=k_chunk, softcap_val=case["softcap"])
        want = jattn.attend_chunked(q, k, v, q_positions=qpos, k_positions=kpos, **kw)
        got = tattn.attend_chunked(to_torch(q), to_torch(k), to_torch(v),
                                   q_positions=to_torch(qpos), k_positions=to_torch(kpos), **kw)
        assert not torch.isnan(got).any()
        assert max_err(got, want) < TOL, (q_chunk, k_chunk)


def test_attend_decode_ring_and_cache_write_match_reference(rng):
    b, t, h, kvh, d = 3, 8, 4, 1, 16
    q, kc, vc = rand(rng, b, 1, h, d), rand(rng, b, t, kvh, d), rand(rng, b, t, kvh, d)
    for pos in ([0, 3, 7], [2, 9, 30]):  # past T: every slot valid / written
        p = np.asarray(pos, np.int32)
        for window in (0, 3):
            want = jattn.attend_decode(q, kc, vc, position=p, window=window, softcap_val=20.0)
            got = tattn.attend_decode(to_torch(q), to_torch(kc), to_torch(vc),
                                      position=to_torch(p), window=window, softcap_val=20.0)
            assert max_err(got, want) < TOL
        want = jattn.attend_decode_ring(q, kc, vc, position=p)
        got = tattn.attend_decode_ring(to_torch(q), to_torch(kc), to_torch(vc),
                                       position=to_torch(p))
        assert max_err(got, want) < TOL
    new = rand(rng, b, kvh, d)
    for pos in ([0, 7, 8], [-3, 100, 5], [-8, -9, -1]):  # as dynamic_update_slice reads them
        p = np.asarray(pos, np.int32)
        want = np.asarray(jattn._cache_write(kc, new, p))
        got = tattn._cache_write(to_torch(kc), to_torch(new), to_torch(p))
        np.testing.assert_array_equal(got.numpy(), want)
        if pos[1] == 100:  # past the end: the last slot
            assert np.array_equal(got.numpy()[1, t - 1], new[1])


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2-vl-7b", "minicpm3-4b"])
def test_gqa_and_mla_forward_and_decode_match_reference(arch, rng):
    jcfg, tcfg = jregistry.get(arch).reduced(), tregistry.get(arch).reduced()
    jp = jattn.init_attention(jax.random.PRNGKey(2), jcfg)
    tp = {k: ({kk: to_torch(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else to_torch(v)) for k, v in jp.items()}
    b, s, t = 2, 7, 12
    x = rand(rng, b, s, jcfg.d_model)
    if jcfg.mrope:
        pos = np.asarray(jmm.mrope_positions(b, s))
    else:
        pos = np.arange(s, dtype=np.int32)
    if jcfg.attention == "mla":
        want = jattn.mla_forward(jp, jcfg, x, pos)
        got = tattn.mla_forward(tp, tcfg, to_torch(x), to_torch(pos))
        c, r = jattn.mla_prefill_cache(jp, jcfg, x, pos)
        tc, tr = tattn.mla_prefill_cache(tp, tcfg, to_torch(x), to_torch(pos))
        assert max(max_err(tc, c), max_err(tr, r)) < TOL
    else:
        want = jattn.gqa_forward(jp, jcfg, x, pos, window=4)
        got = tattn.gqa_forward(tp, tcfg, to_torch(x), to_torch(pos), window=4)
        k, v = jattn.gqa_prefill_kv(jp, jcfg, x, pos)
        tk, tv = tattn.gqa_prefill_kv(tp, tcfg, to_torch(x), to_torch(pos))
        assert max(max_err(tk, k), max_err(tv, v)) < TOL
        mem = rand(rng, b, 5, jcfg.d_model)
        want_x = jattn.gqa_forward(jp, jcfg, x, np.arange(s, dtype=np.int32), causal=False,
                                   kv_override=(mem, mem))
        got_x = tattn.gqa_forward(tp, tcfg, to_torch(x), torch.arange(s, dtype=torch.int32),
                                  causal=False, kv_override=(to_torch(mem), to_torch(mem)))
        assert max_err(got_x, want_x) < TOL
    assert max_err(got, want) < TOL

    xd = rand(rng, b, 1, jcfg.d_model)
    p = np.asarray([3, 11], np.int32)
    if jcfg.attention == "mla":
        m = jcfg.mla
        c, r = rand(rng, b, t, m.kv_lora_rank), rand(rng, b, t, m.qk_rope_head_dim)
        want = jattn.mla_decode(jp, jcfg, xd, c, r, p)
        got = tattn.mla_decode(tp, tcfg, to_torch(xd), to_torch(c), to_torch(r), to_torch(p))
    else:
        kvh, hd = jcfg.num_kv_heads, jcfg.resolved_head_dim
        kc, vc = rand(rng, b, t, kvh, hd), rand(rng, b, t, kvh, hd)
        mp = np.stack([p[:, None]] * 3) if jcfg.mrope else p
        want = jattn.gqa_decode(jp, jcfg, xd, kc, vc, mp, window=5, cache_pos=p)
        got = tattn.gqa_decode(tp, tcfg, to_torch(xd), to_torch(kc), to_torch(vc),
                               to_torch(mp), window=5, cache_pos=to_torch(p))
        cross = jattn.gqa_cross_decode(jp, jcfg, xd, kc, vc)
        assert max_err(tattn.gqa_cross_decode(tp, tcfg, to_torch(xd), to_torch(kc),
                                              to_torch(vc)), cross) < TOL
        if not jcfg.mrope:
            ring = jattn.gqa_decode(jp, jcfg, xd, kc, vc, p + 20, ring=True)
            got_ring = tattn.gqa_decode(tp, tcfg, to_torch(xd), to_torch(kc), to_torch(vc),
                                        to_torch(p + 20), ring=True)
            assert all(max_err(g, w) < TOL for g, w in zip(got_ring, ring))
    assert all(max_err(g, w) < TOL for g, w in zip(got, want))


# --- ssm: the reference's test_ssm.py checks, on the port ---


def naive_ssd(x, dt, a, b, c):
    """Direct per-step recurrence oracle: h = h*exp(dt a) + dt B x."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    bb = torch.repeat_interleave(b, rep, dim=2)
    cc = torch.repeat_interleave(c, rep, dim=2)
    state = torch.zeros((bs, h, p, n))
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a[None])  # (B, H)
        xt = x[:, t] * dt[:, t][..., None]
        state = state * decay[..., None, None] + torch.einsum("bhp,bhn->bhpn", xt, bb[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cc[:, t]))
    return torch.stack(ys, dim=1), state


def _ssd_inputs(seed, bs, s, h, p, g, n):
    r = np.random.default_rng(seed)
    x = to_torch(rand(r, bs, s, h, p))
    dt = torch.nn.functional.softplus(to_torch(rand(r, bs, s, h)))
    a = -torch.exp(to_torch(rand(r, h)) * 0.3)
    b = to_torch(rand(r, bs, s, g, n)) * 0.5
    c = to_torch(rand(r, bs, s, g, n)) * 0.5
    return x, dt, a, b, c


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 1000), st.sampled_from([4, 8]), st.sampled_from([8, 16]))
def test_chunked_ssd_equals_naive(seed, chunk, seqlen):
    x, dt, a, b, c = _ssd_inputs(seed, 2, seqlen, 4, 8, 2, 8)
    y_chunk, final_chunk = tssm.ssd_chunked(x, dt, a, b, c, chunk)
    y_naive, final_naive = naive_ssd(x, dt, a, b, c)
    np.testing.assert_allclose(y_chunk.numpy(), y_naive.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(final_chunk.numpy(), final_naive.numpy(), rtol=1e-4, atol=1e-4)


def test_initial_state_carries():
    """ssd(x, h0) == ssd over a longer sequence split at the boundary."""
    s1 = 16
    x, dt, a, b, c = _ssd_inputs(0, 1, 32, 2, 4, 1, 4)
    y_full, final_full = tssm.ssd_chunked(x, dt, a, b, c, 8)
    y1, h1 = tssm.ssd_chunked(x[:, :s1], dt[:, :s1], a, b[:, :s1], c[:, :s1], 8)
    y2, h2 = tssm.ssd_chunked(x[:, s1:], dt[:, s1:], a, b[:, s1:], c[:, s1:], 8, h0=h1)
    np.testing.assert_allclose(y_full[:, s1:].numpy(), y2.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(final_full.numpy(), h2.numpy(), rtol=1e-4, atol=1e-4)


def test_block_forward_decode_equivalence():
    """Full block: prefill then per-token decode == one long forward."""
    cfg = tregistry.get("mamba2-370m").reduced()
    params = tssm.init_ssm_block(torch.Generator().manual_seed(0), cfg, device="cpu")
    B, S = 2, 12
    u = torch.randn((B, S, cfg.d_model), generator=torch.Generator().manual_seed(1)) * 0.5
    y_full, state_full = tssm.ssm_forward(params, cfg, u)
    state = tssm.init_state(cfg, B, device="cpu")
    ys = []
    for t in range(S):
        y_t, state = tssm.ssm_decode(params, cfg, u[:, t: t + 1], state)
        ys.append(y_t)
    y_seq = torch.cat(ys, dim=1)
    np.testing.assert_allclose(y_full.numpy(), y_seq.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(state_full.ssd.numpy(), state.ssd.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("seqlen,chunk", [(16, 8), (32, 32), (24, 8)])
def test_ssd_chunked_and_ssm_block_match_reference(seqlen, chunk):
    """ssd_chunked with a carried state at the reference's SSD tolerance
    (1e-4, tests/test_ssm.py: unit-normal inputs grow the state past 1);
    the block's forward, with its conv tails, and one decode step at 1e-5."""
    x, dt, a, b, c = _ssd_inputs(seqlen, 2, seqlen, 4, 8, 2, 8)
    h0 = to_torch(rand(np.random.default_rng(5), 2, 4, 8, 8))
    want = jax.jit(jssm.ssd_chunked, static_argnums=5)(
        *(x.numpy() for x in (x, dt, a, b, c)), chunk, h0.numpy())
    got = tssm.ssd_chunked(x, dt, a, b, c, chunk, h0)
    assert max(max_err(g, w) for g, w in zip(got, want)) < 1e-4
    jcfg, tcfg = jregistry.get("mamba2-370m").reduced(), tregistry.get("mamba2-370m").reduced()
    jp = jssm.init_ssm_block(jax.random.PRNGKey(3), jcfg)
    tp = jax.tree_util.tree_map(to_torch, jp)
    forward = jax.jit(lambda p, u: jssm.ssm_forward(p, jcfg, u))
    decode = jax.jit(lambda p, u, st: jssm.ssm_decode(p, jcfg, u, st))
    for s in (1, 3, seqlen + 5):  # shorter than the conv window, and a padded chunk
        u = rand(np.random.default_rng(s), 2, s, jcfg.d_model, scale=0.5)
        (jy, jst), (ty, tst) = forward(jp, u), tssm.ssm_forward(tp, tcfg, to_torch(u))
        assert max_err(ty, jy) < TOL
        assert all(max_err(g, w) < TOL for g, w in zip(tst, jst))
        jy, jst2 = decode(jp, u[:, :1], jst)
        ty, tst2 = tssm.ssm_decode(tp, tcfg, to_torch(u[:, :1]), tst)
        assert max_err(ty, jy) < TOL and all(max_err(g, w) < TOL for g, w in zip(tst2, jst2))


# --- moe: the reference's test_moe.py checks, on the port ---


def _cfg(impl="dense", capacity=8.0, registry=tregistry):
    cfg = registry.get("mixtral-8x7b").reduced()
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, impl=impl, capacity_factor=capacity))


def _moe_params(cfg, seed=0):
    return tmoe.init_moe(torch.Generator().manual_seed(seed), cfg, device="cpu")


def _normal(seed, *shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def test_dropping_matches_dense_when_capacity_ample():
    cfg_dense = _cfg("dense")
    cfg_drop = _cfg("dropping", capacity=16.0)
    params = _moe_params(cfg_dense)
    x = _normal(1, 2, 16, cfg_dense.d_model)
    y_dense, aux_d = tmoe.moe_forward(params, cfg_dense, x)
    y_drop, aux_s = tmoe.moe_forward(params, cfg_drop, x)
    np.testing.assert_allclose(y_dense.numpy(), y_drop.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(aux_d), float(aux_s), rtol=1e-5)


def test_capacity_drops_tokens_gracefully():
    cfg = _cfg("dropping", capacity=0.01)
    params = _moe_params(cfg)
    x = _normal(1, 2, 16, cfg.d_model)
    y, aux = tmoe.moe_forward(params, cfg, x)
    assert not bool(torch.isnan(y).any())
    assert float(y.abs().mean()) < float(x.abs().mean())


def test_router_aux_loss_uniform_is_one():
    cfg = _cfg("dense")
    m = cfg.moe
    t, e = 4096, m.num_experts
    params = {"router": torch.zeros((cfg.d_model, e))}  # uniform probs
    gates, idx, aux = tmoe._router(params, m, _normal(0, t, cfg.d_model))
    assert float(aux) == pytest.approx(1.0, rel=1e-3)
    # ties go to the lower expert index first, as jax.lax.top_k
    assert torch.equal(idx, torch.arange(m.experts_per_token).expand(t, -1))


def test_gates_normalized():
    cfg = _cfg("dense")
    params = _moe_params(cfg)
    gates, idx, aux = tmoe._router(params, cfg.moe, _normal(2, 64, cfg.d_model))
    np.testing.assert_allclose(gates.sum(-1).numpy(), np.ones(64), rtol=1e-5)


@pytest.mark.parametrize("impl,capacity", [("dense", 8.0), ("dropping", 16.0),
                                           ("dropping", 1.0), ("dropping", 0.3)])
def test_moe_matches_reference(impl, capacity):
    """Dense, and the dropping dispatch at ample and at tight capacity
    (tokens dropped), equal to the reference's on the same parameters."""
    jcfg, tcfg = _cfg(impl, capacity, jregistry), _cfg(impl, capacity)
    jp = jmoe.init_moe(jax.random.PRNGKey(4), jcfg)
    tp = jax.tree_util.tree_map(to_torch, jp)
    x = rand(np.random.default_rng(6), 3, 10, jcfg.d_model)
    (jy, jaux), (ty, taux) = jmoe.moe_forward(jp, jcfg, x), tmoe.moe_forward(tp, tcfg, to_torch(x))
    assert max_err(ty, jy) < TOL and abs(float(taux) - float(jaux)) < 1e-6
    jg, ji, _ = jmoe._router(jp, jcfg.moe, x.reshape(-1, jcfg.d_model))
    tg, ti, _ = tmoe._router(tp, tcfg.moe, to_torch(x).reshape(-1, tcfg.d_model))
    assert np.array_equal(ti.numpy(), np.asarray(ji)) and max_err(tg, jg) < 1e-6


def test_expert_parallel_mesh_is_refused():
    """A mesh whose 'model' axis splits the experts, handed plain tensors,
    is refused: expert parallelism takes DTensors on the mesh (held in
    ``test_torch_multidevice.py``), and the port raises instead of quietly
    running the local path."""
    cfg = _cfg("dropping", 2.0)
    params = _moe_params(cfg)
    x = _normal(3, 1, 4, cfg.d_model)

    def shard_on(names, shape):
        hook = lambda t, name: t
        hook.mesh = types.SimpleNamespace(mesh_dim_names=names, shape=shape)
        return hook

    with pytest.raises(TypeError):
        tmoe.moe_forward(params, cfg, x, shard=shard_on(("data", "model"), (1, 2)))
    want, _ = tmoe.moe_forward(params, cfg, x)
    for names, shape in ((("data", "model"), (2, 1)), (("data",), (4,)), (("model",), (3,))):
        got, _ = tmoe.moe_forward(params, cfg, x, shard=shard_on(names, shape))
        assert torch.equal(got, want)


# --- multimodal and init ---


def test_frontend_embeds_equal_reference():
    for arch in ("qwen2-vl-7b", "seamless-m4t-large-v2"):
        for cfg_j, cfg_t in ((jregistry.get(arch).reduced(), tregistry.get(arch).reduced()),
                             (jregistry.get(arch), tregistry.get(arch))):
            spec_j, spec_t = jmm.frontend_spec(cfg_j, 2), tmm.frontend_spec(cfg_t, 2)
            assert (spec_t.shape, str(spec_t.dtype)) == (spec_j.shape, f"torch.{spec_j.dtype}")
        want = np.asarray(jmm.fake_frontend_embeds(cfg_j.reduced(), 3, seed=4))
        got = tmm.fake_frontend_embeds(cfg_t.reduced(), 3, seed=4, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        full = tmm.fake_frontend_embeds(dataclasses.replace(cfg_t.reduced(), dtype="bfloat16"),
                                        2, device="cpu")
        want = np.asarray(jmm.fake_frontend_embeds(
            dataclasses.replace(cfg_j.reduced(), dtype="bfloat16"), 2))
        assert np.array_equal(full.view(torch.int16).numpy(), want.view(np.int16))


def _shape_tree(tree):
    return [(path, tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
            for path, leaf in ttf.tree_leaves(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_and_scales(arch):
    """The port's random parameters have the reference's key tree, shapes
    and dtypes (reduced, materialized; full, on the meta device), weights
    near N(0, 0.02^2), and the reference's constants."""
    jcfg, tcfg = jregistry.get(arch).reduced(), tregistry.get(arch).reduced()
    jp = to_numpy(jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = ttf.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    want = [(p, tuple(a.shape), str(a.dtype))
            for p, a in ttf.tree_leaves(jp)]
    assert _shape_tree(tp) == want
    again = dict(ttf.tree_leaves(ttf.init_params(tcfg, torch.Generator().manual_seed(0),
                                                 device="cpu")))
    for (path, leaf), (_, ref) in zip(ttf.tree_leaves(tp), ttf.tree_leaves(jp)):
        assert torch.equal(leaf, again[path]), path  # the same seed, the same draws
        name = path.split("/")[-1]
        if name.startswith("w") or name in ("table", "router", "conv_x_w", "conv_bc_w"):
            if name in ("conv_x_w", "conv_bc_w"):
                assert abs(float(leaf.std()) - 0.5) < 0.1, path
            else:
                assert abs(float(leaf.std()) - 0.02) < 0.004, path
                assert abs(float(leaf.mean())) < 0.004, path
        else:  # norms, biases and the SSM constants are set, not drawn
            np.testing.assert_array_equal(leaf.numpy(), ref, err_msg=path)
    full_j = jax.eval_shape(lambda: jtf.param_shapes(jregistry.get(arch)))
    full_t = ttf.param_shapes(tregistry.get(arch))
    assert all(leaf.device.type == "meta" for _, leaf in ttf.tree_leaves(full_t))
    assert _shape_tree(full_t) == [(p, tuple(a.shape), str(a.dtype))
                                   for p, a in ttf.tree_leaves(_as_dict(full_j))]


def _as_dict(tree):
    """A reference pytree of ShapeDtypeStructs as nested dicts."""
    if isinstance(tree, dict):
        return {k: _as_dict(v) for k, v in tree.items()}
    return tree


def test_params_from_numpy_checks_the_tree():
    jcfg, tcfg, jp, tp = reference_params("gemma-2b-reduced")
    tree = to_numpy(jp)
    for path, leaf in ttf.tree_leaves(tp):
        ref = tree
        for k in path.split("/"):
            ref = ref[k]
        np.testing.assert_array_equal(leaf.numpy(), ref)
    bad = dict(tree, extra={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        ttf.params_from_numpy(tcfg, bad, device="cpu")
    bad = dict(tree, final_norm={"scale": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="final_norm/scale"):
        ttf.params_from_numpy(tcfg, bad, device="cpu")
    bad = dict(tree, final_norm={"scale": tree["final_norm"]["scale"].astype(np.float64)})
    with pytest.raises(ValueError, match="float64"):
        ttf.params_from_numpy(tcfg, bad, device="cpu")
    # bfloat16 leaves carry bit for bit
    bcfg_j = dataclasses.replace(jcfg, dtype="bfloat16")
    bcfg_t = dataclasses.replace(tcfg, dtype="bfloat16")
    bj = to_numpy(jtf.init_params(bcfg_j, jax.random.PRNGKey(1)))
    bt = ttf.params_from_numpy(bcfg_t, bj, device="cpu")
    table = bt["embed"]["table"]
    assert table.dtype == torch.bfloat16
    assert np.array_equal(table.view(torch.int16).numpy(), bj["embed"]["table"].view(np.int16))
