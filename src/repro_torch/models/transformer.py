"""Model assembly: init / forward / prefill / decode for all six
architecture families (dense, MoE, SSM, hybrid, audio enc-dec, VLM).

Layer stacks are stored as *stacked* parameter dicts (a leading L axis on
every leaf), the reference's layout, so a reference parameter tree
carries across leaf for leaf (``params_from_numpy``).  Where the
reference scans over that axis, the port loops over it in Python; the
per-layer window table (gemma3's local:global pattern) is read per
layer.  The zamba2 hybrid walks groups of ``shared_attn_every`` SSM
layers, with the single shared attention block (one set of weights, its
own KV cache per application) applied after each group.

The ``shard`` hook keeps this module mesh-agnostic; its default is the
identity.  ``remat`` recomputes activations in the backward pass where
the reference applies ``jax.checkpoint``: each decoder layer, each SSM
layer and each hybrid group (its SSM layers and the shared attention
block) runs under ``torch.utils.checkpoint``, with its parameters passed
in so their gradients land in the stacked leaves.  It changes no value.

Every function infers its device from its inputs; ``init_params`` and
``init_cache`` take one, and default to the card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, layers, moe, ssm

ShardFn = Callable[[torch.Tensor, str], torch.Tensor]


def _no_shard(x: torch.Tensor, name: str) -> torch.Tensor:
    return x


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def tree_map(fn, tree):
    """``fn`` over every tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict, keys sorted, paths '/'-joined."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


def _layer(stacked: Dict, i: int) -> Dict:
    """Layer i's parameters from a stacked dict."""
    return tree_map(lambda a: a[i], stacked)


# ===========================================================================
# Parameter initialization
# ===========================================================================


def _init_decoder_layer(gen, cfg: ArchConfig, dtype, device) -> Dict:
    """One decoder block (attention archs)."""
    p = {
        "attn_norm": layers.init_norm(cfg.norm, cfg.d_model, dtype, device),
        "attn": attention.init_attention(gen, cfg, dtype, device),
        "mlp_norm": layers.init_norm(cfg.norm, cfg.d_model, dtype, device),
    }
    if cfg.moe is not None:
        p["moe"] = moe.init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype, device)
    if cfg.cross_attention:
        p["cross_norm"] = layers.init_norm(cfg.norm, cfg.d_model, dtype, device)
        p["cross"] = attention.init_cross_attention(gen, cfg, dtype, device)
    return p


def _init_encoder_layer(gen, cfg: ArchConfig, dtype, device) -> Dict:
    return {
        "attn_norm": layers.init_norm(cfg.norm, cfg.d_model, dtype, device),
        "attn": attention.init_attention(gen, cfg, dtype, device),
        "mlp_norm": layers.init_norm(cfg.norm, cfg.d_model, dtype, device),
        "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype, device),
    }


def _init_ssm_layer(gen, cfg: ArchConfig, dtype, device) -> Dict:
    return {
        "norm": layers.init_norm(cfg.norm, cfg.d_model, dtype, device),
        "ssm": ssm.init_ssm_block(gen, cfg, dtype, device),
    }


def _stack(trees: List[Dict]) -> Dict:
    """Per-layer parameter dicts stacked on a leading axis, leaf by leaf."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None, *,
                device="cuda") -> Dict:
    """Random parameters in the reference's layout and dtype.  Weights are
    N(0, 0.02^2) drawn from ``generator`` (on its own device; seed 0 on
    ``device`` when None) and placed on ``device``; norms and the SSM
    constants are set as the reference sets them.  On the meta device,
    shapes and dtypes only."""
    dtype = _dtype(cfg)
    device = torch.device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    gen = generator
    params: Dict[str, Any] = {
        "embed": layers.init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, device),
        "final_norm": layers.init_norm(cfg.norm, cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {
            "w": layers._dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype, device)
        }

    if cfg.arch_type in ("dense", "moe", "vlm", "audio"):
        params["layers"] = _stack(
            [_init_decoder_layer(gen, cfg, dtype, device) for _ in range(cfg.num_layers)])
    elif cfg.arch_type in ("ssm", "hybrid"):
        params["layers"] = _stack(
            [_init_ssm_layer(gen, cfg, dtype, device) for _ in range(cfg.num_layers)])
        if cfg.arch_type == "hybrid":
            # ONE shared attention block (zamba2): attention + its own MLP
            params["shared_attn"] = _init_encoder_layer(gen, cfg, dtype, device)
    else:
        raise ValueError(cfg.arch_type)

    if cfg.encoder_layers:
        params["encoder"] = {
            "layers": _stack([_init_encoder_layer(gen, cfg, dtype, device)
                              for _ in range(cfg.encoder_layers)]),
            "final_norm": layers.init_norm(cfg.norm, cfg.d_model, dtype, device),
        }
    return params


def param_shapes(cfg: ArchConfig) -> Dict:
    """The parameter tree on the meta device: shapes and dtypes, no storage."""
    return init_params(cfg, device="meta")


def params_from_numpy(cfg: ArchConfig, tree: Dict, *, device="cuda") -> Dict:
    """The reference's parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) as the port's, on
    ``device``.  The key tree, every shape and every dtype must equal
    ``param_shapes(cfg)``'s.  bfloat16 arrays (``ml_dtypes``) are carried
    bit for bit."""
    want = dict(tree_leaves(param_shapes(cfg)))
    got = dict(tree_leaves(tree))
    if sorted(want) != sorted(got):
        raise ValueError(f"parameter keys differ: missing {sorted(set(want) - set(got))}, "
                         f"unexpected {sorted(set(got) - set(want))}")

    def convert(node, path):
        if isinstance(node, dict):
            return {k: convert(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        arr = np.array(node)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        spec = want[path]
        if tuple(t.shape) != tuple(spec.shape) or t.dtype != spec.dtype:
            raise ValueError(f"{path}: got {tuple(t.shape)} {t.dtype}, "
                             f"expected {tuple(spec.shape)} {spec.dtype}")
        return t.to(device)

    return convert(tree, "")


# ===========================================================================
# Embedding / head
# ===========================================================================


def _embed_tokens(cfg: ArchConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    x = layers.embed(params["embed"], tokens)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def _lm_logits(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = layers.unembed(params["embed"], x)
    else:
        logits = x @ params["lm_head"]["w"]
    return layers.softcap(logits.to(torch.float32), cfg.logit_softcap)


# ===========================================================================
# Layer bodies (shared by forward/prefill; decode versions further below)
# ===========================================================================


def _mlp_or_moe(cfg: ArchConfig, lp: Dict, h: torch.Tensor, shard: ShardFn):
    """The block's MLP (or MoE) output and its aux loss."""
    if cfg.moe is not None:
        return moe.moe_forward(lp["moe"], cfg, h, shard=shard)
    return layers.mlp(lp["mlp"], h, cfg.mlp), None


def _decoder_layer_fwd(
    cfg: ArchConfig,
    lp: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    window,
    memory: Optional[torch.Tensor],
    shard: ShardFn,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (x_out, aux_loss or None)."""
    h = layers.apply_norm(cfg.norm, lp["attn_norm"], x)
    if cfg.attention == "mla":
        attn_out = attention.mla_forward(lp["attn"], cfg, h, positions)
    else:
        attn_out = attention.gqa_forward(lp["attn"], cfg, h, positions, window=window)
    x = x + shard(attn_out, "activation")
    if cfg.cross_attention and memory is not None:
        h = layers.apply_norm(cfg.norm, lp["cross_norm"], x)
        qpos = positions if positions.ndim == 1 else positions[0, 0]
        cross_out = attention.gqa_forward(
            lp["cross"], cfg, h, qpos, window=0, causal=False,
            kv_override=(memory, memory),
        )
        x = x + shard(cross_out, "activation")
    h = layers.apply_norm(cfg.norm, lp["mlp_norm"], x)
    mlp_out, aux = _mlp_or_moe(cfg, lp, h, shard)
    x = x + shard(mlp_out, "activation")
    return x, aux


def _ssm_layer_fwd(cfg, lp, x, h0, shard: ShardFn):
    h = layers.apply_norm(cfg.norm, lp["norm"], x)
    y, state = ssm.ssm_forward(lp["ssm"], cfg, h, h0)
    return x + shard(y, "activation"), state


def _shared_attn_fwd(cfg, sp, x, positions, shard: ShardFn):
    h = layers.apply_norm(cfg.norm, sp["attn_norm"], x)
    attn_out = attention.gqa_forward(sp["attn"], cfg, h, positions, window=0)
    x = x + shard(attn_out, "activation")
    h = layers.apply_norm(cfg.norm, sp["mlp_norm"], x)
    x = x + shard(layers.mlp(sp["mlp"], h, cfg.mlp), "activation")
    return x


# ===========================================================================
# Forward (train / prefill trunk): tokens -> final hidden states
# ===========================================================================


def _run_encoder(cfg, params, enc_in, shard: ShardFn):
    """Bidirectional encoder over precomputed frame embeddings."""
    pos = torch.arange(enc_in.shape[1], dtype=torch.int32, device=enc_in.device)
    x = enc_in
    for i in range(cfg.encoder_layers):
        lp = _layer(params["encoder"]["layers"], i)
        h = layers.apply_norm(cfg.norm, lp["attn_norm"], x)
        a = attention.gqa_forward(lp["attn"], cfg, h, pos, window=0, causal=False)
        x = x + shard(a, "activation")
        h = layers.apply_norm(cfg.norm, lp["mlp_norm"], x)
        x = x + shard(layers.mlp(lp["mlp"], h, cfg.mlp), "activation")
    return layers.apply_norm(cfg.norm, params["encoder"]["final_norm"], x)


def _embed_inputs(cfg, params, tokens, frontend_embeds, encoder_tokens, shard):
    """Token embeddings (with any frontend embeddings prepended) and the
    encoder memory, if any."""
    x = _embed_tokens(cfg, params, tokens)
    memory = None
    if encoder_tokens is not None:
        memory = _run_encoder(cfg, params, encoder_tokens.to(x.dtype), shard)
    if frontend_embeds is not None and encoder_tokens is None:
        # VLM / audio-LM: patch embeddings prepended to the text stream
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    return shard(x, "activation"), memory


def _ssm_groups(cfg: ArchConfig):
    """The hybrid's layer indices, one list per shared-attention group."""
    k = cfg.shared_attn_every
    return [list(range(g * k, (g + 1) * k)) for g in range(cfg.num_layers // k)]


def trunk(
    cfg: ArchConfig,
    params: Dict,
    tokens: torch.Tensor,  # (B, S)
    *,
    positions: Optional[torch.Tensor] = None,  # (S,) or mrope (3, B, S)
    frontend_embeds: Optional[torch.Tensor] = None,  # (B, F, d)
    encoder_tokens: Optional[torch.Tensor] = None,  # (B, F, d) audio frames
    shard: ShardFn = _no_shard,
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embeds, runs the layer stack, final-norms. Returns (hidden, aux)."""
    x, memory = _embed_inputs(cfg, params, tokens, frontend_embeds, encoder_tokens, shard)
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(body, *args):
        if remat:
            return torch.utils.checkpoint.checkpoint(body, *args, use_reentrant=False)
        return body(*args)

    if cfg.arch_type in ("dense", "moe", "vlm", "audio"):
        for i, win in enumerate(cfg.layer_window_sizes()):
            body = lambda lp, h, win=win: _decoder_layer_fwd(cfg, lp, h, positions, win,
                                                             memory, shard)
            x, a = run(body, _layer(params["layers"], i), x)
            if a is not None:
                aux_total = aux_total + a
    elif cfg.arch_type == "ssm":
        body = lambda lp, h: _ssm_layer_fwd(cfg, lp, h, None, shard)[0]
        for i in range(cfg.num_layers):
            x = run(body, _layer(params["layers"], i), x)
    elif cfg.arch_type == "hybrid":

        def group_body(lps, sp, h):
            for lp in lps:
                h, _ = _ssm_layer_fwd(cfg, lp, h, None, shard)
            return _shared_attn_fwd(cfg, sp, h, positions, shard)

        for group in _ssm_groups(cfg):
            x = run(group_body, [_layer(params["layers"], i) for i in group],
                    params["shared_attn"], x)
    else:
        raise ValueError(cfg.arch_type)

    return layers.apply_norm(cfg.norm, params["final_norm"], x), aux_total


def forward(cfg: ArchConfig, params: Dict, batch: Dict, *,
            shard: ShardFn = _no_shard, remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward to logits. batch keys per configs.shapes.token_inputs."""
    hidden, aux = trunk(
        cfg,
        params,
        batch["tokens"],
        positions=batch.get("positions"),
        frontend_embeds=batch.get("frontend_embeds"),
        encoder_tokens=batch.get("encoder_tokens"),
        shard=shard,
        remat=remat,
    )
    logits = _lm_logits(cfg, params, hidden)
    return shard(logits, "logits"), aux


def loss_fn(cfg: ArchConfig, params: Dict, batch: Dict, *,
            shard: ShardFn = _no_shard, remat: bool = True) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy (+ MoE aux). Frontend tokens, if any, are
    excluded from the loss (they precede the text stream)."""
    logits, aux = forward(cfg, params, batch, shard=shard, remat=remat)
    targets = batch["targets"]
    n_text = targets.shape[1]
    logits = logits[:, -n_text:]  # drop frontend positions
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].to(torch.long))[..., 0]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(nll)
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    aux_w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0
    total = loss + aux_w * aux
    return total, {"ce_loss": loss, "aux_loss": aux}


# ===========================================================================
# KV / state caches
# ===========================================================================


class Cache(NamedTuple):
    """Decode-time state for every family (unused fields are None)."""

    position: torch.Tensor  # (B,) next write position
    attn_k: Optional[torch.Tensor] = None  # (L, B, T, KV, D)
    attn_v: Optional[torch.Tensor] = None
    # pattern-ring mode: windowed layers keep ring buffers of length
    # `window`; attn_k/attn_v then hold only the global layers' caches.
    local_k: Optional[torch.Tensor] = None  # (L_local, B, W, KV, D)
    local_v: Optional[torch.Tensor] = None
    mla_c: Optional[torch.Tensor] = None  # (L, B, T, R)
    mla_rope: Optional[torch.Tensor] = None  # (L, B, T, P)
    ssm_conv_x: Optional[torch.Tensor] = None  # (L, B, d_conv-1, d_inner)
    ssm_conv_bc: Optional[torch.Tensor] = None  # (L, B, d_conv-1, 2GN)
    ssm_state: Optional[torch.Tensor] = None  # (L, B, H, P, N)
    shared_k: Optional[torch.Tensor] = None  # (G, B, T, KV, D) zamba2
    shared_v: Optional[torch.Tensor] = None
    cross_k: Optional[torch.Tensor] = None  # (L, B, F, KV, D) enc-dec
    cross_v: Optional[torch.Tensor] = None


def _pattern_split(cfg: ArchConfig):
    """(local_layer_indices, global_layer_indices) per the window table."""
    wins = cfg.layer_window_sizes()
    local = [i for i, w in enumerate(wins) if w > 0]
    glob = [i for i, w in enumerate(wins) if w == 0]
    return local, glob


def init_cache(
    cfg: ArchConfig, batch: int, max_len: int, ring: bool = False, *, device="cuda"
) -> Cache:
    dtype = _dtype(cfg)
    l = cfg.num_layers
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    pos = zeros(batch, dt=torch.int32)
    if cfg.arch_type in ("ssm", "hybrid"):
        s, d_inner, n_heads, bc_ch = ssm._dims(cfg)
        cache = Cache(
            position=pos,
            ssm_conv_x=zeros(l, batch, s.d_conv - 1, d_inner),
            ssm_conv_bc=zeros(l, batch, s.d_conv - 1, bc_ch),
            ssm_state=zeros(l, batch, n_heads, s.head_dim, s.d_state, dt=torch.float32),
        )
        if cfg.arch_type == "hybrid":
            g = cfg.num_layers // cfg.shared_attn_every
            cache = cache._replace(shared_k=zeros(g, batch, max_len, kvh, hd),
                                   shared_v=zeros(g, batch, max_len, kvh, hd))
        return cache
    if cfg.attention == "mla":
        m = cfg.mla
        return Cache(
            position=pos,
            mla_c=zeros(l, batch, max_len, m.kv_lora_rank),
            mla_rope=zeros(l, batch, max_len, m.qk_rope_head_dim),
        )
    if ring and cfg.num_heads and any(w > 0 for w in cfg.layer_window_sizes()):
        local, glob = _pattern_split(cfg)
        w = min(cfg.sliding_window, max_len)
        return Cache(
            position=pos,
            local_k=zeros(len(local), batch, w, kvh, hd),
            local_v=zeros(len(local), batch, w, kvh, hd),
            attn_k=zeros(len(glob), batch, max_len, kvh, hd) if glob else None,
            attn_v=zeros(len(glob), batch, max_len, kvh, hd) if glob else None,
        )
    cache = Cache(
        position=pos,
        attn_k=zeros(l, batch, max_len, kvh, hd),
        attn_v=zeros(l, batch, max_len, kvh, hd),
    )
    if cfg.cross_attention:
        f = cfg.frontend_tokens
        cache = cache._replace(cross_k=zeros(l, batch, f, kvh, hd),
                               cross_v=zeros(l, batch, f, kvh, hd))
    return cache


def cache_shapes(cfg: ArchConfig, batch: int, max_len: int, ring: bool = False) -> Cache:
    """The cache on the meta device: shapes and dtypes, no storage."""
    return init_cache(cfg, batch, max_len, ring, device="meta")


def dynamic_update_slice(operand: torch.Tensor, update: torch.Tensor,
                         starts) -> torch.Tensor:
    """``jax.lax.dynamic_update_slice``: ``update`` written into a copy of
    ``operand`` at ``starts``.  A negative start counts from the end once;
    then each start is clamped so the update fits."""
    if update.ndim != operand.ndim or any(u > o for u, o in zip(update.shape, operand.shape)):
        raise ValueError(f"update {tuple(update.shape)} does not fit in {tuple(operand.shape)}")
    out = operand.clone()
    index = []
    for st, u, o in zip(starts, update.shape, operand.shape):
        st = int(st) + (o if int(st) < 0 else 0)
        st = min(max(st, 0), o - u)
        index.append(slice(st, st + u))
    out[tuple(index)] = update.to(operand.dtype)
    return out


# ===========================================================================
# Decode step
# ===========================================================================


def _decode_block(cfg, lp, h, pos, mpos, shard, *, kc=None, vc=None, window=0,
                  ring=False, mla=None, cross=None):
    """One decoder block on one token.  Returns (h, kc, vc, mla caches)."""
    hh = layers.apply_norm(cfg.norm, lp["attn_norm"], h)
    if cfg.attention == "mla":
        a, cc, rc = attention.mla_decode(lp["attn"], cfg, hh, mla[0], mla[1], pos)
        mla = (cc, rc)
    else:
        a, kc, vc = attention.gqa_decode(lp["attn"], cfg, hh, kc, vc, mpos, window=window,
                                         cache_pos=pos, ring=ring)
    h = h + shard(a, "decode_activation")
    if cross is not None:
        hh = layers.apply_norm(cfg.norm, lp["cross_norm"], h)
        h = h + shard(attention.gqa_cross_decode(lp["cross"], cfg, hh, *cross),
                      "decode_activation")
    hh = layers.apply_norm(cfg.norm, lp["mlp_norm"], h)
    m, _ = _mlp_or_moe(cfg, lp, hh, shard)
    return h + shard(m, "decode_activation"), kc, vc, mla


def _ssm_decode_layer(cfg, lp, h, cache: Cache, i: int, shard):
    """SSM layer i on one token; returns (h, its new (conv_x, conv_bc, ssd))."""
    hn = layers.apply_norm(cfg.norm, lp["norm"], h)
    y, new = ssm.ssm_decode(lp["ssm"], cfg, hn, ssm.SSMState(
        cache.ssm_conv_x[i], cache.ssm_conv_bc[i], cache.ssm_state[i]))
    return h + shard(y, "decode_activation"), new


def decode_step(
    cfg: ArchConfig,
    params: Dict,
    cache: Cache,
    tokens: torch.Tensor,  # (B, 1)
    *,
    positions: Optional[torch.Tensor] = None,  # mrope (3, B, 1)
    shard: ShardFn = _no_shard,
) -> Tuple[torch.Tensor, Cache]:
    """One serving step: consume ONE token per sequence, emit logits for
    the next, and return the updated cache (the one passed in is left as
    it was). When the cache was built with ``ring=True`` (``local_k``
    present), sliding-window layers use ring buffers of length `window`."""
    x = _embed_tokens(cfg, params, tokens)
    x = shard(x, "decode_activation")
    pos = cache.position  # (B,)
    mpos = positions if cfg.mrope else pos

    if cache.local_k is not None:
        return _decode_step_pattern_ring(cfg, params, cache, x, pos, shard)

    if cfg.arch_type in ("dense", "moe", "vlm", "audio"):
        nk, nv, nc, nr = [], [], [], []
        for i, win in enumerate(cfg.layer_window_sizes()):
            lp = _layer(params["layers"], i)
            x, kc, vc, mla = _decode_block(
                cfg, lp, x, pos, mpos, shard,
                kc=None if cache.attn_k is None else cache.attn_k[i],
                vc=None if cache.attn_v is None else cache.attn_v[i],
                window=win,
                mla=None if cache.mla_c is None else (cache.mla_c[i], cache.mla_rope[i]),
                cross=(cache.cross_k[i], cache.cross_v[i]) if cfg.cross_attention else None,
            )
            if cache.attn_k is not None:
                nk.append(kc)
                nv.append(vc)
            if cache.mla_c is not None:
                nc.append(mla[0])
                nr.append(mla[1])
        cache = cache._replace(
            attn_k=torch.stack(nk) if nk else cache.attn_k,
            attn_v=torch.stack(nv) if nv else cache.attn_v,
            mla_c=torch.stack(nc) if nc else cache.mla_c,
            mla_rope=torch.stack(nr) if nr else cache.mla_rope,
        )

    elif cfg.arch_type in ("ssm", "hybrid"):
        groups = (_ssm_groups(cfg) if cfg.arch_type == "hybrid"
                  else [list(range(cfg.num_layers))])
        states, sks, svs = [], [], []
        for g, group in enumerate(groups):
            for i in group:
                x, new = _ssm_decode_layer(cfg, _layer(params["layers"], i), x, cache, i, shard)
                states.append(new)
            if cfg.arch_type == "hybrid":
                sp = params["shared_attn"]
                hh = layers.apply_norm(cfg.norm, sp["attn_norm"], x)
                a, sk, sv = attention.gqa_decode(sp["attn"], cfg, hh, cache.shared_k[g],
                                                 cache.shared_v[g], pos, window=0)
                x = x + shard(a, "decode_activation")
                hh = layers.apply_norm(cfg.norm, sp["mlp_norm"], x)
                x = x + shard(layers.mlp(sp["mlp"], hh, cfg.mlp), "decode_activation")
                sks.append(sk)
                svs.append(sv)
        cache = cache._replace(
            ssm_conv_x=torch.stack([s.conv_x for s in states]),
            ssm_conv_bc=torch.stack([s.conv_bc for s in states]),
            ssm_state=torch.stack([s.ssd for s in states]),
        )
        if sks:
            cache = cache._replace(shared_k=torch.stack(sks), shared_v=torch.stack(svs))
    else:
        raise ValueError(cfg.arch_type)

    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    logits = _lm_logits(cfg, params, x)
    cache = cache._replace(position=cache.position + 1)
    return shard(logits, "decode_logits"), cache


def _decode_step_pattern_ring(
    cfg: ArchConfig, params: Dict, cache: Cache, x, pos, shard: ShardFn
) -> Tuple[torch.Tensor, Cache]:
    """Decode with ring buffers on windowed layers.

    The layers run in their original order; a local (windowed) layer reads
    and writes the next ring cache in local order, a global layer the next
    full cache in global order. For uniform-window archs (starcoder2,
    mixtral) there are no global layers."""
    new_local_k, new_local_v, new_glob_k, new_glob_v = [], [], [], []
    h = x
    for i, win in enumerate(cfg.layer_window_sizes()):
        lp = _layer(params["layers"], i)
        if win > 0:
            li = len(new_local_k)
            h, kc, vc, _ = _decode_block(cfg, lp, h, pos, pos, shard, kc=cache.local_k[li],
                                         vc=cache.local_v[li], window=0, ring=True)
            new_local_k.append(kc)
            new_local_v.append(vc)
        else:
            gi = len(new_glob_k)
            h, kc, vc, _ = _decode_block(cfg, lp, h, pos, pos, shard, kc=cache.attn_k[gi],
                                         vc=cache.attn_v[gi], window=0)
            new_glob_k.append(kc)
            new_glob_v.append(vc)

    cache = cache._replace(
        local_k=torch.stack(new_local_k),
        local_v=torch.stack(new_local_v),
        attn_k=torch.stack(new_glob_k) if new_glob_k else cache.attn_k,
        attn_v=torch.stack(new_glob_v) if new_glob_v else cache.attn_v,
        position=cache.position + 1,
    )
    h = layers.apply_norm(cfg.norm, params["final_norm"], h)
    logits = _lm_logits(cfg, params, h)
    return shard(logits, "decode_logits"), cache


# ===========================================================================
# Prefill: process a full prompt, return cache ready for decode
# ===========================================================================


def prefill(
    cfg: ArchConfig,
    params: Dict,
    tokens: torch.Tensor,  # (B, S)
    max_len: int,
    *,
    positions: Optional[torch.Tensor] = None,
    frontend_embeds: Optional[torch.Tensor] = None,
    encoder_tokens: Optional[torch.Tensor] = None,
    shard: ShardFn = _no_shard,
) -> Tuple[torch.Tensor, Cache]:
    """Returns (last-position logits (B, V), populated cache)."""
    b = tokens.shape[0]
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    x, memory = _embed_inputs(cfg, params, tokens, frontend_embeds, encoder_tokens, shard)
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)

    if cfg.arch_type in ("dense", "moe", "vlm", "audio"):
        new_kvs, cks, cvs = [], [], []
        for i, win in enumerate(cfg.layer_window_sizes()):
            lp = _layer(params["layers"], i)
            hh = layers.apply_norm(cfg.norm, lp["attn_norm"], x)
            if cfg.attention == "mla":
                a = attention.mla_forward(lp["attn"], cfg, hh, positions)
                new_kvs.append(attention.mla_prefill_cache(lp["attn"], cfg, hh, positions))
            else:
                a = attention.gqa_forward(lp["attn"], cfg, hh, positions, window=win)
                new_kvs.append(attention.gqa_prefill_kv(lp["attn"], cfg, hh, positions))
            x = x + shard(a, "activation")
            if cfg.cross_attention:
                hh = layers.apply_norm(cfg.norm, lp["cross_norm"], x)
                qpos = positions if positions.ndim == 1 else positions[0, 0]
                cr = attention.gqa_forward(
                    lp["cross"], cfg, hh, qpos, window=0, causal=False,
                    kv_override=(memory, memory),
                )
                x = x + shard(cr, "activation")
                kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
                f = memory.shape[1]
                cks.append((memory @ lp["cross"]["w_k"]).reshape(b, f, kvh, hd))
                cvs.append((memory @ lp["cross"]["w_v"]).reshape(b, f, kvh, hd))
            hh = layers.apply_norm(cfg.norm, lp["mlp_norm"], x)
            m, _ = _mlp_or_moe(cfg, lp, hh, shard)
            x = x + shard(m, "activation")

        first = torch.stack([kv[0] for kv in new_kvs])  # (L, B, S, ...)
        second = torch.stack([kv[1] for kv in new_kvs])
        starts = (0,) * first.ndim
        if cfg.attention == "mla":
            cache = cache._replace(mla_c=dynamic_update_slice(cache.mla_c, first, starts),
                                   mla_rope=dynamic_update_slice(cache.mla_rope, second, starts))
        else:
            cache = cache._replace(attn_k=dynamic_update_slice(cache.attn_k, first, starts),
                                   attn_v=dynamic_update_slice(cache.attn_v, second, starts))
        if cfg.cross_attention:
            cache = cache._replace(cross_k=torch.stack(cks).to(_dtype(cfg)),
                                   cross_v=torch.stack(cvs).to(_dtype(cfg)))

    elif cfg.arch_type in ("ssm", "hybrid"):
        groups = (_ssm_groups(cfg) if cfg.arch_type == "hybrid"
                  else [list(range(cfg.num_layers))])
        states, sks, svs = [], [], []
        for group in groups:
            for i in group:
                lp = _layer(params["layers"], i)
                hn = layers.apply_norm(cfg.norm, lp["norm"], x)
                y, st = ssm.ssm_forward(lp["ssm"], cfg, hn)
                x = x + shard(y, "activation")
                states.append(st)
            if cfg.arch_type == "hybrid":
                sp = params["shared_attn"]
                hh = layers.apply_norm(cfg.norm, sp["attn_norm"], x)
                a = attention.gqa_forward(sp["attn"], cfg, hh, positions, window=0)
                sk, sv = attention.gqa_prefill_kv(sp["attn"], cfg, hh, positions)
                x = x + shard(a, "activation")
                hh = layers.apply_norm(cfg.norm, sp["mlp_norm"], x)
                x = x + shard(layers.mlp(sp["mlp"], hh, cfg.mlp), "activation")
                sks.append(sk)
                svs.append(sv)
        cache = cache._replace(
            ssm_conv_x=torch.stack([st.conv_x for st in states]),
            ssm_conv_bc=torch.stack([st.conv_bc for st in states]),
            ssm_state=torch.stack([st.ssd for st in states]),
        )
        if sks:
            k_all, v_all = torch.stack(sks), torch.stack(svs)
            cache = cache._replace(
                shared_k=dynamic_update_slice(cache.shared_k, k_all, (0,) * 5),
                shared_v=dynamic_update_slice(cache.shared_v, v_all, (0,) * 5),
            )
    else:
        raise ValueError(cfg.arch_type)

    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    logits = _lm_logits(cfg, params, x[:, -1])
    cache = cache._replace(position=torch.full((b,), s, dtype=torch.int32, device=x.device))
    return logits, cache
