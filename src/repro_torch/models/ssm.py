"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060].

Training/prefill uses the chunked SSD algorithm (Listing 1 of the Mamba2
paper): within-chunk quadratic attention-like term + inter-chunk
recurrence on the (heads, head_dim, d_state) state; the recurrence over
chunk boundaries is a Python loop where the reference scans.

Decode keeps the constant-size recurrent state:
    h <- h * exp(dt * A) + dt * (B outer x);   y = C . h + D * x
so the inter-step payload is O(1) for SSMs.

The projections are separate ([z, x, B, C, dt] not packed) and the
depthwise conv is split into an x-conv and a bc-conv, the reference's
layout, so its parameters carry across leaf for leaf.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, layers


class SSMState(NamedTuple):
    conv_x: torch.Tensor  # (B, d_conv - 1, d_inner)
    conv_bc: torch.Tensor  # (B, d_conv - 1, 2 * G * N)
    ssd: torch.Tensor  # (B, H, P, N) recurrent state (f32)


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    bc_ch = 2 * s.n_groups * s.d_state
    return s, d_inner, n_heads, bc_ch


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) with no linear cut-over."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_ssm_block(generator, cfg: ArchConfig, dtype=torch.float32,
                   device="cuda") -> Dict:
    s, d_inner, n_heads, bc_ch = _dims(cfg)
    d = cfg.d_model
    w = lambda shape, scale=None: layers._dense_init(generator, shape, dtype, device, scale)
    f32 = torch.float32
    return {
        "w_z": w((d, d_inner)),
        "w_x": w((d, d_inner)),
        "w_bc": w((d, bc_ch)),
        "w_dt": w((d, n_heads)),
        "conv_x_w": w((s.d_conv, d_inner), 0.5),
        "conv_x_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "conv_bc_w": w((s.d_conv, bc_ch), 0.5),
        "conv_bc_b": torch.zeros((bc_ch,), dtype=dtype, device=device),
        # A in (-exp) parameterization: A = -exp(a_log), init near -1.
        "a_log": torch.zeros((n_heads,), dtype=f32, device=device),
        "dt_bias": torch.full((n_heads,), -2.0, dtype=f32, device=device),  # softplus ~ 0.12
        "d_skip": torch.ones((n_heads,), dtype=f32, device=device),
        "norm": layers.init_rmsnorm(d_inner, dtype, device),
        "w_out": w((d_inner, d)),
    }


def _causal_conv(w, bias, x: torch.Tensor, d_conv: int) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) + SiLU."""
    pad = torch.cat([attention.zeros_axis1(x, d_conv - 1), x], dim=1)
    out = pad[:, 0: x.shape[1]] * w[0][None, None]
    for i in range(1, d_conv):
        out = out + pad[:, i: i + x.shape[1]] * w[i][None, None]
    return F.silu(out + bias[None, None])


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k],
    -inf above the diagonal (Mamba2 reference helper)."""
    t = x.shape[-1]
    x_cum = torch.cumsum(x, dim=-1)
    diff = x_cum[..., :, None] - x_cum[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) — already softplus'd
    a: torch.Tensor,  # (H,) negative decay rates
    b: torch.Tensor,  # (B, S, G, N)
    c: torch.Tensor,  # (B, S, G, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y (B,S,H,P), final_state (B,H,P,N))."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    rep = h // g
    f32 = torch.float32

    x_f = x.to(f32)
    dt_f = dt.to(f32)
    da = dt_f * a[None, None, :]  # (B, S, H) log-decay per step
    xb = x_f * dt_f[..., None]  # fold dt into the input

    xc = xb.reshape(bs, nc, chunk, h, p)
    dac = da.reshape(bs, nc, chunk, h)
    bc = torch.repeat_interleave(b, rep, dim=2).reshape(bs, nc, chunk, h, n).to(f32)
    cc = torch.repeat_interleave(c, rep, dim=2).reshape(bs, nc, chunk, h, n).to(f32)

    # ---- intra-chunk (quadratic within chunk) ----
    l_mat = torch.exp(_segsum(dac.permute(0, 1, 3, 2)))  # (B, nc, H, T, T)
    scores = torch.einsum("bzihn,bzjhn->bzhij", cc, bc)  # (B, nc, H, T, T)
    y_diag = torch.einsum("bzhij,bzjhp->bzihp", scores * l_mat, xc)

    # ---- chunk states: decay-to-end weighted sum of inputs ----
    dac_cum = torch.cumsum(dac, dim=2)
    decay_to_end = torch.exp(dac_cum[:, :, -1:, :] - dac_cum)  # (B,nc,T,H)
    states = torch.einsum("bzthn,bzth,bzthp->bzhpn", bc, decay_to_end, xc)  # (B,nc,H,P,N)

    # ---- inter-chunk recurrence over chunk boundary states ----
    chunk_decay = torch.exp(torch.sum(dac, dim=2))  # (B, nc, H)
    state = (torch.zeros((bs, h, p, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    h_in = []  # the state *entering* each chunk
    for z in range(nc):
        h_in.append(state)
        state = state * chunk_decay[:, z][..., None, None] + states[:, z]
    h_in = torch.stack(h_in, dim=1)  # (B, nc, H, P, N)

    # ---- contribution of the carried state to each position ----
    decay_from_start = torch.exp(dac_cum)  # (B, nc, T, H)
    y_off = torch.einsum("bzthn,bzhpn,bzth->bzthp", cc, h_in, decay_from_start)
    y = (y_diag + y_off).reshape(bs, s, h, p)
    return y.to(x.dtype), state


def init_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
               device="cuda") -> SSMState:
    s, d_inner, n_heads, bc_ch = _dims(cfg)
    return SSMState(
        conv_x=torch.zeros((batch, s.d_conv - 1, d_inner), dtype=dtype, device=device),
        conv_bc=torch.zeros((batch, s.d_conv - 1, bc_ch), dtype=dtype, device=device),
        ssd=torch.zeros((batch, n_heads, s.head_dim, s.d_state), dtype=torch.float32,
                        device=device),
    )


def ssm_forward(
    params: Dict,
    cfg: ArchConfig,
    u: torch.Tensor,  # (B, S, d_model)
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, SSMState]:
    """Train/prefill pass. Returns (y (B,S,d_model), final SSMState) —
    the state hands off to ``ssm_decode`` for serving."""
    s, d_inner, n_heads, bc_ch = _dims(cfg)
    bsz, seq, _ = u.shape
    z = u @ params["w_z"]
    x_raw = u @ params["w_x"]
    bc_raw = u @ params["w_bc"]
    dt = u @ params["w_dt"]

    # conv windows for decode handoff: last (d_conv - 1) raw inputs
    def tail(arr):
        if seq < s.d_conv - 1:
            arr = torch.cat([attention.zeros_axis1(arr, s.d_conv - 1 - seq), arr], dim=1)
        return arr[:, -(s.d_conv - 1):]

    conv_x_tail = tail(x_raw)
    conv_bc_tail = tail(bc_raw)

    x = _causal_conv(params["conv_x_w"], params["conv_x_b"], x_raw, s.d_conv)
    bc = _causal_conv(params["conv_bc_w"], params["conv_bc_b"], bc_raw, s.d_conv)

    gn = s.n_groups * s.d_state
    x = x.reshape(bsz, seq, n_heads, s.head_dim)
    b = bc[..., :gn].reshape(bsz, seq, s.n_groups, s.d_state)
    c = bc[..., gn:].reshape(bsz, seq, s.n_groups, s.d_state)
    dt_act = _softplus(dt.to(torch.float32) + params["dt_bias"])
    a = -torch.exp(params["a_log"])

    chunk = s.chunk_size
    pad = (-seq) % chunk
    if pad:
        x, b, c, dt_act = (attention.pad_axis1(t, pad) for t in (x, b, c, dt_act))
    y, final = ssd_chunked(x, dt_act, a, b, c, chunk, h0)
    y = y[:, :seq]
    y = y + x[:, :seq] * params["d_skip"][None, None, :, None]
    y = y.reshape(bsz, seq, d_inner)
    y = layers.rmsnorm(params["norm"], y * F.silu(z)).to(u.dtype)
    return y @ params["w_out"], SSMState(conv_x=conv_x_tail, conv_bc=conv_bc_tail, ssd=final)


def ssm_decode(
    params: Dict,
    cfg: ArchConfig,
    u: torch.Tensor,  # (B, 1, d_model)
    state: SSMState,
) -> Tuple[torch.Tensor, SSMState]:
    """One recurrent decode step with conv+SSD state update."""
    s, d_inner, n_heads, bc_ch = _dims(cfg)
    bsz = u.shape[0]
    f32 = torch.float32
    z = u @ params["w_z"]
    x_new = (u @ params["w_x"])[:, 0]  # (B, d_inner)
    bc_new = (u @ params["w_bc"])[:, 0]
    dt = (u @ params["w_dt"])[:, 0]

    def conv_step(win_state, new, w, bias):
        window = torch.cat([win_state, new[:, None].to(win_state.dtype)], dim=1)
        out = torch.einsum("btc,tc->bc", window, w) + bias
        return F.silu(out), window[:, 1:]

    x1, new_conv_x = conv_step(state.conv_x, x_new, params["conv_x_w"], params["conv_x_b"])
    bc1, new_conv_bc = conv_step(state.conv_bc, bc_new, params["conv_bc_w"],
                                 params["conv_bc_b"])

    gn = s.n_groups * s.d_state
    x1 = x1.reshape(bsz, n_heads, s.head_dim)
    b1 = bc1[..., :gn].reshape(bsz, s.n_groups, s.d_state)
    c1 = bc1[..., gn:].reshape(bsz, s.n_groups, s.d_state)
    rep = n_heads // s.n_groups
    b1 = torch.repeat_interleave(b1, rep, dim=1)  # (B, H, N)
    c1 = torch.repeat_interleave(c1, rep, dim=1)

    dt_act = _softplus(dt.to(f32) + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    decay = torch.exp(dt_act * a[None])  # (B, H)

    x_in = x1.to(f32) * dt_act[..., None]
    new_ssd = state.ssd * decay[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", x_in, b1.to(f32))
    y = torch.einsum("bhpn,bhn->bhp", new_ssd, c1.to(f32))
    y = y + x1.to(f32) * params["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, d_inner).to(u.dtype)
    y = layers.rmsnorm(params["norm"], y * F.silu(z)).to(u.dtype)
    return y @ params["w_out"], SSMState(new_conv_x, new_conv_bc, new_ssd)
