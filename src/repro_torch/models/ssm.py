"""Mamba-2 block via SSD (state-space duality), chunked form.
[arXiv:2405.21060]

Port of ``repro/models/ssm.py``, in the reference's param layout and
arithmetic. The SSD algorithm splits the sequence into chunks: within a
chunk the recurrence is computed in its dual quadratic-attention form;
across chunks a linear recurrence over per-chunk states runs (the
reference's ``lax.scan``, here a Python loop over the chunks).
Single-token decode keeps (conv_state, ssm_state) and costs
O(heads * head_dim * state) per step.

The reference has no Pallas kernel here (XLA compiles its ``jnp``), so
this is plain torch, written for the ``vmap(grad)`` local step:

  * the prefix sums of the log-decays (``_cumsum``) are doubling steps
    of elementwise adds, one fixed order, where torch's CUDA ``cumsum``
    picks its threads per row from the row count;
  * the four-operand einsums are written as the pairwise products they
    contract to, in a fixed order (``torch.einsum`` may let
    ``opt_einsum`` choose one);
  * the depthwise conv is the reference's W shifted products (cuDNN's
    weight gradient would be a reduction over tokens with unpinned
    bits), and every parameter that meets the tokens elementwise
    (``conv_w``, ``conv_b``, ``dt_bias``, ``A_log``, ``D_skip``) enters
    through ``layers.broadcast``, the gated norm's scale through
    ``layers.rmsnorm_gated``: their gradients are ``token_sum``'s.

At bf16 the reference multiplies bf16 ``xin`` by f32 ``dt`` and feeds
bf16 ``B`` / ``C`` to f32 einsums, which JAX promotes; torch promotes
the elementwise product alike, and ``B`` / ``C`` are cast to f32 where
JAX's promotion lands.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import (NEG_INF, _device, broadcast,
                                       matmul, rmsnorm_gated, silu,
                                       truncated_normal_init, zeros)


def _filled(key, values, lead):
    """An f32 leaf of fixed ``values`` (numpy), stacked over ``lead``, on
    ``key``'s device (``meta``: shape and dtype only)."""
    shape = tuple(lead) + values.shape
    t = torch.from_numpy(values).to(_device(key))
    return t.expand(shape).contiguous()


def init_mamba2(key, cfg, dtype, lead=()):
    D = cfg.d_model
    Din = cfg.ssm_d_inner
    N = cfg.ssm_state
    H = cfg.ssm_heads
    W = cfg.ssm_conv_width
    conv_ch = Din + 2 * N
    # A_log = log(linspace(1, 16, H)) in f64, rounded once to f32 (the
    # reference's f32 linspace may differ in the last bit; a test carries
    # the reference's params across)
    a_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    # in_proj emits [z (Din), x (Din), B (N), C (N), dt (H)]
    return {
        "in_proj": truncated_normal_init(
            key, (D, 2 * Din + 2 * N + H), 1.0, dtype, lead),
        "conv_w": truncated_normal_init(key, (W, conv_ch), 1.0, dtype, lead),
        "conv_b": zeros(key, (conv_ch,), dtype, lead),
        # f32 whatever the param dtype
        "A_log": _filled(key, a_log, lead),
        "dt_bias": zeros(key, (H,), torch.float32, lead),
        "D_skip": _filled(key, np.ones((H,), np.float32), lead),
        "norm_scale": zeros(key, (Din,), dtype, lead),
        "out_proj": truncated_normal_init(key, (Din, D), 1.0, dtype, lead),
    }


def _cumsum(a):
    """Inclusive prefix sum over the last axis in ceil(log2 L) doubling
    steps of elementwise adds: one order, on every device and for every
    row count."""
    s = 1
    while s < a.shape[-1]:
        a = a + F.pad(a[..., :-s], (s, 0))
        s *= 2
    return a


def _segsum(cs):
    """cs = ``_cumsum(a)``: (..., L) -> (..., L, L) lower-triangular
    segment sums of ``a``, the reference's difference of prefix sums (the
    caller keeps ``cs``: the scan needs it too)."""
    L = cs.shape[-1]
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=cs.device))
    return torch.where(mask, diff, NEG_INF)


def ssd_chunked(X, dtA, Bm, Cm, chunk, initial_state=None):
    """Chunked SSD scan.

    X: (b, s, h, p)  values            dtA: (b, s, h)  log-decay (<=0)
    Bm/Cm: (b, s, n) input/output maps (ngroups=1, shared across heads)
    Returns y: (b, s, h, p), final_state: (b, h, p, n), f32.
    """
    b, s, h, p = X.shape
    n = Bm.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_chunked: {s} tokens are not a multiple of "
                         f"the chunk {chunk}")
    c = s // chunk

    Xc = X.reshape(b, c, chunk, h, p)
    Ac = dtA.reshape(b, c, chunk, h).permute(0, 3, 1, 2)     # (b,h,c,l)
    Bc = Bm.reshape(b, c, chunk, n).float()
    Cc = Cm.reshape(b, c, chunk, n).float()

    A_cum = _cumsum(Ac)                                       # (b,h,c,l)
    L = torch.exp(_segsum(A_cum))                             # (b,h,c,l,l)

    # intra-chunk (dual quadratic form): bcln,bcsn,bhcls,bcshp->bclhp
    CB = Cc @ Bc.transpose(-1, -2)                            # (b,c,l,s)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", CB[:, None] * L, Xc)

    # per-chunk input states: bcln,bhcl,bclhp->bchpn
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)        # (b,h,c,l)
    Xd = Xc * decay_states.permute(0, 2, 3, 1)[..., None]    # (b,c,l,h,p)
    states = torch.einsum("bclhp,bcln->bchpn", Xd, Bc)

    # inter-chunk recurrence
    chunk_decay = torch.exp(A_cum[..., -1])                   # (b,h,c)
    prev = (states.new_zeros((b, h, p, n)) if initial_state is None
            else initial_state.float())
    starts = []
    for j in range(c):
        starts.append(prev)
        prev = prev * chunk_decay[:, :, j, None, None] + states[:, j]
    prev_states = torch.stack(starts, dim=1)                  # (b,c,h,p,n)

    # chunk-start state contribution: bcln,bchpn,bhcl->bclhp
    state_decay = torch.exp(A_cum).permute(0, 2, 3, 1)       # (b,c,l,h)
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, prev_states) \
        * state_decay[..., None]

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, prev


def make_ssm_cache(cfg, batch, dtype, device=None):
    Din, N, H, P = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                    cfg.ssm_head_dim)
    W = cfg.ssm_conv_width
    return {
        "conv": torch.zeros((batch, W - 1, Din + 2 * N), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32,
                             device=device),
    }


def _causal_conv(xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv, width W, as the reference's W shifted
    products summed in order. xbc: (B,S,C)."""
    B, S, C = xbc.shape
    W = conv_w.shape[0]
    if conv_state is None:
        pad = xbc.new_zeros((B, W - 1, C))
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                         # (B,S+W-1,C)
    w = broadcast(conv_w, (B, S))                             # (B,S,W,C)
    out = xp[:, :S] * w[:, :, 0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[:, :, i]
    new_state = xp[:, S:]
    return silu(out + broadcast(conv_b, (B, S))), new_state


def _pad_tokens(t, pad):
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def apply_mamba2(params, x, cfg, cache=None):
    """x: (B, S, D). cache: {'conv','state'} for S==1 decode, or a prefill
    continuing into decode (S > 1). Returns (y, new_cache)."""
    B, S, D = x.shape
    Din, N, H, P = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                    cfg.ssm_head_dim)

    zxbcdt = matmul(x, params["in_proj"])
    z = zxbcdt[..., :Din]
    xbc = zxbcdt[..., Din:2 * Din + 2 * N]
    dt_raw = zxbcdt[..., -H:].float()
    dt = F.softplus(dt_raw + broadcast(params["dt_bias"], (B, S)))  # (B,S,H)
    A = -torch.exp(params["A_log"])                           # (H,) < 0

    new_cache = cache
    xbc, conv_state = _causal_conv(
        xbc, params["conv_w"], params["conv_b"],
        None if cache is None else cache["conv"])

    xin = xbc[..., :Din].reshape(B, S, H, P)
    Bm = xbc[..., Din:Din + N]
    Cm = xbc[..., Din + N:]

    if cache is None or S > 1:
        # pad sequence to a chunk multiple for the SSD scan
        chunk = min(cfg.ssm_chunk, max(1, S))
        pad = (-S) % chunk
        xin_p, dt_p, Bm_p, Cm_p = (_pad_tokens(t, pad) if pad else t
                                   for t in (xin, dt, Bm, Cm))
        dtA = dt_p * broadcast(A, (B, S + pad))              # (B,S',H)
        init_state = None if cache is None else cache["state"]
        y, final_state = ssd_chunked(
            xin_p * dt_p[..., None], dtA, Bm_p, Cm_p, chunk,
            initial_state=init_state)
        y = y[:, :S]
        if cache is not None:  # prefill continuing into decode
            new_cache = {"conv": conv_state, "state": final_state}
    else:
        # single-step recurrence
        st = cache["state"]                                   # (B,H,P,N)
        dt0 = dt[:, 0]                                        # (B,H)
        dA = torch.exp(dt0 * broadcast(A, (B,)))              # (B,H)
        dBx = (xin[:, 0].float()[..., None]
               * Bm[:, 0].float()[:, None, None, :]) * dt0[..., None, None]
        st_new = st * dA[..., None, None] + dBx
        y = (st_new @ Cm[:, 0].float()[:, None, :, None])[..., 0][:, None]
        new_cache = {"conv": conv_state, "state": st_new}

    skip = broadcast(params["D_skip"], (B, S, P)).transpose(-1, -2)
    y = y + xin.float() * skip                                # (B,S,H,P)
    y = y.reshape(B, S, Din).to(x.dtype)
    y = rmsnorm_gated(params["norm_scale"], y, z)
    return y @ params["out_proj"], new_cache
