"""Mamba2 (SSD — state-space duality) mixer layer — the port of the
reference's ``models/mamba2.py``.

Implements the chunked SSD algorithm (arXiv:2405.21060) with an *initial
state*, which is what makes chunked prefill and prefill->decode state
handoff (the paper's "flowing" migration for SSM archs) exact.

Cache per layer: ``{"conv": [B, k-1, C_in], "ssm": [B, H, P, N]}`` —
O(1) in sequence length; ``ssm`` is float32 whatever the parameter type.
Where the reference returns an updated cache, the port UPDATES THE CACHE
IN PLACE.  A prefill chunk (T > 1) goes through the hand-written SSD scan
kernel's wrapper (``kernels/ssd_scan/ops.py``), beside which its plain
version ``ssd_scan_ref`` (the reference's ``ssd_chunked``) lives; a decode
step (T == 1) is the single-token recurrence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import hints
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.common import dense_init, rms_norm


def conv_channels(cfg) -> int:
    return cfg.ssm_d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def init_mamba2(gen: torch.Generator, cfg):
    """Random mixer parameters from ``gen``.  ``dt_bias``, ``A_log`` and
    ``D`` are float32 whatever the parameter type, as in the reference."""
    d = cfg.d_model
    dinner = cfg.ssm_d_inner
    H, N, G = cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_ngroups
    cin = conv_channels(cfg)
    dt, dev = cfg.param_dtype, gen.device
    proj_out = 2 * dinner + 2 * G * N + H
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(gen, (d, proj_out), dt),
        "conv_w": dense_init(gen, (cfg.ssm_conv, cin), dt,
                             scale=cfg.ssm_conv ** -0.5),
        "conv_b": torch.zeros((cin,), dtype=dt, device=dev),
        "dt_bias": torch.zeros((H,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "norm_w": torch.zeros((dinner,), dtype=dt, device=dev),
        "out_proj": dense_init(gen, (dinner, d), dt),
    }


# ---------------------------------------------------------------------------
# SSD decode step (a prefill chunk goes through the scan kernel's wrapper)
# ---------------------------------------------------------------------------

def ssd_decode_step(x, dt, A, B, C, state):
    """Single-token recurrence.  x [b,h,p], dt [b,h], B/C [b,g,n],
    state [b,h,p,n] -> (y [b,h,p], new_state float32)."""
    g = B.shape[1]
    rep = x.shape[1] // g
    Bh = B.float().repeat_interleave(rep, dim=1)
    Ch = C.float().repeat_interleave(rep, dim=1)
    xf = x.float()
    dtf = dt.float()
    dA = torch.exp(dtf * A.float()[None, :])                 # [b,h]
    upd = (xf * dtf[..., None])[..., None] * Bh[:, :, None, :]
    new_state = state.float() * dA[..., None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", Ch, new_state)
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Causal depthwise conv with state
# ---------------------------------------------------------------------------

def _causal_conv(xBC, w, b, conv_state):
    """xBC [B,T,Cin]; w [k,Cin]; conv_state [B,k-1,Cin] or None."""
    k = w.shape[0]
    T = xBC.shape[1]
    if conv_state is None:
        pad = torch.zeros((xBC.shape[0], k - 1, xBC.shape[2]),
                          dtype=xBC.dtype, device=xBC.device)
    else:
        pad = conv_state.to(xBC.dtype)
    full = torch.cat([pad, xBC], dim=1)                     # [B, T+k-1, Cin]
    out = sum(full[:, i:i + T] * w[i] for i in range(k))
    new_state = full[:, -(k - 1):] if k > 1 else None
    return out + b, new_state


# ---------------------------------------------------------------------------
# Full mixer layer
# ---------------------------------------------------------------------------

def mamba2_block(p, cfg, x, cache=None, *, valid_len=None):
    """x [B,T,d].  cache None -> fresh sequence (states discarded).
    cache given -> chunked prefill or decode continuation; the cache's
    ``conv``/``ssm`` views are updated in place.

    valid_len: optional [B] for a decode step (T == 1): rows with
    ``valid_len == 0`` are not decoding and keep their recurrent state
    exactly as it was (the engine's full-slot-batch decode passes the
    rows it schedules).  A padded prefill (T > 1) cannot be expressed:
    recurrent state would advance through the padding.

    Returns (out [B,T,d], cache)."""
    B, T, _ = x.shape
    dinner = cfg.ssm_d_inner
    H, P, N, G = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                  cfg.ssm_ngroups)
    if valid_len is not None and (T > 1 or cache is None):
        raise NotImplementedError(
            "valid_len on a Mamba2 layer is a decode row mask: padded "
            "prefill would advance recurrent state through the padding")

    # gathered whole before the uneven split below (a DTensor's split
    # gathers it anyway; this way its gradient comes back split as the
    # product's, which the weight's gradient product can take)
    zxbcdt = hints.whole_axis(x @ p["in_proj"], 1)
    z, xBC, dt_raw = torch.split(zxbcdt, [dinner, conv_channels(cfg), H],
                                 dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    xBC = F.silu(xBC.float()).to(x.dtype)
    xs, Bmat, Cmat = torch.split(xBC, [dinner, G * N, G * N], dim=-1)
    xs = xs.reshape(B, T, H, P)
    Bmat = Bmat.reshape(B, T, G, N)
    Cmat = Cmat.reshape(B, T, G, N)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    init_state = cache["ssm"] if cache is not None else None
    if T == 1:
        st = init_state if init_state is not None else torch.zeros(
            (B, H, P, N), dtype=torch.float32, device=x.device)
        # on DTensors, on local shards: rows and heads split as the
        # state [B, H, P, N] splits them, B and C by rows only
        y, new_state = hints.local(
            ssd_decode_step, st,
            in_dims=((0, 1, None), (0, 1), (1,), (0, None, None),
                     (0, None, None), (0, 1, 2, 3)),
            out_dims=[(0, 1, None), (0, 1, 2, 3)])(
                xs[:, 0], dt[:, 0], A, Bmat[:, 0], Cmat[:, 0], st)
        y = y[:, None]
    else:
        chunk = scan_chunk(cfg, T)
        # dt rounds to the activation type before the scan, as in the
        # reference.  On DTensors, on local shards: rows and heads split
        # as the initial state [B, H, P, N] splits them (as x [B, T, H, P]
        # does without one), B and C [B, T, G, N] by rows only
        ref, h = (xs, 2) if init_state is None else (init_state, 1)
        rows = (0, None, None, None)
        y, new_state = hints.local(
            ssd_ops.ssd_scan, ref,
            in_dims=((0, None, h, None), (0, None, h), (h,), rows, rows,
                     None, (0, h, None, None)),
            out_dims=[(0, None, h, None), (0, h, None, None)])(
                xs, dt.to(x.dtype), A, Bmat, Cmat, chunk, init_state)
    y = y + xs * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B, T, dinner)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm_w"],
                 cfg.norm_eps)
    out = y @ p["out_proj"]
    if cache is not None:
        new_conv = new_conv.to(cache["conv"].dtype)
        if valid_len is not None:
            keep = valid_len > 0
            new_conv = torch.where(keep[:, None, None], new_conv,
                                   cache["conv"])
            new_state = torch.where(keep[:, None, None, None], new_state,
                                    cache["ssm"])
        cache["conv"].copy_(hints.split_like(new_conv, cache["conv"]))
        cache["ssm"].copy_(hints.split_like(new_state, cache["ssm"]))
    return out, cache


def scan_chunk(cfg, T: int) -> int:
    """The scan's chunk for a T-token prefill, as the reference picks it:
    ``cfg.ssm_chunk`` (or T if shorter), halved until it divides T."""
    chunk = min(cfg.ssm_chunk, T)
    while T % chunk != 0:
        chunk //= 2
    return chunk


def init_mamba2_cache(cfg, batch: int, dtype, device="cuda"):
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_channels(cfg)),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_headdim,
                            cfg.ssm_state), dtype=torch.float32,
                           device=device),
    }
