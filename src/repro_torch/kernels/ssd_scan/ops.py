"""Mamba2 SSD scan: the wrapper of the CUDA kernel ``csrc/ssd_scan.cu``,
its plain PyTorch version :func:`ssd_scan_ref` (the reference model's
``ssd_chunked``), both with the same contract, and
:func:`ssd_scan_tiled_ref`, the kernel's tile walk in plain PyTorch for the
tests.

Replaces the Pallas kernel ``ssd_scan_kernel`` of
``repro/kernels/ssd_scan/ssd_kernel.py`` (wrapper ``ssd_scan/ops.py``).
The scan is one function whatever the chunk: chunking changes only how
its sums are grouped (at chunk 1 it is the token recurrence).  So the
kernel does not walk the caller's chunks: it cuts the tokens into tiles of
its own (:data:`TILE`), and one thread block a (row, head) walks them with
the state on chip, on tensor cores; its time follows the tokens, not the
caller's ``chunk``.  It reads x, dt, B and C in place, in the caller's
type and through their strides (B and C a group's row per head, where the
Pallas wrapper repeats and transposes them), so the wrapper makes no
float32 copy of them where they share x's type.  See the kernel source for
the design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_args import NEG_INF, check_launch, ptr

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's shape limits: head dim, state widths; the caller's chunk
#: is held to the plain version's contract (it divides t) and the
#: reference's longest chunk, though the kernel does not use it
HEAD_DIM = 64
STATE_WIDTHS = (16, 32, 64, 128)
MAX_CHUNK = 256
#: tokens of one of the kernel's tiles (``kTile`` in ``csrc/ssd_scan.cu``)
TILE = 64


def _in_place(t, inner):
    """``t`` itself where its inner strides are ``inner`` and its data
    pointer and outer strides are multiples of 16 bytes (the kernel brings
    rows in by 16-byte loads), else a contiguous copy in its own type."""
    n_outer = t.dim() - len(inner)
    if tuple(t.stride()[n_outer:]) == tuple(inner) \
            and t.data_ptr() % 16 == 0 \
            and all(s * t.element_size() % 16 == 0
                    for s in t.stride()[:n_outer]):
        return t
    return t.contiguous()


def ssd_scan(x, dt, A, B, C, chunk: int, init_state=None):
    """Same contract as :func:`ssd_scan_ref`:
    x [b,t,h,p], dt [b,t,h], A [h], B/C [b,t,g,n], init_state [b,h,p,n]
    or None -> (y [b,t,h,p] in x's type, final_state [b,h,p,n] float32).
    Requires t % chunk == 0.

    A CUDA tensor launches the kernel (or raises: p must be 64, n one of
    16/32/64/128, chunk at most 256, x float32 or bfloat16; and while grad
    mode is on and an input requires grad, as the kernel has no backward);
    only a CPU tensor goes to the plain version, which is differentiable.
    dt, B and C in x's type are read as they are; where one is not, the
    kernel runs on float32 copies of all four, as the plain version
    computes.  One launch is counted a call, however many the kernel
    makes (one for each 1024 tokens)."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C, chunk, init_state)
    if x.device.type != "cuda":
        raise RuntimeError(f"unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad
            for a in (x, dt, A, B, C, init_state)):
        raise RuntimeError(
            "ssd_scan: the CUDA kernel has no backward, so a gradient "
            "through it would be dropped; Mamba2 layers train on the CPU "
            "until the kernel's backward lands (ROADMAP.md queue A item 9)")
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if p != HEAD_DIM or n not in STATE_WIDTHS:
        raise ValueError(f"unsupported head dim {p} / state width {n}")
    if not 0 < chunk <= MAX_CHUNK or t % chunk:
        raise ValueError(f"chunk {chunk} must divide t={t} and be <= "
                         f"{MAX_CHUNK}")
    if dt.shape != (b, t, h) or A.shape != (h,) or h % g \
            or B.shape != (b, t, g, n) or C.shape != B.shape \
            or (init_state is not None
                and init_state.shape != (b, h, p, n)):
        raise ValueError("ssd_scan: shapes do not agree")
    tensors = [dt, A, B, C] + ([init_state] if init_state is not None
                               else [])
    if any(a.device != x.device for a in tensors):
        raise ValueError("all tensors must lie on x's device")
    y_dtype = x.dtype
    if not dt.dtype == B.dtype == C.dtype == x.dtype:
        x, dt, B, C = (a.float() for a in (x, dt, B, C))
    x = _in_place(x, (p, 1))
    B = _in_place(B, (n, 1))
    C = _in_place(C, (n, 1))
    if B.stride() != C.stride():
        B, C = B.contiguous(), C.contiguous()
    dt = dt if dt.stride(2) == 1 else dt.contiguous()
    A = A.float().contiguous()          # h values
    s0 = None
    if init_state is not None:
        s0 = _in_place(init_state.float(), (p * n, n, 1))
    y = torch.empty((b, t, h, p), dtype=x.dtype, device=x.device)
    sfin = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), ptr(s0), y.data_ptr(), sfin.data_ptr(), b, t, h,
            g, p, n, x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
            B.stride(0), B.stride(1), s0.stride(0) if s0 is not None else 0,
            _DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
    check_launch(err, "ssd_scan")
    ssd_scan.launches += 1
    return y.to(y_dtype), sfin


#: kernel launches made by this wrapper (the plain version never counts)
ssd_scan.launches = 0


def ssd_scan_ref(x, dt, A, B, C, chunk: int, init_state=None):
    """Chunked SSD scan in plain PyTorch, the kernel's plain version.

    x:  [b, t, h, p]    per-head inputs
    dt: [b, t, h]       post-softplus step sizes
    A:  [h]             negative real decay
    B:  [b, t, g, n]    input projections  (g groups broadcast over heads)
    C:  [b, t, g, n]    output projections
    init_state: [b, h, p, n] or None
    Returns (y [b,t,h,p] in x's type, final_state [b,h,p,n] float32).
    Requires t % chunk == 0.
    """
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if t % chunk:
        raise ValueError(f"chunk {chunk} does not divide t={t}")
    nc = t // chunk
    rep = h // g

    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    Bh = B.float().reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Ch = C.float().reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    dA = dtf * A.float()[None, None, None, :]       # [b,nc,l,h]
    # inclusive within chunk, in float64 (as the scan kernel does): the
    # decays below are exponents of differences of two such sums, which
    # reach ~1e3 at the model's step sizes.  Taken in float32 each
    # difference would carry the sums' rounding (~1e-4 absolute), so each
    # is formed in float64 and rounded once
    cum64 = torch.cumsum(dA.double(), dim=2)
    cum = cum64.float()
    seg_sum = cum[:, :, -1]                         # [b,nc,h]

    # --- intra-chunk: decay from j to i (i >= j) is exp(cum_i - cum_j),
    # masked INSIDE the exponent (anti-causal exponents would overflow)
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    diff = (cum64[:, :, :, None, :]
            - cum64[:, :, None, :, :]).float()      # [b,nc,i,j,h]
    decay = torch.exp(diff.masked_fill(~causal, NEG_INF))
    cb = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    xdt = xf * dtf[..., None]
    y = torch.einsum("bcijh,bcjhp->bcihp", cb * decay, xdt)

    # --- chunk-final states: sum_j exp(seg_sum - cum_j) B_j (x_j dt_j)
    sdecay = torch.exp((cum64[:, :, -1:] - cum64).float())  # [b,nc,l,h]
    chunk_states = torch.einsum("bclhn,bclhp->bchpn", Bh,
                                xdt * sdecay[..., None])

    # --- inter-chunk recurrence over nc (sequential)
    s = (init_state.float() if init_state is not None
         else torch.zeros((b, h, p, n), dtype=torch.float32,
                          device=x.device))
    entering = []
    for c in range(nc):
        entering.append(s)                  # state *entering* chunk c
        s = s * torch.exp(seg_sum[:, c])[:, :, None, None] \
            + chunk_states[:, c]
    entering = torch.stack(entering, dim=1)                 # [b,nc,h,p,n]

    # --- inter-chunk output: C_i exp(cum_i) S_entering
    y_inter = torch.einsum("bcihn,bchpn->bcihp", Ch, entering) \
        * torch.exp(cum)[..., None]
    y = (y + y_inter).reshape(b, t, h, p)
    return y.to(x.dtype), s


#: bf16 pieces an operand with float32 values is cut into when it enters a
#: tensor-core product: one rounding, the pair hi + lo, or three pieces
#: (exact for a float32 value)
PIECES = {"bf16": 1, "pair": 2, "triple": 3}
#: the products of the walk: the tile state increments of pass 1, the
#: scores C B^T, the inter term C S_enter^T and the decayed scores times x
PRODUCTS = ("state", "score", "inter", "intra")
#: how the kernel rounds each product's operands, by the inputs' type.
#: bf16 inputs enter as they are and every computed operand as a pair; with
#: float32 inputs the pair put the score and intra products past half the
#: 2e-3 tolerance on the CPU walk, so those two run on three pieces
#: (PERF.md)
P_ROUND = {
    torch.bfloat16: dict.fromkeys(PRODUCTS, "pair"),
    torch.float32: {"state": "pair", "score": "triple", "inter": "pair",
                    "intra": "triple"},
}


def _split(a, p_round):
    """``a`` as it enters a tensor-core product: the list of its bf16
    pieces, ``PIECES[p_round]`` of them, each the bf16 rounding of
    what the ones before leave (``[a]`` unrounded when ``p_round`` is
    None)."""
    if p_round is None:
        return [a]
    if p_round not in PIECES:
        raise ValueError(f"unknown p_round {p_round!r}")
    pieces = []
    for _ in range(PIECES[p_round]):
        pieces.append(a.to(torch.bfloat16).float())
        a = a - pieces[-1]
    return pieces


def _product(eq, a, b, p_round):
    """``einsum(eq, a, b)`` with both operands cut as ``p_round`` says.
    With k pieces each, the products of pieces i and j with i + j < k are
    the ones the kernel runs (hi hi, hi lo, lo hi for the pair); an
    operand exact in bf16 has zero pieces past its first."""
    pa, pb = _split(a, p_round), _split(b, p_round)
    out = None
    for i, ai in enumerate(pa):
        for j, bj in enumerate(pb):
            if i + j < len(pa):
                term = torch.einsum(eq, ai, bj)
                out = term if out is None else out + term
    return out


def ssd_scan_tiled_ref(x, dt, A, B, C, init_state=None, *, p_round=None):
    """Plain PyTorch walk of the kernel's tiles and passes; only tests use
    it.  Same arguments and results as :func:`ssd_scan_ref`, but no chunk:
    the tokens are cut into tiles of :data:`TILE` (the last one
    zero-filled past t), and with ``cum`` the float64 inclusive sum of
    float32 ``dt * A`` inside a tile and ``seg`` its last entry:

    1. each tile's state increment ``dS = sum_j (x_j * (dt_j *
       exp(seg - cum_j)))^T B_j``;
    2. in tile order, ``S_enter = S``, then ``S = exp(seg) S + dS``;
    3. ``y_i = exp(cum_i) C_i S_enter^T + sum_j ((C_i . B_j) exp(cum_i -
       cum_j) dt_j) x_j``, the decay masked to ``j <= i`` inside the
       exponent.

    Every float64 difference is rounded to float32 once.  ``p_round``
    rounds the operands of the products as the kernel's tensor cores take
    them (:func:`_split`): one mode for all, or a mode for each of
    :data:`PRODUCTS` (:data:`P_ROUND` holds the kernel's)."""
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    nt = -(-t // TILE)
    rnd = (p_round if isinstance(p_round, dict)
           else dict.fromkeys(PRODUCTS, p_round))

    def tiles(a):       # [b, t, ...] -> float32 [b, nt, TILE, ...]
        a = a.float()
        pad = torch.zeros((b, nt * TILE - t) + a.shape[2:], dtype=a.dtype,
                          device=a.device)
        return torch.cat([a, pad], dim=1).reshape(
            (b, nt, TILE) + a.shape[2:])

    xf = tiles(x)                                           # [b,c,l,h,p]
    dtf = tiles(dt)                                         # [b,c,l,h]
    Bh = tiles(B).repeat_interleave(rep, dim=3)             # [b,c,l,h,n]
    Ch = tiles(C).repeat_interleave(rep, dim=3)
    cum64 = torch.cumsum((dtf * A.float()).double(), dim=2)
    seg64 = cum64[:, :, -1]                 # padding adds dt * A = 0

    # pass 1: the tiles' state increments
    coef = dtf * torch.exp((seg64[:, :, None] - cum64).float())
    dS = _product("bclhp,bclhn->bchpn", xf * coef[..., None], Bh,
                  rnd["state"])

    # pass 2: the states entering the tiles, in order
    s = (init_state.float() if init_state is not None
         else torch.zeros((b, h, p, n), dtype=torch.float32,
                          device=x.device))
    entering = []
    for c in range(nt):
        entering.append(s)
        s = s * torch.exp(seg64[:, c].float())[:, :, None, None] + dS[:, c]
    entering = torch.stack(entering, dim=1)                 # [b,c,h,p,n]

    # pass 3: the outputs
    idx = torch.arange(TILE, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    diff = (cum64[:, :, :, None, :] - cum64[:, :, None, :, :]).float()
    decay = torch.exp(diff.masked_fill(~causal, NEG_INF))   # [b,c,i,j,h]
    score = _product("bcihn,bcjhn->bcijh", Ch, Bh, rnd["score"])
    weights = score * decay * dtf[:, :, None, :, :]
    y = _product("bcihn,bchpn->bcihp", Ch, entering, rnd["inter"]) \
        * torch.exp(cum64.float())[..., None] \
        + _product("bcijh,bcjhp->bcihp", weights, xf, rnd["intra"])
    y = y.reshape(b, nt * TILE, h, p)[:, :t]
    return y.to(x.dtype), s
