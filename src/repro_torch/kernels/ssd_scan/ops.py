"""Mamba2 SSD scan: the wrapper of the CUDA kernel ``csrc/ssd_scan.cu``,
its plain PyTorch version :func:`ssd_scan_ref` (the reference model's
``ssd_chunked``), both with the same contract, and
:func:`ssd_scan_tiled_ref`, the kernel's tile walk in plain PyTorch for the
tests.  Its gradient is :class:`SSDScanFn`, whose backward on the card is
the kernel ``csrc/ssd_scan_bwd.cu`` (:func:`ssd_scan_bwd`, the reverse
tile walk) and on the CPU that walk's plain version
:func:`ssd_scan_bwd_ref`; the reference has no Pallas backward (it takes
``jax.grad`` of ``ssd_chunked``).

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


def _kernel_inputs(x, dt, A, B, C, chunk, init_state):
    """Check what the forward kernel takes and return its inputs as it
    reads them: x, dt, B and C in x's type (float32 copies of all four
    where one is not), x, B and C in place where their strides allow, A
    and the initial state (or None) in float32."""
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
    return x, dt, A, B, C, s0


def _launch_scan(x, dt, A, B, C, s0, with_states: bool):
    """The forward kernel on inputs from :func:`_kernel_inputs`: (y in x's
    type, the final state, and where ``with_states`` the float32 state
    entering each :data:`TILE`-token tile, ``[b, h, ceil(t / TILE), p,
    n]``, else None)."""
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty((b, t, h, p), dtype=x.dtype, device=x.device)
    sfin = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    states = (torch.empty((b, h, -(-t // TILE), p, n), dtype=torch.float32,
                          device=x.device) if with_states else None)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), ptr(s0), y.data_ptr(), sfin.data_ptr(),
            ptr(states), b, t, h, g, p, n, x.stride(0), x.stride(1),
            dt.stride(0), dt.stride(1), B.stride(0), B.stride(1),
            s0.stride(0) if s0 is not None else 0, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, sfin, states


def ssd_scan(x, dt, A, B, C, chunk: int, init_state=None):
    """Same contract as :func:`ssd_scan_ref`:
    x [b,t,h,p], dt [b,t,h], A [h], B/C [b,t,g,n], init_state [b,h,p,n]
    or None -> (y [b,t,h,p] in x's type, final_state [b,h,p,n] float32).
    Requires t % chunk == 0.

    A CUDA tensor launches the kernel (or raises: p must be 64, n one of
    16/32/64/128, chunk at most 256, x float32 or bfloat16); only a CPU
    tensor goes to the plain version.  dt, B and C in x's type are read as
    they are; where one is not, the kernel runs on float32 copies of all
    four, as the plain version computes.  One launch is counted a call,
    however many the kernel makes (one for each 1024 tokens).

    While grad mode is on and an input requires grad, the call goes
    through :class:`SSDScanFn`: on the card the forward kernel also
    writes the state entering each tile, and the backward is the kernel
    of ``csrc/ssd_scan_bwd.cu`` (:func:`ssd_scan_bwd`); on the CPU both
    directions are plain versions."""
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad
            for a in (x, dt, A, B, C, init_state)):
        return SSDScanFn.apply(x, dt, A, B, C, chunk, init_state)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C, chunk, init_state)
    y_dtype = x.dtype
    y, sfin, _ = _launch_scan(
        *_kernel_inputs(x, dt, A, B, C, chunk, init_state), False)
    return y.to(y_dtype), sfin


#: kernel launches made by this wrapper (the plain version never counts)
ssd_scan.launches = 0


class SSDScanFn(torch.autograd.Function):
    """The scan with its gradient for every input (x, dt, A, B, C and the
    initial state), each in its input's type.  A CUDA input runs the
    forward kernel, which also writes the state entering each tile (saved
    for the backward: under ``torch.utils.checkpoint`` it is dropped and
    written again by the recomputed forward), and the backward kernel
    (:func:`ssd_scan_bwd`); a CPU input runs :func:`ssd_scan_ref` and
    :func:`ssd_scan_bwd_ref`."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk, init_state):
        ctx.set_materialize_grads(False)
        ctx.dtypes = (x.dtype, dt.dtype, A.dtype, B.dtype, C.dtype,
                      None if init_state is None else init_state.dtype)
        if x.device.type == "cpu":
            ctx.save_for_backward(x, dt, A, B, C, init_state)
            return ssd_scan_ref(x, dt, A, B, C, chunk, init_state)
        xk, dtk, Ak, Bk, Ck, s0 = _kernel_inputs(x, dt, A, B, C, chunk,
                                                 init_state)
        y, sfin, states = _launch_scan(xk, dtk, Ak, Bk, Ck, s0, True)
        ctx.save_for_backward(xk, dtk, Ak, Bk, Ck, states)
        return y.to(x.dtype), sfin

    @staticmethod
    def backward(ctx, dy, dsfin):
        # the last saved tensor: the initial state (CPU) or the tile
        # states the forward kernel wrote (CUDA)
        x, dt, A, B, C, last = ctx.saved_tensors
        need_s0 = ctx.needs_input_grad[6]
        if x.device.type == "cpu":
            grads = ssd_scan_bwd_ref(x, dt, A, B, C, last, dy, dsfin)
        else:
            grads = ssd_scan_bwd(x, dt, A, B, C, last, dy, dsfin,
                                 with_ds0=need_s0)
        out = [None if g is None or not need else g.to(dtype)
               for g, dtype, need in zip(grads, ctx.dtypes,
                                         ctx.needs_input_grad[:5]
                                         + (need_s0,))]
        return (*out[:5], None, out[5])


def ssd_scan_bwd(x, dt, A, B, C, states, dy, dsfin, with_ds0=True):
    """The backward kernel (``csrc/ssd_scan_bwd.cu``): the gradients of
    the scan's inputs from ``dy`` (y's cotangent, or None) and ``dsfin``
    (the final state's, or None), on the forward kernel's inputs
    (:func:`_kernel_inputs`) and the tile states it wrote.  Returns
    float32 (dx, ddt, dA, dB, dC, ds0 or None); dx comes in x's type.
    The kernel writes dA, dB and dC for each head; their sums over the
    heads that share a value (a group's B and C, A over the batch) are
    taken here in a fixed order: the transpose of the reference's
    ``jnp.repeat``."""
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nt = -(-t // TILE)
    if states.shape != (b, h, nt, p, n) or states.dtype != torch.float32:
        raise ValueError("ssd_scan_bwd: tile states do not agree")
    dev = x.device
    dy = (torch.zeros_like(x) if dy is None
          else dy.to(x.dtype).contiguous())
    if dsfin is not None:
        dsfin = dsfin.float().contiguous()
    states = states.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((b, t, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, t, h), **f32)
    dA = torch.empty((b, h), **f32)
    dB = torch.empty((b, t, h, n), **f32)
    dC = torch.empty((b, t, h, n), **f32)
    ds0 = torch.empty((b, h, p, n), **f32) if with_ds0 else None
    lib = build.load_library()
    timing = ssd_scan_bwd.events
    with torch.cuda.device(dev):
        if timing is not None:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        err = lib.ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(), ptr(dsfin), states.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), ptr(ds0), b, t, h, g, p, n, x.stride(0),
            x.stride(1), dt.stride(0), dt.stride(1), B.stride(0),
            B.stride(1), _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream)
        if timing is not None:
            ev[1].record()
            timing.append(tuple(ev))
    check_launch(err, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    rep = h // g
    return (dx, ddt, dA.sum(0), dB.view(b, t, g, rep, n).sum(3),
            dC.view(b, t, g, rep, n).sum(3), ds0)


#: kernel launches made by this wrapper (the plain version never counts)
ssd_scan_bwd.launches = 0
#: None, or a list to which each launch appends its (start, end) CUDA
#: events, recorded on the launch's stream just around the kernel
ssd_scan_bwd.events = None


def _compute_dtype(x):
    """The plain versions' arithmetic type: float64 for float64 inputs,
    else float32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def ssd_scan_ref(x, dt, A, B, C, chunk: int, init_state=None):
    """Chunked SSD scan in plain PyTorch, the kernel's plain version.

    x:  [b, t, h, p]    per-head inputs
    dt: [b, t, h]       post-softplus step sizes
    A:  [h]             negative real decay
    B:  [b, t, g, n]    input projections  (g groups broadcast over heads)
    C:  [b, t, g, n]    output projections
    init_state: [b, h, p, n] or None
    Returns (y [b,t,h,p] in x's type, final_state [b,h,p,n] float32).
    Requires t % chunk == 0.  Float64 inputs are computed in float64 (the
    state too): the gradient oracle of the tests.
    """
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if t % chunk:
        raise ValueError(f"chunk {chunk} does not divide t={t}")
    nc = t // chunk
    rep = h // g
    ct = _compute_dtype(x)

    xf = x.to(ct).reshape(b, nc, chunk, h, p)
    dtf = dt.to(ct).reshape(b, nc, chunk, h)
    Bh = B.to(ct).reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Ch = C.to(ct).reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    dA = dtf * A.to(ct)[None, None, None, :]        # [b,nc,l,h]
    # inclusive within chunk, in float64 (as the scan kernel does): the
    # decays below are exponents of differences of two such sums, which
    # reach ~1e3 at the model's step sizes.  Taken in float32 each
    # difference would carry the sums' rounding (~1e-4 absolute), so each
    # is formed in float64 and rounded once
    cum64 = torch.cumsum(dA.double(), dim=2)
    cum = cum64.to(ct)
    seg_sum = cum[:, :, -1]                         # [b,nc,h]

    # --- intra-chunk: decay from j to i (i >= j) is exp(cum_i - cum_j),
    # masked INSIDE the exponent (anti-causal exponents would overflow)
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    diff = (cum64[:, :, :, None, :]
            - cum64[:, :, None, :, :]).to(ct)       # [b,nc,i,j,h]
    decay = torch.exp(diff.masked_fill(~causal, NEG_INF))
    cb = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    xdt = xf * dtf[..., None]
    y = torch.einsum("bcijh,bcjhp->bcihp", cb * decay, xdt)

    # --- chunk-final states: sum_j exp(seg_sum - cum_j) B_j (x_j dt_j)
    sdecay = torch.exp((cum64[:, :, -1:] - cum64).to(ct))   # [b,nc,l,h]
    chunk_states = torch.einsum("bclhn,bclhp->bchpn", Bh,
                                xdt * sdecay[..., None])

    # --- inter-chunk recurrence over nc (sequential)
    s = (init_state.to(ct) if init_state is not None
         else torch.zeros((b, h, p, n), dtype=ct, device=x.device))
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


def _tiles(a, dtype):
    """``a`` [b, t, ...] in ``dtype`` as [b, nt, TILE, ...], zero-filled
    past t."""
    b, t = a.shape[:2]
    nt = -(-t // TILE)
    a = a.to(dtype)
    pad = torch.zeros((b, nt * TILE - t) + a.shape[2:], dtype=dtype,
                      device=a.device)
    return torch.cat([a, pad], dim=1).reshape((b, nt, TILE) + a.shape[2:])


def _walk_states(xf, dtf, Bh, cum64, init_state, p_round=None):
    """Passes 1 and 2 of the tile walk on tiled operands (``xf`` [b, c,
    l, h, p], ``dtf`` [b, c, l, h], ``Bh`` [b, c, l, h, n]) in their type,
    with ``cum64`` the float64 inclusive sum of ``dt * A`` in each tile:
    each tile's state increment ``sum_j (x_j dt_j exp(seg - cum_j))^T
    B_j`` (its product rounded as ``p_round`` says, :func:`_product`),
    then in tile order ``S_enter = S``, ``S = exp(seg) S + increment``.
    Returns (the entering states [b, c, h, p, n], the final state)."""
    ct = xf.dtype
    b, _, _, h, p = xf.shape
    seg64 = cum64[:, :, -1]                 # padding adds dt * A = 0
    coef = dtf * torch.exp((seg64[:, :, None] - cum64).to(ct))
    dS = _product("bclhp,bclhn->bchpn", xf * coef[..., None], Bh, p_round)
    s = (init_state.to(ct) if init_state is not None
         else torch.zeros((b, h, p, Bh.shape[-1]), dtype=ct,
                          device=xf.device))
    entering = []
    for c in range(xf.shape[1]):
        entering.append(s)
        s = s * torch.exp(seg64[:, c].to(ct))[:, :, None, None] + dS[:, c]
    return torch.stack(entering, dim=1), s


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
    g = B.shape[2]
    rep = h // g
    nt = -(-t // TILE)
    rnd = (p_round if isinstance(p_round, dict)
           else dict.fromkeys(PRODUCTS, p_round))
    xf = _tiles(x, torch.float32)                           # [b,c,l,h,p]
    dtf = _tiles(dt, torch.float32)                         # [b,c,l,h]
    Bh = _tiles(B, torch.float32).repeat_interleave(rep, dim=3)
    Ch = _tiles(C, torch.float32).repeat_interleave(rep, dim=3)
    cum64 = torch.cumsum((dtf * A.float()).double(), dim=2)
    # passes 1 and 2: the states entering the tiles, [b,c,h,p,n]
    entering, s = _walk_states(xf, dtf, Bh, cum64, init_state, rnd["state"])

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


def ssd_tile_states_ref(x, dt, A, B, C, init_state=None):
    """The state entering each :data:`TILE`-token tile, ``[b, h,
    ceil(t / TILE), p, n]``, as the forward kernel writes it for the
    backward: the tile walk of :func:`ssd_scan_tiled_ref` without
    rounding, in float64 for float64 inputs, else float32."""
    h, g = x.shape[2], B.shape[2]
    ct = _compute_dtype(x)
    xf = _tiles(x, ct)
    dtf = _tiles(dt, ct)
    Bh = _tiles(B, ct).repeat_interleave(h // g, dim=3)
    cum64 = torch.cumsum((dtf * A.to(ct)).double(), dim=2)  # [b,c,l,h]
    return _walk_states(xf, dtf, Bh, cum64, init_state)[0].transpose(1, 2)


#: the products of the reverse walk (:func:`ssd_scan_bwd_ref`), each named
#: by its two operands: the scores C B^T of M, dy x^T of D, then M^T dy and
#: B dS^T (the gradient of x dt), dy S and P B (dC), P^T C and x dS (dB),
#: and (e dy)^T C (the gradient of the entering state)
BWD_PRODUCTS = ("cb", "dyx", "m_dy", "b_ds", "dy_s", "p_b", "p_c", "x_ds",
                "edy_c")
#: how the backward kernel rounds each product's operands, by the inputs'
#: type: pairs for all.  bf16 inputs (x, B, C, dy) enter as they are (their
#: pair is the value and a zero) and every computed operand (M, P, e dy,
#: S, dS) as a pair, the forward's choice; float32 inputs enter as pairs
#: too.  Unlike the forward's absolute 2e-3 on y, the gradients are held
#: relative to their largest value, and on the CPU walk against
#: ``jax.grad`` pairs stay within 8.1e-5 (float32) and 9.8e-6 (bf16 values)
#: of it, against half-tolerances of 1e-3 and 1e-2
#: (``tests/test_torch_ssd_grad.py``), so no product needs a third piece
#: (x, dy, B and C in three pieces would not fit shared memory at N 128).
#: One bf16 rounding instead reaches 1.2e-2 with float32 inputs and 3.0e-3
#: with bf16 ones.
BWD_P_ROUND = {
    torch.bfloat16: dict.fromkeys(BWD_PRODUCTS, "pair"),
    torch.float32: dict.fromkeys(BWD_PRODUCTS, "pair"),
}


def ssd_scan_bwd_ref(x, dt, A, B, C, init_state, dy, dsfin, states=None,
                     *, p_round=None):
    """The backward kernel's plain version: the reverse tile walk, written
    with explicit sums (no ``torch.autograd``).  ``dy`` is y's cotangent
    and ``dsfin`` the final state's (either may be None); ``states`` the
    tile states (:func:`ssd_tile_states_ref` of the inputs where None).
    Returns (dx, ddt, dA, dB, dC, ds0) in float64 for float64 inputs,
    else float32; ds0 is None without ``init_state``.

    In a tile, with ``cum`` the float64 inclusive sum of ``dt * A`` (each
    difference rounded once), ``seg`` its last entry, ``e_i =
    exp(cum_i)``, ``w_j = exp(seg - cum_j)``, ``L_ij = exp(cum_i -
    cum_j)`` masked to ``j <= i`` inside the exponent, S the entering
    state, ``xdt_j = x_j dt_j`` and dS the gradient of the state leaving
    the tile (from ``dsfin`` at the last tile):

    * ``M_ij = (C_i . B_j) L_ij``, ``D_ij = (dy_i . x_j) dt_j``, ``P = D
      L``;
    * ``d(xdt)_j = sum_i M_ij dy_i + w_j dS B_j``, so ``dx_j = d(xdt)_j
      dt_j`` and ddt_j gains ``d(xdt)_j . x_j``;
    * ``dC_i = e_i S^T dy_i + sum_j P_ij B_j``;
    * ``dB_j = sum_i P_ij C_i + w_j dt_j dS^T x_j``;
    * ``dcum_i = sum_j M_ij D_ij - sum_j M_ji D_ji + e_i C_i . S^T dy_i
      - R_i`` with ``R_j = w_j xdt_j . dS B_j``, and the last entry gains
      ``d seg = exp(seg) <dS, S> + sum_j R_j``; its reverse cumulative sum
      is ``d(dt A)``, so ddt gains ``d(dt A) A`` and dA is ``sum d(dt A)
      dt``;
    * the state entering the tile gets ``exp(seg) dS + sum_i (e_i dy_i)^T
      C_i``.

    ``p_round`` rounds the operands of each product as the kernel's tensor
    cores take them (:func:`_product`): one mode for all, or a mode for
    each of :data:`BWD_PRODUCTS` (:data:`BWD_P_ROUND` holds the kernel's);
    None computes every product exactly.  dB and dC are summed over the
    heads of a group, the transpose of the forward's repeat."""
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    ct = _compute_dtype(x)
    rnd = (p_round if isinstance(p_round, dict)
           else dict.fromkeys(BWD_PRODUCTS, p_round))
    if states is None:
        states = ssd_tile_states_ref(x, dt, A, B, C, init_state)
    xf = _tiles(x, ct)                                      # [b,c,l,h,p]
    dtf = _tiles(dt, ct)                                    # [b,c,l,h]
    Bh = _tiles(B, ct).repeat_interleave(rep, dim=3)        # [b,c,l,h,n]
    Ch = _tiles(C, ct).repeat_interleave(rep, dim=3)
    dyf = (torch.zeros_like(xf) if dy is None else _tiles(dy, ct))
    Af = A.to(ct)
    cum64 = torch.cumsum((dtf * Af).double(), dim=2)        # [b,c,l,h]
    idx = torch.arange(TILE, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    dS = (dsfin.to(ct) if dsfin is not None
          else torch.zeros((b, h, p, n), dtype=ct, device=x.device))
    dA = torch.zeros((h,), dtype=ct, device=x.device)
    dxs, ddts, dBs, dCs = [], [], [], []
    for c in reversed(range(xf.shape[1])):
        cm = cum64[:, c]                                    # [b,l,h]
        seg = cm[:, -1]                                     # [b,h]
        e = torch.exp(cm.to(ct))
        w = torch.exp((seg[:, None] - cm).to(ct))
        E = torch.exp(seg.to(ct))
        L = torch.exp((cm[:, :, None] - cm[:, None, :]).to(ct)
                      .masked_fill(~causal, NEG_INF))       # [b,i,j,h]
        xc, dtc, Bc, Cc, dyc = (a[:, c] for a in (xf, dtf, Bh, Ch, dyf))
        S = states[:, :, c].to(ct)                          # [b,h,p,n]
        M = _product("bihn,bjhn->bijh", Cc, Bc, rnd["cb"]) * L
        D = _product("bihp,bjhp->bijh", dyc, xc, rnd["dyx"]) \
            * dtc[:, None]
        P = D * L
        Q = M * D
        SB = _product("bhpn,bjhn->bjhp", dS, Bc, rnd["b_ds"])  # dS B_j
        dxdt = _product("bijh,bihp->bjhp", M, dyc, rnd["m_dy"]) \
            + w[..., None] * SB
        R = w * dtc * (xc * SB).sum(-1)                     # [b,l,h]
        Sdy = _product("bihp,bhpn->bihn", dyc, S, rnd["dy_s"])  # S^T dy_i
        dCs.append(e[..., None] * Sdy
                   + _product("bijh,bjhn->bihn", P, Bc, rnd["p_b"]))
        dBs.append(_product("bijh,bihn->bjhn", P, Cc, rnd["p_c"])
                   + (w * dtc)[..., None]
                   * _product("bjhp,bhpn->bjhn", xc, dS, rnd["x_ds"]))
        dcum = Q.sum(2) - Q.sum(1) + e * (Cc * Sdy).sum(-1) - R
        dcum[:, -1] += E * (dS * S).sum((-2, -1)) + R.sum(1)
        da = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        dxs.append(dxdt * dtc[..., None])
        ddts.append((dxdt * xc).sum(-1) + da * Af)
        dA = dA + (da * dtc).sum((0, 1))
        dS = E[..., None, None] * dS \
            + _product("bihp,bihn->bhpn", e[..., None] * dyc, Cc,
                       rnd["edy_c"])

    def untile(parts):          # tiles last to first -> [b, t, ...]
        a = torch.stack(parts[::-1], dim=1)
        return a.reshape((b, -1) + a.shape[3:])[:, :t]

    dBh, dCh = untile(dBs), untile(dCs)                     # [b,t,h,n]
    return (untile(dxs), untile(ddts), dA,
            dBh.reshape(b, t, g, rep, n).sum(3),
            dCh.reshape(b, t, g, rep, n).sum(3),
            dS if init_state is not None else None)
