"""Mamba2 SSD chunked scan: the wrapper of the CUDA kernel
``csrc/ssd_scan.cu`` and its plain PyTorch version :func:`ssd_scan_ref`
(the reference model's ``ssd_chunked``), both with the same contract.

Replaces the Pallas kernel ``ssd_scan_kernel`` of
``repro/kernels/ssd_scan/ssd_kernel.py`` (wrapper ``ssd_scan/ops.py``).
As the reference's wrapper does, it pre-fuses the elementwise inputs in
float32 (``xdt = x * dt``, ``dA = dt * A``) so the kernel reads only what
its products need; unlike it, it neither repeats B and C over the heads of
a group nor transposes anything: the kernel reads ``[b, t, g, n]`` rows in
place.  On the card the scan is bound by operations: its products are f32
FMA loops (no TF32), one thread block per (batch row, head) walking the
chunks in order with the state on chip.  See the kernel source for the
design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_args import NEG_INF, check_launch

_Y_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's shape limits: head dim, state widths, longest chunk
HEAD_DIM = 64
STATE_WIDTHS = (16, 32, 64, 128)
MAX_CHUNK = 256


def ssd_scan(x, dt, A, B, C, chunk: int, init_state=None):
    """Same contract as :func:`ssd_scan_ref`:
    x [b,t,h,p], dt [b,t,h], A [h], B/C [b,t,g,n], init_state [b,h,p,n]
    or None -> (y [b,t,h,p] in x's type, final_state [b,h,p,n] float32).
    Requires t % chunk == 0.

    A CUDA tensor launches the kernel (or raises: p must be 64, n one of
    16/32/64/128, chunk at most 256, x float32 or bfloat16); only a CPU
    tensor goes to the plain version."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C, chunk, init_state)
    if x.device.type != "cuda":
        raise RuntimeError(f"unsupported device {x.device}")
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if x.dtype not in _Y_CODE:
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
    dtf = dt.float()
    xdt = (x.float() * dtf[..., None]).contiguous()
    dA = (dtf * A.float()[None, None, :]).contiguous()
    Bf = B.float().contiguous()
    Cf = C.float().contiguous()
    s0 = (init_state.float().contiguous() if init_state is not None
          else torch.zeros((b, h, p, n), dtype=torch.float32,
                           device=x.device))
    y = torch.empty((b, t, h, p), dtype=x.dtype, device=x.device)
    sfin = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        err = lib.ssd_scan(
            xdt.data_ptr(), dA.data_ptr(), Bf.data_ptr(), Cf.data_ptr(),
            s0.data_ptr(), y.data_ptr(), sfin.data_ptr(), b, t, h, g, p, n,
            chunk, _Y_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
    check_launch(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, sfin


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
