"""The SSD scan's gradient on the CPU (``kernels/ssd_scan/ops.py``).

The backward kernel (``csrc/ssd_scan_bwd.cu``) runs only on the card, so
its plain version ``ssd_scan_bwd_ref``, the same reverse tile walk with
explicit sums, is held here, on numpy-made inputs, to

* ``jax.grad`` of the reference's ``ssd_chunked`` for all six inputs (x,
  dt, A, B, C and the initial state), with cotangents on y and on the
  final state: ``max |port - ref| <= 1e-4 max |ref| + 1e-6``, as
  ``tests/test_torch_training.py`` holds the scan's gradients (float32
  sums in another order, the port's cum in float64);
* a float64 ``torch.autograd.gradcheck`` of ``SSDScanFn`` (whose CPU
  backward it is);

and y under grad is bit-equal to y under ``no_grad``.  The cases: t of 64
(one tile), 150 (a ragged last tile) and 1088 (17 tiles: past one
1024-token slice of the forward kernel), g of 1 and 2.

The same walk with the kernel's rounding (``p_round=BWD_P_ROUND[type]``:
every product's operands cut into bf16 pairs as the tensor cores take
them) is held to ``jax.grad`` of ``ssd_chunked`` within half of the
card's tolerances on the kernel against float64 (2e-3 for float32
inputs, 2e-2 for bf16 ones, of each gradient's largest value): float32
inputs, and bf16-valued ones (x, dt, B, C and dy rounded to bf16), at a
ragged t with two groups, at the kernel's widths (P 64, N 128) and at the
model's large step sums.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jax_m2
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from test_torch_helpers import cap_threads

cap_threads()

#: a gradient: max |port - reference| <= GRAD_RTOL max |reference| +
#: GRAD_ATOL
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
#: kernel 5b against float64 autograd on the card, of each gradient's
#: largest value (``tests/test_torch_gpu.py::SSD_GRAD_TOL``); the rounded
#: walk is held to half of it
CARD_GRAD_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
NAMES = ("x", "dt", "A", "B", "C", "init_state")


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _inputs(b, t, h, p, g, n, seed, dtype=np.float32):
    """x, dt, A, B, C, s0 and the cotangents of y and the final state,
    drawn as ``tests/test_kernels.py`` draws the scan's inputs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h))))
    A = -np.exp(rng.standard_normal(h))
    B = rng.standard_normal((b, t, g, n))
    C = rng.standard_normal((b, t, g, n))
    s0 = rng.standard_normal((b, h, p, n)) * 0.1
    dy = rng.standard_normal((b, t, h, p))
    ds = rng.standard_normal((b, h, p, n))
    return [a.astype(dtype) for a in (x, dt, A, B, C, s0, dy, ds)]


# b, t, h, p, g, n, chunk (the reference's chunk divides t)
CASES = [(1, 64, 2, 16, 1, 8, 64), (2, 150, 4, 16, 2, 8, 50),
         (1, 1088, 2, 16, 1, 8, 64)]


@pytest.mark.parametrize("b,t,h,p,g,n,chunk", CASES,
                         ids=["t64", "t150_g2", "t1088"])
def test_bwd_ref_matches_jax_grad_of_reference(b, t, h, p, g, n, chunk):
    *ins, dy, ds = _inputs(b, t, h, p, g, n, seed=t)

    def loss(*a):
        y, s = jax_m2.ssd_chunked(*a[:5], chunk, a[5])
        return jnp.sum(y * dy) + jnp.sum(s * ds)

    ref = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        *(jnp.asarray(a) for a in ins))
    got = ssd_ops.ssd_scan_bwd_ref(*(_t(a) for a in ins), _t(dy), _t(ds))
    for name, gp, gr in zip(NAMES, got, ref):
        gr = np.asarray(gr)
        assert gp.dtype == torch.float32 and gp.shape == gr.shape, name
        err = float(np.abs(gp.numpy() - gr).max())
        assert err <= GRAD_RTOL * float(np.abs(gr).max()) + GRAD_ATOL, \
            (name, err)


@pytest.mark.parametrize("with_s0", [True, False], ids=["s0", "no_s0"])
def test_scan_fn_passes_float64_gradcheck(with_s0):
    """Two tiles, the second of 2 tokens; the final state and y both
    reach the loss."""
    x, dt, A, B, C, s0, _, _ = _inputs(1, 66, 2, 4, 1, 3, seed=5,
                                       dtype=np.float64)
    args = [_t(a).requires_grad_(True) for a in (x, dt, A, B, C)]
    s0 = _t(s0).requires_grad_(True) if with_s0 else None
    assert torch.autograd.gradcheck(
        lambda *a: ssd_ops.SSDScanFn.apply(*a[:5], 66, a[5]),
        (*args, s0), fast_mode=True)


def test_y_under_grad_is_bit_equal_to_y_without():
    x, dt, A, B, C, s0, dy, ds = (_t(a) for a in _inputs(2, 150, 4, 16, 2,
                                                         8, seed=6))
    with torch.no_grad():
        y0, s_0 = ssd_ops.ssd_scan(x, dt, A, B, C, 50, s0)
    ins = [a.clone().requires_grad_(True) for a in (x, dt, A, B, C, s0)]
    y1, s_1 = ssd_ops.ssd_scan(*ins[:5], 50, ins[5])
    assert y1.grad_fn is not None
    assert torch.equal(y0, y1.detach()) and torch.equal(s_0, s_1.detach())
    (y1 * dy).sum().add((s_1 * ds).sum()).backward()
    want = ssd_ops.ssd_scan_bwd_ref(x, dt, A, B, C, s0, dy, ds)
    for a, w in zip(ins, want):
        assert torch.equal(a.grad, w)


def test_gradients_come_in_their_inputs_types():
    """bf16 x, dt, B and C (as a bf16 model passes them) get bf16
    gradients, A and the initial state float32 ones; an input that needs
    no gradient gets none, and no input needing one runs no Function."""
    x, dt, A, B, C, s0, dy, _ = (_t(a) for a in _inputs(1, 70, 2, 16, 1, 8,
                                                        seed=7))
    x, dt, B, C = (a.bfloat16().requires_grad_(True) for a in (x, dt, B, C))
    A.requires_grad_(True)
    y, s = ssd_ops.ssd_scan(x, dt, A, B, C, 70, s0)
    assert y.dtype == torch.bfloat16
    (y.float() * dy).sum().backward()
    assert [a.grad.dtype for a in (x, dt, A, B, C)] == \
        [torch.bfloat16] * 2 + [torch.float32] + [torch.bfloat16] * 2
    assert s0.grad is None
    y, _ = ssd_ops.ssd_scan(*(a.detach() for a in (x, dt, A, B, C)), 70, s0)
    assert y.grad_fn is None


def _bf16_values(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


# b, t, h, p, g, n, chunk, large step sums (A from -1 to -16, as
# ``init_mamba2``: in-tile sums of dt * A reach ~-800)
ROUNDED_CASES = [(2, 150, 4, 16, 2, 8, 50, False),
                 (1, 130, 2, 64, 1, 128, 65, False),
                 (1, 512, 4, 16, 1, 16, 64, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,h,p,g,n,chunk,large", ROUNDED_CASES,
                         ids=["t150_g2", "p64_n128", "large_step_sums"])
def test_rounded_bwd_ref_is_within_half_the_card_tolerance(
        b, t, h, p, g, n, chunk, large, dtype):
    x, dt, A, B, C, s0, dy, ds = _inputs(b, t, h, p, g, n, seed=t + 1)
    if large:
        A = -np.linspace(1.0, 16.0, h).astype(np.float32)
        assert np.abs(np.cumsum(dt[:, :64] * A, axis=1)).max() > 500
    if dtype == torch.bfloat16:
        x, dt, B, C, dy = (_bf16_values(a) for a in (x, dt, B, C, dy))
    ins = (x, dt, A, B, C, s0)

    def loss(*a):
        y, s = jax_m2.ssd_chunked(*a[:5], chunk, a[5])
        return jnp.sum(y * dy) + jnp.sum(s * ds)

    ref = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        *(jnp.asarray(a) for a in ins))
    got = ssd_ops.ssd_scan_bwd_ref(*(_t(a) for a in ins), _t(dy), _t(ds),
                                   p_round=ssd_ops.BWD_P_ROUND[dtype])
    tol = CARD_GRAD_TOL[dtype] / 2
    for name, gp, gr in zip(NAMES, got, ref):
        gr = np.asarray(gr)
        assert gp.dtype == torch.float32 and gp.shape == gr.shape, name
        err = float(np.abs(gp.numpy() - gr).max())
        assert err <= tol * float(np.abs(gr).max()), (name, err)


def test_rounding_reaches_the_walk():
    """Each product's rounding changes the walk: one bf16 rounding of its
    operands moves the gradients (far past the pairs' ~1e-5), and the
    pairs move them from the exact walk."""
    x, dt, A, B, C, s0, dy, ds = (_t(a) for a in _inputs(1, 70, 2, 16, 1,
                                                        8, seed=9))
    exact = ssd_ops.ssd_scan_bwd_ref(x, dt, A, B, C, s0, dy, ds)
    pairs = ssd_ops.ssd_scan_bwd_ref(
        x, dt, A, B, C, s0, dy, ds,
        p_round=ssd_ops.BWD_P_ROUND[torch.float32])
    for prod in ssd_ops.BWD_PRODUCTS:
        rnd = dict(ssd_ops.BWD_P_ROUND[torch.float32], **{prod: "bf16"})
        one = ssd_ops.ssd_scan_bwd_ref(x, dt, A, B, C, s0, dy, ds,
                                       p_round=rnd)
        moved = max(float((o - q).abs().max() / q.abs().max())
                    for o, q in zip(one, pairs))
        assert moved > 1e-4, prod
    gap = max(float((q - e).abs().max() / e.abs().max())
              for q, e in zip(pairs, exact))
    assert 0 < gap < 1e-4
