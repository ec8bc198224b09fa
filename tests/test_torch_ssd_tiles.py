"""The tile walk of the port's SSD scan kernel, on the CPU.

The kernel (``csrc/ssd_scan.cu``) ignores the caller's chunk: it cuts the
tokens into 64-token tiles of its own (the last one zero-filled), forms
each tile's state increment, passes the state from tile to tile, and then
each tile's outputs, with its products on tensor cores (bf16 operands, a
float32 value cut into bf16 pieces).  It runs only on the card, so
``ssd_scan_tiled_ref`` repeats that walk in plain PyTorch, and this file
holds it, on numpy-made inputs, to

* the reference's sequential ``ssd_naive_ref`` and its Pallas ``ssd_scan``
  in interpret mode (atol 2e-3, the bound ``tests/test_kernels.py`` holds
  the reference's kernel to);
* the port's plain version ``ssd_scan_ref`` at chunks 1, 4, 215 and 256,
  unrounded float32 (atol 1e-4: the same sums, grouped otherwise);
* the float64 token recurrence at the model's large step sums;
* with the kernel's rounding (``P_ROUND``): bf16 inputs (computed
  operands as bf16 pairs) and float32 inputs (three pieces in the two
  products where a pair would reach past half the tolerance) within half
  of 2e-3 of the float32 plain version, and the pair far closer than one
  bf16 rounding.

The cases: t of 37, 300 and 430 (none a multiple of the tile), with and
without an initial state, g of 1 and 2, n of 16, 64 and 128.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_naive_ref
from repro_torch.kernels.ssd_scan.ops import (P_ROUND, PRODUCTS, TILE,
                                              ssd_scan_ref,
                                              ssd_scan_tiled_ref)
from test_torch_helpers import cap_threads

cap_threads()

SSD_ATOL = 2e-3
#: the walk against the plain version, both unrounded float32
REGROUP_ATOL = 1e-4

# b, t, h, p, g, n
CASES = [
    (2, 37, 3, 16, 1, 16),
    (1, 300, 4, 32, 2, 64),
    (2, 430, 2, 16, 1, 128),
    (1, 300, 2, 64, 1, 64),         # the kernel's head dim
]


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _inputs(b, t, h, p, g, n, seed=0):
    """x, dt, A, B, C, s0 as numpy float32, as ``tests/test_kernels.py``
    draws them (standard normal x, B, C; softplus step sizes)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    B = rng.standard_normal((b, t, g, n)).astype(np.float32)
    C = rng.standard_normal((b, t, g, n)).astype(np.float32)
    s0 = (rng.standard_normal((b, h, p, n)) * 0.1).astype(np.float32)
    return x, dt, A, B, C, s0


def _err(got, ref):
    return max(float((got[0].float() - _t(ref[0]).float()).abs().max())
               if not isinstance(ref[0], torch.Tensor)
               else float((got[0].float() - ref[0].float()).abs().max()),
               float((got[1] - (ref[1] if isinstance(ref[1], torch.Tensor)
                                else _t(ref[1]))).abs().max()))


def _divisor(t):
    """The largest chunk of at most 256 that divides t."""
    return max(c for c in range(1, min(t, 256) + 1) if t % c == 0)


@pytest.mark.parametrize("with_state", [True, False], ids=["s0", "no_s0"])
@pytest.mark.parametrize("b,t,h,p,g,n", CASES)
def test_walk_matches_the_reference(b, t, h, p, g, n, with_state):
    assert t % TILE != 0
    x, dt, A, B, C, s0 = _inputs(b, t, h, p, g, n)
    s0 = s0 if with_state else None
    jx = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    js0 = None if s0 is None else jnp.asarray(s0)
    naive = ssd_naive_ref(*jx, js0)
    pallas = jax_ssd_scan(*jx, _divisor(t), js0)
    walk = ssd_scan_tiled_ref(*(_t(a) for a in (x, dt, A, B, C)), _t(s0))
    assert walk[0].shape == (b, t, h, p) and walk[1].shape == (b, h, p, n)
    assert walk[0].dtype == torch.float32 and walk[1].dtype == torch.float32
    for ref in (naive, pallas):
        got_y, got_s = walk[0].numpy(), walk[1].numpy()
        np.testing.assert_allclose(got_y, np.asarray(ref[0]), atol=SSD_ATOL)
        np.testing.assert_allclose(got_s, np.asarray(ref[1]), atol=SSD_ATOL)


@pytest.mark.parametrize("b,t,h,p,g,n,chunk", [
    (2, 37, 3, 16, 1, 16, 1),
    (1, 300, 4, 32, 2, 64, 1),
    (1, 300, 4, 32, 2, 64, 4),
    (2, 430, 2, 16, 1, 128, 1),
    (2, 430, 2, 16, 1, 128, 215),
    (1, 512, 2, 64, 2, 64, 256),
])
def test_walk_regroups_the_plain_version(b, t, h, p, g, n, chunk):
    """The scan at any chunk is one function: the walk's tiles and the
    plain version's chunks group the same float32 sums otherwise."""
    x, dt, A, B, C, s0 = (_t(a) for a in _inputs(b, t, h, p, g, n, seed=1))
    ref = ssd_scan_ref(x, dt, A, B, C, chunk, s0)
    walk = ssd_scan_tiled_ref(x, dt, A, B, C, s0)
    torch.testing.assert_close(walk[0], ref[0], rtol=0, atol=REGROUP_ATOL)
    torch.testing.assert_close(walk[1], ref[1], rtol=0, atol=REGROUP_ATOL)


def _recurrence_f64(x, dt, A, B, C, s0):
    """The scan token by token in float64 (single group)."""
    s = s0.astype(np.float64)
    ys = []
    for i in range(x.shape[1]):
        s = (s * np.exp(dt[:, i] * A)[:, :, None, None]
             + (x[:, i] * dt[:, i][..., None])[..., None]
             * B[:, i, 0][:, None, None, :])
        ys.append(np.einsum("bn,bhpn->bhp", C[:, i, 0], s))
    return np.stack(ys, 1), s


@pytest.mark.parametrize("p_round,y_atol,s_atol", [
    (None, 2e-5, 1e-6), (P_ROUND[torch.float32], 1e-4, 3e-5)],
    ids=["unrounded", "kernel_f32"])
def test_walk_at_large_step_sums(p_round, y_atol, s_atol):
    """A of -1 to -16 (``init_mamba2``) and softplus step sizes: in-tile sums
    of dt * A reach ~-800, and the decays come from float64 differences
    rounded once, so the walk stays within 2e-5 (|y| up to ~35) of the
    float64 recurrence (the state, up to ~2.3, within 1e-6); in the
    kernel's float32 rounding within 1e-4 and 3e-5 (the pairs' ~2^-17
    relative error, summed over a tile)."""
    rng = np.random.default_rng(0)
    b, t, h, p, n = 1, 512, 4, 8, 8
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, h).astype(np.float32)
    B = rng.standard_normal((b, t, 1, n)).astype(np.float32)
    C = rng.standard_normal((b, t, 1, n)).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((b, h, p, n))).astype(np.float32)
    y_gold, s_gold = _recurrence_f64(
        *(a.astype(np.float64) for a in (x, dt, A, B, C, s0)))
    assert np.abs(np.cumsum(dt[:, :TILE] * A, axis=1)).max() > 500
    y, s = ssd_scan_tiled_ref(*(_t(a) for a in (x, dt, A, B, C, s0)),
                              p_round=p_round)
    np.testing.assert_allclose(y.numpy(), y_gold, rtol=0, atol=y_atol)
    np.testing.assert_allclose(s.numpy(), s_gold, rtol=0, atol=s_atol)


@pytest.mark.parametrize("b,t,h,p,g,n", CASES)
def test_bf16_inputs_with_pairs_meet_the_tolerance(b, t, h, p, g, n):
    """bf16 x, dt, B and C (as the model passes them) enter the products as
    they are, every computed operand as a bf16 pair: within half the 2e-3
    tolerance of the float32 plain version on the same values, and the
    walk of the bf16 tensors is that float32 result rounded once."""
    x, dt, A, B, C, s0 = (_t(a) for a in _inputs(b, t, h, p, g, n, seed=2))
    xb, dtb, Bb, Cb = (a.to(torch.bfloat16) for a in (x, dt, B, C))
    vals = [a.float() for a in (xb, dtb)] + [A] + [a.float()
                                                    for a in (Bb, Cb)]
    ref = ssd_scan_ref(*vals, _divisor(t), s0)
    walk = ssd_scan_tiled_ref(*vals, s0, p_round=P_ROUND[torch.bfloat16])
    assert _err(walk, ref) <= SSD_ATOL / 2
    yb, sb = ssd_scan_tiled_ref(xb, dtb, A, Bb, Cb, s0,
                                p_round=P_ROUND[torch.bfloat16])
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb, walk[0].to(torch.bfloat16))
    assert torch.equal(sb, walk[1])


@pytest.mark.parametrize("b,t,h,p,g,n", CASES)
def test_float32_inputs_with_the_kernels_rounding_meet_the_tolerance(
        b, t, h, p, g, n):
    """float32 inputs: pairs for the state and inter products, three
    pieces for the score and intra ones, keep the walk within half the
    2e-3 tolerance of the plain version."""
    x, dt, A, B, C, s0 = (_t(a) for a in _inputs(b, t, h, p, g, n, seed=3))
    ref = ssd_scan_ref(x, dt, A, B, C, _divisor(t), s0)
    walk = ssd_scan_tiled_ref(x, dt, A, B, C, s0,
                              p_round=P_ROUND[torch.float32])
    assert _err(walk, ref) <= SSD_ATOL / 2


def test_pair_is_far_closer_than_one_bf16_rounding():
    """One bf16 rounding of every operand misses the tolerance by two
    orders; the pair meets it and three pieces come near the unrounded
    walk."""
    x, dt, A, B, C, s0 = (_t(a) for a in _inputs(1, 430, 3, 64, 1, 64,
                                                  seed=4))
    unrounded = ssd_scan_tiled_ref(x, dt, A, B, C, s0)
    err = {r: _err(ssd_scan_tiled_ref(x, dt, A, B, C, s0, p_round=r),
                   unrounded) for r in ("bf16", "pair", "triple")}
    assert err["bf16"] > 10 * SSD_ATOL
    assert err["pair"] < err["bf16"] / 100
    assert err["triple"] < err["pair"] / 10


@pytest.mark.parametrize("product", PRODUCTS)
def test_which_float32_products_need_three_pieces(product):
    """Why a float32 call runs the score and intra products on three
    pieces: at n 128 with standard-normal inputs (|y| ~ 200), a pair in
    either of them alone puts the walk past half the 2e-3 tolerance; a
    pair in the state or inter product alone stays well inside it."""
    x, dt, A, B, C, s0 = (_t(a) for a in _inputs(2, 430, 4, 64, 2, 128))
    unrounded = ssd_scan_tiled_ref(x, dt, A, B, C, s0)
    one = dict.fromkeys(PRODUCTS, None)
    one[product] = "pair"
    err = _err(ssd_scan_tiled_ref(x, dt, A, B, C, s0, p_round=one),
               unrounded)
    if P_ROUND[torch.float32][product] == "triple":
        assert err > SSD_ATOL / 2
    else:
        assert err < SSD_ATOL / 4


def test_walk_refuses_an_unknown_rounding():
    x, dt, A, B, C, _ = (_t(a) for a in _inputs(1, 16, 1, 16, 1, 16))
    with pytest.raises(ValueError):
        ssd_scan_tiled_ref(x, dt, A, B, C, p_round="fp8")
