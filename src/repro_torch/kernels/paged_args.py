"""What the attention wrappers share: the table gather and the masked
softmax of the plain versions, and the checks and C arguments of the
CUDA launches (paged pools and dense caches)."""
from __future__ import annotations

from typing import Optional

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
NEG_INF = -1e30
#: the kernels' floor on a softmax denominator (a row with no key is 0)
MIN_DENOMINATOR = 1e-30
#: head dims the dense kernels are built for (``csrc/decode.cu``,
#: ``csrc/chunked_prefill.cu``): smollm / granite, zamba2-7b, qwen, gemma3
DENSE_HEAD_DIMS = (64, 112, 128, 256)


def gather_pool(pool, tables, block_size: int):
    """Dense per-row view ``[B, NB * bs, ...]`` of a ``[P(+1), ...]`` pool
    through the block tables; entries < 0 or past the pool are clamped
    (the caller masks them)."""
    B, NB = tables.shape
    n_blk = pool.shape[0] // block_size
    idx = (tables.clamp(0, n_blk - 1).long()[:, :, None] * block_size
           + torch.arange(block_size, device=tables.device)[None, None, :])
    return pool[idx.reshape(B, NB * block_size)]


def gather_kv(pool, scale, tables, block_size: int):
    """Gathered pool as float32, dequantised where ``scale`` is given."""
    dense = gather_pool(pool, tables, block_size).float()
    if scale is not None:
        dense = dense * gather_pool(scale, tables, block_size)[..., None]
    return dense


def masked_softmax(scores, mask):
    """Softmax over the last axis with masked entries at -1e30 and rows
    without any valid key zeroed (the reference's ``_masked_softmax``)."""
    scores = torch.where(mask, scores.float(),
                         torch.full_like(scores, NEG_INF,
                                         dtype=torch.float32))
    probs = torch.softmax(scores, dim=-1)
    return torch.where(mask.any(dim=-1, keepdim=True), probs,
                       torch.zeros_like(probs))


def _aligned16(t, n_outer: int) -> bool:
    """The data pointer and the ``n_outer`` outer strides, in bytes, are
    multiples of 16: the kernels bring KV rows in by 16-byte ``cp.async``
    and 16-byte loads."""
    return t.data_ptr() % 16 == 0 and all(
        s * t.element_size() % 16 == 0 for s in t.stride()[:n_outer])


def pool_args(q, k_pool, v_pool, tables, block_size: int,
              k_scale: Optional[torch.Tensor],
              v_scale: Optional[torch.Tensor]):
    """Validate what the kernels assume and return
    ``(n_blk, stride_tok, stride_head, sc_stride_tok, q_code, kv_code)``.
    Raises on any device, type, shape or layout the kernels do not take."""
    D = q.shape[-1]
    Hq = q.shape[-2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pool.dtype not in _DTYPE_CODE or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"unsupported pool types {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    if D not in (64, 128):
        raise ValueError(f"head_dim must be 64 or 128, got {D}")
    if k_pool.dim() != 3 or k_pool.shape != v_pool.shape \
            or k_pool.shape[2] != D:
        raise ValueError(f"pools must be [P, Hkv, {D}], got "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    Hkv = k_pool.shape[1]
    if Hq % Hkv or Hq // Hkv > 16:
        raise ValueError(f"unsupported GQA grouping Hq={Hq}, Hkv={Hkv}")
    n_blk = k_pool.shape[0] // block_size
    if n_blk < 1:
        raise ValueError("pool holds less than one block")
    quant = k_pool.dtype == torch.int8
    if quant != (k_scale is not None and v_scale is not None):
        raise ValueError("int8 pools need k_scale and v_scale, "
                         "and only int8 pools take them")
    tensors = [q, k_pool, v_pool, tables]
    if quant:
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or s.dim() != 2 \
                    or s.shape[1] != Hkv or s.shape[0] < n_blk * block_size \
                    or s.stride(1) != 1 or s.stride() != k_scale.stride():
                raise ValueError("scale pools must be float32 [P, Hkv]")
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device:
            raise ValueError("all tensors must lie on q's device")
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    for pool in (k_pool, v_pool):
        if pool.stride() != k_pool.stride() or pool.stride(2) != 1 \
                or not _aligned16(pool, 2):
            raise ValueError("pools must share one layout with a "
                             "contiguous, 16-byte aligned last axis")
    if tables.dtype != torch.int32 or tables.dim() != 2 \
            or not tables.is_contiguous():
        raise ValueError("tables must be contiguous int32 [B, NB]")
    return (n_blk, k_pool.stride(0), k_pool.stride(1),
            k_scale.stride(0) if quant else 0,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype])


def dense_args(q, k, v):
    """Validate what the dense kernels assume of q and a dense KV cache
    pair ``[B, S, Hkv, D]`` (read in place through its strides) and return
    ``(S, stride_b, stride_tok, stride_head, q_code, kv_code)``.  Raises on
    any device, type, shape or layout the kernels do not take."""
    D = q.shape[-1]
    Hq = q.shape[-2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise TypeError(f"unsupported cache types {k.dtype}, {v.dtype}")
    if D not in DENSE_HEAD_DIMS:
        raise ValueError(
            f"head_dim must be one of {DENSE_HEAD_DIMS}, got {D}")
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != D:
        raise ValueError(f"k/v must be [{q.shape[0]}, S, Hkv, {D}], got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    Hkv = k.shape[2]
    if Hq % Hkv or Hq // Hkv > 16:
        raise ValueError(f"unsupported GQA grouping Hq={Hq}, Hkv={Hkv}")
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("all tensors must lie on q's device")
        if t.stride() != k.stride() or t.stride(3) != 1 \
                or not _aligned16(t, 3):
            raise ValueError("k and v must share one layout with a "
                             "contiguous, 16-byte aligned last axis")
    return (k.shape[1], k.stride(0), k.stride(1), k.stride(2),
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype])


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def check_launch(err: int, name: str):
    if err != 0:
        raise RuntimeError(
            f"{name}: launch refused "
            f"({'unsupported arguments' if err < 0 else f'CUDA error {err}'})")
