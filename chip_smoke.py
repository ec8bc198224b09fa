#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

    python3 chip_smoke.py

Needs one NVIDIA H100 (or another sm_90a card), ``nvcc`` and nothing from
the network.  It imports ``repro_torch`` only, builds the port's CUDA
kernels from the sources in this checkout, and runs its phases, each
printing one JSON line; any failure raises and the process exits non-zero
(nothing falls back to the CPU or to a kernel's plain version):

  env            torch / CUDA versions, the card's name and power limit
  build          builds the kernel library, seconds taken; registers and
                 spill bytes of the head-dim-256 instantiations (ptxas)
  kernels        the two paged kernels against their plain PyTorch
                 versions on the card, at smollm-135m's and qwen2.5-3b's
                 shapes, fp and int8 pools, the decode at the serve
                 phase's batch and the prefill at its mixed batch (a
                 256-token chunk beside 13 decode rows); every kernel,
                 plain version and library call timed with a cold L2
                 (``time_ms``)
  params, model  qwen2.5-3b at full width: a mixed and a decode
                 ``forward`` through the kernels against the same through
                 the plain versions
  serve          the paged path as a batch replay: ``build_cluster``
                 under ``TaiChiPolicy`` with one P-heavy and one D-heavy
                 ``TorchExecutor`` instance serving 32 seeded requests at
                 the full width of qwen2.5-3b (random weights from a
                 seed), with flowing-decode migrations; every decode-only
                 iteration replays a captured CUDA graph
  live           the main path, ``--engine live``: the online
                 ``ServingLoop`` paced by a ``WallClock`` over a
                 non-blocking cluster with decode horizons up to K = 8,
                 the same 32 requests arriving at 8 a second; TTFT / TPOT
                 percentiles, horizons, readbacks, graphs, launches
  frontend       ``--serve``'s stack on ``live``'s executors: the
                 ``FrontendServer`` on 127.0.0.1 (port 0) over the live
                 loop, eight concurrent clients (streaming and whole,
                 completions and chat), ``/healthz`` and ``/metrics``, a
                 graceful drain with the requests in flight; each reply
                 the detokenised tokens of its request, the usage counts,
                 tokenizer workers without torch; client TTFT and TPOT
  tiers          the KV tiers on int8 pools at full width: a 1024-token
                 hot prefix spilled to the host by a cold prompt that
                 needs the pool and promoted back, a prefix replicated
                 into a fresh executor, checkpoint blocks; blocks bit-equal
                 after every round trip, tokens equal to never-evicted
                 runs; host seconds of the spill's fetch and load legs
  graphs_paged   one paged horizon bucket (4 rows, K = 8) at full width:
                 its graph's replay against the step run without a graph
                 from the same pool, tokens and KV bit for bit
  kernels_dense  the dense decode and dense chunked-prefill kernels
                 against their plain versions, at smollm-135m's,
                 zamba2-7b's, gemma3-1b's (head dim 256) and
                 granite-moe-3b-a800m's attention shapes (all but
                 smollm-135m's in bf16 and float32; the bf16 prefill also
                 at the D-heavy instance's 256-token chunk)
  kernels_ssd    the SSD-scan kernel against its plain version: one slot's
                 1024-token prefill at zamba2-7b's and mamba2-1.3b's widths
                 in float32, and zamba2-7b's served prefills in bf16 (887
                 tokens at chunk 1, 251 at 251, 1024 at 256 and at 1)
  model_zamba2   zamba2-7b at full width, cut to 12 of its 81 layers:
                 slot prefills and a masked full-batch decode over a dense
                 cache, through the kernels against the plain versions
  params_zamba2, serve_zamba2
                 the dense main path: the same cluster with two 8-slot
                 dense ``TorchExecutor`` instances serving 16 seeded
                 requests at the full width and depth of zamba2-7b; each
                 first token held against a replay of its prefill chunks;
                 the served (T, chunk) histogram of the scan and its
                 kernel time over those prefills (``scan_ms_served``)
  graphs_dense   zamba2-7b's full-slot-batch decode graph against the
                 step run without it, tokens, KV and recurrent state
  model_gemma3, params_gemma3, serve_gemma3, graphs_dense
                 the same for gemma3-1b (sliding-window ring layers and
                 head-dim-256 global layers): 12 layers at full width
                 through the kernels against the plain versions; 16
                 requests with prompts to 3072 tokens on two 8-slot
                 instances at max_seq 4096, full width and depth, first
                 tokens held against their replays (the cache-free
                 forward reported beside); its decode graph
  model_moe, params_moe, serve_moe, graphs_dense
                 the same for granite-moe-3b-a800m (40 experts top-8,
                 capacity shared by every row of a decode): 8 layers, then
                 full depth, prompts to 2048 tokens

``python3 chip_smoke.py --scan-only [SERVED]`` runs only the build and
``kernels_ssd`` and, given a file holding an earlier run's
``serve_zamba2`` line, the scan time over its served prefills.

Then one line ``{"kernels": [...]}`` with, for every kernel of the port,
its launches on the paths that run it (``live``, ``frontend`` and
``tiers`` for the paged kernels, ``serve_zamba2``, ``serve_gemma3`` and
``serve_moe`` for the dense ones; ``launches_by_path`` splits them), its error against the plain
version and its time beside the plain version's, the card's bound and one
library call; the card's name and power limit as ``nvidia-smi`` prints
them; and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.estimator import CostModel  # noqa: E402
from repro_torch.core.hw import InstanceSpec  # noqa: E402
from repro_torch.core.instance import D_HEAVY, Instance  # noqa: E402
from repro_torch.core.latency import SLO  # noqa: E402
from repro_torch.core.policies import Sliders  # noqa: E402
from repro_torch.engine.batching import bucket_batch, pack_decode  # noqa: E402
from repro_torch.engine.engine import PendingStep, TorchExecutor  # noqa: E402
from repro_torch.engine.request import Request  # noqa: E402
from repro_torch.frontend import (AdmissionConfig, ByteTokenizer,  # noqa: E402
                                  FrontendConfig, FrontendServer)
from repro_torch.frontend import protocol  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.chunked_prefill_attention import ops as pf_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.paged_args import gather_kv  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import mamba2 as m2  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import ServingLoop, WallClock  # noqa: E402
from repro_torch.sim.simulator import ServingConfig, build_cluster  # noqa: E402
from repro_torch.sim.workload import LengthDist, WorkloadSpec  # noqa: E402

DEV = "cuda"
MODEL = "qwen2.5-3b"
BLOCK = 16
# NVIDIA H100 SXM data sheet: HBM3 rate, dense tensor-core bf16 rate, and
# the float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel timing: the buffer overwritten before each timed call, and the
# writes queued first (~85 us each at the HBM rate) so that the host runs
# ahead of the device
L2_FLUSH_BYTES = 256 * 2**20
HEAD_START_FLUSHES = 40
# float32: sums in another order than the plain version's matmul;
# bfloat16: one rounding of the output (2^-8 relative) on values of a few
# units, plus the same for the plain version's
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# full-width logits after 36 layers, relative to the largest logit.  In
# float32 kernel and plain path differ by summation order only; in bf16
# see phase_model
MODEL_TOL_F32 = 1e-4
MODEL_TOL_BF16_SLACK = 5e-3

SHAPES = {   # name -> (Hq, Hkv, D, q dtype)
    "smollm-135m": (9, 3, 64, torch.float32),
    "qwen2.5-3b": (16, 2, 128, torch.bfloat16),
}

ZAMBA = "zamba2-7b"
DENSE_S = 2048          # max_seq of the dense cache (serve_zamba2's too)
DENSE_SHAPES = [   # (name, Hq, Hkv, D, q and cache dtype); zamba2-7b's
    # shape (the main path's, in bf16) also in float32, where the
    # tolerance is a small part of a typical output
    ("smollm-135m", 9, 3, 64, torch.float32),
    (ZAMBA, 32, 32, 112, torch.float32),
    (ZAMBA, 32, 32, 112, torch.bfloat16),
]
GEMMA = "gemma3-1b"
MOE = "granite-moe-3b-a800m"
#: max_seq of the two dense families' caches (serve_gemma3's and
#: serve_moe's): gemma3-1b's 1024-token ring wraps well inside it
FAMILY_S = 4096
FAMILY_SHAPES = [   # gemma3-1b's global layers (head dim 256) and granite's
    (GEMMA, 4, 1, 256, torch.bfloat16), (GEMMA, 4, 1, 256, torch.float32),
    (MOE, 24, 8, 64, torch.bfloat16), (MOE, 24, 8, 64, torch.float32)]
# the scan: float32 sums over a chunk in another order and exp of another
# library (the reference's kernel tests hold it to the same bound)
SSD_TOL = 2e-3
SSD_SHAPES = [   # (model, heads, head dim P, state N, chunk L, tokens t,
    # x / dt / B / C type)
    (ZAMBA, 112, 64, 64, 256, 1024, torch.float32),
    (ZAMBA, 112, 64, 64, 215, 1075, torch.float32),  # five chunks of 215
    ("mamba2-1.3b", 64, 64, 128, 256, 1024, torch.float32),
    # served prefills, in bf16 as mamba2.py passes them; by the model's
    # rule an odd 887-token prefill scans at chunk 1, 251 tokens at 251,
    # 1024 at 256 (and at chunk 1 beside it: the kernel ignores the chunk)
    (ZAMBA, 112, 64, 64, 1, 887, torch.bfloat16),
    (ZAMBA, 112, 64, 64, 251, 251, torch.bfloat16),
    (ZAMBA, 112, 64, 64, 256, 1024, torch.bfloat16),
    (ZAMBA, 112, 64, 64, 1, 1024, torch.bfloat16),
]
#: half a bf16 step of a value v is at most 2^-8 |v|: a bf16 y is the
#: float32 result rounded once, and its error counts beyond that
BF16_HALF_STEP = 2.0 ** -8

# every kernel wrapper of the port (the launch counters live on these
# function objects, whatever a comparison swaps into the model's modules)
KERNELS = {
    "paged_decode_attention": dec_ops.paged_decode_attention,
    "paged_chunked_prefill_attention":
        pf_ops.paged_chunked_prefill_attention,
    "decode_attention": dec_ops.decode_attention,
    "chunked_prefill_attention": pf_ops.chunked_prefill_attention,
    "ssd_scan": ssd_ops.ssd_scan,
}
PAGED_KERNELS = ("paged_decode_attention", "paged_chunked_prefill_attention")
DENSE_KERNELS = ("decode_attention", "chunked_prefill_attention", "ssd_scan")


def launch_counts(names):
    return {n: KERNELS[n].launches for n in names}


def reset_counts(names):
    for n in names:
        KERNELS[n].launches = 0


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def time_ms(fn, n: int = 10) -> float:
    """Mean milliseconds of one call of ``fn`` with a cold L2, as a
    serving step finds its KV: before each call, outside its own pair of
    CUDA events, a buffer of L2_FLUSH_BYTES (the L2 holds 50 MB) is
    overwritten.  A queue of such writes first gives the host a head
    start, so that the events time the device, not the host's enqueueing.
    One warm-up call before."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=DEV)
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for _ in range(HEAD_START_FLUSHES):
        flush.zero_()
    for a, b in events:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / n


def bound(nbytes, flops, dtype):
    """The least time the card could take: the larger of ``nbytes`` over
    the HBM rate and ``flops`` over the peak rate of ``dtype``."""
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def make_pool(seed, n_blk, hkv, d, dtype, quant):
    """A [P + 1, Hkv, D] pool pair as the model holds it (dump row last),
    filled from a seeded generator on the card."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    rows = n_blk * BLOCK + 1
    k = torch.randn((rows, hkv, d), device=DEV, generator=g)
    v = torch.randn((rows, hkv, d), device=DEV, generator=g)
    if not quant:
        return k.to(dtype), v.to(dtype), None, None
    kq, ks = attn_lib.quantize_int8(k)
    vq, vs = attn_lib.quantize_int8(v)
    return kq, vq, ks, vs


def make_tables(seed, n_blk, need_tokens, width):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_blk)
    tables = np.full((len(need_tokens), width), -1, np.int32)
    at = 0
    for b, n in enumerate(need_tokens):
        nb = -(-int(n) // BLOCK)
        tables[b, :nb] = perm[at:at + nb]
        at += nb
    assert at <= n_blk
    return torch.from_numpy(tables).to(DEV)


def pool_item_bytes(k, quant):
    """Bytes one (token, KV head) of K or V costs to read."""
    return k.shape[2] * k.element_size() + (4 if quant else 0)


def check_decode(shape_name, quant, lengths, n_blk=8192):
    hq, hkv, d, dtype = SHAPES[shape_name]
    B = len(lengths)
    k, v, ks, vs = make_pool(1, n_blk, hkv, d, dtype, quant)
    # the table width as the engine buckets it (pack_mixed): a power of 2
    width = bucket_batch(-(-max(lengths) // BLOCK))
    tables = make_tables(2, n_blk, lengths, width)
    g = torch.Generator(device=DEV)
    g.manual_seed(3)
    q = torch.randn((B, hq, d), device=DEV, generator=g).to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    kw = dict(block_size=BLOCK, k_scale=ks, v_scale=vs)
    run = lambda: dec_ops.paged_decode_attention(q, k, v, tables, ln, **kw)
    plain = lambda: dec_ops.paged_decode_attention_ref(q, k, v, tables, ln,
                                                       **kw)
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    assert out.shape == ref.shape and out.dtype == dtype
    assert torch.isfinite(out.float()).all(), "decode kernel: non-finite"
    assert not out[ln == 0].any(), "decode kernel: empty row not zero"
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], f"decode {shape_name} quant={quant}: {err}"
    # the library call: one SDPA over the gathered dense KV (timed alone)
    kd = gather_kv(k, ks, tables, BLOCK).to(dtype).transpose(1, 2)
    vd = gather_kv(v, vs, tables, BLOCK).to(dtype).transpose(1, 2)
    mask = (torch.arange(kd.shape[2], device=DEV)[None, :]
            < ln[:, None])[:, None, None, :]
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None, :], kd, vd, attn_mask=mask, enable_gqa=True)
    keys = sum(lengths)
    nbytes = (2 * keys * hkv * pool_item_bytes(k, quant)
              + 2 * q.numel() * q.element_size()
              + tables.numel() * 4 + ln.numel() * 4)
    return {"kernel": "paged_decode_attention", "shape": shape_name,
            "pool": "int8" if quant else str(dtype).split(".")[1],
            "B": B, "max_ctx": max(lengths), "max_abs_err": err,
            "tol": TOL[dtype], "ms": time_ms(run),
            "plain_ms": time_ms(plain), "library_ms": time_ms(lib),
            **bound(nbytes, 4.0 * hq * d * keys, dtype)}


def check_prefill(shape_name, quant, starts, valids, tq, n_blk=8192):
    hq, hkv, d, dtype = SHAPES[shape_name]
    B = len(starts)
    ends = [s + n for s, n in zip(starts, valids)]
    k, v, ks, vs = make_pool(4, n_blk, hkv, d, dtype, quant)
    width = -(-max(ends) // BLOCK)
    tables = make_tables(5, n_blk, ends, width)
    g = torch.Generator(device=DEV)
    g.manual_seed(6)
    q = torch.randn((B, tq, hq, d), device=DEV, generator=g).to(dtype)
    st = torch.tensor(starts, dtype=torch.int32, device=DEV)
    vl = torch.tensor(valids, dtype=torch.int32, device=DEV)
    kw = dict(block_size=BLOCK, k_scale=ks, v_scale=vs)
    run = lambda: pf_ops.paged_chunked_prefill_attention(
        q, k, v, tables, st, vl, **kw)
    plain = lambda: pf_ops.paged_chunked_prefill_attention_ref(
        q, k, v, tables, st, vl, **kw)
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    assert out.shape == ref.shape and out.dtype == dtype
    assert torch.isfinite(out.float()).all(), "prefill kernel: non-finite"
    err = 0.0
    for b in range(B):
        n = valids[b]     # tokens past valid are the caller's to drop
        if n:
            err = max(err, (out[b, :n].float() - ref[b, :n].float())
                      .abs().max().item())
        else:
            assert not out[b].any(), "prefill kernel: padding row not zero"
    assert err <= TOL[dtype], f"prefill {shape_name} quant={quant}: {err}"
    del ref
    kd = gather_kv(k, ks, tables, BLOCK).to(dtype).transpose(1, 2)
    vd = gather_kv(v, vs, tables, BLOCK).to(dtype).transpose(1, 2)
    kpos = torch.arange(kd.shape[2], device=DEV)[None, None, :]
    qpos = (st[:, None] + torch.arange(tq, device=DEV)[None, :])[:, :, None]
    mask = ((kpos <= qpos) & (kpos < (st + vl)[:, None, None]))[:, None]
    qt = q.transpose(1, 2)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kd, vd, attn_mask=mask, enable_gqa=True)
    # what THIS batch needs: keys below each row's frontier and their table
    # entries once, the valid tokens' queries (tokens past `valid` are not
    # read), the whole output (zeros past `valid`), and a query-key pair for
    # every valid token and every key it may see
    live = [b for b in range(B) if valids[b]]
    pairs = sum(n * s + n * (n + 1) // 2 for s, n in zip(starts, valids))
    nbytes = (2 * sum(ends[b] for b in live) * hkv * pool_item_bytes(k, quant)
              + sum(-(-ends[b] // BLOCK) for b in live) * 4
              + sum(valids) * hq * d * q.element_size()
              + q.numel() * q.element_size() + 8 * B)
    return {"kernel": "paged_chunked_prefill_attention", "shape": shape_name,
            "pool": "int8" if quant else str(dtype).split(".")[1],
            "B": B, "Tq": tq, "max_ctx": max(ends), "max_abs_err": err,
            "tol": TOL[dtype], "ms": time_ms(run),
            "plain_ms": time_ms(plain), "library_ms": time_ms(lib),
            **bound(nbytes, 4.0 * hq * d * pairs, dtype)}


def phase_kernels():
    # decode: 16 rows, contexts to 4096 on and off block boundaries, one
    # empty row; prefill: a mixed batch padded to Tq = 1024 with padding,
    # decode (valid 1), short and full chunks at offsets up to 3072
    lengths = [0, 1, 17, 256, 1024, 4096, 4095, 2049,
               512, 777, 1500, 3000, 64, 2048, 1333, 3583]
    starts = [0, 4000, 100, 7, 3072, 512, 0, 2900]
    valids = [0, 1, 17, 256, 1024, 1024, 1024, 1]
    cases = []
    for shape in SHAPES:
        for quant in (False, True):
            cases.append(check_decode(shape, quant, lengths))
            cases.append(check_prefill(shape, quant, starts, valids, 1024))
    # the decode batch of the serve phase: 32 rows, contexts 128-2176
    serve_lengths = np.random.default_rng(10).integers(128, 2177, 32)
    cases.append(check_decode(MODEL, False, serve_lengths.tolist()))
    # the D-heavy instance's mixed batch: a 256-token chunk at offset 1024
    # beside 13 decode rows (contexts 128-2176), padded to Tq 256
    ctx = np.random.default_rng(11).integers(128, 2177, 13).tolist()
    cases.append(check_prefill(MODEL, False, [1024] + [c - 1 for c in ctx],
                               [256] + [1] * 13, 256))
    emit("kernels", cases=cases, launches={
        "paged_decode_attention": dec_ops.paged_decode_attention.launches,
        "paged_chunked_prefill_attention":
            pf_ops.paged_chunked_prefill_attention.launches})
    return cases


# ---------------------------------------------------------------------------
# the model at full width: kernels vs plain versions
# ---------------------------------------------------------------------------

class plain_kernels:
    """Route the model's cache reads and scans to the kernels' plain
    versions — for this script's comparison only; the port itself never
    does."""

    SWAPS = [
        (attn_lib, "paged_decode_attention",
         dec_ops.paged_decode_attention_ref),
        (attn_lib, "paged_chunked_prefill_attention",
         pf_ops.paged_chunked_prefill_attention_ref),
        (attn_lib, "decode_attention", dec_ops.decode_attention_ref),
        (attn_lib, "chunked_prefill_attention",
         pf_ops.chunked_prefill_attention_ref),
        (ssd_ops, "ssd_scan", ssd_ops.ssd_scan_ref),
    ]

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name, _ in self.SWAPS]
        for mod, name, fn in self.SWAPS:
            setattr(mod, name, fn)

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _float_tree(tree):
    if isinstance(tree, dict):
        return {k: _float_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_float_tree(v) for v in tree]
    return tree.float()


@torch.no_grad()
def phase_model(cfg, params):
    """One mixed forward (full chunk, decode row, short chunk, padding
    row) and one decode forward over the same pool, three ways: bf16
    through the kernels, bf16 through the plain versions, float32 through
    both.  In float32 kernel and plain path must agree to MODEL_TOL_F32.
    In bf16 the two paths round at other places and drift apart over 36
    layers, so each is held against the float32 result: the kernel path
    may be no further from it than the plain path is (times 1.5, plus
    MODEL_TOL_BF16_SLACK)."""
    n_blk, B, T = 256, 4, 256
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(B, T)).astype(np.int32)).to(DEV)
    start = torch.tensor([0, 700, 33, 0], dtype=torch.int32, device=DEV)
    valid = torch.tensor([256, 1, 100, 0], dtype=torch.int32, device=DEV)
    tables = make_tables(8, n_blk, [256, 701, 133, 0], 64)
    pos = start[:, None] + torch.arange(T, dtype=torch.int32,
                                        device=DEV)[None]
    tok1 = tokens[:, :1].contiguous()
    pos1 = (start + valid)[:, None]
    # give row 1 (a decode row at position 700) a context to attend over
    g = torch.Generator(device=DEV)
    g.manual_seed(9)
    seed_pool = tf.init_paged_cache(cfg, n_blk, BLOCK, device=DEV)
    for name in ("k", "v"):
        seed_pool[name][:, :-1] = torch.randn(
            seed_pool[name][:, :-1].shape, device=DEV, generator=g
        ).to(seed_pool[name].dtype)

    def run(prm, dtype, plain):
        pool = {n: t.to(dtype) for n, t in seed_pool.items()}
        n0 = launch_counts(PAGED_KERNELS)
        with plain_kernels() if plain else contextlib.nullcontext():
            mixed, _, _ = tf.forward(prm, cfg, tokens, pos, pool,
                                     valid_len=valid,
                                     block_tables=(tables, BLOCK))
            dec, _, _ = tf.forward(prm, cfg, tok1, pos1, pool,
                                   block_tables=(tables, BLOCK))
        torch.cuda.synchronize()
        want = 0 if plain else cfg.num_layers
        n1 = launch_counts(PAGED_KERNELS)
        assert all(n1[k] - n0[k] == want for k in n0), (n0, n1)
        assert mixed.shape == (B, T, cfg.vocab_size) and mixed.dtype == dtype
        assert torch.isfinite(mixed[:3].float()).all()
        assert torch.isfinite(dec.float()).all()
        return mixed.float(), dec.float()

    def scaled_err(a, b):
        worst = 0.0
        for r in range(3):                  # row 3 is padding
            n = int(valid[r])
            for x, y in ((a[0][r, :n], b[0][r, :n]), (a[1][r], b[1][r])):
                scale = max(y.abs().max().item(), 1.0)
                worst = max(worst, (x - y).abs().max().item() / scale)
        return worst

    bf_kernel = run(params, torch.bfloat16, plain=False)
    bf_plain = run(params, torch.bfloat16, plain=True)
    params32 = _float_tree(params)
    f32_kernel = run(params32, torch.float32, plain=False)
    f32_plain = run(params32, torch.float32, plain=True)
    del params32
    err_f32 = scaled_err(f32_kernel, f32_plain)
    err_kernel = scaled_err(bf_kernel, f32_plain)
    err_plain = scaled_err(bf_plain, f32_plain)
    assert err_f32 <= MODEL_TOL_F32, err_f32
    assert err_kernel <= 1.5 * err_plain + MODEL_TOL_BF16_SLACK, \
        (err_kernel, err_plain)
    agree = (bf_kernel[0][0].argmax(-1) == f32_plain[0][0].argmax(-1))
    emit("model", model=cfg.name, layers=cfg.num_layers,
         logits_shape=list(bf_kernel[0].shape),
         f32_kernel_vs_plain=err_f32, f32_tol=MODEL_TOL_F32,
         bf16_kernel_vs_f32=err_kernel, bf16_plain_vs_f32=err_plain,
         bf16_kernel_vs_bf16_plain=scaled_err(bf_kernel, bf_plain),
         bf16_greedy_agreement_with_f32=agree.float().mean().item())
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the main path: a TaiChi cluster serving requests
# ---------------------------------------------------------------------------

class TimedExecutor(TorchExecutor):
    """TorchExecutor that also logs, for every iteration, what ran, its
    decode steps (the horizon K of a decode-only iteration, else 1),
    whether it replayed a captured graph, how long dispatch and dispatch +
    readback took on the host clock, and the device milliseconds between
    two CUDA events around the dispatch."""

    def __init__(self, *a, log, **kw):
        super().__init__(*a, **kw)
        self.log = log

    def step_async(self, plan):
        rows = [(take, req.prefill_pos + req.recompute_offset)
                for req, take in plan.prefill_items]
        rids = [req.rid for req, _ in plan.prefill_items]
        ctxs = [int(self.positions[self.slots.slot(r.rid)])
                for r in plan.decode_reqs]
        steps = 1 if rows else getattr(plan, "horizon", 1)
        captures, replays = self.graphs.captures, self.graphs.replays
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        step = super().step_async(plan)
        ev1.record()
        t1 = time.perf_counter()
        if not isinstance(step, PendingStep):
            return step
        inner = step.resolve
        replayed = self.graphs.replays > replays
        captured = self.graphs.captures > captures

        def resolve():
            first = not step.resolved
            eos = inner()
            if first:
                self.log.append({"prefill": rows, "prefill_rids": rids,
                                 "decode": ctxs, "steps": steps,
                                 "replayed": replayed, "captured": captured,
                                 "dispatch_s": t1 - t0,
                                 "total_s": time.perf_counter() - t0,
                                 "device_ms": ev0.elapsed_time(ev1)})
            return eos

        step.resolve = resolve
        return step


def graph_stats(executors, log):
    """What the executors' CUDA graphs did in a run, and the decode-only
    iterations split into replays and first uses (eager run + capture):
    host ms of dispatch + readback, and device ms a decode step (between
    the events around the dispatch, over the iteration's steps)."""
    dec = [e for e in log if not e["prefill"]]

    def ms(entries, key, per_step=False):
        xs = [1e3 * e[key] if key.endswith("_s") else e[key]
              for e in entries]
        if per_step:
            xs = [x / e["steps"] for x, e in zip(xs, entries)]
        return ({"mean": float(np.mean(xs)), "p50": float(np.median(xs)),
                 "min": float(np.min(xs)), "max": float(np.max(xs)),
                 "n": len(xs)} if xs else None)

    replays = [e for e in dec if e["replayed"]]
    firsts = [e for e in dec if e["captured"]]
    by_k = collections.defaultdict(list)
    for e in replays:
        by_k[e["steps"]].append(e)
    return {"graphs": sum(len(ex.graphs) for ex in executors),
            "captures": sum(ex.graphs.captures for ex in executors),
            "capture_s": sum(ex.graphs.capture_seconds for ex in executors),
            "replays": sum(ex.graphs.replays for ex in executors),
            "decode_only_replay_total_ms": ms(replays, "total_s"),
            "decode_only_replay_dispatch_ms": ms(replays, "dispatch_s"),
            "decode_only_first_use_total_ms": ms(firsts, "total_s"),
            "replay_device_ms_a_step_by_k": {
                k: ms(v, "device_ms", per_step=True)
                for k, v in sorted(by_k.items())},
            "replay_total_ms_a_step_by_k": {
                k: ms(v, "total_s", per_step=True)
                for k, v in sorted(by_k.items())}}


def derive_derates(log, cost):
    """The estimator's three derates from the measured iterations.  The
    estimator adds ``iteration_overhead_s`` to the larger of FLOPs /
    (peak * ``prefill_mfu``) and bytes / (bandwidth * ``decode_membw_eff``).

    * the overhead is the mean time the host needs to enqueue a
      decode-only iteration (``dispatch_s``): with an eager per-layer loop
      no iteration is shorter than that, whatever its batch;
    * the decode bandwidth share is model bytes over what the mean
      decode-only iteration leaves after the overhead, and the prefill MFU
      model FLOPs over what the mean prefill-only iteration leaves.  The
      device works while the host still enqueues, so the remainder
      understates its time: it is floored at a quarter of the iteration.
    FLOPs and bytes are the estimator's own (``CostModel``)."""
    inst = cost.inst
    pre = [e for e in log if e["prefill"] and not e["decode"]]
    dec = [e for e in log if e["decode"] and not e["prefill"]]
    mixed = [e for e in log if e["decode"] and e["prefill"]]

    def flops(e):
        n = sum(t for t, _ in e["prefill"]) + len(e["decode"])
        f = cost._matmul_flops(n)
        f += sum(cost._attn_flops(t, c) for t, c in e["prefill"])
        return f + sum(cost._attn_flops(1, c) for c in e["decode"])

    def nbytes(e):
        b = float(cost.weight_bytes)
        b += sum(cost._kv_read_bytes(c) for c in e["decode"])
        return b + sum(cost._kv_read_bytes(c) + t * cost.kv_bytes_per_token()
                       for t, c in e["prefill"])

    def mean(xs):
        return float(np.mean(xs))

    out = {"prefill_only_iterations": len(pre),
           "decode_only_iterations": len(dec),
           "mixed_iterations": len(mixed)}
    if mixed:
        out["mixed_mean_s"] = mean([e["total_s"] for e in mixed])
        out["mixed_mean_prefill_tokens"] = mean(
            [sum(t for t, _ in e["prefill"]) for e in mixed])
        out["mixed_mean_decode_rows"] = mean(
            [len(e["decode"]) for e in mixed])
    if not (pre and dec):
        return out
    t_dec = mean([e["total_s"] for e in dec])
    t_pre = mean([e["total_s"] for e in pre])
    overhead = mean([e["dispatch_s"] for e in dec])
    out.update(
        decode_only_mean_s=t_dec,
        decode_only_mean_batch=mean([len(e["decode"]) for e in dec]),
        decode_only_mean_context=mean(
            [c for e in dec for c in e["decode"]]),
        prefill_only_mean_s=t_pre,
        prefill_only_mean_dispatch_s=mean([e["dispatch_s"] for e in pre]),
        prefill_only_mean_tokens=mean(
            [sum(t for t, _ in e["prefill"]) for e in pre]),
        iteration_overhead_s=overhead,
        decode_membw_eff=mean([nbytes(e) for e in dec])
        / max(t_dec - overhead, t_dec / 4) / inst.hbm_bw,
        prefill_mfu=mean([flops(e) for e in pre])
        / max(t_pre - overhead, t_pre / 4) / inst.flops,
        in_use={"prefill_mfu": inst.hw.prefill_mfu,
                "decode_membw_eff": inst.hw.decode_membw_eff,
                "iteration_overhead_s": inst.hw.iteration_overhead_s})
    return out


def raise_exec_error(inst, now, exc):
    """The cluster would quarantine the instance and carry on: here a
    failed executor step fails the run."""
    raise exc


def count_params(params):
    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        elif isinstance(tree, list):
            for v in tree:
                yield from leaves(v)
        else:
            yield tree
    return sum(t.numel() for t in leaves(params))


def check_finished(cfg, reqs, cluster):
    for r in reqs:
        assert r.state.value == "finished", (r.rid, r.state)
        assert len(r.output_tokens) == r.target_output_len, \
            (r.rid, len(r.output_tokens), r.target_output_len)
        assert all(0 <= t < cfg.vocab_size for t in r.output_tokens)
    assert cluster.exec_errors == 0, cluster.last_exec_error
    assert cluster.transfer_count > 0, "no flowing-decode migration ran"


def phase_serve(cfg, params):
    log = []
    sc = ServingConfig(model=MODEL, tp=1, policy="taichi",
                       sliders=Sliders(n_p=1, n_d=1, s_p=1024, s_d=256),
                       hbm_blocks=8192, block_size=BLOCK)
    factory = lambda: TimedExecutor(cfg, params, n_slots=32, max_seq=4096,
                                    hbm_blocks=8192, device=DEV, log=log)
    slo = SLO(ttft=5.0, tpot=0.2)
    cluster = build_cluster(sc, slo, seed=0, executor_factory=factory)
    cluster._on_exec_error = raise_exec_error
    reqs = serve_workload(cfg)
    executors = [inst.executor for inst in cluster.policy.instances]
    pool_bytes = sum(ex.cache_bytes() for ex in executors)

    # counts to 0 just before the main path, read just after
    reset_counts(PAGED_KERNELS)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cluster.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(PAGED_KERNELS)

    check_finished(cfg, reqs, cluster)
    assert all(n > 0 for n in launches.values()), launches
    iterations = sum(inst.iterations for inst in cluster.policy.instances)
    readbacks = sum(ex.host_readbacks for ex in executors)
    assert 0 < readbacks <= iterations, (readbacks, iterations)
    assert len(log) == readbacks
    assert launches["paged_decode_attention"] \
        + launches["paged_chunked_prefill_attention"] \
        == readbacks * cfg.num_layers
    # every decode-only iteration replays a graph, or captures one at its
    # bucket's first use; no other iteration does either
    assert all((e["replayed"] or e["captured"]) == (not e["prefill"])
               for e in log)
    for ex in executors:
        ex.kv.check_invariants()
    out_tokens = sum(len(r.output_tokens) for r in reqs)
    in_tokens = sum(r.prompt_len for r in reqs)
    derates = derive_derates(log, cluster.cost)
    emit("serve", model=cfg.name, policy="taichi", requests=len(reqs),
         prompt_tokens=in_tokens, output_tokens=out_tokens,
         wall_s=wall, output_tokens_per_s=out_tokens / wall,
         total_tokens_per_s=(in_tokens + out_tokens) / wall,
         iterations=iterations, host_readbacks=readbacks,
         host_syncs=sum(ex.host_syncs for ex in executors),
         transfers=cluster.transfer_count, launches=launches,
         kv_pool_bytes=pool_bytes,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         graphs=graph_stats(executors, log), measured=derates)
    return launches


def serve_workload(cfg):
    """The 32 seeded requests of ``serve`` (and ``live``), at 8 a second."""
    wl = WorkloadSpec("smoke",
                      LengthDist(mu=6.5, sigma=0.8, lo=128, hi=2048),
                      LengthDist(mu=4.0, sigma=0.6, lo=16, hi=128),
                      tokenized=True, vocab_size=cfg.vocab_size)
    return wl.sample_requests(32, qps=8.0, seed=0)


def pct(xs, q):
    return float(np.percentile(xs, q)) if xs else None


def phase_live(cfg, params, name="live", executors=None):
    """The reference's main path, ``--engine live``: the online
    ``ServingLoop`` paced by a ``WallClock`` over a non-blocking cluster
    (one P-heavy and one D-heavy instance) with decode horizons up to K =
    8, greedy, serving ``serve``'s 32 requests as they arrive.  Reports
    the loop's own TTFT / TPOT (on the estimator's clock, which the
    pacing follows) beside the wall-clock ones the token sink saw, and
    the device ms a decode step inside the replayed horizons.

    Given the ``executors`` of an earlier run (idle, their graphs
    captured), the cluster is built over them: the run then replays
    from its first horizon on.  Returns (launches, executors)."""
    log = []
    sc = ServingConfig(model=MODEL, tp=1, policy="taichi",
                       sliders=Sliders(n_p=1, n_d=1, s_p=1024, s_d=256),
                       hbm_blocks=8192, block_size=BLOCK)
    if executors is None:
        factory = lambda: TimedExecutor(cfg, params, n_slots=32,
                                        max_seq=4096, hbm_blocks=8192,
                                        device=DEV, log=log)
    else:
        for ex in executors:
            ex.log = log
        factory = iter(executors).__next__
    slo = SLO(ttft=5.0, tpot=0.2)
    cluster = build_cluster(sc, slo, seed=0, executor_factory=factory,
                            async_exec=True)
    cluster.set_horizon(8)
    cluster._on_exec_error = raise_exec_error
    reqs = serve_workload(cfg)
    executors = [inst.executor for inst in cluster.instances]
    before = {k: sum(getattr(ex, k) for ex in executors)
              for k in ("host_readbacks", "host_syncs", "horizon_calls",
                        "horizon_tokens")}
    captures = {id(ex): (ex.graphs.captures, ex.graphs.capture_seconds)
                for ex in executors}
    walls = collections.defaultdict(list)
    streamed = {"tokens": 0}

    def sink(req, t, tok):
        streamed["tokens"] += 1
        walls[req.rid].append(clock.now)

    # counts to 0 just before the main path, read just after
    reset_counts(PAGED_KERNELS)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    clock = WallClock()
    loop = ServingLoop(cluster, slo, arrivals=iter(reqs), on_token=sink,
                       clock=clock, pace=True)
    t0 = time.perf_counter()
    loop.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(PAGED_KERNELS)

    real = sum(len(r.output_tokens) for r in reqs)
    assert streamed["tokens"] == real, (streamed, real)
    for r in reqs:
        assert r.state.value == "finished", (r.rid, r.state)
        assert len(r.output_tokens) == r.target_output_len
    assert cluster.exec_errors == 0, cluster.last_exec_error
    assert all(n > 0 for n in launches.values()), launches
    hist = collections.Counter()
    for inst in cluster.instances:
        hist.update(inst.horizon_hist)
    assert max(hist) >= 2, f"no horizon of K >= 2 was planned: {hist}"
    got = {k: sum(getattr(ex, k) for ex in executors) - n
           for k, n in before.items()}
    assert len(log) == got["host_readbacks"]
    assert launches["paged_decode_attention"] \
        + launches["paged_chunked_prefill_attention"] \
        == sum(e["steps"] for e in log) * cfg.num_layers
    assert all((e["replayed"] or e["captured"]) == (not e["prefill"])
               for e in log)
    for ex in executors:
        ex.kv.check_invariants()
    ttft = [walls[r.rid][0] - r.arrival for r in reqs]
    tpot = [(walls[r.rid][-1] - walls[r.rid][0]) / (len(walls[r.rid]) - 1)
            for r in reqs if len(walls[r.rid]) > 1]
    loop_tpot = [r.tpot() for r in reqs if r.tpot() is not None]
    stats = graph_stats(executors, log)
    stats["captures_this_run"] = sum(
        ex.graphs.captures - captures[id(ex)][0] for ex in executors)
    stats["capture_s_this_run"] = sum(
        ex.graphs.capture_seconds - captures[id(ex)][1] for ex in executors)
    emit(name, model=cfg.name, policy="taichi", requests=len(reqs),
         horizon=8, async_exec=True, pace="WallClock",
         output_tokens=real, streamed_tokens=streamed["tokens"],
         wall_s=wall, output_tokens_per_s=real / wall,
         wall_ttft_s={"p50": pct(ttft, 50), "p90": pct(ttft, 90)},
         wall_tpot_s={"p50": pct(tpot, 50), "p90": pct(tpot, 90)},
         loop_ttft_s={"p50": pct([r.ttft() for r in reqs], 50),
                      "p90": pct([r.ttft() for r in reqs], 90)},
         loop_tpot_s={"p50": pct(loop_tpot, 50), "p90": pct(loop_tpot, 90)},
         slo={"ttft_s": slo.ttft, "tpot_s": slo.tpot},
         wall_slo_attainment=sum(
             a <= slo.ttft and b <= slo.tpot
             for a, b in zip(ttft, tpot)) / len(reqs),
         loop_summary=loop.stats(8.0).summary(),
         horizon_hist=dict(sorted(hist.items())), **got,
         tokens_a_readback=real / got["host_readbacks"],
         transfers=cluster.transfer_count, launches=launches,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         graphs=stats)
    return launches, executors


# ---------------------------------------------------------------------------
# the KV tiers' tensor legs: host spill, prefix replication, checkpoints
# ---------------------------------------------------------------------------

TIER_HOT, TIER_COLD = 1024, 1536     # tokens: 64 blocks, then 96
TIER_POOL = 100                      # blocks: the cold prompt needs them all


class TimedLegs:
    """A spill tier's fetch and load legs, timed on the host clock (each
    leg returns only when its copy has landed)."""

    def __init__(self, ex):
        self.ex = ex
        self.fetch_s = self.load_s = 0.0
        self.fetches = self.loads = 0
        ex.prefix_cache_obj.bind_tiers(fetch_block=self.fetch,
                                       load_block=self.load)

    def fetch(self, bid):
        t0 = time.perf_counter()
        out = self.ex.fetch_block(bid)
        self.fetch_s += time.perf_counter() - t0
        self.fetches += 1
        return out

    def load(self, bid, payload):
        t0 = time.perf_counter()
        self.ex.load_block(bid, payload)
        torch.cuda.current_stream().synchronize()
        self.load_s += time.perf_counter() - t0
        self.loads += 1


def tier_executor(cfg, params, blocks, spill=0):
    """A paged int8-pool executor with a prefix cache (and, given
    ``spill``, a host spill tier) under one D-heavy instance."""
    ex = TorchExecutor(cfg, params, n_slots=4, max_seq=4096,
                       hbm_blocks=blocks, prefix_cache=True,
                       kv_quant="int8", kv_spill_blocks=spill, device=DEV)
    inst = Instance(0, D_HEAVY, 1024, CostModel(cfg, InstanceSpec(tp=1)),
                    ex, hbm_blocks=blocks)
    assert inst.prefix_cache is ex.prefix_cache_obj
    return ex, inst


def serve_alone(inst, prompt, n_out=16, probe=None):
    """Serve one request to its end on ``inst`` (``probe(req)`` runs once
    after its second token, while it is resident)."""
    r = Request(prompt_len=len(prompt), max_new_tokens=n_out,
                hidden_output_len=n_out, prompt_tokens=list(prompt))
    inst.enqueue_prefill(r)
    now = 0.0
    for _ in range(10 * n_out):
        if r.done():
            break
        dur, done, _ = inst.run_iteration(now)
        now += dur
        for d in done:
            inst.admit_decode(d)
        if probe is not None and r.output_len == 2:
            probe(r)
            probe = None
    assert r.done() and len(r.output_tokens) == n_out, r.state
    return r


def host_bit_equal(a, b, blocks):
    """Two block payloads (host tensors, [L, blocks * 16, ...] a leaf)
    equal bit for bit on their first ``blocks`` blocks."""
    n = blocks * BLOCK
    return set(a) == set(b) and all(
        torch.equal(a[k][:, :n], b[k][:, :n]) for k in a)


@torch.no_grad()
def phase_tiers(cfg, params):
    """The host spill tier, hot-prefix replication and checkpoint blocks
    at qwen2.5-3b's full width on int8 pools (``tests/test_kv_tiers_live
    .py``'s spill case at full width): a 1024-token hot prefix (64
    blocks) is served, evicted to the host by a 1536-token cold prompt
    that needs the whole 100-block pool, and promoted back for its next
    hit.  Held: the promoted blocks bit-equal to their contents before
    the eviction, the re-served request's tokens equal to a never-evicted
    run's at the same batch shapes (the prefix cached in the pool), a
    replicated prefix's blocks bit-equal on the importer and its decode's
    tokens equal to the locally prefilled run's, and checkpoint blocks
    equal to the pool slices they name."""
    rng = np.random.default_rng(41)
    hot, cold = ([int(x) for x in rng.integers(1, cfg.vocab_size, size=n)]
                 for n in (TIER_HOT, TIER_COLD))
    full = TIER_HOT // BLOCK
    # counts to 0 just before the tiers' path, read just after
    reset_counts(PAGED_KERNELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    # control: the hot prefix never leaves the pool
    ctl, ctl_inst = tier_executor(cfg, params, 4 * TIER_POOL)
    serve_alone(ctl_inst, hot)
    ctl_again = serve_alone(ctl_inst, hot)

    # pressured pool with a host tier
    ex, inst = tier_executor(cfg, params, TIER_POOL, spill=2 * TIER_POOL)
    legs = TimedLegs(ex)
    pc = ex.prefix_cache_obj
    serve_alone(inst, hot)
    before = ex.export_prefix_blocks(hot)
    assert before["n_blocks"] == full and before["kv_format"] == "int8"
    checkpoint = {}

    def check_checkpoint(r):
        n = ex.kv.allocator.owned_count(r.rid)
        got = ex.export_request_blocks(r, range(n))
        bids = ex.kv.allocator.owned(r.rid)
        checkpoint["blocks"] = len(got)
        checkpoint["equal"] = all(
            torch.equal(e["kv"][k], leaf[:, bids[i] * BLOCK:
                                         (bids[i] + 1) * BLOCK].cpu())
            for i, e in got.items() for k, leaf in ex.kv.pool.items())
    serve_alone(inst, cold, probe=check_checkpoint)
    spilled = pc.spilled_blocks
    assert spilled >= full and pc.match_tokens(hot + [0]) == 0, spilled
    c = serve_alone(inst, hot)
    promoted = inst.spill_promoted_tokens // BLOCK
    after = ex.export_prefix_blocks(hot)
    promoted_equal = host_bit_equal(after["paged_blocks"],
                                    before["paged_blocks"], promoted)

    # replication: the control's cached prefix into a fresh executor
    state = ctl.export_prefix_blocks(hot)
    dst, dst_inst = tier_executor(cfg, params, 4 * TIER_POOL)
    t1 = time.perf_counter()
    landed = dst.import_prefix_blocks(state)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t1
    replica_equal = host_bit_equal(dst.export_prefix_blocks(hot)
                                   ["paged_blocks"], state["paged_blocks"],
                                   full)
    replica = serve_alone(dst_inst, hot)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(PAGED_KERNELS)

    for e in (ctl, ex, dst):
        e.kv.check_invariants()
    al = pc.allocator
    assert al.free_blocks + al.cached_blocks + al.used_blocks == TIER_POOL
    block_bytes = ex.kv.token_bytes() * BLOCK
    emit("tiers", model=cfg.name, kv_quant="int8", pool_blocks=TIER_POOL,
         hot_tokens=TIER_HOT, cold_tokens=TIER_COLD,
         spilled_blocks=spilled, promoted_blocks=promoted,
         spill_fetches=legs.fetches, spill_loads=legs.loads,
         fetch_s=legs.fetch_s, load_s=legs.load_s,
         fetch_ms_a_block=1e3 * legs.fetch_s / max(legs.fetches, 1),
         load_ms_a_block=1e3 * legs.load_s / max(legs.loads, 1),
         bytes_a_block=block_bytes,
         promoted_bit_equal=promoted_equal,
         cached_prefix_tokens=c.cached_prefix_len,
         tokens_equal_never_evicted=c.output_tokens
         == ctl_again.output_tokens,
         replicated_blocks=landed, replica_bit_equal=replica_equal,
         import_s=import_s, replica_cached_tokens=replica.cached_prefix_len,
         replica_tokens_equal_local=replica.output_tokens
         == ctl_again.output_tokens,
         checkpoint_blocks=checkpoint.get("blocks"),
         checkpoint_equal_pool=checkpoint.get("equal"),
         int8_launches=launches, wall_s=wall)
    assert promoted >= full - 1, promoted
    assert legs.fetches >= full and legs.loads == promoted
    assert promoted_equal and replica_equal
    assert c.cached_prefix_len >= (full - 1) * BLOCK
    assert c.output_tokens == ctl_again.output_tokens
    assert landed == full and replica.cached_prefix_len >= (full - 1) * BLOCK
    assert replica.output_tokens == ctl_again.output_tokens
    assert checkpoint.get("blocks", 0) > 0 and checkpoint["equal"]
    assert all(n > 0 for n in launches.values()), launches
    del ctl, ex, dst
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the OpenAI-compatible front end over the live loop
# ---------------------------------------------------------------------------

FRONTEND_CLIENTS = 8
FRONTEND_MAX_TOKENS = 32


def http_exchange(port, method, path, body=None):
    """One HTTP/1.1 exchange on loopback; returns (status, raw body,
    send time, arrival times of the ``data:`` frames) on the monotonic
    clock."""
    raw = b"" if body is None else json.dumps(body).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=120)
    frames, data = [], b""
    try:
        t_send = time.monotonic()
        s.sendall((f"{method} {path} HTTP/1.1\r\nHost: smoke\r\n"
                   f"Content-Length: {len(raw)}\r\n"
                   "Connection: close\r\n\r\n").encode() + raw)
        while chunk := s.recv(65536):
            data += chunk
            now = time.monotonic()
            frames += [now] * (data.count(b"data: ") - len(frames))
    finally:
        s.close()
    head, _, payload = data.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), payload, t_send, frames


def sse_text(payload):
    """(text, finished) of a chunked SSE reply: the concatenated deltas,
    and whether it ended with ``[DONE]`` and no error notice."""
    body, rest = b"", payload
    while rest:
        size, _, rest = rest.partition(b"\r\n")
        n = int(size, 16)
        if n == 0:
            break
        body += rest[:n]
        rest = rest[n + 2:]
    text, done, errored = "", False, False
    for ev in body.split(b"\n\n"):
        if ev == b"data: [DONE]":
            done = True
        elif ev.startswith(b"data: "):
            obj = json.loads(ev[len(b"data: "):])
            if "choices" not in obj:
                errored = True
                continue
            ch = obj["choices"][0]
            text += ch.get("text") or ch.get("delta", {}).get("content", "")
    return text, done and not errored


def frontend_request(i, rng):
    """Client ``i``: streaming (even) or whole, completions or chat (every
    third), with a prompt of 200-800 bytes."""
    words = " ".join(f"w{int(x)}" for x in rng.integers(0, 10 ** 6,
                                                        size=120))
    text = f"client {i}: " + words[:int(rng.integers(200, 800))]
    body = {"max_tokens": FRONTEND_MAX_TOKENS, "stream": i % 2 == 0}
    if i % 3 == 1:
        body["messages"] = [{"role": "user", "content": text}]
        return protocol.CHAT_COMPLETIONS, body
    body["prompt"] = text
    return protocol.COMPLETIONS, body


def maps_torch(pid):
    with open(f"/proc/{pid}/maps") as f:
        return "libtorch" in f.read()


def phase_frontend(cfg, executors):
    """``--serve``'s stack at qwen2.5-3b's full width: the
    ``FrontendServer`` on 127.0.0.1 (port 0) over the live loop (a
    ``WallClock``-paced ``ServingLoop`` with K <= 8 horizons, behind an
    admission queue), on ``live``'s executors, whose buckets are
    captured.  Eight concurrent clients, streaming and whole, completions
    and chat; ``/healthz`` and ``/metrics`` scraped once while they run;
    then a graceful drain while the requests are in flight.  Held: status
    200, ``[DONE]``, each reply's text the detokenised ``output_tokens``
    of its request on the server, the usage counts, every request
    finished by the drain, the string work in worker processes that have
    no torch loaded."""
    log = []
    for ex in executors:
        ex.log = log
    sc = ServingConfig(model=MODEL, tp=1, policy="taichi",
                       sliders=Sliders(n_p=1, n_d=1, s_p=1024, s_d=256),
                       hbm_blocks=8192, block_size=BLOCK)
    slo = SLO(ttft=5.0, tpot=0.2)
    cluster = build_cluster(sc, slo, seed=0,
                            executor_factory=iter(executors).__next__,
                            async_exec=True)
    cluster.set_horizon(8)
    cluster._on_exec_error = raise_exec_error
    loop = ServingLoop(cluster, slo, clock=WallClock(), pace=True,
                       admission=AdmissionConfig(max_depth=64,
                                                 max_inflight=16))
    srv = FrontendServer(loop, FrontendConfig(
        port=0, model=MODEL, tok_workers=2))
    rng = np.random.default_rng(43)
    clients = [frontend_request(i, rng) for i in range(FRONTEND_CLIENTS)]
    replies = {}
    captures = sum(ex.graphs.captures for ex in executors)

    def client(i):
        replies[i] = http_exchange(srv.port, "POST", *clients[i])

    # counts to 0 just before the front end's path, read just after
    reset_counts(PAGED_KERNELS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server = threading.Thread(target=srv.run, name="frontend", daemon=True)
    server.start()
    threads = []
    try:
        assert srv.started.wait(timeout=120), "the server did not start"
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(FRONTEND_CLIENTS)]
        for th in threads:
            th.start()
        health = http_exchange(srv.port, "GET", "/healthz")
        metrics = http_exchange(srv.port, "GET", "/metrics")
        # drain once every request is in flight (admitted, streaming)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and srv._engine_thread.is_alive() \
                and not (len(loop.requests) == FRONTEND_CLIENTS
                         and any(r.output_len for r in loop.requests)):
            time.sleep(0.01)
        assert srv._engine_thread.is_alive(), "the engine thread died"
        workers = [p.pid for p in srv.pipeline._procs]
        workers_torch = [maps_torch(pid) for pid in workers]
        drain_at = time.perf_counter()
        in_flight = sum(not r.done() for r in loop.requests)
    finally:
        srv.shutdown()
        for th in threads:
            th.join(timeout=120)
        server.join(timeout=120)
    wall = time.perf_counter() - t0
    drain_s = time.perf_counter() - drain_at
    launches = launch_counts(PAGED_KERNELS)
    assert not server.is_alive() and not any(t.is_alive() for t in threads)

    by_prompt = {tuple(r.prompt_tokens): r for r in loop.requests}
    ttft, tpot, gaps = [], [], []
    usage_ok = wire_ok = 0
    for i, (path, body) in enumerate(clients):
        status, payload, t_send, frames = replies[i]
        assert status == 200, (i, status, payload[:200])
        text_in = protocol.parse_request(path, json.dumps(body).encode()
                                         ).prompt_text
        r = by_prompt[tuple(ByteTokenizer.encode(text_in))]
        assert r.state.value == "finished", (i, r.state)
        assert len(r.output_tokens) == FRONTEND_MAX_TOKENS
        want = ByteTokenizer.decode(r.output_tokens)
        if body["stream"]:
            text, done = sse_text(payload)
            assert done, i
            ttft.append(frames[0] - t_send)
            token_frames = frames[:-2]          # the finish and [DONE]
            gaps += list(np.diff(token_frames))
            if len(token_frames) > 1:
                tpot.append((token_frames[-1] - token_frames[0])
                            / (len(token_frames) - 1))
        else:
            obj = json.loads(payload)
            ch = obj["choices"][0]
            text = ch["text"] if "text" in ch else ch["message"]["content"]
            assert ch["finish_reason"] == "length"
            usage_ok += obj["usage"] == {
                "prompt_tokens": r.prompt_len,
                "completion_tokens": FRONTEND_MAX_TOKENS,
                "total_tokens": r.prompt_len + FRONTEND_MAX_TOKENS}
        wire_ok += text == want
    whole = sum(not b["stream"] for _, b in clients)
    wire = loop.snapshot().get("wire")
    emit("frontend", model=cfg.name, clients=FRONTEND_CLIENTS,
         max_tokens=FRONTEND_MAX_TOKENS, horizon=8,
         prompt_tokens=[len(ByteTokenizer.encode(
             protocol.parse_request(p, json.dumps(b).encode()).prompt_text))
             for p, b in clients],
         status_200=sum(replies[i][0] == 200 for i in replies),
         wire_exact=wire_ok, usage_exact=usage_ok, whole_replies=whole,
         healthz=health[0], metrics_status=metrics[0],
         metrics_keys=sorted(json.loads(metrics[1])),
         wire_engine_to_socket=wire,
         worker_pids=workers, main_pid=os.getpid(),
         worker_torch_loaded=workers_torch,
         seen_worker_pids=sorted(srv.seen_worker_pids),
         in_flight_at_drain=in_flight, drain_s=drain_s,
         client_ttft_s={"p50": pct(ttft, 50), "p90": pct(ttft, 90)},
         client_tpot_s={"p50": pct(tpot, 50), "p90": pct(tpot, 90)},
         client_interframe_s={"p50": pct(gaps, 50), "p90": pct(gaps, 90)},
         captures_this_run=sum(ex.graphs.captures
                               for ex in executors) - captures,
         launches=launches, exec_errors=cluster.exec_errors, wall_s=wall)
    assert wire_ok == FRONTEND_CLIENTS and usage_ok == whole
    assert health[0] == 200 and metrics[0] == 200
    assert workers and not any(workers_torch), workers_torch
    assert srv.seen_worker_pids and os.getpid() not in srv.seen_worker_pids
    assert in_flight > 0, "the drain found no request in flight"
    assert cluster.exec_errors == 0, cluster.last_exec_error
    assert all(n > 0 for n in launches.values()), launches
    return launches


# ---------------------------------------------------------------------------
# captured steps against the same steps run without a graph
# ---------------------------------------------------------------------------

@torch.no_grad()
def captured_vs_uncaptured(ex, key, fn, host):
    """Capture ``fn`` for ``key`` (its first use runs it eagerly), then
    from one copy of the cache replay the graph and run ``fn`` without
    one, on the same host inputs; compare the tokens and every cache
    entry (KV, and recurrent state on the dense path) the two wrote."""
    cache = ex.kv.pool if ex.paged else ex.cache
    saved = {n: t.clone() for n, t in cache.items()}

    def restore():
        for n, t in saved.items():
            cache[n].copy_(t)
    ex._dispatch(key, fn, *host)
    assert key in ex.graphs.graphs, key
    restore()
    replayed = [t.clone() for t in ex._dispatch(key, fn, *host)]
    after = {n: t.clone() for n, t in cache.items()}
    restore()
    plain = fn(*(torch.from_numpy(np.array(a)).to(DEV) for a in host))
    torch.cuda.synchronize()
    out = {"key": list(key),
           "tokens_equal": all(torch.equal(a, b)
                               for a, b in zip(replayed, plain)),
           "cache_equal": {n: torch.equal(after[n], cache[n])
                           for n in cache}}
    if not out["tokens_equal"]:
        out["tokens_differing"] = sum(int((a != b).sum())
                                      for a, b in zip(replayed, plain))
    for n in cache:
        if not out["cache_equal"][n]:
            out.setdefault("cache_max_abs_diff", {})[n] = (
                after[n].float() - cache[n].float()).abs().max().item()
    del saved, after
    return out


def decoding_executor(cfg, params, n_slots, max_seq, lengths, chunk,
                      **kw):
    """A fresh executor at full width whose requests (seeded prompts of
    ``lengths``) have prefilled and entered decode."""
    ex = TorchExecutor(cfg, params, n_slots=n_slots, max_seq=max_seq,
                       device=DEV, **kw)
    inst = Instance(0, D_HEAVY, chunk, CostModel(cfg, InstanceSpec(tp=1)),
                    ex, hbm_blocks=kw.get("hbm_blocks") or 4096)
    rng = np.random.default_rng(31)
    reqs = [Request(prompt_len=n, max_new_tokens=64, hidden_output_len=64,
                    prompt_tokens=[int(x) for x in rng.integers(
                        1, cfg.vocab_size, size=n)]) for n in lengths]
    for r in reqs:
        inst.enqueue_prefill(r)
    now = 0.0
    while any(r.output_len == 0 for r in reqs):
        dur, done, _ = inst.run_iteration(now)
        now += dur
        for r in done:
            inst.admit_decode(r)
    return ex, reqs


def check_paged_graph(cfg, params, K=8):
    """One paged horizon bucket at full width (4 rows, K = 8)."""
    ex, reqs = decoding_executor(cfg, params, 8, 4096, [300, 517, 1024, 77],
                                 2048, hbm_blocks=1024)
    slots = [ex.slots.slot(r.rid) for r in reqs]
    for r, sl in zip(reqs, slots):
        ex.kv.grow_for(sl, r.rid, int(ex.positions[sl]) + K, False)
    pk = pack_decode([int(ex.last_token[sl]) for sl in slots],
                     [int(ex.positions[sl]) for sl in slots],
                     [K] * len(slots), [ex.kv.tables[sl] for sl in slots],
                     ex.kv.max_blocks, ex.cache_block_size)
    key = ("paged",) + pk.tables.shape + (K,)
    out = captured_vs_uncaptured(
        ex, key, lambda *a: (ex._horizon_paged(*a, K=K),),
        (pk.tokens, pk.start, pk.budget, pk.tables))
    del ex
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_dense_graph(cfg, params, max_seq, lengths):
    """A dense family's full-slot-batch decode graph (4 slots, one of them
    idle) at full width."""
    ex, reqs = decoding_executor(cfg, params, 4, max_seq, lengths, 1024)
    active = ex._decode_mask(reqs)
    out = captured_vs_uncaptured(
        ex, ("dense", 1), lambda *a: (ex._decode_fused(*a),),
        (ex.last_token[:, None], ex.positions, active))
    out["model"] = cfg.name
    del ex
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ptxas_d256():
    """What ptxas reported (``-Xptxas -v``, the build's ``nvcc.log``) for
    every head-dim-256 instantiation of the dense kernels: registers a
    thread and spill bytes, by kernel, query and cache types, and the
    FMA body's padded group (``gm``)."""
    out, cur = [], None
    for line in (build.build_dir() / "nvcc.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '_ZN5paged\d+(\w+?_kernel)"
                      r"I(\w+?)Li256E(?:Li(\d+)E)?", line)
        if m:
            types = re.findall(r"13__nv_bfloat16|S1_|f", m.group(2))
            names = []
            for t in types:
                names.append(names[0] if t == "S1_" else
                             "bf16" if t.startswith("13") else "f32")
            cur = {"kernel": m.group(1), "types": names}
            if m.group(3):
                cur["gm"] = int(m.group(3))
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            cur = None
    return out


def phase_graphs(name, check, *args):
    """Run a captured-against-uncaptured check: any difference is printed
    before the phase fails (the two are the same launches on the same
    inputs, and expected bit-equal)."""
    out = check(*args)
    emit(name, **out)
    assert out["tokens_equal"] and all(out["cache_equal"].values()), out
    return out


# ---------------------------------------------------------------------------
# the dense kernels against their plain versions
# ---------------------------------------------------------------------------

def make_dense_kv(seed, B, hkv, d, dtype, S):
    """A layer's [B, S, Hkv, D] dense cache pair, as the model holds it."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    k = torch.randn((B, S, hkv, d), device=DEV, generator=g)
    v = torch.randn((B, S, hkv, d), device=DEV, generator=g)
    return k.to(dtype), v.to(dtype)


def check_dense_decode(shape, lengths, S=DENSE_S):
    shape_name, hq, hkv, d, dtype = shape
    B = len(lengths)
    k, v = make_dense_kv(11, B, hkv, d, dtype, S)
    g = torch.Generator(device=DEV)
    g.manual_seed(12)
    q = torch.randn((B, hq, d), device=DEV, generator=g).to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    run = lambda: dec_ops.decode_attention(q, k, v, ln)
    plain = lambda: dec_ops.decode_attention_ref(q, k, v, ln)
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    assert out.shape == ref.shape and out.dtype == dtype
    assert torch.isfinite(out.float()).all(), "dense decode: non-finite"
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], f"dense decode {shape_name} {dtype}: {err}"
    ref_max = ref.float().abs().max().item()
    del ref
    # the library call: one SDPA over the same dense cache with a key mask
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(S, device=DEV)[None, :]
            < ln[:, None])[:, None, None, :]
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None, :], kt, vt, attn_mask=mask, enable_gqa=True)
    keys = sum(min(n, S) for n in lengths)
    nbytes = (2 * keys * hkv * d * k.element_size()
              + 2 * q.numel() * q.element_size() + 4 * B)
    return {"kernel": "decode_attention", "shape": shape_name,
            "dtype": str(dtype).split(".")[1], "B": B, "S": S,
            "max_ctx": max(lengths), "max_abs_err": err, "tol": TOL[dtype],
            "plain_max_abs": ref_max,
            "ms": time_ms(run), "plain_ms": time_ms(plain),
            "library_ms": time_ms(lib),
            **bound(nbytes, 4.0 * hq * d * keys, dtype)}


def check_dense_prefill(shape, B, tq, prefix, S=DENSE_S):
    shape_name, hq, hkv, d, dtype = shape
    k, v = make_dense_kv(13, B, hkv, d, dtype, S)
    g = torch.Generator(device=DEV)
    g.manual_seed(14)
    q = torch.randn((B, tq, hq, d), device=DEV, generator=g).to(dtype)
    pre = torch.tensor(prefix, dtype=torch.int32, device=DEV)
    run = lambda: pf_ops.chunked_prefill_attention(q, k, v, pre)
    plain = lambda: pf_ops.chunked_prefill_attention_ref(q, k, v, pre)
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    assert out.shape == ref.shape and out.dtype == dtype
    assert torch.isfinite(out.float()).all(), "dense prefill: non-finite"
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], f"dense prefill {shape_name} {dtype}: {err}"
    ref_max = ref.float().abs().max().item()
    del ref
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    kpos = torch.arange(S, device=DEV)[None, :]
    qpos = prefix + torch.arange(tq, device=DEV)[:, None]
    mask = ((kpos <= qpos) & (kpos < prefix + tq))[None, None]
    qt = q.transpose(1, 2)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    # what this chunk needs: keys below its frontier once, a query-key pair
    # for every token and every key it may see
    pairs = B * (tq * prefix + tq * (tq + 1) // 2)
    nbytes = (2 * B * (prefix + tq) * hkv * d * k.element_size()
              + 2 * q.numel() * q.element_size() + 4)
    return {"kernel": "chunked_prefill_attention", "shape": shape_name,
            "dtype": str(dtype).split(".")[1], "B": B, "Tq": tq,
            "prefix": prefix, "S": S, "max_abs_err": err,
            "tol": TOL[dtype], "plain_max_abs": ref_max,
            "ms": time_ms(run), "plain_ms": time_ms(plain),
            "library_ms": time_ms(lib),
            **bound(nbytes, 4.0 * hq * d * pairs, dtype)}


def ssd_inputs(h, p, n, t, dtype, seed=15):
    """One slot's scan inputs (batch 1: the engine prefills one slot at a
    time), drawn as the model makes them: A from -1 to -16 over the heads
    (``init_mamba2``), dt through softplus, x, B and C through SiLU, a
    non-zero float32 initial state; x, dt, B and C in ``dtype``."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    silu = torch.nn.functional.silu
    x = silu(torch.randn((1, t, h, p), device=DEV, generator=g))
    dt = torch.nn.functional.softplus(
        torch.randn((1, t, h), device=DEV, generator=g))
    A = -torch.linspace(1.0, 16.0, h, device=DEV)
    B = silu(torch.randn((1, t, 1, n), device=DEV, generator=g))
    C = silu(torch.randn((1, t, 1, n), device=DEV, generator=g))
    s0 = 0.1 * torch.randn((1, h, p, n), device=DEV, generator=g)
    x, dt, B, C = (a.to(dtype) for a in (x, dt, B, C))
    return x, dt, A, B, C, s0


def ssd_bound(x, dt, A, B, C, s0):
    """The scan's least time: every input and output in its own type (y as
    x, the state in and out in float32) over the HBM rate, or the
    recurrence's 5 P N operations a token and head (decay the [P, N]
    state, add x dt B^T, read C s) at the bf16 tensor-core rate, the
    fastest unit a product can run on within the tolerance."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    nbytes = (2 * x.numel() * x.element_size()
              + dt.numel() * dt.element_size() + 4 * A.numel()
              + (B.numel() + C.numel()) * B.element_size()
              + 2 * 4 * s0.numel())
    return bound(nbytes, 5.0 * b * t * h * p * n, torch.bfloat16)


def check_ssd(shape_name, h, p, n, L, t, dtype):
    """The scan at chunk L against its float32 plain version on the same
    values, tolerance 2e-3 (for a bf16 y beyond its own rounding)."""
    x, dt, A, B, C, s0 = ssd_inputs(h, p, n, t, dtype)
    run = lambda: ssd_ops.ssd_scan(x, dt, A, B, C, L, s0)
    plain = lambda: ssd_ops.ssd_scan_ref(x, dt, A, B, C, L, s0)
    y, s = run()
    torch.cuda.synchronize()
    ry, rs = ssd_ops.ssd_scan_ref(*(a.float() for a in (x, dt, A, B, C)),
                                  L, s0)
    assert y.dtype == dtype and s.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    slack = BF16_HALF_STEP if dtype == torch.bfloat16 else 0.0
    err = max(((y.float() - ry).abs() - slack * ry.abs()).max().item(),
              (s - rs).abs().max().item())
    assert err <= SSD_TOL, f"ssd {shape_name} {dtype} L={L} t={t}: {err}"
    ref_max = max(ry.abs().max().item(), rs.abs().max().item())
    y_raw = (y.float() - ry).abs().max().item()
    del ry, rs
    return {"kernel": "ssd_scan", "shape": shape_name,
            "dtype": str(dtype).split(".")[1], "h": h, "p": p, "n": n,
            "L": L, "t": t, "max_abs_err": err, "y_max_abs_diff": y_raw,
            "tol": SSD_TOL, "plain_max_abs": ref_max,
            "ms": time_ms(run), "plain_ms": time_ms(plain),
            "library_ms": None,
            "library": "none: no single PyTorch call computes a chunked "
                       "SSD scan",
            **ssd_bound(x, dt, A, B, C, s0)}


def phase_kernels_ssd():
    cases = [check_ssd(*args) for args in SSD_SHAPES]
    emit("kernels_ssd", cases=cases)
    return cases


def served_scan_ms(served, n_layers, h, p, n):
    """Device milliseconds of the scan kernel over a served run's prefills:
    ``n_layers`` scans of each served ``[T, chunk, count]``, each timed
    (``time_ms``, cold L2) on bf16 inputs drawn as the model makes them."""
    total, per_t = 0.0, []
    for T, chunk, count in served:
        x, dt, A, B, C, s0 = ssd_inputs(h, p, n, T, torch.bfloat16)
        ms = time_ms(lambda: ssd_ops.ssd_scan(x, dt, A, B, C, chunk, s0))
        per_t.append([T, chunk, count, ms])
        total += count * n_layers * ms
    return total, per_t


def phase_kernels_dense():
    """Decode: 8 rows (the serving slots) with contexts to 2048 on a
    2048-slot cache; prefill: one slot's 1024-token chunk at offset 1024
    (the P-heavy instance's chunk on the slot path) and, for zamba2-7b in
    bf16, a 256-token chunk at offset 768 (the D-heavy one's).  The same
    at gemma3-1b's (4 / 1 / 256) and granite-moe-3b-a800m's (24 / 8 / 64)
    shapes on their 4096-slot caches, decode to 4096 keys, in bf16 and
    float32 (the 256-token chunk in bf16 only).  Then the scan
    (``phase_kernels_ssd``): one slot's 1024-token prefill at zamba2-7b's
    and mamba2-1.3b's widths in float32, and served prefills of zamba2-7b
    in bf16."""
    lengths = [2048, 1, 700, 1536, 33, 1024, 2000, 129]
    cases = []
    for shape in DENSE_SHAPES:
        cases.append(check_dense_decode(shape, lengths))
        cases.append(check_dense_prefill(shape, 1, 1024, 1024))
    # the D-heavy instance's 256-token chunk, at offset 768
    cases.append(check_dense_prefill(DENSE_SHAPES[-1], 1, 256, 768))
    long_lengths = [4096, 1, 1400, 3072, 33, 2048, 4000, 129]
    for shape in FAMILY_SHAPES:
        cases.append(check_dense_decode(shape, long_lengths, FAMILY_S))
        cases.append(check_dense_prefill(shape, 1, 1024, 1024, FAMILY_S))
        if shape[-1] == torch.bfloat16:
            cases.append(check_dense_prefill(shape, 1, 256, 768, FAMILY_S))
    emit("kernels_dense", cases=cases)
    cases += phase_kernels_ssd()
    torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------
# the dense families at full width: kernels vs plain versions
# ---------------------------------------------------------------------------

@torch.no_grad()
def check_model_dense(phase, cfg, chunks, pos1, active, max_seq):
    """The dense path at full width, random weights from a seed, over a
    dense cache of 4 slots: the slot prefills ``chunks`` ((slot, start,
    n), each slot's tokens drawn from a seed), then one decode over all
    four slots at ``pos1`` under the row mask ``active``.  Three ways, as
    ``phase_model``: bf16 through the kernels, bf16 through the plain
    versions, float32 through both; the same tolerances.  Every kernel
    runs the launches the layers call for, and none on the plain path."""
    params = tf.init_params(1, cfg, device=DEV)
    rng = np.random.default_rng(21)
    n_tok = max(st + n for _, st, n in chunks)
    tokens = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(4, n_tok)).astype(np.int64)).to(DEV)
    pos1 = torch.tensor(pos1, device=DEV)[:, None]
    active = torch.tensor(active, dtype=torch.int32, device=DEV)
    types = tf.layer_types(cfg)
    n_kv = sum(b in tf.KV_BLOCKS for b in types)
    n_state = sum(b in tf.STATE_BLOCKS for b in types)
    want = {"decode_attention": n_kv,
            "chunked_prefill_attention": len(chunks) * n_kv,
            "ssd_scan": len(chunks) * n_state}

    def run(prm, dtype, plain):
        cache = tf.init_cache(cfg, 4, max_seq, dtype=dtype, device=DEV)
        n0 = launch_counts(DENSE_KERNELS)
        outs = []
        with plain_kernels() if plain else contextlib.nullcontext():
            for slot, st, n in chunks:
                row = {name: leaf[:, slot:slot + 1]
                       for name, leaf in cache.items()}
                pos = torch.arange(st, st + n, device=DEV)[None]
                lg, _, _ = tf.forward(prm, cfg, tokens[slot:slot + 1,
                                                       st:st + n],
                                      pos, row)
                outs.append(lg[0].float())
            dec, _, _ = tf.forward(prm, cfg, tokens[:, :1], pos1, cache,
                                   valid_len=active)
            outs.append(dec[active.bool(), 0].float())
        torch.cuda.synchronize()
        n1 = launch_counts(DENSE_KERNELS)
        got = {k: n1[k] - n0[k] for k in n0}
        assert got == ({k: 0 for k in want} if plain else want), got
        for o in outs:
            assert torch.isfinite(o).all()
        return outs

    def scaled_err(a, b):
        worst = 0.0
        for x, y in zip(a, b):
            scale = max(y.abs().max().item(), 1.0)
            worst = max(worst, (x - y).abs().max().item() / scale)
        return worst

    bf_kernel = run(params, torch.bfloat16, plain=False)
    bf_plain = run(params, torch.bfloat16, plain=True)
    params32 = _float_tree(params)
    f32_kernel = run(params32, torch.float32, plain=False)
    f32_plain = run(params32, torch.float32, plain=True)
    del params32, params
    err_f32 = scaled_err(f32_kernel, f32_plain)
    err_kernel = scaled_err(bf_kernel, f32_plain)
    err_plain = scaled_err(bf_plain, f32_plain)
    agree = torch.cat([(a.argmax(-1) == b.argmax(-1)).float()
                       for a, b in zip(bf_kernel, f32_plain)])
    emit(phase, model=cfg.name, layers=cfg.num_layers,
         layers_registered=get_config(cfg.name).num_layers,
         attention_layers=n_kv, launches=want,
         f32_kernel_vs_plain=err_f32, f32_tol=MODEL_TOL_F32,
         bf16_kernel_vs_f32=err_kernel, bf16_plain_vs_f32=err_plain,
         bf16_kernel_vs_bf16_plain=scaled_err(bf_kernel, bf_plain),
         bf16_greedy_agreement_with_f32=agree.mean().item())
    assert err_f32 <= MODEL_TOL_F32, err_f32
    assert err_kernel <= 1.5 * err_plain + MODEL_TOL_BF16_SLACK, \
        (err_kernel, err_plain)
    gc.collect()
    torch.cuda.empty_cache()


def phase_model_zamba2():
    """zamba2-7b, cut to its first 12 layers (two of its shared-attention
    layers): slot 0 prefills a 1024-token chunk, slot 1 a 215-token chunk
    and then a 300-token one (scan chunks of 256, 215 and 4), then one
    decode over all four slots with slot 3 masked out."""
    check_model_dense(
        "model_zamba2", dataclasses.replace(get_config(ZAMBA), num_layers=12),
        [(0, 0, 1024), (1, 0, 215), (1, 215, 300)],
        [1024, 515, 0, 0], [1, 1, 1, 0], DENSE_S)


def phase_model_gemma3():
    """gemma3-1b, cut to its first 12 layers (two periods: 10 ring layers
    of 1024 slots, 2 global ones at head dim 256): slot 0 prefills a
    1024-token chunk, slot 1 a 700-token chunk and then a 600-token one,
    which wraps its rings and runs kernel 4 at prefix 700; then one decode
    over all four slots with slot 3 masked out."""
    check_model_dense(
        "model_gemma3", dataclasses.replace(get_config(GEMMA), num_layers=12),
        [(0, 0, 1024), (1, 0, 700), (1, 700, 600)],
        [1024, 1300, 0, 0], [1, 1, 1, 0], FAMILY_S)


def phase_model_moe():
    """granite-moe-3b-a800m, cut to its first 8 layers (40 experts top-8
    each): the chunks of ``phase_model_zamba2``, then the masked decode,
    whose four rows share the experts' capacity."""
    check_model_dense(
        "model_moe", dataclasses.replace(get_config(MOE), num_layers=8),
        [(0, 0, 1024), (1, 0, 215), (1, 215, 300)],
        [1024, 515, 0, 0], [1, 1, 1, 0], FAMILY_S)


# ---------------------------------------------------------------------------
# the dense main path: zamba2-7b served by a TaiChi cluster
# ---------------------------------------------------------------------------

def served_chunks(log, reqs):
    """rid -> the chunk lengths each request's prompt was prefilled in, as
    the cluster ran them (one prefill a request: a dense row holds its
    request to the end, so none is preempted and prefilled again)."""
    out = {r.rid: [] for r in reqs}
    for e in log:
        for (take, pos), rid in zip(e["prefill"], e["prefill_rids"]):
            assert pos == sum(out[rid]), (rid, pos, out[rid])
            out[rid].append(take)
    for r in reqs:
        assert sum(out[r.rid]) == r.prompt_len, (r.rid, out[r.rid])
    return out


@torch.no_grad()
def replay_prefill(cfg, params, prompt, chunks, max_seq, dtype=None):
    """The prompt prefilled again in the served chunks, as the executor's
    slot prefill runs them, on a fresh one-slot dense cache (of ``dtype``,
    default the model's).  Returns the last position's logits
    (float32)."""
    cache = tf.init_cache(cfg, 1, max_seq, dtype=dtype, device=DEV)
    row = {name: leaf[:, 0:1] for name, leaf in cache.items()}
    at = 0
    for take in chunks:
        toks = torch.tensor([prompt[at:at + take]], dtype=torch.int32,
                            device=DEV)
        pos = torch.tensor([at], dtype=torch.int32, device=DEV)[:, None] \
            + torch.arange(take, dtype=torch.int32, device=DEV)[None]
        hidden, _, _ = tf.forward(params, cfg, toks, pos, row,
                                  compute_logits=False)
        at += take
    return (hidden[:, -1] @ params["lm_head"])[0].float()


@torch.no_grad()
def cache_free_logits(cfg, params, prompt):
    hidden, _, _ = tf.forward(params, cfg,
                              torch.tensor([prompt], device=DEV),
                              compute_logits=False)
    return (hidden[0, -1] @ params["lm_head"]).float()


def serve_dense(cfg, params, wl, qps, max_seq, kernels, cache_free=True,
                f32_oracle=False, n_requests=16, n_slots=8):
    """The dense main path at full width: ``build_cluster`` under
    ``TaiChiPolicy`` with one P-heavy (chunk 1024) and one D-heavy (chunk
    256) instance, each a dense ``TorchExecutor`` of ``n_slots`` rows of
    ``max_seq``, sharing one params dict, serving ``n_requests`` of ``wl``
    arriving at ``qps``.  The launch counts of ``kernels`` are set to 0
    just before the run and read just after.

    Afterwards, each request's first token is held against a replay of
    its prompt in the chunks it was served in, on a fresh cache, through
    the kernels: equal, so scheduling beside decodes, row masks and
    migration changed no state the first token reads.  The same replay
    through the plain versions and (``cache_free``) a cache-free forward
    both ways are reported beside it: bf16 chunked and cache-free forwards
    round differently, and the plain versions show how much of that is
    the kernels'.  With ``f32_oracle`` the chunked replay is also run in
    float32 through the kernels, against the cache-free forward in
    float32: the greedy tokens must agree for every request (the
    cache-free mask is an oracle of what the chunks' caches hold).
    Returns (fields of the phase's line, launches, the served chunks, the
    requests)."""
    log = []
    sc = ServingConfig(model=cfg.name, tp=1, policy="taichi",
                       sliders=Sliders(n_p=1, n_d=1, s_p=1024, s_d=256),
                       hbm_blocks=n_slots * max_seq // BLOCK,
                       block_size=BLOCK)
    factory = lambda: TimedExecutor(cfg, params, n_slots=n_slots,
                                    max_seq=max_seq, device=DEV, log=log)
    slo = SLO(ttft=10.0, tpot=0.5)
    cluster = build_cluster(sc, slo, seed=0, executor_factory=factory)
    cluster._on_exec_error = raise_exec_error
    reqs = wl.sample_requests(n_requests, qps=qps, seed=0)
    executors = [inst.executor for inst in cluster.policy.instances]
    assert all(not ex.paged for ex in executors)
    cache_bytes = sum(ex.cache_bytes() for ex in executors)

    # counts to 0 just before the main path, read just after
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cluster.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(kernels)
    peak = torch.cuda.max_memory_allocated()

    check_finished(cfg, reqs, cluster)
    iterations = sum(inst.iterations for inst in cluster.policy.instances)
    readbacks = sum(ex.host_readbacks for ex in executors)
    assert 0 < readbacks <= iterations, (readbacks, iterations)
    out_tokens = sum(len(r.output_tokens) for r in reqs)
    in_tokens = sum(r.prompt_len for r in reqs)
    derates = derive_derates(log, cluster.cost)
    chunks = served_chunks(log, reqs)
    first = {r.rid: r.output_tokens[0] for r in reqs}
    agree = {k: 0 for k in ("cache_free", "replay", "plain_replay",
                            "plain_replay_vs_plain_cache_free")}
    replay_err = 0.0
    for r in reqs:
        kernel = replay_prefill(cfg, params, r.prompt_tokens, chunks[r.rid],
                                max_seq)
        with plain_kernels():
            plain = replay_prefill(cfg, params, r.prompt_tokens,
                                   chunks[r.rid], max_seq)
        agree["replay"] += int(int(kernel.argmax()) == first[r.rid])
        agree["plain_replay"] += int(int(plain.argmax()) == first[r.rid])
        replay_err = max(replay_err, (kernel - plain).abs().max().item()
                         / max(plain.abs().max().item(), 1.0))
        if cache_free:
            kernel_cf = int(cache_free_logits(cfg, params,
                                              r.prompt_tokens).argmax())
            agree["cache_free"] += int(kernel_cf == first[r.rid])
            with plain_kernels():
                plain_cf = int(cache_free_logits(cfg, params,
                                                 r.prompt_tokens).argmax())
            agree["plain_replay_vs_plain_cache_free"] += int(
                int(plain.argmax()) == plain_cf)
    f32 = None
    if f32_oracle:
        params32 = _float_tree(params)
        f32 = {"greedy_equal": 0, "max_scaled_err": 0.0}
        for r in reqs:
            rep32 = replay_prefill(cfg, params32, r.prompt_tokens,
                                   chunks[r.rid], max_seq, torch.float32)
            cf32 = cache_free_logits(cfg, params32, r.prompt_tokens)
            f32["greedy_equal"] += int(int(rep32.argmax())
                                       == int(cf32.argmax()))
            f32["max_scaled_err"] = max(
                f32["max_scaled_err"], (rep32 - cf32).abs().max().item()
                / max(cf32.abs().max().item(), 1.0))
        del params32
        assert f32["greedy_equal"] == len(reqs), f32
    n = len(reqs)
    fields = dict(
        model=cfg.name, policy="taichi", requests=n,
        slots_per_instance=n_slots, max_seq=max_seq,
        prompt_tokens=in_tokens, output_tokens=out_tokens,
        prompt_lengths=sorted(r.prompt_len for r in reqs),
        wall_s=wall, output_tokens_per_s=out_tokens / wall,
        total_tokens_per_s=(in_tokens + out_tokens) / wall,
        iterations=iterations,
        iterations_by_kind={k: derates[k] for k in (
            "prefill_only_iterations", "decode_only_iterations",
            "mixed_iterations")},
        host_readbacks=readbacks,
        host_syncs=sum(ex.host_syncs for ex in executors),
        transfers=cluster.transfer_count, launches=launches,
        exec_errors=cluster.exec_errors, cache_bytes=cache_bytes,
        peak_memory_bytes=peak, graphs=graph_stats(executors, log),
        first_token_equals_replay=f"{agree['replay']}/{n}",
        first_token_agrees_with_plain_replay=(
            f"{agree['plain_replay']}/{n}"),
        first_token_agrees_with_cache_free=(
            f"{agree['cache_free']}/{n}" if cache_free else None),
        plain_replay_agrees_with_plain_cache_free=(
            f"{agree['plain_replay_vs_plain_cache_free']}/{n}"
            if cache_free else None),
        f32_replay_vs_f32_cache_free=f32,
        replay_kernel_vs_plain_logits=replay_err, measured=derates)
    return fields, launches, chunks, reqs


def phase_serve_zamba2(cfg, params):
    """zamba2-7b: two 8-slot instances at ``max_seq`` 2048, 16 requests
    with prompts of 128-1536 tokens (the D-heavy instance prefills them in
    several 256-token chunks beside its decodes) and 16-48 output tokens,
    arriving at 4 a second.  Besides ``serve_dense``'s checks: every slot
    prefill of more than one token scans once a layer, and the scan
    kernel's time summed over the served prefills (``scan_ms_served``)."""
    wl = WorkloadSpec("zamba2-smoke",
                      LengthDist(mu=6.5, sigma=0.7, lo=128, hi=1536),
                      LengthDist(mu=3.4, sigma=0.4, lo=16, hi=48),
                      tokenized=True, vocab_size=cfg.vocab_size)
    fields, launches, chunks, reqs = serve_dense(cfg, params, wl, 4.0,
                                                 DENSE_S, DENSE_KERNELS)
    assert all(n > 0 for n in launches.values()), launches
    # the scan and the chunked-prefill kernel run together, on every slot
    # prefill of more than one token: 81 scans to 13 attention reads
    n_attn = cfg.attn_layer_count()
    assert launches["ssd_scan"] * n_attn \
        == launches["chunked_prefill_attention"] * cfg.num_layers, launches
    # every slot prefill of more than one token scans once a layer, at the
    # chunk the model's rule picks for its length
    served = collections.Counter(
        (take, m2.scan_chunk(cfg, take)) for takes in chunks.values()
        for take in takes if take > 1)
    served = sorted([T, c, k] for (T, c), k in served.items())
    assert sum(k for _, _, k in served) * cfg.num_layers \
        == launches["ssd_scan"], (served, launches)
    scan_ms, scan_per_t = served_scan_ms(
        served, cfg.num_layers, cfg.ssm_nheads, cfg.ssm_headdim,
        cfg.ssm_state)
    emit("serve_zamba2", **fields, served_prefills=served,
         scan_ms_served=scan_ms, scan_ms_by_prefill=scan_per_t)
    # the served path against its own replay: the same kernels on the
    # same chunks, so only a fault around them could tell the two apart
    assert fields["first_token_equals_replay"] == f"{len(reqs)}/{len(reqs)}", \
        fields["first_token_equals_replay"]
    return launches


def phase_serve_family(name, cfg, params, wl, cache_free):
    """gemma3-1b or granite-moe-3b-a800m: two 8-slot instances at
    ``max_seq`` 4096, 16 requests arriving at 8 a second; only the two
    dense attention kernels run (no scan), each of them at least once, and
    every first token equals its replay's.  Where the cache-free forward
    is an oracle (``cache_free``), it is reported beside the bf16 first
    tokens and held against the float32 replays."""
    fields, launches, chunks, reqs = serve_dense(
        cfg, params, wl, 8.0, FAMILY_S, DENSE_KERNELS, cache_free=cache_free,
        f32_oracle=cache_free)
    longest = max(sum(c) for c in chunks.values())
    emit(name, **fields, served_chunks=sorted(
        collections.Counter(t for c in chunks.values() for t in c).items()),
        longest_prompt=longest)
    assert launches["decode_attention"] > 0 \
        and launches["chunked_prefill_attention"] > 0 \
        and launches["ssd_scan"] == 0, launches
    assert fields["first_token_equals_replay"] == f"{len(reqs)}/{len(reqs)}", \
        fields["first_token_equals_replay"]
    return launches


def phase_serve_gemma3(cfg, params):
    """Prompts of 128-3072 tokens (four of the sixteen past 2048, so the
    1024-slot rings wrap and kernel 4 runs at prefixes past 1024), 16-64
    output tokens.  The cache-free forward, whose full causal windowed
    mask is an oracle of the rings, is held against the float32 replay of
    every prompt's served chunks, and reported beside each bf16 first
    token."""
    wl = WorkloadSpec("gemma3-smoke",
                      LengthDist(mu=7.3, sigma=0.8, lo=128, hi=3072),
                      LengthDist(mu=3.4, sigma=0.5, lo=16, hi=64),
                      tokenized=True, vocab_size=cfg.vocab_size)
    return phase_serve_family("serve_gemma3", cfg, params, wl, True)


def phase_serve_moe(cfg, params):
    """Prompts of 128-2048 tokens, 16-64 output tokens.  The cache-free
    forward is no oracle here: an MoE layer's capacity follows T, so a
    prompt routed whole drops other slots than its chunks do."""
    wl = WorkloadSpec("moe-smoke",
                      LengthDist(mu=6.7, sigma=0.7, lo=128, hi=2048),
                      LengthDist(mu=3.4, sigma=0.5, lo=16, hi=64),
                      tokenized=True, vocab_size=cfg.vocab_size)
    return phase_serve_family("serve_moe", cfg, params, wl, False)


# ---------------------------------------------------------------------------

#: kernel -> (source, the TPU kernel's pl.pallas_call it replaces, the
#: case of the kernels phases at the main path's shape)
KERNEL_META = {
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/paged_decode.cu",
        "src/repro/kernels/decode_attention/paged_decode.py:122",
        dict(shape=MODEL, pool="bfloat16", B=16)),
    "paged_chunked_prefill_attention": (
        "src/repro_torch/kernels/csrc/paged_prefill.cu",
        "src/repro/kernels/chunked_prefill_attention/paged_prefill.py:135",
        dict(shape=MODEL, pool="bfloat16", Tq=1024)),
    "decode_attention": (
        "src/repro_torch/kernels/csrc/decode.cu",
        "src/repro/kernels/decode_attention/decode_attn.py:74",
        dict(shape=ZAMBA, dtype="bfloat16")),
    "chunked_prefill_attention": (
        "src/repro_torch/kernels/csrc/chunked_prefill.cu",
        "src/repro/kernels/chunked_prefill_attention/chunked_attn.py:89",
        dict(shape=ZAMBA, dtype="bfloat16", Tq=1024)),
    "ssd_scan": (
        "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/ssd_kernel.py:85",
        dict(shape=ZAMBA, L=256, dtype="float32")),
}


def kernels_line(cases, by_path):
    """One entry a kernel, at the shape of the main path that runs it;
    ``launches`` sums the paths that run it (``by_path``: path -> kernel
    -> launches, each counted from 0 over that path's run)."""
    out = []
    for name, (source, replaces, where) in KERNEL_META.items():
        c = next(c for c in cases if c["kernel"] == name
                 and all(c.get(k) == v for k, v in where.items()))
        paths = {p: n[name] for p, n in by_path.items() if name in n}
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    return out


def scan_only(argv):
    """``--scan-only [SERVED]``: build, time the scan cases and, given the
    ``serve_zamba2`` JSON line of an earlier run in the file SERVED, the
    scan over that run's served prefills.  It uses only the scan wrapper's
    public call, so a copy of this script placed in an older checkout
    times that checkout's kernel the same way."""
    build.load_library()
    phase_kernels_ssd()
    if argv:
        with open(argv[0]) as f:
            served = json.loads(f.read())["served_prefills"]
        zcfg = get_config(ZAMBA)
        ms, per_t = served_scan_ms(served, zcfg.num_layers, zcfg.ssm_nheads,
                                   zcfg.ssm_headdim, zcfg.ssm_state)
        emit("scan_served", served_prefills=served, scan_ms_served=ms,
             scan_ms_by_prefill=per_t)
    return 0


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi, allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    if argv[:1] == ["--scan-only"]:
        return scan_only(argv[1:])

    t0 = time.perf_counter()
    build.load_library()
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=build.last_build_seconds,
         sources=[p.name for p in build.sources()], d256=ptxas_d256())

    cases = phase_kernels()

    cfg = get_config(MODEL)
    t0 = time.perf_counter()
    params = tf.init_params(0, cfg, device=DEV)
    torch.cuda.synchronize()
    emit("params", model=cfg.name, parameters=count_params(params),
         seconds=time.perf_counter() - t0)
    phase_model(cfg, params)
    phase_serve(cfg, params)
    gc.collect()
    torch.cuda.empty_cache()
    launches, executors = phase_live(cfg, params)
    # the same executors again: every horizon bucket of the run is
    # captured, so this run shows the steady state
    phase_live(cfg, params, "live_warm", executors)
    by_path = {"live": launches,
               "frontend": phase_frontend(cfg, executors)}
    del executors
    gc.collect()
    torch.cuda.empty_cache()
    by_path["tiers"] = phase_tiers(cfg, params)
    phase_graphs("graphs_paged", check_paged_graph, cfg, params)
    # qwen2.5-3b's weights and pools go before zamba2-7b loads
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cases += phase_kernels_dense()
    phase_model_zamba2()
    zcfg = get_config(ZAMBA)
    t0 = time.perf_counter()
    zparams = tf.init_params(0, zcfg, device=DEV)
    torch.cuda.synchronize()
    emit("params_zamba2", model=zcfg.name, layers=zcfg.num_layers,
         parameters=count_params(zparams),
         device_bytes=torch.cuda.memory_allocated(),
         seconds=time.perf_counter() - t0)
    by_path["serve_zamba2"] = phase_serve_zamba2(zcfg, zparams)
    gc.collect()
    torch.cuda.empty_cache()
    phase_graphs("graphs_dense", check_dense_graph, zcfg, zparams, DENSE_S,
                 [300, 700, 129])
    # zamba2-7b's weights go before the next families load
    del zparams
    gc.collect()
    torch.cuda.empty_cache()

    for name, phase, model_phase, serve_phase, lengths in (
            (GEMMA, "gemma3", phase_model_gemma3, phase_serve_gemma3,
             [1500, 700, 129]),
            (MOE, "moe", phase_model_moe, phase_serve_moe,
             [300, 1500, 129])):
        model_phase()
        fcfg = get_config(name)
        t0 = time.perf_counter()
        fparams = tf.init_params(0, fcfg, device=DEV)
        torch.cuda.synchronize()
        emit(f"params_{phase}", model=fcfg.name, layers=fcfg.num_layers,
             parameters=count_params(fparams),
             device_bytes=torch.cuda.memory_allocated(),
             seconds=time.perf_counter() - t0)
        by_path[f"serve_{phase}"] = serve_phase(fcfg, fparams)
        gc.collect()
        torch.cuda.empty_cache()
        phase_graphs("graphs_dense", check_dense_graph, fcfg, fparams,
                     FAMILY_S, lengths)
        del fparams
        gc.collect()
        torch.cuda.empty_cache()

    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels_line(cases, by_path)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
