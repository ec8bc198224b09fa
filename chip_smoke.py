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
                 versions on the card, at smollm-135m's, qwen2.5-3b's and
                 llava-next-34b's (56 / 8 / 128, a group of 7) shapes, fp
                 and int8 pools, the decode at the serve
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
                 zamba2-7b's, gemma3-1b's (head dim 256),
                 granite-moe-3b-a800m's, whisper-base's (8 / 8 / 64 on
                 its 448-token text context) and llava-next-34b's (56 / 8
                 / 128, a group of 7; bf16) attention shapes (all but
                 smollm-135m's and llava's in bf16 and float32; the bf16
                 prefill also at the D-heavy instance's 256-token chunk);
                 then both kernels' log-sum-exp forms at zamba2-7b's,
                 qwen2.5-3b's and gemma3-1b's shapes: the output bit-equal
                 to the serving form's, lse against the plain version's,
                 two slot halves (kernel 4's second at a negative offset)
                 combined against the whole call and the plain version;
                 both forms timed
  kernels_ssd    the SSD-scan kernel against its plain version: one slot's
                 1024-token prefill at zamba2-7b's and mamba2-1.3b's widths
                 in float32, and zamba2-7b's served prefills in bf16 (887
                 tokens at chunk 1, 251 at 251, 1024 at 256 and at 1), each
                 also with the tile states written (the same bits); its
                 backward kernel (5b) through ``SSDScanFn`` against float64
                 autograd of the plain version at both widths, float32 and
                 bf16, t 1024 and 1075, with and without an initial state,
                 and at ``train_ssm``'s batches (8 x 512, bf16)
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
  params_mamba2, serve_mamba2
                 mamba2-1.3b at full width and depth (48 MAMBA2 layers, no
                 attention) on the dense path: 16 requests, prompts to 2048
                 tokens, two 8-slot instances at max_seq 4096; the scan
                 only, first tokens held against their replays and float32
                 replays against the float32 cache-free forward,
                 ``scan_ms_served``
  model_whisper  whisper-base at full width and depth (6 ENC + 6 DEC
                 layers), bf16, batch 4: 1500 audio frames from a seed
                 through the encoder, a 64-token prompt through kernel 4,
                 32 greedy decode steps through kernel 3; the same through
                 the plain versions and in float32 (first tokens equal,
                 float32 within 1e-4, the bf16 rule of ``phase_model``);
                 ``full_prefill`` at chunk 16 against one-shot prefill
  model_llava    llava-next-34b at full width cut to 12 layers, bf16,
                 batch 2: ``full_prefill`` of 2880 image embeddings and
                 1024 text tokens at chunk 512 (kernel 4 at a group of 7
                 over 3392 tokens, then at prefix 3392), 16 decode steps
                 (kernel 3); held as ``model_whisper``
  serve_whisper  whisper-base at full width and depth, bf16, served
                 text-only through the executor (dense path, a cross
                 cache of 0 keys): two 8-slot instances at max_seq 448, 16
                 requests, kernels 3 and 4 only; first tokens held against
                 their replays, every decode-only iteration on a graph
  examples       ``repro_torch.examples``' quickstart, latency-shifting
                 demo and trainer on the card: attainment, degradations,
                 the loss falling and the checkpoint restored bit for bit
  train          qwen2.5-3b at full width and depth, bf16, remat: 10
                 AdamW steps at batch 8 by 512 on synthetic LM batches;
                 every loss and gradient norm finite, the last loss below
                 the first, no kernel launched; ms a step, tokens/s, peak
                 memory, the optimizer's share, model FLOPs a step over
                 the bf16 peak
  train_ssm      mamba2-1.3b at full width and depth, bf16, remat: 10
                 steps at 8 x 512 through kernels 5 and 5b; zamba2-7b at
                 full width cut to one period (6 layers), 3 steps; losses
                 finite and falling, each layer's scan (a ZAMBA_ATTN layer
                 has a mixer too) launched twice forward (with the
                 recompute) and once backward a step; ms
                 a step, tokens/s, peak memory, kernel 5b's share of a step
  train_grad     ``train_loss``'s gradients on the card against the CPU
                 (the one CPU computation of this script, labelled so),
                 float32, qwen2.5-3b at full width cut to 2 layers and
                 whisper-base in full, mamba2-1.3b cut to 2 layers and
                 zamba2-7b's 6-layer period at 2 x 256 (kernels 5 and 5b
                 on the card): every leaf within 1e-3 of its largest
                 value; a whisper-base step at full size with audio; a
                 checkpoint round trip (one more step from the saved and
                 the loaded state: losses bit-equal)
  tp_local       the sharded path on the card: an NCCL group of world 1,
                 the (1, 1) local mesh, qwen2.5-3b's full-width parameters
                 and a 2-row dense cache as DTensors (``param_specs``,
                 ``cache_specs``), a 512-token prefill and 16 greedy
                 decode steps under hints against the same on plain
                 tensors: tokens equal, logits bit-equal (else
                 ``model``'s bf16 rule); kernels 3 and 4 launched on local
                 shards; the sharded and the plain decode step's ms; the
                 same again with the cache split along its slot axis
                 (``kv_mode="seq"``, path ``tp_local_seq``): the read of
                 the rank's slots and the all-reduce combine
  dryrun         ``python -m repro_torch.launch.dryrun`` in a process of
                 its own, on the host (a fake process group of 256 / 512
                 ranks, fake tensors): qwen3-14b prefill_32k, qwen2.5-3b
                 decode_32k, mamba2-1.3b long_500k, arctic-480b train_4k
                 (FSDP) on 16x16 and qwen3-14b train_4k on 2x16x16; a
                 line a case with its peak bytes a rank, the three
                 roofline terms at the H100's published constants, the
                 collectives and the trace's seconds
  serve_llava    last, alone on the card: llava-next-34b served text-only
                 on the paged path at full width and (where it fits) its
                 60 layers, two 16-slot instances at max_seq 4096 whose
                 pools take what the weights leave, 16 requests; held as
                 ``serve``, plus every first token against a replay of its
                 served chunks on a fresh one-slot paged executor; the
                 replayed decode step's device ms beside its weight read

``python3 chip_smoke.py --scan-only [SERVED]`` runs only the build and
``kernels_ssd`` (forward and backward cases) and, given a file holding
an earlier run's ``serve_zamba2`` line, the scan time over its served
prefills; ``--train-ssm`` only the build and ``train_ssm``;
``--tp-local`` only the build, ``tp_local`` and ``dryrun``.
``--ptxas [LOG]`` prints ptxas's registers and spill bytes
of the scan's and the attention kernels, from this checkout's build or
from LOG, the ``nvcc.log`` of another checkout's (``kernels/build.py``
writes one beside its library); ``--ptxas-compare LOG`` builds this
checkout and lists the attention kernels' serving instantiations whose
registers or spill bytes differ from LOG's.

Then one line ``{"kernels": [...]}`` with, for every kernel of the port,
its launches on the paths that run it (``live``, ``frontend``, ``tiers``
and ``serve_llava`` for the paged kernels, ``serve_zamba2``,
``serve_gemma3``, ``serve_moe``, ``serve_mamba2``, ``model_whisper``,
``model_llava``, ``serve_whisper``, ``tp_local`` and ``tp_local_seq``
for the dense ones, and ``train_ssm`` for the scan and its backward;
``launches_by_path`` splits them), its error against the plain
version and its time beside the plain version's, the card's bound and one
library call; the card's name and power limit as ``nvidia-smi`` prints
them; and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
import json
import os
from pathlib import Path
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
from repro_torch.training.checkpoint import (load_checkpoint,  # noqa: E402
                                             save_checkpoint)
from repro_torch.training.optimizer import (AdamWConfig,  # noqa: E402
                                            adamw_update, init_opt_state,
                                            tree_leaves, tree_map)
from repro_torch.training.train import (loss_and_grads,  # noqa: E402
                                        make_train_step,
                                        synthetic_lm_batches)

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
#: a gradient leaf on the card against the CPU, float32 without TF32:
#: max |g_gpu - g_cpu| <= TRAIN_GRAD_RTOL max |g_cpu| + 1e-6
TRAIN_GRAD_RTOL = 1e-3

SHAPES = {   # name -> (Hq, Hkv, D, q dtype)
    "smollm-135m": (9, 3, 64, torch.float32),
    "qwen2.5-3b": (16, 2, 128, torch.bfloat16),
    # a group of 7: the decode body pads it to 8, the prefill tile holds
    # 9 tokens x 7 heads = 63 of its 64 rows
    "llava-next-34b": (56, 8, 128, torch.bfloat16),
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
WHISPER = "whisper-base"
LLAVA = "llava-next-34b"
#: Whisper's text context (the decoder's max_seq) and its 30 s of audio at
#: 50 frames a second, after the stubbed convolutional front end
WHISPER_S = 448
WHISPER_FRAMES = 1500
#: llava-next-34b at full width, cut to this many of its 60 layers so that
#: the float32 copy and the plain path's 3392 x 4096 scores fit one card
LLAVA_LAYERS = 12
LLAVA_S = 4096
#: serve_llava: slots and max_seq an instance, the most blocks a pool
#: holds, and the device bytes kept free beside the weights and pools for
#: activations and graphs.  The P-heavy instance's largest mixed step packs
#: 16 rows padded to its 1024-token chunk: 16,384 tokens, whose MLP holds
#: the gate and up products in bf16 and the gate and its SiLU in float32
#: (12 bytes x 20,480 a token, 4.0 GB) beside the hidden states (0.24 GB
#: each)
LLAVA_SERVE_SLOTS = 16
LLAVA_SERVE_S = 4096
LLAVA_MAX_POOL = 2048
LLAVA_RESERVE_BYTES = 6 * 10**9
#: a pool smaller than this many blocks (two of the longest requests,
#: 2048 + 64 tokens and the executor's 64-token headroom) would cut the
#: depth instead
LLAVA_MIN_POOL = 2 * 136
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
MAMBA = "mamba2-1.3b"
#: kernel 5b against float64 autograd of the plain scan, per input:
#: max |g - g_ref| <= tol max |g_ref| (float32: sums in another order and
#: the forward's tensor-core pieces; bf16: the gradients rounded to bf16,
#: 2^-9 of a value, and the forward's bf16 pairs)
SSD_GRAD_TOL = {torch.float32: SSD_TOL, torch.bfloat16: 2e-2}
#: kernel 5b against its plain reverse walk on the same inputs and tile
#: states, the products' operands rounded as the kernel's tensor cores take
#: them (``BWD_P_ROUND``), per input, relative to the largest value:
#: float32 sums in another order (bf16: dx rounded to bf16 once, 2^-9 of a
#: value, beyond)
SSD_BWD_PLAIN_RTOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}
#: (model, heads, state N, batch, tokens t, chunk L, type, initial state,
#: final state's cotangent): zamba2-7b's and mamba2-1.3b's widths at one
#: slice and two (t 1075), with and without an initial state; then the
#: training batches of ``train_ssm`` (8 x 512, bf16, no initial state, the
#: final state unused)
SSD_BWD_SHAPES = [
    (name, h, n, 1, t, L, dtype, s0, True)
    for name, h, n in ((ZAMBA, 112, 64), (MAMBA, 64, 128))
    for dtype in (torch.float32, torch.bfloat16)
    for t, L in ((1024, 256), (1075, 215)) for s0 in (True, False)] + [
    (MAMBA, 64, 128, 8, 512, 256, torch.bfloat16, False, False),
    (ZAMBA, 112, 64, 8, 512, 256, torch.bfloat16, False, False)]

# every kernel wrapper of the port (the launch counters live on these
# function objects, whatever a comparison swaps into the model's modules)
KERNELS = {
    "paged_decode_attention": dec_ops.paged_decode_attention,
    "paged_chunked_prefill_attention":
        pf_ops.paged_chunked_prefill_attention,
    "decode_attention": dec_ops.decode_attention,
    "chunked_prefill_attention": pf_ops.chunked_prefill_attention,
    "ssd_scan": ssd_ops.ssd_scan,
    "ssd_scan_bwd": ssd_ops.ssd_scan_bwd,
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
    return tree_map(lambda t: t.float(), tree)


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
    readback took on the host clock, the device milliseconds between two
    CUDA events around the dispatch, and the packed (B, T, NB) of a paged
    mixed or prefill step."""

    def __init__(self, *a, log, **kw):
        super().__init__(*a, **kw)
        self.log = log
        self._packed = None

    def _mixed_fused(self, tokens, start, valid, tables):
        self._packed = (*tokens.shape, tables.shape[1])
        return super()._mixed_fused(tokens, start, valid, tables)

    def step_async(self, plan):
        rows = [(take, req.prefill_pos + req.recompute_offset)
                for req, take in plan.prefill_items]
        rids = [req.rid for req, _ in plan.prefill_items]
        ctxs = [int(self.positions[self.slots.slot(r.rid)])
                for r in plan.decode_reqs]
        steps = 1 if rows else getattr(plan, "horizon", 1)
        captures, replays = self.graphs.captures, self.graphs.replays
        self._packed = None
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
        packed = self._packed

        def resolve():
            first = not step.resolved
            eos = inner()
            if first:
                self.log.append({"prefill": rows, "prefill_rids": rids,
                                 "decode": ctxs, "steps": steps,
                                 "replayed": replayed, "captured": captured,
                                 "packed": packed,
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
    FLOPs and bytes are the estimator's own (``CostModel``).

    ``by_kind`` sets, for each kind of iteration, the mean the estimator
    predicts under the derates in use (``iteration_time`` of each
    iteration's prefill chunks and decode contexts, times its steps)
    beside the measured mean."""
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
           "mixed_iterations": len(mixed),
           "by_kind": {kind: {
               "measured_mean_s": mean([e["total_s"] for e in es]),
               "predicted_mean_s": mean([e["steps"] * cost.iteration_time(
                   e["prefill"], e["decode"]) for e in es]),
               "n": len(es)}
               for kind, es in (("decode_only", dec), ("prefill_only", pre),
                                ("mixed", mixed)) if es}}
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
    return sum(t.numel() for t in tree_leaves(params))


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
    return derates


#: the derates ``derive_derates`` sets, as ``core/hw.py`` names them
DERATES = ("iteration_overhead_s", "decode_membw_eff", "prefill_mfu")


def serve_only(argv):
    """``--serve [N]``: ``model`` (which warms the card's libraries up
    before ``serve``, as the whole script does), ``serve`` N times (3 by
    default), then the median of each derate over the runs (what
    ``core/hw.py`` takes), then ``live``, ``live_warm`` and ``frontend``
    under the derates in use."""
    n = int(argv[0]) if argv else 3
    build.load_library()
    cfg = get_config(MODEL)
    params = tf.init_params(0, cfg, device=DEV)
    phase_model(cfg, params)
    runs = []
    for _ in range(n):
        runs.append(phase_serve(cfg, params))
        gc.collect()
        torch.cuda.empty_cache()
    emit("derates_median", runs=n, **{
        k: float(np.median([r[k] for r in runs])) for k in DERATES},
        by_run={k: [r[k] for r in runs] for k in DERATES},
        in_use=runs[0]["in_use"])
    _, executors = phase_live(cfg, params)
    phase_live(cfg, params, "live_warm", executors)
    phase_frontend(cfg, executors)
    return 0


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


def _ptxas_entries(log, name_re, describe):
    """ptxas's report (``-Xptxas -v`` in a build's ``nvcc.log``) of every
    entry function whose mangled name matches ``name_re``: ``describe(m)``
    of the match, with its registers a thread and spill bytes."""
    out, cur = [], None
    for line in Path(log).read_text().splitlines():
        m = re.search(r"Compiling entry function '" + name_re, line)
        if m:
            cur = describe(m)
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


def ptxas_attention(log=None):
    """Registers and spill bytes of every instantiation of the attention
    kernels (``decode_kernel.cuh``'s split and combine passes,
    ``prefill_kernel.cuh``'s FMA and tensor-core bodies; paged and dense),
    from this checkout's build or ``log``, another build's: by kernel,
    view, head dim ``D``, query and cache types, the FMA body's padded
    group ``gm``, and ``lse``, whether it is the form that writes the
    log-sum-exp (None where the checkout's kernels have no such form)."""
    def describe(m):
        args = m.group(2)
        head = re.match(r"(13__nv_bfloat16|S1_|f|a)*", args).group(0)
        names = []
        for t in re.findall(r"13__nv_bfloat16|S1_|f|a", head):
            names.append(names[0] if t == "S1_" else "bf16" if
                         t.startswith("13") else "i8" if t == "a" else "f32")
        ints = [int(x) for x in re.findall(r"Li(\d+)E", args)]
        lse = re.search(r"Lb([01])E", args)
        view = re.search(r"(Dense|Pool)View", args)
        d = {"kernel": m.group(1), "view": view.group(1).lower()
             if view else None, "types": names,
             "D": ints[0] if ints and m.group(1) != "decode_combine_kernel"
             else None,
             "lse": lse.group(1) == "1" if lse else None}
        if m.group(1) == "decode_split_kernel" and len(ints) > 1:
            d["gm"] = ints[1]
        return d
    return _ptxas_entries(log or build.build_dir() / "nvcc.log",
                          r"_ZN5paged\d+(\w+?_kernel)I(\w+)'", describe)


def ptxas_d256():
    """The head-dim-256 instantiations of :func:`ptxas_attention`."""
    return [e for e in ptxas_attention() if e["D"] == 256]


def ptxas_compare(log):
    """The serving instantiations of the attention kernels (``lse`` not
    true) of this build against those of the build whose ``nvcc.log`` is
    ``log``, matched by kernel, view, D, types and group: every pair whose
    registers or spill bytes differ, and how many pairs were compared."""
    def key(e):
        return (e["kernel"], e["view"], e["D"], tuple(e["types"]),
                e.get("gm"))

    def fields(e):
        return (e.get("registers"), e.get("spill_stores"),
                e.get("spill_loads"))
    old = {key(e): e for e in ptxas_attention(log)}
    differ, n = [], 0
    for e in ptxas_attention():
        if e["lse"] or key(e) not in old:
            continue
        n += 1
        if fields(e) != fields(old[key(e)]):
            differ.append({"this": e, "other": old[key(e)]})
    return {"compared": n, "differ": differ,
            "lse_forms": sum(bool(e["lse"]) for e in ptxas_attention())}


def ptxas_scan(log=None):
    """What ptxas reported (``-Xptxas -v``: the ``nvcc.log`` of this
    checkout's build, or ``log``, another build's) for every instantiation of the scan's kernels (``csrc/ssd_scan.cu``'s
    ``ssd_walk_kernel``, ``csrc/ssd_scan_bwd.cu``'s ``ssd_bwd_kernel``
    where the checkout has it): registers a thread and spill bytes, by
    kernel, state width N, input type and, for the forward, whether the
    instantiation writes the tile states (None where the checkout's walk
    has no such parameter)."""
    def describe(m):
        n = re.search(r"Li(\d+)E", m.group(2))
        st = re.search(r"Lb([01])E", m.group(2))
        return {"kernel": m.group(1), "N": int(n.group(1)) if n else None,
                "type": "bf16" if "bfloat16" in m.group(2) else "f32",
                "states": st.group(1) == "1" if st else None}
    return _ptxas_entries(log or build.build_dir() / "nvcc.log",
                          r"_ZN\d+ssd\w*?\d+(ssd_\w+?_kernel)I(\w+)'",
                          describe)


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
    return {"kernel": "decode_attention", "form": "serving",
            "shape": shape_name, "dtype": str(dtype).split(".")[1], "B": B,
            "S": S,
            "max_ctx": max(lengths), "max_abs_err": err, "tol": TOL[dtype],
            "plain_max_abs": ref_max,
            "ms": time_ms(run), "plain_ms": time_ms(plain),
            "library_ms": time_ms(lib),
            **bound(*dense_decode_work(q, k, lengths), dtype)}


def dense_decode_work(q, k, lengths, lse=False):
    """Kernel 3's (bytes, operations) at these inputs: the live keys and
    values read once, q read and the output written once, the lengths;
    4 B a row more for the log-sum-exp form's lse."""
    B, hq, d = q.shape
    keys = sum(min(n, k.shape[1]) for n in lengths)
    nbytes = (2 * keys * k.shape[2] * d * k.element_size()
              + 2 * q.numel() * q.element_size() + 4 * B)
    return nbytes + (4 * B * hq if lse else 0), 4.0 * hq * d * keys


def dense_prefill_work(q, k, prefix, lse=False):
    """Kernel 4's (bytes, operations): the keys below the chunk's
    frontier once, q read and the output written once, a query-key pair
    for every token and every key it may see; 4 B a query row more for
    the log-sum-exp form's lse."""
    B, tq, hq, d = q.shape
    pairs = B * (tq * prefix + tq * (tq + 1) // 2)
    nbytes = (2 * B * (prefix + tq) * k.shape[2] * d * k.element_size()
              + 2 * q.numel() * q.element_size() + 4)
    return nbytes + (4 * B * tq * hq if lse else 0), 4.0 * hq * d * pairs


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
    return {"kernel": "chunked_prefill_attention", "form": "serving",
            "shape": shape_name, "dtype": str(dtype).split(".")[1], "B": B,
            "Tq": tq,
            "prefix": prefix, "S": S, "max_abs_err": err,
            "tol": TOL[dtype], "plain_max_abs": ref_max,
            "ms": time_ms(run), "plain_ms": time_ms(plain),
            "library_ms": time_ms(lib),
            **bound(*dense_prefill_work(q, k, prefix), dtype)}


#: kernels 3 and 4's log-sum-exp (f32, a few units to ~10 at these
#: shapes): float32 sums of up to 4096 exponentials in another order than
#: the plain version's, exp2 of pre-scaled scores in the tensor-core bodies
LSE_TOL = 1e-3


def _halves(S):
    """The two slot halves (first slot, slots) of an S-slot cache: the
    pieces a slot-split cache's ranks hold on a model axis of 2."""
    return [(0, S // 2), (S // 2, S // 2)]


def _lse_err(a, b):
    return (a - b).abs().max().item()


def check_dense_decode_lse(shape, lengths, S=DENSE_S):
    """Kernel 3's log-sum-exp form at a serving row: its output bit-equal
    to the serving form's, its lse against the plain version's, and the
    two slot halves' partials (each at its local lengths: what a rank of
    a slot-split cache runs) combined (``combine_stacked``) against the
    whole kernel call and the plain version; both forms timed."""
    shape_name, hq, hkv, d, dtype = shape
    B = len(lengths)
    k, v = make_dense_kv(11, B, hkv, d, dtype, S)
    g = torch.Generator(device=DEV)
    g.manual_seed(12)
    q = torch.randn((B, hq, d), device=DEV, generator=g).to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    serve = lambda: dec_ops.decode_attention(q, k, v, ln)
    lse_form = lambda: dec_ops.decode_attention(q, k, v, ln, return_lse=True)
    out, lse = lse_form()
    whole = serve()
    parts = [dec_ops.decode_attention(
        q, k[:, off:off + n], v[:, off:off + n],
        (ln.long() - off).clamp(0, n).to(torch.int32), return_lse=True)
        for off, n in _halves(S)]
    comb = attn_lib.combine_stacked(torch.stack([p[0] for p in parts]),
                                    torch.stack([p[1] for p in parts]))
    torch.cuda.synchronize()
    ref, ref_lse = dec_ops.decode_attention_ref(q, k, v, ln, return_lse=True)
    res = {"kernel": "decode_attention", "form": "lse", "shape": shape_name,
           "dtype": str(dtype).split(".")[1], "B": B, "S": S,
           "max_ctx": max(lengths),
           "out_bit_equal_serving": torch.equal(out, whole),
           "lse_err": _lse_err(lse, ref_lse), "lse_tol": LSE_TOL,
           "halves_vs_kernel": (comb.float() - whole.float()).abs().max()
           .item(),
           "halves_vs_plain": (comb.float() - ref.float()).abs().max().item(),
           "tol": TOL[dtype]}
    del ref, ref_lse
    assert res["out_bit_equal_serving"], res
    assert res["lse_err"] <= LSE_TOL, res
    assert max(res["halves_vs_kernel"], res["halves_vs_plain"]) \
        <= TOL[dtype], res
    res["ms"] = time_ms(serve)
    res["lse_ms"] = time_ms(lse_form)
    res.update(bound(*dense_decode_work(q, k, lengths, lse=True), dtype))
    return res


def check_dense_prefill_lse(shape, B, tq, prefix, S=DENSE_S):
    """Kernel 4's log-sum-exp form, as :func:`check_dense_decode_lse`: the
    halves take the chunk's offset less the half's first slot (past the
    first half's end, or negative on the second half)."""
    shape_name, hq, hkv, d, dtype = shape
    k, v = make_dense_kv(13, B, hkv, d, dtype, S)
    g = torch.Generator(device=DEV)
    g.manual_seed(14)
    q = torch.randn((B, tq, hq, d), device=DEV, generator=g).to(dtype)
    pre = torch.tensor(prefix, dtype=torch.int32, device=DEV)
    serve = lambda: pf_ops.chunked_prefill_attention(q, k, v, pre)
    lse_form = lambda: pf_ops.chunked_prefill_attention(q, k, v, pre,
                                                        return_lse=True)
    out, lse = lse_form()
    whole = serve()
    parts = [pf_ops.chunked_prefill_attention(
        q, k[:, off:off + n], v[:, off:off + n], prefix - off,
        return_lse=True) for off, n in _halves(S)]
    comb = attn_lib.combine_stacked(torch.stack([p[0] for p in parts]),
                                    torch.stack([p[1] for p in parts]))
    torch.cuda.synchronize()
    ref, ref_lse = pf_ops.chunked_prefill_attention_ref(q, k, v, prefix,
                                                        return_lse=True)
    res = {"kernel": "chunked_prefill_attention", "form": "lse",
           "shape": shape_name, "dtype": str(dtype).split(".")[1], "B": B,
           "Tq": tq, "prefix": prefix, "S": S,
           "halves_prefix": [prefix - off for off, _ in _halves(S)],
           "out_bit_equal_serving": torch.equal(out, whole),
           "lse_err": _lse_err(lse, ref_lse), "lse_tol": LSE_TOL,
           "halves_vs_kernel": (comb.float() - whole.float()).abs().max()
           .item(),
           "halves_vs_plain": (comb.float() - ref.float()).abs().max().item(),
           "tol": TOL[dtype]}
    del ref, ref_lse
    assert res["out_bit_equal_serving"], res
    assert res["lse_err"] <= LSE_TOL, res
    assert max(res["halves_vs_kernel"], res["halves_vs_plain"]) \
        <= TOL[dtype], res
    res["ms"] = time_ms(serve)
    res["lse_ms"] = time_ms(lse_form)
    res.update(bound(*dense_prefill_work(q, k, prefix, lse=True), dtype))
    return res


#: the log-sum-exp forms' shapes: zamba2-7b's (the main path's, both
#: types), qwen2.5-3b's 16 / 2 / 128 (``tp_local``'s) on the same
#: 2048-slot cache, gemma3-1b's head dim 256 on its 4096-slot one
LSE_SHAPES = [(ZAMBA, 32, 32, 112, torch.bfloat16, DENSE_S),
              (ZAMBA, 32, 32, 112, torch.float32, DENSE_S),
              (MODEL, 16, 2, 128, torch.bfloat16, DENSE_S),
              (GEMMA, 4, 1, 256, torch.bfloat16, FAMILY_S),
              (GEMMA, 4, 1, 256, torch.float32, FAMILY_S)]


def phase_kernels_dense_lse():
    """Kernels 3 and 4's log-sum-exp forms at LSE_SHAPES: decode at the
    serving rows (8 rows to S keys), the prefill row of record (Tq 1024
    at prefix 1024) and a chunk whose second half's offset is negative
    with keys live in it (Tq 1024 at S / 2 - 512)."""
    cases = []
    for name, hq, hkv, d, dtype, S in LSE_SHAPES:
        shape = (name, hq, hkv, d, dtype)
        lengths = ([2048, 1, 700, 1536, 33, 1024, 2000, 129] if S == DENSE_S
                   else [4096, 1, 1400, 3072, 33, 2048, 4000, 129])
        cases.append(check_dense_decode_lse(shape, lengths, S))
        cases.append(check_dense_prefill_lse(shape, 1, 1024, 1024, S))
        cases.append(check_dense_prefill_lse(shape, 1, 1024, S // 2 - 512,
                                             S))
    return cases


def ssd_inputs(h, p, n, t, dtype, seed=15, b=1):
    """One slot's scan inputs (batch 1: the engine prefills one slot at a
    time; a training batch of ``b`` rows), drawn as the model makes them:
    A from -1 to -16 over the heads (``init_mamba2``), dt through
    softplus, x, B and C through SiLU, a non-zero float32 initial state;
    x, dt, B and C in ``dtype``."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    silu = torch.nn.functional.silu
    x = silu(torch.randn((b, t, h, p), device=DEV, generator=g))
    dt = torch.nn.functional.softplus(
        torch.randn((b, t, h), device=DEV, generator=g))
    A = -torch.linspace(1.0, 16.0, h, device=DEV)
    B = silu(torch.randn((b, t, 1, n), device=DEV, generator=g))
    C = silu(torch.randn((b, t, 1, n), device=DEV, generator=g))
    s0 = 0.1 * torch.randn((b, h, p, n), device=DEV, generator=g)
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
    # the launch training makes: the same bits, and the state entering
    # each tile written besides
    args = ssd_ops._kernel_inputs(x, dt, A, B, C, L, s0)
    with_states = lambda: ssd_ops._launch_scan(*args, True)
    y1, s1, _ = with_states()
    torch.cuda.synchronize()
    states_bit_equal = torch.equal(y, y1) and torch.equal(s, s1)
    assert states_bit_equal, f"ssd {shape_name} {dtype} t={t}: states"
    del y1, s1
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
            "states_bit_equal": states_bit_equal,
            "ms_with_states": time_ms(with_states),
            "library_ms": None,
            "library": "none: no single PyTorch call computes a chunked "
                       "SSD scan",
            **ssd_bound(x, dt, A, B, C, s0)}


def ssd_bwd_bound(x, dt, A, B, C, s0, dy, ds):
    """Kernel 5b's least time, in the terms of ``ssd_bound``, on the bytes
    of the function itself: x, dt, B, C and dy in their type, A, the
    initial state and the final state's cotangent in float32 read once;
    dx in x's type, ddt, dA, a group's dB and dC ``[b, t, g, n]`` and the
    initial state's gradient in float32 written once; or 10 P N operations
    a token and head (twice the forward's) at the bf16 tensor-core rate."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    f32 = lambda a: 4 * a.numel() if a is not None else 0
    nbytes = (3 * x.numel() * x.element_size()      # x, dy read; dx
              + dt.numel() * (dt.element_size() + 4) + 2 * f32(A)
              + (B.numel() + C.numel()) * (B.element_size() + 4)
              + 2 * f32(s0) + f32(ds))
    return bound(nbytes, 10.0 * b * t * h * p * n, torch.bfloat16)


def check_ssd_bwd(shape_name, h, n, b, t, L, dtype, with_s0, with_ds):
    """Kernel 5b through ``SSDScanFn`` (the forward kernel with its tile
    states, then the backward) against float64 ``torch.autograd`` of
    ``ssd_scan_ref`` on the card, every input's gradient within
    ``SSD_GRAD_TOL`` of its largest value; the forward's y and final state
    from the same call held to the float64 forward as ``check_ssd`` holds
    them, and bit-equal to a ``no_grad`` call; timed (``time_ms``) on the
    forward kernel's inputs and tile states, beside its plain reverse walk
    ``ssd_scan_bwd_ref`` on the same.  ``design_bytes``: what this design
    moves beyond the function's own bytes (the tile states read, and the
    per-head dA, dB and dC the kernel writes for the wrapper's sums);
    ``head_sums_ms``: those sums of dB and dC alone (inside ``ms``)."""
    x, dt, A, B, C, s0 = ssd_inputs(h, 64, n, t, dtype, b=b)
    s0 = s0 if with_s0 else None
    g = torch.Generator(device=DEV)
    g.manual_seed(16)
    dy = torch.randn((b, t, h, 64), device=DEV, generator=g).to(dtype)
    ds = (torch.randn((b, h, 64, n), device=DEV, generator=g) if with_ds
          else None)
    names = ("x", "dt", "A", "B", "C", "init_state")

    def loss(y, s):
        out = (y * dy.to(y.dtype)).sum()
        return out + (s * ds.to(s.dtype)).sum() if ds is not None else out

    ins = [a.clone().requires_grad_(True) if a is not None else None
           for a in (x, dt, A, B, C, s0)]
    y, s = ssd_ops.ssd_scan(*ins[:5], L, ins[5])
    loss(y.float(), s).backward()
    y, s = y.detach(), s.detach()
    with torch.no_grad():
        y0, s0_out = ssd_ops.ssd_scan(x, dt, A, B, C, L, s0)
    torch.cuda.synchronize()
    fwd_bit_equal = torch.equal(y, y0) and torch.equal(s, s0_out)
    assert fwd_bit_equal, f"ssd_bwd {shape_name} {dtype} t={t}: forward"
    del y0, s0_out
    r64 = [a.detach().double().requires_grad_(True) if a is not None
           else None for a in (x, dt, A, B, C, s0)]
    ry, rs = ssd_ops.ssd_scan_ref(*r64[:5], L, r64[5])
    want = torch.autograd.grad(loss(ry, rs),
                               [a for a in r64 if a is not None])
    slack = BF16_HALF_STEP if dtype == torch.bfloat16 else 0.0
    ry, rs = ry.detach(), rs.detach()
    fwd_err = max(((y.double() - ry).abs() - slack * ry.abs()).max().item(),
                  (s.double() - rs).abs().max().item())
    assert y.dtype == dtype and s.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    assert fwd_err <= SSD_TOL, \
        f"ssd_bwd {shape_name} {dtype} t={t}: forward {fwd_err}"
    del y, s, ry, rs
    rel, err = {}, 0.0
    for name, a, w in zip(names, [a for a in ins if a is not None], want):
        assert a.grad.dtype == a.dtype and torch.isfinite(a.grad).all()
        gap = (a.grad.double() - w).abs().max().item()
        rel[name] = gap / max(w.abs().max().item(), 1e-30)
        err = max(err, gap)
    del r64, want
    tol = SSD_GRAD_TOL[dtype]
    assert max(rel.values()) <= tol, \
        f"ssd_bwd {shape_name} {dtype} t={t}: {rel}"
    # the wrapper against its plain reverse walk (the kernel's rounding) on
    # the same inputs and the tile states the forward kernel wrote
    args = ssd_ops._kernel_inputs(x, dt, A, B, C, L, s0)
    _, _, states = ssd_ops._launch_scan(*args, True)
    run = lambda: ssd_ops.ssd_scan_bwd(*args[:5], states, dy, ds,
                                       with_ds0=with_s0)
    plain = lambda: ssd_ops.ssd_scan_bwd_ref(
        *(a.float() for a in args[:5]), s0, dy, ds, states=states,
        p_round=ssd_ops.BWD_P_ROUND[dtype])
    # the wrapper's sums of the per-head dB and dC over a group's heads
    grp = B.shape[2]
    parts = [torch.empty((b, t, h, n), device=DEV) for _ in range(2)]
    head_sums = lambda: [q.view(b, t, grp, h // grp, n).sum(3)
                         for q in parts]
    plain_rel = {name: ((k.float() - w).abs().max()
                        / w.abs().max().clamp_min(1e-30)).item()
                 for name, k, w in zip(names, run(), plain())
                 if w is not None}
    assert max(plain_rel.values()) <= SSD_BWD_PLAIN_RTOL[dtype], \
        f"ssd_bwd {shape_name} {dtype} t={t} vs plain: {plain_rel}"
    return {"kernel": "ssd_scan_bwd", "shape": shape_name,
            "dtype": str(dtype).split(".")[1], "h": h, "p": 64, "n": n,
            "b": b, "t": t, "L": L, "init_state": with_s0,
            "final_state_cotangent": with_ds, "max_abs_err": err,
            "rel_err_by_input": rel, "tol": tol, "oracle": "float64 "
            "autograd of ssd_scan_ref on the card",
            "forward_max_abs_err": fwd_err, "forward_tol": SSD_TOL,
            "forward_bit_equal_no_grad": fwd_bit_equal,
            "plain_rel_err_by_input": plain_rel,
            "plain_tol": SSD_BWD_PLAIN_RTOL[dtype],
            "design_bytes": {"tile_states_read": 4 * states.numel(),
                             "per_head_partials_written":
                                 4 * (b * h + 2 * b * t * h * n)},
            "ms": time_ms(run), "plain_ms": time_ms(plain),
            "head_sums_ms": time_ms(head_sums),
            "library_ms": None,
            "library": "none: no single PyTorch call computes the scan's "
                       "gradient",
            **ssd_bwd_bound(x, dt, A, B, C, s0, dy, ds)}


def phase_kernels_ssd():
    cases = [check_ssd(*args) for args in SSD_SHAPES]
    cases += [check_ssd_bwd(*args) for args in SSD_BWD_SHAPES]
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
    # whisper-base's decoder (8 / 8 / 64) on its 448-token text context,
    # both types; llava-next-34b's 56 / 8 / 128 (a group of 7) in bf16
    for dtype in (torch.bfloat16, torch.float32):
        shape = (WHISPER, 8, 8, 64, dtype)
        cases.append(check_dense_decode(
            shape, [448, 1, 200, 64, 33, 448, 300, 129], WHISPER_S))
        cases.append(check_dense_prefill(shape, 4, 64, 0, WHISPER_S))
    shape = (LLAVA, 56, 8, 128, torch.bfloat16)
    cases.append(check_dense_decode(shape, long_lengths, LLAVA_S))
    cases.append(check_dense_prefill(shape, 1, 1024, 1024, LLAVA_S))
    cases += phase_kernels_dense_lse()
    emit("kernels_dense", cases=cases)
    cases += phase_kernels_ssd()
    torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------
# the dense families at full width: kernels vs plain versions
# ---------------------------------------------------------------------------

def scaled_err_lists(a, b):
    """Largest gap between two lists of logit tensors, each over the larger
    of 1 and the second's largest magnitude."""
    worst = 0.0
    for x, y in zip(a, b):
        scale = max(y.abs().max().item(), 1.0)
        worst = max(worst, (x - y).abs().max().item() / scale)
    return worst


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

    bf_kernel = run(params, torch.bfloat16, plain=False)
    bf_plain = run(params, torch.bfloat16, plain=True)
    params32 = _float_tree(params)
    f32_kernel = run(params32, torch.float32, plain=False)
    f32_plain = run(params32, torch.float32, plain=True)
    del params32, params
    err_f32 = scaled_err_lists(f32_kernel, f32_plain)
    err_kernel = scaled_err_lists(bf_kernel, f32_plain)
    err_plain = scaled_err_lists(bf_plain, f32_plain)
    agree = torch.cat([(a.argmax(-1) == b.argmax(-1)).float()
                       for a, b in zip(bf_kernel, f32_plain)])
    emit(phase, model=cfg.name, layers=cfg.num_layers,
         layers_registered=get_config(cfg.name).num_layers,
         attention_layers=n_kv, launches=want,
         f32_kernel_vs_plain=err_f32, f32_tol=MODEL_TOL_F32,
         bf16_kernel_vs_f32=err_kernel, bf16_plain_vs_f32=err_plain,
         bf16_kernel_vs_bf16_plain=scaled_err_lists(bf_kernel, bf_plain),
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
    dec_only = [e for e in log if not e["prefill"]]
    on_graphs = sum(e["replayed"] or e["captured"] for e in dec_only)
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
        decode_only_iterations_on_graphs=f"{on_graphs}/{len(dec_only)}",
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


def scan_layers(cfg):
    """Layers that run a Mamba2 mixer, hence the scan: MAMBA2 and
    ZAMBA_ATTN (a shared attention block beside a mixer of its own)."""
    return sum(b in tf.STATE_BLOCKS for b in tf.layer_types(cfg))


def served_scans(cfg, chunks, launches):
    """Every slot prefill of more than one token scans once a MAMBA2
    layer, at the chunk the model's rule picks for its length (held
    against the run's scan launches); the served (T, chunk, count)
    histogram and the scan kernel's time summed over it."""
    n_scan = scan_layers(cfg)
    served = collections.Counter(
        (take, m2.scan_chunk(cfg, take)) for takes in chunks.values()
        for take in takes if take > 1)
    served = sorted([T, c, k] for (T, c), k in served.items())
    assert sum(k for _, _, k in served) * n_scan \
        == launches["ssd_scan"], (served, launches)
    scan_ms, scan_per_t = served_scan_ms(
        served, n_scan, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state)
    return dict(served_prefills=served, scan_ms_served=scan_ms,
                scan_ms_by_prefill=scan_per_t)


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
    emit("serve_zamba2", **fields, **served_scans(cfg, chunks, launches))
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


def phase_serve_mamba2(cfg, params):
    """mamba2-1.3b at full width and depth (48 MAMBA2 layers, no
    attention): two 8-slot dense instances at ``max_seq`` 4096, 16
    requests with prompts of 128-2048 tokens and 16-64 output tokens,
    arriving at 8 a second.  Held: the scan launched once a layer for
    every slot prefill of more than one token, no attention kernel, every
    first token equal to its replay's, and the float32 replay of every
    prompt's served chunks against the float32 cache-free forward (the
    recurrent state carried across chunks against one scan of the
    prompt).  Reported: ``scan_ms_served``."""
    wl = WorkloadSpec("mamba2-smoke",
                      LengthDist(mu=6.7, sigma=0.7, lo=128, hi=2048),
                      LengthDist(mu=3.4, sigma=0.5, lo=16, hi=64),
                      tokenized=True, vocab_size=cfg.vocab_size)
    fields, launches, chunks, reqs = serve_dense(
        cfg, params, wl, 8.0, FAMILY_S, DENSE_KERNELS, f32_oracle=True)
    emit("serve_mamba2", **fields, **served_scans(cfg, chunks, launches))
    assert launches["ssd_scan"] > 0 \
        and launches["decode_attention"] == 0 \
        and launches["chunked_prefill_attention"] == 0, launches
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
# the encoder-decoder and VLM families served through the executor
# ---------------------------------------------------------------------------

def phase_serve_whisper():
    """whisper-base at full width and depth (6 ENC + 6 DEC layers), bf16,
    served text-only as the reference serves it: ``serve_dense``'s two
    8-slot dense instances on the 448-token text context, 16 requests with
    prompts of 32-224 tokens and 16-96 output tokens (prompt, output and
    the executor's 64-token headroom stay within 448), arriving at 8 a
    second.  Every decoder layer's cross-attention reads a cache of 0 keys
    and the encoder never runs.  Held: only kernels 3 and 4 run, each at
    least once; every decode-only iteration replays a graph (or captures
    it at its bucket's first use); every first token equals its
    replay's."""
    cfg = get_config(WHISPER)
    params = tf.init_params(0, cfg, device=DEV)
    wl = WorkloadSpec("whisper-smoke",
                      LengthDist(mu=4.6, sigma=0.6, lo=32, hi=224),
                      LengthDist(mu=3.7, sigma=0.5, lo=16, hi=96),
                      tokenized=True, vocab_size=cfg.vocab_size)
    fields, launches, _, reqs = serve_dense(
        cfg, params, wl, 8.0, WHISPER_S, DENSE_KERNELS, cache_free=False)
    emit("serve_whisper", **fields, parameters=count_params(params),
         layers={"enc": cfg.num_encoder_layers, "dec": cfg.num_layers},
         cross_len=0,
         longest_context=max(r.prompt_len + r.target_output_len
                             for r in reqs))
    assert launches["decode_attention"] > 0 \
        and launches["chunked_prefill_attention"] > 0 \
        and launches["ssd_scan"] == 0, launches
    done, total = fields["decode_only_iterations_on_graphs"].split("/")
    assert done == total and int(total) > 0, \
        fields["decode_only_iterations_on_graphs"]
    assert fields["first_token_equals_replay"] == f"{len(reqs)}/{len(reqs)}", \
        fields["first_token_equals_replay"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def llava_depth(cfg, free_bytes):
    """The deepest stack of at most ``cfg.num_layers`` layers whose bf16
    weights, two pools of LLAVA_MIN_POOL blocks and LLAVA_RESERVE_BYTES fit
    in ``free_bytes``."""
    one = dataclasses.replace(cfg, num_layers=1).param_count()
    per_layer = dataclasses.replace(cfg, num_layers=2).param_count() - one
    base = one - per_layer
    for n in range(cfg.num_layers, 0, -1):
        block = BLOCK * n * 2 * cfg.num_kv_heads * cfg.head_dim * 2
        need = (2 * (base + n * per_layer) + LLAVA_RESERVE_BYTES
                + 2 * LLAVA_MIN_POOL * block)
        if need <= free_bytes:
            return n
    raise RuntimeError("llava-next-34b does not fit one layer deep")


def served_paged_rows(log, reqs):
    """rid -> the request's prefill rows as the paged executor packed
    them: (take, position, B, T, NB, its row), in order (the prefill rows
    lead a packed step, in the plan's order)."""
    out = {r.rid: [] for r in reqs}
    for e in log:
        if not e["prefill"]:
            continue
        for row, ((take, pos), rid) in enumerate(zip(e["prefill"],
                                                     e["prefill_rids"])):
            assert pos == sum(t for t, *_ in out[rid]), (rid, pos)
            out[rid].append((take, pos, *e["packed"], row))
    for r in reqs:
        assert sum(t for t, *_ in out[r.rid]) == r.prompt_len, r.rid
    return out


@torch.no_grad()
def replay_paged(ex, prompt, rows):
    """The first token of ``prompt`` prefilled again on the fresh one-slot
    paged executor ``ex``, in its served chunks and at their packed shapes
    (the same GEMM shapes, so the same kernels and sums): the row at its
    served index, every other row padding, its table the pool's first
    blocks."""
    for take, pos, B, T, NB, row in rows:
        tokens = np.zeros((B, T), np.int32)
        start = np.zeros(B, np.int32)
        valid = np.zeros(B, np.int32)
        tables = np.full((B, NB), -1, np.int32)
        tokens[row, :take] = prompt[pos:pos + take]
        start[row], valid[row] = pos, take
        tables[row] = np.arange(NB, dtype=np.int32)
        tok = ex._mixed_fused(ex._to_dev(tokens), ex._to_dev(start),
                              ex._to_dev(valid), ex._to_dev(tables))
    return int(tok[row])


def phase_serve_llava():
    """llava-next-34b served text-only on the paged path (its projector
    unused), at full width and, where it fits, full depth (60 layers:
    34.4 B parameters, 68.8 GB in bf16): ``build_cluster`` under
    ``TaiChiPolicy`` with one P-heavy (chunk 1024) and one D-heavy (chunk
    256) instance of LLAVA_SERVE_SLOTS slots at ``max_seq`` 4096, sharing
    one params dict, each pool sized to half of what the weights and
    LLAVA_RESERVE_BYTES leave (at most LLAVA_MAX_POOL blocks); 16 requests
    with prompts of 128-2048 tokens and 16-64 output tokens arriving at 4
    a second.  Kernels 1 and 2 run at a group of 7.  Held as ``serve``:
    every request finishes, launches equal readbacks times layers, graphs
    on exactly the decode-only iterations, the pools' invariants; and
    every first token equals a replay of its served chunks on a fresh
    one-slot paged executor through the kernels.  Runs last: nothing else
    is on the card."""
    full = get_config(LLAVA)
    gc.collect()
    torch.cuda.empty_cache()
    free0, total = torch.cuda.mem_get_info()
    # what the earlier phases leave: torch's own figures, and the bytes of
    # the CUDA tensors Python still reaches (their weights and pools are
    # gone when these are near 0; the rest is the allocator's)
    live = [o for o in gc.get_objects()
            if issubclass(type(o), torch.Tensor) and o.is_cuda]
    held0 = {"allocated": torch.cuda.memory_allocated(),
             "reserved": torch.cuda.memory_reserved(),
             "live_tensors": len(live),
             "live_tensor_bytes": sum(t.numel() * t.element_size()
                                      for t in live)}
    del live
    cfg = dataclasses.replace(full, num_layers=llava_depth(full, free0))
    t0 = time.perf_counter()
    params = tf.init_params(0, cfg, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()        # the draws' float32 temporaries
    n_params = count_params(params)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    block_bytes = BLOCK * cfg.num_layers * 2 * cfg.num_kv_heads \
        * cfg.head_dim * 2
    free1, _ = torch.cuda.mem_get_info()
    blocks = int(min(LLAVA_MAX_POOL,
                     (free1 - LLAVA_RESERVE_BYTES) // (2 * block_bytes)))
    assert blocks >= LLAVA_MIN_POOL, dict(
        blocks=blocks, free_before_weights=free0, free_after=free1,
        total=total, layers=cfg.num_layers, torch_before_weights=held0)
    log = []
    sc = ServingConfig(model=cfg.name, tp=1, policy="taichi",
                       sliders=Sliders(n_p=1, n_d=1, s_p=1024, s_d=256),
                       hbm_blocks=blocks, block_size=BLOCK)
    factory = lambda: TimedExecutor(
        cfg, params, n_slots=LLAVA_SERVE_SLOTS, max_seq=LLAVA_SERVE_S,
        hbm_blocks=blocks, device=DEV, log=log)
    slo = SLO(ttft=10.0, tpot=0.5)
    cluster = build_cluster(sc, slo, seed=0, executor_factory=factory)
    cluster._on_exec_error = raise_exec_error
    wl = WorkloadSpec("llava-smoke",
                      LengthDist(mu=6.5, sigma=0.8, lo=128, hi=2048),
                      LengthDist(mu=3.4, sigma=0.5, lo=16, hi=64),
                      tokenized=True, vocab_size=cfg.vocab_size)
    reqs = wl.sample_requests(16, qps=4.0, seed=0)
    executors = [inst.executor for inst in cluster.policy.instances]
    assert all(ex.paged for ex in executors)
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
    peak = torch.cuda.max_memory_allocated()

    check_finished(cfg, reqs, cluster)
    assert all(n > 0 for n in launches.values()), launches
    iterations = sum(inst.iterations for inst in cluster.policy.instances)
    readbacks = sum(ex.host_readbacks for ex in executors)
    assert 0 < readbacks <= iterations, (readbacks, iterations)
    assert len(log) == readbacks
    assert sum(launches.values()) == readbacks * cfg.num_layers, \
        (launches, readbacks)
    assert all((e["replayed"] or e["captured"]) == (not e["prefill"])
               for e in log)
    for ex in executors:
        ex.kv.check_invariants()
    rows = served_paged_rows(log, reqs)
    graphs = graph_stats(executors, log)
    derates = derive_derates(log, cluster.cost)
    first = {r.rid: r.output_tokens[0] for r in reqs}
    out_tokens = sum(len(r.output_tokens) for r in reqs)
    in_tokens = sum(r.prompt_len for r in reqs)
    transfers = cluster.transfer_count
    del cluster, executors
    gc.collect()
    torch.cuda.empty_cache()

    # each first token against its replay on a fresh one-slot executor
    replay = TorchExecutor(cfg, params, n_slots=1, max_seq=LLAVA_SERVE_S,
                           hbm_blocks=LLAVA_SERVE_S // BLOCK, device=DEV)
    equal = sum(replay_paged(replay, r.prompt_tokens, rows[r.rid])
                == first[r.rid] for r in reqs)
    del replay
    step = graphs["replay_device_ms_a_step_by_k"].get(1)
    emit("serve_llava", model=cfg.name, layers=cfg.num_layers,
         layers_registered=full.num_layers, parameters=n_params,
         weight_bytes=weight_bytes, params_init_s=init_s,
         device_free_before_weights=free0, device_total=total,
         torch_bytes_before_weights=held0,
         pool_blocks_per_instance=blocks, block_bytes=block_bytes,
         kv_pool_bytes=pool_bytes, reserve_bytes=LLAVA_RESERVE_BYTES,
         slots_per_instance=LLAVA_SERVE_SLOTS, max_seq=LLAVA_SERVE_S,
         requests=len(reqs), prompt_tokens=in_tokens,
         output_tokens=out_tokens,
         prompt_lengths=sorted(r.prompt_len for r in reqs),
         wall_s=wall, output_tokens_per_s=out_tokens / wall,
         iterations=iterations,
         iterations_by_kind={k: derates[k] for k in (
             "prefill_only_iterations", "decode_only_iterations",
             "mixed_iterations")},
         host_readbacks=readbacks, transfers=transfers, launches=launches,
         peak_memory_bytes=peak, graphs=graphs,
         decode_step_device_ms=step,
         decode_step_weight_read_bound_ms=1e3 * weight_bytes
         / HBM_BYTES_PER_S,
         first_token_equals_replay=f"{equal}/{len(reqs)}",
         measured=derates)
    assert equal == len(reqs), equal
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_examples():
    """The port's examples on the card at their reduced configs, each
    held to its own end condition (their printing captured):
    ``quickstart`` serves every request within the SLO,
    ``latency_shifting_demo`` degrades under memory pressure, and
    ``train_smollm`` trains 30 steps (the loss falls) and restores its
    checkpoint bit for bit."""
    from repro_torch.examples import (latency_shifting_demo, quickstart,
                                      train_smollm)
    out = {}
    printed = io.StringIO()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_ckpt", "smollm.npz")
    with contextlib.redirect_stdout(printed):
        t0 = time.perf_counter()
        st = quickstart.main(["--device", DEV])
        out["quickstart"] = {
            "seconds": time.perf_counter() - t0,
            "attainment": st.slo_attainment,
            "finished": sum(len(r.output_tokens) == r.target_output_len
                            for r in st.reqs), "requests": len(st.reqs)}
        t0 = time.perf_counter()
        cluster = latency_shifting_demo.main(["--device", DEV])
        out["latency_shifting_demo"] = {
            "seconds": time.perf_counter() - t0,
            "degrade_count": cluster.degrade_count,
            "backflow_count": cluster.backflow_count,
            "transfers": cluster.transfer_count}
        t0 = time.perf_counter()
        history, equal = train_smollm.main(
            ["--device", DEV, "--steps", "30", "--ckpt", path])
        out["train_smollm"] = {
            "seconds": time.perf_counter() - t0,
            "first_loss": history[0]["loss"],
            "last_loss": history[-1]["loss"],
            "checkpoint_restores_bit_equal": equal}
    emit("examples", **out, printed_lines=len(printed.getvalue()
                                              .splitlines()))
    q = out["quickstart"]
    assert q["finished"] == q["requests"] and q["attainment"] >= 0.9, q
    assert out["latency_shifting_demo"]["degrade_count"] > 0
    t = out["train_smollm"]
    assert t["last_loss"] < 0.95 * t["first_loss"], t
    assert t["checkpoint_restores_bit_equal"]


# ---------------------------------------------------------------------------
# the encoder-decoder and VLM families: the model path at full width
# ---------------------------------------------------------------------------

@torch.no_grad()
def check_model_modal(phase, cfg, prompt, embeds, chunk, steps, max_seq,
                      cross_len=0):
    """Random weights from seed 0; a prompt prefilled with its modality's
    embeddings (``full_prefill`` at ``chunk``: the first chunk carries
    them), then ``steps`` greedy decode steps, four ways as
    ``phase_model``: bf16 through the kernels (its greedy tokens are fed
    to the other three), bf16 through the plain versions, float32 through
    both (the bf16 weights are freed first).  Held: the first token equal
    on both paths in each type; float32 kernel against plain within
    MODEL_TOL_F32; the bf16 kernel path no further from float32 than 1.5
    times the plain path plus MODEL_TOL_BF16_SLACK; the launches the
    layers call for, none on the plain path.  Returns (fields, the float32
    parameters)."""
    params = tf.init_params(0, cfg, device=DEV)
    n_params = count_params(params)
    B, S = prompt.shape
    n_img = embeds.get("image_embeds", torch.empty(0, 0)).shape[1]
    n_dec = sum(b in tf.KV_BLOCKS for b in tf.layer_types(cfg))
    want = {"decode_attention": steps * n_dec,
            "chunked_prefill_attention": S // chunk * n_dec}
    forced = []

    def run(prm, dtype, plain):
        cache = tf.init_cache(cfg, B, max_seq, dtype=dtype, device=DEV,
                              cross_len=cross_len)
        n0 = launch_counts(DENSE_KERNELS)
        with plain_kernels() if plain else contextlib.nullcontext():
            lg, _ = tf.full_prefill(prm, cfg, prompt, cache, chunk,
                                    **{k: v.to(dtype)
                                       for k, v in embeds.items()})
            outs = [lg.float()]
            pos = torch.full((B,), n_img + S, device=DEV)
            for i in range(steps):
                if len(forced) == i:
                    forced.append(lg.argmax(-1))
                lg, _ = tf.decode_step(prm, cfg, forced[i][:, None], cache,
                                       pos)
                outs.append(lg.float())
                pos = pos + 1
        torch.cuda.synchronize()
        n1 = launch_counts(DENSE_KERNELS)
        got = {k: n1[k] - n0[k] for k in want}
        assert got == ({k: 0 for k in want} if plain else want), got
        assert outs[0].shape == (B, cfg.vocab_size)
        for o in outs:
            assert torch.isfinite(o).all()
        return outs

    bf_kernel = run(params, torch.bfloat16, plain=False)
    bf_plain = run(params, torch.bfloat16, plain=True)
    params32 = _float_tree(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    f32_kernel = run(params32, torch.float32, plain=False)
    f32_plain = run(params32, torch.float32, plain=True)
    err_f32 = scaled_err_lists(f32_kernel, f32_plain)
    err_kernel = scaled_err_lists(bf_kernel, f32_plain)
    err_plain = scaled_err_lists(bf_plain, f32_plain)
    first = {"bf16": bool(torch.equal(bf_kernel[0].argmax(-1),
                                      bf_plain[0].argmax(-1))),
             "f32": bool(torch.equal(f32_kernel[0].argmax(-1),
                                     f32_plain[0].argmax(-1)))}
    agree = torch.cat([(a.argmax(-1) == b.argmax(-1)).float()
                       for a, b in zip(bf_kernel, f32_plain)])
    fields = dict(
        model=cfg.name, layers=cfg.num_layers,
        layers_registered=get_config(cfg.name).num_layers,
        parameters=n_params, batch=B,
        prompt_tokens=S, image_tokens=n_img, cross_len=cross_len,
        chunk=chunk, first_chunk_tokens=n_img + chunk, decode_steps=steps,
        launches=want, first_token_equal=first,
        f32_kernel_vs_plain=err_f32, f32_tol=MODEL_TOL_F32,
        bf16_kernel_vs_f32=err_kernel, bf16_plain_vs_f32=err_plain,
        bf16_kernel_vs_bf16_plain=scaled_err_lists(bf_kernel, bf_plain),
        bf16_greedy_agreement_with_f32=agree.mean().item())
    ok = (first["bf16"] and first["f32"] and err_f32 <= MODEL_TOL_F32
          and err_kernel <= 1.5 * err_plain + MODEL_TOL_BF16_SLACK)
    if not ok:
        emit(phase, **fields)
    assert first["bf16"] and first["f32"], first
    assert err_f32 <= MODEL_TOL_F32, err_f32
    assert err_kernel <= 1.5 * err_plain + MODEL_TOL_BF16_SLACK, \
        (err_kernel, err_plain)
    return fields, params32


def phase_model_whisper():
    """whisper-base at full width and depth (6 ENC + 6 DEC layers) in
    bf16, batch 4: 1500 audio frames from a seed through the encoder,
    a 64-token decoder prompt through kernel 4 (one chunk), 32 greedy
    decode steps through kernel 3 on the 448-token text context; then, in
    float32 through the kernels, the prompt in chunks of 16 against the
    one-shot prefill."""
    cfg = get_config(WHISPER)
    g = torch.Generator(device=DEV)
    g.manual_seed(31)
    B = 4
    audio = torch.randn((B, WHISPER_FRAMES, cfg.d_model), device=DEV,
                        generator=g)
    prompt = torch.randint(1, cfg.vocab_size, (B, 64), device=DEV,
                           generator=g)
    fields, params32 = check_model_modal(
        "model_whisper", cfg, prompt, {"audio_embeds": audio}, 64, 32,
        WHISPER_S, WHISPER_FRAMES)
    with torch.no_grad():
        outs = []
        n0 = launch_counts(DENSE_KERNELS)
        for chunk in (64, 16):
            cache = tf.init_cache(cfg, B, WHISPER_S, dtype=torch.float32,
                                  device=DEV, cross_len=WHISPER_FRAMES)
            lg, _ = tf.full_prefill(params32, cfg, prompt, cache, chunk,
                                    audio_embeds=audio)
            outs.append(lg.float())
        n1 = launch_counts(DENSE_KERNELS)
    chunked = scaled_err_lists([outs[1]], [outs[0]])
    n_dec = cfg.num_layers
    assert n1["chunked_prefill_attention"] - \
        n0["chunked_prefill_attention"] == (1 + 64 // 16) * n_dec
    emit("model_whisper", **fields, full_prefill_chunk16_vs_one_shot=chunked,
         full_prefill_tol=MODEL_TOL_F32)
    assert chunked <= MODEL_TOL_F32, chunked
    del params32
    gc.collect()
    torch.cuda.empty_cache()


def phase_model_llava():
    """llava-next-34b at full width (d_model 7168, 56 / 8 heads of 128,
    d_ff 20480, vision_dim 1152) cut to LLAVA_LAYERS layers, bf16, batch
    2: ``full_prefill`` of 2880 image embeddings from a seed and 1024
    text tokens at chunk 512 (the first chunk 3392 tokens through kernel 4
    at a group of 7, the second at prefix 3392), then 16 decode steps
    through kernel 3."""
    cfg = dataclasses.replace(get_config(LLAVA), num_layers=LLAVA_LAYERS)
    g = torch.Generator(device=DEV)
    g.manual_seed(32)
    B = 2
    image = torch.randn((B, cfg.num_image_tokens, cfg.vision_dim),
                        device=DEV, generator=g)
    prompt = torch.randint(1, cfg.vocab_size, (B, 1024), device=DEV,
                           generator=g)
    fields, params32 = check_model_modal(
        "model_llava", cfg, prompt, {"image_embeds": image}, 512, 16,
        LLAVA_S)
    del params32
    emit("model_llava", **fields,
         weight_bytes_bf16=2 * fields["parameters"])
    gc.collect()
    torch.cuda.empty_cache()


def _cuda_ms(fn):
    """(result, device milliseconds) of ``fn()`` between two CUDA events."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def phase_train():
    """qwen2.5-3b at full width and depth, bf16 parameters, ``cfg.remat``
    on: 10 steps of ``train_loop``'s step (AdamW, ``total_steps`` 10,
    ``warmup_steps`` 1, as ``train_loop`` sets them) at batch 8 by 512 on
    ``synthetic_lm_batches``.  Held: every loss and gradient norm finite,
    the last loss below the first, no kernel launched (training runs
    without a cache).  Reported: ms a step (first, steady), tokens/s, peak
    device memory, the optimizer's share of a step, and the step's
    model FLOPs over its time as a share of the bf16 peak."""
    cfg = get_config(MODEL)
    assert cfg.remat
    B, T, steps = 8, 512, 10
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(0, cfg, device=DEV)
    n_params = count_params(params)
    opt_cfg = AdamWConfig(total_steps=steps, warmup_steps=max(steps // 20, 1))
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg)
    data = synthetic_lm_batches(cfg, B, T, seed=0, device=DEV)
    batches = [next(data) for _ in range(steps)]
    reset_counts(tuple(KERNELS))
    losses, norms, ms = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        _, _, m = step_fn(params, opt_state, b)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        ms.append(1e3 * (time.perf_counter() - t0))
    launched = launch_counts(tuple(KERNELS))
    peak = torch.cuda.max_memory_allocated()
    # the optimizer alone, on the last batch's gradients (a few more
    # updates of parameters nobody reads after)
    _, grads = loss_and_grads(params, cfg, batches[-1])
    opt_ms = [_cuda_ms(lambda: adamw_update(opt_cfg, params, grads,
                                            opt_state))[1]
              for _ in range(3)]
    del grads
    steady = sum(ms[2:]) / len(ms[2:])
    tokens = B * T
    L, hq, d = cfg.num_layers, cfg.num_heads, cfg.head_dim
    attn_fwd = 4.0 * B * T * T * hq * d * L    # QK^T and PV, full squares
    layer_params = n_params - 2 * cfg.vocab_size * cfg.d_model
    flops = (6.0 * n_params * tokens + 3 * attn_fwd
             + 2.0 * layer_params * tokens + attn_fwd)
    fields = dict(
        model=cfg.name, layers=cfg.num_layers, parameters=n_params,
        remat=cfg.remat, batch=B, seq=T, steps=steps, losses=losses,
        grad_norms=norms, step_ms=ms, first_step_ms=ms[0],
        steady_step_ms=steady, tokens_per_s=1e3 * tokens / steady,
        peak_device_bytes=peak, optimizer_ms=sum(opt_ms) / len(opt_ms),
        optimizer_share=sum(opt_ms) / len(opt_ms) / steady,
        kernel_launches=launched, model_flops_a_step=flops,
        model_flops_share_of_bf16_peak=flops / (steady * 1e-3)
        / PEAK_FLOPS[torch.bfloat16])
    emit("train", **fields)
    assert all(np.isfinite(losses)) and all(np.isfinite(norms))
    assert losses[-1] < losses[0], losses
    assert not any(launched.values()), launched
    del params, opt_state, batches
    gc.collect()
    torch.cuda.empty_cache()


#: train_ssm: zamba2-7b at full width cut to one period of its layer
#: pattern (5 MAMBA2 + 1 ZAMBA_ATTN of its 81 layers): its 19 B parameters
#: would need ~420 GB at 22 bytes each
ZAMBA_TRAIN_LAYERS = 6


def train_ssm_run(cfg, B, T, steps):
    """``steps`` AdamW steps of ``make_train_step`` (``total_steps`` =
    steps, ``warmup_steps`` 1) at batch B by T on ``synthetic_lm_batches``
    with ``cfg.remat`` on, the launch counts set to 0 just before and read
    just after; kernel 5b timed by the CUDA events its wrapper records
    just around each launch (``ssd_scan_bwd.events``).
    Held: every loss and gradient norm finite, the last loss below the
    first, no attention kernel launched, and each scan layer's
    (``scan_layers``) scan run twice forward (the step's forward and its
    recompute under ``torch.utils.checkpoint``) and once backward a
    step."""
    assert cfg.remat
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(0, cfg, device=DEV)
    n_params = count_params(params)
    n_scan = scan_layers(cfg)
    opt_cfg = AdamWConfig(total_steps=steps, warmup_steps=1)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg)
    data = synthetic_lm_batches(cfg, B, T, seed=0, device=DEV)
    batches = [next(data) for _ in range(steps)]
    names = DENSE_KERNELS + PAGED_KERNELS + ("ssd_scan_bwd",)
    losses, norms, ms, bwd_events = [], [], [], []
    reset_counts(names)
    for b in batches:
        bwd_events.append([])
        ssd_ops.ssd_scan_bwd.events = bwd_events[-1]
        t0 = time.perf_counter()
        _, _, m = step_fn(params, opt_state, b)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        ms.append(1e3 * (time.perf_counter() - t0))
    launched = launch_counts(names)
    ssd_ops.ssd_scan_bwd.events = None
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    bwd_ms = [sum(a.elapsed_time(b) for a, b in ev) for ev in bwd_events]
    steady = ms[2:] if steps > 3 else ms[1:]
    steady_ms = sum(steady) / len(steady)
    fields = dict(
        model=cfg.name, layers=cfg.num_layers, scan_layers=n_scan,
        parameters=n_params, remat=cfg.remat, dtype=cfg.dtype, batch=B,
        seq=T, steps=steps, losses=losses, grad_norms=norms, step_ms=ms,
        first_step_ms=ms[0], steady_step_ms=steady_ms,
        tokens_per_s=1e3 * B * T / steady_ms, peak_device_bytes=peak,
        kernel_launches=launched,
        expected_scan_launches={"ssd_scan": 2 * n_scan * steps,
                                "ssd_scan_bwd": n_scan * steps},
        ssd_scan_bwd_ms_a_step=bwd_ms,
        ssd_scan_bwd_share_of_steady_step=(
            sum(bwd_ms[len(ms) - len(steady):]) / sum(steady)))
    del params, opt_state, batches
    gc.collect()
    torch.cuda.empty_cache()
    return fields


def phase_train_ssm():
    """mamba2-1.3b at full width and depth (48 MAMBA2 layers), bf16,
    remat: 10 steps at batch 8 by 512; then zamba2-7b at full width cut to
    one period (``ZAMBA_TRAIN_LAYERS``: 6 scans a forward, the ZAMBA_ATTN
    layer's mixer included), 3 steps at the same batch; both
    held as ``train_ssm_run`` says.  Returns the launches of both runs
    (kernel -> sum), the path's counts."""
    runs = {}
    for name, cfg, steps in (
            (MAMBA, get_config(MAMBA), 10),
            (ZAMBA, dataclasses.replace(get_config(ZAMBA),
                                        num_layers=ZAMBA_TRAIN_LAYERS), 3)):
        runs[name] = train_ssm_run(cfg, 8, 512, steps)
    runs[ZAMBA]["cut"] = (f"num_layers {ZAMBA_TRAIN_LAYERS} of 81: one "
                          "period, 5 MAMBA2 + 1 ZAMBA_ATTN")
    emit("train_ssm", runs=runs)
    for name, r in runs.items():
        assert all(np.isfinite(r["losses"])) \
            and all(np.isfinite(r["grad_norms"])), (name, r["losses"])
        assert r["losses"][-1] < r["losses"][0], (name, r["losses"])
        got = r["kernel_launches"]
        for k, want in r["expected_scan_launches"].items():
            assert got[k] == want, (name, k, got[k], want)
        assert all(got[k] == 0 for k in got
                   if k not in r["expected_scan_launches"]), (name, got)
    return {k: sum(r["kernel_launches"][k] for r in runs.values())
            for k in ("ssd_scan", "ssd_scan_bwd")}


def _grad_gaps(gpu, cpu):
    """Per leaf max |g_gpu - g_cpu| over max |g_cpu|, and whether every
    leaf keeps max |g_gpu - g_cpu| <= TRAIN_GRAD_RTOL max |g_cpu| + 1e-6."""
    worst, ok = 0.0, True
    for a, b in zip(tree_leaves(gpu), tree_leaves(cpu)):
        gap = (a.float().cpu() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        ok = ok and gap <= TRAIN_GRAD_RTOL * scale + 1e-6
        worst = max(worst, gap / max(scale, 1e-30))
    return worst, ok


def _to_device(tree, dev):
    return tree_map(lambda t: t.detach().to(dev), tree)


def phase_train_grad():
    """The gradient's oracle: ``train_loss`` and its gradients on the card
    against the same code on the CPU (labelled: the one CPU computation of
    this script), float32, for qwen2.5-3b at full width cut to 2 layers
    and whisper-base in full (1500 audio frames) at batch 2 by 128, and
    mamba2-1.3b cut to 2 layers and zamba2-7b cut to one period
    (``ZAMBA_TRAIN_LAYERS``) at batch 2 by 256 (four scan tiles: the card
    runs kernels 5 and 5b, the CPU their plain versions).  Then one
    whisper-base train step at full size in bf16 (batch 4 by 448, audio)
    and a checkpoint round trip (save, load, one more step from each:
    losses bit-equal)."""
    out = {}
    for name, cfg, seq in (
            ("qwen2.5-3b", dataclasses.replace(get_config(MODEL),
                                               num_layers=2, dtype="float32"),
             128),
            (WHISPER, dataclasses.replace(get_config(WHISPER),
                                          dtype="float32"), 128),
            (MAMBA, dataclasses.replace(get_config(MAMBA), num_layers=2,
                                        dtype="float32"), 256),
            (ZAMBA, dataclasses.replace(get_config(ZAMBA),
                                        num_layers=ZAMBA_TRAIN_LAYERS,
                                        dtype="float32"), 256)):
        params_cpu = tf.init_params(0, cfg, device="cpu")
        batch = next(synthetic_lm_batches(cfg, 2, seq, seed=1, device="cpu"))
        if cfg.family == "audio":
            gen = torch.Generator().manual_seed(33)
            batch["audio_embeds"] = torch.randn(
                (2, WHISPER_FRAMES, cfg.d_model), generator=gen)
        params_gpu = _to_device(params_cpu, DEV)
        reset_counts(("ssd_scan", "ssd_scan_bwd"))
        loss_gpu, g_gpu = loss_and_grads(params_gpu, cfg,
                                         _to_device(batch, DEV))
        scans = launch_counts(("ssd_scan", "ssd_scan_bwd"))
        t0 = time.perf_counter()
        loss_cpu, g_cpu = loss_and_grads(params_cpu, cfg, batch)
        cpu_s = time.perf_counter() - t0
        worst, ok = _grad_gaps(g_gpu, g_cpu)
        n_scan = scan_layers(cfg)
        assert scans == {"ssd_scan": 2 * n_scan,
                         "ssd_scan_bwd": n_scan}, (name, scans)
        out[name] = {"layers": cfg.num_layers, "batch": 2, "seq": seq,
                     "scan_launches": scans, "loss_gpu": loss_gpu.item(),
                     "loss_cpu_oracle": loss_cpu.item(),
                     "grad_leaves": len(tree_leaves(g_cpu)),
                     "worst_leaf_gap_over_max": worst, "held": ok,
                     "cpu_oracle_seconds": cpu_s}
        del params_cpu, params_gpu, g_gpu, g_cpu
        gc.collect()
        torch.cuda.empty_cache()
    # whisper-base at full size in bf16: a step, then a checkpoint round
    # trip
    cfg = get_config(WHISPER)
    params = tf.init_params(0, cfg, device=DEV)
    batch = next(synthetic_lm_batches(cfg, 4, 448, seed=2, device=DEV))
    g = torch.Generator(device=DEV)
    g.manual_seed(34)
    batch["audio_embeds"] = torch.randn((4, WHISPER_FRAMES, cfg.d_model),
                                        device=DEV, generator=g)
    opt_cfg = AdamWConfig(total_steps=10, warmup_steps=1)
    step_fn = make_train_step(cfg, opt_cfg)
    opt_state = init_opt_state(params)
    (_, _, m0), step_ms = _cuda_ms(lambda: step_fn(params, opt_state, batch))
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_ckpt", "whisper.npz")
    save_checkpoint(path, params, opt_state, meta={"arch": cfg.name},
                    cfg=cfg)
    template = tf.init_params(1, cfg, device=DEV)
    p2, s2 = load_checkpoint(path, template, init_opt_state(template))
    params_equal = all(torch.equal(a.detach(), b)
                       for a, b in zip(tree_leaves(params), tree_leaves(p2)))
    _, _, m1 = step_fn(params, opt_state, batch)
    _, _, m2 = step_fn(p2, s2, batch)
    ckpt = {"params_bit_equal": params_equal,
            "loss_saved": m1["loss"].item(), "loss_loaded": m2["loss"].item()}
    emit("train_grad", oracle="cpu", tol_rtol=TRAIN_GRAD_RTOL, tol_atol=1e-6,
         models=out, whisper_step={"batch": 4, "seq": 448,
                                   "audio_frames": WHISPER_FRAMES,
                                   "loss": m0["loss"].item(),
                                   "grad_norm": m0["grad_norm"].item(),
                                   "ms": step_ms},
         checkpoint=ckpt)
    assert all(v["held"] for v in out.values()), out
    assert np.isfinite(m0["loss"].item()) and \
        np.isfinite(m0["grad_norm"].item())
    assert params_equal and ckpt["loss_saved"] == ckpt["loss_loaded"], ckpt
    del params, p2, template, opt_state, s2
    gc.collect()
    torch.cuda.empty_cache()


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
        dict(shape=ZAMBA, dtype="bfloat16", form="serving")),
    "chunked_prefill_attention": (
        "src/repro_torch/kernels/csrc/chunked_prefill.cu",
        "src/repro/kernels/chunked_prefill_attention/chunked_attn.py:89",
        dict(shape=ZAMBA, dtype="bfloat16", Tq=1024, form="serving")),
    "ssd_scan": (
        "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/ssd_kernel.py:85",
        dict(shape=ZAMBA, L=256, dtype="float32")),
    "ssd_scan_bwd": (
        "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "none: no pl.pallas_call (the reference takes jax.grad of "
        "ssd_chunked, src/repro/models/mamba2.py:48)",
        dict(shape=MAMBA, b=8, t=512, dtype="bfloat16")),
}


# ---------------------------------------------------------------------------
# the sharded path: one rank, and the dry-run of the production meshes
# ---------------------------------------------------------------------------

#: tp_local: rows, prompt tokens, greedy decode steps; gemma3-1b's
#: prompt, longer than its 1024-token window
TP_ROWS, TP_PROMPT, TP_STEPS = 2, 512, 16
TP_PROMPT_GEMMA = 1536


def _tp_run(cfg, params, cache, prompt, mesh=None):
    """A prefill of the prompt and TP_STEPS greedy decode steps; returns
    (tokens [B, 1 + steps], logits [1 + steps, B, V] float32, the decode
    steps' ms between CUDA events around each call, the host's enqueueing
    included).  With ``mesh`` (sharded): every call under hints and
    implicit replication, the logits gathered whole (one rank: no
    transfer)."""
    B, n_prompt = prompt.shape
    whole = (lambda t: t.full_tensor()) if mesh is not None else \
        (lambda t: t)
    toks, logits, step_ms = [], [], []
    with torch.no_grad(), (_sharded(mesh) if mesh is not None
                           else contextlib.nullcontext()):
        last, cache = tf.prefill(params, cfg, prompt, cache,
                                 torch.zeros(B, dtype=torch.long, device=DEV))
        last = whole(last)
        for i in range(TP_STEPS + 1):
            nxt = last.argmax(-1)
            toks.append(nxt)
            logits.append(last.float())
            if i == TP_STEPS:
                break
            a, b = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            a.record()
            last, cache = tf.decode_step(
                params, cfg, nxt[:, None], cache,
                torch.full((B,), n_prompt + i, dtype=torch.long,
                           device=DEV))
            last = whole(last)
            b.record()
            torch.cuda.synchronize()
            step_ms.append(a.elapsed_time(b))
    return torch.stack(toks, 1), torch.stack(logits), step_ms


@contextlib.contextmanager
def _sharded(mesh):
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import hints
    with implicit_replication(), hints.hints(("data",), "model", mesh=mesh):
        yield


def _tp_family(mesh, cfg, prompt, S, paths):
    """One family's sharded runs on the one-rank ``mesh``: the plain run
    on plain tensors, then, for each (path, kv_mode) of ``paths``, the
    same calls on DTensor parameters and a cache sharded by
    ``cache_specs(kv_mode)``: tokens equal (held), logits bit-equal or
    within phase_model's bf16 rule (held), kernels 3 and 4 launched
    (held).  Returns ({kv_mode: record}, the plain run, {path:
    launches})."""
    from repro_torch.distributed import sharding as shd
    params = tf.init_params(0, cfg, device=DEV)
    plain = _tp_run(cfg, params, tf.init_cache(cfg, TP_ROWS, S, device=DEV),
                    prompt)
    dparams = shd.shard(mesh, shd.param_specs(cfg, 1), params)
    rows = lambda t: shd.shard(mesh, shd.P(("data",)), t)
    ref = []

    def bf16_rule(sharded):
        # phase_model's bf16 rule: no further from the float32 plain
        # result than the bf16 plain run is (x 1.5 + slack)
        if not ref:
            ref.append(_tp_run(cfg, _float_tree(params), tf.init_cache(
                cfg, TP_ROWS, S, dtype=torch.float32, device=DEV), prompt))
        err = lambda a: max(
            ((a[1][i] - ref[0][1][i]).abs().max()
             / ref[0][1][i].abs().max().clamp_min(1.0)).item()
            for i in range(TP_STEPS + 1))
        rule = {"sharded_vs_f32": err(sharded), "plain_vs_f32": err(plain)}
        assert rule["sharded_vs_f32"] <= 1.5 * rule["plain_vs_f32"] \
            + MODEL_TOL_BF16_SLACK, rule
        return rule

    runs, by_path = {}, {}
    for path, kv_mode in paths:
        dcache = shd.shard(mesh, shd.cache_specs(cfg, mesh, TP_ROWS, S,
                                                 kv_mode=kv_mode),
                           tf.init_cache(cfg, TP_ROWS, S, device=DEV))
        reset_counts(DENSE_KERNELS)
        sharded = _tp_run(cfg, dparams, dcache, rows(prompt), mesh)
        launches = launch_counts(("decode_attention",
                                  "chunked_prefill_attention"))
        assert all(n > 0 for n in launches.values()), (path, launches)
        bit_equal = torch.equal(plain[1], sharded[1])
        runs[kv_mode] = dict(
            cache_placements={n: str(dcache[n].placements)
                              for n in sorted(dcache)},
            tokens_equal=torch.equal(plain[0], sharded[0]),
            logits_bit_equal=bit_equal,
            logits_max_abs_diff=(plain[1] - sharded[1]).abs().max().item(),
            bf16_rule=None if bit_equal else bf16_rule(sharded),
            launches=launches,
            decode_step_ms_sharded=sum(sharded[2]) / TP_STEPS,
            decode_step_ms_sharded_all=sharded[2])
        assert runs[kv_mode]["tokens_equal"], (path, plain[0], sharded[0])
        by_path[path] = launches
        del dcache
    del params, dparams
    return runs, plain, by_path


def phase_tp_local():
    """The sharded path on the card: an NCCL group of world 1, the
    (1, 1) local mesh, qwen2.5-3b's full-width parameters sharded by
    ``param_specs`` and a dense cache for TP_ROWS rows by ``cache_specs``
    (DTensors), a prefill and greedy decode steps under hints, against
    the same calls on plain tensors.  The cache writes and kernels 3 and 4
    run on local shards (``local_map``); the sharded run must launch both.
    A second sharded run takes ``kv_mode="seq"``: the cache split along
    its slot axis, read where it lies (kernels 3 and 4's log-sum-exp form
    on the rank's slots, the partials combined by all-reduce over the
    one-rank group).  A third, ``tp_local_gemma3_seq``, takes gemma3-1b
    at full width under ``seq``, with a prompt longer than its window:
    its ring caches, split along their slots too, are read where they lie
    by the masked partial softmax (the ring wraps, and the prefill writes
    only its last window of keys), its global layers by kernels 3 and 4's
    log-sum-exp forms.  Returns the runs' launches by path."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda:0"))
    try:
        mesh = make_local_mesh(model=1)
        rng = np.random.default_rng(31)
        cfg = get_config(MODEL)
        prompt = torch.from_numpy(rng.integers(
            1, cfg.vocab_size, size=(TP_ROWS, TP_PROMPT))).to(DEV)
        runs, plain, by_path = _tp_family(
            mesh, cfg, prompt, TP_PROMPT + TP_STEPS,
            (("tp_local", "auto"), ("tp_local_seq", "seq")))
        auto = runs.pop("auto")
        emit("tp_local", model=cfg.name, mesh=list(mesh.shape),
             backend=dist.get_backend(), rows=TP_ROWS, prompt=TP_PROMPT,
             decode_steps=TP_STEPS, **auto,
             decode_step_ms_plain=sum(plain[2]) / TP_STEPS,
             decode_step_ms_plain_all=plain[2], seq=runs["seq"])
        gc.collect()
        torch.cuda.empty_cache()

        gcfg = get_config(GEMMA)
        assert TP_PROMPT_GEMMA > gcfg.sliding_window
        prompt = torch.from_numpy(rng.integers(
            1, gcfg.vocab_size, size=(TP_ROWS, TP_PROMPT_GEMMA))).to(DEV)
        runs, plain, gpaths = _tp_family(
            mesh, gcfg, prompt, TP_PROMPT_GEMMA + TP_STEPS,
            (("tp_local_gemma3_seq", "seq"),))
        by_path.update(gpaths)
        emit("tp_local_gemma3_seq", model=gcfg.name, layers=gcfg.num_layers,
             window=gcfg.sliding_window, mesh=list(mesh.shape),
             backend=dist.get_backend(), rows=TP_ROWS,
             prompt=TP_PROMPT_GEMMA, decode_steps=TP_STEPS, **runs["seq"],
             decode_step_ms_plain=sum(plain[2]) / TP_STEPS,
             decode_step_ms_plain_all=plain[2])
        return by_path
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()


#: the dry-run's cases here (ARCH:SHAPE:single|multi); the --all run
#: traces every applicable case on both meshes
DRYRUN_CASES = ("qwen3-14b:prefill_32k:single", "qwen2.5-3b:decode_32k:single",
                "mamba2-1.3b:long_500k:single", "arctic-480b:train_4k:single",
                "qwen3-14b:train_4k:multi")


def phase_dryrun():
    """``python -m repro_torch.launch.dryrun`` on the production meshes, in
    a process of its own (its fake process group of 256 / 512 ranks and
    NCCL's cannot share one), on the host: one line a case with its peak
    bytes a rank, the three roofline terms (H100 constants), the dominant
    one, the collectives and the trace's seconds.  Any failed case fails
    the phase."""
    out_dir = Path(__file__).resolve().parent / "chiprun_out" / "dryrun_torch"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--runs-dir", str(out_dir)]
    for c in DRYRUN_CASES:
        cmd += ["--case", c]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=900)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
        raise RuntimeError(f"dryrun exited {r.returncode}")
    for c in DRYRUN_CASES:
        arch, shape, mesh = c.split(":")
        name = "2x16x16" if mesh == "multi" else "16x16"
        with open(out_dir / f"{arch}__{shape}__{name}.json") as f:
            rec = json.load(f)
        roof = rec["roofline"]
        emit("dryrun", arch=arch, shape=shape, mesh=name,
             note=rec["note"], hints=rec["hints"],
             peak_gb_per_rank=rec["peak_bytes_per_device"] / 1e9,
             arg_gb_per_rank=rec["arg_bytes"] / 1e9,
             compute_s=roof["compute_s"], memory_s=roof["memory_s"],
             collective_s=roof["collective_s"], dominant=roof["dominant"],
             collective_link=roof["collective_link"],
             collectives=rec["collectives"],
             collective_gb_by_op={k: v / 1e9 for k, v in
                                  rec["collective_bytes_by_op"].items()},
             flops_per_rank=rec["flops_per_device"],
             useful_flops_ratio=roof["useful_flops_ratio"],
             fits_hbm=roof["fits_hbm"], trace_s=rec["trace_s"],
             torch=rec["torch"])
    emit("dryrun_total", cases=len(DRYRUN_CASES), seconds=wall,
         constants="H100 published (core/hw.py), host trace, not card time")


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
    scan over that run's served prefills."""
    build.load_library()
    emit("ptxas_scan", kernels=ptxas_scan())
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
    if argv[:1] == ["--serve"]:
        return serve_only(argv[1:])
    if argv[:1] == ["--tp-local"]:
        build.load_library()
        phase_tp_local()
        phase_dryrun()
        return 0
    if argv[:1] == ["--train-ssm"]:
        build.load_library()
        phase_train_ssm()
        return 0
    if argv[:1] == ["--ptxas"]:
        if len(argv) == 1:
            build.load_library()
        emit("ptxas_scan", log=argv[1] if len(argv) > 1 else "this build",
             kernels=ptxas_scan(*argv[1:2]))
        emit("ptxas_attention",
             log=argv[1] if len(argv) > 1 else "this build",
             kernels=ptxas_attention(*argv[1:2]))
        return 0
    if argv[:1] == ["--ptxas-compare"]:
        build.load_library()
        emit("ptxas_compare", log=argv[1], **ptxas_compare(argv[1]))
        return 0

    t0 = time.perf_counter()
    build.load_library()
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=build.last_build_seconds,
         sources=[p.name for p in build.sources()], d256=ptxas_d256(),
         ssd=ptxas_scan())

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

    mcfg = get_config(MAMBA)
    t0 = time.perf_counter()
    mparams = tf.init_params(0, mcfg, device=DEV)
    torch.cuda.synchronize()
    emit("params_mamba2", model=mcfg.name, layers=mcfg.num_layers,
         parameters=count_params(mparams),
         device_bytes=torch.cuda.memory_allocated(),
         seconds=time.perf_counter() - t0)
    by_path["serve_mamba2"] = phase_serve_mamba2(mcfg, mparams)
    del mparams
    gc.collect()
    torch.cuda.empty_cache()

    for phase, fn in (("model_whisper", phase_model_whisper),
                      ("model_llava", phase_model_llava)):
        reset_counts(DENSE_KERNELS)
        fn()
        by_path[phase] = launch_counts(("decode_attention",
                                        "chunked_prefill_attention"))
    by_path["serve_whisper"] = phase_serve_whisper()
    phase_examples()
    phase_train()
    by_path["train_ssm"] = phase_train_ssm()
    phase_train_grad()
    by_path.update(phase_tp_local())
    phase_dryrun()
    # last, with nothing else on the card: llava-next-34b's weights fill
    # most of it
    by_path["serve_llava"] = phase_serve_llava()

    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels_line(cases, by_path)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
