"""Target-hardware constants (NVIDIA H100 SXM) used by the estimator and
the scheduler's TTFT projections (Algorithm 2).

Peak rates, memory size and link rate are NVIDIA's published figures for
the H100 SXM (H100 data sheet and the Hopper architecture white paper:
dense bf16 tensor-core rate, HBM3 bandwidth, 80 GB, NVLink at 900 GB/s
per card, i.e. 450 GB/s each way).  The field names are the reference
dataclass's, so the estimator reads them unchanged: ``ici_*`` is the
link between the cards of one host (NVLink here) and ``dcn_bw`` the link
between hosts.

The three efficiency derates are MEASURED, not published.  They are the
median, rounded, of three runs of ``chip_smoke.py --serve 3`` (phase
``serve``, function ``derive_derates``): qwen2.5-3b at full width through
the port's own kernels, its decode-only iterations replayed from CUDA
graphs, on one "NVIDIA H100 80GB HBM3, 700.00 W" (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``).  Each run served
32 requests in 429 iterations: 320 decode-only (5.3 rows at 1,077 tokens
of context on average), 21 prefill-only (602 tokens), 88 mixed.

* ``iteration_overhead_s``: the mean time the host needs to enqueue a
  decode-only iteration: 4.45, 4.25 and 5.07 ms, 4 ms here.  A replay
  enqueues in about 0.5 ms; most of the mean is the ten first uses of a
  decode bucket (an eager run and a capture, 84-314 ms each);
* ``decode_membw_eff``: model bytes over what the mean decode-only
  iteration (11.57, 11.40, 12.19 ms) leaves after that overhead:
  0.294, 0.292, 0.293;
* ``prefill_mfu``: model FLOPs over what the mean prefill-only iteration
  (50.6, 45.7, 48.4 ms) leaves after the overhead: 0.084, 0.094,
  0.090.  Prefill runs eagerly, and its time is mostly the host's.

The runs had two instances (a P-heavy and a D-heavy one) sharing the one
card, so the values absorb that sharing as far as ``serve``'s mix does.
The eager mixed iteration (54-55 ms measured) is host-bound, and the
estimator models it at 23 ms: one overhead constant cannot fit both it
and the replayed decode.  ``PERF.md`` records the runs.  These numbers
describe the port as it is, not what the card can do.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str = "h100-sxm"
    peak_flops: float = 989e12          # bf16 FLOP/s per card, dense
    hbm_bw: float = 3.35e12             # bytes/s per card
    hbm_bytes: int = 80 * 10 ** 9       # 80 GB per card
    ici_bw: float = 450e9               # bytes/s each way over NVLink
    ici_links: int = 1                  # one aggregate NVLink port a card
    dcn_bw: float = 50e9                # bytes/s between hosts (one 400 Gb/s
                                        # NIC a card, DGX H100): the
                                        # dry-run's collective term on a
                                        # mesh beyond one host

    # achieved-efficiency derates, measured (see module docstring):
    prefill_mfu: float = 0.09           # share of peak_flops in prefill
    decode_membw_eff: float = 0.29      # share of hbm_bw in decode
    iteration_overhead_s: float = 4e-3  # host enqueue time an iteration


H100 = HardwareSpec()


@dataclasses.dataclass(frozen=True)
class InstanceSpec:
    """One serving instance = a TP group of ``tp`` cards."""
    hw: HardwareSpec = H100
    tp: int = 4

    @property
    def flops(self) -> float:
        return self.hw.peak_flops * self.tp

    @property
    def hbm_bw(self) -> float:
        return self.hw.hbm_bw * self.tp

    @property
    def hbm_bytes(self) -> int:
        return self.hw.hbm_bytes * self.tp

    @property
    def interconnect_bw(self) -> float:
        """Effective point-to-point bandwidth for KV migration between
        instances (NVLink within a host)."""
        return self.hw.ici_bw
