"""Target-hardware constants (NVIDIA H100 SXM) used by the estimator and
the scheduler's TTFT projections (Algorithm 2).

Peak rates, memory size and link rate are NVIDIA's published figures for
the H100 SXM (H100 data sheet and the Hopper architecture white paper:
dense bf16 tensor-core rate, HBM3 bandwidth, 80 GB, NVLink at 900 GB/s
per card, i.e. 450 GB/s each way).  The field names are the reference
dataclass's, so the estimator reads them unchanged: ``ici_*`` is the
link between the cards of one host (NVLink here) and ``dcn_bw`` the link
between hosts.

The three efficiency derates are MEASURED, not published.  They come
from the iterations that ``chip_smoke.py`` (phase ``serve``, function
``derive_derates``) timed for qwen2.5-3b at full width through the port's
own kernels on an NVIDIA H100 80GB HBM3 at a 700 W power limit:

* ``iteration_overhead_s``: the mean time the host needs to enqueue a
  decode-only iteration: 45.6, 45.6, 54.6 and 55.4 ms in four runs of
  127-160 such iterations each (the host is shared and varies), 50 ms
  here.  The eager per-layer loop issues the 36 layers' launches one by
  one and no batch hides that;
* ``decode_membw_eff``: model bytes over what the mean decode-only
  iteration (50.0-57.3 ms at 9-11 rows) leaves after that overhead,
  floored at a quarter of the iteration: 0.169, 0.172, 0.152, 0.150;
* ``prefill_mfu``: model FLOPs over what the mean prefill-only iteration
  (48.4-60.3 ms at about 640 tokens) leaves after the overhead, with the
  same floor: 0.34, 0.28, 0.29, 0.30.

``PERF.md`` records the runs.  These numbers describe the port as it is
(simple kernels, a host-bound loop), not what the card can do.
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
    prefill_mfu: float = 0.30           # share of peak_flops in prefill
    decode_membw_eff: float = 0.16      # share of hbm_bw in decode
    iteration_overhead_s: float = 50e-3  # host enqueue time an iteration


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
