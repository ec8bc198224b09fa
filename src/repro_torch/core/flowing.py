"""Flowing decode scheduling — Algorithm 1 of the paper (§3.3).

Per inference iteration, each instance's scheduler selects:

  * P-heavy: the *optimizing set* O — decode requests whose current TPOT
    (since their last reset) exceeds alpha * tpot_slo; they flow BACK to a
    D-heavy instance before they violate the SLO (step ③).
  * D-heavy: the *degrading set* D — while HBM usage exceeds the
    watermark M, repeatedly pick the request with the current LONGEST
    output (it has banked the most low-interference iterations, hence the
    largest remaining TPOT budget; short-output requests — unknowable a
    priori — are never picked because they haven't grown long) (step ②).

Migration itself (KV/state transfer + re-admission) is orchestrated by
the cluster; this module is the pure selection logic so it can be
unit/property tested against the paper's pseudocode.
"""
from __future__ import annotations

from typing import List

from repro_torch.core.instance import D_HEAVY, Instance, P_HEAVY
from repro_torch.engine.request import Request


def select_backflow(inst: Instance, tpot_slo: float, alpha: float,
                    now: float) -> List[Request]:
    """Algorithm 1, lines 1-3 (P-heavy): requests approaching TPOT SLO."""
    assert inst.itype == P_HEAVY
    out = []
    for r in inst.decoding.values():
        cur = r.current_tpot(now)
        if cur is not None and cur > tpot_slo * alpha:
            out.append(r)
    return out


def select_degrade(inst: Instance, watermark: float) -> List[Request]:
    """Algorithm 1, lines 4-12 (D-heavy): longest-first until usage <= M.

    Memory-to-release loop over the allocator's actual block ownership."""
    assert inst.itype == D_HEAVY
    total = inst.allocator.num_blocks
    used = inst.allocator.used_blocks
    threshold = watermark * total
    degrade: List[Request] = []
    chosen = set()
    while used > threshold:
        candidates = [r for r in inst.decoding.values()
                      if r.rid not in chosen]
        if not candidates:
            break
        r_star = max(candidates, key=lambda r: r.effective_output_len)
        chosen.add(r_star.rid)
        degrade.append(r_star)
        used -= inst.allocator.blocks_for(r_star.context_len)
    return degrade
