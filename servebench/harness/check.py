"""The comparison that decides ``correct``.

Once the window and the drain are over and the program's state is freed,
a sample of the requests the program finished is drawn from the seed:
the one with the most served tokens, one that flowing decode moved
between the instances, one prefilled on each instance role (chunks of
both sizes), then others at random until the sample holds the mix's
``check.served_tokens`` served tokens (never more than
``check.max_tokens`` tokens of sequence in all).  The plain float32
reference (``reference/model.py``) runs once over each prompt with its
served tokens, and the number compared is the widest gap by which a
served token's logit lies below the reference's best logit at its
position.  Greedy decoding serves the argmax of the program's own
logits, so a sound program's gaps are its rounding; a wrong token, a
dropped KV write or a lost migration shows as a gap of the logits' own
scale.

The control (``control_gap``) puts the reference in the program's place
at the next precision down (float8 e4m3 products): at each position of
the same prompts and tokens, the gap of the token it puts first.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from harness.traffic import rng_for
from reference import model as ref


def choose(finished: Sequence, seed: int, roles: Dict[int, str],
           served_tokens: int, max_tokens: int) -> list:
    """The sample of finished requests the reference compares."""
    if not finished:
        return []
    rng = rng_for(seed, "sample")
    size = lambda r: r.prompt_len + len(r.output_tokens)
    picked: list = []

    def take(r):
        if any(p is r for p in picked):
            return
        if picked and sum(map(size, picked)) + size(r) > max_tokens:
            return
        picked.append(r)

    take(max(finished, key=lambda r: (len(r.output_tokens), -r.rid)))
    migrated = [r for r in finished if r.n_migrations > 0]
    if migrated:
        take(migrated[int(rng.integers(len(migrated)))])
    for role in sorted(set(roles.values())):
        mine = [r for r in finished
                if roles.get(r.prefill_instance) == role]
        if mine:
            take(mine[int(rng.integers(len(mine)))])
    rest = [finished[i] for i in rng.permutation(len(finished))]
    for r in rest:
        if sum(len(p.output_tokens) for p in picked) >= served_tokens:
            break
        take(r)
    return picked


def sequences(reqs, device) -> List[Tuple[torch.Tensor, int]]:
    """(prompt + served tokens but the last, index of the last prompt
    token) of each request: the positions whose logits chose the served
    tokens."""
    out = []
    for r in reqs:
        toks = list(r.prompt_tokens) + list(r.output_tokens[:-1])
        out.append((torch.tensor(toks, dtype=torch.int32, device=device),
                    r.prompt_len - 1))
    return out


def served(reqs, device) -> List[torch.Tensor]:
    return [torch.tensor(r.output_tokens, dtype=torch.long, device=device)
            for r in reqs]


def widest_gap(params, config, reqs, device) -> Tuple[float, int]:
    """(widest gap of a served token below the reference's best logit,
    tokens compared)."""
    if not reqs:
        return float("nan"), 0
    lg = ref.logits(params, config, sequences(reqs, device))
    worst, n = 0.0, 0
    for lo, tok in zip(lg, served(reqs, device)):
        gap = lo.max(-1).values - lo.gather(-1, tok[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        n += len(tok)
    return worst, n


def control_gap(params, config, reqs, device) -> Tuple[float, int]:
    """The control: the widest gap, in the float32 reference's logits, of
    the token the float8 reference puts first at each position of the
    same prompts and tokens."""
    seqs = sequences(reqs, device)
    lg = ref.logits(params, config, seqs)
    low = ref.logits(params, config, seqs, mm=ref.fp8_mm)
    worst, n = 0.0, 0
    for lo, lw in zip(lg, low):
        pick = lw.argmax(-1)
        gap = lo.max(-1).values - lo.gather(-1, pick[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        n += len(pick)
    return worst, n
