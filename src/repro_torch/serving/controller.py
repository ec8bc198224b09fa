"""Epoch-based adaptive slider control.

The paper's thesis is that one system spans the aggregation<->
disaggregation spectrum by moving three sliders — R_PD (P-heavy :
D-heavy instance ratio) and the chunk sizes S_P / S_D (§3.1) — but it
positions them via *offline* search.  This controller moves them
*online*: every ``epoch`` virtual seconds it reads the telemetry
window's TTFT/TPOT attainment and walks the configuration toward
whichever dimension is starved:

* **TTFT starved** (prefill capacity short): raise S_D — D-heavy
  instances take bigger prefill chunks (aggregation-ward).  When S_D is
  maxed, flip the least decode-loaded D-heavy instance to P-heavy
  (drain-and-flip via the cluster's migration machinery).
* **TPOT starved** (decode interference high): lower S_D
  (disaggregation-ward).  When S_D is floored, flip a P-heavy instance
  to D-heavy.

Moves are damped by a deadband around the attainment target, a cooldown
of ``cooldown`` epochs after every move, and min-instance floors per
role; both attainment signals starving simultaneously means the cluster
is saturated — reconfiguration cannot help, so the controller holds
(admission control, not slider motion, is the right tool there).

The controller is deliberately model-free: it reads only *attained*
service quality, so it works unchanged on the simulator and the real
engine, and under workloads the offline search never saw.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core.instance import D_HEAVY, P_HEAVY


@dataclasses.dataclass
class ControllerConfig:
    epoch: float = 5.0          # seconds between control decisions
    target: float = 0.9         # per-dimension attainment target
    deadband: float = 0.03      # hysteresis below target before acting
    cooldown: int = 1           # full epochs to hold after a move
    # the S_D ladder; S_P stays at its configured value — the paper
    # moves S_D for interference control, S_P mainly scales with prompt
    # length, which routing already handles.  The floor is 64, not 0: a
    # pure-decode instance strands whatever prefill work is already
    # queued on it, and a minimal chunk keeps the corner reachable
    # without that cliff (S_D=0 remains expressible as a static config).
    sd_steps: Tuple[int, ...] = (64, 128, 256, 512, 1024)
    min_p: int = 1              # role-count floors for R_PD flips
    min_d: int = 1
    min_evidence: int = 4       # windowed events needed before acting
    # raising S_D is only safe while decode has real headroom: require
    # windowed p90 TPOT below this fraction of the SLO, else go straight
    # to a D->P flip (bigger chunks would trade one violation for
    # another)
    tpot_guard: float = 0.85
    # a chunk move that breaks the other dimension is reverted and its
    # direction embargoed for this many epochs (local search with tabu —
    # prevents oscillation when neither chunk direction can win)
    tabu_epochs: int = 4
    # ---- admission control as an actuator --------------------------
    # when BOTH attainment signals starve, sliders cannot conjure
    # capacity — shed from the router-side admission queue instead
    # (lowest priority classes first; no-op when the loop runs without
    # an admission queue).  Queue pressure also feeds the TTFT signal:
    # a queue whose oldest entry has burned ``queue_guard`` of the TTFT
    # SLO counts as prefill starvation even before first tokens lag.
    shed: bool = True
    shed_fraction: float = 0.5       # share of queued entries per shed
    queue_guard: float = 0.5         # oldest-wait fraction of TTFT SLO
    # ---- hot-prefix replication (off by default) -------------------
    # every epoch, copy each instance's hottest matchable prefixes to
    # the instance with the fewest local hits for them — cache-aware
    # routing then spreads that traffic instead of pinning it
    replicate: bool = False
    replicate_max_paths: int = 2     # hot paths exported per source
    replicate_min_hits: int = 3      # touch count before a path is hot
    replicate_max_blocks: int = 64   # per-epoch block budget per source
    # ---- decision audit trail --------------------------------------
    # one record per epoch: the input signals, every action taken (or
    # the reason for holding), guard/tabu outcomes, and — filled in at
    # the NEXT epoch — the observed effect.  Lightweight (a few dict
    # appends per epoch), so on by default.
    audit: bool = True
    audit_max_epochs: int = 4096


class SliderController:
    def __init__(self, cfg: Optional[ControllerConfig] = None):
        self.cfg = cfg or ControllerConfig()
        self.loop = None
        self.moves: List[dict] = []      # chunk retunes + role flips
        self.replications = 0            # hot-prefix transfers started
        self._next_epoch: Optional[float] = None
        self._hold_until = 0.0
        self._pending_eval: Optional[dict] = None   # last chunk move
        self._tabu: dict = {}            # direction -> embargo-until time
        # decision audit trail: one record per epoch (see
        # ControllerConfig.audit); the current epoch's record while
        # ``on_epoch`` runs, so helpers can annotate it
        self.audit: List[dict] = []
        self._cur: Optional[dict] = None

    # ------------------------------------------------------------------
    def bind(self, loop):
        self.loop = loop
        self._next_epoch = self.cfg.epoch

    @property
    def n_moves(self) -> int:
        return len(self.moves)

    @property
    def n_flips(self) -> int:
        return sum(m["kind"] == "flip" for m in self.moves)

    # ------------------------------------------------------------------
    def _instances(self, itype: str) -> List:
        return [i for i in self.loop.cluster.instances
                if i.itype == itype and not i.draining and i.schedulable]

    def _flip_in_progress(self) -> bool:
        return any(i.pending_flip is not None
                   for i in self.loop.cluster.instances)

    def _current_sd(self) -> int:
        d = self._instances(D_HEAVY)
        return min((i.chunk_size for i in d), default=0)

    def _current_sp(self) -> int:
        p = self._instances(P_HEAVY)
        return max((i.chunk_size for i in p), default=0)

    def _record(self, now: float, kind: str, **detail):
        mv = {"t": round(now, 3), "kind": kind, **detail}
        self.moves.append(mv)
        self._hold_until = now + self.cfg.cooldown * self.cfg.epoch
        if self._cur is not None:
            self._cur["actions"].append(mv)
        tr = getattr(self.loop, "tracer", None)
        if tr is not None:
            tr.global_event(now, "controller_" + kind, **detail)

    def _note(self, key: str, val):
        """Annotate the current epoch's audit record (no-op when the
        audit is off)."""
        if self._cur is not None:
            self._cur[key] = val

    # ------------------------------------------------------------------
    def maybe_epoch(self, now: float):
        if self._next_epoch is None or now < self._next_epoch:
            return
        # one decision per elapsed epoch boundary, not per backlogged one
        self._next_epoch = (now - now % self.cfg.epoch) + self.cfg.epoch
        self.on_epoch(now)

    def on_epoch(self, now: float):
        tele = self.loop.telemetry
        att_ttft = tele.ttft_attainment(now)
        # TPOT: prefer the in-flight signal — finished-request TPOT lags
        # a whole generation behind (it reports violations long after
        # they began, and keeps reporting them long after a fix lands);
        # the in-flight view tracks the population actually decoding now
        att_live = tele.tpot_inflight_attainment(
            now, self.loop.cluster.instances)
        att_tpot = (att_live if att_live is not None
                    else tele.tpot_attainment(now))
        # close the loop on the PREVIOUS record: what the last decision
        # actually did to the signals, captured before this epoch's
        # queue-guard mutates them
        if self.audit and "observed" not in self.audit[-1]:
            self.audit[-1]["observed"] = {
                "t": round(now, 3),
                "ttft_att": att_ttft,
                "tpot_att": att_tpot,
                "goodput_rps": tele.goodput(now),
            }
        low = self.cfg.target - self.cfg.deadband
        ttft_bad = att_ttft is not None and att_ttft < low
        tpot_bad = att_tpot is not None and att_tpot < low
        # the admission queue is a first-class controller signal: work
        # aging in the router queue IS prefill starvation, visible one
        # window earlier than the first-token stream it delays
        queue_forced = False
        adm = getattr(self.loop, "admission", None)
        if adm is not None and len(adm) \
                and adm.oldest_wait(now) > self.cfg.queue_guard \
                * self.loop.slo.ttft:
            ttft_bad = True
            queue_forced = True
            if att_ttft is None:
                att_ttft = 0.0
        n_evidence = len(tele._first) + len(tele._fin)
        if self.cfg.audit:
            rec = {
                "t": round(now, 3),
                "signals": {
                    "ttft_att": att_ttft,
                    "tpot_att": att_tpot,
                    "tpot_inflight": att_live is not None,
                    "ttft_bad": ttft_bad,
                    "tpot_bad": tpot_bad,
                    "queue_forced": queue_forced,
                    "queue_depth": len(adm) if adm is not None else 0,
                    "queue_oldest_wait_s": (
                        round(adm.oldest_wait(now), 3)
                        if adm is not None and len(adm) else 0.0),
                    "s_d": self._current_sd(),
                    "s_p": self._current_sp(),
                    "n_p": len(self._instances(P_HEAVY)),
                    "n_d": len(self._instances(D_HEAVY)),
                    "evidence": n_evidence,
                },
                "actions": [],
            }
            self.audit.append(rec)
            if len(self.audit) > self.cfg.audit_max_epochs:
                del self.audit[0]
            self._cur = rec
        else:
            self._cur = None
        self._evaluate_last_move(now, ttft_bad, tpot_bad)
        if self.cfg.replicate:
            # orthogonal to slider motion: replication never reconfigures
            # roles, so it runs regardless of cooldown or staged flips
            self._replicate_hot(now)
        if now < self._hold_until:
            self._note("hold", "cooldown")
            return
        if self._flip_in_progress():
            self._note("hold", "flip_in_progress")
            return
        if n_evidence < self.cfg.min_evidence:
            self._note("hold", "insufficient_evidence")
            return
        if ttft_bad and tpot_bad:
            # saturated on both axes: sliders cannot conjure capacity —
            # admission control can: early-reject queued work from the
            # lowest priority classes so what remains meets its SLOs
            self._shed(now, att_ttft, att_tpot)
            return
        if ttft_bad:
            self._more_prefill(now, att_ttft)
        elif tpot_bad:
            self._more_decode(now, att_tpot)
        else:
            self._note("hold", "within_deadband")

    def _shed(self, now: float, att_ttft, att_tpot):
        self._note("branch", "saturated_both")
        if not self.cfg.shed:
            self._note("hold", "shed_disabled")
            return
        shed_fn = getattr(self.loop, "shed_admission", None)
        if shed_fn is None:
            self._note("hold", "no_admission_queue")
            return
        n = shed_fn(self.cfg.shed_fraction)
        if n:
            self._record(now, "shed", count=n,
                         why=f"ttft_att={att_ttft:.2f} "
                             f"tpot_att={att_tpot:.2f}")

    def _evaluate_last_move(self, now: float, ttft_bad: bool,
                            tpot_bad: bool):
        """Local-search backtracking: a chunk move that broke the OTHER
        dimension is undone and its direction embargoed, so the next
        starved epoch escalates to a role flip instead of oscillating."""
        mv = self._pending_eval
        self._pending_eval = None
        if mv is None:
            return
        broke_other = (tpot_bad if mv["dir"] == "up" else ttft_bad)
        if not broke_other:
            return
        self.loop.set_chunks(D_HEAVY, mv["frm"])
        until = now + self.cfg.tabu_epochs * self.cfg.epoch
        self._tabu["sd_" + mv["dir"]] = until
        self._record(now, "revert", slider="s_d", frm=mv["to"],
                     to=mv["frm"],
                     why=("tpot broke" if mv["dir"] == "up"
                          else "ttft broke"))

    def _tabued(self, direction: str, now: float) -> bool:
        return now < self._tabu.get("sd_" + direction, 0.0)

    # ------------------------------------------------------------------
    def _replicate_hot(self, now: float):
        """Epoch-boundary hot-prefix replication: for every instance's
        hottest matchable prefixes (per-instance hit telemetry), ship
        the blocks the COLDEST peer is missing.  Best effort and off the
        critical path — the transfer lands through the cluster's
        ordinary migration machinery, and a full destination pool admits
        nothing rather than evicting its own content."""
        cfg = self.cfg
        cluster = self.loop.cluster
        insts = [i for i in cluster.instances
                 if i.prefix_cache is not None and not i.draining
                 and i.schedulable]
        if len(insts) < 2:
            return
        rec = getattr(cluster, "recovery", None)
        for src in insts:
            budget = cfg.replicate_max_blocks
            for tokens, hits in src.hot_prefixes(cfg.replicate_max_paths,
                                                 cfg.replicate_min_hits):
                if budget <= 0:
                    break
                bs = src.prefix_cache.block_size
                n = len(tokens) // bs
                if rec is not None:
                    # warm recovery already re-replicated this path after
                    # a crash: spend the epoch budget elsewhere while two
                    # healthy holders survive
                    live = [iid for iid in rec.holders(tokens)
                            if (cluster._inst_by_id.get(iid) is not None
                                and cluster._inst_by_id[iid].schedulable)]
                    if len(live) >= 2:
                        continue

                def depth(inst):
                    return len(inst.prefix_cache.tree.match(
                        tokens, n, touch=False))

                dst = min((i for i in insts if i is not src), key=depth)
                have = depth(dst)
                if have >= n:
                    continue          # path already everywhere it fits
                ship = tokens[:min(n, have + budget) * bs]
                if cluster.replicate_prefix(src, dst, ship, now):
                    budget -= len(ship) // bs
                    self.replications += 1

    # ------------------------------------------------------------------
    def _more_prefill(self, now: float, att: float):
        """Aggregation-ward: S_D up while decode has headroom, else flip
        D->P (drain-and-flip)."""
        cfg = self.cfg
        sd = self._current_sd()
        sp = self._current_sp()
        higher = [s for s in cfg.sd_steps if s > sd]
        tele = self.loop.telemetry
        p90 = tele.p90_tpot_inflight(now, self.loop.cluster.instances)
        if p90 is None:
            p90 = tele.p90_tpot(now)
        tpot_headroom = (p90 is None
                         or p90 < cfg.tpot_guard * self.loop.slo.tpot)
        higher = [s for s in higher if not sp or s <= sp]
        self._note("guards", {"branch": "more_prefill",
                              "tpot_headroom": tpot_headroom,
                              "tabu_up": self._tabued("up", now),
                              "sd_at_ceiling": not higher})
        if higher and tpot_headroom and not self._tabued("up", now):
            # cratered TTFT jumps the ladder (mirror of _more_decode)
            to = higher[-1] if att < cfg.target / 2 else higher[0]
            if self.loop.set_chunks(D_HEAVY, to):
                self._record(now, "chunk", slider="s_d", frm=sd,
                             to=to, why=f"ttft_att={att:.2f}")
                self._pending_eval = {"dir": "up", "frm": sd, "to": to}
                return
        d = self._instances(D_HEAVY)
        if len(d) > cfg.min_d:
            inst = min(d, key=lambda i: i.decode_load())
            if self.loop.flip_role(inst, P_HEAVY, sp or max(cfg.sd_steps)):
                self._record(now, "flip", iid=inst.iid, to=P_HEAVY,
                             why=f"ttft_att={att:.2f}")
                return
        self._note("hold", "at_role_floor")

    def _more_decode(self, now: float, att: float):
        """Disaggregation-ward: S_D down, then P->D flip.  A cratered
        signal (att < 1/2 target) jumps straight to the ladder floor —
        stepping down one notch per epoch pays the violation bill for
        every epoch the descent takes."""
        cfg = self.cfg
        sd = self._current_sd()
        lower = [s for s in cfg.sd_steps if s < sd]
        self._note("guards", {"branch": "more_decode",
                              "tabu_down": self._tabued("down", now),
                              "sd_at_floor": not lower})
        if lower and not self._tabued("down", now):
            to = lower[0] if att < cfg.target / 2 else lower[-1]
            if self.loop.set_chunks(D_HEAVY, to):
                self._record(now, "chunk", slider="s_d", frm=sd,
                             to=to, why=f"tpot_att={att:.2f}")
                self._pending_eval = {"dir": "down", "frm": sd,
                                      "to": to}
                return
        p = self._instances(P_HEAVY)
        if len(p) > cfg.min_p:
            inst = min(p, key=lambda i: i.decode_load())
            # floor at the smallest ladder step: chunk 0 would strand
            # whatever prefill work is already queued on the instance
            new_sd = self._current_sd() or min(cfg.sd_steps)
            if self.loop.flip_role(inst, D_HEAVY, new_sd):
                self._record(now, "flip", iid=inst.iid, to=D_HEAVY,
                             why=f"tpot_att={att:.2f}")
                return
        self._note("hold", "at_role_floor")
