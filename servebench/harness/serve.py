"""One run of a cell on the program's main path, ``--engine live``:
``repro_torch.serving.server.ServingLoop.run``, paced (``pace=True``) on a
``serving.clock.WallClock``, over ``sim.simulator.build_cluster(policy=
"taichi", async_exec=True)`` with one P-heavy and one D-heavy paged
``engine.engine.TorchExecutor`` sharing one params dict, decode horizons
up to the configuration's ``horizon``, greedy decoding.

Set-up (``setup_s``: process start to the window's opening) makes the
weights on the device, builds the executors, serves a warm-up burst from
the warm-up stream (another seed than the window's) through a cluster
over them, and captures the decode graphs the window will replay.  The
program's schedule is a function of its own (virtual) clock and the
requests alone, so the set of decode buckets ``(B, NB, K)`` the window
uses is found by running the same cluster over bookkeeping-only
executors on a virtual clock; the buckets the warm-up did not capture are
then captured through the executor's own dispatch with padding rows
(every row's budget 0: nothing is written).  The timed cluster is built
over the warmed, idle executors, as ``chip_smoke.py``'s ``live_warm``.

The window opens when the ``WallClock`` is made: a request is due at its
arrival time on that clock, and every token is timed at the benchmark's
own ``on_token`` sink.  After the window a ``drain`` mix keeps its
arrivals coming and waits for the requests due in the window (each until
it has finished or can no longer meet both limits); a ``stop`` mix ends
at the window's close.

With ``trace`` the executors and the loop are this module's subclasses,
which time each dispatch (CUDA events around it, host clock), record
what it computed, and open host spans (``torch.profiler.record_function``)
around dispatch, readback and pacing; ``torch.profiler`` traces a steady
slice of the window.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List

import numpy as np
import torch

import families
from harness.measure import Timed
from harness.traffic import Arrival, Traffic

#: events the loop processes between two looks at the wall clock
SLICE_EVENTS = 4


# ---------------------------------------------------------------------------
# the program's classes, and the benchmark's instrumented subclasses
# ---------------------------------------------------------------------------

def program():
    """The program's serving stack (imported on first use)."""
    from repro_torch.core.latency import SLO
    from repro_torch.core.policies import Sliders
    from repro_torch.engine.batching import bucket_batch
    from repro_torch.engine.engine import (PendingStep, SimExecutor,
                                           TorchExecutor)
    from repro_torch.engine.request import Request, State
    from repro_torch.serving.clock import VirtualClock, WallClock
    from repro_torch.serving.server import ServingLoop
    from repro_torch.sim.simulator import ServingConfig, build_cluster
    from repro_torch.cache.shared_allocator import SharedBlockAllocator
    return dict(SLO=SLO, Sliders=Sliders, bucket_batch=bucket_batch,
                PendingStep=PendingStep, SimExecutor=SimExecutor,
                TorchExecutor=TorchExecutor, Request=Request, State=State,
                VirtualClock=VirtualClock, WallClock=WallClock,
                ServingLoop=ServingLoop, ServingConfig=ServingConfig,
                build_cluster=build_cluster,
                SharedBlockAllocator=SharedBlockAllocator)


@dataclasses.dataclass
class Dispatch:
    """One executor dispatch as the traced run records it."""
    inst: int
    kind: str                 # "decode" (a horizon) or "mixed"
    t: float                  # host seconds (perf_counter) at dispatch
    steps: int                # K of a horizon, else 1
    decode: list              # [(position, budget)] of horizon rows,
                              # [(position, 1)] of decode rows riding along
    prefill: list             # [(start, valid, completes)]
    replayed: bool            # a replay of a captured graph
    used_blocks: int          # blocks in use in this instance's pool
    ev0: object = None
    ev1: object = None
    # rids of the requests whose prefill starts in this dispatch
    started: list = dataclasses.field(default_factory=list)

    def device_ms(self) -> float:
        return self.ev0.elapsed_time(self.ev1)


def traced_classes(P):
    """The instrumented executor and loop of a ``--trace 1`` run."""
    from torch.profiler import record_function as span
    TorchExecutor, PendingStep = P["TorchExecutor"], P["PendingStep"]

    class TracedExecutor(TorchExecutor):
        """Records every dispatch (what it computed, host and device
        time) into ``self.log`` and opens the host spans
        ``exec.dispatch.<kind>`` and ``exec.readback``."""

        def __init__(self, *a, log, index, **kw):
            super().__init__(*a, **kw)
            self.log = log
            self.index = index

        def step_async(self, plan):
            prefill, started = [], []
            for req, start, take, completes in (plan.prefill_rows()
                                                if plan.prefill_items
                                                else ()):
                prefill.append((start + req.recompute_offset, take,
                                bool(completes)))
                if start + req.recompute_offset == 0:
                    started.append(req.rid)
            pos = [int(self.positions[self.slots.slot(r.rid)])
                   for r in plan.decode_reqs]
            if prefill:
                kind, steps = "mixed", 1
                decode = [(p, 1) for p in pos]
            else:
                kind, steps = "decode", getattr(plan, "horizon", 1)
                budgets = (getattr(plan, "decode_budgets", None)
                           or [1] * len(pos))
                decode = list(zip(pos, budgets))
            rep = self.graphs.replays
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            with span(f"exec.dispatch.{'prefill' if prefill else 'decode'}"):
                ev0.record()
                step = super().step_async(plan)
                ev1.record()
            if not isinstance(step, PendingStep):
                return step
            self.log.append(Dispatch(
                self.index, kind, t0, steps, decode, prefill,
                self.graphs.replays > rep, self.kv.allocator.used_blocks,
                ev0, ev1, started))
            inner = step.resolve

            def resolve():
                with span("exec.readback"):
                    return inner()

            step.resolve = resolve
            return step

    ServingLoop = P["ServingLoop"]

    class TracedLoop(ServingLoop):
        """The program's loop with a host span over its pacing waits."""

        def _pace_until(self, t):
            with span("loop.pace"):
                return super()._pace_until(t)

    return TracedExecutor, TracedLoop


# ---------------------------------------------------------------------------
# the program's private capture path: set-up predicts the window's decode
# buckets with a copy of ``TorchExecutor._step_horizon_paged``'s bucket
# arithmetic and captures them through ``_dispatch`` / ``_horizon_paged``.
# Both go once the program captures a bucket on request.  A prediction
# that no longer holds shows as a capture inside the window, which makes
# the run not correct (``run.py``).
# ---------------------------------------------------------------------------

def capture_bucket(ex, key):
    """Captures decode bucket ``("paged", B, NB, K)`` on executor ``ex``
    with padding rows (every row's budget 0: nothing is written)."""
    _, B, NB, K = key
    zeros = np.zeros(B, np.int32)
    ex._dispatch(key, lambda *a: (ex._horizon_paged(*a, K=K),),
                 zeros, zeros, zeros, np.full((B, NB), -1, np.int32))


def key_recorder(P, num_blocks: int, block_size: int):
    """A bookkeeping-only executor that records the decode bucket
    ``("paged", B, NB, K)`` each decode-only plan would replay on a paged
    ``TorchExecutor`` with this pool (``_step_horizon_paged``)."""
    SimExecutor, bucket_batch = P["SimExecutor"], P["bucket_batch"]
    SharedBlockAllocator = P["SharedBlockAllocator"]

    class KeyRecorder(SimExecutor):
        prefix_aware_transfer = True

        def __init__(self, max_seq: int):
            self.allocator = SharedBlockAllocator(num_blocks, block_size)
            self.max_blocks = -(-max_seq // block_size)
            self.keys = set()

        def use_external_bookkeeping(self):
            pass

        def step_async(self, plan):
            if plan.decode_reqs and not plan.prefill_items:
                budgets = (getattr(plan, "decode_budgets", None)
                           or [1] * len(plan.decode_reqs))
                need = max(-(-(r.context_len - 1 + b) // block_size)
                           for r, b in zip(plan.decode_reqs, budgets))
                nb = min(bucket_batch(max(need, 1)), self.max_blocks)
                self.keys.add(("paged", bucket_batch(len(plan.decode_reqs)),
                               nb, getattr(plan, "horizon", 1)))
            return super().step_async(plan)

    return KeyRecorder


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

class Sink:
    """The benchmark's ``on_token``: the wall time of every token of the
    requests it was told of, and the loop clock's lag behind the wall."""

    def __init__(self, clock, seconds: float, timed: Dict[int, Timed]):
        self.clock = clock
        self.seconds = seconds
        self.timed = timed
        self.lags: List[float] = []
        self.in_window = 0

    def __call__(self, req, t, tok):
        now = self.clock.now
        r = self.timed.get(req.rid)
        if r is None:
            return
        if r.first is None:
            r.first = now
        r.last = now
        r.tokens += 1
        if now < self.seconds:
            self.in_window += 1
        self.lags.append(now - t)


class Bench:
    """Set-up, window and drain of one cell's run, and what the readers
    read afterwards."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device="cuda"):
        self.P = program()
        self.cell = cell
        self.config = cell.config
        self.family = families.load(self.config)
        self.seed = seed
        self.seconds = float(seconds)
        self.trace = trace
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if trace and not self.cuda:
            raise ValueError("a traced run reads the card's trace")
        self.cfg = self.family.port_config(self.config)
        self.ex = self.config["executor"]
        self.set_traffic()
        self.limits = cell.traffic["limits"]
        self.log: List[Dispatch] = []
        self.notes: dict = {}
        # each window request's inputs beyond its prompt ids, by rid
        self.inputs: Dict[int, dict] = {}

    def set_traffic(self):
        """The generator of the cell's mix (after a change to the mix)."""
        self.traffic = Traffic(self.cell.traffic, self.cfg.vocab_size,
                               self.seconds, self.family.inputs)

    # ---- set-up ----------------------------------------------------------
    def _request(self, a: Arrival):
        return self.P["Request"](prompt_len=len(a.prompt),
                                 max_new_tokens=a.output_len, arrival=a.due,
                                 hidden_output_len=a.output_len,
                                 prompt_tokens=a.prompt.tolist(),
                                 **self.family.request_kwargs(a))

    def _serving_config(self):
        P, ex = self.P, self.ex
        return P["ServingConfig"](
            model=self.config["port_arch"], tp=1, policy="taichi",
            sliders=P["Sliders"](n_p=ex["n_p"], n_d=ex["n_d"],
                                 s_p=ex["s_p"], s_d=ex["s_d"]),
            hbm_blocks=ex["hbm_blocks"], block_size=ex["block_size"])

    def _cluster(self, factory):
        P = self.P
        slo = P["SLO"](ttft=self.limits["ttft_s"], tpot=self.limits["tpot_s"])
        cluster = P["build_cluster"](self._serving_config(), slo, seed=0,
                                     executor_factory=factory,
                                     async_exec=True)
        cluster.set_horizon(self.ex["horizon"])
        return cluster, slo

    def setup(self, params):
        """Executors over ``params``, the warm-up burst, the window's
        decode buckets captured."""
        P, ex = self.P, self.ex
        n = ex["n_p"] + ex["n_d"]
        kw = dict(n_slots=ex["n_slots"], max_seq=ex["max_seq"],
                  hbm_blocks=ex["hbm_blocks"],
                  cache_block_size=ex["block_size"], device=self.device)
        if self.trace:
            Exec, self.Loop = traced_classes(P)
            self.executors = [Exec(self.cfg, params, log=self.log, index=i,
                                   **kw) for i in range(n)]
            warm_profiler(self.device)
        else:
            self.Loop = P["ServingLoop"]
            self.executors = [P["TorchExecutor"](self.cfg, params, **kw)
                              for _ in range(n)]
        self.warmup()
        self.capture_window_buckets()
        if self.cuda:
            torch.cuda.synchronize()
        del self.log[:]

    def warmup(self):
        P = self.P
        cluster, slo = self._cluster(iter(self.executors).__next__)
        reqs = [self._request(a) for a in self.traffic.warmup(self.seed)]
        loop = P["ServingLoop"](cluster, slo, arrivals=iter(reqs))
        t0 = time.perf_counter()
        loop.run()
        bad = [r for r in reqs if r.state != P["State"].FINISHED]
        if bad or cluster.exec_errors:
            raise RuntimeError(
                f"warm-up: {len(bad)} of {len(reqs)} requests unfinished, "
                f"{cluster.exec_errors} executor errors "
                f"({cluster.last_exec_error})")
        self.notes["warmup_s"] = time.perf_counter() - t0
        self.notes["warmup_requests"] = len(reqs)

    def window_buckets(self) -> List[set]:
        """The decode buckets each instance replays in this seed's window
        and drain, from the program's schedule on a virtual clock."""
        P, ex = self.P, self.ex
        Rec = key_recorder(P, ex["hbm_blocks"], ex["block_size"])
        recs = [Rec(ex["max_seq"]) for _ in range(ex["n_p"] + ex["n_d"])]
        cluster, slo = self._cluster(iter(recs).__next__)
        arrivals = (self._request(a) for a in self.traffic.arrivals(self.seed))
        loop = P["ServingLoop"](cluster, slo, arrivals=arrivals,
                                clock=P["VirtualClock"]())
        loop.run(until=self.seconds
                 + (self.drain_cap() if self.traffic.drain else 0.0))
        return [r.keys for r in recs]

    def capture_window_buckets(self):
        if not self.cuda:
            return
        t0 = time.perf_counter()
        before = sum(e.graphs.captures for e in self.executors)
        buckets = self.window_buckets()
        self.notes["schedule_s"] = time.perf_counter() - t0
        self.notes["window_buckets"] = [len(b) for b in buckets]
        for ex, keys in zip(self.executors, buckets):
            for key in sorted(keys - set(ex.graphs.graphs)):
                capture_bucket(ex, key)
        torch.cuda.synchronize()
        self.notes["captured_ahead"] = sum(
            e.graphs.captures for e in self.executors) - before
        self.notes["capture_ahead_s"] = time.perf_counter() - t0

    def drain_cap(self) -> float:
        """The longest a request due in the window can still be waited
        for after the window."""
        return (self.limits["ttft_s"] + self.limits["tpot_s"]
                * self.traffic.output.hi + 1.0)

    # ---- the window ------------------------------------------------------
    def run_window(self):
        """Opens the window, serves it (and the drain), and returns when
        the run is over; the timed path's state stays for the readers."""
        P = self.P
        cluster, slo = self._cluster(iter(self.executors).__next__)
        self.cluster = cluster
        timed: Dict[int, Timed] = {}
        self.requests = {}
        self.more_arrivals = True
        # every request due in the window, whether or not the program
        # takes it in before the run ends
        self.window = [Timed(a.due, len(a.prompt), a.output_len)
                       for a in self.traffic.period(self.seed, 0)]

        def arrivals():
            for a in self.traffic.arrivals(self.seed):
                if not self.more_arrivals:
                    return
                r = self._request(a)
                t = (self.window[a.index] if a.index < len(self.window)
                     else Timed(a.due, len(a.prompt), a.output_len))
                t.rid = r.rid
                timed[r.rid] = t
                self.requests[r.rid] = r
                self.inputs[r.rid] = a.inputs
                yield r

        self.captures_before = [e.graphs.captures for e in self.executors] \
            if self.cuda else []
        clock = P["WallClock"]()
        self.setup_end = time.perf_counter()
        sink = Sink(clock, self.seconds, timed)
        self.sink = sink
        loop = self.Loop(cluster, slo, arrivals=arrivals(), on_token=sink,
                         clock=clock, pace=True)
        self.loop = loop
        prof = Profile(self, clock) if self.trace and self.cuda else None
        drain = self.traffic.drain
        cap = self.seconds + self.drain_cap()
        Done = (P["State"].REJECTED, P["State"].CANCELLED, P["State"].FAILED)
        while True:
            loop.run(max_steps=SLICE_EVENTS)
            now = clock.now
            if prof is not None:
                prof.poll(now)
            if now < self.seconds:
                continue
            if not drain or now >= cap:
                break
            self._update(self.window, Done)
            if all(r.settled(now, self.limits["ttft_s"],
                             self.limits["tpot_s"]) for r in self.window):
                break
        self.end = clock.now
        if prof is not None:
            prof.poll(float("inf"))
        if self.cuda:
            torch.cuda.synchronize()
        self._update(timed.values(), Done)
        self.timed = timed
        self.profile = prof
        self.captures_in_window = (
            sum(e.graphs.captures for e in self.executors)
            - sum(self.captures_before)) if self.cuda else 0

    def finish(self):
        """For the tools that serve several windows on one set-up: stops
        the arrivals, aborts what is unfinished and runs the loop until
        the executors are idle."""
        from repro_torch.engine.request import TERMINAL_STATES
        self.more_arrivals = False
        for rid, r in self.requests.items():
            if r.state not in TERMINAL_STATES:
                self.loop.abort(rid)
        self.loop.run()
        if self.cuda:
            torch.cuda.synchronize()

    def _update(self, records, done_states):
        for r in records:
            if r.rid is not None:
                st = self.requests[r.rid].state
                r.finished = st == self.P["State"].FINISHED
                r.failed = st in done_states

    # ---- after the window ------------------------------------------------
    def window_timed(self) -> List[Timed]:
        """Every request due in the window (those the program never took
        in have no first token)."""
        return self.window

    def finished_requests(self) -> list:
        """The Requests that finished, with every token they were asked
        for, in order of arrival."""
        F = self.P["State"].FINISHED
        return [r for r in self.requests.values()
                if r.state == F and len(r.output_tokens) == r.target_output_len]

    def roles(self) -> Dict[int, str]:
        return {inst.iid: inst.itype for inst in self.cluster.instances}

    def release(self):
        """Frees the program's state (pools, graphs, cluster), keeping the
        weights for the reference."""
        for name in ("loop", "cluster", "executors"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def warm_profiler(device):
    """Starts and stops the profiler once, in set-up: its first start
    (CUPTI's initialisation) takes seconds that would stall the window."""
    with _profiler():
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize()


class Profile:
    """``torch.profiler`` over a steady slice of the window: it starts at
    ``trace.start_share`` of the window and lasts ``trace.seconds`` from
    the moment it has started; at its end the device is synchronised, so
    every dispatch of the slice has run inside it."""

    def __init__(self, bench: Bench, clock):
        tr = bench.config["trace"]
        self.clock = clock
        self.start_at = tr["start_share"] * bench.seconds
        self.seconds = tr["seconds"]
        self.stop_at = None
        self.prof = None
        self.t0 = self.t1 = None
        self.done = False

    def poll(self, now: float):
        if self.done:
            return
        if self.prof is None and now >= self.start_at:
            self.prof = _profiler()
            self.prof.start()
            self.t0 = time.perf_counter()
            self.stop_at = self.clock.now + self.seconds
        elif self.prof is not None and now >= self.stop_at:
            torch.cuda.synchronize()
            self.t1 = time.perf_counter()
            self.prof.stop()
            self.done = True
