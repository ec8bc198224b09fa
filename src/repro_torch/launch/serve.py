"""Serving launcher of the port: run a TaiChi (or baseline) cluster.

Modes:
  --engine sim    event-driven simulator with estimator timing (default;
                  any registered arch, production scale)
  --engine torch  real PyTorch engine with the hand-written CUDA kernels:
                  tokens are really computed, batch replay
  --engine live   the ONLINE serving runtime on the real PyTorch engine:
                  open-loop ingestion, per-token streaming, windowed
                  telemetry snapshots, K-step decode horizons (``--horizon``,
                  default 8) over the non-blocking dispatch/commit
                  pipeline, and (with --controller) live slider adaptation
                  incl. drain-and-flip role changes

Both real-engine modes run on the card (``--device cuda``, the default) at
the registered width; ``--reduced`` serves the small test variant and
``--device cpu`` the kernels' plain versions.  All-ATTN archs take the
paged executor path, llava-next-34b among them (text only: its projector
is unused); Mamba2, hybrid, MoE, sliding-window and encoder-decoder archs
(mamba2-1.3b, zamba2-7b, granite-moe-3b-a800m, arctic-480b, gemma3-1b,
whisper-base) the batched dense one, as ``engine.packable`` decides (and
only the former fuse decode horizons).  The engine's requests carry text
only, so whisper's decoder serves over a cross cache of 0 keys, as the
reference's does; its 448-token text context wants ``--max-seq 448``.

``--serve HOST:PORT`` puts the same live loop behind the OpenAI-compatible
HTTP/SSE front end (``repro_torch.frontend``): ``POST /v1/completions``
and ``/v1/chat/completions``, ``GET /healthz`` and ``/metrics``, with the
tokenizer workers and the admission queue; it runs until SIGINT or
SIGTERM, then drains.  Port 0 takes a free port; the ``serving ...`` line
names the one bound.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
      --policy taichi --np 2 --nd 2 --sp 1024 --sd 256 --qps 80
  PYTHONPATH=src python -m repro_torch.launch.serve --engine torch \\
      --arch qwen2.5-3b --np 1 --nd 1 --qps 4 --n 32
  PYTHONPATH=src python -m repro_torch.launch.serve --engine live \\
      --arch qwen2.5-3b --np 1 --nd 1 --qps 8 --n 32 --pace
  PYTHONPATH=src python -m repro_torch.launch.serve --engine live \\
      --arch smollm-135m --reduced --device cpu --qps 4 --n 8
  PYTHONPATH=src python -m repro_torch.launch.serve --engine torch \\
      --arch zamba2-7b --reduced --device cpu --qps 2 --n 8 --np 1 --nd 1
  PYTHONPATH=src python -m repro_torch.launch.serve --engine live \\
      --arch gemma3-1b --np 1 --nd 1 --slots 8 --qps 8 --n 16
  PYTHONPATH=src python -m repro_torch.launch.serve --engine torch \\
      --arch whisper-base --np 1 --nd 1 --slots 8 --max-seq 448 --n 16
  PYTHONPATH=src python -m repro_torch.launch.serve --engine live \\
      --arch llava-next-34b --np 1 --nd 1 --hbm-blocks 640 --n 16
  PYTHONPATH=src python -m repro_torch.launch.serve --engine live \\
      --serve 127.0.0.1:8000 --arch smollm-135m --reduced --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.latency import SLO
from repro_torch.core.policies import Sliders
from repro_torch.sim.simulator import ServingConfig, build_cluster, run_sim
from repro_torch.sim.workload import WORKLOADS, LengthDist, WorkloadSpec

def _engine_setup(args, slo: SLO, async_exec: bool = False):
    """The cluster of the real-engine modes: shared random weights from a
    seed, one TorchExecutor an instance.  Returns (cfg, cluster,
    workload)."""
    import torch

    from repro_torch.engine.engine import TorchExecutor
    from repro_torch.models import transformer as tf
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("--device cuda: no CUDA device is available "
                 "(--device cpu runs the kernels' plain versions)")
    if args.reduced:
        cfg = reduced_config(args.arch)
        sp, sd, max_seq, blocks = min(args.sp, 64), min(args.sd, 32), 512, 512
        wl = WorkloadSpec("tiny",
                          LengthDist(mu=3.4, sigma=0.4, lo=16, hi=128),
                          LengthDist(mu=2.5, sigma=0.4, lo=4, hi=32),
                          tokenized=True, vocab_size=cfg.vocab_size)
    else:
        cfg = get_config(args.arch)
        sp, sd, max_seq, blocks = args.sp, args.sd, args.max_seq, \
            args.hbm_blocks
        wl = WorkloadSpec("replay",
                          LengthDist(mu=6.3, sigma=0.7, lo=64,
                                     hi=max_seq // 2),
                          LengthDist(mu=4.0, sigma=0.6, lo=8, hi=128),
                          tokenized=True, vocab_size=cfg.vocab_size)
    params = tf.init_params(0, cfg, device=args.device)
    sc = ServingConfig(model=args.arch, tp=1, policy=args.policy,
                       sliders=Sliders(n_p=args.np, n_d=args.nd,
                                       s_p=sp, s_d=sd),
                       hbm_blocks=blocks)
    factory = lambda: TorchExecutor(cfg, params, n_slots=args.slots,
                                    max_seq=max_seq, hbm_blocks=blocks,
                                    device=args.device)
    cluster = build_cluster(sc, slo, executor_factory=factory,
                            async_exec=async_exec)
    return cfg, cluster, wl


def _torch_mode(args, slo: SLO):
    """Batch replay on the real engine."""
    cfg, cluster, wl = _engine_setup(args, slo)
    reqs = wl.sample_requests(args.n, args.qps, seed=0)
    t0 = time.perf_counter()
    cluster.run(reqs)
    wall = time.perf_counter() - t0
    st = cluster.stats(reqs, slo, args.qps)
    tokens = sum(len(r.output_tokens) for r in reqs)
    print(json.dumps({**st.summary(),
                      "policy": args.policy,
                      "device": args.device,
                      "model": cfg.name,
                      "real_tokens": tokens,
                      "wall_s": round(wall, 3),
                      "transfers": cluster.transfer_count}, indent=2))


def _trace_config(args):
    """--trace (or either output path) turns on lifecycle tracing."""
    if not (args.trace or args.trace_out or args.trace_jsonl):
        return None
    from repro_torch.serving import TraceConfig
    return TraceConfig()


def _dump_trace(loop, args, slo: SLO):
    tr = getattr(loop, "tracer", None)
    if tr is None:
        return
    if args.trace_out:
        tr.dump_chrome(args.trace_out)
        print(f"chrome trace -> {args.trace_out} "
              "(open in ui.perfetto.dev)", flush=True)
    if args.trace_jsonl:
        tr.dump_jsonl(args.trace_jsonl)
        print(f"trace jsonl -> {args.trace_jsonl}", flush=True)
    print(json.dumps(
        {"slo_violation_report": tr.violation_report(slo)},
        indent=2, default=str))


def live_loop(args, slo: SLO, on_token=None, serve: bool = False):
    """The ``--engine live`` serving loop, built and not yet run, with
    ``on_token(req, t, tok)`` (if given) called for every streamed token.
    With ``serve`` (``--serve``) it takes its requests from the front
    end's ingress instead of a workload, paced on the wall clock, behind
    an admission queue of ``--adm-depth`` / ``--adm-inflight``.
    Returns (cfg, loop, controller or None, streamed) where
    ``streamed["tokens"]`` counts the tokens the loop has streamed."""
    from repro_torch.frontend import AdmissionConfig
    from repro_torch.serving import (ControllerConfig, ServingLoop,
                                     SliderController, WallClock)
    cfg, cluster, wl = _engine_setup(args, slo, async_exec=not args.no_async)
    if args.horizon > 1:
        cluster.set_horizon(args.horizon)
    ctl = None
    if args.controller:
        kw = dict(epoch=args.epoch, cooldown=1)
        if args.reduced:
            kw["sd_steps"] = (16, 32, 64)      # the reduced chunk ladder
        ctl = SliderController(ControllerConfig(**kw))
    streamed = {"tokens": 0}

    def sink(req, t, tok):
        streamed["tokens"] += 1
        if args.stream:
            print(f"[{t:8.3f}s] req{req.rid} token#{req.output_len} "
                  f"id={tok}")
        if on_token is not None:
            on_token(req, t, tok)

    pace = args.pace or serve
    loop = ServingLoop(
        cluster, slo,
        arrivals=None if serve else wl.iter_requests(
            args.qps, seed=0, max_new_tokens=32, limit=args.n),
        controller=ctl, window=args.window, on_token=sink,
        snapshot_every=args.snapshot_every,
        clock=WallClock() if pace else None, pace=pace,
        admission=(AdmissionConfig(max_depth=args.adm_depth,
                                   max_inflight=args.adm_inflight)
                   if serve else None),
        tracing=_trace_config(args))
    return cfg, loop, ctl, streamed


def _live_mode(args, slo: SLO):
    """Online runtime on the real engine: tokens stream as they are
    computed, telemetry snapshots print as JSON lines, and the controller
    may retune sliders mid-run."""
    cfg, loop, ctl, streamed = live_loop(args, slo)
    cluster = loop.cluster
    t0 = time.perf_counter()
    loop.run()
    wall = time.perf_counter() - t0
    _dump_trace(loop, args, slo)
    for snap in loop.log.snapshots:
        print(json.dumps({k: v for k, v in snap.items()
                          if k != "instances"}))
    executors = [inst.executor for inst in cluster.instances]
    st = loop.stats(args.qps)
    print(json.dumps({**st.summary(),
                      "policy": args.policy,
                      "device": args.device,
                      "model": cfg.name,
                      "streamed_tokens": streamed["tokens"],
                      "real_tokens": sum(len(r.output_tokens)
                                         for r in loop.requests),
                      "wall_s": round(wall, 3),
                      "horizon_calls": sum(ex.horizon_calls
                                           for ex in executors),
                      "horizon_tokens": sum(ex.horizon_tokens
                                            for ex in executors),
                      "host_readbacks": sum(ex.host_readbacks
                                            for ex in executors),
                      "transfers": cluster.transfer_count,
                      "controller_moves": (ctl.moves if ctl else [])},
                     indent=2, default=str))


def _serve_mode(args, slo: SLO):
    """Deployable network front-end: the live loop of ``--engine live``
    (on the card unless ``--device cpu``) behind the OpenAI-compatible
    HTTP/SSE server (``repro_torch.frontend``), with the multi-process
    tokenize/detokenize pipeline and the router-side admission queue.
    Blocks until SIGINT/SIGTERM, then drains."""
    from repro_torch.frontend import FrontendConfig, FrontendServer
    host, _, port = args.serve.rpartition(":")
    host = host or "127.0.0.1"
    cfg, loop, _, _ = live_loop(args, slo, serve=True)
    srv = FrontendServer(loop, FrontendConfig(
        host=host, port=int(port), model=args.arch,
        tok_workers=args.tok_workers))

    def announce():
        # the bound port is known once the server has started (port 0)
        if srv.started.wait(timeout=600):
            print(f"serving {cfg.name} ({args.policy}) on {args.device} at "
                  f"http://{host}:{srv.port} — POST /v1/completions, "
                  "/v1/chat/completions; GET /healthz, /metrics",
                  flush=True)

    threading.Thread(target=announce, name="announce", daemon=True).start()
    srv.run(install_signals=True)
    print(json.dumps(loop.snapshot(), default=str), flush=True)
    _dump_trace(loop, args, slo)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--engine", choices=["sim", "torch", "live"],
                    default="sim")
    ap.add_argument("--policy", default="taichi",
                    choices=["taichi", "aggregation", "disaggregation"])
    ap.add_argument("--np", type=int, default=2)
    ap.add_argument("--nd", type=int, default=2)
    ap.add_argument("--sp", type=int, default=1024)
    ap.add_argument("--sd", type=int, default=256)
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--qps", type=float, default=40.0)
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--workload", default="sharegpt",
                    choices=sorted(WORKLOADS))
    ap.add_argument("--ttft-slo", type=float, default=1.5)
    ap.add_argument("--tpot-slo", type=float, default=0.030)
    # torch-engine knobs
    ap.add_argument("--device", default="cuda",
                    help="torch: device of the engine (default cuda)")
    ap.add_argument("--reduced", action="store_true",
                    help="torch: serve the reduced test variant of --arch "
                         "instead of the registered width")
    ap.add_argument("--slots", type=int, default=16,
                    help="torch: resident requests an instance")
    ap.add_argument("--max-seq", type=int, default=4096,
                    help="torch: longest context an instance holds")
    ap.add_argument("--hbm-blocks", type=int, default=8192,
                    help="torch: 16-token KV blocks an instance")
    # live-mode knobs
    ap.add_argument("--controller", action="store_true",
                    help="live: adapt sliders online (epoch-based)")
    ap.add_argument("--epoch", type=float, default=2.0,
                    help="live: controller epoch seconds")
    ap.add_argument("--window", type=float, default=5.0,
                    help="live: telemetry window seconds")
    ap.add_argument("--snapshot-every", type=float, default=5.0,
                    help="live: telemetry snapshot cadence")
    ap.add_argument("--stream", action="store_true",
                    help="live: print every streamed token")
    ap.add_argument("--pace", action="store_true",
                    help="live: pace events to wall-clock time")
    ap.add_argument("--horizon", type=int, default=8,
                    help="live: max fused decode steps per iteration "
                         "(adaptive; 1 = classic single-step)")
    ap.add_argument("--no-async", action="store_true",
                    help="live: disable the non-blocking dispatch/"
                         "commit executor pipeline")
    # tracing knobs (live mode)
    ap.add_argument("--trace", action="store_true",
                    help="record per-request lifecycle traces and print "
                         "an SLO violation attribution report")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="write a Chrome/Perfetto trace JSON after the "
                         "run (implies --trace)")
    ap.add_argument("--trace-jsonl", metavar="PATH", default=None,
                    help="write the trace event log as JSON lines "
                         "(implies --trace)")
    # network front-end knobs
    ap.add_argument("--serve", metavar="HOST:PORT", default=None,
                    help="run the OpenAI-compatible HTTP/SSE server on "
                         "the live engine (e.g. --serve 0.0.0.0:8000)")
    ap.add_argument("--tok-workers", type=int, default=2,
                    help="serve: tokenizer/detokenizer worker processes "
                         "(0 = inline, single-process)")
    ap.add_argument("--adm-depth", type=int, default=256,
                    help="serve: admission queue depth bound")
    ap.add_argument("--adm-inflight", type=int, default=64,
                    help="serve: released-but-unfinished request cap")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    slo = SLO(ttft=args.ttft_slo, tpot=args.tpot_slo)
    if args.serve:
        return _serve_mode(args, slo)
    if args.engine == "torch":
        return _torch_mode(args, slo)
    if args.engine == "live":
        return _live_mode(args, slo)

    sc = ServingConfig(model=args.arch, tp=args.tp, policy=args.policy,
                       sliders=Sliders(n_p=args.np, n_d=args.nd,
                                       s_p=args.sp, s_d=args.sd))
    st = run_sim(sc, slo, WORKLOADS[args.workload], args.qps, args.n)
    c = st.cluster
    print(json.dumps({**st.summary(),
                      "policy": args.policy,
                      "transfers": c.transfer_count,
                      "backflows": c.backflow_count,
                      "degrades": c.degrade_count}, indent=2))


if __name__ == "__main__":
    main()
