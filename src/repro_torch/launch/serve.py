"""Serving launcher: batched prefill + decode with clock-stamped sessions.

Example (the card, Qwen1.5-0.5B's full config):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1_5_0_5b \\
      --batch 4 --prompt-len 32 --gen 16

``--device cpu`` runs the same on the CPU (with ``--smoke``, a reduced
config, for a quick check); without ``--device`` the run takes the
CUDA card and fails where there is none.  Weights are random, drawn
from ``--seed`` (``models.params.init_params``), and prompts from
``--seed + 1``: the weights from a ``torch.Generator`` on the run's
device, the prompts from one on the CPU.

With ``--peers "id@host:port,..."`` the replica joins a multi-process
gossip fleet: after serving it runs one anti-entropy session over a
``SocketTransport`` to the listed ``ClockPeerServer`` processes (see
``repro_torch.launch.peers``), so replica clocks reconcile across hosts.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.causal import CausalPolicy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.params import init_params
from repro_torch.runtime.clock_runtime import ClockConfig
from repro_torch.serving.engine import ServeConfig, ServingEngine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="qwen1_5_0_5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--peers", type=str, default=None,
                    help="gossip fleet peers, 'id@host:port,...' "
                         "(repro_torch.launch.peers serves them)")
    ap.add_argument("--replica-id", type=str, default="replica0")
    ap.add_argument("--trace-dir", type=str, default=None,
                    help="record spans/metrics/audit for this run under "
                         "this directory (see repro_torch.obs)")
    ap.add_argument("--tiered", action="store_true",
                    help="hold session clocks in a hot/warm/cold "
                         "TieredRegistry behind a streaming admission "
                         "pipeline (repro_torch.serve) instead of the flat "
                         "engine slab")
    ap.add_argument("--hybrid", action="store_true",
                    help="serve session causality through the adaptive "
                         "HybridEngine: exact clocks for the hot set "
                         "over the packed bloom tail (repro_torch.hybrid)")
    ap.add_argument("--fp-budget", type=float, default=1e-4,
                    help="declared Eq. 3 false-positive budget for "
                         "--hybrid; AdaptivePolicy derives the tail "
                         "(m, k) from it — operators set a budget, "
                         "not clock geometry")
    ap.add_argument("--bench-serve", action="store_true",
                    help="run the serve churn benchmark (quick config) "
                         "and exit; the full run is "
                         "python -m repro_torch.serve.churn")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.bench_serve:
        import json

        from repro_torch.serve.churn import ChurnConfig, run_churn
        report = run_churn(ChurnConfig.quick(seed=args.seed,
                                             trace_dir=args.trace_dir),
                           device=device)
        print(json.dumps(report.to_dict(), indent=2))
        return 0 if report.ok() else 1

    obs = None
    policy = CausalPolicy(fp_threshold=1e-4)
    if args.trace_dir:
        from repro_torch.obs import Observer
        obs = Observer.to_dir(args.trace_dir)
        policy = dataclasses.replace(policy, observer=obs)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = init_params(torch.Generator(device).manual_seed(args.seed), cfg,
                         device)
    engine = ServingEngine(
        params, cfg,
        ServeConfig(max_batch=args.batch,
                    max_seq=args.prompt_len + args.gen + 8,
                    temperature=args.temperature, seed=args.seed),
        ClockConfig(policy=policy), device=device)

    prompts = torch.randint(
        0, cfg.vocab, (args.batch, args.prompt_len),
        generator=torch.Generator().manual_seed(args.seed + 1))

    _sync(device)
    t0 = time.perf_counter()
    session = engine.admit(prompts)
    _sync(device)
    t1 = time.perf_counter()
    out = engine.generate(session, args.gen)
    _sync(device)
    t2 = time.perf_counter()
    print(f"[serve] {cfg.name} on {device}: prefill "
          f"{args.batch}x{args.prompt_len} in {t1-t0:.2f}s; "
          f"decode {args.gen} toks in {t2-t1:.2f}s "
          f"({args.batch*args.gen/(t2-t1):.1f} tok/s)")
    print(f"[serve] sample outputs: {out[:, :8].tolist()}")
    print(f"[serve] engine clock sum: {float(engine.clock.clock.sum()):.0f}")

    if args.tiered:
        from repro_torch.serve import (AdmissionPipeline, TierConfig,
                                       TieredRegistry)
        tiers = TieredRegistry(
            TierConfig(hot_capacity=max(16, 4 * args.batch)),
            m=engine.clock.cfg.m, k=engine.clock.cfg.k,
            policy=dataclasses.replace(engine.clock.policy,
                                       fp_threshold=1.0),
            device=device)
        pipe = AdmissionPipeline(tiers, lambda: engine.clock.clock)
        try:
            ticket = pipe.submit(session["sid"],
                                 clock=session["clock"].clock)
            pipe.drain(timeout=60)
            v = ticket.result(1)
            q = pipe.submit(session["sid"], kind="query").result(60)
            print(f"[serve] tiered admission: {v.verdict} fp={v.fp:.3g} "
                  f"admitted={v.admitted} engine={v.engine}; "
                  f"query={q.verdict}; tiers={tiers.occupancy()}")
        finally:
            pipe.close()
            tiers.close()

    if args.hybrid:
        from repro_torch.hybrid import HybridConfig, HybridEngine
        hyb = HybridEngine(
            HybridConfig(m=max(128, engine.clock.cfg.m),
                         k=engine.clock.cfg.k,
                         hot_capacity=max(16, 4 * args.batch),
                         fp_budget=args.fp_budget),
            observer=obs, device=device)
        # mirror this run's decode steps into the local chain, then
        # register the serving sessions as prefixes of it
        hyb.advance_local(args.prompt_len + args.gen)
        for i in range(args.batch):
            hyb.admit(f"{session['sid']}/{i}",
                      v=min(args.prompt_len + i, hyb.local_version))
        for _ in range(3):
            for i in range(min(4, args.batch)):
                hyb.touch(f"{session['sid']}/{i}")
        view = hyb.classify()
        hot_n = int(view.hot.sum())
        print(f"[serve] hybrid classify[{view.engine}]: "
              f"{hot_n} hot (exact, fp=0) + {len(view.sids) - hot_n} tail "
              f"rows, tail m={hyb.m}, fp_budget={args.fp_budget:g}, "
              f"hot_fraction={hot_n / max(1, len(view.sids)):.2f}")

    if args.peers:
        from repro_torch.launch.peers import parse_peers, transport_from_specs
        specs = parse_peers(args.peers)
        transport = transport_from_specs(specs, exclude=args.replica_id)
        registry = engine.clock.make_registry(
            capacity=max(8, 2 * len(specs)))
        report = engine.clock.gossip(registry, transport=transport)
        print(f"[serve] gossip[{report.transport}] {report.summary()}")
        print(f"[serve] post-gossip clock sum: "
              f"{float(engine.clock.clock.sum()):.0f}")

    if obs is not None:
        obs.close()
        print(f"[serve] trace written to {args.trace_dir} "
              "(trace.jsonl, metrics.json, audit.jsonl)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
