"""End-to-end training launcher with clock-stamped checkpointing and
fault-tolerant restart.

Example (the card, Qwen1.5-0.5B's full config):
  PYTHONPATH=src python -m repro_torch.launch.train --steps 12 \\
      --ckpt-dir CKPT_DIR --ckpt-every 4 --inject-failure 8

``--device cpu`` runs the same on the CPU (with ``--smoke``, a reduced
config, for a quick check); without ``--device`` the run takes the CUDA
card and fails where there is none.  Weights are random, drawn from
``--seed`` by a ``torch.Generator`` on the run's device.  The default
``--ckpt-dir`` lies under the temporary directory (``TMPDIR``).

Restart behavior: if ``--ckpt-dir`` holds a checkpoint, training resumes
from it — after the runtime verifies the checkpoint's bloom clock is
comparable with the live run's (``ClockRuntime.admit_restore``): an
ancestor within the fp gate, the same clock, or a descendant; a forked
checkpoint is refused.  ``--inject-failure N`` kills and restarts the
loop at step N to exercise the path.

The JAX launcher imports ``make_local_mesh``, ``DEFAULT_RULES`` and
``use_mesh_rules`` and calls none of them: it trains without a mesh.
So does this one; it sets up no process group.  A state is placed on a
mesh through ``launch.specs`` and stepped under ``sharding
.use_mesh_rules`` by the caller (``tests/test_torch_model_mesh_ranks.py``).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.causal import CausalPolicy
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import clock as bc
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime.clock_runtime import ClockConfig, ClockRuntime
from repro_torch.runtime.training import init_train_state, make_train_step


def build(args):
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(args.steps // 20, 5))
    # the launch spec names the causality policy explicitly: it is the
    # one source of truth the runtime threads through its registry,
    # gossip and checkpoint-lineage gates
    clock_cfg = ClockConfig(policy=CausalPolicy(fp_threshold=1e-4))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, run_id=args.run_id))
    return cfg, opt_cfg, clock_cfg, data


def train_loop(args) -> dict:
    cfg, opt_cfg, clock_cfg, data = build(args)
    device = resolve_device(args.device)
    runtime = ClockRuntime(clock_cfg, run_id=args.run_id, device=device)
    mgr = CheckpointManager(args.ckpt_dir, keep=3, run_id=args.run_id)

    step_fn = make_train_step(cfg, opt_cfg, clock_cfg,
                              num_microbatches=args.microbatches)
    state = init_train_state(torch.Generator(device).manual_seed(args.seed),
                             cfg, opt_cfg, clock_cfg, device=device)

    start_step = 0
    if mgr.latest_step() is not None:
        restored, manifest = mgr.restore(target_structure=state, device=device)
        # decoded on the runtime's device once: the gate and the merge
        # below both read it there
        ckpt_clock = ClockRuntime.clock_from_snapshot(manifest["clock"],
                                                      device=device)
        ok, status, fp = runtime.admit_restore(ckpt_clock)
        print(f"[train] restore step={manifest['step']} lineage={status} "
              f"fp={fp:.2e} admitted={ok}")
        if not ok:
            raise RuntimeError(f"refusing restore: lineage={status}")
        state = restored
        runtime.clock = bc.merge(runtime.clock, ckpt_clock)
        start_step = manifest["step"]

    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = data.batch(step, device=device)
        batch["ev_hi"], batch["ev_lo"] = data.event_id(step)
        runtime.tick_batch(step)
        state, metrics = step_fn(state, batch)
        runtime.tick_step(step)
        losses.append(float(metrics["loss"]))
        if args.log_every and step % args.log_every == 0:
            print(f"[train] step={step} loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"clock_sum={float(metrics['clock_sum']):.0f}")
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            runtime.tick_checkpoint(step + 1)
            mgr.save(step + 1, state, runtime.snapshot(), block=args.sync_ckpt)
        if args.inject_failure and step + 1 == args.inject_failure:
            mgr.wait()
            print(f"[train] INJECTED FAILURE at step {step + 1}; restarting")
            return _restart(args)
    mgr.wait()
    dt = time.time() - t0
    print(f"[train] done: {args.steps - start_step} steps in {dt:.1f}s, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"losses": losses, "final_state": state, "runtime": runtime}


def _restart(args):
    args2 = argparse.Namespace(**vars(args))
    args2.inject_failure = 0
    return train_loop(args2)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="qwen1_5_0_5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--run-id", type=str, default="run0")
    ap.add_argument("--ckpt-dir", type=str,
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--sync-ckpt", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--inject-failure", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    train_loop(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
