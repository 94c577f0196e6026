"""End-to-end driver on the PyTorch port: train a ~100M-param LM for a
few hundred steps with clock-stamped checkpoints and a mid-run failure
+ verified restart (``examples/train_100m.py`` over ``repro_torch``).

Pass --small for a quick demo (5M params, 60 steps).  Without
``--device`` the run takes the CUDA card (the bloom-clock tick inside
the step launches the port's tick kernel); ``--device cpu`` runs the
plain versions.  Weights come from a seeded ``torch.Generator``, so the
losses are not the JAX example's; the checkpoints, the restore line and
the final clock sum are.

Run:  python examples/torch_train_100m.py [--small] [--device cpu]
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.core import clock as bc  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.runtime.clock_runtime import ClockConfig, ClockRuntime  # noqa: E402
from repro_torch.runtime.training import init_train_state, make_train_step  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="5M params / 60 steps instead of ~100M / 300")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: the card)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    if args.small:
        cfg = ModelConfig(name="demo-5m", n_layers=4, d_model=128, n_heads=4,
                          n_kv_heads=4, d_head=32, d_ff=512, vocab=8192,
                          attn_chunk=128)
        steps, seq, batch = 60, 128, 8
    else:
        # ~100M dense LM (GPT-2-small-ish, llama-style blocks)
        cfg = ModelConfig(name="demo-100m", n_layers=12, d_model=768,
                          n_heads=12, n_kv_heads=12, d_head=64, d_ff=2048,
                          vocab=32768, attn_chunk=256)
        steps, seq, batch = 300, 256, 8
    print(f"[example] {cfg.name}: {cfg.n_params()/1e6:.1f}M params")

    opt_cfg = OptConfig(lr=3e-3, total_steps=steps, warmup_steps=steps // 20)
    clock_cfg = ClockConfig()
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, run_id="ex100m"))
    runtime = ClockRuntime(clock_cfg, run_id="ex100m", device=dev)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_ex_")
    mgr = CheckpointManager(ckpt_dir, run_id="ex100m")

    step_fn = make_train_step(cfg, opt_cfg, clock_cfg)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, opt_cfg,
                             clock_cfg, device=dev)

    ckpt_every = max(10, steps // 6)
    fail_at = ckpt_every + ckpt_every // 2  # after the first checkpoint
    step = 0
    restarted = False
    while step < steps:
        b = data.batch(step, device=dev)
        b["ev_hi"], b["ev_lo"] = data.event_id(step)
        runtime.tick_batch(step)
        state, metrics = step_fn(state, b)
        runtime.tick_step(step)
        if step % 20 == 0:
            print(f"[example] step={step:4d} loss={float(metrics['loss']):.4f} "
                  f"lr={float(metrics['lr']):.2e}")
        step += 1
        if step % ckpt_every == 0:
            runtime.tick_checkpoint(step)
            mgr.save(step, state, runtime.snapshot(), block=True)
        if step == fail_at and not restarted:
            print(f"[example] *** simulated preemption at step {step} ***")
            restarted = True
            # new process: fresh runtime, restore from latest checkpoint
            runtime = ClockRuntime(clock_cfg, run_id="ex100m", device=dev)
            restored, manifest = mgr.restore(target_structure=state,
                                             device=dev)
            ck = ClockRuntime.clock_from_snapshot(manifest["clock"],
                                                  device=dev)
            ok, status, fp = runtime.admit_restore(ck)
            print(f"[example] restore step={manifest['step']} lineage={status} "
                  f"admitted={ok}")
            assert ok
            state = restored
            runtime.clock = bc.merge(runtime.clock, ck)
            step = manifest["step"]
    print(f"[example] done. final loss ~{float(metrics['loss']):.4f}; "
          f"clock sum {float(bc.clock_sum(runtime.clock)):.0f}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
