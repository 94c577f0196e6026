"""Serving example on the PyTorch port: batched generation + clock-gated
session migration (``examples/serve_sessions.py`` over ``repro_torch``).

Two replicas serve the same model.  A session admitted on replica A
migrates to replica B (which shares causal history -> accepted) and is
refused by replica C (which doesn't -> stale-read prevented).

Run:  python examples/torch_serve_sessions.py [--device cpu]

Without ``--device`` the replicas serve on the CUDA card.  Weights and
prompts come from seeded ``torch.Generator``s, so the generated tokens
are not the JAX example's; the verdicts are.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.causal import CausalPolicy  # noqa: E402
from repro_torch.core import clock as bc  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.runtime.clock_runtime import ClockConfig  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: the card)")
    dev = resolve_device(ap.parse_args().device)

    cfg = ModelConfig(name="serve-demo", n_layers=2, d_model=128, n_heads=4,
                      n_kv_heads=2, d_head=32, d_ff=256, vocab=4096,
                      dtype="float32", attn_chunk=64)
    params = init_params(torch.Generator().manual_seed(0), cfg, dev)
    s_cfg = ServeConfig(max_batch=4, max_seq=96)
    c_cfg = ClockConfig(m=512, policy=CausalPolicy(fp_threshold=0.999999))

    rep_a = ServingEngine(params, cfg, s_cfg, c_cfg, replica_id="A",
                          device=dev)
    rep_b = ServingEngine(params, cfg, s_cfg, c_cfg, replica_id="B",
                          device=dev)
    rep_c = ServingEngine(params, cfg, s_cfg, c_cfg, replica_id="C",
                          device=dev)

    # keep B in the same gossip domain as A
    rep_b.clock.clock = bc.merge(rep_b.clock.clock, rep_a.clock.clock)

    prompts = torch.randint(0, cfg.vocab, (4, 16),
                            generator=torch.Generator().manual_seed(1))
    sess = rep_a.admit(prompts)
    toks = rep_a.generate(sess, 12)
    print(f"[serve] replica A generated: {tuple(toks.shape)} "
          f"first row: {toks[0].tolist()}")

    # gossip A -> B (replicas exchange clocks out-of-band, O(m) each)
    rep_b.clock.clock = bc.merge(rep_b.clock.clock, rep_a.clock.clock)
    ok_b, status_b, fp_b = rep_b.can_adopt(sess)
    print(f"[serve] migrate to B: {status_b} fp={fp_b:.2e} -> "
          f"{'ACCEPT' if ok_b else 'REFUSE'}")

    rep_c.clock.tick("own", "history")  # C has its own unrelated history
    ok_c, status_c, _ = rep_c.can_adopt(sess)
    print(f"[serve] migrate to C: {status_c} -> "
          f"{'ACCEPT' if ok_c else 'REFUSE'} (stale-read prevented)")

    assert ok_b and not ok_c


if __name__ == "__main__":
    main()
