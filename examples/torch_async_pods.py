"""Async multi-pod training (DiLoCo-style) with clock-guarded merges on
the PyTorch port (``examples/async_pods.py`` over ``repro_torch``).

Four pods train locally and sync through an outer optimizer.  Mid-run:
pod 2 stalls (straggler), pod 3 restores a stale snapshot and forks.
Watch the coordinator's decisions — made purely from O(m) bloom clocks.

Run:  python examples/torch_async_pods.py [--device cpu]

Without ``--device`` the pods and the coordinator live on the CUDA card
(the pods' ticks and the coordinator's one packed one-vs-many classify a
round launch the port's kernels).  Weights come from a seeded
``torch.Generator``, so the losses are not the JAX example's; the
verdicts are.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.causal import CausalPolicy  # noqa: E402
from repro_torch.core import clock as bc  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.runtime.async_trainer import (AsyncConfig,  # noqa: E402
                                               AsyncCoordinator,
                                               run_pod_round)
from repro_torch.runtime.clock_runtime import ClockConfig  # noqa: E402
from repro_torch.runtime.training import cross_entropy  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu for the plain versions (default: the card)")
    dev = resolve_device(ap.parse_args().device)

    cfg = ModelConfig(name="pods-demo", n_layers=2, d_model=128, n_heads=4,
                      n_kv_heads=4, d_head=32, d_ff=256, vocab=4096,
                      dtype="float32", attn_chunk=64)
    a_cfg = AsyncConfig(n_pods=4, local_steps=4, outer_lr=0.6)
    c_cfg = ClockConfig(m=512, straggler_gap=8.0,
                        policy=CausalPolicy(fp_threshold=1e-4))
    params = init_params(torch.Generator().manual_seed(0), cfg, dev)
    coord = AsyncCoordinator(params, a_cfg, c_cfg, device=dev)
    pods = coord.add_pods(list(range(a_cfg.n_pods)), c_cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4))

    def loss_fn(p, batch):
        logits, _ = T.forward_train(p, cfg, batch["tokens"])
        return cross_entropy(logits, batch["labels"], cfg.vocab)

    def sgd_step(p, batch):
        leaves = {k: w.detach().requires_grad_(True) for k, w in p.items()}
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return ({k: w.detach() - 3e-3 * g
                 for (k, w), g in zip(leaves.items(), grads)}, loss.detach())

    def data_fn(pod_id, step):
        return data.batch(step * a_cfg.n_pods + pod_id, device=dev)

    stale = None
    for rnd in range(8):
        deltas = {}
        for pod in pods:
            if rnd == 4 and pod.pod_id == 2:
                # straggler: no work this round
                deltas[pod.pod_id] = {k: torch.zeros_like(v)
                                      for k, v in coord.params.items()}
                continue
            if rnd == 4 and pod.pod_id == 3:
                # fork: restore the snapshot taken before round 3's commit
                pod.clock.clock = stale
            d, _ = run_pod_round(pod, sgd_step, data_fn, a_cfg, rnd * 100)
            deltas[pod.pod_id] = d
            if rnd == 3 and pod.pod_id == 3:
                stale = pod.clock.clock  # pre-commit snapshot
        decisions = coord.outer_step(pods, deltas)
        with torch.no_grad():
            loss = float(loss_fn({k: x.float() for k, x in coord.params.items()},
                                 data.batch(999, device=dev)))
        verdicts = {p: (("MERGED" if ok else f"REJECTED({why})"))
                    for p, (ok, why, _) in decisions.items()}
        print(f"[round {rnd}] eval_loss={loss:.4f} {verdicts}")

    # recover the forked pod: resync to the published union clock
    pods[3].clock.clock = bc.merge(pods[3].clock.clock, coord.clock.clock)
    pods[3].params = dict(coord.params)
    d, _ = run_pod_round(pods[3], sgd_step, data_fn, a_cfg, 900)
    deltas = {3: d}
    for pod in pods[:3]:
        deltas[pod.pod_id], _ = run_pod_round(pod, sgd_step, data_fn, a_cfg, 900)
    decisions = coord.outer_step(pods, deltas)
    print(f"[recovery] pod3 readmitted: {decisions[3][0]}")


if __name__ == "__main__":
    main()
