"""The port's async pod coordinator (``repro_torch.runtime.async_trainer``)
against the JAX package's on the CPU: the four cases of
``tests/test_integration.py::TestAsyncClockGuard``, each run by a JAX
and a port coordinator from the same params, pods, data and sequence.

Tolerances: decisions and statuses, registry rows (u8 residuals, bases,
sums, liveness), slots and coordinator clocks identical; fp within a
relative 5e-2 (Eq. 3 across math libraries); the coordinator's params
within rtol 2e-4 / atol 1e-6 (float32 SGD steps summed in each
framework's order, deltas rounded to bfloat16 on the wire, where a
float32 difference can move a delta by one bfloat16 ulp); the
compressed wire values of the same delta identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import clock as jbc  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig, SyntheticLM as JLM  # noqa: E402
from repro.models import transformer as JTr  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.runtime import async_trainer as JA  # noqa: E402
from repro.runtime.clock_runtime import ClockConfig as JClockConfig  # noqa: E402
from repro.runtime.training import cross_entropy as j_ce  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import clock as tbc  # noqa: E402
from repro_torch.data.pipeline import DataConfig as TDataConfig, SyntheticLM as TLM  # noqa: E402
from repro_torch.models import transformer as TTr  # noqa: E402
from repro_torch.runtime import async_trainer as TA  # noqa: E402
from repro_torch.runtime.clock_runtime import ClockConfig as TClockConfig, LineageStatus  # noqa: E402
from repro_torch.runtime.training import cross_entropy as t_ce  # noqa: E402

FP_RTOL = 5e-2
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)
ARCH = "qwen1_5_0_5b"


def jax_side(params, cfg32, a_cfg, c_cfg):
    coord = JA.AsyncCoordinator(params, a_cfg, c_cfg)
    pods = coord.add_pods(list(range(a_cfg.n_pods)), c_cfg)
    data = JLM(JDataConfig(vocab=cfg32.vocab, seq_len=32, global_batch=4))

    def loss_fn(p, batch):
        logits, _ = JTr.forward_train(p, cfg32, batch["tokens"])
        return j_ce(logits, batch["labels"], cfg32.vocab)

    @jax.jit
    def sgd_step(p, batch):
        l, g = jax.value_and_grad(loss_fn)(p, batch)
        return jax.tree.map(lambda w, gr: w - 2e-3 * gr, p, g), l

    return coord, pods, sgd_step, lambda pod_id, step: data.batch(step * 10 + pod_id)


def sgd_step_of(cfg):
    """The reference tests' SGD step on the port: grads of the CE by
    autograd with respect to the masters, w - 2e-3 g."""
    def sgd_step(p, batch):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        logits, _ = TTr.forward_train(leaves, cfg, batch["tokens"])
        loss = t_ce(logits, batch["labels"], cfg.vocab)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return ({k: w.detach() - 2e-3 * g for (k, w), g in zip(leaves.items(), grads)},
                loss.detach())
    return sgd_step


def port_side(params, cfg32, a_cfg, c_cfg):
    coord = TA.AsyncCoordinator(params, a_cfg, c_cfg, device="cpu")
    pods = coord.add_pods(list(range(a_cfg.n_pods)), c_cfg)
    data = TLM(TDataConfig(vocab=cfg32.vocab, seq_len=32, global_batch=4))
    return (coord, pods, sgd_step_of(cfg32),
            lambda pod_id, step: data.batch(step * 10 + pod_id, device="cpu"))


class Pair:
    """A JAX and a port coordinator over the same params and pods
    (``TestAsyncClockGuard._setup``)."""

    def __init__(self):
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype="float32")
        tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype="float32")
        jp = init_params(jax.random.PRNGKey(0), jcfg)
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
        self.a_cfg = JA.AsyncConfig(n_pods=3, local_steps=3, outer_lr=0.5)
        ta_cfg = TA.AsyncConfig(**dataclasses.asdict(self.a_cfg))
        kw = dict(m=256, fp_threshold=1.0 - 1e-6, straggler_gap=1e9)
        self.j = jax_side(jp, jcfg, self.a_cfg, JClockConfig(**kw))
        self.t = port_side(tp, tcfg, ta_cfg, TClockConfig(**kw))

    def round(self, base_step, who=None, zero=()):
        """Every pod (or ``who``'s) runs a round in both packages; the pods
        in ``zero`` send a zero delta instead.  Returns both deltas."""
        out = []
        for coord, pods, step, data_fn in (self.j, self.t):
            mod = JA if coord.__class__ is JA.AsyncCoordinator else TA
            deltas = {}
            for pod in pods:
                if who is not None and pod.pod_id not in who:
                    continue
                deltas[pod.pod_id], _ = mod.run_pod_round(
                    pod, step, data_fn, self.a_cfg, base_step)
            out.append(deltas)
        return out

    def outer(self, jd, td):
        dj = self.j[0].outer_step(self.j[1], jd)
        dt = self.t[0].outer_step(self.t[1], td)
        self.check(dj, dt)
        return dt

    def check(self, dj, dt):
        assert list(dt) == list(dj)
        for pid in dj:
            assert dt[pid][:2] == dj[pid][:2], (pid, dt[pid], dj[pid])
            np.testing.assert_allclose(dt[pid][2], dj[pid][2], rtol=FP_RTOL)
        jc, tc = self.j[0], self.t[0]
        for name in ("cells_u8", "base", "sums", "alive"):
            np.testing.assert_array_equal(getattr(tc.registry, name).numpy(),
                                          np.asarray(getattr(jc.registry, name)),
                                          err_msg=name)
        assert tc.registry._slot_of == jc.registry._slot_of
        np.testing.assert_array_equal(tc.clock.clock.logical_cells().numpy(),
                                      np.asarray(jc.clock.clock.logical_cells()))
        for k in jc.params:
            np.testing.assert_allclose(tc.params[k].numpy(),
                                       np.asarray(jc.params[k]), err_msg=k,
                                       **PARAM_TOL)


def test_compress_delta_wire_identical():
    """bfloat16 wire values and the float32 residuals of the same delta
    (and of a second one carrying the residual) are identical."""
    rng = np.random.default_rng(4)
    d = {"a": rng.normal(size=(6, 40)).astype(np.float32) * 1e-3,
         "b": rng.normal(size=(17,)).astype(np.float32)}
    jw, je = JA._compress_delta({k: jnp.asarray(v) for k, v in d.items()}, None)
    tw, te = TA._compress_delta({k: torch.from_numpy(v) for k, v in d.items()}, None)
    for step in range(2):
        for k in d:
            assert tw[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(tw[k].view(torch.int16).numpy(),
                                          np.asarray(jw[k]).view(np.int16))
            np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]))
        if step == 0:
            jw, je = JA._compress_delta({k: jnp.asarray(v) for k, v in d.items()}, je)
            tw, te = TA._compress_delta({k: torch.from_numpy(v) for k, v in d.items()}, te)


def test_healthy_pods_all_merge():
    p = Pair()
    jd, td = p.round(0)
    dt = p.outer(jd, td)
    assert all(ok for ok, _, _ in dt.values())


def test_elastic_pod_churn_never_exhausts_registry():
    """Retired pod ids free their registry slots: churning through more
    distinct pods than the slab holds keeps working, in step with the
    reference."""
    p = Pair()
    cap = p.t[0].registry.capacity
    assert cap == p.j[0].registry.capacity
    next_id = p.a_cfg.n_pods
    for rnd in range(3):
        jd, td = p.round(rnd)
        dt = p.outer(jd, td)
        assert all(ok for ok, _, _ in dt.values()), dt
        new = list(range(next_id, next_id + cap // 2))
        p.j = (p.j[0], p.j[0].add_pods(new, p.j[0].clock.cfg), *p.j[2:])
        p.t = (p.t[0], p.t[0].add_pods(new, p.t[0].clock.cfg), *p.t[2:])
        next_id += cap // 2
    assert len(p.t[0].registry) == len(p.j[0].registry) <= cap


def test_forked_pod_quarantined():
    """A pod restored from its pre-commit clock that then does local work
    is concurrent with the advanced coordinator: quarantined in both."""
    p = Pair()
    stale = []
    for side in (p.j, p.t):
        stale.append(next(pod for pod in side[1] if pod.pod_id == 2))
    jd, td = p.round(0)
    snaps = [pod.clock.clock for pod in stale]   # pre-commit state
    dt = p.outer(jd, td)
    assert all(ok for ok, _, _ in dt.values())
    for pod, snap in zip(stale, snaps):
        pod.clock.clock = snap
    jd, td = p.round(50)
    dt = p.outer(jd, td)
    assert dt[0][0] and dt[1][0]
    assert not dt[2][0] and dt[2][1] == LineageStatus.FORKED


def test_straggler_skipped_then_catches_up():
    p = Pair()
    for coord in (p.j[0], p.t[0]):
        coord.clock.cfg = dataclasses.replace(coord.clock.cfg, straggler_gap=4.0)
    jd, td = p.round(0, who={0, 1})
    jd[2] = jax.tree.map(jnp.zeros_like, jd[0])
    td[2] = {k: torch.zeros_like(v) for k, v in td[0].items()}
    dt = p.outer(jd, td)
    assert not dt[2][0] and dt[2][1] == "straggler"
    # pod 2 resyncs to the published union clock, works one round, and is
    # readmitted
    p.j[1][2].clock.clock = jbc.merge(p.j[1][2].clock.clock, p.j[0].clock.clock)
    p.t[1][2].clock.clock = tbc.merge(p.t[1][2].clock.clock, p.t[0].clock.clock)
    jd2, td2 = p.round(100)
    dt = p.outer(jd2, td2)
    assert dt[2][0], dt
