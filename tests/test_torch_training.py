"""The port's training step (``repro_torch.optim``, ``runtime.training``,
``data.pipeline``, the differentiable forward of ``models.transformer``)
against the JAX package's on the CPU.

Both packages start from one state: the JAX package's ``TrainState``
carried across by ``convert.train_state_from_jax``; the batches of both
``SyntheticLM`` streams are identical.  Tolerances, each stated where it
is used:

- identical: int8 moment codes and scales, the data stream and event
  ids, clock cells, the step counter, checkpoint keys;
- ``cosine_lr`` and one ``adamw_update`` on the same inputs: rtol 1e-6
  (the two libms may differ by an ulp in ``cos`` and ``pow``);
- train steps at float32 compute: loss, grad norm and params within
  rtol 2e-4 / atol 2e-5, the tolerance of the reference's own
  ``test_microbatched_grads_match`` (the frameworks sum the products
  and reductions in different orders);
- within the port (chunked against monolithic CE, microbatches, the
  three remat policies): rtol 1e-5 / atol 1e-6.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.runtime import training as JT  # noqa: E402
from repro.runtime.clock_runtime import ClockConfig as JClockConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.runtime import training as TT  # noqa: E402
from repro_torch.runtime.clock_runtime import ClockConfig as TClockConfig  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
ARCH = "qwen1_5_0_5b"
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
PORT_TOL = dict(rtol=1e-5, atol=1e-6)


def smoke_pair(arch=ARCH, **kw):
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), **kw),
            dataclasses.replace(tconfigs.get_smoke_config(arch), **kw))


def host_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_batch(data, step):
    b = data.batch(step)
    hi, lo = data.event_id(step)
    b["ev_hi"], b["ev_lo"] = jnp.uint32(hi), jnp.uint32(lo)
    return b


def torch_batch(data, step):
    b = data.batch(step, device="cpu")
    b["ev_hi"], b["ev_lo"] = data.event_id(step)
    return b


def streams(vocab, seq=32, batch=8):
    return (JD.SyntheticLM(JD.DataConfig(vocab=vocab, seq_len=seq,
                                         global_batch=batch)),
            TD.SyntheticLM(TD.DataConfig(vocab=vocab, seq_len=seq,
                                         global_batch=batch)))


def start(jcfg, tcfg, opt=dict(lr=1e-3, total_steps=10), m=64, seed=0):
    """The reference's fresh state and the same state in the port."""
    jst = JT.init_train_state(jax.random.PRNGKey(seed), jcfg,
                              JA.OptConfig(**opt), JClockConfig(m=m))
    return jst, convert.train_state_from_jax(host_tree(jst), tcfg, device="cpu")


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_cosine_lr_matches_reference():
    """Steps 0, inside the warmup, at its end, mid-decay, at and past
    the total: rtol 1e-6."""
    cfg_j = JA.OptConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    cfg_t = TA.OptConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    for step in (0, 3, 10, 55, 100, 250):
        np.testing.assert_allclose(float(TA.cosine_lr(cfg_t, step)),
                                   float(JA.cosine_lr(cfg_j, step)),
                                   rtol=1e-6, err_msg=str(step))


def test_quantized_moment_codes_and_scales_identical():
    """Codes and scales of the same float32 values are identical (both
    round half to even), including exact halves and padded rows."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 5, 200)).astype(np.float32)
    x[0, 0, :128] = np.arange(128, dtype=np.float32) - 63.5   # exact .5 codes
    jm = JA.Moment.of(jnp.asarray(x))
    tm = TA.Moment.of(torch.from_numpy(x))
    assert tm.d == jm.d == 200
    assert tm.codes.dtype == torch.int8 and tm.scale.dtype == torch.float32
    np.testing.assert_array_equal(tm.codes.numpy(), np.asarray(jm.codes))
    np.testing.assert_array_equal(tm.scale.numpy(), np.asarray(jm.scale))
    np.testing.assert_array_equal(tm.value().numpy(), np.asarray(jm.value()))


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_adamw_update_matches_reference(state_dtype):
    """One update from the same params, grads and state (a second update
    on top of it for the moments' history): params and moments within
    rtol 1e-6, int8 codes identical, metrics within rtol 1e-6.  Grads
    are scaled so the global norm stays below the clip (the clip factor
    is then exactly 1 in both)."""
    jcfg, tcfg = smoke_pair()
    from repro.models.params import init_params
    jp = init_params(jax.random.PRNGKey(1), jcfg)
    tp = convert.params_from_jax(host_tree(jp), tcfg, device="cpu")
    rng = np.random.default_rng(5)
    opt_j = JA.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                         state_dtype=state_dtype)
    opt_t = TA.OptConfig(**dataclasses.asdict(opt_j))
    js, ts = JA.init_opt_state(jp, opt_j), TA.init_opt_state(tp, opt_t)
    for _ in range(2):
        g = {k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32)
             for k, v in jp.items()}
        jp, js, jm = JA.adamw_update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                     js, opt_j)
        tp, ts, tm = TA.adamw_update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                                     ts, opt_t)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)
        for k in jp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
            for name in ("m", "v"):
                jx, tx = js[name][k], ts[name][k]
                if state_dtype == "int8" and isinstance(jx, JA.Moment):
                    assert isinstance(tx, TA.Moment), k
                    np.testing.assert_array_equal(tx.codes.numpy(),
                                                  np.asarray(jx.codes))
                    np.testing.assert_allclose(tx.scale.numpy(),
                                               np.asarray(jx.scale), rtol=1e-6)
                else:
                    assert not isinstance(tx, TA.Moment), k
                    np.testing.assert_allclose(tx.numpy(), np.asarray(jx),
                                               rtol=1e-6, atol=1e-12)
        assert int(ts["step"]) == int(js["step"])


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def test_cross_entropy_masks_out_of_range_labels():
    """Labels -1 and >= vocab: the loss equals the reference's (which
    fills its gather and masks), the port raises nothing, and the
    gradient is zero at those positions (rtol 1e-6)."""
    rng = np.random.default_rng(7)
    V = 50
    logits = rng.normal(size=(2, 6, V)).astype(np.float32) * 3
    labels = rng.integers(0, V, (2, 6)).astype(np.int32)
    labels[0, 1], labels[1, 4], labels[1, 5] = -1, V, V + 17
    jl, jg = jax.value_and_grad(lambda x: JT.cross_entropy(
        x, jnp.asarray(labels), V))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    tl = TT.cross_entropy(x, torch.from_numpy(labels), V)
    (tg,) = torch.autograd.grad(tl, x)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-8)
    for b, s in ((0, 1), (1, 4), (1, 5)):
        assert not tg[b, s].any()


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def run_both(jcfg, tcfg, n_steps, opt=dict(lr=1e-3, total_steps=10), **kw):
    """``n_steps`` of both packages' steps from one state on identical
    batches (a vlm config's prefix embeddings and an enc-dec config's
    frames drawn from a seed)."""
    jst, tst = start(jcfg, tcfg, opt)
    jdata, tdata = streams(jcfg.vocab)
    jstep = jax.jit(JT.make_train_step(jcfg, JA.OptConfig(**opt),
                                       JClockConfig(m=64), **kw))
    tstep = TT.make_train_step(tcfg, TA.OptConfig(**opt), TClockConfig(m=64), **kw)
    metrics = []
    for s in range(n_steps):
        jb, tb = jax_batch(jdata, s), torch_batch(tdata, s)
        if jcfg.n_prefix:
            pfx = np.random.default_rng(s).standard_normal(
                (8, jcfg.n_prefix, jcfg.d_model)).astype(np.float32)
            jb["prefix_embeds"], tb["prefix_embeds"] = (jnp.asarray(pfx),
                                                        torch.from_numpy(pfx))
        if jcfg.is_encdec:
            fr = np.random.default_rng(100 + s).standard_normal(
                (8, jcfg.enc_seq, jcfg.d_model)).astype(np.float32)
            jb["enc_frames"], tb["enc_frames"] = (jnp.asarray(fr),
                                                  torch.from_numpy(fr))
        jst, jm = jstep(jst, jb)
        tst, tm = tstep(tst, tb)
        metrics.append((jm, tm))
    return jst, tst, metrics


@pytest.mark.parametrize("arch,n_steps", [
    pytest.param(ARCH, 1, id="1"), pytest.param(ARCH, 3, id="3"),
    *(pytest.param(a, n, id=f"{a}-{n}") for a, n in (
        ("stablelm_1_6b", 1), ("granite_20b", 1), ("pixtral_12b", 1),
        ("grok_1_314b", 1), ("deepseek_v2_236b", 1),
        ("deepseek_v2_236b", 3), ("mamba2_130m", 1), ("hymba_1_5b", 1),
        ("hymba_1_5b", 3), ("whisper_large_v3", 2)))])
def test_train_steps_match_reference(arch, n_steps):
    """One and three steps at float32 compute under OptConfig(total_steps
    =10)'s warmup, for the dense and vlm smoke configs, both ``moe``
    ones (whose router aux enters the loss with ``aux_coef`` and carries
    a gradient into the router), the ``ssm`` and ``hybrid`` ones
    (the SSD at the smoke chunk, 16, where the reference's gradient is
    finite) and the ``encdec`` one (frames through the encoder, two
    steps): loss, aux and grad norm per step and
    every param within rtol 2e-4 / atol 2e-5; clock cells, the step and
    lr identical."""
    jcfg, tcfg = smoke_pair(arch, dtype="float32")
    jst, tst, metrics = run_both(jcfg, tcfg, n_steps)
    for jm, tm in metrics:
        for key in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), **STEP_TOL)
        assert (float(tm["aux"]) > 0) == (jcfg.family == "moe")
        assert float(tm["lr"]) == float(jm["lr"])
        assert float(tm["clock_sum"]) == float(jm["clock_sum"])
    for k in jst.params:
        np.testing.assert_allclose(tst.params[k].numpy(),
                                   np.asarray(jst.params[k]), err_msg=k,
                                   **STEP_TOL)
    np.testing.assert_array_equal(tst.clock_cells.numpy(),
                                  np.asarray(jst.clock_cells))
    assert int(tst.step) == int(jst.step) == n_steps
    assert int(tst.opt["step"]) == int(jst.opt["step"]) == n_steps


def test_train_step_bfloat16_matches_reference():
    """The configs' own bfloat16 compute: the loss within 2e-2 relative
    (bfloat16 products rounded in each framework's own places), the
    clock identical."""
    jcfg, tcfg = smoke_pair()
    jst, tst, metrics = run_both(jcfg, tcfg, 1)
    (jm, tm), = metrics
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-2)
    np.testing.assert_array_equal(tst.clock_cells.numpy(),
                                  np.asarray(jst.clock_cells))


def test_moe_train_step_bf16_masters_int8_moments_match_reference():
    """The full ``moe`` configs' memory policy on DeepSeek's smoke config:
    bfloat16 masters, bfloat16 compute and ``OptConfig(state_dtype=
    "int8")``, two steps.  Loss, aux and grad norm within 2e-2 relative
    (bfloat16 products rounded in each framework's own places).  Params
    stay bfloat16 and lie within four bfloat16 ulps (rtol 2^-5, atol
    1e-3) wherever the reference's second moment exceeds 1e-9; where it
    does not, an int8 code of 0 on one side and 1 on the other divides
    Adam's m by sqrt(v) + eps of very different sizes, so there only
    0.1% of all elements may part (37 of 191,456 did).  The moments
    stay int8 ``Moment``s of the reference's shapes; clock cells and
    steps identical."""
    opt = dict(lr=1e-3, total_steps=10, state_dtype="int8")
    jcfg, tcfg = smoke_pair("deepseek_v2_236b", param_dtype="bfloat16")
    jst, tst, metrics = run_both(jcfg, tcfg, 2, opt=opt)
    for jm, tm in metrics:
        for key in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=2e-2)
    parted = total = 0
    for k in jst.params:
        assert tst.params[k].dtype == torch.bfloat16, k
        got = tst.params[k].float().numpy()
        want = np.asarray(jst.params[k], np.float32)
        v = jst.opt["v"][k]
        well = np.asarray(v.value() if hasattr(v, "value") else v) > 1e-9
        np.testing.assert_allclose(got[well], want[well], rtol=2 ** -5,
                                   atol=1e-3, err_msg=k)
        parted += int((np.abs(got - want) > 1e-3 + 2 ** -5 * np.abs(want)).sum())
        total += want.size
    assert parted <= 1e-3 * total, (parted, total)
    for name in ("m", "v"):
        got, want = tst.opt[name]["lm_head"], jst.opt[name]["lm_head"]
        assert isinstance(got, TA.Moment) and got.codes.dtype == torch.int8
        assert (got.codes.shape, got.scale.shape, got.d) == (
            want.codes.shape, want.scale.shape, want.d)
    np.testing.assert_array_equal(tst.clock_cells.numpy(),
                                  np.asarray(jst.clock_cells))
    assert int(tst.step) == int(jst.step) == 2


def port_step(tcfg, n_micro=1, state=None):
    """One port step from the reference's seed-0 state."""
    _, tst = start(*smoke_pair(dtype="float32"))
    _, tdata = streams(tcfg.vocab)
    step = TT.make_train_step(tcfg, TA.OptConfig(lr=1e-3, total_steps=10),
                              TClockConfig(m=64), num_microbatches=n_micro)
    return step(state if state is not None else tst, torch_batch(tdata, 0))


def assert_states_close(a, b, tol=PORT_TOL):
    for k in a.params:
        np.testing.assert_allclose(a.params[k].numpy(), b.params[k].numpy(),
                                   err_msg=k, **tol)
    assert torch.equal(a.clock_cells, b.clock_cells)


def test_ce_chunk_matches_monolithic_loss():
    """``ce_chunk`` (chunks of 8 over seq 32, and 12 with a padded tail)
    against the monolithic CE: loss and params within rtol 1e-5."""
    _, tcfg = smoke_pair(dtype="float32")
    s0, m0 = port_step(tcfg)
    for chunk in (8, 12):
        s1, m1 = port_step(dataclasses.replace(tcfg, ce_chunk=chunk))
        np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]), **PORT_TOL)
        assert_states_close(s1, s0)


def test_ce_chunk_matches_reference():
    """The chunked loss of both packages (chunk 12: a padded tail),
    float32: rtol 2e-4 / atol 2e-5."""
    jcfg, tcfg = smoke_pair(dtype="float32", ce_chunk=12)
    jst, tst, metrics = run_both(jcfg, tcfg, 1)
    (jm, tm), = metrics
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **STEP_TOL)
    for k in jst.params:
        np.testing.assert_allclose(tst.params[k].numpy(),
                                   np.asarray(jst.params[k]), err_msg=k,
                                   **STEP_TOL)


def test_microbatches_match_one_batch():
    """4 microbatches against 1 (the reference's
    ``test_microbatched_grads_match`` on the port): loss within rtol
    1e-4, params within rtol 2e-4 / atol 2e-5."""
    _, tcfg = smoke_pair(dtype="float32")
    s1, m1 = port_step(tcfg, 1)
    s4, m4 = port_step(tcfg, 4)
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]), rtol=1e-4)
    assert_states_close(s4, s1, STEP_TOL)


def test_microbatches_match_reference():
    jcfg, tcfg = smoke_pair(dtype="float32")
    jst, tst, metrics = run_both(jcfg, tcfg, 1, num_microbatches=4)
    (jm, tm), = metrics
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **STEP_TOL)
    for k in jst.params:
        np.testing.assert_allclose(tst.params[k].numpy(),
                                   np.asarray(jst.params[k]), err_msg=k,
                                   **STEP_TOL)


def test_remat_policies_give_the_same_step():
    """"nothing" (checkpoint each layer), "dots" (save the projections)
    and "full" (save everything): the same loss and params, and the
    unstacked layout (``scan_layers=False``) too (rtol 1e-5)."""
    _, tcfg = smoke_pair(dtype="float32")
    assert tcfg.remat_policy == "nothing"
    s0, m0 = port_step(tcfg)
    for policy in ("dots", "full"):
        s1, m1 = port_step(dataclasses.replace(tcfg, remat_policy=policy))
        np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]), **PORT_TOL)
        np.testing.assert_allclose(float(m1["grad_norm"]), float(m0["grad_norm"]),
                                   **PORT_TOL)
        assert_states_close(s1, s0)


def test_unstacked_layout_matches_reference():
    """``scan_layers=False`` (``layers_{i}/...`` params): one step at
    float32 within rtol 2e-4 / atol 2e-5 of the reference's."""
    jcfg, tcfg = smoke_pair(dtype="float32", scan_layers=False)
    jst, tst, metrics = run_both(jcfg, tcfg, 1)
    (jm, tm), = metrics
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **STEP_TOL)
    for k in jst.params:
        np.testing.assert_allclose(tst.params[k].numpy(),
                                   np.asarray(jst.params[k]), err_msg=k,
                                   **STEP_TOL)


def test_families_not_yet_ported_raise():
    """Both packages refuse a train step of an enc-dec config whose
    batch has no ``enc_frames``: the reference with an
    ``AttributeError`` (its encoder reads ``None``), the port with a
    ``ValueError`` naming ``enc_frames``."""
    for arch in ("whisper_large_v3",):
        jcfg, tcfg = smoke_pair(arch, dtype="float32")
        jst, tst = start(jcfg, tcfg)
        jdata, tdata = streams(jcfg.vocab)
        jstep = JT.make_train_step(jcfg, JA.OptConfig(), JClockConfig(m=64))
        with pytest.raises(AttributeError):
            jstep(jst, jax_batch(jdata, 0))
        tstep = TT.make_train_step(tcfg, TA.OptConfig(), TClockConfig(m=64))
        with pytest.raises(ValueError, match="enc_frames"):
            tstep(tst, torch_batch(tdata, 0))


def test_grads_reach_the_masters_through_the_casts():
    """bfloat16 compute: the gradient of a float32 master is float32 and
    nonzero, the cast to the compute dtype being inside the graph."""
    _, tcfg = smoke_pair()
    _, tst = start(*smoke_pair())
    from repro_torch.models import transformer as T
    leaves = {k: v.detach().requires_grad_(True) for k, v in tst.params.items()}
    logits, _ = T.forward_train(leaves, tcfg, torch.zeros((2, 8), dtype=torch.int32))
    assert logits.dtype == torch.bfloat16
    logits.float().square().mean().backward()
    for k, v in leaves.items():
        assert v.grad is not None and v.grad.dtype == torch.float32, k
    assert leaves["layers/attn/wq"].grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,host_id,n_hosts",
                         [(1234, 0, 0, 1), (7, 41, 1, 2), (1234, 3, 3, 4)])
def test_synthetic_batches_identical(seed, step, host_id, n_hosts):
    jd = JD.SyntheticLM(JD.DataConfig(vocab=97, seq_len=16, global_batch=8,
                                      seed=seed, run_id="r1"))
    td = TD.SyntheticLM(TD.DataConfig(vocab=97, seq_len=16, global_batch=8,
                                      seed=seed, run_id="r1"))
    jb = jd.batch(step, host_id, n_hosts)
    tb = td.batch(step, host_id, n_hosts, device="cpu")
    for key in ("tokens", "labels"):
        assert tb[key].dtype == torch.int32
        np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))
    assert td.event_id(step) == jd.event_id(step)
    assert TD.batch_event_id("r1", step) == JD.batch_event_id("r1", step)


# ---------------------------------------------------------------------------
# the reference's training integration cases, on the port
# ---------------------------------------------------------------------------

def test_loss_decreases():
    """``tests/test_integration.py``'s loss-decreases case on the port:
    40 steps at lr 3e-3, batch 8, seq 64; the loss falls by more than
    0.5 and the clock ticked k times a step."""
    _, tcfg = smoke_pair()
    opt = TA.OptConfig(lr=3e-3, total_steps=40)
    ck = TClockConfig(m=128)
    state = TT.init_train_state(torch.Generator().manual_seed(0), tcfg, opt, ck,
                                device="cpu")
    step_fn = TT.make_train_step(tcfg, opt, ck)
    _, data = streams(tcfg.vocab, seq=64)
    losses = []
    for s in range(40):
        state, m = step_fn(state, torch_batch(data, s))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5
    assert int(state.clock_cells.sum()) == 40 * ck.k


def test_int8_state_checkpoint_keys_match_reference(tmp_path):
    """An int8-moment state saved by each package: the npz keys (with
    ``<path>/0`` codes and ``<path>/1`` scales), shapes and dtypes are
    identical."""
    from repro.checkpoint.manager import CheckpointManager as JM
    from repro_torch.checkpoint.manager import CheckpointManager as TM
    from repro_torch.runtime.clock_runtime import ClockRuntime

    jcfg, tcfg = smoke_pair()
    jst, tst = start(jcfg, tcfg, opt=dict(total_steps=10, state_dtype="int8"))
    assert isinstance(tst.opt["m"]["layers/mlp/w_up"], TA.Moment)
    snap = ClockRuntime(TClockConfig(m=64), device="cpu").snapshot()
    JM(str(tmp_path / "j")).save(1, jst, snap, block=True)
    TM(str(tmp_path / "t")).save(1, tst, snap, block=True)
    with np.load(tmp_path / "j" / "step_1" / "state.npz") as j, \
            np.load(tmp_path / "t" / "step_1" / "state.npz") as t:
        assert list(t.keys()) == list(j.keys())
        assert "1/m/layers/mlp/w_up/0" in j and "1/v/layers/mlp/w_up/1" in j
        for key in j.keys():
            assert (t[key].dtype, t[key].shape) == (j[key].dtype, j[key].shape), key
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)


# ---------------------------------------------------------------------------
# the launcher, in a process that cannot import JAX
# ---------------------------------------------------------------------------

def test_train_launcher_restarts_without_jax(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu`` with a
    checkpoint every 4 steps and a failure injected at step 8: the
    restart restores step 8 as a descendant of the fresh runtime's
    empty clock, admitted, and no module imports JAX."""
    fake = tmp_path / "nojax" / "jax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text(
        "raise ImportError('this process must not import jax')\n")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(fake.parent), SRC])}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "12", "--batch", "4", "--seq", "32",
         "--ckpt-every", "4", "--inject-failure", "8",
         "--ckpt-dir", str(tmp_path / "ckpt")],
        env=env, capture_output=True, text=True, timeout=120)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert "[train] INJECTED FAILURE at step 8; restarting" in out
    assert "[train] restore step=8 lineage=descendant fp=1.00e+00 admitted=True" in out
    assert "[train] done: 4 steps" in out
    assert "must not import jax" not in out
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_12", "step_4", "step_8"]
