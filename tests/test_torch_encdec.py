"""The port's enc-dec family (whisper: ``models.transformer``'s
``Encoder``, the decoder's cross-attention and its ``CrossCache``)
against the JAX package's on the CPU.

The same numpy-seeded tokens and frame embeddings and the same weights
(the JAX package's ``init_params``, carried across by
``convert.params_from_jax``) go through the JAX function (under
``jit``) and the port's, at whisper's smoke config (2 + 2 layers, d 64,
enc_seq 16, attn_chunk 64).  Tolerances:

- float32 compute against the reference: ``F32_TOL`` (rtol = atol =
  1e-5), as ``tests/test_torch_models.py``;
- bfloat16 compute: ``BF16_TOL`` (atol 6.25e-2, rtol 2e-2), as there;
- the port's own prefill and decode against its teacher-forced logits:
  rtol = atol = 2e-4, as ``tests/test_archs.py``;
- train steps at float32: rtol 2e-4 / atol 2e-5, as
  ``tests/test_torch_training.py``; clock cells identical;
- greedy tokens, cache shapes, lengths, positions and checkpoint leaves:
  identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as JOpt  # noqa: E402
from repro.runtime import training as JTr  # noqa: E402
from repro.runtime.clock_runtime import ClockConfig as JClockConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager as TManager  # noqa: E402
from repro_torch.checkpoint.manager import _leaves  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw as TOpt  # noqa: E402
from repro_torch.runtime import clock_runtime as TR  # noqa: E402
from repro_torch.runtime import training as TTr  # noqa: E402

ARCH = "whisper_large_v3"
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=6.25e-2)
PORT_TOL = dict(rtol=2e-4, atol=2e-4)
STEP_TOL = dict(rtol=2e-4, atol=2e-5)


def smoke_pair(**kw):
    """Whisper's smoke config in both packages, with ``kw`` replaced."""
    return (dataclasses.replace(jconfigs.get_smoke_config(ARCH), **kw),
            dataclasses.replace(tconfigs.get_smoke_config(ARCH), **kw))


def weights(jcfg, tcfg, seed=0):
    jp = JP.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                 tcfg, device="cpu")
    return jp, tp


def frames(cfg, batch=2, seed=5, seq=None):
    """Frame embeddings [batch, seq (enc_seq), d_model], float32."""
    return np.random.default_rng(seed).standard_normal(
        (batch, seq or cfg.enc_seq, cfg.d_model)).astype(np.float32)


def tokens(cfg, shape=(2, 12), seed=7):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_close(j, t, tol=F32_TOL, what=""):
    np.testing.assert_allclose(host(t), host(j), err_msg=what, **tol)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("se", [16, 100])
def test_attn_block_cross_matches_reference(se):
    """``attn_block`` with ``xa``: K and V from the source, no RoPE,
    non-causal, ``kv_valid`` the source's length; at Se = 100 the source
    pads to two chunks of 64, the tail masked.  The new (k, v) have the
    source's length; a cross call leaves a self-attention cache as it
    was."""
    jcfg, tcfg = smoke_pair(dtype="float32")
    jp, tp = weights(jcfg, tcfg)
    x = frames(jcfg, seq=5, seed=1)
    xa = frames(jcfg, seq=se, seed=2)
    blk = {k: v[0] for k, v in JL.sub(jp, "layers").items()}
    jo, (jk, jv) = jax.jit(lambda p, x, xa: JA.attn_block(
        p, jcfg, x, positions=jnp.arange(5), causal=False, xa=xa))(
        JL.sub(blk, "cross"), jnp.asarray(x), jnp.asarray(xa))
    tblk = TT.layer_params(tp, tcfg, 0)
    cache = TA.init_cache(tcfg, 2, 8, tcfg.n_kv_heads, tcfg.d_head)
    to, (tk, tv) = TA.attn_block(TL.sub(tblk, "cross"), tcfg,
                                 torch.from_numpy(x), positions=torch.arange(5),
                                 causal=False, cache=cache,
                                 xa=torch.from_numpy(xa))
    assert tuple(tk.shape) == jk.shape == (2, se, tcfg.n_kv_heads, tcfg.d_head)
    assert_close(jo, to, what="cross out")
    assert_close(jk, tk, what="cross k")
    assert_close(jv, tv, what="cross v")
    assert cache.length == cache.pos == 0 and not cache.k.any()


def test_cross_from_cache_matches_reference():
    """``_cross_from_cache`` (the decode path) on a layer's cross leaves
    and cached K/V: the reference's one-shot attention over every cached
    key."""
    jcfg, tcfg = smoke_pair(dtype="float32")
    jp, tp = weights(jcfg, tcfg)
    x = frames(jcfg, seq=1, seed=3)
    ck, cv = (np.random.default_rng(s).standard_normal(
        (2, jcfg.enc_seq, jcfg.n_kv_heads, jcfg.d_head)).astype(np.float32)
        for s in (4, 6))
    blk = {k: v[1] for k, v in JL.sub(jp, "layers").items()}
    jo = jax.jit(lambda *a: JT._cross_from_cache(*a[:1], jcfg, *a[1:]))(
        blk, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv))
    to = TT._cross_from_cache(TL.sub(TT.layer_params(tp, tcfg, 1), "cross"),
                              tcfg, torch.from_numpy(x), torch.from_numpy(ck),
                              torch.from_numpy(cv))
    assert_close(jo, to)


@pytest.mark.parametrize("dtype,scan", [
    ("float32", True), ("float32", False), ("bfloat16", True),
    ("bfloat16", False)])
def test_encode_matches_reference(dtype, scan):
    """The encoder in both layouts (stacked ``enc_layers/...`` and
    ``enc_layers_{i}/...``): the frames cast to the compute dtype, the
    positions added in it, the layers, the final norm."""
    jcfg, tcfg = smoke_pair(dtype=dtype, scan_layers=scan)
    jp, tp = weights(jcfg, tcfg)
    fr = frames(jcfg)
    je = jax.jit(lambda p, f: JT.encode(p, jcfg, f))(jp, jnp.asarray(fr))
    te = TT.encode(tp, tcfg, torch.from_numpy(fr))
    assert te.dtype == tcfg.compute_dtype and tuple(te.shape) == je.shape
    model = TT.build(tp, tcfg)
    assert len(model.encoder.layers) == tcfg.n_enc_layers
    assert_close(je, te, F32_TOL if dtype == "float32" else BF16_TOL)


def test_norm_cross_is_held_in_float32():
    """``norm_cross`` (the cross-attention's pre-norm) is a norm leaf:
    held in float32 under bfloat16 compute, as the reference reads it;
    the cross projections in bfloat16."""
    assert TT.held_f32("norm_cross/scale") and TT.held_f32("norm_cross/bias")
    assert not TT.held_f32("cross/wq")
    _, tcfg = smoke_pair()
    _, tp = weights(*smoke_pair())
    layer = TT.build(tp, tcfg).layers[0]
    assert layer.norm_cross.scale.dtype == torch.float32
    assert layer.cross.wk.dtype == torch.bfloat16
    assert not layer.cross.causal


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_matches_reference(dtype):
    jcfg, tcfg = smoke_pair(dtype=dtype)
    jp, tp = weights(jcfg, tcfg)
    tok, fr = tokens(jcfg), frames(jcfg)
    jl, _ = jax.jit(lambda p, t, f: JT.forward_train(p, jcfg, t, enc_frames=f))(
        jp, jnp.asarray(tok), jnp.asarray(fr))
    tl, taux = TT.forward_train(tp, tcfg, torch.from_numpy(tok),
                                enc_frames=torch.from_numpy(fr))
    assert tl.dtype == tcfg.compute_dtype and tuple(tl.shape) == jl.shape
    assert float(taux) == 0.0
    assert_close(jl, tl, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    """prefill's logits, its self-attention K/V and its cross K/V, then
    three decode steps through ``_cross_from_cache`` fed the reference's
    greedy tokens, which the port's must equal; the cross cache is read,
    never written."""
    jcfg, tcfg = smoke_pair(dtype=dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jp, tp = weights(jcfg, tcfg)
    tok, fr = tokens(jcfg, (2, 8)), frames(jcfg)
    jlp, jc = jax.jit(lambda p, t, f: JT.prefill(p, jcfg, t, enc_frames=f,
                                                 buf_len=16))(
        jp, jnp.asarray(tok), jnp.asarray(fr))
    model = TT.build(tp, tcfg)
    tlp, tc = TT.prefill(model, tcfg, torch.from_numpy(tok),
                         enc_frames=torch.from_numpy(fr), buf_len=16)
    assert_close(jlp, tlp, tol, "prefill logits")
    assert sorted(tc) == sorted(jc) == ["attn", "cross"]
    assert isinstance(tc["cross"], TA.CrossCache)
    assert tuple(tc["cross"].k.shape) == jc["cross"][0].shape == (
        tcfg.n_layers, 2, tcfg.enc_seq, tcfg.n_kv_heads, tcfg.d_head)
    for j, t, what in ((jc["cross"][0], tc["cross"].k, "cross k"),
                       (jc["cross"][1], tc["cross"].v, "cross v"),
                       (jc["attn"].k, tc["attn"].k, "self k"),
                       (jc["attn"].v, tc["attn"].v, "self v")):
        assert_close(j, t, tol, what)
    assert tc["attn"].length == int(jc["attn"].length[0]) == 8
    cross = (tc["cross"].k.clone(), tc["cross"].v.clone())
    j_dec = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jcfg, c, t, pos))
    jl, tl = jlp, tlp
    for pos in range(8, 11):
        jt = jnp.argmax(jl, -1).astype(jnp.int32)
        tt = tl.float().argmax(-1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jl, jc = j_dec(jp, jc, jt, jnp.asarray(pos, jnp.int32))
        tl, tc = TT.decode_step(model, tcfg, tc, tt, pos)
        assert_close(jl, tl, tol, f"decode step {pos}")
    assert torch.equal(tc["cross"].k, cross[0])
    assert torch.equal(tc["cross"].v, cross[1])
    assert_close(jc["attn"].k, tc["attn"].k, tol, "self k after decode")
    assert tc["attn"].pos == int(jc["attn"].pos[0]) == 11


def test_init_decode_caches_and_a_decode_from_them():
    """``init_decode_caches`` gives zero cross K/V of ``enc_seq`` slots
    beside the self-attention cache; a decode from them, with no
    prefill, attends over the zeros as the reference's does."""
    jcfg, tcfg = smoke_pair(dtype="float32")
    jp, tp = weights(jcfg, tcfg)
    jc = JT.init_decode_caches(jcfg, 2, 8)
    tc = TT.init_decode_caches(tcfg, 2, 8, device="cpu")
    assert sorted(tc) == sorted(jc) == ["attn", "cross"]
    for j, t in zip(jc["cross"], (tc["cross"].k, tc["cross"].v)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        assert not t.any()
    tok = tokens(jcfg, (2, 3))
    model = TT.build(tp, tcfg)
    j_dec = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jcfg, c, t, pos))
    for pos in range(3):
        jl, jc = j_dec(jp, jc, jnp.asarray(tok[:, pos]),
                       jnp.asarray(pos, jnp.int32))
        tl, tc = TT.decode_step(model, tcfg, tc, torch.from_numpy(tok[:, pos]),
                                pos)
        assert_close(jl, tl, what=f"decode {pos}")


def test_prefill_decode_equivalence():
    """The port's prefill and decode against its own teacher-forced
    logits (float32), as the reference's ``test_prefill_decode_equivalence``
    checks its own."""
    _, cfg = smoke_pair(dtype="float32")
    _, p = weights(*smoke_pair(dtype="float32"))
    tok = torch.from_numpy(tokens(cfg))
    fr = torch.from_numpy(frames(cfg))
    full, _ = TT.forward_train(p, cfg, tok, enc_frames=fr)
    pre, caches = TT.prefill(p, cfg, tok[:, :-1], enc_frames=fr)
    torch.testing.assert_close(pre, full[:, 10], **PORT_TOL)
    dec, _ = TT.decode_step(p, cfg, caches, tok[:, -1], 11)
    torch.testing.assert_close(dec, full[:, 11], **PORT_TOL)


def test_layer_fn_and_run_stack_carry_the_cross_branch():
    """``layer_fn`` with ``enc_out`` layer by layer equals the stack; in
    prefill the stack returns the cross K/V as a ``CrossCache``, in
    train none; without ``enc_out`` or a cross cache a layer refuses."""
    _, cfg = smoke_pair(dtype="float32")
    _, p = weights(*smoke_pair(dtype="float32"))
    x = torch.from_numpy(frames(cfg, seq=6, seed=9))
    enc = TT.encode(p, cfg, torch.from_numpy(frames(cfg)))
    pos = torch.arange(6)
    y, kv, _ = TT.run_stack(p, cfg, x, positions=pos, mode="prefill",
                            enc_out=enc)
    assert isinstance(kv["cross"], TA.CrossCache)
    assert kv["cross"].k.shape == (cfg.n_layers, 2, cfg.enc_seq,
                                   cfg.n_kv_heads, cfg.d_head)
    h = x
    for i in range(cfg.n_layers):
        h, nc, _ = TT.layer_fn(TT.layer_params(p, cfg, i), cfg, h,
                               positions=pos, window=0, mode="train",
                               enc_out=enc)
        assert nc == {"attn": None, "cross": None}
    torch.testing.assert_close(h, y, rtol=0, atol=0)
    with pytest.raises(ValueError, match="enc_frames"):
        TT.layer_fn(TT.layer_params(p, cfg, 0), cfg, x, positions=pos,
                    window=0, mode="train")


# ---------------------------------------------------------------------------
# training and checkpoints
# ---------------------------------------------------------------------------

def start(jcfg, tcfg):
    jst = JTr.init_train_state(jax.random.PRNGKey(0), jcfg,
                               JOpt.OptConfig(lr=1e-3, total_steps=10),
                               JClockConfig(m=64))
    return jst, convert.train_state_from_jax(jax.tree.map(np.asarray, jst),
                                             tcfg, device="cpu")


def batches(cfg, step, batch=4, seq=16):
    """Step ``step``'s batch of both packages' ``SyntheticLM`` streams,
    with seeded frames."""
    jd = JD.SyntheticLM(JD.DataConfig(vocab=cfg.vocab, seq_len=seq,
                                      global_batch=batch))
    td = TD.SyntheticLM(TD.DataConfig(vocab=cfg.vocab, seq_len=seq,
                                      global_batch=batch))
    jb, tb = jd.batch(step), td.batch(step, device="cpu")
    hi, lo = jd.event_id(step)
    jb["ev_hi"], jb["ev_lo"] = jnp.uint32(hi), jnp.uint32(lo)
    tb["ev_hi"], tb["ev_lo"] = td.event_id(step)
    fr = frames(cfg, batch=batch, seed=100 + step)
    jb["enc_frames"], tb["enc_frames"] = jnp.asarray(fr), torch.from_numpy(fr)
    return jb, tb


def test_microbatches_slice_the_frames_and_match_reference():
    """Two microbatches: each takes its rows of ``enc_frames`` with its
    tokens, so the step equals the reference's two-microbatch step and
    the port's one-batch step (frames left whole would not fit the
    microbatch's rows)."""
    jcfg, tcfg = smoke_pair(dtype="float32")
    jst, tst = start(jcfg, tcfg)
    opt = dict(lr=1e-3, total_steps=10)
    jb, tb = batches(jcfg, 0)
    jstep = jax.jit(JTr.make_train_step(jcfg, JOpt.OptConfig(**opt),
                                        JClockConfig(m=64), num_microbatches=2))
    jst2, jm = jstep(jst, jb)
    steps = {n: TTr.make_train_step(tcfg, TOpt.OptConfig(**opt),
                                    TR.ClockConfig(m=64), num_microbatches=n)
             for n in (1, 2)}
    t2, m2 = steps[2](tst, tb)
    t1, m1 = steps[1](tst, tb)
    np.testing.assert_allclose(float(m2["loss"]), float(jm["loss"]), **STEP_TOL)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-5)
    for k in jst2.params:
        np.testing.assert_allclose(t2.params[k].numpy(),
                                   np.asarray(jst2.params[k]), err_msg=k,
                                   **STEP_TOL)
        np.testing.assert_allclose(t2.params[k].numpy(), t1.params[k].numpy(),
                                   err_msg=k, **STEP_TOL)
    np.testing.assert_array_equal(t2.clock_cells.numpy(),
                                  np.asarray(jst2.clock_cells))


def test_train_state_checkpoint_crosses_between_the_packages(tmp_path):
    """Whisper train states cross both ways with the same keys, dtypes
    and bytes: the JAX package's fresh state restores in the port, and
    the port's state after a step (moments and clock no longer zero)
    restores in the JAX package; the encoder's leaves (``encoder/pos``,
    ``enc_layers/...``) and the cross leaves among them."""
    jcfg, tcfg = smoke_pair(dtype="float32")
    jst, tst = start(jcfg, tcfg)
    _, tb = batches(jcfg, 0)
    tst, _ = TTr.make_train_step(tcfg, TOpt.OptConfig(lr=1e-3, total_steps=10),
                                 TR.ClockConfig(m=64))(tst, tb)
    snap = TR.ClockRuntime(TR.ClockConfig(m=64), device="cpu").snapshot()
    JManager(str(tmp_path / "j")).save(1, jst, snap, block=True)
    TManager(str(tmp_path / "t")).save(1, tst, snap, block=True)
    from_jax, _ = TManager(str(tmp_path / "j")).restore(
        target_structure=tst, device="cpu")
    want = dict(_leaves(convert.train_state_from_jax(
        jax.tree.map(np.asarray, jst), tcfg, device="cpu")))
    got = dict(_leaves(from_jax))
    assert list(got) == list(want)
    assert any("encoder/pos" in k for k in got)
    assert any("layers/cross/wk" in k for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    from_port, _ = JManager(str(tmp_path / "t")).restore(target_structure=jst)
    back = dict(_leaves(convert.train_state_from_jax(
        jax.tree.map(np.asarray, from_port), tcfg, device="cpu")))
    for k, t in _leaves(tst):
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k
