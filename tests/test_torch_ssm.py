"""The port's SSM and hybrid families (``repro_torch.models.ssm`` and
their branches in ``models.transformer``) against the JAX package's on
the CPU.

The same numpy-seeded inputs and the same weights (the JAX package's
``init_params``, carried across by ``convert.params_from_jax``) go
through the JAX function (under ``jit``) and the port's, at the two
smoke configs (``mamba2_130m.SMOKE``: a pure SSD stack; ``hymba_1_5b
.SMOKE``: attention, windowed but in layer 0, beside the SSM in every
layer) and variants of them.  Tolerances:

- float32 compute: outputs, logits, caches and gradients within
  ``F32_TOL`` (rtol and atol 2e-4, the reference's own
  ``test_mamba2_chunked_equals_small_chunk``: the frameworks sum the
  products, the conv taps' and the chunk recurrence in different
  orders);
- bfloat16 compute: within ``BF16_TOL`` (atol 6.25e-2, rtol 2e-2, as
  the dense tests: XLA fuses the bfloat16 conv, bias and SiLU and
  rounds in its own places);
- the decode caches' integers (lengths, positions), shapes and dtypes:
  identical.

The port departs from the reference in one place, the SSD's
intra-chunk decay (``models/ssm.py``'s docstring): its forward is the
reference formula's bit for bit and its gradient is finite where the
reference's is NaN; ``test_ssd_departure_*`` hold both.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=2e-2, atol=6.25e-2)
SSM_ARCHS = ("mamba2_130m", "hymba_1_5b")


def smoke_pair(arch, **kw):
    """The same smoke config in both packages, with ``kw`` replaced."""
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), **kw),
            dataclasses.replace(tconfigs.get_smoke_config(arch), **kw))


def weights(jcfg, tcfg, seed=0):
    """The JAX package's random weights, and the same carried across."""
    jp = JP.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                 tcfg, device="cpu")
    return jp, tp


def host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_close(j, t, tol=F32_TOL, what=""):
    np.testing.assert_allclose(host(t), host(j), err_msg=what, **tol)


def tensors(a, dtype):
    """A numpy float32 array as a JAX and a torch array of ``dtype``
    (the same values: bfloat16 rounds the same way in both)."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return j, t


def ssm_params(arch, dtype="float32", seed=0, **kw):
    """Both configs and layer 0's ``ssm/`` leaves (float32 masters) in
    both packages."""
    jcfg, tcfg = smoke_pair(arch, dtype=dtype, **kw)
    jp = JP.init_params(jax.random.PRNGKey(seed), jcfg)
    jm = {k: v[0] for k, v in JL.sub(JL.sub(jp, "layers"), "ssm").items()}
    tm = {k: torch.from_numpy(np.array(v)) for k, v in jm.items()}
    return jcfg, tcfg, jm, tm


# ---------------------------------------------------------------------------
# ssm.py's pieces
# ---------------------------------------------------------------------------

CONV_CASES = [(dt, case) for dt in ("float32", "bfloat16")
              for case in ("train", "short", "decode")]


@pytest.mark.parametrize("dtype,case", CONV_CASES)
def test_causal_conv_matches_reference(dtype, case):
    """mamba2's smoke conv (width 4): a 9-token train call, a 2-token one
    (S < w - 1: the tail is part padding), and 3 decode steps chained
    through the tail.  Output and new tail within the dtype's
    tolerance; the tails are the last w - 1 rows of the padded input."""
    jcfg, tcfg, jm, tm = ssm_params("mamba2_130m", dtype)
    ch = jcfg.d_inner_ssm + 2 * jcfg.ssm_state
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(11)
    conv = jax.jit(lambda p, x, c: JS._causal_conv(p, jcfg, x, c))
    conv0 = jax.jit(lambda p, x: JS._causal_conv(p, jcfg, x))
    if case in ("train", "short"):
        S = 9 if case == "train" else 2
        x, tx = tensors(rng.standard_normal((2, S, ch)).astype(np.float32),
                        jcfg.compute_dtype)
        jy, jtail = conv0(jm, x)
        ty, ttail = TS._causal_conv(tm, tcfg, tx)
        assert ty.dtype == tcfg.compute_dtype and ty.shape == jy.shape
        assert_close(jy, ty, tol, "conv output")
        np.testing.assert_array_equal(host(ttail), host(jtail))
        assert ttail.shape == (2, jcfg.ssm_conv - 1, ch)
        if case == "short":
            assert not ttail[:, :jcfg.ssm_conv - 1 - S].any()
        return
    state, tstate = tensors(rng.standard_normal(
        (2, jcfg.ssm_conv - 1, ch)).astype(np.float32), jcfg.compute_dtype)
    for step in range(3):
        x, tx = tensors(rng.standard_normal((2, 1, ch)).astype(np.float32),
                        jcfg.compute_dtype)
        jy, state = conv(jm, x, state)
        ty, tstate = TS._causal_conv(tm, tcfg, tx, tstate)
        assert_close(jy, ty, tol, f"decode {step}")
        np.testing.assert_array_equal(host(tstate), host(state))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_norm_matches_reference(dtype):
    jcfg, tcfg, jm, tm = ssm_params("hymba_1_5b", dtype)
    rng = np.random.default_rng(12)
    shape = (2, 7, jcfg.d_inner_ssm)
    y, ty = tensors(rng.standard_normal(shape).astype(np.float32),
                    jcfg.compute_dtype)
    z, tz = tensors(rng.standard_normal(shape).astype(np.float32),
                    jcfg.compute_dtype)
    jm = dict(jm, norm=jnp.asarray(rng.uniform(0.5, 1.5, shape[-1]), jnp.float32))
    tm = dict(tm, norm=torch.from_numpy(np.array(jm["norm"])))
    jo = jax.jit(lambda p, y, z: JS._gated_norm(p, jcfg, y, z))(jm, y, z)
    to = TS._gated_norm(tm, tcfg, ty, tz)
    assert to.dtype == tcfg.compute_dtype
    assert_close(jo, to, F32_TOL if dtype == "float32" else BF16_TOL)


def ssd_inputs(cfg, S, seed=13, dt_scale=0.1, B=2):
    """Random SSD inputs at ``cfg``'s widths: x, dt (positive, up to
    ``dt_scale``), A in [-8, -1), B and C, float32 numpy."""
    rng = np.random.default_rng(seed)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return (rng.standard_normal((B, S, H, P)).astype(np.float32),
            rng.uniform(1e-3, dt_scale, (B, S, H)).astype(np.float32),
            -rng.uniform(1.0, 8.0, H).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32))


@pytest.mark.parametrize("chunk", [16, 7])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssd_chunked_matches_reference(arch, chunk):
    """S = 33, a multiple of neither chunk: y and the final state."""
    jcfg, tcfg = smoke_pair(arch, dtype="float32", ssm_chunk=chunk)
    args = ssd_inputs(jcfg, 33)
    jy, jst = jax.jit(lambda *a: JS._ssd_chunked(jcfg, *a))(
        *map(jnp.asarray, args))
    ty, tst = TS._ssd_chunked(tcfg, *map(torch.from_numpy, args))
    assert ty.dtype == tst.dtype == torch.float32
    assert_close(jy, ty, what="y")
    assert_close(jst, tst, what="final state")


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssd_gradients_match_reference(arch):
    """The smoke configs' chunk (16) at S = 33, where the reference's
    gradient is finite: the gradients of sum(y * w) + sum(state * u)
    with respect to x, dt, A, B and C."""
    jcfg, tcfg = smoke_pair(arch, dtype="float32")
    args = ssd_inputs(jcfg, 33)
    rng = np.random.default_rng(14)
    w = rng.standard_normal(args[0].shape).astype(np.float32)
    u = rng.standard_normal((2, jcfg.ssm_heads, jcfg.ssm_head_dim,
                             jcfg.ssm_state)).astype(np.float32)

    def jloss(*a):
        y, st = JS._ssd_chunked(jcfg, *a)
        return jnp.sum(y * w) + jnp.sum(st * u)

    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(*map(jnp.asarray, args))
    ta = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, st = TS._ssd_chunked(tcfg, *ta)
    ((y * torch.from_numpy(w)).sum() + (st * torch.from_numpy(u)).sum()).backward()
    for name, g, t in zip(("x", "dt", "A", "B", "C"), jg, ta):
        assert np.isfinite(np.asarray(g)).all()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=2e-4,
                                   atol=2e-4 * float(np.abs(g).max()),
                                   err_msg=name)


def _reference_decay(diff, causal):
    """The reference's intra-chunk decay, in torch: ``exp`` of every
    entry, 0 selected above the diagonal afterwards."""
    return torch.where(causal, torch.exp(diff), 0.0)


def test_ssd_departure_forward_bit_identical_gradient_finite(monkeypatch):
    """Q = 128 with dt |A| up to 2.4: above the diagonal the exponent
    overflows.  The reference's gradient (``jax.grad``, and the same
    formula in torch) has non-finite entries; the port's has none, and
    the port's forward (y and state) is the reference formula's bit for
    bit."""
    jcfg, tcfg = smoke_pair("mamba2_130m", dtype="float32", ssm_chunk=128)
    args = ssd_inputs(jcfg, 128, dt_scale=0.3, B=1)
    w = np.random.default_rng(15).standard_normal(args[0].shape).astype(np.float32)

    jg = jax.jit(jax.grad(lambda *a: jnp.sum(JS._ssd_chunked(jcfg, *a)[0] * w),
                          argnums=tuple(range(5))))(*map(jnp.asarray, args))
    assert not all(np.isfinite(np.asarray(g)).all() for g in jg)

    def run():
        ta = [torch.from_numpy(a).requires_grad_(True) for a in args]
        y, st = TS._ssd_chunked(tcfg, *ta)
        (y * torch.from_numpy(w)).sum().backward()
        return y.detach(), st.detach(), [t.grad for t in ta]

    y, st, grads = run()
    assert all(bool(g.isfinite().all()) for g in grads)
    monkeypatch.setattr(TS, "_intra_decay", _reference_decay)
    ry, rst, rgrads = run()
    assert not all(bool(g.isfinite().all()) for g in rgrads)
    assert torch.equal(y.view(torch.int32), ry.view(torch.int32))
    assert torch.equal(st.view(torch.int32), rst.view(torch.int32))
    # the masked exponent gives the reference's L exactly
    diff = torch.randn(4, 9, 9, 3) * 40
    causal = torch.ones(9, 9, dtype=torch.bool).tril()[None, :, :, None]
    assert torch.equal(TS._intra_decay(diff, causal),
                       _reference_decay(diff, causal))


def test_ssd_departure_gradient_same_at_any_chunk():
    """The chunked form is one function at any chunk: at Q = 128 (where
    the reference's gradient is NaN) the port's gradients equal its own
    at Q = 8 within 2e-4 (relative to each gradient's largest entry)."""
    base, tcfg = smoke_pair("mamba2_130m", dtype="float32")
    args = ssd_inputs(base, 128, dt_scale=0.3, B=1)
    w = torch.from_numpy(np.random.default_rng(16).standard_normal(
        args[0].shape).astype(np.float32))
    out = []
    for chunk in (128, 8):
        cfg = dataclasses.replace(tcfg, ssm_chunk=chunk)
        ta = [torch.from_numpy(a).requires_grad_(True) for a in args]
        y, st = TS._ssd_chunked(cfg, *ta)
        ((y * w).sum() + st.sum()).backward()
        out.append((y.detach(), [t.grad for t in ta]))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=2e-4, atol=2e-4)
    for name, g128, g8 in zip(("x", "dt", "A", "B", "C"), out[0][1], out[1][1]):
        assert bool(g128.isfinite().all()), name
        torch.testing.assert_close(g128, g8, rtol=2e-4,
                                   atol=2e-4 * float(g8.abs().max()), msg=name)


SSM_BLOCK_CASES = [(a, dt, S) for a in SSM_ARCHS
                   for dt in ("float32", "bfloat16") for S in (8, 2)]


@pytest.mark.parametrize("arch,dtype,S", SSM_BLOCK_CASES)
def test_ssm_block_prefill_and_decode_match_reference(arch, dtype, S):
    """Layer 0's SSM block: a prefill of S tokens (2 < w - 1: the conv
    tail left-padded) returns the output and a ready cache, then 4
    decode steps update it: outputs, conv tails and states."""
    jcfg, tcfg = smoke_pair(arch, dtype=dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jp, tp = weights(jcfg, tcfg)
    jm = {k: v[0] for k, v in JL.sub(JL.sub(jp, "layers"), "ssm").items()}
    tm = TT.build(tp, tcfg).layers[0].ssm.weights
    x, tx = tensors(np.random.default_rng(17).standard_normal(
        (2, S + 4, jcfg.d_model)).astype(np.float32), jcfg.compute_dtype)
    block = jax.jit(lambda p, x, c: JS.ssm_block(p, jcfg, x, cache=c))
    jo, jc = block(jm, x[:, :S], None)
    to, tc = TS.ssm_block(tm, tcfg, tx[:, :S])
    assert to.dtype == tcfg.compute_dtype
    assert tc.conv.dtype == tcfg.compute_dtype and tc.state.dtype == torch.float32
    assert tc.conv.shape == jc.conv.shape and tc.state.shape == jc.state.shape
    assert_close(jo, to, tol, "prefill output")
    np.testing.assert_array_equal(host(tc.conv), host(jc.conv))
    assert_close(jc.state, tc.state, tol, "prefill state")
    conv, state = tc.conv, tc.state
    for t in range(S, S + 4):
        jo, jc = block(jm, x[:, t:t + 1], jc)
        to, tc = TS.ssm_block(tm, tcfg, tx[:, t:t + 1], cache=tc)
        assert tc.conv is conv and tc.state is state       # in place
        assert_close(jo, to, tol, f"decode {t}")
        assert_close(jc.conv, tc.conv, tol, f"decode {t} conv")
        assert_close(jc.state, tc.state, tol, f"decode {t} state")


def test_init_ssm_cache_matches_reference():
    for arch in SSM_ARCHS:
        jcfg, tcfg = smoke_pair(arch)
        jc = JT.init_decode_caches(jcfg, 3, 20, long_context=True)
        tc = TT.init_decode_caches(tcfg, 3, 20, long_context=True, device="cpu")
        assert sorted(tc) == sorted(jc)
        for name in ("conv", "state"):
            j, t = getattr(jc["ssm"], name), getattr(tc["ssm"], name)
            assert tuple(t.shape) == j.shape and not t.any()
            assert str(t.dtype).split(".")[1] == j.dtype.name
        if "attn" in tc:
            assert tc["attn"].ring and tc["attn"].k.shape == jc["attn"].k.shape


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------

def test_float32_leaves_stay_float32():
    """At bfloat16 compute, in the stacked and the unstacked layout: the
    six leaves the reference reads as float32 (``ssm/norm``,
    ``ssm/dt_bias``, ``ssm/a_log``, ``ssm/d_skip``, ``fuse/gain_attn``,
    ``fuse/gain_ssm``) and the norm scales stay float32 in
    ``_layer_dicts`` (which casts a stacked leaf once, the rest to
    bfloat16, and hands an unstacked layer's masters over as they are)
    and in a built ``Transformer``, with the masters' values; the rest
    of the built model is bfloat16."""
    six = ("ssm/norm", "ssm/dt_bias", "ssm/a_log", "ssm/d_skip",
           "fuse/gain_attn", "fuse/gain_ssm")
    for scan in (True, False):
        _, cfg = smoke_pair("hymba_1_5b", scan_layers=scan)
        p = TP.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        for name in six:
            assert TT.held_f32(name) and TT.held_f32(name.split("/")[1])
        for i, d in enumerate(TT._layer_dicts(p, cfg)):
            for k, v in d.items():
                assert v.dtype == (torch.float32 if TT.held_f32(k) or not scan
                                   else torch.bfloat16), k
            for name in six:
                assert torch.equal(d[name], TT.layer_params(p, cfg, i)[name])
        model = TT.build(p, cfg)
        for i, layer in enumerate(model.layers):
            got = {**{f"ssm/{k}": v for k, v in layer.ssm.weights.items()},
                   **{f"fuse/{k}": v for k, v in layer.fuse.weights.items()}}
            for name in six:
                assert got[name].dtype == torch.float32
                assert torch.equal(got[name], TT.layer_params(p, cfg, i)[name])
            for k, v in layer.named_buffers():
                assert v.dtype == (torch.float32 if TT.held_f32(
                    k.split(".", 1)[1]) or k.startswith("norm")
                    else torch.bfloat16), k


STACK_CASES = [(a, dt, scan) for a in SSM_ARCHS
               for dt in ("float32", "bfloat16") for scan in (True, False)]


@pytest.mark.parametrize("arch,dtype,scan", STACK_CASES)
def test_forward_prefill_decode_match_reference(arch, dtype, scan):
    """forward_train logits and aux, prefill logits and caches, then 4
    decode steps token for token, against the JAX package."""
    jcfg, tcfg = smoke_pair(arch, dtype=dtype, scan_layers=scan)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jp, tp = weights(jcfg, tcfg)
    tok = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    jl, jaux = jax.jit(lambda p, t: JT.forward_train(p, jcfg, t))(
        jp, jnp.asarray(tok))
    tl, taux = TT.forward_train(tp, tcfg, torch.from_numpy(tok))
    assert tl.dtype == tcfg.compute_dtype and tl.shape == jl.shape
    assert_close(jl, tl, tol, "forward_train")
    assert float(taux) == float(jaux) == 0.0

    model = TT.build(tp, tcfg)
    jlp, jc = jax.jit(lambda p, t: JT.prefill(p, jcfg, t, buf_len=16))(
        jp, jnp.asarray(tok[:, :8]))
    tlp, tc = TT.prefill(model, tcfg, torch.from_numpy(tok[:, :8]), buf_len=16)
    assert_close(jlp, tlp, tol, "prefill logits")
    assert sorted(tc) == sorted(jc)

    def caches_close(what):
        for name in ("conv", "state"):
            j, t = getattr(jc["ssm"], name), getattr(tc["ssm"], name)
            assert tuple(t.shape) == j.shape
            assert_close(j, t, tol, f"{what} ssm {name}")
        if "attn" in jc:
            for name in ("k", "v"):
                assert_close(getattr(jc["attn"], name),
                             getattr(tc["attn"], name), tol, f"{what} {name}")

    caches_close("prefill")
    if "attn" in tc:
        assert tc["attn"].length == int(jc["attn"].length[0]) == 8
    j_dec = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jcfg, c, t, pos))
    for t in range(8, 12):
        jld, jc = j_dec(jp, jc, jnp.asarray(tok[:, t]), jnp.asarray(t, jnp.int32))
        tld, tc = TT.decode_step(model, tcfg, tc, torch.from_numpy(tok[:, t]), t)
        assert_close(jld, tld, tol, f"decode step {t}")
    caches_close("decode")
    if "attn" in tc:
        assert tc["attn"].pos == int(jc["attn"].pos[0]) == 12


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_decode_equivalence(arch):
    """Decode with the caches == teacher-forced logits (float32), as the
    JAX package's own test checks it."""
    _, cfg = smoke_pair(arch, dtype="float32")
    p = TP.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (2, 12)))
    full, _ = TT.forward_train(p, cfg, tok)
    pre, caches = TT.prefill(p, cfg, tok[:, :-1])
    torch.testing.assert_close(pre, full[:, 10], rtol=2e-4, atol=2e-4)
    dec, _ = TT.decode_step(p, cfg, caches, tok[:, -1], 11)
    torch.testing.assert_close(dec, full[:, 11], rtol=2e-4, atol=2e-4)


def test_chunked_equals_small_chunk():
    """The port's twin of the reference's
    ``test_mamba2_chunked_equals_small_chunk``: forward_train at chunk 16
    and 7 on 33 tokens, within 2e-4."""
    _, cfg = smoke_pair("mamba2_130m", dtype="float32")
    p = TP.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 33)))
    l1, _ = TT.forward_train(p, cfg, tok)
    l2, _ = TT.forward_train(p, dataclasses.replace(cfg, ssm_chunk=7), tok)
    torch.testing.assert_close(l1, l2, rtol=2e-4, atol=2e-4)


def test_hybrid_ring_buffer_decode_matches_linear_and_jax():
    """The twin of ``test_ring_buffer_long_decode_matches_linear`` at
    hymba's smoke config with every layer windowed: ring-buffer decode
    over the whole prefix equals linear prefill + decode with the window
    mask, and the JAX package's ring decode (logits, K/V and SSM
    caches)."""
    jcfg, tcfg = smoke_pair("hymba_1_5b", dtype="float32", global_layers=())
    jp, tp = weights(jcfg, tcfg)
    model = TT.build(tp, tcfg)
    S_ctx, n_gen = 20, 6
    tok = np.random.default_rng(8).integers(0, tcfg.vocab, (1, S_ctx + n_gen))
    _, lin = TT.prefill(model, tcfg, torch.from_numpy(tok[:, :S_ctx]))
    ring = TT.init_decode_caches(tcfg, 1, S_ctx + n_gen + 1, long_context=True,
                                 device="cpu")
    jring = JT.init_decode_caches(jcfg, 1, S_ctx + n_gen + 1, long_context=True)
    j_dec = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jcfg, c, t, pos))
    assert ring["attn"].ring and ring["attn"].k.shape[2] == jcfg.window
    for t in range(S_ctx):
        _, ring = TT.decode_step(model, tcfg, ring, torch.from_numpy(tok[:, t]), t)
        _, jring = j_dec(jp, jring, jnp.asarray(tok[:, t]),
                         jnp.asarray(t, jnp.int32))
    for t in range(S_ctx, S_ctx + n_gen):
        lo_l, lin = TT.decode_step(model, tcfg, lin, torch.from_numpy(tok[:, t]), t)
        lo_r, ring = TT.decode_step(model, tcfg, ring, torch.from_numpy(tok[:, t]), t)
        lo_j, jring = j_dec(jp, jring, jnp.asarray(tok[:, t]),
                            jnp.asarray(t, jnp.int32))
        torch.testing.assert_close(lo_r, lo_l, rtol=2e-4, atol=2e-4)
        assert_close(lo_j, lo_r)
    assert_close(jring["attn"].k, ring["attn"].k)
    assert_close(jring["ssm"].state, ring["ssm"].state)
    torch.testing.assert_close(ring["ssm"].state, lin["ssm"].state,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_layer_fn_and_run_stack(arch):
    """The functional entry points: run_stack's prefill caches are the
    layers' stacked (an ``SSMCache`` on a leading L axis, hymba's (k, v)
    beside it), layer_fn's train caches are None under the family's
    keys, and layer after layer gives run_stack's output exactly."""
    _, cfg = smoke_pair(arch, dtype="float32")
    p = TP.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    x = torch.randn(2, 6, cfg.d_model, generator=torch.Generator().manual_seed(2))
    pos = torch.arange(6)
    y, kv, aux = TT.run_stack(p, cfg, x, positions=pos, mode="prefill")
    keys = ["ssm"] if arch == "mamba2_130m" else ["attn", "ssm"]
    assert sorted(kv) == keys and float(aux) == 0.0
    assert kv["ssm"].conv.shape == (cfg.n_layers, 2, cfg.ssm_conv - 1,
                                    cfg.d_inner_ssm + 2 * cfg.ssm_state)
    assert kv["ssm"].state.shape == (cfg.n_layers, 2, cfg.ssm_heads,
                                     cfg.ssm_head_dim, cfg.ssm_state)
    h = x
    for i in range(cfg.n_layers):
        h, nc, _ = TT.layer_fn(TT.layer_params(p, cfg, i), cfg, h,
                               positions=pos, window=TT.layer_windows(cfg)[i],
                               mode="train")
        assert nc == dict.fromkeys(keys)
    torch.testing.assert_close(h, y, rtol=0, atol=0)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_stack_gradient_finite_at_the_configs_chunk(arch):
    """The full configs' chunk, Q = 128, on 128 tokens of each smoke
    config (float32): the gradient of the mean squared logits with
    respect to every leaf is finite in the port, where the reference's
    has non-finite leaves for hymba's, and equals the port's own at the
    smoke chunk (16) within 2e-4 of each leaf's largest entry."""
    jcfg, tcfg = smoke_pair(arch, dtype="float32", ssm_chunk=128)
    jp, _ = weights(jcfg, tcfg)
    tok = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 128)).astype(np.int32)
    jg = jax.jit(jax.grad(lambda p: jnp.mean(JT.forward_train(
        p, jcfg, jnp.asarray(tok))[0] ** 2)))(jp)
    ref_bad = sum(not np.isfinite(np.asarray(v)).all() for v in jg.values())
    assert ref_bad == (20 if arch == "hymba_1_5b" else 0)
    grads = []
    for chunk in (128, 16):
        cfg = dataclasses.replace(tcfg, ssm_chunk=chunk)
        tp = {k: v.requires_grad_(True) for k, v in convert.params_from_jax(
            {k: np.asarray(v) for k, v in jp.items()}, cfg, device="cpu").items()}
        logits, _ = TT.forward_train(tp, cfg, torch.from_numpy(tok))
        (logits ** 2).mean().backward()
        grads.append({k: v.grad for k, v in tp.items()})
    for k, g in grads[0].items():
        assert bool(g.isfinite().all()), k
        torch.testing.assert_close(g, grads[1][k], rtol=2e-4,
                                   atol=2e-4 * float(g.abs().max()), msg=k)
        if np.isfinite(np.asarray(jg[k])).all():
            np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=2e-4,
                                       atol=2e-4 * float(g.abs().max()),
                                       err_msg=k)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_launchers_run_without_jax(tmp_path, arch):
    """``launch.serve`` and ``launch.train`` at the smoke config on the
    CPU, in a process whose ``jax`` fails on import."""
    import os
    import subprocess
    import sys

    fake = tmp_path / "nojax" / "jax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text(
        "raise ImportError('this process must not import jax')\n")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "src")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(fake.parent), src])}
    name = tconfigs.get_smoke_config(arch).name
    for args, want in (
            (["serve", "--gen", "4"], f"[serve] {name} on cpu: prefill 4x32"),
            (["train", "--steps", "2", "--batch", "2", "--seq", "32",
              "--ckpt-dir", str(tmp_path / "ckpt")], "[train] done: 2 steps")):
        proc = subprocess.run(
            [sys.executable, "-m", f"repro_torch.launch.{args[0]}", "--arch",
             arch, "--smoke", "--device", "cpu", *args[1:]],
            env=env, capture_output=True, text=True, timeout=120)
        out = proc.stdout + proc.stderr
        assert proc.returncode == 0, out
        assert want in out and "must not import jax" not in out
