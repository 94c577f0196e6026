"""The port's dense decoder (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package's on the CPU.

The same numpy-seeded inputs and the same weights (the JAX package's
``init_params``, carried across by ``convert.params_from_jax``) go
through the JAX function and the port's.  Tolerances:

- float32 (``dtype="float32"``): logits, caches and layer outputs within
  ``F32_TOL`` (1e-5 absolute and relative).  The two frameworks sum the
  matrix products in different orders; the largest gap seen on the four
  smoke configs is 3.6e-6 at logits of magnitude 3.5.
- bfloat16 (the configs' own compute dtype): within ``BF16_TOL``
  (6.25e-2 absolute, 2e-2 relative): four bfloat16 ulps at magnitude 2-4,
  where each framework rounds the products' outputs in its own places.
- integers, shapes, paths, dtypes and parameter counts: identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import config as JC  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import config as TC  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=6.25e-2)

DENSE = ("qwen1_5_0_5b", "stablelm_1_6b", "granite_20b", "pixtral_12b")


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
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_close(j, t, tol=F32_TOL, what=""):
    np.testing.assert_allclose(host(t), host(j), err_msg=what, **tol)


# ---------------------------------------------------------------------------
# configs and the parameter table
# ---------------------------------------------------------------------------

def test_config_fields_and_registry_identical():
    jf = [(f.name, f.default) for f in dataclasses.fields(JC.ModelConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TC.ModelConfig)]
    assert jf == tf
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    assert tconfigs.families() == jconfigs.families()
    assert TC.ModelConfig(dtype="bfloat16").compute_dtype == torch.bfloat16
    assert TC.ModelConfig(dtype="float32").compute_dtype == torch.float32
    with pytest.raises(ValueError):
        TC.validate(TC.ModelConfig(n_heads=4, n_kv_heads=3))


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_param_table_identical(arch):
    for jcfg, tcfg in (
            (jconfigs.get_config(arch), tconfigs.get_config(arch)),
            smoke_pair(arch),
            smoke_pair(arch, scan_layers=False)):
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        jt, tt = JP.param_table(jcfg), TP.param_table(tcfg)
        assert list(jt) == list(tt)
        for path in jt:
            assert dataclasses.astuple(jt[path]) == dataclasses.astuple(tt[path]), path
        assert tcfg.n_params() == jcfg.n_params()
        assert tcfg.n_active_params() == jcfg.n_active_params()
        assert tcfg.d_q == jcfg.d_q and tcfg.attends == jcfg.attends


def test_qwen_full_config_size():
    cfg = tconfigs.get_config("qwen1_5_0_5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab) == (
        24, 1024, 16, 2816, 151936)
    assert cfg.tie_embeddings and cfg.n_params() == 463_987_712


def test_init_params_kinds_statistics_and_determinism():
    cfg = dataclasses.replace(tconfigs.get_smoke_config("hymba_1_5b"),
                              d_model=128, d_ff=256)
    table = TP.param_table(cfg)
    p = TP.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    again = TP.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    other = TP.init_params(torch.Generator().manual_seed(4), cfg, device="cpu")
    assert list(p) == list(table)
    kinds = set()
    for path, info in table.items():
        x = p[path]
        kinds.add(info.init)
        assert tuple(x.shape) == info.shape and x.dtype == torch.float32, path
        assert torch.equal(x, again[path]), path
        v = x.double()
        if info.init == "zeros":
            assert not v.any(), path
        elif info.init == "ones":
            assert (v == 1).all(), path
        else:
            assert not torch.equal(x, other[path]), path
        if info.init == "embed":
            assert abs(v.std().item() - 0.02) < 0.002, path
        elif info.init == "linear":
            fan_in = info.shape[-2] if len(info.shape) >= 2 else info.shape[-1]
            std = 1.0 / np.sqrt(fan_in)
            assert v.abs().max().item() <= 2 * std * (1 + 1e-6), path
            # a standard normal truncated at ±2 has std 0.8796
            assert abs(v.std().item() / std - 0.8796) < 0.05, path
        elif info.init == "ssm_a":
            assert (v >= 0).all() and (v < np.log(8.0) + 1e-6).all(), path
        elif info.init == "dt_bias":
            dt = torch.nn.functional.softplus(v)
            assert (dt >= 1e-3 - 1e-6).all() and (dt <= 1e-1 + 1e-6).all(), path
    assert kinds == {"linear", "embed", "zeros", "ones", "ssm_a", "dt_bias"}
    bf = dataclasses.replace(cfg, param_dtype="bfloat16")
    pb = TP.init_params(torch.Generator().manual_seed(3), bf, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in pb.values())


def test_params_from_jax_carries_bfloat16_bits_and_checks_the_table():
    jcfg, tcfg = smoke_pair("qwen1_5_0_5b", param_dtype="bfloat16")
    jp, tp = weights(jcfg, tcfg)
    for path, leaf in jp.items():
        assert tp[path].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tp[path].view(torch.int16).numpy(),
            np.asarray(leaf).view(np.int16), err_msg=path)
    np_params = {k: np.asarray(v) for k, v in jp.items()}
    np_params.pop("norm_f/scale")
    with pytest.raises(ValueError):
        convert.params_from_jax(np_params, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(kind):
    jcfg, tcfg = smoke_pair("stablelm_1_6b", norm=kind)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    j = JL.norm({k: jnp.asarray(v) for k, v in p.items()}, jcfg, jnp.asarray(x))
    t = TL.norm({k: torch.from_numpy(v) for k, v in p.items()}, tcfg,
                torch.from_numpy(x))
    assert_close(j, t)
    jb = JL.norm({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                 jnp.asarray(x, jnp.bfloat16))
    tb = TL.norm({k: torch.from_numpy(v) for k, v in p.items()}, tcfg,
                 torch.from_numpy(x).bfloat16())
    assert tb.dtype == torch.bfloat16
    assert_close(jb, tb, BF16_TOL)


@pytest.mark.parametrize("rope_pct", [1.0, 0.25])
def test_rope_matches_jax(rope_pct):
    jcfg, tcfg = smoke_pair("stablelm_1_6b", rope_pct=rope_pct,
                            rope_theta=1e6)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.arange(3, 10)
    j = JL.rope(jnp.asarray(x), jnp.asarray(pos), jcfg)
    t = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), tcfg)
    assert_close(j, t)
    rot = TL.rope_width(tcfg, 16)
    np.testing.assert_array_equal(t[..., rot:].numpy(), x[..., rot:])
    angles = TL.rope_angles(torch.from_numpy(pos), tcfg, 16)
    assert torch.equal(TL.rope(torch.from_numpy(x), None, tcfg, angles=angles), t)


@pytest.mark.parametrize("act", ["silu_glu", "gelu"])
def test_mlp_matches_jax(act):
    jcfg, tcfg = smoke_pair("granite_20b", act=act, dtype="float32")
    jp, tp = weights(jcfg, tcfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    for name in ("b_in", "b_out"):     # zeros at init: give them values
        path = f"layers/mlp/{name}"
        if path in jp:
            val = rng.standard_normal(jp[path].shape).astype(np.float32)
            jp[path] = jnp.asarray(val)
            tp[path] = torch.from_numpy(val)
    j = JL.mlp({k: v[0] for k, v in JL.sub(jp, "layers/mlp").items()}, jcfg,
               jnp.asarray(x))
    t = TL.mlp({k: v[0] for k, v in TL.sub(tp, "layers/mlp").items()}, tcfg,
               torch.from_numpy(x))
    assert_close(j, t)


def test_embed_and_unembed_match_jax():
    jcfg, tcfg = smoke_pair("grok_1_314b", dtype="float32")
    jp, tp = weights(jcfg, tcfg)
    tok = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 5))
    x = JL.embed_tokens(jp, jcfg, jnp.asarray(tok))
    assert_close(x, TL.embed_tokens(tp, tcfg, torch.from_numpy(tok)))
    assert_close(JL.unembed(jp, jcfg, x),
                 TL.unembed(tp, tcfg, torch.from_numpy(np.array(x))))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [4, 5])      # divides S = 12 / does not
@pytest.mark.parametrize("case", ["causal", "windowed", "gqa", "full"])
def test_attention_core_matches_jax(case, chunk):
    H, KV = (4, 1) if case == "gqa" else (4, 4)
    rng = np.random.default_rng(5)
    B, S, Dh = 2, 12, 16
    q = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, Dh)).astype(np.float32)
    kw = dict(causal=case != "full", window=5 if case == "windowed" else 0,
              q_offset=0, kv_valid=S, chunk=chunk)
    j = JA.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    t = TA.attention_core(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **kw)
    assert_close(j, t)
    # decode-shaped: one query against a partly valid buffer
    kw1 = dict(causal=False, window=kw["window"], q_offset=8, kv_valid=9,
               chunk=chunk)
    j1 = JA.attention_core(jnp.asarray(q[:, 8:9]), jnp.asarray(k),
                           jnp.asarray(v), **kw1)
    t1 = TA.attention_core(torch.from_numpy(q[:, 8:9]), torch.from_numpy(k),
                           torch.from_numpy(v), **kw1)
    assert_close(j1, t1)


def test_attention_core_bf16_accumulator_matches_jax():
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
               for _ in range(3))
    kw = dict(causal=True, window=0, q_offset=0, kv_valid=9, chunk=4)
    j = JA.attention_core(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                          acc_dtype=jnp.bfloat16, **kw)
    t = TA.attention_core(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                          acc_dtype=torch.bfloat16, **kw)
    assert_close(j, t, BF16_TOL)


def test_cache_update_linear_and_ring():
    cfg = tconfigs.get_smoke_config("qwen1_5_0_5b")
    for ring in (False, True):
        c = TA.init_cache(cfg, 1, 3, 1, 2, ring=ring, device="cpu")
        jc = JA.init_cache(jconfigs.get_smoke_config("qwen1_5_0_5b"), 1, 3, 1,
                           2, ring=ring)
        for step in range(5):
            new = np.full((1, 1, 1, 2), step + 1, np.float32)
            c = TA.cache_update(c, torch.from_numpy(new).bfloat16(),
                                torch.from_numpy(-new).bfloat16())
            jc = JA.cache_update(jc, jnp.asarray(new), jnp.asarray(-new))
            np.testing.assert_array_equal(host(c.k), host(jc.k))
            np.testing.assert_array_equal(host(c.v), host(jc.v))
            assert (c.length, c.pos) == (int(jc.length), int(jc.pos))


# ---------------------------------------------------------------------------
# the stack: forward, prefill, decode
# ---------------------------------------------------------------------------

def _inputs(cfg, B=2, S=12, seed=7):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    pfx = (rng.standard_normal((B, cfg.n_prefix, cfg.d_model)).astype(np.float32)
           if cfg.n_prefix else None)
    return tok, pfx


def _kw(pfx, jax_side):
    if pfx is None:
        return {}
    return {"prefix_embeds": jnp.asarray(pfx) if jax_side
            else torch.from_numpy(pfx)}


STACK_CASES = [(a, "float32", True) for a in DENSE] + [
    ("qwen1_5_0_5b", "bfloat16", True), ("granite_20b", "float32", False)]


@pytest.mark.parametrize("arch,dtype,scan", STACK_CASES)
def test_forward_prefill_decode_match_jax(arch, dtype, scan):
    """forward_train logits, prefill logits and caches, then 4 decode
    steps, token for token against the JAX package."""
    jcfg, tcfg = smoke_pair(arch, dtype=dtype, scan_layers=scan)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jp, tp = weights(jcfg, tcfg)
    tok, pfx = _inputs(jcfg)
    # the JAX side under jit, one compile a function (eager JAX runs
    # the unrolled layout op by op)
    j_fwd = jax.jit(lambda p, t, x: JT.forward_train(p, jcfg, t, prefix_embeds=x))
    j_pre = jax.jit(lambda p, t, x: JT.prefill(p, jcfg, t, prefix_embeds=x,
                                               buf_len=16))
    j_dec = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jcfg, c, t, pos))
    jpfx = None if pfx is None else jnp.asarray(pfx)
    jl, jaux = j_fwd(jp, jnp.asarray(tok), jpfx)
    tl, taux = TT.forward_train(tp, tcfg, torch.from_numpy(tok), **_kw(pfx, False))
    assert tl.dtype == tcfg.compute_dtype and tl.shape == jl.shape
    assert_close(jl, tl, tol, "forward_train")
    assert float(taux) == float(jaux) == 0.0

    model = TT.build(tp, tcfg)      # decode reuses one built model
    jlp, jc = j_pre(jp, jnp.asarray(tok[:, :8]), jpfx)
    tlp, tc = TT.prefill(model, tcfg, torch.from_numpy(tok[:, :8]),
                         buf_len=16, **_kw(pfx, False))
    assert_close(jlp, tlp, tol, "prefill logits")
    assert tc["attn"].k.shape == jc["attn"].k.shape
    assert_close(jc["attn"].k, tc["attn"].k, tol, "prefill k cache")
    assert_close(jc["attn"].v, tc["attn"].v, tol, "prefill v cache")
    assert tc["attn"].length == int(jc["attn"].length[0])
    assert tc["attn"].pos == int(jc["attn"].pos[0])
    off = jcfg.n_prefix
    for t in range(8, 12):
        jld, jc = j_dec(jp, jc, jnp.asarray(tok[:, t]),
                        jnp.asarray(off + t, jnp.int32))
        tld, tc = TT.decode_step(model, tcfg, tc, torch.from_numpy(tok[:, t]),
                                 off + t)
        assert_close(jld, tld, tol, f"decode step {t}")
    assert_close(jc["attn"].k, tc["attn"].k, tol, "decode k cache")
    assert tc["attn"].pos == int(jc["attn"].pos[0]) == off + 12


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_equivalence(arch):
    """Decode with cache == teacher-forced logits (float32), as the JAX
    package's own test checks it."""
    _, cfg = smoke_pair(arch, dtype="float32")
    p = TP.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tok, pfx = _inputs(cfg)
    kw = _kw(pfx, False)
    full, _ = TT.forward_train(p, cfg, torch.from_numpy(tok), **kw)
    pre, caches = TT.prefill(p, cfg, torch.from_numpy(tok[:, :-1]), **kw)
    off, S = cfg.n_prefix, tok.shape[1]
    torch.testing.assert_close(pre, full[:, off + S - 2], rtol=2e-4, atol=2e-4)
    dec, _ = TT.decode_step(p, cfg, caches, torch.from_numpy(tok[:, -1]),
                            off + S - 1)
    torch.testing.assert_close(dec, full[:, off + S - 1], rtol=2e-4, atol=2e-4)


def test_ring_buffer_decode_matches_linear_and_jax():
    """A windowed dense config: ring-buffer decode over the whole prefix
    equals linear prefill + decode with the window mask, and the JAX
    package's ring decode."""
    jcfg, tcfg = smoke_pair("qwen1_5_0_5b", dtype="float32", window=6)
    jp, tp = weights(jcfg, tcfg)
    model = TT.build(tp, tcfg)
    S_ctx, n_gen = 10, 4
    tok = np.random.default_rng(8).integers(0, tcfg.vocab, (1, S_ctx + n_gen))
    _, lin = TT.prefill(model, tcfg, torch.from_numpy(tok[:, :S_ctx]))
    ring = TT.init_decode_caches(tcfg, 1, S_ctx + n_gen + 1, long_context=True,
                                 device="cpu")
    jring = JT.init_decode_caches(jcfg, 1, S_ctx + n_gen + 1, long_context=True)
    j_dec = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jcfg, c, t, pos))
    assert ring["attn"].ring and ring["attn"].k.shape[2] == 6
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


def test_layer_fn_and_run_stack_match_the_model():
    _, cfg = smoke_pair("stablelm_1_6b", dtype="float32")
    p = TP.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    model = TT.build(p, cfg)
    assert TT.build(model, cfg) is model
    assert TT.layer_windows(cfg) == [0, 0]
    x = torch.randn(2, 6, cfg.d_model, generator=torch.Generator().manual_seed(2))
    pos = torch.arange(6)
    y, kv, aux = TT.run_stack(p, cfg, x, positions=pos, mode="prefill")
    assert kv["attn"][0].shape == (cfg.n_layers, 2, 6, cfg.n_kv_heads, cfg.d_head)
    h = x
    for i in range(cfg.n_layers):
        h, nc, _ = TT.layer_fn(TT.layer_params(p, cfg, i), cfg, h,
                               positions=pos, window=0, mode="train")
        assert nc == {"attn": None}
    torch.testing.assert_close(h, y, rtol=0, atol=0)
    y2, none, _ = TT.run_stack(model, cfg, x, positions=pos, mode="train")
    assert none is None and torch.equal(y2, y)


@pytest.mark.parametrize("arch", ["whisper_large_v3"])
def test_unported_families_raise(arch):
    """Both packages refuse an enc-dec config without ``enc_frames``:
    ``forward_train``, ``prefill`` and ``ServingEngine.admit`` (whose
    prefill passes none) raise in the reference (``AttributeError``,
    its encoder reads ``None``) and in the port (``ValueError`` naming
    ``enc_frames``)."""
    from repro.runtime.clock_runtime import ClockConfig as JClockConfig
    from repro.serving.engine import ServeConfig as JServe
    from repro.serving.engine import ServingEngine as JEngine
    from repro_torch.runtime.clock_runtime import ClockConfig
    from repro_torch.serving import ServeConfig, ServingEngine

    jcfg, cfg = smoke_pair(arch, dtype="float32")
    jp, p = weights(jcfg, cfg)
    tok = np.zeros((1, 4), np.int32)
    jeng = JEngine(jp, jcfg, JServe(max_seq=16), JClockConfig(m=64))
    for call in (lambda: JT.forward_train(jp, jcfg, jnp.asarray(tok)),
                 lambda: JT.prefill(jp, jcfg, jnp.asarray(tok)),
                 lambda: jeng.admit(jnp.asarray(tok))):
        with pytest.raises(AttributeError):
            call()
    eng = ServingEngine(p, cfg, ServeConfig(max_seq=16), ClockConfig(m=64),
                        device="cpu")
    tok = torch.from_numpy(tok)
    for call in (lambda: TT.forward_train(p, cfg, tok),
                 lambda: TT.prefill(p, cfg, tok),
                 lambda: eng.admit(tok)):
        with pytest.raises(ValueError, match="enc_frames"):
            call()
