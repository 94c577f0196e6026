"""The port's MoE family (``repro_torch.models.moe``, ``models.mla`` and
their branches in ``models.transformer``) against the JAX package's on
the CPU.

The same numpy-seeded inputs and the same weights (the JAX package's
``init_params``, carried across by ``convert.params_from_jax``) go
through the JAX function and the port's, at the two ``moe`` smoke
configs (``grok_1_314b.SMOKE``: top-2, no MLA; ``deepseek_v2_236b
.SMOKE``: MLA, top-2, one shared expert) and variants of them.
Tolerances:

- identical: expert ids of the router's top-k (also on tie-heavy
  bfloat16 logits), the dispatch bookkeeping (tokens, experts, ranks,
  kept slots), physical ids, capacities, cache lengths and positions;
- bit-identical: ``_combine`` given identical expert outputs and gates,
  at top-2 and top-6 in bfloat16 and float32 (the reference's
  scatter-add rounds after every update, in sorted-slot order);
- float32 compute: outputs, aux, logits and caches within ``F32_TOL``
  (rtol and atol 1e-5: the frameworks sum the products in different
  orders; the largest gap seen on the smoke configs is 2.8e-6);
- bfloat16 compute: within ``BF16_TOL`` (atol 6.25e-2, rtol 2e-2, four
  bfloat16 ulps at magnitude 2-4; the largest gap seen is 0.034), and
  the top-k gates within one bfloat16 ulp (``GATE_TOL``: each framework
  rounds the softmax's exp and sum in its own places).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mla as JMLA  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mla as TMLA  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=6.25e-2)
GATE_TOL = dict(rtol=2 ** -7, atol=0)     # a bfloat16 ulp is <= 2^-7 |x|
MOE = ("grok_1_314b", "deepseek_v2_236b")


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


def bits(x):
    """The raw bits of a bfloat16 or float32 array, for bit-identity."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x.view(torch.int32)).numpy()
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def assert_close(j, t, tol=F32_TOL, what=""):
    np.testing.assert_allclose(host(t), host(j), err_msg=what, **tol)


def tensors(a, dtype):
    """A numpy float32 array as a JAX and a torch array of ``dtype``
    (the same values: bfloat16 rounds the same way in both)."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return j, t


def layer0(params, cfg, prefix):
    """Layer 0's ``prefix`` block as a flat dict (stacked layout)."""
    return {k: v[0] for k, v in JL.sub(JL.sub(params, "layers"), prefix).items()}


# ---------------------------------------------------------------------------
# moe.py's helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,k", [(8, 2), (160, 6), (4, 2)])
def test_top_k_gates_breaks_ties_as_lax_top_k(E, k):
    """4,096 rows of bfloat16 logits drawn from 6 values (ties in almost
    every row): ids identical, gates within one bfloat16 ulp."""
    rng = np.random.default_rng(E)
    a = rng.integers(-3, 3, (4096, E)).astype(np.float32) / 4
    j, t = tensors(a, jnp.bfloat16)
    jg, ji = JM._top_k_gates(j, k)
    tg, ti = TM._top_k_gates(t, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tg.dtype == torch.bfloat16
    np.testing.assert_allclose(host(tg), host(jg), **GATE_TOL)


@pytest.mark.parametrize("replicas", [1, 2])
def test_phys_idx_identical(replicas):
    rng = np.random.default_rng(2)
    idx = np.stack([rng.permutation(8)[:3] for _ in range(37)]).astype(np.int32)
    want = np.asarray(JM._phys_idx(jnp.asarray(idx), replicas))
    got = TM._phys_idx(torch.from_numpy(idx).long(), replicas)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("T,k,E,C", [(40, 2, 8, 3), (64, 6, 16, 30),
                                     (33, 2, 4, 1)])
def test_dispatch_indices_with_drops_identical(T, k, E, C):
    """Skewed routing (half the slots to expert 0) so full experts drop
    slots: sorted tokens, experts, ranks and kept slots identical."""
    rng = np.random.default_rng(T)
    idx = np.stack([rng.choice(E, k, replace=False,
                               p=np.r_[0.5, np.full(E - 1, 0.5 / (E - 1))])
                    for _ in range(T)]).astype(np.int32)
    want = JM._dispatch_indices(jnp.asarray(idx), T, k, E, C)
    got = TM._dispatch_indices(torch.from_numpy(idx).long(), T, k, E, C)
    assert not np.asarray(want[3]).all()          # some slots dropped
    for name, w, g in zip(("token", "expert", "rank", "keep"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("k,E", [(2, 8), (6, 16)])
def test_combine_bit_identical(k, E, dtype):
    """Identical expert outputs and gates (T = 512, D = 64, random
    top-k, capacity 0.75 of the even share so some slots drop): the
    combine is bit for bit the reference's."""
    T, D = 512, 64
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    rng = np.random.default_rng(k)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    C = max(1, int(0.75 * T * k / E))
    tok, exp, rank, keep = JM._dispatch_indices(jnp.asarray(idx), T, k, E, C)
    dest = exp * C + jnp.minimum(rank, C - 1)
    ye, tye = tensors(rng.standard_normal((E * C, D)).astype(np.float32), jdt)
    gates, tgates = tensors(rng.random(T * k).astype(np.float32), jdt)
    want = JM._combine((T, D), jdt, ye, tok, dest, keep, gates)
    got = TM._combine((T, D), tye.dtype, tye,
                      *(torch.from_numpy(np.array(a)).long()
                        for a in (tok, dest)),
                      torch.from_numpy(np.array(keep)), tgates)
    assert got.dtype == tye.dtype
    np.testing.assert_array_equal(bits(got), bits(want))


def test_aux_loss_matches():
    rng = np.random.default_rng(4)
    logits, tl = tensors(rng.standard_normal((96, 16)).astype(np.float32),
                         jnp.bfloat16)
    idx = np.argsort(-rng.random((96, 6)), -1)
    want = JM._aux_loss(logits, jnp.asarray(idx), 16)
    got = TM._aux_loss(tl, torch.from_numpy(idx), 16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

MOE_CASES = [(arch, replicas, cap, dtype)
             for arch in MOE for replicas in (1, 2) for cap in (1.25, 0.5)
             for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("arch,replicas,cap,dtype", MOE_CASES)
def test_moe_ffn_matches_reference(arch, replicas, cap, dtype):
    """grok's smoke MoE (no shared expert) and DeepSeek's (one shared
    expert) at ``moe_replicas`` 1 and 2, capacity factor 1.25 and 0.5
    (drops), float32 and bfloat16: output within the dtype's tolerance,
    aux within rtol 1e-5 (float32) or 2e-3 (bfloat16 logits an ulp
    apart move the float32 probabilities).  Routing: the router's
    logits within the dtype's tolerance; on the reference's logits the
    port's top-k ids, physical ids and kept slots identical to the
    reference's, and on its own logits the same ids."""
    jcfg, tcfg = smoke_pair(arch, moe_replicas=replicas, capacity_factor=cap,
                            dtype=dtype)
    jp, tp = weights(jcfg, tcfg)
    jm, tm = layer0(jp, jcfg, "moe"), TL.sub(TT.layer_params(tp, tcfg, 0), "moe")
    jdt, tdt = jcfg.compute_dtype, tcfg.compute_dtype
    x, tx = tensors(np.random.default_rng(5).standard_normal(
        (2, 12, jcfg.d_model)).astype(np.float32), jdt)
    jy, jaux = jax.jit(lambda p, x: JM.moe_ffn(p, jcfg, x))(jm, x)
    ty, taux = TM.moe_ffn({k: v.to(tdt) for k, v in tm.items()}, tcfg, tx)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert ty.dtype == tdt and ty.shape == jy.shape
    assert_close(jy, ty, tol, "moe_ffn")
    np.testing.assert_allclose(float(taux), float(jaux),
                               rtol=1e-5 if dtype == "float32" else 2e-3)

    T, k = 24, jcfg.top_k
    jl = x.reshape(T, -1) @ jm["router"].astype(jdt)
    tl = tx.reshape(T, -1) @ tm["router"].to(tdt)
    assert_close(jl, tl, tol, "router logits")
    E_phys = jcfg.n_experts * replicas
    C = TM._capacity(tcfg, T, E_phys)
    assert C == max(1, int(cap * T * k / E_phys))
    _, ji = JM._top_k_gates(jl, k)
    _, ti = TM._top_k_gates(torch.from_numpy(bits(jl)).view(tdt), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(TM._top_k_gates(tl, k)[1].numpy(),
                                  np.asarray(ji))
    jphys, tphys = JM._phys_idx(ji, replicas), TM._phys_idx(ti, replicas)
    np.testing.assert_array_equal(tphys.numpy(), np.asarray(jphys))
    jkeep = JM._dispatch_indices(jphys, T, k, E_phys, C)[3]
    tkeep = TM._dispatch_indices(tphys, T, k, E_phys, C)[3]
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert cap == 1.25 or not tkeep.all()          # 0.5 drops slots


def test_moe_ffn_gradients_match_reference():
    """float32, DeepSeek's smoke MoE with drops and replicas 2: the
    gradients of sum(y * w) + aux with respect to the input and every
    weight within rtol 1e-4 / atol 1e-5 (dropped slots pass none)."""
    jcfg, tcfg = smoke_pair("deepseek_v2_236b", moe_replicas=2,
                            capacity_factor=0.5, dtype="float32")
    jp, tp = weights(jcfg, tcfg)
    jm = layer0(jp, jcfg, "moe")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = JM.moe_ffn(p, jcfg, x)
        return jnp.sum(y * w) + aux

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jm, jnp.asarray(x))
    tm = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in jm.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = TM.moe_ffn(tm, tcfg, tx)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]),
                               rtol=1e-4, atol=1e-5)
    for k, v in tm.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg[0][k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# mla.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_block_prefill_and_decode_match_reference(dtype):
    """DeepSeek's smoke MLA: the prefill output and latents (ckv, k_rope)
    of 8 positions, then 4 absorbed decode steps against the latent
    cache (a 16-slot buffer): outputs, cache contents, lengths and
    positions."""
    jcfg, tcfg = smoke_pair("deepseek_v2_236b", dtype=dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jp, tp = weights(jcfg, tcfg)
    ja = layer0(jp, jcfg, "attn")
    model = TT.build(tp, tcfg)
    ta = model.layers[0].attn.weights       # compute dtype, norms float32
    x, tx = tensors(np.random.default_rng(9).standard_normal(
        (2, 12, jcfg.d_model)).astype(np.float32), jcfg.compute_dtype)
    pos = np.arange(8)
    jo, (jckv, jkr) = jax.jit(lambda p, x: JMLA.mla_block(
        p, jcfg, x, positions=jnp.asarray(pos)))(ja, x[:, :8])
    to, (tckv, tkr) = TMLA.mla_block(ta, tcfg, tx[:, :8],
                                     positions=torch.from_numpy(pos))
    assert to.dtype == tcfg.compute_dtype
    assert_close(jo, to, tol, "prefill output")
    assert_close(jckv, tckv, tol, "prefill ckv")
    assert_close(jkr, tkr, tol, "prefill k_rope")

    def pad(a):
        return np.pad(np.asarray(host(a)), ((0, 0), (0, 8), (0, 0)))

    jc = JMLA.MLACache(ckv=jnp.asarray(pad(jckv)).astype(jcfg.compute_dtype),
                       krope=jnp.asarray(pad(jkr)).astype(jcfg.compute_dtype),
                       length=jnp.asarray(8, jnp.int32),
                       pos=jnp.asarray(8, jnp.int32))
    tc = TMLA.MLACache(ckv=torch.from_numpy(pad(jckv)).to(tcfg.compute_dtype),
                       krope=torch.from_numpy(pad(jkr)).to(tcfg.compute_dtype),
                       length=8, pos=8)
    j_dec = jax.jit(lambda p, x, c, pos: JMLA.mla_block(
        p, jcfg, x, positions=pos, cache=c))
    for t in range(8, 12):
        jo, jc = j_dec(ja, x[:, t:t + 1], jc, jnp.asarray([t]))
        to, tc = TMLA.mla_block(ta, tcfg, tx[:, t:t + 1],
                                positions=torch.tensor([t]), cache=tc)
        assert_close(jo, to, tol, f"decode step {t}")
        assert (tc.length, tc.pos) == (int(jc.length), int(jc.pos)) == (t + 1,
                                                                        t + 1)
    assert_close(jc.ckv, tc.ckv, tol, "decode ckv cache")
    assert_close(jc.krope, tc.krope, tol, "decode krope cache")


def test_init_mla_cache_matches_reference():
    jcfg, tcfg = smoke_pair("deepseek_v2_236b")
    jc = JT.init_decode_caches(jcfg, 3, 20)["attn"]
    tc = TT.init_decode_caches(tcfg, 3, 20, device="cpu")["attn"]
    assert isinstance(tc, TMLA.MLACache)
    for name in ("ckv", "krope"):
        j, t = getattr(jc, name), getattr(tc, name)
        assert tuple(t.shape) == j.shape and t.dtype == torch.bfloat16
        assert not t.any()
    assert (tc.length, tc.pos) == (0, 0)
    assert TT.init_decode_caches(tcfg, 3, 20, long_context=True,
                                 device="cpu")["attn"].ckv.shape[2] == 20


# ---------------------------------------------------------------------------
# the stack: forward, prefill, decode
# ---------------------------------------------------------------------------

STACK_CASES = [(a, dt, scan) for a in MOE for dt in ("float32", "bfloat16")
               for scan in (True, False)]


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
    assert taux.dtype == torch.float32 and float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux),
                               rtol=1e-5 if dtype == "float32" else 2e-3)

    model = TT.build(tp, tcfg)
    jlp, jc = jax.jit(lambda p, t: JT.prefill(p, jcfg, t, buf_len=16))(
        jp, jnp.asarray(tok[:, :8]))
    tlp, tc = TT.prefill(model, tcfg, torch.from_numpy(tok[:, :8]), buf_len=16)
    assert_close(jlp, tlp, tol, "prefill logits")
    names = ("ckv", "krope") if jcfg.use_mla else ("k", "v")
    for name in names:
        j, t = getattr(jc["attn"], name), getattr(tc["attn"], name)
        assert tuple(t.shape) == j.shape
        assert_close(j, t, tol, f"prefill {name} cache")
    assert tc["attn"].length == int(jc["attn"].length[0]) == 8
    j_dec = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jcfg, c, t, pos))
    for t in range(8, 12):
        jld, jc = j_dec(jp, jc, jnp.asarray(tok[:, t]), jnp.asarray(t, jnp.int32))
        tld, tc = TT.decode_step(model, tcfg, tc, torch.from_numpy(tok[:, t]), t)
        assert_close(jld, tld, tol, f"decode step {t}")
    for name in names:
        assert_close(getattr(jc["attn"], name), getattr(tc["attn"], name), tol,
                     f"decode {name} cache")
    assert tc["attn"].pos == int(jc["attn"].pos[0]) == 12


@pytest.mark.parametrize("arch", MOE)
def test_prefill_decode_equivalence(arch):
    """Decode with the cache == teacher-forced logits (float32, no
    capacity drops: ``capacity_factor=64``), as the JAX package's own
    test checks it."""
    _, cfg = smoke_pair(arch, dtype="float32", capacity_factor=64.0)
    p = TP.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (2, 12)))
    full, _ = TT.forward_train(p, cfg, tok)
    pre, caches = TT.prefill(p, cfg, tok[:, :-1])
    torch.testing.assert_close(pre, full[:, 10], rtol=2e-4, atol=2e-4)
    dec, _ = TT.decode_step(p, cfg, caches, tok[:, -1], 11)
    torch.testing.assert_close(dec, full[:, 11], rtol=2e-4, atol=2e-4)


def test_layer_fn_and_run_stack_sum_aux():
    """The functional entry points on DeepSeek's smoke config: run_stack's
    aux is the layers' auxes summed in order, its prefill caches the
    stacked (ckv, k_rope), and a dense config's aux is 0."""
    _, cfg = smoke_pair("deepseek_v2_236b", dtype="float32")
    p = TP.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    x = torch.randn(2, 6, cfg.d_model, generator=torch.Generator().manual_seed(2))
    pos = torch.arange(6)
    y, kv, aux = TT.run_stack(p, cfg, x, positions=pos, mode="prefill")
    assert kv["attn"][0].shape == (cfg.n_layers, 2, 6, cfg.kv_lora_rank)
    assert kv["attn"][1].shape == (cfg.n_layers, 2, 6, cfg.qk_rope_dim)
    h, total = x, torch.zeros(())
    for i in range(cfg.n_layers):
        h, nc, a = TT.layer_fn(TT.layer_params(p, cfg, i), cfg, h,
                               positions=pos, window=0, mode="train")
        assert nc == {"attn": None} and float(a) > 0
        total = total + a
    torch.testing.assert_close(h, y, rtol=0, atol=0)
    assert torch.equal(total, aux)
    _, dense = smoke_pair("qwen1_5_0_5b", dtype="float32")
    pd = TP.init_params(torch.Generator().manual_seed(1), dense, device="cpu")
    _, _, aux0 = TT.run_stack(pd, dense, x, positions=pos, mode="train")
    assert float(aux0) == 0.0
