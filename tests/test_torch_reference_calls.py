"""The reference's own call patterns through the port, against the JAX
package on the CPU, on the same numpy-seeded inputs:

- ``ClassifyResult``'s result-dict protocol (``res["q_le_p"]``,
  ``.keys()``, ``.items()``), as ``tests/test_fleet.py`` indexes it;
- ``CausalEngine.pairs(alive_dev=)`` on sharded slabs with dead slots
  and a promoted row, and ``ClockRegistry.all_pairs``, which passes it;
- ``models.transformer.run_stack(prefix=, windows=, n_layers=)`` on
  hymba's smoke widths in both layouts;
- the keywords that change nothing in the port (``ops.tick``'s ``bb``,
  ``bm`` and ``interpret``, ``ops.merge_compare``'s ``bb`` and
  ``interpret``, the front door's and ``CausalPolicy``'s ``interpret``,
  the autotuner's ``interpret``): each call bit-identical to the one
  without it.

Tolerances: flags, integers, cells and float32 sums identical (bm = 512
on both sides); Eq. 3 fp bit-identical within the port and within a
relative 5e-2 of the reference's (values at or below the 1e-30 clip
floor count as equal); the stack's activations and caches within 1e-5
absolute and relative (float32, ``tests/test_torch_models.py``'s
``F32_TOL``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import causal as jcausal  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import clock as jbc  # noqa: E402
from repro.fleet import ClockRegistry as JRegistry  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch.mesh import make_fleet_mesh as jmake_fleet_mesh  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import causal as tcausal  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import clock as tbc  # noqa: E402
from repro_torch.fleet import ClockRegistry as TRegistry  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import pack  # noqa: E402
from repro_torch.launch.mesh import make_fleet_mesh  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

FP_RTOL = 5e-2
FP_FLOOR = 1e-30
F32_TOL = dict(rtol=1e-5, atol=1e-5)
CPU = "cpu"
CAP, M, K = 32, 192, 3
KEYS = ["q_le_p", "p_le_q", "sum_q", "sum_p", "fp_q_before_p",
        "fp_p_before_q"]
MATRIX_KEYS = ["a_le_b", "b_le_a", "concurrent", "fp", "row_sums",
               "col_sums"]


def host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_fp_close(a, b):
    a, b = host(a).astype(np.float64), host(b).astype(np.float64)
    assert a.shape == b.shape
    keep = ~((a == b) | ((np.abs(a) <= FP_FLOOR) & (np.abs(b) <= FP_FLOOR)))
    np.testing.assert_allclose(a[keep], b[keep], rtol=FP_RTOL, atol=0)


def assert_same(got, want, keys):
    """Bit-identical leaves under ``keys`` (dtypes included)."""
    for k in keys:
        x, y = torch.as_tensor(got[k]), torch.as_tensor(want[k])
        assert x.dtype == y.dtype and torch.equal(x, y), k


def tpolicy(**kw):
    return tcausal.CausalPolicy(bm=512, bn=8, **kw)


def jpolicy(**kw):
    return jcausal.CausalPolicy(bm=512, bn=8, autotune=False, **kw)


# ---------------------------------------------------------------------------
# (a) ClassifyResult's result-dict protocol
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(5, 300), (33, 129), (17, 512)])
def test_classify_result_answers_the_reference_keys(n, m):
    """``tests/test_fleet.py``'s pattern, ``classify(q, cells)["q_le_p"]``,
    in both packages: the six keys in the reference's order, each the
    field of its name; flags and sums identical, fp within tolerance;
    any other key a ``KeyError``."""
    rng = np.random.default_rng(n)
    cells = rng.integers(0, 20, (n, m)).astype(np.int32)
    cells[1] = cells[0]
    jres = jcausal.CausalEngine(jpolicy()).classify(jnp.asarray(cells[0]),
                                                   jnp.asarray(cells))
    tres = tcausal.CausalEngine(tpolicy()).classify(torch.as_tensor(cells[0]),
                                                   torch.as_tensor(cells))
    assert list(tres.keys()) == list(jres.keys()) == KEYS
    items = dict(tres.items())
    assert list(items) == KEYS
    for k in KEYS:
        assert tres[k] is getattr(tres, k) and items[k] is tres[k]
    for k in ("q_le_p", "p_le_q", "sum_q", "sum_p"):
        np.testing.assert_array_equal(host(tres[k]), np.asarray(jres[k]),
                                      err_msg=k)
    for k in ("fp_q_before_p", "fp_p_before_q"):
        assert_fp_close(tres[k], np.asarray(jres[k]))
    on_host = tres.to_host()
    assert list(on_host.keys()) == KEYS
    assert all(isinstance(v, np.ndarray) for _, v in on_host.items())
    for res in (jres, tres, on_host):
        with pytest.raises(KeyError):
            res["a_le_b"]


def test_comparison_matrix_keeps_the_reference_keys():
    """The mixin ``ClassifyResult`` now shares: ``ComparisonMatrix``'s
    keys in the reference's order, and a foreign key a ``KeyError``."""
    cells = np.random.default_rng(3).integers(0, 20, (9, 200)).astype(np.int32)
    jres = jcausal.CausalEngine(jpolicy()).pairs(jnp.asarray(cells))
    tres = tcausal.CausalEngine(tpolicy()).pairs(torch.as_tensor(cells))
    assert list(tres.keys()) == list(jres.keys()) == MATRIX_KEYS
    assert dict(tres.items())["a_le_b"] is tres.le
    for res in (jres, tres):
        with pytest.raises(KeyError):
            res["q_le_p"]


# ---------------------------------------------------------------------------
# (b) pairs(alive_dev=) and all_pairs on sharded slabs
# ---------------------------------------------------------------------------

def fleet_rows() -> dict:
    """CAP peers with per-row offsets, one of them promoted (a span past
    a byte)."""
    rng = np.random.default_rng(21)
    rows = rng.integers(0, 20, (CAP, M)) + rng.integers(0, 300, (CAP, 1))
    out = {f"peer{i}": rows[i] for i in range(CAP)}
    out["peer7"] = np.where(np.arange(M) % 7 == 0, 1000, 0)
    return out


def filled(rows: dict, shards, port: bool):
    """A registry of ``rows`` (``shards`` None: unsharded), five peers
    evicted."""
    if port:
        mesh = None if shards is None else make_fleet_mesh(shards, device=CPU)
        reg = TRegistry(CAP, M, K, mesh=mesh, policy=tpolicy(), device=CPU)
        make = lambda r: tbc.BloomClock(  # noqa: E731
            torch.as_tensor(np.asarray(r, np.int32)),
            torch.zeros((), dtype=torch.int32), K)
    else:
        mesh = None if shards is None else jmake_fleet_mesh(shards)
        reg = JRegistry(capacity=CAP, m=M, k=K, mesh=mesh, policy=jpolicy())
        make = lambda r: jbc.BloomClock(  # noqa: E731
            jnp.asarray(r, jnp.int32), jnp.zeros((), jnp.int32), K)
    reg.admit_many({pid: make(r) for pid, r in rows.items()})
    reg.evict_many(["peer3", "peer10", "peer17", "peer24", "peer31"])
    return reg


def assert_pairs_identical(got, want):
    got, want = got.to_host(), want.to_host()
    for key in MATRIX_KEYS:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got[key].dtype == want[key].dtype, key


@pytest.mark.parametrize("shards", [None, 1, 2, 4])
def test_pairs_alive_dev_matches_alive_and_the_reference(host_devices, shards):
    """A device mask beside the host one changes nothing: flags, sums and
    fp bits equal the ``alive=`` call and ``all_pairs`` (which passes the
    registry's own mask); against the reference's call with
    ``alive_dev``, flags and sums identical and fp within tolerance."""
    rows = fleet_rows()
    treg, jreg = filled(rows, shards, True), filled(rows, shards, False)
    assert not treg.packed and not jreg.packed
    slab, alive = treg._slab(), treg._alive_host
    assert (~alive).sum() == 5
    plain = treg.engine.pairs(slab, alive=alive)
    got = treg.engine.pairs(slab, alive=alive, alive_dev=treg.alive)
    assert_pairs_identical(got, plain)
    assert_pairs_identical(treg.all_pairs(), plain)
    assert got.engine == plain.engine == (
        "tri+wide_rim" if shards is None else "ring_full+wide_rim")
    jgot = jreg.engine.pairs(jreg._slab(), alive=jreg._alive_host,
                             alive_dev=jreg.alive)
    got = got.to_host()
    for key in ("a_le_b", "b_le_a", "concurrent", "row_sums", "col_sums"):
        np.testing.assert_array_equal(got[key], np.asarray(jgot[key]),
                                      err_msg=key)
    assert_fp_close(got["fp"], np.asarray(jgot["fp"]))


def test_alive_dev_refusals():
    """``alive_dev`` needs a ``PackedSlab`` in both packages, and in the
    port a [capacity] bool tensor on the slab's device: a mask anywhere
    else is refused, not copied."""
    cells = np.random.default_rng(4).integers(0, 20, (8, 64)).astype(np.int32)
    mask = np.ones(8, bool)
    with pytest.raises(ValueError):
        jcausal.CausalEngine(jpolicy()).pairs(
            jnp.asarray(cells), alive_dev=jnp.asarray(mask))
    eng = tcausal.CausalEngine(tpolicy())
    with pytest.raises(ValueError, match="PackedSlab"):
        eng.pairs(torch.as_tensor(cells), alive_dev=torch.as_tensor(mask))
    reg = filled(fleet_rows(), 2, True)
    slab, alive = reg._slab(), reg._alive_host
    for bad in (torch.as_tensor(alive, device="meta"),
                torch.as_tensor(alive, dtype=torch.int32),
                torch.as_tensor(alive[:-1]), alive):
        with pytest.raises(ValueError, match="alive_dev"):
            eng.pairs(slab, alive=alive, alive_dev=bad)


# ---------------------------------------------------------------------------
# (c) run_stack(prefix=, windows=, n_layers=)
# ---------------------------------------------------------------------------

_WEIGHTS = {}


def hymba(scan: bool):
    """hymba-1.5b's smoke config (float32; a 16-token window on layer 1,
    layer 0 global) in both packages and one set of weights, the JAX
    package's carried across."""
    if scan not in _WEIGHTS:
        jcfg, tcfg = (dataclasses.replace(c.get_smoke_config("hymba_1_5b"),
                                          dtype="float32", scan_layers=scan)
                      for c in (jconfigs, tconfigs))
        jp = JP.init_params(jax.random.PRNGKey(0), jcfg)
        tp = convert.params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                                     tcfg, device=CPU)
        _WEIGHTS[scan] = jcfg, tcfg, jp, tp
    return _WEIGHTS[scan]


def renamed(params: dict, rows: int | None) -> dict:
    """``params`` with the layer stack under "alt" (``alt/...`` or
    ``alt_{i}/...``), a stacked one cut to its first ``rows``."""
    out = {}
    for k, v in params.items():
        if k.startswith("layers"):
            k = "alt" + k[len("layers"):]
            v = v[:rows] if rows is not None and k.startswith("alt/") else v
        out[k] = v
    return out


def stack_kwargs(case: str, scan: bool, jcfg, tcfg, jp, tp):
    """(jax params, jax kwargs, port params, port kwargs) of one case."""
    if case == "windows":
        return (jp, dict(windows=JT.layer_windows(jcfg, force_window=True)),
                tp, dict(windows=TT.layer_windows(tcfg, force_window=True)))
    if case == "n_layers":
        return jp, dict(n_layers=1), tp, dict(n_layers=1)
    # a stacked "alt" of one row at n_layers=1 (the reference's scan
    # takes the windows' and the stack's rows alike); an unstacked
    # "alt_0", "alt_1" at the default depth, global windows
    kw = dict(prefix="alt", n_layers=1) if scan else dict(prefix="alt")
    rows = 1 if scan else None
    return renamed(jp, rows), kw, renamed(tp, rows), dict(kw)


def leaves(kv: dict) -> dict:
    """A prefill cache dict's tensors by (key, index or field)."""
    out = {}
    for key, c in kv.items():
        if isinstance(c, tuple) and not hasattr(c, "_fields"):
            out.update({(key, i): x for i, x in enumerate(c)})
        else:
            out.update({(key, f): getattr(c, f) for f in ("conv", "state")})
    return out


@pytest.mark.parametrize("case", ["windows", "n_layers", "prefix"])
@pytest.mark.parametrize("scan", [True, False])
def test_run_stack_keywords_match_the_reference(scan, case):
    """x, the prefill caches and aux (prefill and train) of the
    reference's ``run_stack`` with the same keywords, on carried-over
    weights, and a decode step on both packages' prefill caches (x and
    the advanced caches).  At ``n_layers=1`` a stacked layout runs both
    rows, as the reference's scan does, an unstacked one the first."""
    jcfg, tcfg, jp, tp = hymba(scan)
    jpar, jkw, tpar, tkw = stack_kwargs(case, scan, jcfg, tcfg, jp, tp)
    x = np.random.default_rng(1).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    for mode in ("prefill", "train"):
        jy, jkv, jaux = JT.run_stack(jpar, jcfg, jnp.asarray(x),
                                     positions=jnp.arange(24), mode=mode,
                                     **jkw)
        ty, tkv, taux = TT.run_stack(tpar, tcfg, torch.as_tensor(x),
                                     positions=torch.arange(24), mode=mode,
                                     **tkw)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32_TOL)
        np.testing.assert_allclose(float(taux), float(jaux), **F32_TOL)
        if mode == "train":
            assert tkv is None and jkv is None
            continue
        jl, tl = leaves(jkv), leaves(tkv)
        assert list(tl) == list(jl)
        depth = 1 if (case == "n_layers" and not scan) or (
            case == "prefix" and scan) else 2
        for k in jl:
            assert tl[k].shape[0] == depth
            np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                       err_msg=str(k), **F32_TOL)
    if case != "prefix":     # the caches hold the "layers" stack's depth
        tok = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 20))
        _, jc = JT.prefill(jp, jcfg, jnp.asarray(tok, jnp.int32), buf_len=32)
        _, tc = TT.prefill(tp, tcfg, torch.as_tensor(tok, dtype=torch.int32),
                           buf_len=32)
        jy, jn, _ = JT.run_stack(jpar, jcfg, jnp.asarray(x[:, :1]),
                                 positions=jnp.asarray([20]), mode="decode",
                                 caches=jc, **jkw)
        ty, tn, _ = TT.run_stack(tpar, tcfg, torch.as_tensor(x[:, :1]),
                                 positions=torch.tensor([20]), mode="decode",
                                 caches=tc, **tkw)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32_TOL)
        assert tn["attn"].pos == int(np.asarray(jn["attn"].pos)[0]) == 21
        for key, field in (("attn", "k"), ("attn", "v"), ("ssm", "conv"),
                           ("ssm", "state")):
            got, want = getattr(tn[key], field), getattr(jn[key], field)
            assert got.shape == want.shape, (key, field)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f"{key}.{field}", **F32_TOL)
    if case == "windows":
        # the forced window reaches layer 0 (global by default)
        default, _, _ = TT.run_stack(tp, tcfg, torch.as_tensor(x),
                                     positions=torch.arange(24),
                                     mode="train")
        assert not torch.allclose(default, ty)


def test_run_stack_keywords_refusals(monkeypatch):
    """A ``Transformer`` holds only the default stack; a stacked layout's
    windows must match its rows, as the reference's scan requires; the
    keywords run on plain tensors only (a stand-in makes every tensor
    count as a DTensor here)."""
    jcfg, tcfg, jp, tp = hymba(True)
    x = torch.zeros((1, 4, tcfg.d_model))
    pos = torch.arange(4)
    with pytest.raises(ValueError, match="flat param dict"):
        TT.run_stack(TT.build(tp, tcfg), tcfg, x, positions=pos,
                     mode="train", prefix="alt")
    with pytest.raises(ValueError):
        JT.run_stack(jp, jcfg, jnp.zeros((1, 4, jcfg.d_model)),
                     positions=jnp.arange(4), mode="train",
                     windows=jnp.zeros((1,), jnp.int32))
    with pytest.raises(ValueError, match="windows and caches"):
        TT.run_stack(tp, tcfg, x, positions=pos, mode="train", windows=[0])
    monkeypatch.setattr(TT, "DTensor", torch.Tensor)
    with pytest.raises(ValueError, match="plain tensors"):
        TT.run_stack(tp, tcfg, x, positions=pos, mode="train", n_layers=1)


# ---------------------------------------------------------------------------
# (d) keywords without effect
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [128, 200])
def test_tick_block_keywords_change_nothing(m):
    """``ops.tick``'s ``bb``, ``bm`` and ``interpret`` change no cell; the
    reference's tick at the same blocks (in its interpret mode, the only
    one it runs on the CPU) gives the same cells."""
    rng = np.random.default_rng(m)
    cells = rng.integers(0, 50, (5, m)).astype(np.int32)
    hi = rng.integers(0, 2 ** 32, (5, 7), dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2 ** 32, (5, 7), dtype=np.uint64).astype(np.uint32)
    args = torch.as_tensor(cells), hi.astype(np.int64), lo.astype(np.int64)
    want = tops.tick(*args, k=4)
    for kw in (dict(bb=16), dict(bm=128), dict(interpret=True),
               dict(bb=16, bm=128, interpret=False)):
        got = tops.tick(*args, k=4, **kw)
        assert got.dtype == want.dtype and torch.equal(got, want), kw
        ref = jops.tick(jnp.asarray(cells), jnp.asarray(hi), jnp.asarray(lo),
                        k=4, **{k: v for k, v in kw.items() if k != "interpret"})
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_merge_compare_block_keywords_change_nothing():
    """``ops.merge_compare``'s ``bb`` and ``interpret`` change no leaf, fp
    bits included, at the bm that sets the sums' order."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 40, (6, 640)).astype(np.int32)
    b = (a + rng.integers(0, 2, a.shape) * (np.arange(6)[:, None] % 2)
         ).astype(np.int32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    for bm in (512, 128):
        want = tops.merge_compare(ta, tb, bm=bm)
        for kw in (dict(bb=32), dict(interpret=True), dict(bb=4, interpret=False)):
            assert_same(tops.merge_compare(ta, tb, bm=bm, **kw), want,
                        list(want))


def _slab(n=24, m=200, seed=6):
    rng = np.random.default_rng(seed)
    cells = torch.as_tensor(rng.integers(0, 9, (n, m)) + rng.integers(0, 5, (n, 1)),
                            dtype=torch.int32)
    base = cells.amin(dim=1)
    u8, b, ok = pack.pack_rows(cells, base)
    assert bool(ok.all())
    return cells, tcausal.PackedSlab(u8, b)


@pytest.mark.parametrize("interpret", [True, False])
def test_engine_and_policy_interpret_change_nothing(interpret):
    """The front door's ``interpret`` and ``CausalPolicy(interpret=)``:
    classify (int32 and packed) and pairs bit-identical to the calls
    without them, and the policy's label unchanged."""
    cells, slab = _slab()
    q = cells[5]
    base = tcausal.CausalEngine(tpolicy())
    pol = tpolicy(interpret=interpret)
    assert pol.interpret is interpret and pol.label() == tpolicy().label()
    assert tpolicy().merged(interpret=interpret) == pol
    for eng, kw in ((base, dict(interpret=interpret)),
                    (tcausal.CausalEngine(pol), {})):
        for peers in (cells, slab):
            assert_same(eng.classify(q, peers, **kw),
                        base.classify(q, peers), KEYS)
            assert_same(eng.pairs(peers, **kw), base.pairs(peers),
                        MATRIX_KEYS)


def test_autotune_interpret_changes_nothing(monkeypatch):
    """The ten autotune functions with ``interpret`` give what they give
    without it: the keys, the lookups and the model's predictions, and
    the sweeps with their measured times pinned (every candidate still
    runs once), winners and explanations alike.  A bool where the port
    takes the table backend, the reference's positional ``interpret``,
    is a ``TypeError``."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_TABLE", "/nonexistent.json")

    def pinned(fn, dev, reps=3, count=True):
        fn()
        return 1e-3

    monkeypatch.setattr(autotune, "_measure", pinned)
    for interpret in (True, False):
        kw = dict(interpret=interpret)
        assert autotune.key_for("matrix", 300, 300, 256, "cpu", 2, **kw) == \
            autotune.key_for("matrix", 300, 300, 256, "cpu", 2)
        assert autotune.lookup("one_vs_many", 64, 64, 256, "cpu", **kw) == \
            autotune.lookup("one_vs_many", 64, 64, 256, "cpu")
        for backend in ("cpu", "cuda"):
            args = ("tri", 1024, 1024, 256, 64, 64, 256, backend)
            assert autotune.predict_cost(*args, regs=64, **kw) == \
                autotune.predict_cost(*args, regs=64)
            args = (4096, 512, 256, 8, 256, backend)
            assert autotune.predict_hybrid_cost(*args, regs=64, **kw) == \
                autotune.predict_hybrid_cost(*args, regs=64)
        regs = {"tri": 64, "full": 64}
        args = ("ring", 4096, 256, 4, "cuda")
        assert autotune.predict_sharded_cost(*args, regs=regs, **kw) == \
            autotune.predict_sharded_cost(*args, regs=regs)
        for fn, fargs, extra in (
                (autotune.autotune_matrix, (32, 128), dict(span=10)),
                (autotune.autotune_matrix_sharded, (32, 128, 2), {}),
                (autotune.autotune_one_vs_many, (64, 128), {}),
                (autotune.autotune_hybrid, (64, 128), {})):
            got, want = {}, {}
            assert fn(*fargs, device=CPU, explain=got, **extra, **kw) == \
                fn(*fargs, device=CPU, explain=want, **extra)
            assert got == want, fn.__name__
        assert autotune.autotune_shapes([(16, 128)], device=CPU, **kw) == \
            autotune.autotune_shapes([(16, 128)], device=CPU)
    with pytest.raises(TypeError, match="interpret"):
        autotune.key_for("matrix", 300, 300, 256, True)
    with pytest.raises(TypeError, match="interpret"):
        autotune.predict_cost("tri", 1024, 1024, 256, 64, 64, 256, False)
