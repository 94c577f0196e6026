"""The port's public surface against the reference's, without importing
JAX, from the ``ast`` of both packages:

- every name in a reference module's ``__all__`` is in the ``__all__``
  of the port's module at the same path, and defined there;
- every public function and class of a ported reference module is in
  the port's module: a function with every parameter name the
  reference's has, a class with every public method (those it takes
  from bases defined in its module too) and its parameter names, every
  dataclass field and every class attribute;

but what stands, with its reason, in ``KEPT_MODULES``, ``KEPT`` (names),
``KEPT_KEYWORDS`` (parameters) or ``KEPT_MEMBERS`` (class members); each
kept entry must name something the reference has and the port lacks.
The deprecated shims of ``kernels/ops.py`` warn ``DeprecationWarning``
and give the front door's results bit for bit.
"""
import ast
import functools
import importlib
import pathlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import causal  # noqa: E402
from repro_torch.kernels import ops, pack  # noqa: E402
from repro_torch.launch.mesh import make_fleet_mesh  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

#: reference modules without a port, and why
KEPT_MODULES = {
    "kernels/bloom_tick.py": "the Pallas tick kernel; its port is "
                             "csrc/bloom_tick.cu behind ops.tick",
    "kernels/bloom_compare.py": "the Pallas merge-compare kernel; its port "
                                "is csrc/bloom_compare.cu behind "
                                "ops.merge_compare",
    "kernels/bloom_matrix.py": "the Pallas one-vs-many and all-pairs entry "
                               "points; their ports are csrc/one_vs_many.cu, "
                               "bloom_matrix.cu and bloom_mxu.cu behind "
                               "ops' wrappers",
    "kernels/generate.py": "Pallas kernels generated from CompareSpec; the "
                           "port's kernels are written in csrc/ and built "
                           "by nvcc",
}
#: names of ported modules the port does not have, and why
KEPT = {
    ("kernels/ops.py", "tile2d"): "the TPU's lane and sublane pad-and-crop "
                                  "plan; the CUDA kernels mask the ragged "
                                  "edge, and tile_width keeps the m-tile",
    ("kernels/template.py", "emit"): "emits a Pallas kernel; the CUDA "
                                     "kernels are written in csrc/",
    ("kernels/template.py", "vmem_estimate"): "TPU VMEM bytes of a Pallas "
                                              "instance; the card's "
                                              "counterpart is shared-memory "
                                              "bytes (template.smem_estimate)",
    ("kernels/template.py", "VMEM_BUDGET"): "the TPU's VMEM budget; the "
                                            "card's is its shared memory "
                                            "a block",
    ("kernels/autotune.py", "vmem_bytes"): "TPU VMEM bytes of a candidate; "
                                           "the autotuner prunes by shared "
                                           "memory instead",
    ("sharding.py", "slab_shardings"): "a NamedSharding of one global slab "
                                       "over TPU devices; the port's fleet "
                                       "mesh keeps one tensor a row shard "
                                       "(FleetMesh, shard_rows, split_rows)",
    ("launch/dryrun.py", "collective_bytes"): "sums collective bytes from "
                                              "XLA's HLO text; the port has "
                                              "no HLO, and its dry run sums "
                                              "the functional collectives' "
                                              "output bytes",
}
_GENERATOR = ("draws from a torch.Generator, which the port's entry point "
              "takes in its place, so parity runs on carried-over weights")
#: parameters of ported functions and methods the port does not take, and
#: why: (module, function or "Class.method", parameter) -> reason
KEPT_KEYWORDS = {
    ("models/params.py", "init_params", "key"): "a JAX PRNG key; " + _GENERATOR,
    ("runtime/training.py", "init_train_state", "key"): "a JAX PRNG key; "
                                                        + _GENERATOR,
}
_PYTREE = ("a JAX pytree hook (jit, vmap, device_put); the port's results "
           "and states are plain dataclasses of tensors")
#: public members of ported classes the port does not have, and why:
#: (module, class, member) -> reason
KEPT_MEMBERS = {
    (rel, cls, hook): _PYTREE
    for rel, cls in (("causal/results.py", "Comparison"),
                     ("causal/results.py", "ComparisonMatrix"),
                     ("causal/results.py", "ClassifyResult"),
                     ("core/clock.py", "BloomClock"),
                     ("core/history.py", "History"),
                     ("core/vector_clock.py", "VectorClock"),
                     ("optim/adamw.py", "Moment"),
                     ("runtime/training.py", "TrainState"))
    for hook in ("tree_flatten", "tree_unflatten")
}


def all_names(path: pathlib.Path):
    """The strings of a module's ``__all__``, or None without one."""
    for node in ast.parse(path.read_text()).body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        if any(getattr(t, "id", None) == "__all__" for t in targets):
            return [e.value for e in node.value.elts]
    return None


def reference_modules() -> list:
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py")
                  if all_names(p) is not None)


def _params(fn: ast.FunctionDef) -> list:
    """Parameter names, with "*" and "**" for ``*args`` and ``**kw``."""
    a = fn.args
    return ([x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
            + ["*"] * bool(a.vararg) + ["**"] * bool(a.kwarg))


def _public(name: str) -> bool:
    return not name.startswith("_") or (name.startswith("__")
                                        and name.endswith("__"))


def _members(cls: ast.ClassDef, classes: dict) -> dict:
    """A class's public members, its same-module bases' first: a method's
    parameter list, "field" (annotated: a dataclass or NamedTuple field)
    or "attr"."""
    out = {}
    for base in cls.bases:
        if getattr(base, "id", None) in classes:
            out.update(_members(classes[base.id], classes))
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(node.name):
                out[node.name] = _params(node)
        elif isinstance(node, ast.AnnAssign):
            if not node.target.id.startswith("_"):
                out[node.target.id] = "field"
        elif isinstance(node, ast.Assign):
            out.update({t.id: "attr" for t in node.targets
                        if isinstance(t, ast.Name) and not t.id.startswith("_")})
    return out


@functools.lru_cache(maxsize=None)
def surface(path: pathlib.Path) -> dict:
    """A module's public functions (name -> parameter list) and classes
    (name -> ``_members``), or {} without the module."""
    if not path.exists():
        return {}
    body = ast.parse(path.read_text()).body
    classes = {n.name: n for n in body if isinstance(n, ast.ClassDef)}
    out = {}
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = _members(node, classes)
    return {k: v for k, v in out.items() if not k.startswith("_")}


def ported_modules() -> list:
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py")
                  if str(p.relative_to(REF)) not in KEPT_MODULES)


SURFACE_CASES = [(rel, name) for rel in ported_modules()
                 for name in surface(REF / rel)]


@pytest.mark.parametrize("rel", reference_modules())
def test_reference_public_names_are_in_the_port(rel):
    if rel in KEPT_MODULES:
        assert not (PORT / rel).exists(), rel
        return
    want = all_names(REF / rel)
    have = all_names(PORT / rel) or []
    missing = [n for n in want if n not in have and (rel, n) not in KEPT]
    assert not missing, (rel, missing)
    kept = [n for n in want if (rel, n) in KEPT]
    assert not set(kept) & set(have), (rel, kept)
    name = "repro_torch." + rel[:-3].replace("/", ".").removesuffix(
        ".__init__")
    mod = importlib.import_module(name)
    assert all(hasattr(mod, n) for n in have), \
        [n for n in have if not hasattr(mod, n)]


def _missing_params(rel: str, where: str, want: list, have: list) -> list:
    """Reference parameters the port lacks, but those kept."""
    return [p for p in want
            if p not in have and (rel, where, p) not in KEPT_KEYWORDS]


@pytest.mark.parametrize("rel,name", SURFACE_CASES)
def test_reference_signatures_and_members_are_in_the_port(rel, name):
    want, have = surface(REF / rel)[name], surface(PORT / rel).get(name)
    if (rel, name) in KEPT:
        assert have is None, (rel, name)
        return
    assert type(have) is type(want), (rel, name, have)
    if isinstance(want, list):
        assert not _missing_params(rel, name, want, have), \
            (rel, name, _missing_params(rel, name, want, have))
        return
    for member, sig in want.items():
        if (rel, name, member) in KEPT_MEMBERS:
            continue
        got = have.get(member)
        assert got is not None, (rel, name, member)
        if sig == "field":
            assert got == "field", (rel, name, member, got)
        elif isinstance(sig, list):
            where = f"{name}.{member}"
            assert isinstance(got, list), (rel, where, got)
            assert not _missing_params(rel, where, sig, got), \
                (rel, where, _missing_params(rel, where, sig, got))


def test_kept_differences_name_reference_names():
    """Each kept entry names what the reference has and the port lacks."""
    for rel, name in KEPT:
        assert (name in (all_names(REF / rel) or [])
                or name in surface(REF / rel)), (rel, name)
        assert name not in surface(PORT / rel), (rel, name)
    for rel, where, param in KEPT_KEYWORDS:
        name, _, method = where.partition(".")
        want, have = surface(REF / rel)[name], surface(PORT / rel)[name]
        if method:
            want, have = want[method], have[method]
        assert param in want and param not in have, (rel, where, param)
    for rel, cls, member in KEPT_MEMBERS:
        assert member in surface(REF / rel)[cls], (rel, cls, member)
        assert member not in surface(PORT / rel)[cls], (rel, cls, member)
    assert all(isinstance(r, str) and r for r in
               (*KEPT_MODULES.values(), *KEPT.values(),
                *KEPT_KEYWORDS.values(), *KEPT_MEMBERS.values()))


def _slab(n=12, m=200, seed=0):
    rng = np.random.default_rng(seed)
    cells = torch.as_tensor(rng.integers(0, 9, (n, m)), dtype=torch.int32)
    base = torch.as_tensor(rng.integers(0, 5, (n,)), dtype=torch.int32)
    u8, b, ok = pack.pack_rows(cells + base[:, None], base)
    assert bool(ok.all())
    return cells + base[:, None], u8, b


def _same(a, b, keys):
    for k in keys:
        x, y = torch.as_tensor(a[k]), torch.as_tensor(b[k])
        assert x.dtype == y.dtype and torch.equal(x, y), k


def _warned(fn, *args, **kwargs):
    """``fn``'s result; it must warn ``DeprecationWarning`` once,
    attributed to this file (stacklevel 2)."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn(*args, **kwargs)
    dep = [x for x in w if issubclass(x.category, DeprecationWarning)]
    assert len(dep) == 1 and "CausalEngine" in str(dep[0].message), dep
    assert dep[0].filename == __file__, dep[0].filename
    return out


CLASSIFY = causal.ClassifyResult._FIELDS
MATRIX = ("a_le_b", "b_le_a", "concurrent", "fp", "row_sums", "col_sums")


def _fields(res) -> dict:
    return {k: getattr(res, k) for k in CLASSIFY}


def test_classify_shims_match_the_front_door():
    cells, u8, base = _slab()
    eng = causal.CausalEngine()
    q = cells[3]
    _same(_warned(ops.classify_vs_many, q, cells),
          _fields(eng.classify(q, cells)), CLASSIFY)
    _same(_warned(ops.classify_vs_many_packed, q, u8, base),
          _fields(eng.classify(q, causal.PackedSlab(u8, base))), CLASSIFY)


def test_sharded_classify_and_overlay_shims_match_the_front_door():
    cells, u8, base = _slab(n=16)
    mesh = make_fleet_mesh(4, device="cpu")
    parts = tuple(u8.split(4)), tuple(base.split(4))
    wide = {5: cells[5].numpy(), 14: cells[14].numpy()}
    q = cells[2]
    got = _warned(ops.classify_vs_many_packed_sharded, q, *parts, mesh=mesh)
    got = _warned(ops.overlay_wide_classify, got, q, list(wide),
                  torch.as_tensor(np.stack(list(wide.values()))))
    want = causal.CausalEngine().classify(
        q, causal.PackedSlab(*parts, wide=wide, mesh=mesh))
    _same(got, _fields(want), CLASSIFY)


def test_matrix_shims_match_the_front_door():
    cells, u8, base = _slab()
    eng = causal.CausalEngine()
    _same(_warned(ops.compare_matrix, cells, cells), eng.pairs(cells), MATRIX)
    _same(_warned(ops.compare_matrix_packed, u8, base),
          eng.pairs(causal.PackedSlab(u8, base)), MATRIX)


def test_pad_to():
    x = torch.arange(10, dtype=torch.int32).view(2, 5)
    y = ops.pad_to(x, 4, axis=1, value=-1)
    assert y.shape == (2, 8) and torch.equal(y[:, :5], x)
    assert bool((y[:, 5:] == -1).all())
    assert ops.pad_to(x, 5, axis=1) is x
    assert ops.pad_to(x, 3, axis=0).shape == (3, 5)
