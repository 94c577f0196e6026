"""The port's public surface against the reference's, without importing
JAX: every name in a reference module's ``__all__`` (read by ``ast``)
is in the ``__all__`` of the port's module at the same path, and
defined there, or stands in ``KEPT`` with the reason it has no meaning
on the card; and the deprecated shims of ``kernels/ops.py`` warn
``DeprecationWarning`` and give the front door's results bit for bit.
"""
import ast
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


def test_kept_differences_name_reference_names():
    for rel, name in KEPT:
        assert name in all_names(REF / rel), (rel, name)


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
