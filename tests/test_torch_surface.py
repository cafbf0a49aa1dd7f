"""Port parity: the public surface of each package ``__init__``.

Every name the JAX package's ``__init__`` files bind by import (and every
name of their ``__all__``) must be an attribute of the port's package at
the same path, and the ``__all__`` lists must be equal; the only names
left out are the Pallas switches of ``zkarray.kernels``, which the port
drops (a tensor's device picks the route). ``SWCurveSpec`` carries
``affine_from_ints``/``affine_to_ints`` as methods, as the JAX package's
does, and their words are the JAX package's."""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_parity import JC, TC, same  # noqa: E402
from zkarray_torch.testing import ec_mul  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ["", ".core", ".ec", ".ff", ".poly", ".ec.pairing", ".serialize", ".kernels"]
DROPPED = {".kernels": {"use_pallas", "pallas_enabled", "interpret_mode"}}


def _bound_names(init: Path):
    """Names an __init__.py binds by import, and its __all__ (or None)."""
    tree = ast.parse(init.read_text())
    names, all_ = set(), None
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Import):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            all_ = ast.literal_eval(node.value)
    return names, all_


@pytest.mark.parametrize("sub", PACKAGES, ids=[s.lstrip(".") or "top" for s in PACKAGES])
def test_package_reexports_match_jax(sub):
    jinit = ROOT / "zkarray" / sub.lstrip(".").replace(".", "/") / "__init__.py"
    names, jall = _bound_names(jinit)
    dropped = DROPPED.get(sub, set())
    assert dropped <= names  # the switches are there to drop
    port = importlib.import_module("zkarray_torch" + sub)
    missing = sorted(n for n in (names | set(jall or ())) - dropped if not hasattr(port, n))
    assert not missing, f"zkarray_torch{sub} lacks {missing}"
    if jall is not None:
        assert list(port.__all__) == list(jall)
    jax_pkg = importlib.import_module("zkarray" + sub)
    for n in sorted(names - dropped):  # re-exported submodules and classes by their own names
        j, t = getattr(jax_pkg, n), getattr(port, n)
        assert getattr(t, "__name__", n).rsplit(".", 1)[-1] == getattr(j, "__name__", n).rsplit(".", 1)[-1]


def test_serialize_keeps_canonical_module_unshadowed():
    import zkarray_torch.serialize as ts

    assert "canonical" not in ts.__all__
    assert ts.canonical.__name__ == "zkarray_torch.serialize.canonical"  # the submodule


def test_sw_curve_spec_int_methods_match_jax():
    p = JC.base.modulus
    gen = (JC.gen_x, JC.gen_y)
    pts = [gen, None, ec_mul(gen, 5, 0, p), (gen[0], p - gen[1]), ec_mul(gen, 1 << 40, 0, p)]
    jA = JC.affine_from_ints(pts)
    tA = TC.affine_from_ints(pts, device="cpu")
    assert same(jA.x, tA.x) and same(jA.y, tA.y)
    assert np.array_equal(np.asarray(jA.inf), tA.inf.numpy())
    assert TC.affine_to_ints(tA) == JC.affine_to_ints(jA) == pts
