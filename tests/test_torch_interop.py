"""The port's boundary: carry-across round trips between numpy uint32 arrays
and the port's int32 tensors, port constants equal to the JAX package's, and
the rule that zkarray_torch and chip_smoke.py import neither JAX nor anything
of zkarray (checked on a fresh interpreter and by a source scan)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from zkarray.curves import bls12_381 as jcurves  # noqa: E402
from zkarray_torch import interop  # noqa: E402
from zkarray_torch.curves import bls12_381 as tcurves  # noqa: E402
from zkarray_torch.ec import sw as tsw  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def test_limb_and_point_round_trips():
    rng = np.random.default_rng(0)
    limbs = rng.integers(0, 1 << 16, size=(24, 5, 3), dtype=np.uint32)
    words = rng.integers(0, 1 << 32, size=(12, 7), dtype=np.uint64).astype(np.uint32)
    for arr in (limbs, words):
        t = interop.limbs_from_numpy(arr, "cpu")
        assert t.dtype == torch.int32 and t.shape == arr.shape
        back = interop.limbs_to_numpy(t)
        assert back.dtype == np.uint32 and np.array_equal(back, arr)
    inf = rng.integers(0, 2, size=(5, 3)).astype(bool)
    A = interop.affine_from_numpy(limbs, limbs[::-1].copy(), inf, "cpu")
    x, y, i = interop.affine_to_numpy(A)
    assert np.array_equal(x, limbs) and np.array_equal(y, limbs[::-1]) and np.array_equal(i, inf)
    P = interop.xyzz_from_numpy([limbs, limbs, words[:, :3], words[:, 3:6]], "cpu")
    assert isinstance(P, tsw.XYZZPoints)
    assert all(np.array_equal(a, b) for a, b in
               zip(interop.xyzz_to_numpy(P), [limbs, limbs, words[:, :3], words[:, 3:6]]))
    with pytest.raises(TypeError):
        interop.limbs_from_numpy(limbs.astype(np.uint64), "cpu")


def test_port_constants_equal_jax():
    for j, t in [(jcurves.FQ, tcurves.FQ), (jcurves.FR, tcurves.FR)]:
        assert t.num_limbs == j.num_limbs and t.bits == j.bits and t.r_bits == j.r_bits
        assert interop.same_field(t, j.modulus, j.generator_int, j.r_int, j.r2_int, j.inv16)
        assert t.to_mont_int(12345) == j.to_mont_int(12345)
        assert t.from_mont_int(6789) == j.from_mont_int(6789)
        assert (t.two_adicity, t.trace, t.two_adic_root_int) == (
            j.two_adicity, j.trace, j.two_adic_root_int)
        assert [t.root_of_unity(1 << k) for k in range(t.two_adicity + 1)] == [
            j.root_of_unity(1 << k) for k in range(j.two_adicity + 1)]
        with pytest.raises(ValueError):
            t.root_of_unity(1 << (t.two_adicity + 1))
    jg, tg = jcurves.G1, tcurves.G1
    assert interop.same_curve(tg, jg.a_int, jg.b_int, jg.gen_x, jg.gen_y, jg.cofactor)
    assert not interop.same_curve(tg, jg.a_int, jg.b_int + 1, jg.gen_x, jg.gen_y, jg.cofactor)


def test_import_pulls_in_no_jax():
    code = (
        "import sys; import zkarray_torch.ec.msm, zkarray_torch.interop, "
        "zkarray_torch.testing, zkarray_torch.kernels.sw, zkarray_torch.poly.domain, "
        "zkarray_torch.poly.evaluations; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'zkarray')]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_source_scan_finds_no_jax_or_zkarray_import():
    files = sorted((ROOT / "zkarray_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "zkarray"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
