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

from zkarray.curves import bls12_377 as jbls377  # noqa: E402
from zkarray.curves import bls12_381 as jcurves  # noqa: E402
from zkarray.curves import bn254 as jbn254  # noqa: E402
from zkarray.ec import fast_checks as jfast  # noqa: E402
from zkarray.ec import sw as jsw  # noqa: E402
from zkarray_torch import interop  # noqa: E402
from zkarray_torch.curves import bls12_377 as tbls377  # noqa: E402
from zkarray_torch.curves import bls12_381 as tcurves  # noqa: E402
from zkarray_torch.curves import bn254 as tbn254  # noqa: E402
from zkarray_torch.ec import fast_checks as tfast  # noqa: E402
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


def test_jacobian_round_trip():
    """Jacobian points carried across: the JAX package's arrays in, the same
    words out, as JacobianPoints."""
    rng = np.random.default_rng(1)
    coords = [rng.integers(0, 1 << 16, size=(16, 4, 2), dtype=np.uint32) for _ in range(3)]
    P = interop.jacobian_from_numpy(coords, "cpu")
    assert isinstance(P, tsw.JacobianPoints) and P.z.dtype == torch.int32
    back = interop.jacobian_to_numpy(P)
    assert all(b.dtype == np.uint32 and np.array_equal(b, c) for b, c in zip(back, coords))
    jG = jsw.from_affine(jcurves.G1, jcurves.G1.generator((3,)))
    tG = interop.jacobian_from_numpy([np.asarray(v) for v in jG], "cpu")
    assert all(np.array_equal(np.asarray(j), t) for j, t in zip(jG, interop.jacobian_to_numpy(tG)))
    want = tsw.from_affine(tcurves.G1, tcurves.G1.generator((3,), "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(tG, want))


@pytest.mark.parametrize("mods", [(jbn254, tbn254), (jbls377, tbls377)], ids=["bn254", "bls12_377"])
def test_bn254_and_bls12_377_constants_equal_jax(mods):
    """Fr, Fq (Montgomery and square-root constants) and G1 of the two new
    curve modules; BLS12-377's X; the fast check's beta and |X|."""
    jm, tm = mods
    for j, t in [(jm.FQ, tm.FQ), (jm.FR, tm.FR)]:
        assert (t.num_limbs, t.bits, t.r_bits, t.n64) == (j.num_limbs, j.bits, j.r_bits, j.n64)
        assert interop.same_field(t, j.modulus, j.generator_int, j.r_int, j.r2_int, j.inv16)
        assert (t.two_adicity, t.trace, t.two_adic_root_int) == (
            j.two_adicity, j.trace, j.two_adic_root_int)
        assert (t.sqrt_mode, t.sqrt_exp, t.sqrt_qnr, t.mod_minus_one_div_two, t.has_spare_bit) == (
            j.sqrt_mode, j.sqrt_exp, j.sqrt_qnr, j.mod_minus_one_div_two, j.has_spare_bit)
        assert (t.modulus_limbs, t.r_limbs, t.r2_limbs) == (j.modulus_limbs, j.r_limbs, j.r2_limbs)
    jg, tg = jm.G1, tm.G1
    assert tg.name == jg.name and tg.scalar == tm.FR and tg.base == tm.FQ
    assert interop.same_curve(tg, jg.a_int, jg.b_int, jg.gen_x, jg.gen_y, jg.cofactor)
    if jm is jbls377:
        assert tm.X == jm.X
    assert (tfast.BLS12_381_BETA, tfast.BLS12_381_X_ABS) == (jfast.BLS12_381_BETA,
                                                             jfast.BLS12_381_X_ABS)


def test_import_pulls_in_no_jax():
    code = (
        "import sys; import zkarray_torch.ec.msm, zkarray_torch.interop, "
        "zkarray_torch.testing, zkarray_torch.kernels.sw, zkarray_torch.poly.domain, "
        "zkarray_torch.poly.evaluations, zkarray_torch.curves.bn254, "
        "zkarray_torch.curves.bls12_377, zkarray_torch.curves.bls12_381_zcash, "
        "zkarray_torch.ec.point_serde, zkarray_torch.serialize.wrappers; "
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
