"""Port parity: zkarray_torch.ff.hash_to_field and ec.h2c (SWU over Fq and
Fq2, the BLS12-381 G1 and G2 Wahby–Boneh maps, cofactor clearing, the full
RFC 9380 suites) against the RFC 9380 vectors in tests/vectors/, the JAX
package's words and the host models (zkarray_torch/testing.py:
host_hash_to_g1, host_hash_to_g2).

The JAX maps at the vectors' lanes plus the exceptional u (SWU's
Z^2 u^4 + Z u^2 = 0), and its pipelines' Jacobian words, are stored in
tests/vectors/h2c_words.npz by scripts/h2c_words.py (the G2 pipeline takes
over a minute of XLA compile on a CPU); the slow-marked test rebuilds them.
On the CPU every field operation is its kernel's plain version."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from zkarray.ec.h2c import _bls12_381_g1_iso as jiso1  # noqa: E402
from zkarray.ec.h2c import _bls12_381_g2_iso as jiso2  # noqa: E402
from zkarray.ec.h2c import wb as jwb  # noqa: E402
from zkarray.ff import hash_to_field as jhtf  # noqa: E402
from zkarray_torch.curves import bls12_381 as tb  # noqa: E402
from zkarray_torch.ec import sw, sw_ext  # noqa: E402
from zkarray_torch.ec.h2c import _bls12_381_g1_iso as tiso1  # noqa: E402
from zkarray_torch.ec.h2c import _bls12_381_g2_iso as tiso2  # noqa: E402
from zkarray_torch.ec.h2c import swu_ext, wb, wb_g2  # noqa: E402
from zkarray_torch.ec.h2c.swu import swu_map  # noqa: E402
from zkarray_torch.ff import fp  # noqa: E402
from zkarray_torch.ff import hash_to_field as thtf  # noqa: E402
from zkarray_torch.testing import g2_affine_to_ints, host_hash_to_g1, host_hash_to_g2, host_swu  # noqa: E402


def _words_script():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "h2c_words.py")
    spec = importlib.util.spec_from_file_location("h2c_words", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


WORDS = _words_script()
STORED = dict(np.load(WORDS.OUT))
G1V, G2V = WORDS.g1_vectors(), WORDS.g2_vectors()
F2 = tb.FQ2


def _pt(x):
    return json.loads(x.replace("'", '"')) if isinstance(x, str) else x


def _g1_pt(x):
    x = _pt(x)
    return (int(x["x"], 16), int(x["y"], 16))


def _g2_pt(x):
    x = _pt(x)
    return (WORDS.fq2_pair(x["x"]), WORDS.fq2_pair(x["y"]))


def _stored(prefix, tP, names):
    for n_, t in zip(names, tP):
        assert np.array_equal(STORED[f"{prefix}_{n_}"], t.numpy().view(np.uint32)), (prefix, n_)


def test_constants_match_jax():
    for name in ("X_MAP_NUMERATOR", "X_MAP_DENOMINATOR", "Y_MAP_NUMERATOR", "Y_MAP_DENOMINATOR",
                 "ISO_A", "ISO_B", "ZETA"):
        assert getattr(tiso1, name) == getattr(jiso1, name), name
    for name in ("X_MAP_NUMERATOR", "X_MAP_DENOMINATOR", "Y_MAP_NUMERATOR", "Y_MAP_DENOMINATOR",
                 "ISO_A", "ISO_B", "ZETA", "PSI_X", "PSI_Y", "PSI2_X", "BLS_X", "NEG_B_OVER_A",
                 "B_OVER_ZA", "P"):
        assert getattr(tiso2, name) == getattr(jiso2, name), name
    c = wb.ISO_CURVE
    assert (c.name, c.a_int, c.b_int, c.base.modulus) == (jwb.ISO_CURVE.name, jwb.ISO_CURVE.a_int,
                                                          jwb.ISO_CURVE.b_int,
                                                          jwb.ISO_CURVE.base.modulus)


def test_expand_message_xmd_all_vectors():
    with open(os.path.join(os.path.dirname(WORDS.OUT), "expand_message_xmd_SHA256_38.json")) as fh:
        d = json.load(fh)
    dst = d["DST"].encode()
    assert len(d["tests"]) >= 10
    for t in d["tests"]:
        n = int(t["len_in_bytes"], 0)
        got = thtf.expand_message_xmd(t["msg"].encode(), dst, n)
        assert got.hex() == t["uniform_bytes"] == jhtf.expand_message_xmd(t["msg"].encode(), dst, n).hex()
    with pytest.raises(ValueError):
        thtf.expand_message_xmd(b"", dst, 256 * 32)


def test_hash_to_field_all_vectors():
    """u of every G1 and G2 vector; the device tensor's words equal the JAX
    package's; the byte helpers."""
    dst = G1V["dst"].encode()
    for v in G1V["vectors"]:
        want = [int(u, 16) for u in v["u"]]
        got = thtf.hash_to_field_ints(tb.FQ, v["msg"].encode(), dst, 2)
        assert [g[0] for g in got] == want
        t = thtf.hash_to_field(tb.FQ, v["msg"].encode(), dst, 2, device="cpu")
        assert np.array_equal(t.numpy().view(np.uint32),
                              np.asarray(jhtf.hash_to_field(jwb.b381.FQ, v["msg"].encode(), dst, 2)))
    dst = G2V["dst"].encode()
    for v in G2V["vectors"]:
        want = [WORDS.fq2_pair(u) for u in v["u"]]
        got = thtf.hash_to_field_ints(tb.FQ, v["msg"].encode(), dst, 2, ext_degree=2)
        assert [tuple(g) for g in got] == want
    assert thtf.len_per_base_elem(tb.FQ) == jhtf.len_per_base_elem(jwb.b381.FQ) == 64
    data = bytes(range(1, 70))
    for f in ("from_be_bytes_mod_order", "from_le_bytes_mod_order"):
        assert getattr(thtf, f)(tb.FQ, data) == getattr(jhtf, f)(jwb.b381.FQ, data)


def test_g1_maps_match_jax_rfc_and_host():
    """SWU on E' and the WB map at the vectors' u plus u = 0 and
    u = +-sqrt(-1/Z): words equal the JAX package's; Q0/Q1 equal the
    vectors'; the SWU points equal the host model's."""
    us = WORDS.g1_us()
    u = fp.from_ints(tb.FQ, us, device="cpu")
    p_iso = swu_map(wb.ISO_CURVE, u, tiso1.ZETA)
    _stored("g1_swu", p_iso[:2], "xy")
    assert not p_iso.inf.any()
    p = tb.FQ.modulus
    assert sw.affine_to_ints(wb.ISO_CURVE, p_iso) == [
        host_swu(tiso1.ISO_A, tiso1.ISO_B, tiso1.ZETA, x, p) for x in us]
    assert sw.is_on_curve(wb.ISO_CURVE, p_iso).all()
    m = wb.bls12_381_g1_wb_map(u)
    _stored("g1_map", m[:2], "xy")
    assert sw.is_on_curve(tb.G1, m).all()
    got = sw.affine_to_ints(tb.G1, m)
    n = len(G1V["vectors"])
    assert got[:n] == [_g1_pt(v["Q0"]) for v in G1V["vectors"]]
    assert got[n:2 * n] == [_g1_pt(v["Q1"]) for v in G1V["vectors"]]


def _recorder(monkeypatch, module, name, log):
    """Wrap ``module.name`` so that each call appends (args, result) to log."""
    fn = getattr(module, name)

    def rec(*args):
        out = fn(*args)
        log.append((args, out))
        return out

    monkeypatch.setattr(module, name, rec)


def test_g1_pipeline_matches_jax_and_rfc(monkeypatch):
    """map_to_g1_pairs over the five vectors' hashed u (the steps of
    hash_to_curve_bls12_381_g1, batched): the words of its add and h_eff
    ladder (recorded) and its points equal the JAX package's; every
    vector's P, which the host model gives too."""
    vs = G1V["vectors"]
    n = len(vs)
    dst = G1V["dst"].encode()
    vals = [thtf.hash_to_field_ints(tb.FQ, v["msg"].encode(), dst, 2) for v in vs]
    u = fp.from_ints(tb.FQ, [e[0][0] for e in vals] + [e[1][0] for e in vals], device="cpu")
    log = []
    for name in ("jac_add_mixed", "scalar_mul_const", "to_affine"):
        _recorder(monkeypatch, wb.sw, name, log)
    P = wb.map_to_g1_pairs(u)
    monkeypatch.undo()
    (_, q), (_, cleared), (_, p_out) = log
    _stored("g1_q", q, "xyz")
    _stored("g1_cleared", cleared, "xyz")
    assert p_out is P
    _stored("g1_p", P[:2], "xy")
    want = [_g1_pt(v["P"]) for v in vs]
    assert sw.affine_to_ints(tb.G1, P) == want
    us = WORDS.g1_us()
    assert [e[0][0] for e in vals] + [e[1][0] for e in vals] == us[:2 * n]
    assert want == [host_hash_to_g1(us[i], us[n + i]) for i in range(n)]


def test_g1_hash_to_curve_one_message():
    vs = G1V["vectors"]
    one = wb.hash_to_curve_bls12_381_g1(vs[1]["msg"].encode(), G1V["dst"].encode(), device="cpu")
    assert sw.affine_to_ints(tb.G1, one) == [_g1_pt(vs[1]["P"])]


def test_g2_maps_match_jax_rfc():
    """swu_map_ext (sgn0_m2, quad_sqrt) and the G2 WB map at the vectors' u
    plus u = 0 (the exceptional x1 = b/(Z a)): words equal the JAX
    package's; Q0/Q1 equal the vectors'."""
    us = WORDS.g2_us()
    u = F2.from_ints([[c[0] for c in us], [c[1] for c in us]], "cpu")
    x, y = swu_ext.swu_map_ext(F2, u, tiso2.ISO_A, tiso2.ISO_B, tiso2.ZETA, tiso2.NEG_B_OVER_A,
                               tiso2.B_OVER_ZA)
    _stored("g2_swu", (x, y), "xy")
    m = wb_g2.bls12_381_g2_wb_map(u)
    _stored("g2_map", m[:2], "xy")
    assert sw_ext.is_on_curve(tb.G2, m).all()
    got = g2_affine_to_ints(tb.G2, m)
    n = len(G2V["vectors"])
    assert got[:n] == [_g2_pt(v["Q0"]) for v in G2V["vectors"]]
    assert got[n:2 * n] == [_g2_pt(v["Q1"]) for v in G2V["vectors"]]
    # sgn0 for m = 2 reads c1 where c0 = 0
    e = F2.from_ints([[0, 0, 3, 4], [5, 6, 0, 1]], "cpu")
    assert swu_ext.sgn0_m2(F2, e).tolist() == [1, 0, 1, 0]


def test_g2_pipeline_matches_jax_and_rfc(monkeypatch):
    """map_to_g2_pairs over the five vectors' hashed u (the steps of
    hash_to_curve_bls12_381_g2, batched): the words of its add, to_affine
    and clear_cofactor_g2 (two BLS_X ladders and four adds; recorded) and
    its points equal the JAX package's; every vector's P, which the host
    model (the h_eff multiple) gives too."""
    vs = G2V["vectors"]
    n = len(vs)
    dst = G2V["dst"].encode()
    vals = [thtf.hash_to_field_ints(tb.FQ, v["msg"].encode(), dst, 2, ext_degree=2) for v in vs]
    us = [tuple(e[0]) for e in vals] + [tuple(e[1]) for e in vals]
    u = F2.from_ints([[c[0] for c in us], [c[1] for c in us]], "cpu")
    log = []
    for name in ("to_affine", "clear_cofactor_g2"):
        _recorder(monkeypatch, wb_g2.swe if name == "to_affine" else wb_g2, name, log)
    P = wb_g2.map_to_g2_pairs(u)
    monkeypatch.undo()
    ((_, q), qa), ((qa_in,), cleared), ((_, cleared_in), p_out) = log
    _stored("g2_q", q, "xyz")
    _stored("g2_qa", qa[:2], "xy")
    assert qa_in is qa and cleared_in is cleared and p_out is P
    _stored("g2_cleared", cleared, "xyz")
    _stored("g2_p", P[:2], "xy")
    want = [_g2_pt(v["P"]) for v in vs]
    assert g2_affine_to_ints(tb.G2, P) == want
    assert us == WORDS.g2_us()[:2 * n]
    assert want == [host_hash_to_g2(us[i], us[n + i]) for i in range(n)]


def test_g2_hash_to_curve_one_message():
    vs = G2V["vectors"]
    one = wb_g2.hash_to_curve_bls12_381_g2(vs[2]["msg"].encode(), G2V["dst"].encode(),
                                           device="cpu")
    assert g2_affine_to_ints(tb.G2, one) == [_g2_pt(vs[2]["P"])]


@pytest.mark.slow
def test_stored_h2c_words_match_jax():
    """The stored words equal what the JAX package computes now."""
    want = WORDS.words()
    assert sorted(STORED) == sorted(want)
    for k, v in want.items():
        assert STORED[k].dtype == v.dtype and np.array_equal(STORED[k], v), k
