"""Port parity for the multi-device layer (zkarray_torch/dist) on CPU
processes: gloo ranks spawned by torch.multiprocessing, each rank one
device, against the JAX package's shard_map versions on its 8 virtual CPU
devices (tests/conftest.py) at tests/test_dist.py's shapes: 32 BN254 G1
points at c = 4, an n = 64 BN254 Fr NTT with n1 = 8. msm_sharded's
replicated XYZZ words and every rank's fft_sharded shard equal the JAX
package's bit for bit; a 3-rank MSM takes the halving tree's odd tail,
held against the port's unsharded msm and the Python-int oracle. Each
spawn has its own time limit."""

import os
import pickle
import random
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ec_oracle import ec_mul  # noqa: E402
from test_msm import oracle_msm  # noqa: E402
from zkarray.curves import bn254 as jbn  # noqa: E402
from zkarray.dist import fft_sharded as j_fft_sharded  # noqa: E402
from zkarray.dist import make_mesh as j_make_mesh  # noqa: E402
from zkarray.dist import msm_sharded as j_msm_sharded  # noqa: E402
from zkarray.ec import sw as jsw  # noqa: E402
from zkarray.ff import fp as jfp  # noqa: E402
from zkarray.poly.domain import Radix2Domain as JDomain  # noqa: E402
from zkarray_torch import interop  # noqa: E402
from zkarray_torch.curves import bn254 as tbn  # noqa: E402
from zkarray_torch.dist import Mesh, fft_fourstep, fft_sharded, make_mesh, msm_sharded  # noqa: E402
from zkarray_torch.dist.mesh import make_mesh_2d  # noqa: E402
from zkarray_torch.ec import msm as tmsm  # noqa: E402
from zkarray_torch.ec import sw as tsw  # noqa: E402
from zkarray_torch.ff import fp as tfp  # noqa: E402

import torch_dist_worker  # noqa: E402

SPAWN_TIMEOUT_S = 300


def _spawn(world: int, job: dict, tmp_path) -> list:
    """Run ``job`` on ``world`` gloo ranks; each rank's results, in rank
    order. Fails when a rank fails or the spawn outlives its limit."""
    import torch.multiprocessing as mp

    workdir = str(tmp_path)
    with open(os.path.join(workdir, "job.pkl"), "wb") as fh:
        pickle.dump(dict(job, world=world), fh)
    ctx = mp.start_processes(torch_dist_worker.run_rank, args=(world, workdir), nprocs=world,
                             join=False, start_method="spawn")
    deadline = SPAWN_TIMEOUT_S
    import time

    t0 = time.monotonic()
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() - t0 > deadline:
                raise AssertionError(f"{world}-rank spawn outlived {deadline} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    outs = []
    for r in range(world):
        with open(os.path.join(workdir, f"out{r}.pkl"), "rb") as fh:
            outs.append(pickle.load(fh))
    return outs


def _msm_inputs(n, seed):
    curve = jbn.G1
    a, mod, r = curve.a_int, curve.base.modulus, curve.scalar.modulus
    rng = random.Random(seed)
    gen = (curve.gen_x, curve.gen_y)
    pts = [ec_mul(gen, rng.randrange(1, 1 << 30), a, mod) for _ in range(n)]
    ks = [rng.randrange(r) for _ in range(n)]
    return pts, ks


def _affine_ints(res):
    """A (L,)-coords XYZZ result (numpy words) -> affine ints (port, CPU)."""
    P = tsw.XYZZPoints(*(interop.limbs_from_numpy(np.asarray(v), "cpu")[:, None] for v in res))
    return tsw.affine_to_ints(tbn.G1, tsw.xyzz_to_affine(tbn.G1, P))[0]


def test_dist_8_ranks_match_jax(tmp_path):
    """msm_sharded and fft_sharded on 8 gloo ranks against the JAX package
    on make_mesh(8): the MSM's replicated XYZZ words on every rank, every
    rank's NTT shard (from the whole array and from its own shard), and
    the gathered transform."""
    pts, ks = _msm_inputs(32, 42)  # tests/test_dist.py:test_msm_sharded_vs_oracle
    A = jbn.G1.affine_from_ints(pts)
    s = jfp.from_ints(jbn.G1.scalar, ks, mont=False)
    want_msm = [np.asarray(v) for v in j_msm_sharded(jbn.G1, A, s, j_make_mesh(8), c=4)]

    spec, n = jbn.FR, 64
    rng = random.Random(4)
    xs = [rng.randrange(spec.modulus) for _ in range(n)]
    dom = JDomain(spec, n)
    a = jfp.from_ints(spec, xs)
    want_fft = np.asarray(j_fft_sharded(spec, a, j_make_mesh(8), dom.group_gen_int, n1=8))
    assert jfp.to_ints(spec, want_fft) == jfp.to_ints(spec, dom.fft(a))

    job = dict(curve="bn254",
               msm=(np.asarray(A.x), np.asarray(A.y), np.asarray(A.inf), np.asarray(s), 4),
               fft=(np.asarray(a), dom.group_gen_int, 8))
    outs = _spawn(8, job, tmp_path)
    assert [o["rank"] for o in outs] == list(range(8)) and all(o["size"] == 8 for o in outs)
    for o in outs:
        assert all(np.array_equal(g, w.astype(np.uint32)) for g, w in zip(o["msm"], want_msm))
        m = n // 8
        assert np.array_equal(o["fft_shard"], want_fft[:, o["rank"] * m:(o["rank"] + 1) * m])
        assert o["fft_local_equal"]
        assert np.array_equal(o["fft_gathered"], want_fft)
    assert _affine_ints(outs[0]["msm"]) == oracle_msm(pts, ks, jbn.G1.a_int, jbn.G1.base.modulus)


def test_dist_3_ranks_odd_tail(tmp_path):
    """A 3-rank MSM (the halving tree's odd tail: 3 -> 2 -> 1) equals the
    port's unsharded msm on the same inputs and the oracle."""
    pts, ks = _msm_inputs(33, 7)
    A = tsw.affine_from_ints(tbn.G1, pts, "cpu")
    s = tfp.from_ints(tbn.G1.scalar, ks, mont=False, device="cpu")
    job = dict(curve="bn254", msm=(interop.limbs_to_numpy(A.x), interop.limbs_to_numpy(A.y),
                                   A.inf.numpy(), interop.limbs_to_numpy(s), 4))
    outs = _spawn(3, job, tmp_path)
    want = oracle_msm(pts, ks, jbn.G1.a_int, jbn.G1.base.modulus)
    whole = tmsm.msm(tbn.G1, A, s, 4)
    assert _affine_ints([interop.limbs_to_numpy(v) for v in whole]) == want
    for o in outs:
        assert all(np.array_equal(g, outs[0]["msm"][i]) for i, g in enumerate(o["msm"]))
        assert _affine_ints(o["msm"]) == want


def test_fft_fourstep_matches_jax():
    """The single-device four-step oracle against the JAX package's, n = 64,
    n1 = n2 = 8 (tests/test_dist.py:test_fourstep_vs_domain)."""
    from zkarray.dist import fft_fourstep as j_fourstep

    spec, n = jbn.FR, 64
    rng = random.Random(3)
    xs = [rng.randrange(spec.modulus) for _ in range(n)]
    w = JDomain(spec, n).group_gen_int
    want = np.asarray(j_fourstep(spec, jfp.from_ints(spec, xs), 8, 8, w))
    got = fft_fourstep(tbn.FR, tfp.from_ints(tbn.FR, xs, device="cpu"), 8, 8, w)
    assert np.array_equal(interop.limbs_to_numpy(got), want)


def test_dist_shapes_refused_before_any_collective():
    """The JAX package's ValueErrors: n not divisible by D, n1 or n2 not
    divisible by D; a mesh without a process group."""
    mesh = Mesh(None, 3, 0)
    pts, ks = _msm_inputs(4, 1)
    A = tsw.affine_from_ints(tbn.G1, pts, "cpu")
    s = tfp.from_ints(tbn.G1.scalar, ks, mont=False, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        msm_sharded(tbn.G1, A, s, mesh)
    x = tfp.from_ints(tbn.FR, list(range(64)), device="cpu")
    with pytest.raises(ValueError, match="D \\| n1"):
        fft_sharded(tbn.FR, x, Mesh(None, 4, 0), 5, n1=2)
    with pytest.raises(ValueError, match="D \\| n1"):
        fft_sharded(tbn.FR, x, mesh, 5)
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(8)
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh_2d((2, 4))
