#!/usr/bin/env python3
"""Count the kernel launches of one call of every pairing and GT path that
chip_smoke.py's phases 9-11 time, on the CPU: scripts/rehearse_chip_smoke.py's
stand-ins replace each launch by a counted call of its plain version, so the
counts are the ones the card shows (they do not depend on the batch, except
gt_msm's and pairing's, which combine across lanes). Prints one JSON line per
path: launches by kernel and their total, and for the BLS12 and BN engines the
split into g2_prepare, the Miller loop and the final exponentiation.

    JAX_PLATFORMS=cpu python3 scripts/count_path_launches.py [lanes]
"""

import json
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import rehearse_chip_smoke as rh  # noqa: E402


def counted(fn):
    from zkarray_torch import kernels

    kernels.reset_launches()
    t = time.perf_counter()
    out = fn()
    s = time.perf_counter() - t
    got = {k: v for k, v in kernels.LAUNCHES.items() if v}
    return out, dict(total=sum(got.values()), by_kernel=got, cpu_s=s)


def main(lanes: int = 2):
    torch.set_num_threads(1)
    rh.setup()
    from zkarray_torch import testing as tt
    from zkarray_torch.curves import (bls12_377, bls12_381, bn254, bw6_761, bw6_767, cp6_782,
                                      mnt4_298, mnt4_753, mnt6_298, mnt6_753)
    from zkarray_torch.ec.pairing import bls12, bn, bw6, cp6, gt, mnt

    rng = np.random.default_rng(12)
    for label, eng, mod in (("bls12_381", bls12, bls12_381), ("bls12_377", bls12, bls12_377),
                            ("bn254", bn, bn254), ("bw6_761", bw6, bw6_761), ("bw6_767", bw6, bw6_767),
                            ("mnt4_298", mnt, mnt4_298), ("mnt6_298", mnt, mnt6_298),
                            ("mnt4_753", mnt, mnt4_753), ("mnt6_753", mnt, mnt6_753)):
        spec = mod.PAIRING
        kw = dict(scalar_bits=64) if eng is mnt else {}
        P, Q, _, _ = tt.pairing_inputs(spec, lanes, rng, lanes, 1024, device="cpu", **kw)
        _, row = counted(lambda: eng.pairing_each(spec, P, Q))
        if eng in (bls12, bn):
            Qp, row["g2_prepare"] = counted(lambda: eng.g2_prepare(spec, Q))
            f, row["miller_loop"] = counted(lambda: eng.multi_miller_loop(spec, P, Qp, False))
            _, row["final_exponentiation"] = counted(lambda: eng.final_exponentiation(spec, f))
        print(json.dumps({"path": label, "lanes": lanes, **row}), flush=True)

    spec = cp6_782.PAIRING
    P, Q, _, _ = tt.pairing_inputs(spec, lanes, rng, lanes, 1024, device="cpu", scalar_bits=64)
    q_host = tt.g2_affine_to_ints(spec.g2, Q)
    Qp = cp6.g2_prepare_host(spec, q_host, "cpu")
    Qp = cp6.CP6G2Prepared(*Qp[:4], torch.zeros(lanes, dtype=torch.bool))
    _, row = counted(lambda: cp6.final_exponentiation(spec, cp6.multi_miller_loop(spec, P, Qp, False)))
    print(json.dumps({"path": "cp6_782", "lanes": lanes, **row}), flush=True)

    F12, FR = bls12_381.FQ12, bls12_381.FR
    G = gt.GTGroup(F12, FR)
    A, sc, _, _ = tt.gt_inputs(F12, tt.E_BLS12_381, FR, lanes, rng, lanes, device="cpu")
    for label, fn in (("gt_mul_scalar", lambda: gt.gt_mul_scalar(G, A, sc)),
                      ("gt_msm", lambda: gt.gt_msm(G, A, sc, 3))):
        _, row = counted(fn)
        print(json.dumps({"path": label, "lanes": lanes, **row}), flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
