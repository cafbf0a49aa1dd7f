"""FFT over group elements (the DomainCoeff abstraction).

Counterpart of zkarray/poly/group_domain.py: the in-order radix-2 DIT of
domain.py's field transform, over a batch of short-Weierstrass Jacobian
points, with each stage's twiddle multiply done by ``scale_rows``: one
double-and-add ladder shared by the whole batch over the bits of the
per-position host scalars (a bit matrix selects per point), as long as the
longest scalar. A stage's twiddles are roots of unity, so most ladders are
the scalar field's full width: ~255 steps of one ``jac_double``, one
``jac_add`` and a select, each a chain of field kernel launches on a CUDA
device (ec/sw.py).
"""

from __future__ import annotations

import numpy as np
import torch

from zkarray_torch.ec import sw
from zkarray_torch.poly.domain import Radix2Domain, _bitrev_perm


class SWJacobianCoeff:
    """DomainCoeff ops for a batch of SW Jacobian points (batch axis last)."""

    def __init__(self, curve):
        self.curve = curve

    def zero(self, batch_shape, device):
        return sw.jac_zero(self.curve, batch_shape, device)

    def add(self, a, b):
        return sw.jac_add(self.curve, a, b)

    def sub(self, a, b):
        return sw.jac_add(self.curve, a, sw.jac_neg(self.curve, b))

    def take(self, a, idx):
        idx = torch.as_tensor(idx, dtype=torch.int64).to(a.x.device)
        return sw.JacobianPoints(*(v[:, idx] for v in a))

    def concat(self, a, b):
        return sw.JacobianPoints(*(torch.cat([u, v], dim=1) for u, v in zip(a, b)))

    def select(self, mask, a, b):
        return sw.select_jac(mask, a, b)

    def scale_rows(self, a, scalars_int):
        """a[i] k_i for host-int scalars (one per point): double-and-add over
        the canonical bits of the k_i, most significant first, one ladder for
        the batch; a step whose bits are all zero skips the add, which its
        select would drop."""
        ks = [int(k) % self.curve.scalar.modulus for k in scalars_int]
        nbits = max(max(k.bit_length() for k in ks), 1)
        bits = np.zeros((nbits, len(ks)), dtype=bool)
        for j, k in enumerate(ks):
            for b in range(nbits):
                bits[nbits - 1 - b, j] = (k >> b) & 1
        rows = torch.from_numpy(bits).to(a.x.device)
        acc = self.zero(a.x.shape[1:], a.x.device)
        for i, row in enumerate(rows):
            acc = sw.jac_double(self.curve, acc)
            if bits[i].any():  # a row of zeros selects the doubling everywhere
                acc = self.select(row, sw.jac_add(self.curve, acc, a), acc)
        return acc


def fft_group(dom: Radix2Domain, gops, values, inverse: bool = False):
    """In-order radix-2 (i)FFT of a batch of dom.size group elements on
    ``dom`` (a coset acts through scalar multiplication; the inverse folds
    in n^-1)."""
    n = dom.size
    p = dom.spec.modulus
    w = dom.group_gen_inv_int if inverse else dom.group_gen_int
    if not inverse and dom.offset_int != 1:
        values = gops.scale_rows(values, [pow(dom.offset_int, j, p) for j in range(n)])
    log_n = n.bit_length() - 1
    x = gops.take(values, _bitrev_perm(log_n, "cpu"))
    for s in range(1, log_n + 1):
        m = 1 << s
        half = m // 2
        # the hi half of each block times w^((j mod m - half) n/m), the rest
        # times 1; then (lo, hi) -> (lo + hi, lo - hi)
        wtab = [pow(w, (j % m - half) * (n // m), p) if j % m >= half else 1 for j in range(n)]
        lo_idx = np.asarray([j for j in range(n) if j % m < half], dtype=np.int64)
        hi_idx = lo_idx + half
        t = gops.scale_rows(x, wtab)
        lo, hi = gops.take(t, lo_idx), gops.take(t, hi_idx)
        order = np.empty(n, dtype=np.int64)
        order[lo_idx] = np.arange(n // 2)
        order[hi_idx] = n // 2 + np.arange(n // 2)
        x = gops.take(gops.concat(gops.add(lo, hi), gops.sub(lo, hi)), order)
    if inverse:
        ninv = pow(n, -1, p)
        scal = [ninv] * n
        if dom.offset_int != 1:
            scal = [ninv * pow(dom.offset_inv_int, j, p) % p for j in range(n)]
        x = gops.scale_rows(x, scal)
    return x
