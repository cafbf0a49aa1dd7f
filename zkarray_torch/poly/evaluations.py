"""Evaluations over a domain: point-wise algebra and interpolation.

Counterpart of zkarray/poly/evaluations.py: point-wise add, sub, mul and div
(by batch inversion) over one shared domain, interpolation by ifft.
"""

from __future__ import annotations

import torch

from zkarray_torch.ff import fp
from zkarray_torch.poly.domain import Radix2Domain


class Evaluations:
    def __init__(self, domain: Radix2Domain, evals: torch.Tensor):
        if evals.shape[1] != domain.size:
            raise ValueError(f"{evals.shape[1]} evaluations for a domain of {domain.size}")
        self.domain = domain
        self.evals = evals

    @classmethod
    def from_coeffs(cls, domain: Radix2Domain, coeffs: torch.Tensor) -> "Evaluations":
        return cls(domain, domain.fft(coeffs))

    def interpolate(self) -> torch.Tensor:
        return self.domain.ifft(self.evals)

    def _chk(self, other: "Evaluations"):
        if (self.domain.size, self.domain.offset_int) != (other.domain.size, other.domain.offset_int):
            raise ValueError("mismatched domains")

    def __add__(self, other):
        self._chk(other)
        return Evaluations(self.domain, fp.add(self.domain.spec, self.evals, other.evals))

    def __sub__(self, other):
        self._chk(other)
        return Evaluations(self.domain, fp.sub(self.domain.spec, self.evals, other.evals))

    def __mul__(self, other):
        self._chk(other)
        return Evaluations(self.domain, fp.mont_mul(self.domain.spec, self.evals, other.evals))

    def __truediv__(self, other):
        self._chk(other)
        inv = fp.batch_inv(self.domain.spec, other.evals)
        return Evaluations(self.domain, fp.mont_mul(self.domain.spec, self.evals, inv))
