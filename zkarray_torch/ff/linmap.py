"""The linear maps around a tower product, derived from its schedule.

A tower product (ff/towers.py's ExtOps.mul, sqr and mul_base, the
Granger-Scott square of ff/cyclotomic.py, the sparse line products of
ff/sparse12.py) is one layer of base-field products between two linear maps
with small integer coefficients: the additions that form the products'
operands, and the additions (with the tower's nonresidues, all small
integers or coefficient shuffles) that combine the products into the
result. Every value on the way is a fully reduced field element, so each map
may be computed in one pass without changing a word (kernels/lin.py:fp_lin).

``derive`` runs an op's own schedule once over symbolic values: at the bottom
of the tower a prime-field element is a linear form over input slots (a
``Form``); add, sub, neg, double and a product by a small integer act on
forms; each base-field product is recorded as a new slot. It refuses
(``NotLinear``) a product of a product, a constant operand (Frobenius and
curve constants stay mont_mul operands) and a coefficient that is not a small
integer. The result is a ``Route``: a pre-map from the inputs' prime
coefficients to the x and y operands of one mont_mul over an (L, S, *batch)
slab, and a post-map from the S products (and the inputs, which the
Granger-Scott square's 3 t0 - 2 r0 reads) to the result's coefficients.
Because the maps come from the JAX package's schedules (Karatsuba, the
Toom-style cubic, the complex and CH-SQR2 squarings, Granger-Scott, the
sparse line products), the products are the same ones, and so are the words.

``run`` caches the route per (tower object, op) and computes the op as fp_lin (pre)
-> mont_mul -> fp_lin (post): three launches on a CUDA device, the same route
on the CPU through the plain versions. Every tower of the port derives its
routes; the schedules never run on tensors.
"""

from __future__ import annotations

import math

import numpy as np

from zkarray_torch.ff import towers
from zkarray_torch.kernels import lin
from zkarray_torch.kernels import mont as km

# a prime-field constant enters a map as a coefficient when |c| is below this
SMALL_INT = 1 << 15


class NotLinear(ValueError):
    """An op that is not one product layer between two small-integer maps."""


class Form(dict):
    """A linear form over slots: {(source, slot): coefficient}, source 0 the
    product slab and source j + 1 the op's input j."""

    def __add__(self, o):
        r = Form(self)
        for k, c in o.items():
            v = r.get(k, 0) + c
            if v:
                r[k] = v
            else:
                r.pop(k, None)
        return r

    def __neg__(self):
        return Form({k: -c for k, c in self.items()})

    def __sub__(self, o):
        return self + (-o)

    def scale(self, c: int):
        return Form({k: c * v for k, v in self.items()}) if c else Form()


class _SymPrime:
    """The prime field on forms; products are recorded in ``products``."""

    deg_abs = 1
    shape = ()

    def __init__(self, spec):
        self.spec = spec
        self.products = []

    def add(self, a, b):
        return a + b

    def sub(self, a, b):
        return a - b

    def neg(self, a):
        return -a

    def double(self, a):
        return a + a

    def mul_const(self, a, host_elem):
        p = self.spec.modulus
        c = host_elem % p
        if c > p // 2:
            c -= p
        if abs(c) >= SMALL_INT:
            raise NotLinear(f"{self.spec.name}: the constant {host_elem} is not a small integer")
        return a.scale(c)

    def mul(self, a, b):
        if any(src == 0 for f in (a, b) for src, _ in f):
            raise NotLinear(f"{self.spec.name}: a product of a product (two product layers)")
        self.products.append((a, b))
        return Form({(0, len(self.products) - 1): 1})

    def sqr(self, a):
        return self.mul(a, a)


class _SymExt(towers.ExtOps):
    """An ExtOps over forms: elements are object arrays of its shape, the
    products are its schedules, and _mul_many multiplies pair by pair."""

    mul = towers.ExtOps._mul_sched
    sqr = towers.ExtOps._sqr_sched
    mul_base = towers.ExtOps._mul_base_sched

    def _stack(self, parts):
        out = np.empty((len(parts),) + self.base.shape, dtype=object)
        for j, p in enumerate(parts):
            out[j] = p
        return out

    def add(self, a, b):
        return a + b

    def sub(self, a, b):
        return a - b

    def neg(self, a):
        return -a

    def double(self, a):
        return a + a

    def _mul_many(self, pairs):
        return [self.base.mul(x, y) for x, y in pairs]

    def const(self, *args, **kwargs):
        raise NotLinear(f"{self.name}: a constant operand inside a traced op")


def _symbolic(ops, prime):
    if not isinstance(ops, towers.ExtOps):
        return prime
    s = _SymExt.__new__(_SymExt)
    s.__dict__.update(ops.__dict__)
    s.base = _symbolic(ops.base, prime)
    return s


def _sym_input(ops, j: int):
    if not ops.shape:
        return Form({(j + 1, 0): 1})
    arr = np.empty(ops.shape, dtype=object)
    for c in range(arr.size):
        arr[np.unravel_index(c, ops.shape)] = Form({(j + 1, c): 1})
    return arr


class Route:
    """fp_lin (pre) -> mont_mul -> fp_lin (post) for one op of one tower."""

    def __init__(self, pre: lin.LinMap, post: lin.LinMap, n_products: int, out_shape: tuple,
                 naxes):
        self.pre, self.post = pre, post
        self.s = n_products
        self.out_shape = out_shape
        self.naxes = naxes  # coefficient axes of each input

    def __call__(self, spec, srcs):
        L = spec.num_limbs
        flat = [t.flatten(0, k - 1) if k > 1 else t if k == 1 else t.unsqueeze(0)
                for t, k in zip(srcs, self.naxes)]
        batch = lin.common_batch([flat[j] for j in self.pre.used])
        slab = flat[0].new_empty((L, 2 * self.s) + batch)
        lin.fp_lin(spec, self.pre, flat, out=slab.movedim(1, 0))
        prod = km.mont_mul(spec, *slab.chunk(2, 1))  # the x and y halves, (L, S, *batch) each
        res = lin.fp_lin(spec, self.post, [prod.movedim(1, 0)] + flat)
        return res if len(self.out_shape) == 1 else res.unflatten(0, self.out_shape)


def derive(ops, op: str, sched, src_ops) -> Route:
    """Trace ``sched(ops, *inputs)`` once over symbolic inputs shaped as
    ``src_ops``' elements; raises NotLinear where the op is not one product
    layer between two small-integer maps."""
    prime = _SymPrime(ops.spec)
    out = sched(_symbolic(ops, prime), *(_sym_input(o, j) for j, o in enumerate(src_ops)))
    prods = prime.products
    if not prods:
        raise NotLinear(f"{ops.name} {op}: no product")
    sizes = [math.prod(o.shape) for o in src_ops]
    name = f"{ops.name} {op}"

    def pre_row(f):
        return [(s - 1, k, c) for (s, k), c in f.items()]

    try:
        pre = lin.LinMap([pre_row(x) for x, _ in prods] + [pre_row(y) for _, y in prods], sizes,
                         name + " pre")
        post = lin.LinMap([[(s, k, c) for (s, k), c in f.items()] for f in out.flat],
                          [len(prods)] + sizes, name + " post")
    except ValueError as exc:
        raise NotLinear(str(exc)) from exc
    return Route(pre, post, len(prods), tuple(out.shape), [len(o.shape) for o in src_ops])


# (id(ops), op) -> (ops, route): ExtOps.__hash__ and __eq__ recurse down the
# tower to FieldSpec's Python hash, which a lookup by the object would pay a
# call; the ops is held beside its route, so its id stays its own
_ROUTES: dict = {}


def route(ops, op: str, sched, src_ops) -> Route:
    """The route of (ops, op), derived on first use and cached."""
    got = _ROUTES.get((id(ops), op))
    if got is None:
        got = _ROUTES[(id(ops), op)] = (ops, derive(ops, op, sched, src_ops))
    return got[1]


def run(ops, op: str, sched, srcs, src_ops):
    """``sched(ops, *srcs)`` through its route: one mont_mul between two
    fp_lin launches. ``src_ops`` gives each input's tower (its coefficient
    axes)."""
    return route(ops, op, sched, src_ops)(ops.spec, srcs)
