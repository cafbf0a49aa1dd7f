"""Linear maps over field elements: the csrc/flin.cu kernel and its plain
PyTorch version.

``fp_lin(spec, lmap, srcs, out)`` computes out[i] = sum_j c[i][j] src[j] mod
p, fully reduced, for a ``LinMap`` c of small signed integers: the linear
glue of a tower product (ff/linmap.py derives the maps) in one launch, where
each addition was one fp_add or fp_sub launch. It replaces no Pallas kernel.

A source is a (k_j, L, *batch_j) tensor (k_j coefficient slots, the limb
axis, the batch), read in place through a slot stride on top of the
operand map of kernels/mont.py:_operand; the batches broadcast as the tower
code aligns them (trailing axes padded with 1s). The output is a new
contiguous (m, L, *batch) tensor, or ``out``, any view of that shape that
the map can write in place (not aliasing a source): a layout the map cannot
address, or whose elements share addresses (a stride-0 axis), raises rather
than be copied. Inputs must be words below p: every value on the paths is a
kernel's reduced output or a reduced constant. CPU tensors take
``fp_lin_plain``; CUDA tensors launch the kernel through the field's cached
``LinLauncher``, or raise.
"""

from __future__ import annotations

import functools
import math
import struct

import numpy as np
import torch

from zkarray_torch.core.fieldspec import FieldSpec
from zkarray_torch.core.limbs import int_to_limbs_np, normalize, sub_with_borrow
from zkarray_torch.kernels import _build
from zkarray_torch.kernels import mont as km

# csrc/flin.cu: LIN_MAX_SRC sources a map may read; a row's sum of |c| stays below
# COEF_SUM_LIMIT, so its 16-bit columns stay below 2^32; rows are a grid axis
MAX_SRC = 4
COEF_SUM_LIMIT = 1 << 16
MAX_ROWS = 65535
# csrc/flin.cu:LinCall with k used sources: table, consts, m, n, nw, nsrc, lanes,
# then (pointer, slot stride, ld, inner, outer) of each source and of the output
_CALLS = tuple(struct.Struct(f"{7 + 5 * (k + 1)}q") for k in range(MAX_SRC + 1))
# csrc/flin.cu: the lanes G a (row, element) can take (1: one thread a row); the
# crossovers of ``lanes``, measured on the card (PERF.md row K): four lanes or more
# while the launch's m x n x G lanes stay within FILL_THREADS, two while its m x n
# (row, element) pairs stay within PAIR_ELEMENTS
LANES = (1, 2, 4, 8, 16, 32)
FILL_THREADS = 1 << 15
PAIR_ELEMENTS = 1 << 16


@functools.lru_cache(maxsize=1 << 12)  # the paths launch a few dozen shapes: ~0.1 us, not ~0.5
def lanes(n: int, m: int, max_terms: int) -> int:
    """G, the lanes csrc/flin.cu gives each (row, element) of a launch of m
    rows over n elements whose longest row has ``max_terms`` terms: the
    power of two that covers that row, at most 32, halved while m n G
    exceeds FILL_THREADS (down to two), and one once m n exceeds
    PAIR_ELEMENTS. G = 1 is the one-thread body (wide batches, where the
    card is full of threads), G > 1 the narrow body (a row's terms over G
    lanes, its column sums by warp shuffles). The one place the body is
    chosen."""
    g = min(32, 1 << (max_terms - 1).bit_length()) if max_terms > 1 else 1
    while g > 2 and m * n * g > FILL_THREADS:
        g >>= 1
    return 1 if g == 2 and m * n > PAIR_ELEMENTS else g


class LinMap:
    """A linear map with small integer coefficients: ``rows[i]`` is output
    row i as (source, slot, coefficient) terms over sources of ``sizes[j]``
    slots. Raises ValueError on a map outside the kernel's bounds. The
    device table (and its address) and the plain version's matrix are built
    once per device and kept on the map."""

    def __init__(self, rows, sizes, name: str = ""):
        self.name = name
        self.sizes = tuple(int(s) for s in sizes)
        merged = []
        for r in rows:
            terms = {}
            for s, k, c in r:
                if not (0 <= s < len(self.sizes) and 0 <= k < self.sizes[s]):
                    raise ValueError(f"{name}: term ({s}, {k}) outside sources {self.sizes}")
                terms[(s, k)] = terms.get((s, k), 0) + int(c)
            merged.append(tuple((s, k, c) for (s, k), c in sorted(terms.items()) if c))
        self.rows = tuple(merged)
        self.m = len(self.rows)
        self.used = tuple(sorted({s for r in self.rows for s, _, _ in r}))
        if not 0 < self.m <= MAX_ROWS or not 0 < len(self.used) <= MAX_SRC:
            raise ValueError(f"{name}: {self.m} rows over {len(self.used)} sources; the kernel "
                             f"takes 1 to {MAX_ROWS} rows over 1 to {MAX_SRC} sources")
        if max(self.sizes[s] for s in self.used) >= 1 << 16:
            raise ValueError(f"{name}: a source of {max(self.sizes)} slots; at most 2^16 - 1")
        self.sum_abs = [sum(abs(c) for _, _, c in r) for r in self.rows]
        if max(self.sum_abs) >= COEF_SUM_LIMIT:
            raise ValueError(f"{name}: a row's sum of |c| is {max(self.sum_abs)}; the bound is "
                             f"below {COEF_SUM_LIMIT}")
        self.max_terms = max(len(r) for r in self.rows)
        self.cneg = [sum(-c for _, _, c in r if c < 0) for r in self.rows]
        self.kbits = [s.bit_length() for s in self.sum_abs]
        self._tables = {}
        self._plain = {}

    def __repr__(self):
        return f"LinMap({self.name}, {self.m} rows, sources {self.sizes})"

    def table_words(self) -> np.ndarray:
        """The int32 table csrc/flin.cu reads: per row (first term's word
        offset, terms, cneg, kbits), then per term (position of the source
        among the used ones << 16 | slot, coefficient)."""
        pos = {s: i for i, s in enumerate(self.used)}
        head, terms = [], []
        for r, cn, kb in zip(self.rows, self.cneg, self.kbits):
            head.append((4 * self.m + 2 * len(terms), len(r), cn, kb))
            terms.extend((pos[s] << 16 | k, c) for s, k, c in r)
        words = np.asarray(head, dtype=np.int32).reshape(-1)
        if terms:
            words = np.concatenate([words, np.asarray(terms, dtype=np.int32).reshape(-1)])
        return words

    def table_ptr(self, index: int) -> int:
        """Address of ``table_words`` on device ``index`` (as
        Tensor.get_device gives it: -1 for the CPU), uploaded on first use
        and kept, with the tensor that owns it, by that index."""
        got = self._tables.get(index)
        if got is None:
            dev = torch.device("cuda", index) if index >= 0 else torch.device("cpu")
            t = torch.from_numpy(self.table_words()).to(dev)
            got = self._tables[index] = (t, t.data_ptr())
        return got[1]

    def plain_matrix(self, device):
        """(W, cneg, kmax): W the (m, 2K) float64 matrix [positive c | -negative
        c] over the used sources' K slots in order, cneg (m, 1) int64."""
        got = self._plain.get(device)
        if got is None:
            off, o = {}, 0
            for s in self.used:
                off[s], o = o, o + self.sizes[s]
            w = np.zeros((self.m, 2 * o), dtype=np.float64)
            for i, r in enumerate(self.rows):
                for s, k, c in r:
                    w[i, off[s] + k + (o if c < 0 else 0)] = abs(c)
            got = self._plain[device] = (
                torch.from_numpy(w).to(device),
                torch.tensor(self.cneg, dtype=torch.int64, device=device)[:, None],
                max(self.kbits))
        return got


def _sources(lmap: LinMap, srcs, L: int):
    """The map's used sources, each (k_j, L, *batch) with one broadcast
    batch shape (the tower code's trailing alignment), and that shape."""
    ts = [srcs[s] for s in lmap.used]
    shapes = [t.shape for t in ts]
    for s, sh in zip(lmap.used, shapes):
        if len(sh) < 2 or sh[0] != lmap.sizes[s] or sh[1] != L:
            raise ValueError(f"fp_lin {lmap.name}: source {s} is {tuple(sh)}, not "
                             f"({lmap.sizes[s]}, L={L}, *batch)")
    batch = shapes[0][2:]
    if all(sh[2:] == batch for sh in shapes[1:]):  # broadcast_shapes costs host time
        return ts, batch
    batch = common_batch(ts)
    return [t.reshape(tuple(t.shape) + (1,) * (len(batch) - t.dim() + 2))
            .expand(tuple(t.shape[:2]) + batch) for t in ts], batch


def common_batch(ts) -> tuple:
    """The broadcast batch of (k, L, *batch) tensors, each padded with
    trailing 1s to one count of batch axes (the towers' alignment)."""
    batch = ts[0].shape[2:]
    if all(t.shape[2:] == batch for t in ts[1:]):  # broadcast_shapes costs host time
        return batch
    nb = max(t.dim() - 2 for t in ts)
    return tuple(torch.broadcast_shapes(*(tuple(t.shape[2:]) + (1,) * (nb - t.dim() + 2)
                                          for t in ts)))


@functools.lru_cache(maxsize=None)
def _plain_consts(spec: FieldSpec, kmax: int, device: str):
    """(L, 1, 1) int64 limbs of p + 1 and the (L + 1, 1, 1) limbs of p 2^b,
    b < kmax."""
    L = spec.num_limbs
    p = spec.modulus

    def col(x, n):
        return torch.from_numpy(int_to_limbs_np(x, n).astype(np.int64)).to(device).reshape(n, 1, 1)

    return col(p + 1, L), [col(p << b, L + 1) for b in range(kmax)]


def fp_lin_plain(spec: FieldSpec, lmap: LinMap, srcs, out: torch.Tensor | None = None):
    """``fp_lin`` in plain PyTorch on the tensors' device: the signed column
    sums of all rows as one float64 matrix product of [c > 0 | -c for c < 0]
    with the limbs and their complements 2^16 - 1 - x (exact: every sum is
    an integer below 2^32), plus cneg (p + 1) as in the kernel; the carries in
    one normalize, then kbits conditional subtractions of p 2^b."""
    L = spec.num_limbs
    ts, batch = _sources(lmap, srcs, L)
    dev = ts[0].device
    n = math.prod(batch)
    w, cneg, kmax = lmap.plain_matrix(dev)
    x = torch.cat([t.reshape(t.shape[0], L * n) for t in ts]).to(torch.float64)
    cols = (w @ torch.cat([x, 65535.0 - x])).to(torch.int64).reshape(lmap.m, L, n)
    p1, pb = _plain_consts(spec, kmax, str(dev))
    limbs, top = normalize(cols.permute(1, 0, 2) + cneg[None] * p1, L, carry_out=True)
    t_ = torch.cat([limbs, (top - cneg)[None]])  # T on L + 1 limbs, below 2^kmax p
    for b in reversed(range(kmax)):
        d, borrow = sub_with_borrow(t_, pb[b])
        t_ = torch.where(borrow[None], t_, d)
    res = t_[:L].permute(1, 0, 2).to(torch.int32).reshape((lmap.m, L) + batch)
    return res if out is None else out.copy_(res)


def _operand(t: torch.Tensor, n: int):
    """(tensor, slot stride, ld, inner, outer) of a (k, L, *batch) source of
    n batch elements: slot s, limb k, batch element i at offset s*slot +
    k*ld + map(i), map as kernels/mont.py:batch_map (memoised); a contiguous
    source without a call of it, one that no map addresses copied first (the
    copy held by the caller until the launch)."""
    if not t.is_contiguous():
        st = t.stride()
        m = km.batch_map_memo(t.shape[2:], st[2:])
        if m is not None:
            return t, st[0], st[1], m[0], m[1]
        t = t.contiguous()
    return t, t.shape[1] * n, n, n, 0


def out_operand(name: str, out: torch.Tensor, n: int):
    """(slot stride, ld, inner, outer) of an (m, L, *batch) output of n
    batch elements that the kernel writes in place (``_operand``'s map);
    raises where there is none, rather than write a copy: a layout the map
    cannot address, or one whose elements share addresses
    (``km.distinct_addresses``: a stride-0 batch or limb axis, a slot stride
    of 0 over more than one row), as kernels/mont.py:out_map refuses for the
    additions."""
    if out.is_contiguous():
        return out.shape[1] * n, n, n, 0
    st = out.stride()
    m = km.batch_map_memo(out.shape[2:], st[2:])
    if m is None or not km.distinct_addresses(out.shape, st):
        raise ValueError(f"fp_lin {name}: out's strides {st} cannot be written in place")
    return st[0], st[1], m[0], m[1]


class LinLauncher(km.FieldLauncher):
    """csrc/flin.cu's linear map (zk_fp_lin_v) for one field on one CUDA
    device, built once by ``lin_launcher``: the library's C entry beside
    ``FieldLauncher``'s state. A call packs one csrc/flin.cu:LinCall (a new
    bytes object, so callers share no buffer) and reads each map's device
    table through ``LinMap.table_ptr``."""

    __slots__ = ("fn",)

    def __init__(self, spec: FieldSpec, index: int):
        super().__init__(spec, index, "fp_lin")
        self.lib = _build.load("flin")
        self.fn = self.lib.zk_fp_lin_v

    def launch(self, lmap: LinMap, srcs, out: torch.Tensor | None) -> torch.Tensor:
        if self.current_device() != self.index:
            with torch.cuda.device(self.index):
                return self.launch(lmap, srcs, out)
        index = self.index
        ts, batch = _sources(lmap, srcs, self.L)
        for t in ts if out is None else ts + [out]:
            if t.dtype is not torch.int32:
                raise TypeError(f"fp_lin: expected int32 tensors, got {t.dtype}")
            if t.get_device() != index:
                raise ValueError("fp_lin: tensors on different devices")
        n = math.prod(batch)
        shape = (lmap.m, self.L) + batch
        if out is None:
            out = ts[0].new_empty(shape)  # int32 on this device, without parsing a device
            o_map = (self.L * n, n, n, 0)
        elif out.shape != shape:
            raise ValueError(f"fp_lin {lmap.name}: out {tuple(out.shape)} is not {tuple(shape)}")
        else:
            o_map = out_operand(lmap.name, out, n)
        words = [lmap.table_ptr(index), self.consts, lmap.m, n, self.nw, len(ts),
                 lanes(n, lmap.m, lmap.max_terms)]
        held = []  # copies of sources that no map addresses, until the launch
        for t in ts:
            t, slot, ld, inner, outer = _operand(t, n)
            held.append(t)
            words += (t.data_ptr(), slot, ld, inner, outer)
        words.append(out.data_ptr())
        words += o_map
        err = self.fn(_CALLS[len(ts)].pack(*words), self.raw_stream(index))
        if err:
            _build.check(self.lib, err, "fp_lin")
        _build.LAUNCHES["fp_lin"] += 1
        return out


_LIN_LAUNCHERS: dict = {}


def lin_launcher(spec: FieldSpec, index: int) -> LinLauncher:
    """The ``LinLauncher`` of ``spec`` on CUDA device ``index``, built on
    first use and kept (keyed as kernels/mont.py:product_launcher's)."""
    got = _LIN_LAUNCHERS.get((id(spec), index))
    if got is None:
        got = _LIN_LAUNCHERS[(id(spec), index)] = LinLauncher(spec, index)
    return got


def _launch_lin(spec: FieldSpec, lmap: LinMap, srcs, out: torch.Tensor | None) -> torch.Tensor:
    """Launch csrc/flin.cu:fp_lin_kernel through the field's ``LinLauncher``
    on the device of the map's first used source: each source read in place
    as ``_operand`` allows (or copied, the copy held until the launch); the
    output ``out``, written through its map (``out_operand``: it raises where
    that needs a copy), or a new contiguous (m, L, *batch) tensor."""
    return lin_launcher(spec, srcs[lmap.used[0]].get_device()).launch(lmap, srcs, out)


def fp_lin(spec: FieldSpec, lmap: LinMap, srcs, out: torch.Tensor | None = None) -> torch.Tensor:
    """out[i] = sum_j c[i][j] src[j] mod p for the map ``lmap`` over the
    (k_j, L, *batch_j) sources ``srcs`` (an unused source may be None).
    CPU tensors: ``fp_lin_plain``; CUDA tensors: csrc/flin.cu, one launch;
    a mix of devices raises."""
    used = [srcs[s] for s in lmap.used]
    if out is not None:
        used.append(out)
    for t in used:
        if not t.is_cuda:
            break
    else:
        return _launch_lin(spec, lmap, srcs, out)
    if km.on_cpu(*used):
        return fp_lin_plain(spec, lmap, srcs, out)
    return _launch_lin(spec, lmap, srcs, out)
