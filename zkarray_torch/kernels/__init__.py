"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.

Sources live in ``csrc/``; ``_build`` compiles them with nvcc at first use
and binds them with ctypes. ``LAUNCHES`` counts each kernel's launches.

    kernel           source    wrappers                                replaces (zkarray/kernels)
    mont_mul         mont.cu   mont.mont_mul                           mont.py:mont_mul
    mont_sqr         mont.cu   mont.mont_sqr                           mont.py:mont_sqr
    mont_pow         mont.cu   mont.mont_pow                           (none: ff/fp.py:pow_const's launch chain)
    mont_inv         mont.cu   mont.mont_inv                           (none: ff/fp.py:inv's Fermat chain, by a batched binary GCD)
    mont_div         mont.cu   mont.mont_div                           (none: ec/sw.py:xyzz_to_affine's batch inverses and products)
    xyzz_accum       sw.cu     sw.xyzz_accum_grid, sw.xyzz_accum_tiles  sw.py:xyzz_accum_grid, :xyzz_accum_tiles
    horner_windows   sw.cu     sw.horner_windows                       sw.py:horner_windows
    butterfly_dit    ntt.cu    mont.butterfly_dit                      mont.py:butterfly_dit_inplace
    butterfly_stage  ntt.cu    mont.butterfly_stage                    mont.py:butterfly_stage
    xyzz_add_affine  madd.cu   sw.xyzz_add_affine                      sw.py:xyzz_add_affine
    xyzz_add         xyzz.cu   sw.xyzz_add                             (none: ec/sw.py:xyzz_add's launch chain)
    xyzz_double      xyzz.cu   sw.xyzz_double                          (none: ec/sw.py:xyzz_double's launch chain)
    xyzz_tree_sum    xyzz.cu   sw.xyzz_tree_sum                        (none: ec/msm.py:_tree_sum_last's per-level launches)
    xyzz_bit_horner  sw.cu     sw.xyzz_bit_horner                      (none: ec/msm.py:_weighted_sum_bits' bit-Horner launches)
    pow_table        twiddle.cu  mont.pow_table                        (none: poly/domain.py's table launch chains)
    twiddle_mul      twiddle.cu  mont.twiddle_mul                      (none: poly/domain.py's table launch chains)
    fp_add           fadd.cu   mont.fp_add                             (none: ff/fp.py:add and :double, plain torch chains)
    fp_sub           fadd.cu   mont.fp_sub, mont.fp_neg                (none: ff/fp.py:sub and :neg, plain torch chains)
    fp_lin           flin.cu   lin.fp_lin                              (none: a tower product's fp_add/fp_sub chains, ff/linmap.py)
    sf_op            smallfp.cu  smallfp.sf_op                         (none: ff/smallfp.py, fp64.py, smallfp64.py's element-wise chains)
    sf_butterfly     smallfp.cu  smallfp.sf_butterfly                  (none: a stage of ff/smallfp.py:ntt and ff/fp64.py:ntt)
"""

from zkarray_torch.kernels._build import LAUNCHES, reset_launches  # noqa: F401
# the JAX package's re-exports, without its Pallas switches (use_pallas,
# pallas_enabled, interpret_mode): a tensor's device picks the route here
from zkarray_torch.kernels.mont import butterfly_stage, mont_mul, mont_sqr  # noqa: F401
