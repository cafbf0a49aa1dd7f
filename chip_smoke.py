#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (zkarray_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each printing one JSON line and raising on any failure:

1. header: the card (nvidia-smi name and power limit), torch and CUDA
   versions; the nvcc build of every kernel source, started in parallel
   with a SASS probe (one field operation per kernel, NW = 12), with its
   time and each kernel's registers and spills (-Xptxas -v); from
   cuobjdump -sass, the instructions (and IMADs) of one product and one
   addition in each of field.cuh's routines, and the code size of the two
   sw.cu kernels and of a one-thread window Horner with xyzz_dbl/xyzz_add
   inlined (the earlier design of horner_windows); registers, spills and
   SASS instructions of the xyzz.cu and madd.cu kernels; one dependent
   carried add's latency in SM cycles (a one-thread chain between two
   clock64() reads), for mont_inv's chain bound.
2. kernel vs plain: each CUDA kernel against its plain PyTorch version on
   the same device inputs, bit for bit (tolerance zero), with both times:
   mont_mul and mont_sqr on 2^20 Fq and Fr elements; xyzz_accum through both
   wrappers on two edge-class feeds (random field elements, 16421 slots x 32
   rounds; testing.accum_edge_rounds' real points, 4099 x 8) and on a random
   feed at the main path's band-1 shape; horner_windows at W = 20, c = 13 on
   random windows and on testing.horner_edge_windows (its total also held
   against the host oracle). Each xyzz_accum row has the wrapper's wall ms,
   device ms (CUDA events), ns per add, share of the operation bound,
   registers, spills, resident blocks per SM and waves; each
   horner_windows row its ms per product and per critical-path product.
3. main path: BLS12-381 G1 msm at n = 2^20, 254-bit scalars, c = 13, on
   tiled inputs with a host known answer; launch counts from one run
   (xyzz_add 2, xyzz_tree_sum 1, xyzz_bit_horner 1, xyzz_double 0: the 13
   weight bits in one group, two tree levels wider than TREE_SUM_MAX;
   the to-affine one mont_div, no mont_mul, mont_inv or mont_pow), with
   the shape and operand map of every mont_mul/mont_sqr/mont_pow/mont_inv,
   xyzz_add/xyzz_double and xyzz_tree_sum launch recorded (and the inputs
   of the first launch of each, views as the tree sums pass them; the
   to-affine's X, ZZ, Y, ZZZ; the bit-Horner's partials). Then
   mont_mul against its plain version at each of its shapes (inputs
   non-contiguous halves of a wider tensor), and xyzz_add/xyzz_double
   against _fadd_plain/_dbl_plain and xyzz_tree_sum against its plain
   version on the recorded inputs themselves, with both times and a bound
   from those inputs' lane classes (xyzz_add's rows split into tree levels
   and bit-Horner adds before xyzz_bit_horner), xyzz_double on the
   bit-Horner's top partials, its old path shape; the median of 3 timed
   runs split into accumulate,
   reduce and to-affine (and the to-affine's launches by kernel, counted
   on one more call); one msm_reduce under torch.profiler (CUDA
   activity only) for its launches, the device's busy time, idle share and
   host time per device op; mont_pow against its plain version at 2^20 Fq
   elements (zeros and mont_inv's edge words included) and at one element,
   for p - 2, and once through ff.fp.pow_const; mont_inv against its plain
   version (Fermat) on testing.mont_inv_edge_words (0, 1, R mod p, p - 1,
   powers of two, random; also against Python's pow), each alone and in one
   launch, on the MSM's ZZ and ZZZ at (24, 1), at (24, 2^12) and at 2^20
   elements (both lane layouts), with the device ms from a trace, its chain
   bound (testing.mont_inv_chain's dependent instructions x the latency
   from phase 1), its operation bound and its registers, stack and spills;
   mont_div (the to-affine) against its plain route on the MSM's own
   result, that point at infinity and 2^16 points, with its device ms and
   chain bound, and the batch-inverse route's ms at 2^16 beside its own;
   xyzz_accum on the path's own band-1 feed (recorded from one more
   accumulate) and band-2 feed; horner_windows on the path's own window
   rows, and every horner_windows row's chain bound: its critical-path
   products x mont_pow's time per product in one thread, and the same chain
   bound for xyzz_add's element-wise launches (one add, 4 products deep)
   and every xyzz_tree_sum row (its rounds of TREE_QUADS adds, each 4
   products deep, and one add a level), each tree row with its share of
   the operation and chain bounds, resident blocks per SM and waves, and
   the kernel's registers and spills (CallOps and PlainCallOps);
   xyzz_bit_horner against its plain version on the path's partials
   (L, 13, 20) and on testing.bit_horner_edge_parts, with its chain bound
   (12 doublings and adds, 84 products deep); xyzz_add and
   xyzz_double on an edge-class feed of 2^20 Fq points (generic, P == Q,
   P == -Q, P = inf, Q = inf, both inf, y = 0), xyzz_double also through
   ec.sw.xyzz_double (its path now); xyzz_tree_sum on rows made
   from that feed (element i of a row meets element i + m // 2 in one of
   those classes) at odd, even and full widths, and ec/msm.py's tree route
   at widths beyond TREE_SUM_MAX (element-wise levels, then the tree sum),
   each against the plain tree sum.
4. ChunkedMSM at 2^21 as two 2^20 chunks, known-answer checked.
5. NTT path: Radix2Domain(Fr, 2^24).fft of geometric coefficients
   a_j = c r^j, held at 256+ output indices against the host closed form
   c (1 - r^n) / (1 - r w^k); launch counts from that run, cold (the
   power-table cache cleared before it: no mont_mul or mont_sqr launch, one
   twiddle_mul per pass-1 block, at most 3 pow_table), with every
   butterfly_dit launch's (C, H, R, stride) and every pow_table and
   twiddle_mul call's arguments recorded; every cached table against the
   plain version, and the same fft again, warm: no pow_table launch, its
   words the cold fft's and the closed form's; the cached tables held
   unchanged after phase 5's, 13's and 15's fft paths. fft/ifft round trip of seeded
   random coefficients at 2^24 (bit for bit, input unchanged); a coset
   (offset 7) round trip and closed-form check at 2^20 (fft_fourstep_core);
   the degree-aware fft of 2^22 coefficients at 2^24, closed-form checked,
   with its peak memory; the median of 3 timed ffts at 2^24 (ms, elems/s,
   peak memory); one fft under torch.profiler. Then butterfly_dit against
   its plain version at every recorded shape, and pow_table and twiddle_mul
   at every argument set of phase 5's runs (the fft's, the round trip's,
   the coset's and the degree-aware's), with both times; pow_table also
   with its device time from a trace of its own calls and the host time
   of a build (the wrapper's call; the host words alone).
6. butterfly_stage through its entry (kernels.mont.butterfly_stage) on 2^20
   Fr elements against its plain version.
7. xyzz_add_affine through its entry (ec.sw.xyzz_add_affine) on 4096 real
   BLS12-381 G1 point pairs against the host oracle; then the kernel
   against its plain version on 2^20 Fq points with the edge classes
   (generic, P == A, P == -A, P = inf, A = inf, both inf, doubling a y = 0
   point), and on 2^20 generic pairs (random finite P and A), each with
   its own bound. mont_sqr's path: ec.sw.xyzz_double_affine on 2^20 points (64
   real points and infinity, tiled) against the host oracle, its mont_sqr
   launches at phase 2's shape.
8. the field and G1 group path (BASELINE configs 1-2), each result held
   against host known answers: BN254 Fr mont_mul, mont_sqr, add, sub,
   batch_inv, legendre and sqrt (Tonelli-Shanks) on 2^16 elements, 256
   sampled indices against Python ints (the roots against
   testing.sqrt_reference), with ms and elements/s; BLS12-381 G1
   scalar_mul of 2^16 points by seeded 255-bit scalars and to_affine, 64
   sampled points against the host's ec_mul, its launches per scalar_mul
   and one more scalar_mul under torch.profiler (device ops, busy time,
   idle share); jac_add, jac_add_mixed and jac_double on the six edge
   classes with random Z, tiled to 2^16; clear_cofactor on points outside
   the subgroup; the generic and the fast subgroup check on 2^16 lanes of
   points in and outside the subgroup and infinity, every lane's mask
   exact; the 1,000 zcash G1 vectors tiled to 2^16, compressed and
   uncompressed, deserialized with validate=True (all accepted, with
   encodings of points outside the subgroup after them, all rejected) and
   serialized back byte-exact, with deserializations/s; BN254 and
   BLS12-377 G1 scalar_mul and generic subgroup_check at 2^12. Every
   mont_mul/mont_sqr/mont_pow/mont_inv launch of those runs is counted and
   recorded by (field, shape, exponent) with its first inputs; then each
   of the four kernels against its plain version at BN254 Fr and Fq,
   BLS12-381 Fr and Fq and BLS12-377 Fq on mont_inv_edge_words (all pairs
   for mont_mul; exponents 0, 1, 2, 3, p - 2, (p - 1)/2, the trace, 2^(s-1)
   and the square-root exponent for mont_pow) and on every recorded input,
   with times and bounds at 2^16 (mont_mul and mont_sqr at NW = 8 and 12,
   mont_pow at each field's widest launch, mont_inv at its launches).
9. the pairing path (BASELINE config 5), each result against host known
   answers: BLS12-381 pairing_each over 2^12 pairs tiled from 64 seeded
   (a_j G, b_j H), every 1,024th G1 point at infinity, every lane against
   E^(a_j b_j) (1 at infinity; E = testing.E_BLS12_381), run once with the
   launches per call counted by kernel, then PAIR_TIMED_RUNS timed runs
   (one) and one under torch.profiler (device ops, busy, idle share); pairing (the
   product over the same pairs) against E^(sum a_j b_j); BLS12-377
   pairing_each at 2^12 (D-twist) on its own E; one BLS12-381
   pairing_each over 2^16 pairs with its peak memory; the 1,000 zcash G2
   vectors tiled to 2^16 with 16 encodings outside G2 after them,
   deserialized with validate=True (all accepted and re-serialized
   byte-exact, sampled points against k H; the 16 rejected), both
   encodings; bls12_381_g2_subgroup_check on 2^16 lanes in G2, outside it
   and at infinity, every lane exact. fp_add and fp_sub (csrc/fadd.cu;
   fp_sub also as fp_neg) against their plain versions at BN254 Fr and Fq,
   BLS12-381 Fr and Fq and BLS12-377 Fq on testing.fadd_edge_words (all
   pairs: 0, 1, p - 1, words >= p, carries and borrows across every 32-bit
   word) and on the first inputs of every (field, shape, strides) key
   recorded on phases 8 and 9, each with its first words; times at
   (24, 2^16) and at the path's widest launch against the byte bound 3 x L
   x 4 B / 3.35 TB/s. The product kernels against their plain versions on
   every (field, shape, exponent) key of phase 9's runs.
10. BN254, GT and the BW6 pairings, each against host known answers:
   BN254 pairing_each over 2^12 pairs tiled from 64 seeded (a_j G1, b_j
   G2), every 1,024th G1 point at infinity, every lane against
   E_BN254^(a_j b_j), and once over 2^16 pairs; pairing over the 2^12
   against E^(sum); GT on BLS12-381's Fp12 (2^12 elements E^(k_i), k and
   255-bit s < r tiled from 64 seeded values): gt_mul_scalar against
   E^(k_i s_i), gt_msm (c = 3) against E^(sum k_i s_i), neg, sub and
   double; BW6-761 and BW6-767 pairing_each and pairing at 2^12 against
   their E. Each path (pairing_each, gt_mul_scalar, gt_msm): the launches
   of one call by kernel (counted from 0 just before it), its peak memory,
   PAIR_TIMED_RUNS timed calls and one traced call (device ops, busy, idle
   share); pairing: its launches and one timed call. Then the six field kernels
   at NW = 24 (mont_mul, mont_sqr, mont_pow, mont_inv, fp_add, fp_sub, the
   last also as fp_neg) against their plain versions on edge words of both
   768-bit fields; every kernel of the phase against its plain version on
   every (field, shape, strides) input recorded on the first counted call
   of each path (BN254's and the BW6 curves' pairing_each and pairing,
   gt_mul_scalar, gt_msm), one kernel_phase10_shapes line per kernel with
   each key's error and the paths that launched it; the NW = 24 kernels
   each timed at (48, 2^16) and at its widest BW6 launch,
   with bounds and ptxas' registers, stack and spills at NW = 24; and
   xyzz_add, xyzz_add_affine, horner_windows, butterfly_dit and pow_table
   refusing NW = 24 (each raises, no launch counted).
11. msm_mixed, the MNT and CP6 pairings, NW = 10 and 26: ec/msm.py:msm_mixed
   on BLS12-381 G1 at 2^20 tiled points with scalars in six magnitude
   classes (0, 1, <= 8, <= 16, <= 64 bits, full width; testing.
   mixed_scalars) against the host known answer, beside msm on the same
   inputs (class sizes, launches by kernel, peak memory; msm_mixed the
   median of 3 and a trace, msm, ~8 s a call on these skewed digits, one
   timed call); MNT4-298, MNT6-298, MNT4-753 and MNT6-753 pairing_each at
   2^12 pairs tiled from 64 seeded (a_j G1, b_j G2), a_j, b_j < 2^64, every 1,024th G1 point
   at infinity, every lane against host powers of the JAX package's E,
   and pairing once; CP6-782's host G2 ladder on the 64 distinct points
   (s per point), its Miller loop and final exponentiation on the prepared
   coefficients tiled to 2^12 lanes (every lane checked) and pairing_each
   end to end on 16 pairs. Then the six field kernels against their plain
   versions on the NW = 10 (MNT4/6-298) and NW = 26 (CP6-782) fields' edge
   words and on every (field, shape, strides) input recorded on the paths'
   first counted calls (one kernel_phase11_shapes line per kernel), and
   timed at (20, 2^16) and (52, 2^16) (mont_pow at e = p - 2), each result
   held against the plain version, with bounds, the widest launch of each
   width's paths and ptxas' registers, stack and spills (nw10_kernels,
   nw26_kernels).
12. fp_lin (csrc/flin.cu, the linear maps around every tower product:
   ff/linmap.py's route, fp_lin -> mont_mul -> fp_lin) against its plain
   version bit for bit: on edge words at NW = 8, 10, 12, 24 and 26 (BN254,
   MNT4-298, BLS12-381, BW6-761 and CP6-782 Fq; maps whose rows reach the
   coefficient bound, broadcast and strided sources, a strided output; the
   first 64 lanes also against Python ints) and on the first input of every
   (field, map, shape, strides) key recorded on the first counted calls of
   phases 9-11 (replayed where each phase replays its own keys, one
   kernel_lin_shapes line); each width's widest recorded path launch and
   BLS12-381 pairing_each's widest (the kernels line's figures) timed
   against their byte bounds, with the device time per launch in a trace
   of their own; the host's us per launch at 64 lanes for fp_lin's two BLS12-381
   Fp12-product maps, fp_add and a whole Fp12 product (fp_lin_host); and
   BLS12-381 pairing_each's launches per call held at most 12,000.
13. the polynomial layer and the scalar-multiplication family
   (``poly_scalar_phase``): the Groth16 quotient at 2^20 (dense.mul, then
   divide_by_vanishing_poly) and dense.evaluate at 64 points against host
   Horner; divide_with_q_and_r; a 2^20-entry MLE's eq_table,
   fix_variables and evaluate against host sums; the sparse evaluations;
   the largest mixed-radix domains of MNT6-753 Fr (NW = 24) and MNT4-298 Fq
   (NW = 10) and a GeneralDomain against host closed forms, with their
   round trips; fft_group on BLS12-381 G1 at 2^10 against (DFT c)_k G and
   its round trip at 2^4 (sizes cut to keep the script inside its time
   limit: each stage is one host-bound ladder); glv_mul, glv_mul_ext, WnafContext.mul and
   FixedBaseTable.batch_mul at 2^12-2^20 lanes against the host's ec_mul;
   msm_chunks at 2^21 and the two Pippengers. Each path's launches,
   wall ms, peak memory (traces for the quotient and the mixed-radix
   ffts); every field- and NTT-kernel input recorded on a path's first
   call, and every Pippenger MSM-kernel launch, held against the plain
   versions; the NTT kernels' widest launch at NW = 10 and 24 timed
   against its bound.
14. the other curve models and hashing to curves (``curves_h2c_phase``):
   hash to BLS12-381 G1 of 2^15 seeded messages (hash_to_field on the host,
   one bls12_381_g1_wb_map at (24, 2^16), the pairwise add, the h_eff
   ladder and to_affine, composed as hash_to_curve_bls12_381_g1; three u
   on SWU's exceptional branch) and to G2 of 2^13 (clear_cofactor_g2),
   every lane on the curve and in the subgroup, sampled lanes against
   testing.host_hash_to_g1/g2, the RFC 9380 vectors' u, Q0, Q1 and P
   through hash_to_curve_bls12_381_g1/g2; twisted Edwards scalar_mul and
   to_affine on Jubjub and Bandersnatch at 2^16 and ed_on_mnt4_298,
   ed_on_cp6_782, ed_on_mnt4_753 (NW = 10, 12, 24) at 2^12 against the
   host TE law, with r P the identity; Elligator2 at 2^16 (Jubjub,
   Bandersnatch; y' = 0 and x' = -1 lanes); the TE encodings' round trip
   on Jubjub; jq255s scalar_mul against the curve's own affine law and
   get_e_from_u; secp256k1 scalar_mul, glv_mul on Pallas, msm of 2^20
   Pallas and 2^16 secp256r1 points against the host; xyzz_accum,
   horner_windows, xyzz_bit_horner, xyzz_add and xyzz_double at a = -3 on
   edge feeds. Each path's launches by kernel, one timed call, peak
   memory (traces of the G1 hash and Jubjub's scalar_mul); every
   field-kernel key and every MSM-kernel launch of the paths held against
   the plain versions.
15. the small fields, the multi-device layer and serialization
   (``smallfield_dist_phase``): BabyBear ntt over (2^20, 64) and KoalaBear
   over (2^20, 16) (the forward transform at 4 indices of 2 columns against
   the host DFT, the inverse round trip word for word), Goldilocks fp64.ntt
   at 2^24 (a geometric input with replaced entries against the closed
   form, the round trip); the element-wise ops at 2^24 (BabyBear mont_mul,
   add, sub, neg, inv; m31_mul; Goldilocks and smallfp64 p62 and
   mersenne61 mul and inv), 4,096 sampled indices against Python ints;
   every sf_op and sf_butterfly launch of those first calls replayed against
   its plain version; each kernel's launches and times against its bounds;
   msm_sharded (BLS12-381 G1, 2^20) and fft_sharded (Fr, 2^24) on a
   one-rank NCCL group (a FileStore in the build directory), equal to msm's
   and Radix2Domain.fft's words and to the host known answer;
   sw_from_random_bytes (BLS12-381 G1) and te_from_random_bytes (Jubjub)
   on 2^16 byte strings, sampled lanes on the curve with the reference's
   root rule; a derived struct of 2^16 G1 points, 2^16 Fr elements and a
   string, both encodings round trip; xyzz_add_affine and xyzz_add on
   PlainCallOps (secp256r1, secp256k1: p >= R/2) on 2^20 edge-class lanes
   against the plain versions and the host; the secp256r1 2^16 msm's
   PlainOps launches, each timed against its bound.
16. the kernels line: per kernel its launches on its path (phase 3 for the
   MSM kernels, 5 for butterfly_dit, twiddle_mul and pow_table, 6 and 7 for
   the entries of butterfly_stage, xyzz_add_affine and mont_sqr, 3 for the
   entries of mont_pow and xyzz_double, which left the MSM path), error
   against the plain version, times and bound. For mont_mul, xyzz_add,
   xyzz_double, xyzz_tree_sum, butterfly_dit, pow_table and twiddle_mul the
   times and bound are means per launch over the path's launches, shape by
   shape (xyzz_add and xyzz_tree_sum also with their chain bound); mont_mul's
   fft launches (none) sit under "ntt". One row per CUDA kernel: xyzz_accum
   serves both xyzz_accum_grid and xyzz_accum_tiles. mont_mul, mont_sqr,
   mont_pow and mont_inv also carry phase 8's launches, rows and error
   under "group", and phase 9's launches per pairing call under "pairing";
   fp_add and fp_sub (no Pallas counterpart) have phase 9's pairing_each
   as their path. mont_mul, mont_sqr, mont_pow, mont_inv, fp_add and
   fp_sub also carry phase 10's launches per call under "bn254", "gt"
   (gt_mul_scalar and gt_msm), "bw6_761" and "bw6_767", and their NW = 24
   figures under "nw24"; phase 11's launches per call under "phase11" and
   their NW = 10 and 26 figures under "nw10" and "nw26". fp_lin's path is
   phase 9's pairing_each too; its row carries every path's launches per
   call (per_path_launches) and each width's widest path launch. Every
   kernel phase 13 launched carries its launches per path and error there
   under "phase13" (the NTT kernels also their NW = 8, 10 and 24 rows),
   and every row phase 14's launches per path and error under "phase14"
   and phase 15's under "phase15". sf_op's path is phase 15's element-wise
   ops, sf_butterfly's the BabyBear ntt; their rows' figures are their
   widest byte-bound launch, with every timed launch under "rows".
   Every row lists the word counts NW its kernel is built for
   ("nw_widths").

The last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero
before printing any result.
"""

import collections
import ctypes
import functools
import gc
import json
import math
import os
import platform
import re
import shutil
import subprocess
import sys
import time
import types

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_LANES_PER_SM = 64  # 32-bit integer multiply-add per SM per clock, compute capability 9.0
DEVICE = "cuda"
LOG_N = 20  # main-path MSM size; ChunkedMSM runs two chunks of this size
EDGE_SLOTS, EDGE_ROUNDS = 16421, 32  # xyzz_accum edge classes: not a multiple of 32
ORACLE_SLOTS, ORACLE_ROUNDS = 4099, 8  # xyzz_accum on testing.accum_edge_rounds
NTT_LOG_N = 24  # the NTT path: Radix2Domain(Fr, 2^24), fft_fourstep_big
COSET_LOG_N = 20  # coset round trip through fft_fourstep_core
DEG_LOG_M = 22  # coefficients of the degree-aware fft at 2^NTT_LOG_N
KAT_POINTS = 256  # output indices held against the host closed form
ELEM_LOG_N = 20  # butterfly_stage and the xyzz_add_affine edge feed
MADD_KAT_BASE = 64  # xyzz_add_affine known answer: all pairs of 64 points
TREE_QUADS = 64  # csrc/xyzz.cu: adds an xyzz_tree_sum block runs at once (4 lanes each)
ADD_DEPTH = 4  # products on a generic full XYZZ add's critical path
TREE_EDGE_ROWS = 80  # rows of each xyzz_tree_sum edge feed (the reduce's q x W)
TREE_EDGE_WIDTHS = (1, 2, 3, 13, 255, 1023, 1024)
TREE_ROUTE_WIDTHS = (1025, 2049, 3001)  # through ec/msm.py:_tree_sum_last
INV_PAIRING_LOG_N = 12  # mont_inv at (24, 2^12): the pairings' Fp12 inverse's width
DIV_LOG_N = 16  # mont_div (the to-affine) at 2^16 points against the batch-inverse route
GROUP_LOG_N = 16  # BASELINE configs 1-2: 2^16 BN254 Fr elements, 2^16 BLS12-381 G1 points
SMALL_LOG_N = 12  # BN254 and BLS12-377 G1: one scalar_mul and one subgroup_check each
FIELD_KAT = 256  # field results held against Python ints at this many sampled indices
GROUP_KAT = 64  # group results held against the host's ec_mul at this many sampled points
OFF_POOL = 16  # distinct curve points outside the subgroup, tiled
ZCASH_VECTORS = 1000  # tests/vectors/g1_*_valid_test_vectors.dat: k G for k < 1000
PAIR_LOG_N = 12  # BASELINE config 5: BLS12-381 pairing_each and pairing, BLS12-377 pairing_each
PAIR_BIG_LOG_N = 16  # one BLS12-381 pairing_each, for its peak memory
PAIR_BASE = 64  # seeded scalar pairs (a_j, b_j) the pairing inputs tile
PAIR_INF_EVERY = 1024  # every 1,024th lane's G1 point at infinity
# timed calls of each pairing and GT path after its counted first call
# (phases 9-11): one, which keeps the whole script within its time limit
# (three took ~1,120 s of the 1,200 on an H100 with phase 11)
PAIR_TIMED_RUNS = 1
G2_LOG_N = 16  # the zcash G2 vectors tiled, and the G2 subgroup check
FIELD48_LOG_N = 16  # phases 10-11: the field kernels timed at (L, 2^16), L = 48 and 20, 52
MIXED_LOG_N = 20  # phase 11: msm_mixed on BLS12-381 G1
MNT_LOG_N = 12  # phase 11: MNT pairing_each and CP6's Miller loop + final exponentiation lanes
CP6_EACH = 16  # phase 11: CP6-782 pairing_each end to end on this many distinct pairs
PAIR_SCALAR_BITS = 64  # phase 11: bits of a_j, b_j in the MNT and CP6 pairs (a_j G, b_j H)
REPO = os.path.dirname(os.path.abspath(__file__))


T_START = time.perf_counter()


def emit(phase, **kw):
    """One JSON line: the phase's name, the seconds since the script
    started (t_s) and its fields."""
    print(json.dumps({"phase": phase, "t_s": round(time.perf_counter() - T_START, 3), **kw}),
          flush=True)


def nvidia_smi(fields):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def host_cpu_model():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return None


def union_ns(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_trace(torch, fn, untraced_ms):
    """Run fn() once under torch.profiler with CUDA activity only (kernels,
    copies and the runtime calls that launch them). Returns (fn's result,
    fields), fields None when this torch build cannot trace CUDA activity.
    The untraced idle share is an estimate: device time under the trace over
    the untraced wall time ``untraced_ms`` of the same work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, supported_activities

    from zkarray_torch.kernels import LAUNCHES

    if ProfilerActivity.CUDA not in supported_activities():
        return fn(), None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t) * 1e3
    evs = prof.profiler.kineto_results.events()
    dev_iv = [(e.start_ns(), e.end_ns(), e.name()) for e in evs if e.device_type() == DeviceType.CUDA]
    api = collections.Counter(e.name() for e in evs if e.device_type() == DeviceType.CPU)
    by_name = collections.defaultdict(lambda: [0, 0])  # name -> [ops, device ns]
    for a, b, nm in dev_iv:
        by_name[nm][0] += 1
        by_name[nm][1] += b - a
    ours = {}
    for k in LAUNCHES:
        hits = [v for nm, v in by_name.items() if f"{k}_kernel" in nm]
        if hits:
            n_k, ns_k = sum(h[0] for h in hits), sum(h[1] for h in hits)
            ours[k] = dict(launches=n_k, device_ms=ns_k / 1e6, device_ms_per_launch=ns_k / 1e6 / n_k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    busy_ms = union_ns([(a, b) for a, b, _ in dev_iv]) / 1e6
    return out, dict(
        ms_wall_traced=traced_ms, device_ops=len(dev_iv), port_kernels=ours,
        top_device_ms=[dict(name=nm[:90], ops=v[0], device_ms=v[1] / 1e6) for nm, v in top],
        runtime_calls=dict(api.most_common(6)), ms_device_busy=busy_ms if dev_iv else None,
        device_idle_share=1 - busy_ms / traced_ms if dev_iv else None,
        device_idle_share_untraced_est=1 - busy_ms / untraced_ms if dev_iv else None,
        us_wall_per_device_op=traced_ms * 1e3 / len(dev_iv) if dev_iv else None,
        us_untraced_wall_per_device_op=untraced_ms * 1e3 / len(dev_iv) if dev_iv else None,
        note=None if dev_iv else "the trace holds no device events")


def traced_device_ms(torch, kernel, fn, reps, device):
    """(device ms per launch, launches recorded) of ``kernel`` over ``reps``
    calls of fn() traced on their own, after eight launches of another
    kernel inside the trace (the profiler can drop a trace's first few
    device ops); (None, 0) when the trace records none of its launches."""
    warm = torch.zeros(1, device=device)

    def body():
        for _ in range(8):
            warm.add_(1)
        for _ in range(reps):
            fn()

    _, tr = device_trace(torch, body, 1.0)
    k = None if tr is None else tr["port_kernels"].get(kernel)
    return (None, 0) if k is None else (k["device_ms_per_launch"], k["launches"])


def parse_ptxas(log):
    """{kernel function: {"registers": n, "stack_frame": b, "spill_stores": b,
    "spill_loads": b}}."""
    out = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            out[name]["stack_frame"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


# One product (or addition) per probe kernel, NW = 12, for instruction counts
# from cuobjdump -sass: a routine's count is its probe's minus probe_none's
# (the same loads and stores around an XOR). fmul_madcc is a CIOS written as
# PTX mad.lo.cc/madc.hi.cc chains, the carry-chain form field.cuh's
# fmul_wide was measured against; probe_horner_serial is the earlier design
# of horner_windows (one thread, xyzz_dbl/xyzz_add inlined), for its code
# size.
SASS_PROBE = r"""
#include "field.cuh"
#define MADCC(op, r, a, b, c) asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c))
__device__ __forceinline__ Fe<12> fmul_madcc(const Fe<12>& a, const Fe<12>& b,
                                             const FieldConsts<12>& F) {
  uint32_t t[13] = {0};
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const uint32_t bi = b.w[i];
    MADCC("mad.lo.cc.u32", t[0], a.w[0], bi, t[0]);
#pragma unroll
    for (int j = 1; j < 12; ++j) MADCC("madc.lo.cc.u32", t[j], a.w[j], bi, t[j]);
    t[12] = ptx::addc(0, 0);
    MADCC("mad.hi.cc.u32", t[1], a.w[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < 11; ++j) MADCC("madc.hi.cc.u32", t[j + 1], a.w[j], bi, t[j + 1]);
    MADCC("madc.hi.u32", t[12], a.w[11], bi, t[12]);
    const uint32_t m = t[0] * F.inv;
    MADCC("mad.lo.cc.u32", t[0], F.p[0], m, t[0]);
#pragma unroll
    for (int j = 1; j < 12; ++j) MADCC("madc.lo.cc.u32", t[j], F.p[j], m, t[j]);
    t[12] = ptx::addc(t[12], 0);
    MADCC("mad.hi.cc.u32", t[0], F.p[0], m, t[1]);
#pragma unroll
    for (int j = 1; j < 11; ++j) MADCC("madc.hi.cc.u32", t[j], F.p[j], m, t[j + 1]);
    MADCC("madc.hi.u32", t[11], F.p[11], m, t[12]);
    t[12] = 0;
  }
  return cond_sub_p_cc<12>(t, F);
}
__device__ Fe<12> fxor(const Fe<12>& x, const Fe<12>& y) {
  Fe<12> r;
#pragma unroll
  for (int j = 0; j < 12; ++j) r.w[j] = x.w[j] ^ y.w[j];
  return r;
}
#define PROBE(name, expr)                                                              \
  extern "C" __global__ void name(const Fe<12>* a, const Fe<12>* b, Fe<12>* o,        \
                                  FieldConsts<12> F) {                               \
    const int i = threadIdx.x;                                                        \
    const Fe<12> x = a[i], y = b[i];                                                  \
    o[i] = expr;                                                                      \
  }
PROBE(probe_none, fxor(x, y))
PROBE(probe_fmul, fmul<12>(x, y, F))
PROBE(probe_fmul_wide, fmul_wide<12>(x, y, F))
PROBE(probe_fmul_madcc, fmul_madcc(x, y, F))
PROBE(probe_fadd, fadd<12>(x, y, F))
PROBE(probe_fadd_cc, fadd_cc<12>(x, y, F))
PROBE(probe_fsub, fsub<12>(x, y, F))
PROBE(probe_fsub_cc, fsub_cc<12>(x, y, F))
extern "C" __global__ void probe_horner_serial(const Xyzz<12>* win, Xyzz<12>* out, int W, int c,
                                               FieldConsts<12> F) {
  Xyzz<12> st = win[W - 1];
  for (int wi = W - 2; wi >= 0; --wi) {
    for (int k = 0; k < c; ++k) st = xyzz_dbl<12>(st, F);
    st = xyzz_add<12>(RegPoint<12>{st}, RegPoint<12>{win[wi]}, F);
  }
  *out = st;
}
"""


# The latency of one dependent carried add on the card: one thread runs
# rounds of 32 add.cc/addc pairs, each instruction waiting on the one
# before, between two clock64() reads. mont_inv's chain bound counts its
# critical path in such instructions.
LATENCY_PROBE = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void add_chain(uint32_t* out, long long* cycles, int rounds, uint32_t seed) {
  uint32_t x = seed, y = seed ^ 0x9e3779b9u;
  const long long t0 = clock64();
  for (int i = 0; i < rounds; ++i) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
      asm volatile("add.cc.u32 %0, %0, %1;\n\taddc.u32 %1, %1, %0;" : "+r"(x), "+r"(y));
  }
  const long long t1 = clock64();
  out[0] = x ^ y;
  cycles[0] = t1 - t0;
}
extern "C" int zk_add_chain(void* out, void* cycles, int rounds, void* stream) {
  add_chain<<<1, 1, 0, (cudaStream_t)stream>>>((uint32_t*)out, (long long*)cycles, rounds, 12345u);
  return (int)cudaGetLastError();
}
"""
ADD_CHAIN_ROUNDS = 4096


def add_latency_cycles(torch, lib_path):
    """SM cycles per dependent carried add, from LATENCY_PROBE's library."""
    lib = ctypes.CDLL(str(lib_path))
    lib.zk_add_chain.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.zk_add_chain.restype = ctypes.c_int
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    best = None
    for _ in range(3):  # the first call also loads the module
        err = lib.zk_add_chain(out.data_ptr(), cycles.data_ptr(), ADD_CHAIN_ROUNDS,
                               torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"latency probe: CUDA launch failed ({err})")
        torch.cuda.synchronize()
        per = int(cycles.item()) / (ADD_CHAIN_ROUNDS * 64)
        best = per if best is None else min(best, per)
    return best


def cuobjdump():
    found = shutil.which("cuobjdump")
    if found:
        return found
    return str(os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump"))


def sass_functions(path):
    """{function: {"instructions": n, "imad": n, "opcodes": {op: n}}} from
    cuobjdump -sass (NOPs not counted)."""
    text = subprocess.run([cuobjdump(), "-sass", str(path)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and cur is not None and m.group(1) != "NOP":
            cur[m.group(1)] += 1
    return {k: dict(instructions=sum(v.values()),
                    imad=sum(n for op, n in v.items() if op.startswith("IMAD")),
                    opcodes=dict(v.most_common(10))) for k, v in out.items()}


# ---- 8. the field and G1 group path --------------------------------------------

def field_group_phase(torch, h, rec):
    """Phase 8: BN254 Fr element operations (config 1) and the BLS12-381 G1
    group path (config 2) at 2^GROUP_LOG_N, BN254 and BLS12-377 G1 at
    2^SMALL_LOG_N, each result against host known answers; every product
    kernel launch recorded by (kernel, field, shape, exponent) with its
    first inputs; then mont_mul, mont_sqr, mont_pow and mont_inv against
    their plain versions at the five moduli, on edge words and on those
    inputs. ``h`` carries main()'s helpers. Returns {kernel: its path
    launches, rows and error} for the kernels line."""
    from zkarray_torch import kernels
    from zkarray_torch.curves import bls12_377, bn254
    from zkarray_torch.curves import bls12_381 as B
    from zkarray_torch.curves import bls12_381_zcash as zc
    from zkarray_torch.ec import fast_checks
    from zkarray_torch.ec import sw as tsw
    from zkarray_torch.ff import fp
    from zkarray_torch.interop import affine_from_numpy, limbs_from_numpy
    from zkarray_torch.kernels import mont as km
    from zkarray_torch.testing import (ec_add, ec_mul, group_inputs, jac_edge_pairs,
                                       jacobian_coords, mont_inv_edge_words, mont_inv_ops,
                                       off_subgroup_points, scalar_of, sqrt_reference)

    dev, sync = h.dev, h.sync
    rng = np.random.default_rng(8)
    n = 1 << GROUP_LOG_N
    path = collections.Counter()  # product-kernel launches over the whole path
    products = ("mont_mul", "mont_sqr", "mont_pow", "mont_inv")

    def run(fn):
        """fn() once on the path, with the counts set to 0 just before and
        read just after: (result, host ms to the device's end, launches).
        Every launch is recorded in ``rec`` (the fp_add/fp_sub inputs are
        replayed in phase 9). Timing repeats and checks run off the path,
        unrecorded."""
        sync()
        kernels.reset_launches()
        rec.on = True
        try:
            out, ms = h.once_ms(fn)
        finally:
            rec.on = False
        got = {k: v for k, v in kernels.LAUNCHES.items() if v}
        path.update(got)
        return out, ms, got

    def sample(m, k):
        return torch.from_numpy(np.sort(rng.choice(m, min(k, m), replace=False))).to(dev)

    def affine_at(A, idx):
        return tsw.AffinePoints(A.x[:, idx], A.y[:, idx], A.inf[idx])

    def tiled(A, m):
        t = torch.arange(m, device=dev) % A.x.shape[1]
        return tsw.AffinePoints(A.x[:, t], A.y[:, t], A.inf[t])

    def same_tiles(what, P, k):
        """Lanes i and i + k of a batch tiled from k lanes hold equal words."""
        t = torch.arange(P[0].shape[-1], device=dev) % k
        if not all(torch.equal(v, v[..., t]) for v in P):
            raise AssertionError(f"{what}: tiled lanes differ")

    # -- config 1: BN254 Fr element operations at 2^GROUP_LOG_N ---------------
    f = bn254.FR
    p = f.modulus
    a, b = h.rand_field(f, n), h.rand_field(f, n)
    a[:, ::4099] = 0
    idx = sample(n, FIELD_KAT)
    av, bv = fp.to_ints(f, a[:, idx]), fp.to_ints(f, b[:, idx])
    leg_v = [0 if x == 0 else (1 if pow(x, (p - 1) // 2, p) == 1 else -1) for x in av]
    checks = {
        "mont_mul": (lambda: fp.mont_mul(f, a, b), lambda r: fp.to_ints(f, r[:, idx]) == [
            x * y % p for x, y in zip(av, bv)], 20),
        "mont_sqr": (lambda: fp.mont_sqr(f, a), lambda r: fp.to_ints(f, r[:, idx]) == [
            x * x % p for x in av], 20),
        "add": (lambda: fp.add(f, a, b), lambda r: fp.to_ints(f, r[:, idx]) == [
            (x + y) % p for x, y in zip(av, bv)], 20),
        "sub": (lambda: fp.sub(f, a, b), lambda r: fp.to_ints(f, r[:, idx]) == [
            (x - y) % p for x, y in zip(av, bv)], 20),
        "batch_inv": (lambda: fp.batch_inv(f, a), lambda r: fp.to_ints(f, r[:, idx]) == [
            pow(x, -1, p) if x else 0 for x in av], 3),
        "legendre": (lambda: fp.legendre(f, a), lambda r: r[idx].tolist() == leg_v, 3),
        "sqrt": (lambda: fp.sqrt(f, a), lambda r: r[1][idx].tolist() == [v >= 0 for v in leg_v]
                 and fp.to_ints(f, r[0][:, idx]) == [sqrt_reference(f, x) for x in av], 3),
    }
    field_rows = {}
    for name, (fn, ok, iters) in checks.items():
        r, wall_ms, got = run(fn)
        if not ok(r):
            raise AssertionError(f"bn254 Fr {name} at 2^{GROUP_LOG_N}: differs from Python ints")
        ms = h.time_ms(fn, iters)
        field_rows[name] = dict(ms=ms, first_call_ms=wall_ms, elements_per_s=n / ms * 1e3,
                                launches=got)
    h.emit("field_ops", field=f.name, n=n, known_answers=len(av), correct=True, ops=field_rows)
    sqrt_launches = field_rows["sqrt"]["launches"]
    del a, b

    # -- config 2: BLS12-381 G1 at 2^GROUP_LOG_N ----------------------------
    C = B.G1
    mod = C.base.modulus
    base, px, py, sc = group_inputs(C, n, rng)
    A = affine_from_numpy(px, py, np.zeros(n, dtype=bool), dev)
    s = limbs_from_numpy(sc, dev)
    J, sm_ms, sm_launches = run(lambda: tsw.scalar_mul(C, A, s))
    aff, aff_ms, aff_launches = run(lambda: tsw.to_affine(C, J))
    gidx = sample(n, GROUP_KAT)
    want = [ec_mul(base[i % len(base)], scalar_of(sc, i), C.a_int, mod) for i in gidx.tolist()]
    if tsw.affine_to_ints(C, affine_at(aff, gidx)) != want:
        raise AssertionError("scalar_mul 2^16: results differ from the host's ec_mul")
    _, trace = device_trace(torch, lambda: tsw.scalar_mul(C, A, s), sm_ms)
    # its bound: the products alone (the additions' operations are
    # fewer), the points and scalars read once, the Jacobian result written
    n_prod = sm_launches.get("mont_mul", 0) + sm_launches.get("mont_sqr", 0)
    L, Ls = C.base.num_limbs, C.scalar.num_limbs
    ops = n * (sm_launches.get("mont_mul", 0) * h.mul_ops(C.base)
               + sm_launches.get("mont_sqr", 0) * h.sqr_ops(C.base))
    b_ms, b_by = h.bound((5 * L + Ls) * n * 4, ops)
    h.emit("scalar_mul", curve=C.name, n=n, scalar_bits=16 * Ls,
           known_answers=len(want), correct=True, ms=sm_ms, to_affine_ms=aff_ms,
           bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / sm_ms,
           scalar_muls_per_s=n / (sm_ms + aff_ms) * 1e3, launches=sm_launches,
           to_affine_launches=aff_launches, product_launches_per_bit=n_prod / (16 * C.scalar.num_limbs),
           trace=trace)
    del J, aff, A, s

    # the Jacobian edge classes, tiled: generic, P == Q, P == -Q, P, Q or
    # both at infinity, with random Z
    ps, qs = jac_edge_pairs(C, 64, rng)
    lams = [int.from_bytes(rng.bytes(48), "little") % (mod - 1) + 1 for _ in range(128)]

    def jac(pts, ls):
        cs = [jacobian_coords(q, lam, mod) for q, lam in zip(pts, ls)]
        return tsw.JacobianPoints(*(fp.from_ints(C.base, [c[k] for c in cs], device=dev)
                                    for k in range(3)))

    t64 = torch.arange(n, device=dev) % 64
    P64, Q64 = jac(ps, lams[:64]), jac(qs, lams[64:])
    P = tsw.JacobianPoints(*(v[:, t64] for v in P64))
    Q = tsw.JacobianPoints(*(v[:, t64] for v in Q64))
    Aq = tiled(tsw.affine_from_ints(C, qs, dev), n)
    edge_rows = {}
    for name, fn, want in (
        ("jac_add", lambda: tsw.jac_add(C, P, Q), [ec_add(u, v, 0, mod) for u, v in zip(ps, qs)]),
        ("jac_add_mixed", lambda: tsw.jac_add_mixed(C, P, Aq),
         [ec_add(u, v, 0, mod) for u, v in zip(ps, qs)]),
        ("jac_double", lambda: tsw.jac_double(C, P), [ec_add(u, u, 0, mod) for u in ps]),
    ):
        R, wall_ms, got = run(fn)
        same_tiles(name, R, 64)
        head = tsw.JacobianPoints(*(v[:, :64] for v in R))
        if tsw.affine_to_ints(C, tsw.to_affine(C, head)) != want:
            raise AssertionError(f"{name} on the edge classes: differs from the host oracle")
        edge_rows[name] = dict(ms=h.time_ms(fn, 3), first_call_ms=wall_ms, launches=got)
    h.emit("jacobian_edges", curve=C.name, n=n, classes=6, correct=True, ops=edge_rows)
    del P, Q, Aq

    # cofactor clearing and both subgroup checks: lanes by i % 8: 0-2 the
    # scalar_mul's base points (in), 3-5 points outside the subgroup
    # (never multiplied by the cofactor), 6 those points cleared (in),
    # 7 infinity (in)
    off = off_subgroup_points(C, OFF_POOL, rng)
    Aoff = tiled(tsw.affine_from_ints(C, off, dev), n)
    Jc, cc_ms, cc_launches = run(lambda: tsw.clear_cofactor(C, Aoff))
    cleared = tsw.to_affine(C, Jc)
    same_tiles("clear_cofactor", cleared, OFF_POOL)
    if tsw.affine_to_ints(C, affine_at(cleared, torch.arange(OFF_POOL, device=dev))) != [
            ec_mul(q, C.cofactor, 0, mod) for q in off]:
        raise AssertionError("clear_cofactor: differs from the host's ec_mul")
    cls = torch.arange(n, device=dev) % 8
    outside, was_cleared = (cls >= 3) & (cls <= 5), cls == 6

    def pick(u, v, w):  # base, outside, cleared
        lead = (None,) * (u.dim() - 1)
        return torch.where(outside[lead], v, torch.where(was_cleared[lead], w, u))

    mix = tsw.AffinePoints(*(pick(u, v, w) for u, v, w in zip(
        tiled(tsw.affine_from_ints(C, base, dev), n), Aoff, cleared)))
    mix = mix._replace(inf=mix.inf | (cls == 7))
    expect = ~outside
    checks = {}
    for name, fn in (("subgroup_check", lambda: tsw.subgroup_check(C, mix)),
                     ("bls12_381_g1_subgroup_check",
                      lambda: fast_checks.bls12_381_g1_subgroup_check(C, mix))):
        ok, ms, got = run(fn)
        if not torch.equal(ok, expect):
            raise AssertionError(f"{name}: {int((ok != expect).sum())} lanes wrong")
        checks[name] = dict(ms=ms, checks_per_s=n / ms * 1e3, launches=got)
    h.emit("subgroup", curve=C.name, n=n, off_subgroup_pool=OFF_POOL, correct=True,
           clear_cofactor=dict(ms=cc_ms, launches=cc_launches), checks=checks)
    del Jc, cleared, mix

    # the zcash G1 vectors tiled to 2^GROUP_LOG_N, then OFF_POOL encodings
    # of points outside the subgroup: deserialized with validate=True
    # (the fast check), serialized back
    vec_pts = [None]
    for _ in range(ZCASH_VECTORS - 1):
        vec_pts.append(ec_add(vec_pts[-1], (C.gen_x, C.gen_y), 0, mod))
    vidx = sample(n, GROUP_KAT)
    zrows = {}
    Aoff_small = tsw.affine_from_ints(C, off, dev)
    for compress in (True, False):
        width = 48 if compress else 96
        kind = "compressed" if compress else "uncompressed"
        vec = np.fromfile(os.path.join(REPO, "tests", "vectors",
                                       f"g1_{kind}_valid_test_vectors.dat"), dtype=np.uint8)
        vec = vec.reshape(ZCASH_VECTORS, width)[np.arange(n) % ZCASH_VECTORS]
        data = np.concatenate([vec, zc.serialize_g1(Aoff_small, compress)])
        (pts, ok), ms, got = run(lambda: zc.deserialize_g1(
            data, compress=compress, validate=True, device=dev))
        if not ok[:n].all() or ok[n:].any():
            raise AssertionError(f"zcash {kind}: {int((~ok[:n]).sum())} vectors rejected, "
                                 f"{int(ok[n:].sum())} points outside the subgroup accepted")
        back, ser_ms = h.once_ms(lambda: zc.serialize_g1(
            tsw.AffinePoints(pts.x[:, :n], pts.y[:, :n], pts.inf[:n]), compress))
        if not np.array_equal(back, vec):
            raise AssertionError(f"zcash {kind}: re-serialized bytes differ")
        if tsw.affine_to_ints(C, affine_at(pts, vidx)) != [
                vec_pts[i % ZCASH_VECTORS] for i in vidx.tolist()]:
            raise AssertionError(f"zcash {kind}: points differ from k G")
        zrows[kind] = dict(ms=ms, deserializations_per_s=data.shape[0] / ms * 1e3,
                           serialize_ms=ser_ms, launches=got)
    h.emit("zcash", n=n, off_subgroup_rejected=OFF_POOL, byte_exact=True, correct=True, **zrows)
    del pts, back

    # BN254 and BLS12-377 G1 at 2^SMALL_LOG_N: scalar_mul and the generic check
    m = 1 << SMALL_LOG_N
    small = {}
    for Cs in (bn254.G1, bls12_377.G1):
        mods = Cs.base.modulus
        base_s, px, py, sc = group_inputs(Cs, m, rng)
        As = affine_from_numpy(px, py, np.zeros(m, dtype=bool), dev)
        ss = limbs_from_numpy(sc, dev)
        Js, ms, got = run(lambda: tsw.scalar_mul(Cs, As, ss))
        gi = sample(m, GROUP_KAT)
        if tsw.affine_to_ints(Cs, affine_at(tsw.to_affine(Cs, Js), gi)) != [
                ec_mul(base_s[i % len(base_s)], scalar_of(sc, i), Cs.a_int, mods)
                for i in gi.tolist()]:
            raise AssertionError(f"{Cs.name} scalar_mul: differs from the host's ec_mul")
        # lanes by i % 4: 0-1 base points, 2 outside the subgroup (when the
        # cofactor allows any), 3 infinity
        cl = torch.arange(m, device=dev) % 4
        Am = tiled(tsw.affine_from_ints(Cs, base_s, dev), m)
        if Cs.cofactor > 1:
            Ao = tiled(tsw.affine_from_ints(Cs, off_subgroup_points(Cs, OFF_POOL, rng), dev), m)
            Am = tsw.AffinePoints(torch.where((cl == 2)[None], Ao.x, Am.x),
                                  torch.where((cl == 2)[None], Ao.y, Am.y), Am.inf)
        Am = tsw.AffinePoints(Am.x, Am.y, Am.inf | (cl == 3))
        expect = ~(cl == 2) if Cs.cofactor > 1 else torch.ones(m, dtype=torch.bool, device=dev)
        ok, ms_c, got_c = run(lambda: tsw.subgroup_check(Cs, Am))
        if not torch.equal(ok, expect):
            raise AssertionError(f"{Cs.name} subgroup_check: {int((ok != expect).sum())} lanes wrong")
        small[Cs.name] = dict(scalar_mul_ms=ms, scalar_muls_per_s=m / ms * 1e3,
                              scalar_mul_launches=got, subgroup_check_ms=ms_c,
                              subgroup_check_launches=got_c)
    h.emit("small_curves", n=m, correct=True, curves=small)
    path_launches = dict(path)
    keys = {k: v for k, v in rec.keys.items() if k[0] in products}
    h.emit("group_path_launches", launches=path_launches, recorded_keys=len(keys),
           per_scalar_mul=sm_launches, per_sqrt=sqrt_launches)
    for name in products:
        recorded = sum(v for k, v in keys.items() if k[0] == name)
        if recorded != path.get(name, 0) or recorded == 0:
            raise AssertionError(f"group path: {name} {recorded} launches recorded, "
                                 f"{path.get(name, 0)} counted")

    # -- kernel vs plain at the five moduli -------------------------------------
    plain = {"mont_mul": lambda spec, ins, e: km.mont_mul_plain(spec, *ins),
             "mont_sqr": lambda spec, ins, e: km.mont_sqr_plain(spec, *ins),
             "mont_pow": lambda spec, ins, e: km.mont_pow_plain(spec, ins[0], e),
             "mont_inv": lambda spec, ins, e: km.mont_inv_plain(spec, ins[0])}
    kern = {"mont_mul": lambda spec, ins, e: km.mont_mul(spec, *ins),
            "mont_sqr": lambda spec, ins, e: km.mont_sqr(spec, *ins),
            "mont_pow": lambda spec, ins, e: km.mont_pow(spec, ins[0], e),
            "mont_inv": lambda spec, ins, e: km.mont_inv(spec, ins[0])}
    err = collections.defaultdict(int)
    edge_fields = {}
    for f in (bn254.FR, bn254.FQ, B.FR, B.FQ, bls12_377.FQ):
        p = f.modulus
        words = mont_inv_edge_words(f, np.random.default_rng(9), n_random=8)
        xe = fp.from_ints(f, words, mont=False, device=dev)
        k = len(words)
        ii = torch.arange(k * k, device=dev)
        pair = (xe[:, ii // k], xe[:, ii % k])
        exps = [0, 1, 2, 3, p - 2, (p - 1) // 2, f.trace, 1 << max(f.two_adicity - 1, 0)]
        if f.sqrt_mode != "tonelli":
            exps.append(f.sqrt_exp)
        cases = [("mont_mul", pair, None), ("mont_sqr", (xe,), None), ("mont_inv", (xe,), None)]
        cases += [("mont_pow", (xe,), e) for e in exps]
        for name, ins, e in cases:
            err[name] = max(err[name], h.check_equal(f"{name} {f.name} edge words (e = {e})",
                                                     kern[name](f, ins, e), plain[name](f, ins, e)))
        if fp.to_ints(f, km.mont_inv(f, xe), mont=False) != [
                pow(w * pow(f.r_int, -1, p), -1, p) * f.r_int % p if w else 0 for w in words]:
            raise AssertionError(f"mont_inv {f.name}: edge words differ from Python's pow")
        edge_fields[f.name] = dict(words=k, pairs=k * k, exponents=len(exps), nw=f.num_limbs // 2)
    rows = collections.defaultdict(list)
    for (name, fname, shape, e), count in sorted(keys.items(), key=lambda kv: -math.prod(kv[0][2])):
        spec, ins, _ = rec.first.pop((name, fname, shape, e))
        del rec.keys[(name, fname, shape, e)]  # phase 9 replays its own products
        got = kern[name](spec, ins, e)
        want, plain_ms = h.once_ms(lambda: plain[name](spec, ins, e))
        e_row = h.check_equal(f"{name} {fname} {shape} (e = {e})", got, want)
        err[name] = max(err[name], e_row)
        rows[name].append(dict(field=fname, nw=spec.num_limbs // 2, shape=list(shape),
                               exponent_bits=None if e is None else e.bit_length(),
                               launches=count, max_abs_err=e_row, plain_ms=plain_ms, ins=ins, e=e,
                               spec=spec))
    # times and bounds: mont_mul and mont_sqr at every recorded shape of
    # 2^GROUP_LOG_N elements (NW = 8: BN254 Fr; NW = 12: BLS12-381 Fq),
    # mont_pow at its widest recorded launch per field, mont_inv at its
    # recorded launches
    report = {}
    for name, rs in rows.items():
        timed = []
        for r in rs:
            spec, ins, e = r.pop("spec"), r.pop("ins"), r.pop("e")
            m_el = math.prod(r["shape"][1:])
            L = spec.num_limbs
            if name in ("mont_mul", "mont_sqr"):
                if m_el != n:
                    continue
                ops = m_el * (h.sqr_ops if name == "mont_sqr" else h.mul_ops)(spec)
                nbytes = (len(ins) + 1) * L * m_el * 4
            elif name == "mont_pow":
                if any(t["field"] == r["field"] for t in timed):
                    continue  # the widest launch of each field only
                nprod = e.bit_length() - 1 + bin(e).count("1") if e else 0
                ops, nbytes = m_el * h.pow_ops(spec, e), 2 * L * m_el * 4
                r["products"] = nprod
            else:  # the batched GCD's fixed work an element (testing.mont_inv_ops)
                ops = m_el * mont_inv_ops(spec)
                nbytes = 2 * L * m_el * 4
            r["ms"] = h.time_ms(lambda: kern[name](spec, ins, e), 20 if m_el <= n else 3)
            b_ms, b_by = h.bound(nbytes, ops)
            r.update(bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / r["ms"])
            timed.append(r)
        h.emit("kernel_group_path_shapes", kernel=name, rows=rs)
        report[name] = dict(max_abs_err=err[name], launches=path.get(name, 0), rows=timed,
                            edge_words=edge_fields)
    return report


# ---- 9. the pairing path -----------------------------------------------------

def replica(torch, t, copy=True):
    """A tensor with ``t``'s shape and strides over a buffer of its own: the
    span of storage t reads, cloned (or left empty). clone() alone would make
    a slice or a stride-0 broadcast contiguous."""
    span = 1 + sum((s - 1) * st for s, st in zip(t.shape, t.stride()) if s > 0)
    flat = (torch.as_strided(t, (span,), (1,), t.storage_offset()).clone() if copy
            else torch.empty(span, dtype=t.dtype, device=t.device))
    return torch.as_strided(flat, tuple(t.shape), tuple(t.stride()))


def install_recorders(torch, km):
    """Wrap kernels.mont's launchers and kernels.lin's so that, while
    ``rec.on``, every launch of fp_add/fp_sub is counted by (kernel, field,
    shape, the strides of a, b and the output), every product launch by
    (kernel, field, shape, exponent) and every fp_lin launch by (field,
    output shape, map, the used sources' shapes and strides, the output's
    strides), each key's first inputs kept with their strides. Phases 8 to
    11 read and replay them (fp_lin's rows gather in ``rec.lin_rows`` for
    phase 12; ``rec.path_launches`` takes each path's launches per call).
    Returns (rec, restore)."""
    from zkarray_torch.kernels import lin

    rec = types.SimpleNamespace(on=False, keys=collections.Counter(), first={}, lin_rows=[],
                                path_launches={})
    addsub, launch, lin_launch = km._launch_addsub, km._launch, lin._launch_lin

    def rec_addsub(kernel, spec, a, b, out):
        if rec.on:
            key = (kernel, spec.name, tuple(a.shape), tuple(a.stride()), tuple(b.stride()),
                   None if out is None else tuple(out.stride()))
            rec.keys[key] += 1
            if key not in rec.first:
                rec.first[key] = (spec, (replica(torch, a), replica(torch, b)),
                                  None if out is None else replica(torch, out, copy=False))
        return addsub(kernel, spec, a, b, out)

    def rec_launch(kernel, spec, *ins, exponent=None):
        if rec.on:
            key = (kernel, spec.name, tuple(ins[0].shape), exponent)
            rec.keys[key] += 1
            if key not in rec.first:
                rec.first[key] = (spec, tuple(replica(torch, t) for t in ins), None)
        return launch(kernel, spec, *ins, exponent=exponent)

    def rec_lin(spec, lmap, srcs, out):
        if rec.on:
            used = [srcs[s] for s in lmap.used]
            key = ("fp_lin", spec.name, (lmap.m, spec.num_limbs) + lin.common_batch(used), lmap,
                   tuple((tuple(t.shape), tuple(t.stride())) for t in used),
                   None if out is None else tuple(out.stride()))
            rec.keys[key] += 1
            if key not in rec.first:
                ins = tuple(replica(torch, t) if s in lmap.used else None for s, t in enumerate(srcs))
                rec.first[key] = (spec, ins, None if out is None else replica(torch, out, copy=False))
        return lin_launch(spec, lmap, srcs, out)

    km._launch_addsub, km._launch, lin._launch_lin = rec_addsub, rec_launch, rec_lin

    def restore():
        km._launch_addsub, km._launch, lin._launch_lin = addsub, launch, lin_launch

    return rec, restore


def lin_bytes(row_map, ins, n_out, L, h):
    """fp_lin's bytes: each slot the map reads, once per distinct batch
    element of its source (a stride-0 constant is read once), and each
    output row written once per element."""
    reads = sum(len({k for r in row_map.rows for s_, k, _ in r if s_ == s})
                * h.distinct_elems(ins[s][0]) for s in row_map.used)
    return L * 4 * (reads + row_map.m * n_out)


def lin_ops(lmap, L):
    """fp_lin's 32-bit operations per element: per term L multiply-adds (and
    L complements for a negative one), per row the carry pass (3 L) and
    kbits conditional subtractions of NW + 1 words (4 each)."""
    return sum(L * sum(2 if c < 0 else 1 for _, _, c in r) + 3 * L + 4 * (L // 2 + 1) * kb
               for r, kb in zip(lmap.rows, lmap.kbits))


def replay_lin(h, rec, key, count, spec, ins, out, path_keys, err):
    """One recorded fp_lin key launched again and held against
    fp_lin_plain (raises on a difference), its row appended to
    ``rec.lin_rows``; the inputs are kept for the widest row of each field
    width and for the rows of BLS12-381's pairing_each (the kernels line's
    path) only: phase 12 times those."""
    from zkarray_torch.kernels import lin

    lmap = key[3]
    got = lin._launch_lin(spec, lmap, list(ins), out)
    want, plain_ms = h.once_ms(lambda: lin.fp_lin_plain(spec, lmap, list(ins)))
    e_row = h.check_equal(f"fp_lin {key[1]} {lmap.name} {key[2]}", got, want)
    err["fp_lin"] = max(err["fp_lin"], e_row)
    L = spec.num_limbs
    n_out = math.prod(key[2][2:])
    row = dict(field=key[1], map=lmap.name, shape=list(key[2]), sources=[list(x) for x in key[4]],
               out_strides=key[5], launches=count,
               paths=[c for c, ks_ in path_keys.items() if key in ks_], max_abs_err=e_row,
               plain_ms=plain_ms, bytes=lin_bytes(lmap, ins, n_out, L, h),
               ops=n_out * lin_ops(lmap, L), _spec=spec, _map=lmap, _ins=ins, _out=out)
    widest = next((r for r in rec.lin_rows if r["_widest"] and r["_spec"].num_limbs == L), None)
    row["_widest"] = widest is None or row["bytes"] > widest["bytes"]
    narrower = widest if row["_widest"] else row
    if narrower is not None:
        narrower["_widest"] = False
        if "bls12_381" not in narrower["paths"]:
            narrower["_ins"] = narrower["_out"] = None
    rec.lin_rows.append(row)


MSM_KERNELS = ("xyzz_accum", "horner_windows", "xyzz_bit_horner", "xyzz_add", "xyzz_double",
               "xyzz_tree_sum")


def install_msm_recorders(torch, rec):
    """Wrap kernels.sw's MSM launchers (both accumulation wrappers, the
    window Horner, the bit-Horner, the element-wise XYZZ kernels and the
    tree sum) so that, while ``rec.on``, every launch's inputs are kept in
    ``rec.msm`` as (kernel, inputs with their strides, extra). Returns
    restore()."""
    from zkarray_torch.kernels import sw as ksw

    rec.msm = []
    names = ("xyzz_accum_grid", "xyzz_accum_tiles", "horner_windows", "xyzz_bit_horner",
             "_launch_xyzz", "xyzz_tree_sum")
    orig = {n: getattr(ksw, n) for n in names}

    def keep(kernel, ins, extra=None):
        if rec.on:
            rec.msm.append((kernel, tuple(replica(torch, t) for t in ins), extra))

    def grid(curve, state, coords, valid):
        keep("xyzz_accum", (state, coords, valid), "grid")
        return orig["xyzz_accum_grid"](curve, state, coords, valid)

    def tiles(curve, state, coords, valid):
        keep("xyzz_accum", (state, coords, valid), "tiles")
        return orig["xyzz_accum_tiles"](curve, state, coords, valid)

    def horner(curve, win, c):
        keep("horner_windows", (win,), c)
        return orig["horner_windows"](curve, win, c)

    def bit_horner(curve, parts):
        keep("xyzz_bit_horner", tuple(parts))
        return orig["xyzz_bit_horner"](curve, parts)

    def launch_xyzz(kernel, curve, *coords):
        keep(kernel, coords)
        return orig["_launch_xyzz"](kernel, curve, *coords)

    def tree(curve, P):
        keep("xyzz_tree_sum", tuple(P))
        return orig["xyzz_tree_sum"](curve, P)

    for n, fn in zip(names, (grid, tiles, horner, bit_horner, launch_xyzz, tree)):
        setattr(ksw, n, fn)

    def restore():
        for n, fn in orig.items():
            setattr(ksw, n, fn)
        rec.msm = []

    return restore


def replay_msm_launches(h, curve, calls):
    """Every recorded MSM-kernel launch (install_msm_recorders) launched
    again on its own inputs and held against its plain version, bit for
    bit (raises on a difference). Returns one row per launch: kernel,
    route, shape, operand strides, error, kernel and plain wall ms."""
    from zkarray_torch.kernels import mont as km
    from zkarray_torch.kernels import sw as ksw

    def run(kernel, ins, extra, plain):
        if kernel == "xyzz_accum":
            return (ksw.xyzz_accum_plain if plain else
                    ksw.xyzz_accum_grid if extra == "grid" else ksw.xyzz_accum_tiles)(curve, *ins)
        if kernel == "horner_windows":
            return (ksw.horner_windows_plain if plain else ksw.horner_windows)(curve, ins[0], extra)
        if kernel == "xyzz_bit_horner":
            return (ksw.xyzz_bit_horner_plain if plain else ksw.xyzz_bit_horner)(curve, ins)
        if kernel == "xyzz_tree_sum":
            return (ksw.xyzz_tree_sum_plain if plain else ksw.xyzz_tree_sum)(curve, ins)
        if plain:
            return (ksw._fadd_plain(curve, ins[:4], ins[4:]) if kernel == "xyzz_add" else
                    ksw._dbl_plain(curve, ins))
        return ksw._launch_xyzz(kernel, curve, *ins)

    rows = []
    for kernel, ins, extra in calls:
        got, ms = h.once_ms(lambda: run(kernel, ins, extra, False))
        want, plain_ms = h.once_ms(lambda: run(kernel, ins, extra, True))
        if not isinstance(got, tuple):  # xyzz_accum and horner_windows: one tensor
            got, want = (got,), (want,)
        err = max(h.check_equal(f"{kernel} on msm_mixed's input {len(rows)}, output {i}", g, w_)
                  for i, (g, w_) in enumerate(zip(got, want)))
        rows.append(dict(kernel=kernel, route=extra if kernel == "xyzz_accum" else None,
                         c=extra if kernel == "horner_windows" else None,
                         shape=list(ins[1 if kernel == "xyzz_accum" else 0].shape),  # accum: coords
                         operand_maps=[list(km._operand(t)[1:]) for t in ins]
                         if kernel in ("xyzz_add", "xyzz_double", "xyzz_tree_sum") else None,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms))
    return rows


def words_hex(t):
    """The first batch element of a limb tensor as one hex int."""
    col = t.reshape(t.shape[0], -1)[:, 0].tolist()
    return hex(sum((v & 0xFFFF) << (16 * k) for k, v in enumerate(col)))


def pairing_phase(torch, h, rec):
    """Phase 9: the BLS12-381 pairing path (BASELINE config 5) and
    BLS12-377's, the G2 encodings and the G2 subgroup check, each against
    host known answers; then fp_add and fp_sub against their plain versions
    at five moduli on edge words and on every input recorded on phases 8
    and 9 (``rec``), and the product kernels on phase 9's recorded inputs.
    Returns the kernels line's rows for fp_add and fp_sub and the product
    kernels' pairing-path figures."""
    from zkarray_torch import kernels
    from zkarray_torch.curves import bls12_377, bn254
    from zkarray_torch.curves import bls12_381 as B
    from zkarray_torch.core.limbs import ints_to_limbs_np
    from zkarray_torch.curves import bls12_381_zcash as zc
    from zkarray_torch.ec import fast_checks
    from zkarray_torch.ec import sw_ext
    from zkarray_torch.ec.pairing import bls12
    from zkarray_torch.kernels import mont as km
    from zkarray_torch.testing import (E_BLS12_377, E_BLS12_381, ext_ec_add, fadd_edge_words,
                                       g2_affine_from_ints, g2_affine_to_ints,
                                       g2_off_subgroup_points, pairing_inputs)

    dev, sync = h.dev, h.sync
    rng = np.random.default_rng(9)
    n = 1 << PAIR_LOG_N

    def run(fn, record=True):
        """fn() once with the counts set to 0 just before and read just
        after: (result, host ms to the device's end, launches)."""
        sync()
        kernels.reset_launches()
        rec.on = record
        try:
            out, ms = h.once_ms(fn)
        finally:
            rec.on = False
        return out, ms, {k: v for k, v in kernels.LAUNCHES.items() if v}

    def expected(bspec, e_flat, ab, inf, m):
        """Per-lane host known answers E^(a_j b_j) (1 on the infinity lanes)
        as an Fp12 tensor of m lanes, and the combined E^(sum)."""
        return expected_gt(torch, bspec.fq12, bspec.g1.scalar.modulus, e_flat, ab, m,
                           PAIR_INF_EVERY, dev)

    # -- BLS12-381 pairing_each at 2^PAIR_LOG_N --------------------------------------
    spec = B.PAIRING
    t0 = time.perf_counter()
    P, Q, ab, inf = pairing_inputs(spec, n, rng, PAIR_BASE, PAIR_INF_EVERY, device=dev)
    want, want_comb = expected(spec, E_BLS12_381, ab, inf, n)
    host_s = time.perf_counter() - t0
    each = lambda: bls12.pairing_each(spec, P, Q)  # noqa: E731
    seen = collections.Counter(rec.keys)
    got, first_ms, per_pairing = run(each)
    path_keys = {k for k, v in rec.keys.items() if v > seen.get(k, 0)}  # this run's launches
    if not torch.equal(got, want):
        raise AssertionError(f"pairing_each 2^{PAIR_LOG_N}: lanes differ from E^(ab)")
    walls = []
    for _ in range(PAIR_TIMED_RUNS):
        got, ms, _ = run(each, record=False)
        walls.append(ms)
        if not torch.equal(got, want):
            raise AssertionError("pairing_each: a timed run differs")
    med = sorted(walls)[len(walls) // 2]
    got, trace = device_trace(torch, each, med)
    if not torch.equal(got, want):
        raise AssertionError("pairing_each: the traced run differs")
    h.emit("pairing_each", curve=spec.name, pairs=n, infinity_lanes=int(inf.sum()),
           known_answer_pairs=len(ab), correct=True, ms=med, ms_runs=walls, first_call_ms=first_ms,
           pairings_per_s=n / med * 1e3, launches_per_pairing_call=per_pairing,
           launches_per_pair=sum(per_pairing.values()) / n, host_known_answer_s=host_s, trace=trace)
    del got

    # -- pairing (combined over the pairs) ------------------------------------------
    comb = lambda: bls12.pairing(spec, P, Q)  # noqa: E731
    got, comb_first_ms, comb_launches = run(comb)
    if not torch.equal(got, want_comb):
        raise AssertionError("pairing (combined): differs from E^(sum a b)")
    got, comb_ms, _ = run(comb, record=False)
    if not torch.equal(got, want_comb):
        raise AssertionError("pairing (combined): the timed run differs")
    h.emit("pairing", curve=spec.name, pairs=n, correct=True, ms=comb_ms, first_call_ms=comb_first_ms,
           pairs_per_s=n / comb_ms * 1e3, launches=comb_launches)

    # -- BLS12-377 pairing_each at 2^PAIR_LOG_N (D-twist) ---------------------------
    s377 = bls12_377.PAIRING
    P7, Q7, ab7, inf7 = pairing_inputs(s377, n, rng, PAIR_BASE, PAIR_INF_EVERY, device=dev)
    want7, _ = expected(s377, E_BLS12_377, ab7, inf7, n)
    got7, ms7, launches7 = run(lambda: bls12.pairing_each(s377, P7, Q7))
    if not torch.equal(got7, want7):
        raise AssertionError(f"bls12_377 pairing_each 2^{PAIR_LOG_N}: lanes differ from E^(ab)")
    h.emit("pairing_each_bls12_377", curve=s377.name, pairs=n, correct=True, ms=ms7,
           pairings_per_s=n / ms7 * 1e3, launches=launches7)
    rec.path_launches.update(bls12_381=per_pairing, bls12_377=launches7)
    del P7, Q7, got7, want7

    # -- one pairing_each at 2^PAIR_BIG_LOG_N: its peak memory -------------------
    m = 1 << PAIR_BIG_LOG_N
    t = torch.arange(m, device=dev) % n
    Pb = P._replace(x=P.x[:, t], y=P.y[:, t], inf=P.inf[t])
    Qb = Q._replace(x=Q.x[..., t], y=Q.y[..., t], inf=Q.inf[t])
    sync()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gotb, big_ms, big_launches = run(lambda: bls12.pairing_each(spec, Pb, Qb), record=False)
    peak = torch.cuda.max_memory_allocated() - base_mem
    if not torch.equal(gotb, want[..., t]):
        raise AssertionError(f"pairing_each 2^{PAIR_BIG_LOG_N}: lanes differ from E^(ab)")
    h.emit("pairing_each_big", curve=spec.name, pairs=m, correct=True, ms=big_ms,
           pairings_per_s=m / big_ms * 1e3, peak_bytes_above_inputs=peak, launches=big_launches)
    del Pb, Qb, gotb, want, P, Q

    # -- G2: zcash vectors at 2^G2_LOG_N, the subgroup check ----------------------
    C2 = B.G2
    F2h = C2.ops.host
    g = G2_LOG_N
    m2 = 1 << g
    vec_pts, cur = [None], None
    for _ in range(ZCASH_VECTORS - 1):
        cur = ext_ec_add(F2h, cur, (C2.gen_x, C2.gen_y))
        vec_pts.append(cur)
    off = g2_off_subgroup_points(C2, OFF_POOL, rng)
    Aoff = g2_affine_from_ints(C2, off, dev)
    vidx = np.sort(rng.choice(m2, GROUP_KAT, replace=False))
    zrows = {}
    for compress in (True, False):
        width = 96 if compress else 192
        kind = "compressed" if compress else "uncompressed"
        vec = np.fromfile(os.path.join(REPO, "tests", "vectors", f"g2_{kind}_valid_test_vectors.dat"),
                          dtype=np.uint8).reshape(ZCASH_VECTORS, width)[np.arange(m2) % ZCASH_VECTORS]
        data = np.concatenate([vec, zc.serialize_g2(Aoff, compress)])
        (pts, ok), ms, got_l = run(lambda: zc.deserialize_g2(data, compress=compress, validate=True,
                                                              device=dev))
        if not ok[:m2].all() or ok[m2:].any():
            raise AssertionError(f"zcash G2 {kind}: {int((~ok[:m2]).sum())} vectors rejected, "
                                 f"{int(ok[m2:].sum())} points outside G2 accepted")
        head = sw_ext.ExtAffine(pts.x[..., :m2], pts.y[..., :m2], pts.inf[:m2])
        back, ser_ms = h.once_ms(lambda: zc.serialize_g2(head, compress))
        if not np.array_equal(back, vec):
            raise AssertionError(f"zcash G2 {kind}: re-serialized bytes differ")
        vi = torch.from_numpy(vidx).to(dev)
        if g2_affine_to_ints(C2, sw_ext.ExtAffine(head.x[..., vi], head.y[..., vi], head.inf[vi])) != [
                vec_pts[i % ZCASH_VECTORS] for i in vidx.tolist()]:
            raise AssertionError(f"zcash G2 {kind}: points differ from k H")
        zrows[kind] = dict(ms=ms, deserializations_per_s=data.shape[0] / ms * 1e3,
                           serialize_ms=ser_ms, launches=got_l)
    h.emit("zcash_g2", n=m2, off_subgroup_rejected=OFF_POOL, byte_exact=True, correct=True, **zrows)

    # lanes by i % 8: 0-4 the vectors' points (in G2), 5-6 outside G2, 7 infinity
    cls = torch.arange(m2, device=dev) % 8
    Ao = sw_ext.ExtAffine(Aoff.x[..., cls % OFF_POOL], Aoff.y[..., cls % OFF_POOL],
                          torch.zeros(m2, dtype=torch.bool, device=dev))
    outside = (cls == 5) | (cls == 6)
    mix = sw_ext.ExtAffine(torch.where(outside, Ao.x, head.x), torch.where(outside, Ao.y, head.y),
                           head.inf | (cls == 7))
    okm, sg_ms, sg_launches = run(lambda: fast_checks.bls12_381_g2_subgroup_check(C2, mix))
    if not torch.equal(okm, ~outside):
        raise AssertionError(f"G2 subgroup check: {int((okm != ~outside).sum())} lanes wrong")
    h.emit("g2_subgroup", n=m2, correct=True, ms=sg_ms, checks_per_s=m2 / sg_ms * 1e3,
           launches=sg_launches)
    del pts, head, mix, back

    # -- fp_add and fp_sub against their plain versions ----------------------------
    fields = (bn254.FR, bn254.FQ, B.FR, B.FQ, bls12_377.FQ)
    plain = {"fp_add": km.add_plain, "fp_sub": km.sub_plain}
    err = collections.defaultdict(int)
    edge = {}
    for f in fields:
        words = fadd_edge_words(f, np.random.default_rng(10))
        x = torch.from_numpy(ints_to_limbs_np(words, f.num_limbs).astype(np.int32)).to(dev)
        k = len(words)
        ii = torch.arange(k * k, device=dev)
        a, b = x[:, ii // k], x[:, ii % k]
        for name, kern, pl in (("fp_add", km.fp_add, km.add_plain), ("fp_sub", km.fp_sub, km.sub_plain),
                               ("fp_sub", km.fp_neg, lambda f, v: km.sub_plain(f, torch.zeros_like(v), v))):
            args = (a, b) if kern is not km.fp_neg else (x,)
            err[name] = max(err[name], h.check_equal(f"{kern.__name__} {f.name} edge words",
                                                     kern(f, *args), pl(f, *args)))
        edge[f.name] = dict(words=k, pairs=k * k, first_words=[hex(w) for w in words[:4]])
    recorded = collections.defaultdict(list)
    prods = collections.defaultdict(list)
    for key, count in sorted(rec.keys.items(), key=lambda kv: -math.prod(kv[0][2])):
        spec_k, ins, out = rec.first[key]
        name = key[0]
        if name == "fp_lin":
            replay_lin(h, rec, key, count, spec_k, ins, out, {"bls12_381": path_keys}, err)
            continue
        if name in plain:
            got = km._launch_addsub(name, spec_k, ins[0], ins[1], out)
            want_k, plain_ms = h.once_ms(lambda: plain[name](spec_k, *ins))
            e_row = h.check_equal(f"{name} {key[1]} {key[2]} strides {key[3:]}", got, want_k)
            err[name] = max(err[name], e_row)
            recorded[name].append(dict(field=key[1], shape=list(key[2]), strides=[list(s) if s else s
                                                                                 for s in key[3:]],
                                       launches=count, on_pairing_each=key in path_keys,
                                       max_abs_err=e_row, plain_ms=plain_ms, a0=words_hex(ins[0]),
                                       b0=words_hex(ins[1]), _ins=ins, _out=out, _spec=spec_k))
        else:
            e = key[3]
            pl = {"mont_mul": lambda: km.mont_mul_plain(spec_k, *ins),
                  "mont_sqr": lambda: km.mont_sqr_plain(spec_k, *ins),
                  "mont_pow": lambda: km.mont_pow_plain(spec_k, ins[0], e),
                  "mont_inv": lambda: km.mont_inv_plain(spec_k, ins[0])}[name]
            got = km._launch(name, spec_k, *ins, exponent=e)
            e_row = h.check_equal(f"{name} {key[1]} {key[2]} (e = {e})", got, pl())
            prods[name].append(dict(field=key[1], shape=list(key[2]), launches=count, max_abs_err=e_row,
                                    a0=words_hex(ins[0])))
    rec.first.clear()
    report = {}
    for name, kern in (("fp_add", km.fp_add), ("fp_sub", km.fp_sub)):
        rows = recorded[name]
        if not rows:
            raise AssertionError(f"{name}: no launch recorded on phases 8-9")
        # times: (24, 2^16) contiguous random words, and the path's widest launch
        f = B.FQ
        L = f.num_limbs
        a, b = h.rand_field(f, 1 << 16), h.rand_field(f, 1 << 16)
        gc.collect()  # the recorded inputs are many objects: no collection inside the timing
        ms = h.time_ms(lambda: kern(f, a, b), 50)
        dev_ms, dev_n = traced_device_ms(torch, name, lambda: kern(f, a, b), 20, dev)
        plain_ms = h.once_ms(lambda: plain[name](f, a, b))[1]
        b_ms, b_by = h.bound(3 * L * 4 * (1 << 16), (1 << 16) * h.add_ops(f))
        wide = next(r for r in rows if r["on_pairing_each"])  # rows run widest first
        m_el = math.prod(wide["shape"][1:])
        wide_ms = h.time_ms(lambda: km._launch_addsub(name, wide["_spec"], *wide["_ins"], wide["_out"]),
                            20)
        reads = sum(h.distinct_elems(t) for t in wide["_ins"])  # a stride-0 constant is read once
        wb_ms, wb_by = h.bound(wide["_spec"].num_limbs * 4 * (reads + m_el),
                               m_el * h.add_ops(wide["_spec"]))
        for r in rows:
            for k_ in ("_ins", "_out", "_spec"):
                r.pop(k_)
        wide.update(ms=wide_ms, bound_ms=wb_ms, bound_by=wb_by, share_of_bound=wb_ms / wide_ms)
        h.emit("kernel_addsub_shapes", kernel=name, rows=rows)
        report[name] = dict(max_abs_err=err[name], launches=per_pairing.get(name, 0), ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
                            device_ms_per_launch_traced=dev_ms, traced_launches=dev_n,
                            shape=[L, 1 << 16], widest_path_launch=wide, recorded_keys=len(rows),
                            edge_words=edge)
    h.emit("kernel_pairing_path_products", rows={k: v for k, v in prods.items()})
    for name in ("mont_mul", "mont_sqr", "mont_inv", "mont_pow"):
        report[name] = dict(launches_per_pairing_call=per_pairing.get(name, 0),
                            recorded_keys=len(prods.get(name, [])),
                            max_abs_err=max((r["max_abs_err"] for r in prods.get(name, [])), default=0))
    return report


# ---- 10. BN254, GT and the BW6 pairings ------------------------------------------

def expected_gt(torch, F, r, e_flat, ks, m, inf_every, dev):
    """Per-lane host known answers E^(k_j) for lane i, j = i % len(ks) (1 on
    the infinity lanes, every inf_every-th), as a tower tensor of m lanes on
    ``dev``, and the combined E^(sum over the lanes mod r)."""
    from zkarray_torch.testing import fp12_tensor, gt_powers

    rows = gt_powers(F.host, e_flat, ks)
    one = tuple(F.host.flatten(F.host.one()))
    table = fp12_tensor(F, rows + [one], dev)
    lane = np.arange(m) % len(ks)
    lane[np.arange(m) % inf_every == inf_every - 1] = len(ks)
    total = sum(ks[j] for j in lane.tolist() if j < len(ks)) % r
    comb = fp12_tensor(F, gt_powers(F.host, e_flat, [total]), dev)[..., 0]
    return table[..., torch.from_numpy(lane).to(dev)], comb


class PathRuns:
    """Phases 10 and 11's per-path runs: a call with the launch counters
    reset (its kernel inputs recorded in ``rec`` when asked), timed, traced,
    its result checked, and the recorded keys each path launched."""

    def __init__(self, torch, h, rec):
        self.torch, self.h, self.rec = torch, h, rec
        rec.keys, rec.first = collections.Counter(), {}
        self.seen, self.path_keys = collections.Counter(), {}

    def tag(self, label):
        """The keys whose launches the calls since the last tag added."""
        self.path_keys[label] = {k for k, v in self.rec.keys.items() if v > self.seen.get(k, 0)}
        self.seen = collections.Counter(self.rec.keys)

    def replay(self, label, err):
        """Tag ``label``, replay the keys its calls recorded against the
        plain versions (replay_recorded) and forget them, so that the next
        path records afresh and no path's input copies outlive it."""
        self.tag(label)
        rows = replay_recorded(self.h, self.rec, {label: self.path_keys[label]}, err)
        self.rec.keys.clear()
        self.seen.clear()
        return rows

    def run(self, fn, record=False):
        from zkarray_torch import kernels

        self.h.sync()
        kernels.reset_launches()
        self.rec.on = record
        try:
            out, ms = self.h.once_ms(fn)
        finally:
            self.rec.on = False
        return out, ms, {k: v for k, v in kernels.LAUNCHES.items() if v}

    def measure(self, fn, check, record=False, timed=PAIR_TIMED_RUNS, trace=True):
        """fn's first call (launches counted, inputs recorded when
        ``record``), ``timed`` timed calls (the first with its peak memory
        above what is allocated before it: no recorded copy in it; the
        median reported; with none, the first call's wall and no peak) and,
        with ``trace``, one traced call, each result checked."""
        torch = self.torch
        got, first_ms, launches = self.run(fn, record)
        check(got, "the first call")
        walls = [] if timed else [first_ms]  # timed = 0: the counted call's wall, no peak
        peak = None
        for i in range(timed):
            if i == 0:
                self.h.sync()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            got, ms, _ = self.run(fn)
            if i == 0:
                peak = torch.cuda.max_memory_allocated() - base
            check(got, "a timed call")
            walls.append(ms)
        med = sorted(walls)[len(walls) // 2]
        if trace:
            got, trace = device_trace(torch, fn, med)
            check(got, "the traced call")
        else:
            trace = None
        return dict(ms=med, ms_runs=walls, first_call_ms=first_ms, launches_per_call=launches,
                    launches_total=sum(launches.values()), peak_bytes_above_inputs=peak,
                    trace=trace)

    def equal(self, what, want):
        torch = self.torch

        def check(got, when):
            if got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(f"{what}: {when} differs from the host known answers")
        return check


FIELD_KERNELS = ("mont_mul", "mont_sqr", "mont_pow", "mont_inv", "fp_add", "fp_sub")


def field_kernel_calls():
    """(plain, kern): the six field kernels' plain versions and wrappers as
    f(spec, inputs, exponent), and mont_div's (inputs num0, den0, num1,
    den1)."""
    from zkarray_torch.kernels import mont as km

    plain = {"mont_mul": lambda f, ins, e: km.mont_mul_plain(f, *ins),
             "mont_sqr": lambda f, ins, e: km.mont_sqr_plain(f, *ins),
             "mont_pow": lambda f, ins, e: km.mont_pow_plain(f, ins[0], e),
             "mont_inv": lambda f, ins, e: km.mont_inv_plain(f, ins[0]),
             "fp_add": lambda f, ins, e: km.add_plain(f, *ins),
             "fp_sub": lambda f, ins, e: km.sub_plain(f, *ins),
             "mont_div": lambda f, ins, e: km.mont_div_plain(f, *ins)}
    kern = {"mont_mul": lambda f, ins, e: km.mont_mul(f, *ins),
            "mont_sqr": lambda f, ins, e: km.mont_sqr(f, *ins),
            "mont_pow": lambda f, ins, e: km.mont_pow(f, ins[0], e),
            "mont_inv": lambda f, ins, e: km.mont_inv(f, ins[0]),
            "fp_add": lambda f, ins, e: km.fp_add(f, *ins),
            "fp_sub": lambda f, ins, e: km.fp_sub(f, *ins),
            "mont_div": lambda f, ins, e: km.mont_div(f, *ins)}
    return plain, kern


def field_edge_checks(torch, h, fields, err):
    """The six field kernels against their plain versions on edge words of
    each field: every pair of testing.mont_inv_edge_words for the products,
    mont_pow at e = 0, 1, 2, 3, p - 2, (p - 1)/2, every pair of
    fadd_edge_words for the additions, fp_neg; mont_inv also against
    Python's pow; mont_div with the edge words as numerators and
    denominators. Raises on a difference; ``err`` takes each kernel's
    largest error. Returns the counts per field."""
    from zkarray_torch.core.limbs import ints_to_limbs_np
    from zkarray_torch.ff import fp
    from zkarray_torch.kernels import mont as km
    from zkarray_torch.testing import fadd_edge_words, mont_inv_edge_words

    plain, kern = field_kernel_calls()
    dev = h.dev
    edge = {}
    for f in fields:
        p = f.modulus
        words = mont_inv_edge_words(f, np.random.default_rng(11), n_random=8)
        xe = fp.from_ints(f, words, mont=False, device=dev)
        k = len(words)
        ii = torch.arange(k * k, device=dev)
        exps = [0, 1, 2, 3, p - 2, (p - 1) // 2]  # two full-length chains: the plain ones are slow
        xr = xe.flip(1)  # zero among the denominators of both quotients
        cases = [("mont_mul", (xe[:, ii // k], xe[:, ii % k]), None), ("mont_sqr", (xe,), None),
                 ("mont_inv", (xe,), None), ("mont_div", (xe, xr, xr, xe), None)]
        cases += [("mont_pow", (xe,), e) for e in exps]
        aw = fadd_edge_words(f, np.random.default_rng(12))
        xa = torch.from_numpy(ints_to_limbs_np(aw, f.num_limbs).astype(np.int32)).to(dev)
        ka = len(aw)
        ia = torch.arange(ka * ka, device=dev)
        for name in ("fp_add", "fp_sub"):
            cases.append((name, (xa[:, ia // ka], xa[:, ia % ka]), None))
        for name, ins, e in cases:
            err[name] = max(err[name], h.check_equal(f"{name} {f.name} edge words (e = {e})",
                                                     kern[name](f, ins, e), plain[name](f, ins, e)))
        err["fp_sub"] = max(err["fp_sub"], h.check_equal(
            f"fp_neg {f.name} edge words", km.fp_neg(f, xa), km.sub_plain(f, torch.zeros_like(xa), xa)))
        if fp.to_ints(f, km.mont_inv(f, xe), mont=False) != [
                pow(w * pow(f.r_int, -1, p), -1, p) * f.r_int % p if w else 0 for w in words]:
            raise AssertionError(f"mont_inv {f.name}: edge words differ from Python's pow")
        edge[f.name] = dict(product_words=k, product_pairs=k * k, exponents=len(exps),
                            addition_words=ka, addition_pairs=ka * ka)
    return edge


def replay_recorded(h, rec, path_keys, err):
    """Every (field, shape, strides) input that ``rec`` recorded, widest
    first, launched again and held against the plain version (raises on a
    difference; ``err`` takes each kernel's largest error). Returns per
    kernel its rows: field, shape, key, launches, the paths that launched
    it, error, plain ms, and the inputs under _-keys for timing. fp_lin's
    keys go to ``replay_lin`` (rec.lin_rows) instead."""
    from zkarray_torch.kernels import mont as km

    plain, _ = field_kernel_calls()
    rows = collections.defaultdict(list)
    for key, count in sorted(rec.keys.items(), key=lambda kv: -math.prod(kv[0][2])):
        spec, ins, out = rec.first.pop(key)
        name = key[0]
        if name == "fp_lin":
            replay_lin(h, rec, key, count, spec, ins, out, path_keys, err)
            continue
        e = key[3] if name not in ("fp_add", "fp_sub") else None
        if name in ("fp_add", "fp_sub"):
            got = km._launch_addsub(name, spec, ins[0], ins[1], out)
        else:
            got = km._launch(name, spec, *ins, exponent=e)
        want, plain_ms = h.once_ms(lambda: plain[name](spec, ins, e))
        e_row = h.check_equal(f"{name} {key[1]} {key[2]} {key[3:]}", got, want)
        err[name] = max(err[name], e_row)
        rows[name].append(dict(field=key[1], shape=list(key[2]), key=[str(x) for x in key[3:]],
                               launches=count, paths=[c for c, ks_ in path_keys.items() if key in ks_],
                               max_abs_err=e_row, plain_ms=plain_ms, _spec=spec, _ins=ins, _out=out,
                               _e=e))
    rec.first.clear()
    return rows


def field_width_report(torch, h, f, rows, labels, wide_key, edge, err):
    """The six field kernels at field ``f``'s width: wrapper ms at (L,
    2^FIELD48_LOG_N) random words (mont_pow at e = p - 2) with its plain ms
    and bound, the kernel's result held against the plain version's there
    (``err``); each kernel's widest recorded launch on the paths ``labels``
    (under ``wide_key``) with its bound; ptxas' registers, stack and spills
    at NW = L/2 from the library that holds that width."""
    from zkarray_torch.ff import fp
    from zkarray_torch.kernels import _build
    from zkarray_torch.kernels import mont as km
    from zkarray_torch.testing import mont_inv_ops

    plain, kern = field_kernel_calls()
    L = f.num_limbs
    nw = L // 2
    ptxas = {}
    for src in (_build.field_lib(nw), "fadd"):
        ptxas.update(parse_ptxas(_build.lib_path(src).with_suffix(".ptxas.txt").read_text()))
    report = {}
    m16 = 1 << FIELD48_LOG_N
    a, b = h.rand_field(f, m16), h.rand_field(f, m16)
    e_time = f.modulus - 2
    gc.collect()

    def inv_ops(spec, t, m_el):
        """mont_inv's 32-bit operations on m_el elements: the batched GCD's
        work is fixed by the field (testing.mont_inv_ops)."""
        return m_el * mont_inv_ops(spec)

    for name in FIELD_KERNELS:
        ins = (a, b) if name in ("mont_mul", "fp_add", "fp_sub") else (a,)
        e = e_time if name == "mont_pow" else None
        iters = 3 if name in ("mont_pow", "mont_inv") else 20
        ms = h.time_ms(lambda: kern[name](f, ins, e), iters)
        want, plain_ms = h.once_ms(lambda: plain[name](f, ins, e))
        err[name] = max(err[name], h.check_equal(f"{name} {f.name} ({L}, {m16}) (e = {e})",
                                                 kern[name](f, ins, e), want))
        del want
        if name in ("fp_add", "fp_sub"):
            ops = m16 * h.add_ops(f)
        elif name == "mont_pow":
            ops = m16 * h.pow_ops(f, e)
        elif name == "mont_inv":
            ops = inv_ops(f, a, m16)
        else:
            ops = m16 * (h.sqr_ops if name == "mont_sqr" else h.mul_ops)(f)
        b_ms, b_by = h.bound((len(ins) + 1) * L * 4 * m16, ops)
        rs = rows.get(name, [])
        rs_w = [r_ for r_ in rs if set(labels) & set(r_["paths"])
                and r_["_spec"].num_limbs == L and r_["_ins"] is not None]
        wide = None
        if rs_w:
            w = max(rs_w, key=lambda r_: math.prod(r_["shape"]))
            spec, w_ins, w_out, w_e = w["_spec"], w["_ins"], w["_out"], w["_e"]
            m_el = math.prod(w["shape"][1:])
            if name in ("fp_add", "fp_sub"):
                w_ms = h.time_ms(lambda: km._launch_addsub(name, spec, w_ins[0], w_ins[1], w_out), 20)
                w_ops = m_el * h.add_ops(spec)
            else:
                w_ms = h.time_ms(lambda: km._launch(name, spec, *w_ins, exponent=w_e),
                                 3 if name == "mont_inv" else 20)
                w_ops = (inv_ops(spec, w_ins[0], m_el) if name == "mont_inv" else
                         m_el * h.pow_ops(spec, w_e) if name == "mont_pow" else
                         m_el * (h.sqr_ops if name == "mont_sqr" else h.mul_ops)(spec))
            reads = sum(h.distinct_elems(t) for t in w_ins)
            wb_ms, wb_by = h.bound(spec.num_limbs * 4 * (reads + m_el), w_ops)
            wide = dict(field=w["field"], shape=w["shape"], launches=w["launches"], ms=w_ms,
                        bound_ms=wb_ms, bound_by=wb_by, share_of_bound=wb_ms / w_ms)
        regs = {k: v for k, v in ptxas.items() if f"{name}_kernelILi{nw}E" in k}
        report[name] = {"max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "share_of_bound": b_ms / ms, "shape": [L, m16],
                        "exponent_bits": None if e is None else e.bit_length(), wide_key: wide,
                        "recorded_keys": len(rs),
                        "recorded_keys_at_width": sum(r_["_spec"].num_limbs == L for r_ in rs),
                        "edge_words": edge, f"ptxas_nw{nw}": regs}
    return report


def bn_gt_bw6_phase(torch, h, rec):
    """Phase 10: the BN254 pairing, GT as a group on BLS12-381's Fp12 and the
    BW6-761 and BW6-767 pairings, each against host known answers, each
    path (pairing_each; GT's gt_mul_scalar and gt_msm) with its launches
    per call by kernel, PAIR_TIMED_RUNS timed calls, one traced call and
    its peak memory, and pairing (the product) with its launches and one
    timed call; then the field kernels at NW = 24
    (mont_mul, mont_sqr, mont_pow, mont_inv, fp_add, fp_sub) against their
    plain versions on edge words and on every (field, shape, strides) input
    recorded on the BW6 calls, timed at (48, 2^16) and at the widest BW6
    launch; ptxas' registers and spills at NW = 24; and the XYZZ, MSM and NTT
    kernels refusing NW = 24. Returns the kernels line's phase-10 figures."""
    from zkarray_torch.curves import bls12_381 as B
    from zkarray_torch.curves import bn254, bw6_761, bw6_767
    from zkarray_torch.ec.pairing import bn, bw6, gt
    from zkarray_torch.testing import E_BLS12_381, E_BN254, E_BW6_761, E_BW6_767, gt_inputs, pairing_inputs

    dev, sync = h.dev, h.sync
    rng = np.random.default_rng(10)
    n = 1 << PAIR_LOG_N
    pr = PathRuns(torch, h, rec)  # phase 10 records every path's inputs
    run, measure, equal, tag, path_keys = pr.run, pr.measure, pr.equal, pr.tag, pr.path_keys
    paths = {}

    def pairing_path(label, engine, spec, E, F, record, big=False):
        t0 = time.perf_counter()
        P, Q, ab, inf = pairing_inputs(spec, n, rng, PAIR_BASE, PAIR_INF_EVERY, device=dev)
        r = spec.g1.scalar.modulus
        want, want_comb = expected_gt(torch, F, r, E, ab, n, PAIR_INF_EVERY, dev)
        host_s = time.perf_counter() - t0
        each = measure(lambda: engine.pairing_each(spec, P, Q), equal(f"{label} pairing_each", want),
                       record)
        h.emit("pairing_each_" + label, curve=spec.name, pairs=n, infinity_lanes=int(inf.sum()),
               known_answer_pairs=len(ab), correct=True, pairings_per_s=n / each["ms"] * 1e3,
               host_known_answer_s=host_s, **each)
        # the product over the pairs: one counted call and one timed
        check = equal(f"{label} pairing", want_comb)
        got, first_ms, launches = run(lambda: engine.pairing(spec, P, Q), record)
        check(got, "the first call")
        got, ms, _ = run(lambda: engine.pairing(spec, P, Q))
        check(got, "the timed call")
        h.emit("pairing_" + label, curve=spec.name, pairs=n, correct=True, ms=ms,
               first_call_ms=first_ms, pairs_per_s=n / ms * 1e3, launches=launches)
        paths[label] = each["launches_per_call"]
        if big:
            m = 1 << PAIR_BIG_LOG_N
            t = torch.arange(m, device=dev) % n
            Pb = P._replace(x=P.x[:, t], y=P.y[:, t], inf=P.inf[t])
            Qb = Q._replace(x=Q.x[..., t], y=Q.y[..., t], inf=Q.inf[t])
            sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got, ms, launches = run(lambda: engine.pairing_each(spec, Pb, Qb))
            peak = torch.cuda.max_memory_allocated() - base
            equal(f"{label} pairing_each 2^{PAIR_BIG_LOG_N}", want[..., t])(got, "its call")
            h.emit(f"pairing_each_{label}_big", curve=spec.name, pairs=m, correct=True, ms=ms,
                   pairings_per_s=m / ms * 1e3, peak_bytes_above_inputs=peak, launches=launches)
            del Pb, Qb, got
        return each

    # -- BN254 (Ethereum's ecPairing, Groth16 verification) ---------------------------
    pairing_path("bn254", bn, bn254.PAIRING, E_BN254, bn254.FQ12, record=True, big=True)
    tag("bn254")

    # -- GT on BLS12-381's Fp12: scalar multiplication, MSM, neg, sub, double ------------
    F12, r = B.FQ12, B.FR.modulus
    G = gt.GTGroup(F12, B.FR)
    t0 = time.perf_counter()
    A, sc, ks, ss = gt_inputs(F12, E_BLS12_381, B.FR, n, rng, PAIR_BASE, device=dev)
    no_inf = 1 << 62
    want_mul, _ = expected_gt(torch, F12, r, E_BLS12_381, [k * s % r for k, s in zip(ks, ss)], n,
                              no_inf, dev)
    total = sum(ks[i % PAIR_BASE] * ss[i % PAIR_BASE] for i in range(n)) % r
    want_msm = expected_gt(torch, F12, r, E_BLS12_381, [total], 1, no_inf, dev)[0][..., 0]
    kb = ks[-1:] + ks[:-1]  # lane i - 1's k: A.roll(1)
    want_neg = expected_gt(torch, F12, r, E_BLS12_381, [-k % r for k in ks], n, no_inf, dev)[0]
    want_sub = expected_gt(torch, F12, r, E_BLS12_381, [(a - b) % r for a, b in zip(ks, kb)], n,
                           no_inf, dev)[0]
    want_dbl = expected_gt(torch, F12, r, E_BLS12_381, [2 * k % r for k in ks], n, no_inf, dev)[0]
    host_s = time.perf_counter() - t0
    gt_rows = {}
    for op, fn, want in (("mul_scalar", lambda: gt.gt_mul_scalar(G, A, sc), want_mul),
                         ("msm", lambda: gt.gt_msm(G, A, sc, 3), want_msm)):
        row = measure(fn, equal(f"gt {op}", want), record=True)
        row["ops_per_s"] = (n if op == "mul_scalar" else 1) / row["ms"] * 1e3
        gt_rows[op] = row
        paths[f"gt_{op}"] = row["launches_per_call"]
    B_ = A.roll(1, -1)
    for op, fn, want in (("neg", lambda: G.neg(A), want_neg), ("sub", lambda: G.sub(A, B_), want_sub),
                         ("double", lambda: G.double(A), want_dbl)):
        got, _, launches = run(fn)
        equal(f"gt {op}", want)(got, "its call")
        ms = h.time_ms(fn, 10)
        gt_rows[op] = dict(ms=ms, ops_per_s=n / ms * 1e3, launches_per_call=launches)
    h.emit("gt", tower=F12.name, n=n, c=3, scalar_bits=B.FR.bits, known_answer_elements=PAIR_BASE,
           correct=True, host_known_answer_s=host_s, **gt_rows)
    paths["gt"] = {k: paths["gt_mul_scalar"].get(k, 0) + paths["gt_msm"].get(k, 0)
                   for k in set(paths["gt_mul_scalar"]) | set(paths["gt_msm"])}
    tag("gt")
    del A, sc, want_mul, want_neg, want_sub, want_dbl, B_

    # -- BW6-761 (BLS12-377 proof verification) and BW6-767 --------------------------
    for label, mod, E in (("bw6_761", bw6_761, E_BW6_761), ("bw6_767", bw6_767, E_BW6_767)):
        pairing_path(label, bw6, mod.PAIRING, E, mod.FQ6, record=True)
        tag(label)

    # -- the field kernels at NW = 24 against their plain versions ----------------
    err = collections.defaultdict(int)
    edge = field_edge_checks(torch, h, (bw6_761.FQ, bw6_767.FQ), err)
    rows = replay_recorded(h, rec, path_keys, err)
    for name, rs in rows.items():
        h.emit("kernel_phase10_shapes", kernel=name,
               rows=[{k_: v for k_, v in r_.items() if not k_.startswith("_")} for r_ in rs])
    f = bw6_761.FQ
    report = field_width_report(torch, h, f, rows, ("bw6_761", "bw6_767"), "widest_bw6_launch",
                                edge, err)
    for name, r_ in report.items():
        r_["per_path_launches"] = {lbl: paths[lbl].get(name, 0)
                                   for lbl in ("bn254", "gt", "bw6_761", "bw6_767")}
        r_["recorded_keys_by_path"] = {lbl: sum(lbl in x["paths"] for x in rows.get(name, []))
                                       for lbl in path_keys}
    h.emit("nw24_kernels", rows={k: {kk: vv for kk, vv in v.items() if kk != "edge_words"}
                                 for k, v in report.items()}, edge_words=edge)
    report["mont_div"] = dict(per_path_launches={}, edge_words_max_abs_err=err["mont_div"],
                              fields=["bw6_761.Fq", "bw6_767.Fq"])

    # the XYZZ and MSM kernels are not built at NW = 24: each refuses it
    refusals = refused_launches(torch, h, bw6_761.G1)
    h.emit("nw24_refused", kernels=refusals, correct=True)
    h.emit("phase10_launches", per_call=paths)
    rec.path_launches.update(paths)
    return report


def refused_launches(torch, h, C):
    """xyzz_add, xyzz_add_affine and horner_windows at curve C's field width,
    which their C entries are not built for, and butterfly_dit and pow_table
    where no NTT library holds that width (NW = 26; phase 13 runs them at
    NW = 10 and 24): each must raise, with no launch counted. Returns the
    messages."""
    from zkarray_torch import kernels
    from zkarray_torch.kernels import _build
    from zkarray_torch.kernels import mont as km
    from zkarray_torch.kernels import sw as ksw

    f, dev = C.base, h.dev
    L = f.num_limbs
    pts = [h.rand_field(f, 64) for _ in range(4)]
    refusals = {}
    for kernel, call in (
            ("xyzz_add", lambda: ksw.xyzz_add(C, pts, pts)),
            ("xyzz_add_affine", lambda: ksw.xyzz_add_affine(C, pts, pts[0], pts[1],
                                                             torch.zeros(64, dtype=torch.bool,
                                                                         device=dev))),
            ("horner_windows", lambda: ksw.horner_windows(C, torch.cat(pts).T.contiguous()[:4], 13)),
            ("butterfly_dit", lambda: km.butterfly_dit(f, pts[0].reshape(L, 1, 2, 4, 8).clone(),
                                                       pts[1], 1)),
            ("pow_table", lambda: km.pow_table(f, 5, 64, dev))):
        if kernel in ("butterfly_dit", "pow_table") and L // 2 in _build.NTT_LIBS:
            continue
        before = kernels.LAUNCHES[kernel]
        try:
            call()
            h.sync()
        except (RuntimeError, ValueError) as exc:
            refusals[kernel] = str(exc)[:120]
        else:
            raise AssertionError(f"{kernel} ran at NW = {L // 2}")
        if kernels.LAUNCHES[kernel] != before:
            raise AssertionError(f"{kernel}: a refused launch was counted")
    return refusals


def mixed_mnt_cp6_phase(torch, h, rec):
    """Phase 11: ec/msm.py:msm_mixed on BLS12-381 G1 at 2^MIXED_LOG_N points
    (scalars in six magnitude classes) beside msm on the same inputs, each
    against the host known answer, and every MSM-kernel launch of its first
    counted call against the plain version on its own inputs; the MNT4-298, MNT6-298, MNT4-753 and
    MNT6-753 pairing_each at 2^MNT_LOG_N pairs and pairing over them; CP6-782's
    host G2 preparation per point, its Miller loop and final exponentiation
    at 2^MNT_LOG_N lanes and pairing_each end to end on CP6_EACH pairs. Each
    pairing lane against host powers of E (testing.E_*, the JAX package's
    words); each path with its launches per call by kernel, PAIR_TIMED_RUNS
    timed calls, one traced call and its peak memory. Then the field kernels
    against their plain versions on the NW = 10 and NW = 26 fields' edge
    words, on every (field, shape, strides) input recorded on the paths'
    first counted calls, and at (L, 2^FIELD48_LOG_N) with their times,
    bounds and ptxas' registers, stack and spills at both widths. Returns
    the kernels line's phase-11 figures."""
    from zkarray_torch import testing as tt
    from zkarray_torch.curves import bls12_381 as B
    from zkarray_torch.curves import cp6_782, mnt4_298, mnt4_753, mnt6_298, mnt6_753
    from zkarray_torch.ec import msm as tmsm
    from zkarray_torch.ec import sw as tsw
    from zkarray_torch.ec.pairing import cp6, mnt
    from zkarray_torch.interop import affine_from_numpy, limbs_from_numpy

    dev, sync = h.dev, h.sync
    pr = PathRuns(torch, h, rec)
    paths = {}
    err = collections.defaultdict(int)
    rows = collections.defaultdict(list)  # each path's recorded inputs, replayed after it

    def replay(label):
        """Replay ``label``'s recorded inputs; keep the input copies of each
        kernel's widest row per field width only (field_width_report times
        those), so the copies of five paths do not pile up on the card."""
        for name, rs in pr.replay(label, err).items():
            rows[name].extend(rs)
            widest = {}
            for r_ in rows[name]:
                L_ = r_["_spec"].num_limbs
                if r_["_ins"] is not None and (L_ not in widest or math.prod(r_["shape"]) >
                                               math.prod(widest[L_]["shape"])):
                    widest[L_] = r_
            for r_ in rows[name]:
                if r_ is not widest.get(r_["_spec"].num_limbs):
                    r_["_ins"] = r_["_out"] = None

    # -- msm_mixed: a Groth16 witness's magnitudes, tiled points ------------------
    n = 1 << MIXED_LOG_N
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    px, py, _, ks, _ = tt.tiled_inputs(B.G1, n, rng)
    sc = tt.mixed_scalars(B.FR, n, rng)
    want_pt = tt.expected_msm(B.G1, ks, sc)
    classes = {str(b): len(i) for b, i in tmsm.classify_scalars(sc, B.FR.bits)}
    host_s = time.perf_counter() - t0
    A = affine_from_numpy(px, py, np.zeros(n, dtype=bool), dev)
    s = limbs_from_numpy(sc, dev)
    del px, py, sc

    def check_pt(what):
        def check(res, when):
            aff = tsw.xyzz_to_affine(B.G1, tsw.XYZZPoints(*(v[:, None] for v in res)))
            if tsw.affine_to_ints(B.G1, aff) != [want_pt]:
                raise AssertionError(f"{what}: {when} differs from the host known answer")
        return check

    # the first counted call also keeps the inputs of every MSM-kernel launch
    # (each class's accumulation feeds, window rows and bit-Horner partials,
    # the 1-bit class's tree levels, the class totals' adds)
    restore_msm = install_msm_recorders(torch, rec)
    try:
        mixed = pr.measure(lambda: tmsm.msm_mixed(B.G1, A, s), check_pt("msm_mixed"), record=True,
                           timed=3)
        msm_calls = rec.msm
    finally:
        restore_msm()
    replay("msm_mixed")
    paths["msm_mixed"] = mixed["launches_per_call"]
    recorded = collections.Counter(k for k, _, _ in msm_calls)
    counted = {k: v for k, v in mixed["launches_per_call"].items() if k in MSM_KERNELS}
    if dict(recorded) != counted:
        raise AssertionError(f"msm_mixed: MSM-kernel launches recorded {dict(recorded)}, "
                             f"counted {counted}")
    msm_rows = replay_msm_launches(h, B.G1, msm_calls)
    del msm_calls
    h.emit("kernel_msm_mixed_shapes", inputs="every MSM-kernel launch of msm_mixed's first counted "
           "call, as it passed them", rows=msm_rows)
    msm_vs_plain = {k: dict(launches=v, max_abs_err=max(r["max_abs_err"] for r in msm_rows
                                                         if r["kernel"] == k),
                            ms_sum=sum(r["ms"] for r in msm_rows if r["kernel"] == k),
                            plain_ms_sum=sum(r["plain_ms"] for r in msm_rows if r["kernel"] == k))
                    for k, v in recorded.items()}
    # msm on these inputs is ~8 s a call (its residual rounds), within 1 % from call to call
    whole = pr.measure(lambda: tmsm.msm(B.G1, A, s), check_pt("msm"), trace=False)
    h.emit("msm_mixed", curve=B.G1.name, n=n, zero_scalars=n - sum(classes.values()),
           classes_by_bits=classes, correct=True, host_known_answer_s=host_s,
           points_per_s=n / mixed["ms"] * 1e3, **mixed, kernels_vs_plain=msm_vs_plain,
           msm_same_inputs=dict(whole, points_per_s=n / whole["ms"] * 1e3),
           msm_over_mixed=whole["ms"] / mixed["ms"])
    del A, s

    # -- the MNT pairings: MNT4/6-298 and MNT4/6-753 ---------------------------
    m = 1 << MNT_LOG_N
    for label, mod in (("mnt4_298", mnt4_298), ("mnt6_298", mnt6_298), ("mnt4_753", mnt4_753),
                       ("mnt6_753", mnt6_753)):
        spec = mod.PAIRING
        t0 = time.perf_counter()
        P, Q, ab, inf = tt.pairing_inputs(spec, m, rng, PAIR_BASE, PAIR_INF_EVERY, device=dev,
                                          scalar_bits=PAIR_SCALAR_BITS)
        want, want_comb = expected_gt(torch, spec.gt, spec.g1.scalar.modulus,
                                      getattr(tt, f"E_{label.upper()}"), ab, m, PAIR_INF_EVERY, dev)
        host_s = time.perf_counter() - t0
        each = pr.measure(lambda: mnt.pairing_each(spec, P, Q),
                          pr.equal(f"{label} pairing_each", want), record=True)
        h.emit("pairing_each_" + label, curve=spec.name, pairs=m, infinity_lanes=int(inf.sum()),
               known_answer_pairs=len(ab), pair_scalar_bits=PAIR_SCALAR_BITS, correct=True,
               pairings_per_s=m / each["ms"] * 1e3, host_known_answer_s=host_s, **each)
        got, ms, launches = pr.run(lambda: mnt.pairing(spec, P, Q), record=True)
        pr.equal(f"{label} pairing", want_comb)(got, "its call")
        h.emit("pairing_" + label, curve=spec.name, pairs=m, correct=True, ms=ms,
               pairs_per_s=m / ms * 1e3, launches=launches)
        paths[label] = each["launches_per_call"]
        replay(label)
        del P, Q, want, got

    # -- CP6-782: the host G2 ladder, then the Miller loop and final exponentiation ----
    spec = cp6_782.PAIRING
    t0 = time.perf_counter()
    P, Q, ab, inf = tt.pairing_inputs(spec, m, rng, PAIR_BASE, PAIR_INF_EVERY, device=dev,
                                      scalar_bits=PAIR_SCALAR_BITS)
    q_host = tt.g2_affine_to_ints(spec.g2, Q._replace(x=Q.x[..., :PAIR_BASE], y=Q.y[..., :PAIR_BASE],
                                                      inf=Q.inf[:PAIR_BASE]))
    want, _ = expected_gt(torch, cp6_782.FQ6, spec.g1.scalar.modulus, tt.E_CP6_782, ab, m,
                          PAIR_INF_EVERY, dev)
    host_s = time.perf_counter() - t0
    del Q
    sync()
    t0 = time.perf_counter()
    Qp64 = cp6.g2_prepare_host(spec, q_host, dev)
    sync()
    prep_s = time.perf_counter() - t0
    t = torch.arange(m, device=dev) % PAIR_BASE
    Qp = cp6.CP6G2Prepared(*(v[..., t] for v in Qp64[:4]), torch.zeros(m, dtype=torch.bool, device=dev))
    del Qp64
    loop = pr.measure(lambda: cp6.final_exponentiation(spec, cp6.multi_miller_loop(spec, P, Qp, False)),
                      pr.equal("cp6_782 Miller loop + final exponentiation", want), record=True)
    paths["cp6_782"] = loop["launches_per_call"]
    del Qp
    k = CP6_EACH
    Pk = P._replace(x=P.x[:, :k], y=P.y[:, :k], inf=P.inf[:k])
    got, each_ms, each_launches = pr.run(lambda: cp6.pairing_each(spec, Pk, q_host[:k]), record=True)
    pr.equal("cp6_782 pairing_each", want[..., :k])(got, "its call")
    replay("cp6_782")
    h.emit("cp6_782", curve=spec.name, g2_prepare_host=dict(points=len(q_host), s=prep_s,
                                                           s_per_point=prep_s / len(q_host)),
           miller_loop_final_exp=dict(lanes=m, infinity_lanes=int(inf.sum()), correct=True,
                                      pairings_per_s=m / loop["ms"] * 1e3, **loop),
           pairing_each=dict(pairs=k, correct=True, ms=each_ms, launches=each_launches),
           known_answer_pairs=len(ab), pair_scalar_bits=PAIR_SCALAR_BITS, host_known_answer_s=host_s)
    del P, Pk, want, got

    # -- the field kernels at NW = 10 and 26 against their plain versions ----------
    edge = field_edge_checks(torch, h, (mnt4_298.FQ, mnt6_298.FQ, cp6_782.FQ), err)
    for name, rs in rows.items():
        h.emit("kernel_phase11_shapes", kernel=name,
               rows=[{k_: v for k_, v in r_.items() if not k_.startswith("_")} for r_ in rs])
    report = {name: {"phase11": {lbl: paths[lbl].get(name, 0) for lbl in paths}}
              for name in FIELD_KERNELS}
    for f, labels in ((mnt4_298.FQ, ("mnt4_298", "mnt6_298")), (cp6_782.FQ, ("cp6_782",))):
        nw = f.num_limbs // 2
        rep = field_width_report(torch, h, f, rows, labels, "widest_path_launch", edge, err)
        for name, r_ in rep.items():
            r_.pop("edge_words")
            r_["recorded_keys_by_path"] = {lbl: sum(lbl in x["paths"] for x in rows.get(name, []))
                                           for lbl in pr.path_keys}
            report[name][f"nw{nw}"] = r_
        h.emit(f"nw{nw}_kernels", rows=rep, edge_words=edge)
    # nor at NW = 10 or 26; the NTT kernels not at NW = 26
    h.emit("nw10_nw26_refused", correct=True,
           kernels={C.name: refused_launches(torch, h, C) for C in (mnt4_298.G1, cp6_782.G1)})
    for name in FIELD_KERNELS:
        report[name]["phase11_max_abs_err"] = err[name]
    report["mont_div"] = dict(nw10_nw26_edge_words_max_abs_err=err["mont_div"],
                              nw10_nw26_fields=["mnt4_298.Fq", "mnt6_298.Fq", "cp6_782.Fq"])
    for name, r_ in msm_vs_plain.items():
        report[name] = {"msm_mixed": r_}
    h.emit("phase11_launches", per_call=paths)
    rec.path_launches.update(paths)
    return report


# ---- 12. fp_lin: the tower products' linear maps ----------------------------------

LIN_CURVES = ("bn254", "mnt4_298", "bls12_381", "bw6_761", "cp6_782")  # Fq at NW = 8 ... 26
LIN_HOST_CALLS = 200  # calls per host-time measurement (small batch: the host's cost per launch)
LIN_HOST_LANES = 64


def lin_phase(torch, h, rec):
    """Phase 12: fp_lin (csrc/flin.cu) against fp_lin_plain on the card, bit
    for bit: on edge words at NW = 8, 10, 12, 24 and 26 (every map row at
    the coefficient bound, broadcast and strided sources, a strided output;
    also against Python ints), and on the first input of every (field, map,
    shape, strides) key recorded on the first counted calls of phases 9-11
    (``rec.lin_rows``, replayed there). Times at each width's widest recorded
    path launch and at BLS12-381 pairing_each's widest against their byte
    bounds, the device time per launch in a trace of its own, and the host's
    us per launch beside fp_add's. Returns the kernels line's fp_lin row."""
    import importlib

    from zkarray_torch.curves import bls12_381 as B
    from zkarray_torch.ff import fp, linmap
    from zkarray_torch.kernels import lin
    from zkarray_torch.kernels import mont as km
    from zkarray_torch.testing import lin_edge_rows, lin_edge_words

    dev = h.dev
    err = collections.defaultdict(int)
    rows = rec.lin_rows
    if not rows:
        raise AssertionError("fp_lin: no launch recorded on phases 9-11")
    h.emit("kernel_lin_shapes", rows=[{k: v for k, v in r.items() if not k.startswith("_")}
                                      for r in rows], keys=len(rows))
    for r in rows:
        err["fp_lin"] = max(err["fp_lin"], r["max_abs_err"])

    # -- edge words at every width, held against the plain version and Python ints
    sizes = (3, 2, 1)
    edge, widths = {}, {}
    for curve in LIN_CURVES:
        f = importlib.import_module(f"zkarray_torch.curves.{curve}").FQ
        p, L = f.modulus, f.num_limbs
        rng = np.random.default_rng(L)
        words = lin_edge_words(f, rng)
        k = len(words)
        lmap = lin.LinMap(lin_edge_rows(sizes, rng), sizes, f"{f.name} edge")
        ii = torch.arange(k * k, device=dev)  # every pair of words in slots 0 and 1
        x = fp.from_ints(f, words, mont=False, device=dev)
        a = torch.stack([x[:, ii // k], x[:, ii % k], x[:, (ii * 7) % k]])
        wide = torch.stack([x[:, (ii * 5) % k], x[:, ii % k]]).repeat_interleave(2, dim=-1)
        b = wide[..., ::2]  # a strided batch
        c = x[None, :, k - 1]  # a ()-batch constant
        got = lin.fp_lin(f, lmap, [a, b, c])
        want = lin.fp_lin_plain(f, lmap, [a, b, c])
        e = h.check_equal(f"fp_lin {f.name} edge words", got, want)
        slab = torch.full((L, 2 * lmap.m, k * k), -1, dtype=torch.int32, device=dev)
        lin.fp_lin(f, lmap, [a, b, c], out=slab[:, ::2].movedim(1, 0))
        e = max(e, h.check_equal(f"fp_lin {f.name} edge words, strided out",
                                 slab[:, ::2].movedim(1, 0), want))
        if not bool((slab[:, 1::2] == -1).all()):
            raise AssertionError(f"fp_lin {f.name}: a strided output wrote outside its view")
        src = [[fp.to_ints(f, t[j, :, :64], mont=False) for j in range(t.shape[0])] for t in (a, b)]
        src.append([[words[-1]] * 64])
        if [fp.to_ints(f, got[i, :, :64], mont=False) for i in range(lmap.m)] != [
                [sum(cf * src[s_][j][e_] for s_, j, cf in r) % p for e_ in range(64)]
                for r in lmap.rows]:
            raise AssertionError(f"fp_lin {f.name}: edge words differ from Python ints")
        err["fp_lin"] = max(err["fp_lin"], e)
        edge[f.name] = dict(words=k, lanes=k * k, rows=lmap.m, max_abs_err=e)
        widths[L // 2] = f

    # -- each width's widest recorded path launch and BLS12-381 pairing_each's:
    # time, plain time, bound ----------------------------------------------------
    def timed(r):
        spec, lmap, ins, out = r["_spec"], r["_map"], list(r["_ins"]), r["_out"]
        ms = h.time_ms(lambda: lin._launch_lin(spec, lmap, ins, out), 20)
        dev_ms, dev_n = traced_device_ms(torch, "fp_lin", lambda: lin._launch_lin(spec, lmap, ins, out),
                                         20, dev)
        b_ms, b_by = h.bound(r["bytes"], r["ops"])
        return dict({k: v for k, v in r.items() if not k.startswith("_")}, ms=ms, bound_ms=b_ms,
                    bound_by=b_by, share_of_bound=b_ms / ms, device_ms_per_launch_traced=dev_ms,
                    traced_launches=dev_n)

    widest = {f"nw{r['_spec'].num_limbs // 2}": timed(r) for r in rows if r["_widest"]}
    missing = sorted(set(widths) - {int(k[2:]) for k in widest})
    if missing:
        raise AssertionError(f"fp_lin: no path launch recorded at NW = {missing}")
    main = timed(max((r for r in rows if "bls12_381" in r["paths"]), key=lambda r: r["bytes"]))
    for r in rows:
        r["_ins"] = r["_out"] = None

    # -- the host's cost per launch: fp_lin against fp_add on the same element --
    F12 = B.FQ12
    L = B.FQ.num_limbs
    g = torch.stack([h.rand_field(B.FQ, LIN_HOST_LANES) for _ in range(12)]).reshape(
        (2, 3, 2, L, LIN_HOST_LANES))
    route = linmap.route(F12, "mul", type(F12)._mul_sched, (F12, F12))
    prod = torch.stack([h.rand_field(B.FQ, LIN_HOST_LANES) for _ in range(route.s)])
    flat = g.flatten(0, 2)

    def host_us(fn):
        fn()
        h.sync()
        t = time.perf_counter()
        for _ in range(LIN_HOST_CALLS):
            fn()
        host = (time.perf_counter() - t) * 1e6 / LIN_HOST_CALLS
        h.sync()
        return host

    host = dict(lanes=LIN_HOST_LANES, calls=LIN_HOST_CALLS,
                fp_lin_post_map_us=host_us(lambda: lin.fp_lin(B.FQ, route.post, [prod, flat])),
                fp_lin_pre_map_us=host_us(lambda: lin.fp_lin(B.FQ, route.pre, [flat, flat])),
                fp_add_fq12_us=host_us(lambda: F12.add(g, g)),
                fp_add_us=host_us(lambda: km.fp_add(B.FQ, g[0, 0, 0], g[1, 0, 0])),
                fq12_mul_us=host_us(lambda: F12.mul(g, g)))
    h.emit("fp_lin_host", **host)

    per_path = {lbl: v.get("fp_lin", 0) for lbl, v in rec.path_launches.items() if v.get("fp_lin")}
    totals = {lbl: sum(v.values()) for lbl, v in rec.path_launches.items()}
    if totals.get("bls12_381", 0) > 12000:
        raise AssertionError(f"BLS12-381 pairing_each: {totals['bls12_381']} launches, above 12,000")
    report = dict(max_abs_err=err["fp_lin"], launches=per_path.get("bls12_381", 0),
                  per_path_launches=per_path, per_path_launches_all_kernels=totals,
                  ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                  bound_by=main["bound_by"], share_of_bound=main["share_of_bound"],
                  device_ms_per_launch_traced=main["device_ms_per_launch_traced"],
                  shape=main["shape"], map=main["map"], path_launch_timed=main,
                  widest_path_launch=widest,
                  recorded_keys=len(rows), edge_words=edge, host_us_per_launch=host)
    h.emit("fp_lin_kernel", **{k: v for k, v in report.items() if k != "edge_words"})
    return report


# ---- 13. the polynomial layer, mixed-radix and group domains, scalar multiplication --

POLY_LOG_N = 20  # Groth16 quotient: two degree 2^20 - 1 polynomials, Z_H of 2^20 points
EVAL_POINTS = 64  # dense.evaluate of a 2^20-coefficient polynomial: a batch of KZG openings
HORNER_KAT = 2  # host points for the quotient's identity and dense.evaluate
DIV_DEGREES = (1023, 3)  # divide_with_q_and_r: dividend and divisor degrees
MLE_VARS, MLE_FIXED, MLE_KAT = 20, 10, 257  # a 2^20-entry sumcheck table
SPARSE_TERMS, SPARSE_KAT = 16, 257  # uv_evaluate_over_domain on the 2^POLY_LOG_N domain
MV_VARS, MV_TERMS, MV_LOG_POINTS, MV_KAT = 3, 32, 16, 64
# (curve module, field, 2-adic exponent, q^b): each MNT base's largest mixed domain
MIXED_DOMAINS = (("mnt6_753", "FR", 15, 25), ("mnt4_298", "FQ", 17, 49))
GENERAL_TARGET, GENERAL_SIZE = 3 * 10 ** 5, 409_600  # tests/test_torch_mixed_radix.py holds the size
POLY_KAT = 16  # transform indices held against the host
GFFT_LOG_N, GFFT_RT_LOG_N, GFFT_KAT = 10, 4, 16  # fft_group: forward size, round-trip size
GLV_LOG_N, GLV_SMALL_LOG_N, G2_GLV_LOG_N = 16, 12, 12
WNAF_LOG_N, WNAF_WINDOW = 16, 4
FIXED_LOG_N, FIXED_WINDOW = 20, 8  # the powers of tau of a 2^20 setup
STREAM_LOG_N, STREAM_CHUNK_LOG_N = 21, 20  # msm_chunks: 2^21 points in chunks of 2^20
PIPPENGER_LOG_N, PIPPENGER_CHUNK = 12, 1 << 10
SCALAR_KAT = 64  # scalar-multiplication lanes held against the host
NTT_KERNELS = ("butterfly_dit", "butterfly_stage", "pow_table", "twiddle_mul")


def check_cached_tables(torch, km, snap):
    """Hold every table in kernels.mont's power-table cache that ``snap``
    (key -> a copy of its words) holds against its copy, bit for bit
    (raises on a change: no code may write into a cached table), then add
    the tables cached since to ``snap``. Returns the counts."""
    now = km.cached_tables()
    changed = [k[1:5] for k, v in snap.items() if k in now and not torch.equal(now[k], v)]
    if changed:
        raise AssertionError(f"cached power tables changed: {changed}")
    held = sum(k in now for k in snap)
    for k, v in now.items():
        snap.setdefault(k, v.clone())
    return dict(held_unchanged=held, evicted=len(snap) - len(now), cached=len(now),
                cached_bytes=sum(v.numel() * v.element_size() for v in now.values()))


def install_ntt_recorders(torch, km):
    """Wrap kernels.mont's NTT launchers so that, while ``nrec.on``, every
    launch of butterfly_dit is counted by (field, shape, table length,
    stride), of pow_table by (field, entries, packed, scaled) and of
    twiddle_mul by (field, shape, strides, r0, c0, the output's layout,
    the tables' sizes), each key's first inputs kept (butterfly_dit's and an
    in-place twiddle_mul's before the launch writes them). Returns (nrec,
    restore)."""
    nrec = types.SimpleNamespace(on=False, keys=collections.Counter(), first={})
    dit, pow_table, twiddle_mul = km._launch_dit, km.pow_table, km.twiddle_mul

    def keep(key, value):
        nrec.keys[key] += 1
        if key not in nrec.first:
            nrec.first[key] = value()

    def rec_dit(spec, x, tw, stride):
        if nrec.on:
            keep(("butterfly_dit", spec.name, tuple(x.shape), tw.shape[1], stride),
                 lambda: (spec, (x.clone(), tw), stride))
        return dit(spec, x, tw, stride)

    def rec_pow(spec, w_int, n, device, scale_int=None, packed=False):
        if nrec.on:
            keep(("pow_table", spec.name, n, packed, scale_int is not None),
                 lambda: (spec, (w_int, n, torch.device(device), scale_int, packed), None))
        return pow_table(spec, w_int, n, device, scale_int, packed)

    def rec_twiddle(spec, x, tw, r0=0, c0=0, out=None):
        if nrec.on:
            inplace = out is not None and out.data_ptr() == x.data_ptr()
            layout = None if out is None else ("in place" if inplace else tuple(out.stride()))
            keep(("twiddle_mul", spec.name, tuple(x.shape), tuple(x.stride()), r0, c0, layout,
                  tw.h, tw.lo.shape[0], tw.hi.shape[0]),
                 lambda: (spec, (replica(torch, x), tw, r0, c0),
                          None if out is None or inplace else replica(torch, out, copy=False)))
        return twiddle_mul(spec, x, tw, r0, c0, out)

    km._launch_dit, km.pow_table, km.twiddle_mul = rec_dit, rec_pow, rec_twiddle

    def restore():
        km._launch_dit, km.pow_table, km.twiddle_mul = dit, pow_table, twiddle_mul

    return nrec, restore


def ntt_bytes_ops(h, key, spec):
    """(bytes, 32-bit operations) of one recorded NTT-kernel launch: each
    input read and each output written once."""
    L, Lw = spec.num_limbs, spec.num_limbs * 4
    name = key[0]
    if name == "butterfly_dit":
        _, C, _, H, R = key[2]
        pairs = C * H * R
        return 4 * pairs * Lw + H * Lw, pairs * (h.mul_ops(spec) + 2 * h.add_ops(spec))
    if name == "pow_table":
        n = key[2]
        return n * Lw, n * max(n - 1, 0).bit_length() * h.mul_ops(spec) // 2
    n = math.prod(key[2][1:])
    return 2 * n * Lw + (key[8] + key[9]) * Lw, 2 * n * h.mul_ops(spec)


def replay_ntt(torch, h, nrec, label, err, rows):
    """Every NTT-kernel key ``nrec`` recorded on path ``label`` launched again
    on its first inputs and held against the plain version (raises on a
    difference; ``err`` takes each kernel's largest error); one row per key
    appended to ``rows[kernel]``, its inputs kept (timed later for the
    widest per width) with its bytes and operations. The keys are then
    forgotten."""
    from zkarray_torch.kernels import mont as km

    for key, count in sorted(nrec.keys.items(), key=lambda kv: str(kv[0])):
        spec, args, extra = nrec.first.pop(key)
        name = key[0]
        if name == "butterfly_dit":
            x, tw = args
            got = km._launch_dit(spec, x.clone(), tw, extra)
            want, plain_ms = h.once_ms(lambda: km.butterfly_dit_plain(spec, x.clone(), tw, extra))

            def again(spec=spec, x=x, tw=tw, stride=extra):  # in place on x: no fresh input needed
                return km._launch_dit(spec, x, tw, stride)
        elif name == "pow_table":
            w_int, n, dev, scale, packed = args
            got = km.pow_table(spec, w_int, n, dev, scale, packed)
            want, plain_ms = h.once_ms(lambda: km.pow_table_plain(spec, w_int, n, dev, scale, packed))

            def again(spec=spec, args=args):
                return km.pow_table(spec, *args)
        else:
            x, tw, r0, c0 = args
            want, plain_ms = h.once_ms(lambda: km.twiddle_mul_plain(
                spec, x, tw, r0, c0, torch.empty(x.shape, dtype=torch.int32, device=x.device)))
            out = extra if extra is not None else (x.clone() if key[6] == "in place" else None)
            if key[6] == "in place":
                x = out  # the launch reads and writes its own copy
            got = km.twiddle_mul(spec, x, tw, r0, c0, out)

            def again(spec=spec, x=x, tw=tw, r0=r0, c0=c0, out=out):
                return km.twiddle_mul(spec, x, tw, r0, c0, out)
        e = h.check_equal(f"{name} {key[1:]}", got, want)
        err[name] = max(err[name], e)
        nbytes, ops = ntt_bytes_ops(h, key, spec)
        row = dict(key=[str(k) for k in key[1:]], field=key[1], nw=spec.num_limbs // 2,
                   launches=count, path=label, max_abs_err=e, plain_ms=plain_ms, bytes=nbytes,
                   ops=ops, _again=again)
        # keep the inputs of each kernel's widest row per width only (timed later)
        wide = [r for r in rows[name] if r["nw"] == row["nw"] and r["_again"] is not None]
        if wide and wide[0]["bytes"] >= nbytes:
            row["_again"] = None
        elif wide:
            wide[0]["_again"] = None
        rows[name].append(row)
        del got, want
    nrec.keys.clear()
    nrec.first.clear()


def ntt_width_report(torch, h, rows, err):
    """Per NTT kernel and width NW: launches on phase 13's paths, the widest
    recorded launch timed (CUDA events, 10 launches) against its bound,
    its plain ms; butterfly_stage, which no path runs, at (L, 2^POLY_LOG_N)
    random words per width against its plain version. Every row's inputs
    are dropped after."""
    from zkarray_torch.curves import mnt4_298, mnt6_753
    from zkarray_torch.kernels import mont as km

    report = {k: {} for k in NTT_KERNELS}
    for name in ("butterfly_dit", "pow_table", "twiddle_mul"):
        by_nw = collections.defaultdict(list)
        for r in rows[name]:
            by_nw[r["nw"]].append(r)
        for nw, rs in sorted(by_nw.items()):
            w = next(r for r in rs if r["_again"] is not None)
            ms = h.time_ms(w["_again"], 10)
            b_ms, b_by = h.bound(w["bytes"], w["ops"])
            report[name][f"nw{nw}"] = dict(
                launches=sum(r["launches"] for r in rs), keys=len(rs),
                launches_by_path=dict(collections.Counter(
                    r["path"] for r in rs for _ in range(r["launches"]))),
                widest_key=w["key"], widest_path=w["path"], ms=ms, plain_ms=w["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
                max_abs_err=max(r["max_abs_err"] for r in rs), library_ms=None)
        for r in rows[name]:
            r.pop("_again")
    n = 1 << POLY_LOG_N
    for spec in (mnt4_298.FQ, mnt6_753.FR):
        lo, hi, w = (h.rand_field(spec, n) for _ in range(3))
        got = km.butterfly_stage(spec, lo, hi, w)
        want, plain_ms = h.once_ms(lambda: km.butterfly_stage_plain(spec, lo, hi, w))
        e = max(h.check_equal(f"butterfly_stage {spec.name} output {i}", g, w_)
                for i, (g, w_) in enumerate(zip(got, want)))
        err["butterfly_stage"] = max(err["butterfly_stage"], e)
        ms = h.time_ms(lambda: km.butterfly_stage(spec, lo, hi, w), 10)
        Lw = spec.num_limbs * 4
        b_ms, b_by = h.bound(5 * n * Lw, n * (h.mul_ops(spec) + 2 * h.add_ops(spec)))
        report["butterfly_stage"][f"nw{spec.num_limbs // 2}"] = dict(
            launches=0, entry="kernels.mont.butterfly_stage (no phase-13 path runs it)",
            shape=[spec.num_limbs, n], ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            share_of_bound=b_ms / ms, max_abs_err=e, library_ms=None)
    return report


def host_horner(cs, x, p):
    acc = 0
    for c in reversed(cs):
        acc = (acc * x + c) % p
    return acc


def poly_scalar_phase(torch, h, rec):
    """Phase 13: the rest of the polynomial layer and the scalar-multiplication
    family, each path through its entry points and against host known
    answers: the Groth16 quotient (dense.mul of two degree 2^20 - 1
    polynomials, divide_by_vanishing_poly by X^(2^20) - 1) and dense.evaluate
    at EVAL_POINTS points; divide_with_q_and_r; an MLE's eq_table,
    fix_variables and evaluate over 2^20 entries; the sparse evaluations;
    the largest mixed-radix domains of MNT6-753 Fr (NW = 24) and MNT4-298
    Fq (NW = 10) and a GeneralDomain; fft_group over BLS12-381 G1; glv_mul
    (BLS12-381, BN254, BLS12-377 G1), glv_mul_ext (BLS12-381 G2),
    WnafContext.mul and FixedBaseTable.batch_mul; msm_chunks and the two
    Pippengers. Each path's launches by kernel on its first counted call
    (its field-kernel and NTT-kernel inputs recorded, then replayed against
    the plain versions), its wall ms and peak memory; one trace each of the
    Groth16 quotient and the mixed-radix ffts. Then the NTT kernels at
    NW = 10 and 24: launches, the widest launch timed against its bound.
    Returns the kernels line's phase-13 figures."""
    import importlib

    from zkarray_torch import testing as tt
    from zkarray_torch.curves import bls12_377, bls12_381 as B, bn254
    from zkarray_torch.ec import fixed_base, glv, stream_msm, wnaf
    from zkarray_torch.ec import sw as tsw
    from zkarray_torch.ff import fp
    from zkarray_torch.interop import affine_from_numpy, limbs_from_numpy
    from zkarray_torch.kernels import mont as km
    from zkarray_torch.poly import dense, mle, sparse
    from zkarray_torch.poly import domain as tdm
    from zkarray_torch.poly import mixed_radix as tmr
    from zkarray_torch.poly.group_domain import SWJacobianCoeff, fft_group

    dev, sync = h.dev, h.sync
    pr = PathRuns(torch, h, rec)
    nrec, restore_ntt = install_ntt_recorders(torch, km)
    err = collections.defaultdict(int)
    ntt_rows = collections.defaultdict(list)
    paths, lines = {}, {}
    rng = np.random.default_rng(13)
    t_phase = time.perf_counter()

    def ints(spec, t, mont=True):
        return fp.to_ints(spec, t, mont=mont)

    def rand_ints(spec, k):
        return [int.from_bytes(rng.bytes(spec.num_limbs * 2), "little") % spec.modulus
                for _ in range(k)]

    def path(label, fn, check, timed=1, trace=False, record=True):
        """One path: its first call counted with its inputs recorded, then
        ``timed`` timed calls and, with ``trace``, one traced call, every
        result checked; the recorded keys replayed against the plain
        versions."""
        nrec.on = record
        try:
            if timed:
                res = pr.measure(fn, check, record=record, timed=timed, trace=trace)
            else:  # one counted call only (the group ladders take seconds)
                sync()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                got, ms, launches = pr.run(fn, record)
                peak = torch.cuda.max_memory_allocated() - base
                check(got, "the first call")
                res = dict(ms=ms, first_call_ms=ms, launches_per_call=launches,
                           launches_total=sum(launches.values()),
                           peak_bytes_above_inputs_recording=peak, trace=None)
        finally:
            nrec.on = False
        if record:
            pr.replay(label, err)
            replay_ntt(torch, h, nrec, label, err, ntt_rows)
        paths[label] = res["launches_per_call"]
        return res

    def emit(label, **kw):
        lines[label] = kw
        h.emit(label, **kw)

    # -- Groth16's quotient: a(X) b(X) = q(X) (X^n - 1) + r(X), BLS12-381 Fr --------
    fr, p = B.FR, B.FR.modulus
    n = 1 << POLY_LOG_N
    a, b = h.rand_field(fr, n), h.rand_field(fr, n)
    taus = rand_ints(fr, HORNER_KAT)
    t0 = time.perf_counter()
    a_i, b_i = ints(fr, a), ints(fr, b)
    ab_tau = [host_horner(a_i, x, p) * host_horner(b_i, x, p) % p for x in taus]
    host_s = time.perf_counter() - t0

    first_words = {}

    def quotient():
        return dense.divide_by_vanishing_poly(fr, dense.mul(fr, a, b), n)

    def check_quotient(res, when):
        q, r = res
        if tuple(q.shape) != (fr.num_limbs, n - 1) or tuple(r.shape) != (fr.num_limbs, n):
            raise AssertionError(f"Groth16 quotient: {when} has shapes {q.shape}, {r.shape}")
        if when == "the first call":
            q_i, r_i = ints(fr, q), ints(fr, r)
            for x, want in zip(taus, ab_tau):
                if (host_horner(q_i, x, p) * (pow(x, n, p) - 1) + host_horner(r_i, x, p)) % p != want:
                    raise AssertionError("Groth16 quotient: q(tau)(tau^n - 1) + r(tau) differs from "
                                         "a(tau) b(tau)")
            first_words["quotient"] = res
        elif not all(torch.equal(u, v) for u, v in zip(res, first_words["quotient"])):
            raise AssertionError(f"Groth16 quotient: {when} differs from the first")

    res = path("groth16_quotient", quotient, check_quotient, trace=True)
    first_words.clear()
    emit("groth16_quotient", field=fr.name, n=n, product_coefficients=2 * n - 1, correct=True,
         host_points=len(taus), host_known_answer_s=host_s, **res)

    tau_t = h.rand_field(fr, EVAL_POINTS)
    tau_i = ints(fr, tau_t[:, :HORNER_KAT])
    want_eval = [host_horner(a_i, x, p) for x in tau_i]

    def check_eval(res, when):
        if tuple(res.shape) != (fr.num_limbs, EVAL_POINTS) or ints(fr, res[:, :HORNER_KAT]) != want_eval:
            raise AssertionError(f"dense.evaluate: {when} differs from the host Horner")

    res = path("dense_evaluate", lambda: dense.evaluate(fr, a, tau_t), check_eval, timed=0)
    emit("dense_evaluate", field=fr.name, coefficients=n, points=EVAL_POINTS, correct=True,
         host_points=HORNER_KAT, **res)
    del a, b, a_i, b_i

    # -- divide_with_q_and_r: one serial step per quotient coefficient ------------
    da, db = DIV_DEGREES
    num, den = h.rand_field(fr, da + 1), h.rand_field(fr, db + 1)
    den[:, db] = fp.one(fr, (), dev)  # a nonzero leading coefficient
    num_i, den_i = ints(fr, num), ints(fr, den)

    def check_div(res, when):
        q, r = res
        if tuple(q.shape) != (fr.num_limbs, da - db + 1) or tuple(r.shape) != (fr.num_limbs, db):
            raise AssertionError(f"divide_with_q_and_r: {when} has shapes {q.shape}, {r.shape}")
        q_i, r_i = ints(fr, q), ints(fr, r)
        for x in taus:
            if (host_horner(q_i, x, p) * host_horner(den_i, x, p) + host_horner(r_i, x, p)) % p != \
                    host_horner(num_i, x, p):
                raise AssertionError(f"divide_with_q_and_r: {when}: q b + r differs from a")

    res = path("divide_with_q_and_r", lambda: dense.divide_with_q_and_r(fr, num, den), check_div,
               timed=0)
    emit("divide_with_q_and_r", field=fr.name, degrees=list(DIV_DEGREES), correct=True, **res)

    # -- MLE: a 2^20-entry table (20 variables) -----------------------------------
    f_t = h.rand_field(fr, 1 << MLE_VARS)
    r_t = h.rand_field(fr, MLE_VARS)
    t0 = time.perf_counter()
    f_i, r_i = ints(fr, f_t), ints(fr, r_t)
    eq_h = [1]
    for rj in r_i:  # bit j of the index is x_j
        eq_h = [e * (1 - rj) % p for e in eq_h] + [e * rj % p for e in eq_h]
    want_val = sum(e * v for e, v in zip(eq_h, f_i)) % p
    fold_idx = sorted({0, (1 << (MLE_VARS - MLE_FIXED)) - 1} | {
        int(i) for i in rng.integers(0, 1 << (MLE_VARS - MLE_FIXED), size=POLY_KAT)})
    eq_low = [1]
    for rj in r_i[:MLE_FIXED]:
        eq_low = [e * (1 - rj) % p for e in eq_low] + [e * rj % p for e in eq_low]
    want_fold = [sum(e * f_i[(y << MLE_FIXED) + x] for x, e in enumerate(eq_low)) % p for y in fold_idx]
    eq_idx = sorted({0, 1, (1 << MLE_VARS) - 1} | {int(i) for i in rng.integers(0, 1 << MLE_VARS,
                                                                               size=MLE_KAT - 3)})
    host_s = time.perf_counter() - t0

    def mle_run():
        return (mle.eq_table(fr, r_t), mle.fix_variables(fr, f_t, r_t[:, :MLE_FIXED]),
                mle.evaluate(fr, f_t, r_t))

    def check_mle(res, when):
        eq, fold, val = res
        if ints(fr, eq[:, eq_idx]) != [eq_h[i] for i in eq_idx]:
            raise AssertionError(f"mle.eq_table: {when} differs from the host at sampled indices")
        if ints(fr, fold[:, fold_idx]) != want_fold:
            raise AssertionError(f"mle.fix_variables: {when} differs from the host")
        if ints(fr, val) != [want_val]:
            raise AssertionError(f"mle.evaluate: {when} differs from sum_x eq(r, x) f(x)")

    res = path("mle", mle_run, check_mle)
    emit("mle", field=fr.name, variables=MLE_VARS, fixed=MLE_FIXED, eq_indices=len(eq_idx),
         fold_indices=len(fold_idx), correct=True, host_known_answer_s=host_s, **res)
    del f_t, f_i, eq_h

    # -- sparse: 16 terms over the 2^20 domain; 32 terms at 2^16 points -------------
    dom = tdm.Radix2Domain(fr, n)
    terms = [(int(d), c) for d, c in zip(rng.integers(0, 2 * n, size=SPARSE_TERMS),
                                         rand_ints(fr, SPARSE_TERMS))]
    degs, cs = sparse.uv_from_terms(fr, terms, dev)
    sp_idx = sorted({0, n - 1} | {int(i) for i in rng.integers(0, n, size=SPARSE_KAT - 2)})
    g = dom.group_gen_int
    want_sp = [sum(c * pow(g, d * j, p) for d, c in terms) % p for j in sp_idx]

    def check_sp(res, when):
        if tuple(res.shape) != (fr.num_limbs, n) or ints(fr, res[:, sp_idx]) != want_sp:
            raise AssertionError(f"uv_evaluate_over_domain: {when} differs from the host")

    res = path("sparse_uv_over_domain", lambda: sparse.uv_evaluate_over_domain(fr, degs, cs, dom),
               check_sp)
    emit("sparse_uv_over_domain", field=fr.name, terms=SPARSE_TERMS, n=n, indices=len(sp_idx),
         correct=True, **res)
    mv_terms = [(c, [(v, int(e)) for v, e in enumerate(rng.integers(0, 8, size=MV_VARS))])
                for c in rand_ints(fr, MV_TERMS)]
    powers, mcs = sparse.mv_from_terms(fr, MV_VARS, mv_terms, dev)
    m_pts = 1 << MV_LOG_POINTS
    pts = h.rand_field(fr, MV_VARS * m_pts).reshape(fr.num_limbs, MV_VARS, m_pts)
    cols = [int(i) for i in rng.integers(0, m_pts, size=MV_KAT)]
    xs = [ints(fr, pts[:, :, c]) for c in cols]
    want_mv = [sum(c * math.prod(pow(x[v], e, p) for v, e in t) for c, t in mv_terms) % p for x in xs]

    def check_mv(res, when):
        if tuple(res.shape) != (fr.num_limbs, m_pts) or ints(fr, res[:, cols]) != want_mv:
            raise AssertionError(f"mv_evaluate: {when} differs from the host")

    res = path("sparse_mv_evaluate", lambda: sparse.mv_evaluate(fr, powers, mcs, pts), check_mv)
    emit("sparse_mv_evaluate", field=fr.name, variables=MV_VARS, terms=MV_TERMS, points=m_pts,
         columns=len(cols), correct=True, **res)
    del pts

    # -- mixed-radix domains at NW = 24 and 10; a GeneralDomain ---------------------
    def geometric_case(spec, dom_, label, trace):
        """fft of c r^j with a few entries replaced, against the closed form
        plus the replaced entries' terms at POLY_KAT indices; the ifft round
        trip."""
        q = spec.modulus
        size = dom_.size
        r_, c_ = rand_ints(spec, 2)
        x = fp.mont_mul(spec, tdm.power_table(spec, r_, size, dev), fp.const_array(spec, c_, (1,), dev))
        spikes = sorted({int(i) for i in rng.integers(0, size, size=4)})
        vals = rand_ints(spec, len(spikes))
        x[:, spikes] = fp.from_ints(spec, vals, device=dev)
        w = dom_.group_gen_int
        ks = sorted({0, size - 1} | {int(i) for i in rng.integers(0, size, size=POLY_KAT - 2)})
        want = []
        for k in ks:
            z = r_ * pow(w, k, q) % q
            v = c_ * (1 - pow(z, size, q)) * pow(1 - z, -1, q) % q if z != 1 else c_ * size % q
            for j, s in zip(spikes, vals):
                v += (s - c_ * pow(r_, j, q)) * pow(w, j * k, q)
            want.append(v % q)

        def check(res, when):
            if tuple(res.shape) != (spec.num_limbs, size) or ints(spec, res[:, ks]) != want:
                raise AssertionError(f"{label}: fft {when} differs from the host at sampled indices")

        res = path(label, lambda: dom_.fft(x), check, trace=trace)
        ev = dom_.fft(x)
        back = dom_.ifft(ev)
        if not torch.equal(back, x):
            raise AssertionError(f"{label}: the ifft does not return the fft's input")
        ms_rt = h.once_ms(lambda: dom_.ifft(ev))[1]
        return res, ms_rt, len(ks)

    for curve, fname, s2, qb in MIXED_DOMAINS:
        spec = getattr(importlib.import_module(f"zkarray_torch.curves.{curve}"), fname)
        size = (1 << s2) * qb
        label = f"mixed_radix_{curve}_{fname.lower()}"
        res, ms_rt, nk = geometric_case(spec, tmr.MixedRadixDomain(spec, size), label, True)
        emit(label, field=spec.name, nw=spec.num_limbs // 2, n=size, factors=[1 << s2, qb],
             correct=True, round_trip=True, indices=nk, ifft_ms=ms_rt, **res)
    spec = importlib.import_module("zkarray_torch.curves.mnt6_753").FR
    gd = tdm.GeneralDomain(spec, GENERAL_TARGET)
    if not isinstance(gd, tmr.MixedRadixDomain) or gd.size != GENERAL_SIZE:
        raise AssertionError(f"GeneralDomain({spec.name}, {GENERAL_TARGET}): {gd!r}, not the "
                             f"mixed-radix domain of {GENERAL_SIZE}")
    res, ms_rt, nk = geometric_case(spec, gd, "general_domain", False)
    emit("general_domain", field=spec.name, target=GENERAL_TARGET, n=gd.size, correct=True,
         round_trip=True, indices=nk, ifft_ms=ms_rt, **res)

    # -- fft_group over BLS12-381 G1: P_j = c_j G ------------------------------------
    G1 = B.G1
    gops = SWJacobianCoeff(G1)
    gen = (G1.gen_x, G1.gen_y)
    ng = 1 << GFFT_LOG_N
    c_ints = rand_ints(fr, ng)
    Pg = tsw.scalar_mul(G1, G1.generator((ng,), dev), fp.from_ints(fr, c_ints, mont=False, device=dev))
    gdom = tdm.Radix2Domain(fr, ng)
    g_idx = sorted({0, ng - 1} | {int(i) for i in rng.integers(0, ng, size=GFFT_KAT - 2)})
    wg = gdom.group_gen_int
    want_g = [tt.ec_mul(gen, sum(c * pow(wg, j * k, p) for j, c in enumerate(c_ints)) % p,
                        G1.a_int, G1.base.modulus) for k in g_idx]
    stage_s = []
    scale_rows = gops.scale_rows

    def timed_scale_rows(a_, ks_):
        sync()
        t = time.perf_counter()
        out = scale_rows(a_, ks_)
        sync()
        stage_s.append(time.perf_counter() - t)
        return out

    gops.scale_rows = timed_scale_rows

    def check_gfft(res, when):
        aff = tsw.to_affine(G1, gops.take(res, g_idx))
        if tsw.affine_to_ints(G1, aff) != want_g:
            raise AssertionError(f"fft_group 2^{GFFT_LOG_N}: {when} differs from (DFT c)_k G")

    res = path("fft_group", lambda: fft_group(gdom, gops, Pg), check_gfft, timed=0)
    ladder_s = list(stage_s)
    nrt = 1 << GFFT_RT_LOG_N
    rdom = tdm.Radix2Domain(fr, nrt)
    P8 = gops.take(Pg, list(range(nrt)))

    def round_trip():
        return fft_group(rdom, gops, fft_group(rdom, gops, P8), inverse=True)

    def check_rt(res, when):
        got, want = tsw.to_affine(G1, res), tsw.to_affine(G1, P8)
        if not all(torch.equal(u, v) for u, v in zip(got, want)):
            raise AssertionError(f"fft_group 2^{GFFT_RT_LOG_N}: {when}: ifft(fft(P)) is not P")

    stage_s.clear()
    res_rt = path("fft_group_round_trip", round_trip, check_rt, timed=0)
    gops.scale_rows = scale_rows
    emit("fft_group", curve=G1.name, n=ng, indices=len(g_idx), correct=True,
         ladder_s=ladder_s, ladders=len(ladder_s), round_trip_n=nrt,
         round_trip_ms=res_rt["ms"], round_trip_launches=res_rt["launches_per_call"],
         round_trip_ladder_s=list(stage_s), **res)
    del Pg, P8

    # -- scalar multiplication: GLV, wNAF, fixed base -------------------------------
    def check_lanes(curve, pts_host, ks, lanes, what):
        a_, mod = curve.a_int, curve.base.modulus
        want = [tt.ec_mul(pts_host[i], ks[i], a_, mod) for i in lanes]

        def check(res, when):
            got = tsw.affine_to_ints(curve, tsw.to_affine(curve, tsw.JacobianPoints(
                *(v[:, lanes] for v in res))))
            if got != want:
                raise AssertionError(f"{what}: {when} differs from the host at sampled lanes")
        return check

    def lanes_of(m):
        return sorted({0, m - 1} | {int(i) for i in rng.integers(0, m, size=SCALAR_KAT - 2)})

    for name, curve, spec_fn, log_m in (("bls12_381", B.G1, glv.bls12_381_g1_glv, GLV_LOG_N),
                                        ("bn254", bn254.G1, glv.bn254_g1_glv, GLV_SMALL_LOG_N),
                                        ("bls12_377", bls12_377.G1, glv.bls12_377_g1_glv,
                                         GLV_SMALL_LOG_N)):
        m = 1 << log_m
        px, py, _, kb, _ = tt.tiled_inputs(curve, m, rng)
        A = affine_from_numpy(px, py, np.zeros(m, dtype=bool), dev)
        base = [tt.ec_mul((curve.gen_x, curve.gen_y), k, curve.a_int, curve.base.modulus) for k in kb]
        pts_host = [base[i % len(base)] for i in range(m)]
        ks = rand_ints(curve.scalar, m)
        gs = spec_fn()
        res = path(f"glv_mul_{name}", lambda: glv.glv_mul(gs, A, ks),
                   check_lanes(curve, pts_host, ks, lanes_of(m), f"glv_mul {name}"), timed=0)
        emit(f"glv_mul_{name}", curve=curve.name, n=m, lanes=SCALAR_KAT, correct=True, **res)
        del A, px, py

    G2 = B.G2
    m = 1 << G2_GLV_LOG_N
    H = G2.generator((m,), dev)
    ks = rand_ints(G2.scalar, m)
    g2s = glv.bls12_381_g2_glv()
    F2h = G2.ops.host
    lanes = lanes_of(m)
    want2 = [tt.ext_ec_mul(F2h, (G2.gen_x, G2.gen_y), ks[i]) for i in lanes]

    def check_g2(res, when):
        got = tt.g2_affine_to_ints(G2, sw_ext_to_affine(G2, res, lanes))
        if got != want2:
            raise AssertionError(f"glv_mul_ext bls12_381 G2: {when} differs from the host")

    res = path("glv_mul_ext_bls12_381_g2", lambda: glv.glv_mul_ext(g2s, H, ks), check_g2, timed=0)
    emit("glv_mul_ext_bls12_381_g2", curve=G2.name, n=m, lanes=len(lanes), correct=True, **res)
    del H

    m = 1 << WNAF_LOG_N
    ks = rand_ints(fr, m)
    ctx = wnaf.WnafContext(G1, gen, WNAF_WINDOW, dev)
    res = path("wnaf_mul", lambda: ctx.mul(ks),
               check_lanes(G1, [gen] * m, ks, lanes_of(m), "WnafContext.mul"), timed=0)
    emit("wnaf_mul", curve=G1.name, n=m, window=WNAF_WINDOW, lanes=SCALAR_KAT, correct=True, **res)

    m = 1 << FIXED_LOG_N
    t0 = time.perf_counter()
    tbl = fixed_base.FixedBaseTable(G1, gen, FIXED_WINDOW, dev)
    table_s = time.perf_counter() - t0
    sc = h.rand_field(fr, m)  # canonical scalars below r
    lanes = lanes_of(m)
    ks = ints(fr, sc[:, lanes], mont=False)
    chk = check_lanes(G1, [gen] * len(lanes), ks, list(range(len(lanes))), "FixedBaseTable.batch_mul")

    def check_fixed(res, when):
        chk(tsw.JacobianPoints(*(v[:, lanes] for v in res)), when)

    res = path("fixed_base_batch_mul", lambda: tbl.batch_mul(sc), check_fixed)
    res_fb = tbl.batch_mul(sc)
    sm = tsw.scalar_mul(G1, G1.generator((len(lanes),), dev), sc[:, lanes])
    if not all(torch.equal(u, v) for u, v in zip(tsw.to_affine(G1, sm), tsw.to_affine(
            G1, tsw.JacobianPoints(*(v[:, lanes] for v in res_fb))))):
        raise AssertionError("FixedBaseTable.batch_mul differs from ec.sw.scalar_mul at sampled lanes")
    emit("fixed_base_batch_mul", curve=G1.name, n=m, window=FIXED_WINDOW, rows=tbl.outerc,
         host_table_s=table_s, lanes=len(lanes), against_scalar_mul=True, correct=True, **res)
    del sc, res_fb, tbl

    # -- streaming MSM ---------------------------------------------------------------
    ns = 1 << STREAM_LOG_N
    chunk = 1 << STREAM_CHUNK_LOG_N
    px, py, ssc, kb, _ = tt.tiled_inputs(G1, ns, rng)
    want_pt = tt.expected_msm(G1, kb, ssc)
    A = affine_from_numpy(px, py, np.zeros(ns, dtype=bool), dev)
    s_t = limbs_from_numpy(ssc, dev)
    del px, py

    def chunks():
        for lo in range(0, ns, chunk):
            yield tsw.AffinePoints(A.x[:, lo:lo + chunk], A.y[:, lo:lo + chunk],
                                   A.inf[lo:lo + chunk]), s_t[:, lo:lo + chunk]

    def check_xyzz(want, what):
        def check(res, when):
            aff = tsw.xyzz_to_affine(G1, tsw.XYZZPoints(*(v[:, None] for v in res)))
            if tsw.affine_to_ints(G1, aff) != [want]:
                raise AssertionError(f"{what}: {when} differs from the host known answer")
        return check

    res = path("msm_chunks", lambda: stream_msm.msm_chunks(G1, chunks(), device=dev),
               check_xyzz(want_pt, "msm_chunks"))
    emit("msm_chunks", curve=G1.name, n=ns, chunk=chunk, correct=True, **res)
    del A, s_t

    npp = 1 << PIPPENGER_LOG_N
    base = [tt.ec_mul(gen, k, G1.a_int, G1.base.modulus) for k in kb]
    feed_pts = [base[i % len(base)] for i in range(npp)]
    feed_ks = rand_ints(fr, npp)
    # P_i = kb_(i mod 64) G, so sum_i k_i P_i = (sum_i kb_(i mod 64) k_i) G: one host ec_mul
    want_pp = tt.ec_mul(gen, sum(kb[i % len(kb)] * k for i, k in enumerate(feed_ks)) % p,
                        G1.a_int, G1.base.modulus)
    restore_msm = install_msm_recorders(torch, rec)
    try:
        for label, make in (("chunked_pippenger",
                             lambda: stream_msm.ChunkedPippenger(G1, PIPPENGER_CHUNK, device=dev)),
                            ("hashmap_pippenger", lambda: stream_msm.HashMapPippenger(G1, device=dev))):
            feed_s = []

            def run_feed():
                acc = make()
                t = time.perf_counter()
                for pt, k in zip(feed_pts, feed_ks):
                    acc.add(pt, k)
                feed_s.append(time.perf_counter() - t)
                return acc.finalize()

            res = path(label, run_feed, check_xyzz(want_pp, label))
            msm_rows = replay_msm_launches(h, G1, rec.msm)
            rec.msm = []
            for r_ in msm_rows:
                err[r_["kernel"]] = max(err[r_["kernel"]], r_["max_abs_err"])
            emit(label, curve=G1.name, points=npp, distinct_points=len(base), correct=True,
                 host_feed_s=feed_s, host_us_per_add=feed_s[0] / npp * 1e6,
                 msm_kernel_launches_vs_plain=len(msm_rows), **res)
    finally:
        restore_msm()
    restore_ntt()

    # -- the NTT kernels at NW = 10 and 24 ---------------------------------------------
    ntt_report = ntt_width_report(torch, h, ntt_rows, err)
    for name, rep in ntt_report.items():
        if name != "butterfly_stage" and not {"nw10", "nw24"} <= set(rep):
            raise AssertionError(f"{name}: no phase-13 launch at NW = 10 and 24 ({sorted(rep)})")
    h.emit("kernel_ntt_phase13_shapes", rows=ntt_rows)
    h.emit("ntt_nw10_nw24", kernels=ntt_report)
    h.emit("phase13_launches", per_call=paths, max_abs_err=dict(err),
           seconds=time.perf_counter() - t_phase)
    report = {}
    for name in set(err) | set(NTT_KERNELS):
        report[name] = dict(phase13_launches={lbl: v[name] for lbl, v in paths.items() if v.get(name)},
                            phase13_max_abs_err=err.get(name, 0))
    for name, rep in ntt_report.items():
        report[name].update(rep)
    return report


def sw_ext_to_affine(curve, P, lanes):
    """Lanes ``lanes`` of an ExtJacobian batch as ExtAffine."""
    from zkarray_torch.ec import sw_ext

    return sw_ext.to_affine(curve, sw_ext.ExtJacobian(*(v[..., lanes] for v in P)))


H2C_G1_LOG_N = 15  # BLS signatures (min-pubkey-size): messages hashed to G1 in one batch
H2C_G2_LOG_N = 13  # BLS signatures as Ethereum hashes them: messages hashed to G2 in one batch
H2C_G1_KAT, H2C_G2_KAT = 64, 16  # lanes held against the host hash-to-curve models
TE_LOG_N, TE_WIDE_LOG_N = 16, 12  # Jubjub and Bandersnatch lanes; the NW = 10, 12, 24 curves'
TE_KAT, TE_ORDER_LANES = 64, 16  # lanes against the host TE law; lanes multiplied by r
DO_LOG_N, ZOO_LOG_N = 16, 16  # jq255s; secp256k1 scalar_mul and Pallas glv_mul lanes
PALLAS_MSM_LOG_N, R1_MSM_LOG_N = 20, 16  # a Halo2 prover's MSM; an a = -3 MSM
ZOO_KAT = 64
R1_EDGE_SLOTS, R1_EDGE_ROUNDS = 4099, 8  # xyzz_accum edge rounds at a = -3
R1_EDGE_LOG_N = 16  # xyzz_add / xyzz_double edge classes at a = -3


def curves_h2c_phase(torch, h, rec):
    """Phase 14: the other curve models and hashing to curves on one card,
    each path through its entry points and against host known answers:
    hash to BLS12-381 G1 (2^15 messages: hash_to_field on the host, one
    bls12_381_g1_wb_map at (24, 2^16), the pairwise add, the h_eff ladder and
    to_affine, as hash_to_curve_bls12_381_g1 composes them; every lane on
    the curve and in G1, 64 lanes against testing.host_hash_to_g1; the RFC
    9380 vectors through hash_to_curve_bls12_381_g1) and to G2 (2^13
    messages, clear_cofactor_g2; 16 lanes against testing.host_hash_to_g2;
    the G2 vectors); twisted Edwards scalar_mul and to_affine (Jubjub and
    Bandersnatch at 2^16, ed_on_mnt4_298, ed_on_cp6_782 and ed_on_mnt4_753
    at 2^12), Elligator2 and the TE encodings; jq255s scalar_mul and
    get_e_from_u; the SW zoo: secp256k1 scalar_mul, a 2^20 Pallas msm,
    pallas_glv's glv_mul, a 2^16 secp256r1 msm and the XYZZ edge feeds at
    a = -3. Each path's launches by kernel on its first call (its
    field-kernel inputs recorded and replayed against the plain versions),
    one timed call, peak memory; traces of the G1 hash and Jubjub's
    scalar_mul; every MSM-kernel launch of the two MSMs and every edge feed
    held against the plain versions. Returns the kernels line's phase-14
    figures."""
    from zkarray_torch import testing as tt
    from zkarray_torch.core.limbs import unpack_pairs
    from zkarray_torch.curves import bls12_381 as B
    from zkarray_torch.curves import ed_on_bls12_381, te_zoo, zoo
    from zkarray_torch.ec import double_odd as tdo
    from zkarray_torch.ec import fast_checks, glv, msm, point_serde
    from zkarray_torch.ec import sw as tsw
    from zkarray_torch.ec import sw_ext
    from zkarray_torch.ec import te as tte
    from zkarray_torch.ec.h2c import elligator2, wb, wb_g2
    from zkarray_torch.ff import fp
    from zkarray_torch.ff.hash_to_field import hash_to_field_ints
    from zkarray_torch.interop import affine_from_numpy, limbs_from_numpy
    from zkarray_torch.kernels import mont as km
    from zkarray_torch.kernels import sw as ksw

    dev = h.dev
    pr = PathRuns(torch, h, rec)
    err = collections.defaultdict(int)
    paths = {}
    rng = np.random.default_rng(14)
    t_phase = time.perf_counter()
    vec_dir = os.path.join(REPO, "tests", "vectors")
    emit = h.emit

    def first_then_same(what, verify):
        """check(res, when): the first call's result through ``verify``
        (host known answers; raises), every later one equal to it word for
        word."""
        first = []

        def check(res, when):
            if not first:
                verify(res, when)
                first.append(res)
            elif not all(torch.equal(u, v) for u, v in zip(res, first[0])):
                raise AssertionError(f"{what}: {when} differs from the first call")
        return check

    def path(label, fn, verify, trace=False, timed=PAIR_TIMED_RUNS):
        res = pr.measure(fn, first_then_same(label, verify), record=True, trace=trace, timed=timed)
        pr.replay(label, err)
        paths[label] = res["launches_per_call"]
        return res

    def lanes_of(m, k):
        return sorted({i for i in (0, 1, 2, m - 1) if i < m}
                      | {int(i) for i in rng.integers(0, m, size=max(k - 4, 0))})

    def vectors(name):
        with open(os.path.join(vec_dir, name)) as fh:
            return json.load(fh)

    def pt_of(x):
        return json.loads(x.replace("'", '"')) if isinstance(x, str) else x

    def fq2_pair(s):
        c0, c1 = s.split(",")
        return int(c0, 16), int(c1, 16)

    # -- hash to G1: 2^15 messages, u on the host, the map and pipeline batched ------
    G1, FQ, FR = B.G1, B.FQ, B.FR
    p = FQ.modulus
    v1 = vectors("BLS12381G1_XMD-SHA-256_SSWU_RO_.json")
    dst1 = v1["dst"].encode()
    n1 = 1 << H2C_G1_LOG_N
    msgs = [rng.bytes(32) for _ in range(n1)]
    t0 = time.perf_counter()
    vals = [hash_to_field_ints(FQ, m, dst1, 2) for m in msgs]
    hash_s = time.perf_counter() - t0
    us = [v[0][0] for v in vals] + [v[1][0] for v in vals]
    s11 = tt.sqrt_mod(-pow(11, -1, p) % p, p)
    us[0], us[n1 + 1], us[2] = 0, s11, p - s11  # SWU's exceptional x1 = b/(Z a): u = 0, Z u^2 = -1
    u1 = fp.from_ints(FQ, us, device=dev)
    lanes1 = lanes_of(n1, H2C_G1_KAT)
    t0 = time.perf_counter()
    want1 = [tt.host_hash_to_g1(us[i], us[n1 + i]) for i in lanes1]
    host1_s = time.perf_counter() - t0

    def verify_g1(P, when):
        if tuple(P.x.shape) != (FQ.num_limbs, n1) or bool(P.inf.any()):
            raise AssertionError(f"hash to G1: {when} has shape {tuple(P.x.shape)} or infinity")
        got = tsw.affine_to_ints(G1, tsw.AffinePoints(P.x[:, lanes1], P.y[:, lanes1], P.inf[lanes1]))
        if got != want1:
            raise AssertionError(f"hash to G1: {when} differs from the host model at sampled lanes")
        if not bool(tsw.is_on_curve(G1, P).all()) or not bool(
                fast_checks.bls12_381_g1_subgroup_check(G1, P).all()):
            raise AssertionError(f"hash to G1: {when}: a lane off the curve or outside G1")

    res = path("hash_to_g1", lambda: wb.map_to_g1_pairs(u1), verify_g1, trace=True)
    rfc1 = []
    for v in v1["vectors"]:
        m = v["msg"].encode()
        u_want = [int(x, 16) for x in v["u"]]
        if [e[0] for e in hash_to_field_ints(FQ, m, dst1, 2)] != u_want:
            raise AssertionError(f"hash_to_field G1 {v['msg'][:16]!r} differs from the vector's u")
        q = tsw.affine_to_ints(G1, wb.bls12_381_g1_wb_map(fp.from_ints(FQ, u_want, device=dev)))
        P = tsw.affine_to_ints(G1, wb.hash_to_curve_bls12_381_g1(m, dst1, device=dev))
        want = [(int(pt_of(v[k])["x"], 16), int(pt_of(v[k])["y"], 16)) for k in ("Q0", "Q1", "P")]
        if q + P != want:
            raise AssertionError(f"hash_to_curve_bls12_381_g1 {v['msg'][:16]!r} differs from the vector")
        rfc1.append(v["msg"][:16])
    emit("hash_to_g1", messages=n1, map_lanes=2 * n1, host_hash_to_field_s=hash_s,
         host_model_lanes=len(lanes1), host_model_s=host1_s, exceptional_u=3,
         rfc9380_vectors=len(rfc1), correct=True, **res)
    del u1

    # -- hash to G2: 2^13 messages ----------------------------------------------------
    G2, F2 = B.G2, B.FQ2
    v2 = vectors("BLS12381G2_XMD-SHA-256_SSWU_RO_.json")
    dst2 = v2["dst"].encode()
    n2 = 1 << H2C_G2_LOG_N
    msgs = [rng.bytes(32) for _ in range(n2)]
    t0 = time.perf_counter()
    vals = [hash_to_field_ints(FQ, m, dst2, 2, ext_degree=2) for m in msgs]
    hash2_s = time.perf_counter() - t0
    us2 = [tuple(v[0]) for v in vals] + [tuple(v[1]) for v in vals]
    us2[0] = (0, 0)  # SWU's exceptional x1 = b/(Z a)
    u2 = F2.from_ints([[c[0] for c in us2], [c[1] for c in us2]], dev)
    lanes2 = lanes_of(n2, H2C_G2_KAT)
    t0 = time.perf_counter()
    want2 = [tt.host_hash_to_g2(us2[i], us2[n2 + i]) for i in lanes2]
    host2_s = time.perf_counter() - t0

    def verify_g2(P, when):
        got = tt.g2_affine_to_ints(G2, sw_ext.ExtAffine(P.x[..., lanes2], P.y[..., lanes2],
                                                         P.inf[lanes2]))
        if got != want2:
            raise AssertionError(f"hash to G2: {when} differs from the host model at sampled lanes")
        if bool(P.inf.any()) or not bool(sw_ext.is_on_curve(G2, P).all()) or not bool(
                fast_checks.bls12_381_g2_subgroup_check(G2, P).all()):
            raise AssertionError(f"hash to G2: {when}: a lane at infinity, off the twist or outside G2")

    res = path("hash_to_g2", lambda: wb_g2.map_to_g2_pairs(u2), verify_g2, timed=0)
    rfc2 = []
    for v in v2["vectors"]:
        m = v["msg"].encode()
        u_want = [fq2_pair(x) for x in v["u"]]
        if [tuple(e) for e in hash_to_field_ints(FQ, m, dst2, 2, ext_degree=2)] != u_want:
            raise AssertionError(f"hash_to_field G2 {v['msg'][:16]!r} differs from the vector's u")
        q = tt.g2_affine_to_ints(G2, wb_g2.bls12_381_g2_wb_map(
            F2.from_ints([[c[0] for c in u_want], [c[1] for c in u_want]], dev)))
        P = tt.g2_affine_to_ints(G2, wb_g2.hash_to_curve_bls12_381_g2(m, dst2, device=dev))
        want = [(fq2_pair(pt_of(v[k])["x"]), fq2_pair(pt_of(v[k])["y"])) for k in ("Q0", "Q1", "P")]
        if q + P != want:
            raise AssertionError(f"hash_to_curve_bls12_381_g2 {v['msg'][:16]!r} differs from the vector")
        rfc2.append(v["msg"][:16])
    emit("hash_to_g2", messages=n2, map_lanes=2 * n2, host_hash_to_field_s=hash2_s,
         host_model_lanes=len(lanes2), host_model_s=host2_s, exceptional_u=1,
         rfc9380_vectors=len(rfc2), correct=True, **res)
    del u2

    # -- twisted Edwards: scalar_mul and to_affine ---------------------------------------
    te_curves = (("jubjub", ed_on_bls12_381.EDWARDS, TE_LOG_N),
                 ("bandersnatch", te_zoo.BANDERSNATCH, TE_LOG_N),
                 ("ed_on_mnt4_298", te_zoo.ED_ON_MNT4_298, TE_WIDE_LOG_N),
                 ("ed_on_cp6_782", te_zoo.ED_ON_CP6_782, TE_WIDE_LOG_N),
                 ("ed_on_mnt4_753", te_zoo.ED_ON_MNT4_753, TE_WIDE_LOG_N))
    te_out = {}
    for name, curve, log_m in te_curves:
        m = 1 << log_m
        g = (curve.gen_x, curve.gen_y)
        kb = [int(k) for k in rng.integers(1, 1 << 30, size=64)]
        base = [tt.te_mul_host(curve, g, k) for k in kb]
        idx = torch.arange(m, device=dev) % 64
        A64 = curve.affine_from_ints(base, device=dev)
        A = tte.TEAffine(A64.x[:, idx], A64.y[:, idx])
        sc = h.rand_field(curve.scalar, m)
        lanes = lanes_of(m, TE_KAT)
        ks = fp.to_ints(curve.scalar, sc[:, lanes], mont=False)
        want = [tt.te_mul_host(curve, base[i % 64], k) for i, k in zip(lanes, ks)]

        def verify_te(P, when, curve=curve, lanes=lanes, want=want, name=name):
            te_out[name] = P
            if curve.affine_to_ints(tte.TEAffine(P.x[:, lanes], P.y[:, lanes])) != want:
                raise AssertionError(f"{name} scalar_mul: {when} differs from the host at sampled lanes")
            if not bool(tte.is_on_curve(curve, P).all()):
                raise AssertionError(f"{name} scalar_mul: {when}: a lane off the curve")
            o = TE_ORDER_LANES
            head = tte.from_affine(curve, tte.TEAffine(P.x[:, :o], P.y[:, :o]))
            rP = tte.scalar_mul_const(curve, head, curve.scalar.modulus)
            if not bool(tte.is_zero(curve, rP).all()):
                raise AssertionError(f"{name} scalar_mul: {when}: r P is not the identity")

        res = path(f"te_scalar_mul_{name}", lambda: tte.to_affine(curve, tte.scalar_mul(curve, A, sc)),
                   verify_te, trace=name == "jubjub", timed=int(name == "jubjub"))
        emit(f"te_scalar_mul_{name}", curve=curve.name, n=m, nw=curve.base.num_limbs // 2,
             a_is_minus_one=curve.a_is_minus_one, ladder_steps=curve.scalar.num_limbs * 16,
             lanes=len(lanes), order_lanes=TE_ORDER_LANES, correct=True, **res)
        del A, A64, sc
    jubjub_affine = te_out.pop("jubjub")
    te_out.clear()

    for name, curve in (("jubjub", ed_on_bls12_381.EDWARDS), ("bandersnatch", te_zoo.BANDERSNATCH)):
        m = 1 << TE_LOG_N
        f = curve.base
        zeta = f.sqrt_qnr
        u = h.rand_field(f, m)
        u[:, 0] = 0  # y' = 0 (-A/B is no square on both curves); x' = -1 never occurs (d no square)
        lanes = lanes_of(m, TE_KAT)
        u_i = fp.to_ints(f, u[:, lanes])
        want = [tt.host_elligator2(curve, x, zeta) for x in u_i]

        def verify_ell(P, when, curve=curve, lanes=lanes, want=want, name=name):
            if curve.affine_to_ints(tte.TEAffine(P.x[:, lanes], P.y[:, lanes])) != want:
                raise AssertionError(f"elligator2 {name}: {when} differs from the host at sampled lanes")
            if not bool(tte.is_on_curve(curve, P).all()):
                raise AssertionError(f"elligator2 {name}: {when}: a lane off the curve")

        res = path(f"elligator2_{name}", lambda: elligator2.elligator2_map(curve, u, zeta), verify_ell)
        emit(f"elligator2_{name}", curve=curve.name, n=m, zeta=zeta, sqrt_route=f.sqrt_mode,
             two_adicity=f.two_adicity, lanes=len(lanes), correct=True, **res)
        del u

    JJ = ed_on_bls12_381.EDWARDS

    def serde_round_trip():
        out = []
        for compress in (True, False):
            data = point_serde.serialize_te(JJ, jubjub_affine, compress)
            back, ok = point_serde.deserialize_te(JJ, data, compress, device=dev)
            out += [back.x, back.y, torch.from_numpy(ok).to(dev)]
        return tuple(out)

    def verify_serde(res, when):
        for k in (0, 3):
            if not (torch.equal(res[k], jubjub_affine.x) and torch.equal(res[k + 1], jubjub_affine.y)
                    and bool(res[k + 2].all())):
                mode = "compressed" if k == 0 else "uncompressed"
                raise AssertionError(f"TE serde: {when}: the {mode} round trip differs or is not ok")

    res = path("te_serde_jubjub", serde_round_trip, verify_serde)
    emit("te_serde_jubjub", curve=JJ.name, n=jubjub_affine.x.shape[1], modes=2, correct=True, **res)
    del jubjub_affine

    # -- double-odd: jq255s scalar_mul and get_e_from_u ----------------------------------
    JQ = zoo.JQ255S
    m = 1 << DO_LOG_N
    g = (JQ.gen_e, JQ.gen_u)
    r_jq = JQ.scalar.modulus
    kb = [int(k) for k in rng.integers(1, 1 << 30, size=64)]
    base = [tt.do_mul_host(JQ, g, k) for k in kb]
    idx = torch.arange(m, device=dev) % 64
    A64 = JQ.affine_from_ints(base, device=dev)
    A = tdo.DOAffine(A64.e[:, idx], A64.u[:, idx])
    sc = h.rand_field(JQ.scalar, m)
    lanes = lanes_of(m, ZOO_KAT)
    ks = fp.to_ints(JQ.scalar, sc[:, lanes], mont=False)
    t0 = time.perf_counter()
    want = [tt.do_mul_host(JQ, g, kb[i % 64] * k % r_jq) for i, k in zip(lanes, ks)]
    do_host_s = time.perf_counter() - t0

    def verify_do(P, when):
        got = JQ.affine_to_ints(tdo.DOAffine(P.e[:, lanes], P.u[:, lanes]))
        if not all(tt.do_same(JQ, a, b) for a, b in zip(got, want)):
            raise AssertionError(f"jq255s scalar_mul: {when} differs from the host group at sampled lanes")
        if not bool(tdo.is_on_curve(JQ, P).all()):
            raise AssertionError(f"jq255s scalar_mul: {when}: a lane off the curve")

    res = path("do_scalar_mul_jq255s", lambda: tdo.to_affine(JQ, tdo.scalar_mul(JQ, A, sc)), verify_do,
               timed=0)
    emit("do_scalar_mul_jq255s", curve=JQ.name, n=m, lanes=len(lanes), host_model="the curve's affine law",
         host_model_s=do_host_s, correct=True, **res)
    D = tdo.to_affine(JQ, tdo.scalar_mul(JQ, A, sc))
    pj = JQ.base.modulus
    bad = [x for x in range(2, 400)
           if pow((JQ.c_int * x ** 4 - 2 * JQ.a_int * x * x + 1) % pj, (pj - 1) // 2, pj) == pj - 1][:4]
    u_do = D.u.clone()
    u_do[:, 3:7] = fp.from_ints(JQ.base, bad, device=dev)
    u_i = fp.to_ints(JQ.base, u_do[:, lanes])
    e_i = fp.to_ints(JQ.base, D.e[:, lanes])

    def verify_e(res_, when):
        e, ok = res_
        got_e, got_ok = fp.to_ints(JQ.base, e[:, lanes]), ok[lanes].tolist()
        for x, ee, ge, gok, i in zip(u_i, e_i, got_e, got_ok, lanes):
            rhs = (JQ.c_int * x ** 4 - 2 * JQ.a_int * x * x + 1) % pj
            square = pow(rhs, (pj - 1) // 2, pj) != pj - 1
            if gok != square or (gok and ge * ge % pj != rhs) or (not gok and ge != 0) or (
                    gok and not 3 <= i < 7 and ge not in (ee, (-ee) % pj)):
                raise AssertionError(f"jq255s get_e_from_u: {when} differs from the host at lane {i}")
        if int((~ok).sum()) != 4:
            raise AssertionError(f"jq255s get_e_from_u: {when}: {int((~ok).sum())} lanes refused, not 4")

    res = path("do_get_e_from_u_jq255s", lambda: tdo.get_e_from_u(JQ, u_do), verify_e)
    emit("do_get_e_from_u_jq255s", curve=JQ.name, n=m, lanes=len(lanes), non_squares=4, correct=True, **res)
    del A, A64, sc, D, u_do

    # -- the short-Weierstrass zoo ---------------------------------------------------
    def sw_tiled(curve, m):
        px, py, _, kb_, _ = tt.tiled_inputs(curve, m, rng)
        return affine_from_numpy(px, py, np.zeros(m, dtype=bool), dev), kb_

    K1 = zoo.SECP256K1
    m = 1 << ZOO_LOG_N
    A, kb = sw_tiled(K1, m)
    sc = h.rand_field(K1.scalar, m)
    lanes = lanes_of(m, ZOO_KAT)
    gk = (K1.gen_x, K1.gen_y)
    want = [tt.ec_mul(gk, kb[i % 64] * k % K1.scalar.modulus, K1.a_int, K1.base.modulus)
            for i, k in zip(lanes, fp.to_ints(K1.scalar, sc[:, lanes], mont=False))]

    def verify_k1(P, when):
        if tsw.affine_to_ints(K1, tsw.AffinePoints(P.x[:, lanes], P.y[:, lanes], P.inf[lanes])) != want:
            raise AssertionError(f"secp256k1 scalar_mul: {when} differs from the host at sampled lanes")

    res = path("scalar_mul_secp256k1", lambda: tsw.to_affine(K1, tsw.scalar_mul(K1, A, sc)), verify_k1,
               timed=0)
    emit("scalar_mul_secp256k1", curve=K1.name, n=m, lanes=len(lanes), correct=True, **res)
    del A, sc

    gp = glv.pallas_glv()
    PA = gp.curve
    A, kb = sw_tiled(PA, m)
    ks = [int.from_bytes(rng.bytes(32), "little") % PA.scalar.modulus for _ in range(m)]
    gpa = (PA.gen_x, PA.gen_y)
    want = [tt.ec_mul(gpa, kb[i % 64] * ks[i] % PA.scalar.modulus, 0, PA.base.modulus) for i in lanes]

    def verify_glv(P, when):
        sampled = tsw.JacobianPoints(*(v[:, lanes] for v in P))
        if tsw.affine_to_ints(PA, tsw.to_affine(PA, sampled)) != want:
            raise AssertionError(f"pallas glv_mul: {when} differs from the host at sampled lanes")

    res = path("glv_mul_pallas", lambda: glv.glv_mul(gp, A, ks), verify_glv, timed=0)
    emit("glv_mul_pallas", curve=PA.name, n=m, lanes=len(lanes), correct=True, **res)
    del A

    restore_msm = install_msm_recorders(torch, rec)
    msm_rows, msm_results = {}, {}
    try:
        for label, curve, log_m in (("msm_pallas", PA, PALLAS_MSM_LOG_N),
                                    ("msm_secp256r1", zoo.SECP256R1, R1_MSM_LOG_N)):
            mm = 1 << log_m
            px, py, ssc, kb, bits = tt.tiled_inputs(curve, mm, rng)
            want_pt = tt.expected_msm(curve, kb, ssc)
            A = affine_from_numpy(px, py, np.zeros(mm, dtype=bool), dev)
            s_t = limbs_from_numpy(ssc, dev)

            def verify_msm(res_, when, curve=curve, want_pt=want_pt, label=label):
                pt = tsw.XYZZPoints(*(v[:, None] for v in res_))
                msm_results[label] = pt
                if tsw.affine_to_ints(curve, tsw.xyzz_to_affine(curve, pt)) != [want_pt]:
                    raise AssertionError(f"{label}: {when} differs from the host known answer")

            res = path(label, lambda: msm.msm(curve, A, s_t, max_scalar_bits=bits), verify_msm)
            rows = replay_msm_launches(h, curve, rec.msm)
            rec.msm = []
            for r_ in rows:
                err[r_["kernel"]] = max(err[r_["kernel"]], r_["max_abs_err"])
            msm_rows[label] = rows
            a_signed = curve.a_int - (curve.base.modulus if curve.a_int > curve.base.modulus // 2 else 0)
            emit(label, curve=curve.name, n=mm, a=a_signed, correct=True,
                 msm_kernel_launches_vs_plain=len(rows), **res)
            del A, s_t, px, py
    finally:
        restore_msm()
    h.emit("kernel_phase14_msm_shapes", rows={k: v for k, v in msm_rows.items()})

    # -- the XYZZ kernels at a = -3 on edge feeds, each against its plain version --------
    R1 = zoo.SECP256R1
    f = R1.base
    L = f.num_limbs
    mod = f.modulus
    edge = {}
    P0, rounds = tt.accum_edge_rounds(R1, R1_EDGE_SLOTS, R1_EDGE_ROUNDS, rng)
    state, coords, valid = tt.accum_feed(R1, P0, rounds, dev)
    for route, fn in (("grid", ksw.xyzz_accum_grid), ("tiles", ksw.xyzz_accum_tiles)):
        got = fn(R1, state, coords, valid)
        want_w, plain_ms = h.once_ms(lambda: ksw.xyzz_accum_plain(R1, state, coords, valid))
        e = h.check_equal(f"xyzz_accum ({route}) secp256r1 edge rounds", got, want_w)
        err["xyzz_accum"] = max(err["xyzz_accum"], e)
        edge[f"xyzz_accum_{route}"] = dict(slots=R1_EDGE_SLOTS, rounds=R1_EDGE_ROUNDS, max_abs_err=e,
                                           plain_ms=plain_ms)
    res_pts = tsw.XYZZPoints(*(unpack_pairs(got[i * L // 2:(i + 1) * L // 2]) for i in range(4)))
    k_chk = list(range(0, R1_EDGE_SLOTS, 97))[:64]
    want_acc = []
    for s in k_chk:
        acc = P0[s]
        for pts, sign, skip in rounds:
            if not skip[s]:
                acc = tt.ec_add(acc, pts[s] if not sign[s] else tt.ec_neg(pts[s], mod), R1.a_int, mod)
        want_acc.append(acc)
    acc64 = tsw.XYZZPoints(*(v[:, k_chk] for v in res_pts))
    got_acc = tsw.affine_to_ints(R1, tsw.xyzz_to_affine(R1, acc64))
    if got_acc != want_acc:
        raise AssertionError("xyzz_accum secp256r1 edge rounds: sampled slots differ from the host oracle")
    W, c = 8, 4  # the path's own windows at a = -3 (W = 24, c = 11) are the msm's
    win, total = tt.horner_edge_windows(R1, W, c, rng, dev)
    got = ksw.horner_windows(R1, win, c)
    want_w, plain_ms = h.once_ms(lambda: ksw.horner_windows_plain(R1, win, c))
    e = h.check_equal("horner_windows secp256r1 edge windows", got, want_w)
    err["horner_windows"] = max(err["horner_windows"], e)
    tot = tsw.XYZZPoints(*(got[i * L:(i + 1) * L, None] for i in range(4)))
    if tsw.affine_to_ints(R1, tsw.xyzz_to_affine(R1, tot)) != [total]:
        raise AssertionError("horner_windows secp256r1 edge windows: the total differs from the host")
    edge["horner_windows"] = dict(W=W, c=c, max_abs_err=e, plain_ms=plain_ms)
    parts = tt.bit_horner_edge_parts(R1, 13, 20, rng, dev)
    got = ksw.xyzz_bit_horner(R1, parts)
    want_w, plain_ms = h.once_ms(lambda: ksw.xyzz_bit_horner_plain(R1, parts))
    e = max(h.check_equal(f"xyzz_bit_horner secp256r1 edge parts {i}", g_, w_)
            for i, (g_, w_) in enumerate(zip(got, want_w)))
    err["xyzz_bit_horner"] = max(err["xyzz_bit_horner"], e)
    edge["xyzz_bit_horner"] = dict(shape=[L, 13, 20], max_abs_err=e, plain_ms=plain_ms)
    # xyzz_add / xyzz_double on real points in two Z representatives: classes
    # generic, P == Q (the doubling, with a), P == -Q, P = inf, Q = inf
    ne = 1 << R1_EDGE_LOG_N
    gr = (R1.gen_x, R1.gen_y)
    pool = [tt.ec_mul(gr, int(k), R1.a_int, mod) for k in rng.integers(1, 1 << 30, size=32)]
    ps, qs = [], []
    for i in range(64):
        a_, b_ = pool[i % 32], pool[(i * 7 + 3) % 32]
        cls = i % 5
        ps.append(None if cls == 3 else a_)
        qs.append(a_ if cls == 1 else tt.ec_neg(a_, mod) if cls == 2 else None if cls == 4 else b_)

    def xyzz_of(pts, seed):
        draws = np.random.default_rng(seed).integers(1, 1 << 62, size=len(pts))
        lam = [int(x) % (mod - 1) + 1 for x in draws]
        cs = [(1, 1, 0, 0) if q is None else (q[0] * l * l % mod, q[1] * l * l * l % mod, l * l % mod,
                                              l * l * l % mod) for q, l in zip(pts, lam)]
        t64 = [fp.from_ints(f, [c_[k] for c_ in cs], device=dev) for k in range(4)]
        tile = torch.arange(ne, device=dev) % len(pts)
        return tsw.XYZZPoints(*(v[:, tile] for v in t64))

    XP, XQ = xyzz_of(ps, 1), xyzz_of(qs, 2)
    got = ksw.xyzz_add(R1, XP, XQ)
    want_w, plain_ms = h.once_ms(lambda: ksw._fadd_plain(R1, tuple(XP), tuple(XQ)))
    e = max(h.check_equal(f"xyzz_add secp256r1 edge classes {i}", g_, w_)
            for i, (g_, w_) in enumerate(zip(got, want_w)))
    err["xyzz_add"] = max(err["xyzz_add"], e)
    add64 = tsw.XYZZPoints(*(v[:, :64] for v in got))
    if tsw.affine_to_ints(R1, tsw.xyzz_to_affine(R1, add64)) != [
            tt.ec_add(a_, b_, R1.a_int, mod) for a_, b_ in zip(ps, qs)]:
        raise AssertionError("xyzz_add secp256r1 edge classes differ from the host oracle")
    edge["xyzz_add"] = dict(n=ne, classes=5, max_abs_err=e, plain_ms=plain_ms)
    got = ksw.xyzz_double(R1, XP)
    want_w, plain_ms = h.once_ms(lambda: ksw._dbl_plain(R1, tuple(XP)))
    e = max(h.check_equal(f"xyzz_double secp256r1 {i}", g_, w_)
            for i, (g_, w_) in enumerate(zip(got, want_w)))
    err["xyzz_double"] = max(err["xyzz_double"], e)
    dbl64 = tsw.XYZZPoints(*(v[:, :64] for v in got))
    if tsw.affine_to_ints(R1, tsw.xyzz_to_affine(R1, dbl64)) != [
            tt.ec_add(a_, a_, R1.a_int, mod) for a_ in ps]:
        raise AssertionError("xyzz_double secp256r1 differs from the host oracle")
    edge["xyzz_double"] = dict(n=ne, max_abs_err=e, plain_ms=plain_ms)
    # the to-affine's mont_div at p >= R/2 against its plain route: the
    # secp256r1 msm's result, the sampled accumulate slots and the 64-wide
    # xyzz_add and xyzz_double batches above (infinity among them)
    div_rows = {}
    for what, P_ in (("msm_secp256r1 result", msm_results["msm_secp256r1"]),
                     ("xyzz_accum slots", acc64), ("xyzz_add batch", add64),
                     ("xyzz_double batch", dbl64)):
        e = h.check_equal(f"mont_div secp256r1 {what}", km.mont_div(f, P_.x, P_.zz, P_.y, P_.zzz),
                          km.mont_div_plain(f, P_.x, P_.zz, P_.y, P_.zzz))
        err["mont_div"] = max(err["mont_div"], e)
        div_rows[what] = dict(points=int(P_.x[0].numel()), max_abs_err=e)
    edge["mont_div"] = div_rows
    h.emit("xyzz_general_a_edges", curve=R1.name, a=-3, feeds=edge, correct=True)
    del state, coords, valid, XP, XQ, got, want_w

    h.emit("phase14_launches", per_call=paths, max_abs_err=dict(err),
           seconds=time.perf_counter() - t_phase)
    report = {}
    for name in set(err) | {k for v in paths.values() for k in v}:
        report[name] = dict(launches={lbl: v[name] for lbl, v in paths.items() if v.get(name)},
                            max_abs_err=err.get(name, 0))
    return report


SF_NTT_LOG_N = 20  # BabyBear ntt over (2^20, 64): a Plonky3 trace's LDE column block, 256 MiB
SF_NTT_COLS = 64
KB_NTT_COLS = 16  # KoalaBear at (2^20, 16)
GL_NTT_LOG_N = 24  # Goldilocks fp64.ntt: Plonky2's 2^21 x 8 blowup, rounded up
SF_ELEM_LOG_N = 24  # element-wise small-field ops
SF_KAT = 4096  # element-wise results held against Python ints at this many sampled indices
SF_DFT_KAT = 4  # NTT outputs held against the host at this many indices (of 2 columns)
DIST_MSM_LOG_N = 20  # msm_sharded on a one-rank NCCL group: the main path's size
DIST_FFT_LOG_N = 24  # fft_sharded on one rank, BLS12-381 Fr
RB_LOG_N = 16  # sw/te_from_random_bytes byte strings
DERIVE_LOG_N = 16  # points and field elements in the derived struct
MADD_TOP_LOG_N = 20  # the xyzz_add_affine (and xyzz_add) feeds at p >= R/2
R1_TIME_LOG_N = 16  # the secp256r1 msm whose PlainOps launches are timed
RB_KAT = 64
# 32-bit multiply instructions (IMAD, IMAD.WIDE, IMAD.HI) of one small-field
# product as csrc/smallfp.cu writes it: u32 Montgomery a b, m = lo inv and
# m p; M31 a b; Goldilocks a 64 x 64 -> 128 product (~7) and w2 eps; u64
# Montgomery the product and two steps' m and m p. The other instructions
# are left out, so the operation bound is a lower bound. Additions cost no
# multiply: their bound is their bytes.
SF_MUL_COST = {"u32": 3, "m31": 1, "gl64": 8, "u64": 16}


def sf_ops(fam, op, n, exponent=None):
    """Multiply instructions of one sf_op launch over n elements (pow: its
    ladder's products)."""
    if op in ("mul", "sqr"):
        return n * SF_MUL_COST[fam]
    if op != "pow":
        return 0
    e = exponent or 0
    return n * SF_MUL_COST[fam] * (e.bit_length() + bin(e).count("1"))


def install_sf_recorders(torch, ks):
    """Wrap kernels.smallfp's two launchers so that, while ``rec.on``, every
    launch's inputs and output are kept: rec.ops as (fam, consts, op, a, b,
    exponent, out) and rec.stages as (fam, consts, y before, tw, m, y
    after). Returns (rec, restore)."""
    rec = types.SimpleNamespace(on=False, ops=[], stages=[])
    launch_op, launch_bf = ks._launch_op, ks._launch_butterfly

    def op(fam, c, op_, a, b, exponent, out):
        res = launch_op(fam, c, op_, a, b, exponent, out)
        if rec.on:
            rec.ops.append((fam, c, op_, replica(torch, a), None if b is None else replica(torch, b),
                            exponent, res.clone()))
        return res

    def stage(fam, c, y, tw, m):
        before = y.clone() if rec.on else None
        launch_bf(fam, c, y, tw, m)
        if rec.on:
            rec.stages.append((fam, c, before, tw, m, y.clone()))
        return y

    ks._launch_op, ks._launch_butterfly = op, stage

    def restore():
        ks._launch_op, ks._launch_butterfly = launch_op, launch_bf

    return rec, restore


def replay_sf(torch, h, ks, rec, err):
    """Every recorded sf_op and sf_butterfly launch against its plain
    version on the same inputs (raises on a difference); the records are
    dropped. Returns the number of launches replayed and the plain
    versions' wall ms, launch by launch."""
    n, plain_ms = 0, []
    for fam, c, op, a, b, e, out in rec.ops:
        want, ms = h.once_ms(lambda: ks.sf_op_plain(fam, c, op, a, b, e))
        plain_ms.append(ms)
        err["sf_op"] = max(err["sf_op"], h.check_equal(f"sf_op {fam} {op} {tuple(a.shape)}",
                                                       out.to(torch.int64), want.to(torch.int64)))
        n += 1
    for fam, c, before, tw, m, after in rec.stages:
        want, ms = h.once_ms(lambda: ks.sf_butterfly_plain(fam, c, before, tw, m))
        plain_ms.append(ms)
        err["sf_butterfly"] = max(err["sf_butterfly"], h.check_equal(
            f"sf_butterfly {fam} m = {m} {tuple(before.shape)}", after.to(torch.int64),
            want.to(torch.int64)))
        n += 1
    rec.ops, rec.stages = [], []
    return n, plain_ms


def msm_launch_ops(curve, kernel, ins, extra, mul, sqr, add):
    """Operations of one recorded MSM-kernel launch, every lane counted as
    the generic formula (the tiled inputs' lanes are generic but for a
    few): xyzz_accum one mixed add per valid entry; horner_windows W - 1
    steps of c doublings and an add; xyzz_bit_horner B - 1 doublings and
    adds per window; xyzz_add, xyzz_double one formula per lane;
    xyzz_tree_sum m - 1 adds per row."""
    ops = functools.partial(xyzz_ops, mul, sqr, add, a_is_zero=curve.a_is_zero)
    L = curve.base.num_limbs
    if kernel == "xyzz_accum":
        return int(ins[2].sum()) * ops("madd")
    if kernel == "horner_windows":
        return (ins[0].shape[0] - 1) * (extra * ops("dbl") + ops("add"))
    if kernel == "xyzz_bit_horner":
        B, W = ins[0].shape[-2], ins[0].shape[-1]
        return W * (B - 1) * (ops("dbl") + ops("add"))
    lanes = ins[0].numel() // L
    if kernel == "xyzz_add":
        return lanes * ops("add")
    if kernel == "xyzz_double":
        return lanes * ops("dbl")
    m = ins[0].shape[-1]  # xyzz_tree_sum
    return lanes // m * (m - 1) * ops("add")


def smallfield_dist_phase(torch, h, rec=None):
    """Phase 15: the small fields and their NTTs on csrc/smallfp.cu
    (sf_op, sf_butterfly), the multi-device layer on a one-rank NCCL
    group, the rest of serialization, the xyzz_add_affine feeds at
    p >= R/2 and the secp256r1 msm's PlainOps launches timed against their
    bounds. Every result against a host known answer; every sf_op and
    sf_butterfly launch of the paths' first calls replayed against its
    plain version. ``rec`` is unused (the phase keeps its own recorders).
    Returns the kernels line's phase-15 figures (and its sf_op /
    sf_butterfly rows under "rows")."""
    import torch.distributed as tdist

    from zkarray_torch import kernels
    from zkarray_torch import testing as tt
    from zkarray_torch.curves import bls12_381 as B
    from zkarray_torch.curves import ed_on_bls12_381, zoo
    from zkarray_torch.dist import fft_sharded, gather_shards, make_mesh, msm_sharded
    from zkarray_torch.ec import msm as tmsm
    from zkarray_torch.ec import sw as tsw
    from zkarray_torch.ff import fp
    from zkarray_torch.ff import fp64 as tfp64
    from zkarray_torch.ff import smallfp as tsf
    from zkarray_torch.ff import smallfp64 as tsf64
    from zkarray_torch.interop import affine_from_numpy, limbs_from_numpy
    from zkarray_torch.kernels import _build
    from zkarray_torch.kernels import sw as ksw
    from zkarray_torch.kernels import smallfp as ks
    from zkarray_torch.poly.domain import Radix2Domain
    from zkarray_torch.serialize import derive as D
    from zkarray_torch.serialize import random_bytes as rb
    from zkarray_torch.serialize.canonical import field_byte_size
    from zkarray_torch.serialize.wrappers import COMPRESSED_CHECKED, UNCOMPRESSED_CHECKED

    dev, emit = h.dev, h.emit
    rng = np.random.default_rng(15)
    gen = torch.Generator(device=dev).manual_seed(15)
    err = collections.defaultdict(int)
    paths = {}
    rows = {"sf_op": [], "sf_butterfly": []}
    t_phase = time.perf_counter()
    rec, restore = install_sf_recorders(torch, ks)

    def counted(fn, record=False):
        h.sync()
        kernels.reset_launches()
        rec.on = record
        try:
            out, ms = h.once_ms(fn)
        finally:
            rec.on = False
        return out, ms, {k: v for k, v in kernels.LAUNCHES.items() if v}

    def pick(t, idx, dim=0):
        """Words of t at the indices ``idx`` (a device tensor) along ``dim``,
        as int64 (the gather runs on the int32 view)."""
        return t.view(torch.int32).index_select(dim, idx).to(torch.int64) & 0xFFFFFFFF

    def same(u, v):
        return torch.equal(u.view(torch.int32), v.view(torch.int32))

    def u32_rand(p, shape):
        return torch.randint(0, p, shape, generator=gen, device=dev, dtype=torch.int64).to(torch.uint32)

    def u64_rand(p, n):
        lo = torch.randint(0, 1 << 32, (n,), generator=gen, device=dev, dtype=torch.int64)
        hi = torch.randint(0, p >> 32, (n,), generator=gen, device=dev, dtype=torch.int64)
        return torch.stack([lo, hi]).to(torch.uint32)

    def host_u64(t, idx):
        w = pick(t, torch.as_tensor(idx, device=dev), 1).cpu().numpy()
        return [int(lo) | (int(hi) << 32) for lo, hi in zip(w[0], w[1])]

    def op_row(fam, c, op, args, label, n, plain_ms, exponent=None):
        """One sf_op at n elements: kernel ms (CUDA events), the plain
        version's ms (from its replay), the bound from its bytes and
        operations."""
        planes = ks.PLANES[fam]
        ms = h.time_ms(lambda: ks.sf_op(fam, c, op, *args, exponent=exponent), 5)
        b_ms, b_by = h.bound((len(args) + 1) * planes * 4 * n, sf_ops(fam, op, n, exponent))
        row = dict(path=label, family=fam, op=op, n=n, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, share_of_bound=b_ms / ms)
        rows["sf_op"].append(row)
        return row

    try:
        # -- small-field NTTs --------------------------------------------------------
        def ntt_path(label, spec, n, cols):
            p = spec.modulus
            x = u32_rand(p, (n, cols))
            w = spec.root_of_unity(n)
            tsf.twiddle_table.cache_clear()
            y, first_ms, first = counted(lambda: tsf.ntt(spec, x, w), record=True)
            replayed = replay_sf(torch, h, ks, rec, err)[0]
            _, ms, steady = counted(lambda: tsf.ntt(spec, x, w))
            back, inv_ms, inv_launches = counted(lambda: tsf.ntt(spec, y, w, inverse=True), record=True)
            replayed += replay_sf(torch, h, ks, rec, err)[0]
            if not same(back, x):
                raise AssertionError(f"{label}: the inverse round trip differs from the input")
            _, inv_steady_ms, _ = counted(lambda: tsf.ntt(spec, y, w, inverse=True))
            # the forward transform at SF_DFT_KAT indices of 2 columns, by host
            # modular arithmetic (exact: p < 2^31, products < 2^62)
            rinv = pow(spec.r_int, -1, p)
            ks_idx = sorted({0, 1, n - 1} | {int(k) for k in rng.integers(0, n, SF_DFT_KAT)})[:SF_DFT_KAT]
            for col in (0, cols - 1):
                col_t = torch.tensor([col], device=dev)
                xc = (pick(x, col_t, 1)[:, 0].cpu().numpy().astype(np.uint64) * np.uint64(rinv)) % np.uint64(p)
                yc = pick(y, torch.tensor(ks_idx, device=dev))[:, col]
                got = [spec.from_mont_int(int(v)) for v in yc.cpu().numpy()]
                for k, g in zip(ks_idx, got):
                    wk = pow(w, k, p)
                    pw = np.ones(n, dtype=np.uint64)
                    m = 1
                    while m < n:
                        pw[m:2 * m] = pw[:m] * np.uint64(pow(wk, m, p)) % np.uint64(p)
                        m *= 2
                    want = int((xc * pw % np.uint64(p)).sum() % np.uint64(p))
                    if g != want:
                        raise AssertionError(f"{label}: output {k} of column {col} differs from the host DFT")
            # the widest sf_butterfly launch (every stage moves the same bytes)
            yy, tw = y.clone(), tsf.twiddle_table(spec, w, n // 2, str(dev))
            st_ms = h.time_ms(lambda: ks.sf_butterfly("u32", spec.consts, yy, tw, n), 10)
            _, st_plain = h.once_ms(lambda: ks.sf_butterfly_plain("u32", spec.consts, yy.clone(), tw, n))
            b_ms, b_by = h.bound(2 * n * cols * 4 + n // 2 * 4, n // 2 * cols * SF_MUL_COST["u32"])
            rows["sf_butterfly"].append(dict(path=label, n=n, cols=cols, m=n, ms=st_ms, plain_ms=st_plain,
                                             bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / st_ms))
            paths[label] = steady
            emit(label, field=spec.name, n=n, cols=cols, correct=True, first_call_ms=first_ms,
                 first_call_launches=first, ms=ms, launches=steady, inverse_first_ms=inv_ms,
                 inverse_ms=inv_steady_ms, inverse_first_launches=inv_launches, dft_indices=ks_idx,
                 replayed_launches=replayed,
                 stage_ms=st_ms, stage_bound_ms=b_ms, stage_bound_by=b_by, stage_plain_ms=st_plain)
            del x, y, back, yy

        ntt_path("ntt_babybear", tsf.BABYBEAR, 1 << SF_NTT_LOG_N, SF_NTT_COLS)
        ntt_path("ntt_koalabear", tsf.KOALABEAR, 1 << SF_NTT_LOG_N, KB_NTT_COLS)

        # Goldilocks: a geometric input c r^j (made on the device by the
        # doubling table) with replaced entries, against the closed form
        # c (1 - r^n) / (1 - r w^k) + sum (new_j - old_j) w^(jk)
        G = tfp64.GOLDILOCKS
        p = G.modulus
        n = 1 << GL_NTT_LOG_N
        w = G.root_of_unity(n)
        cg, r = 7, 3
        x = tfp64.mul(tfp64.twiddle_table(r, n, str(dev)), tfp64.from_ints([cg], dev).reshape(2, 1))
        repl = {int(j): int(v) for j, v in zip(rng.integers(2, n - 1, 3), rng.integers(0, 1 << 62, 3))}
        for j, v in repl.items():
            x[:, j:j + 1] = tfp64.from_ints([v], dev).reshape(2, 1)
        jj = sorted(repl)[:1] + [0, 1, n - 1]
        if host_u64(x, jj) != [repl.get(j, cg * pow(r, j, p) % p) for j in jj]:
            raise AssertionError("goldilocks ntt: the device geometric input differs from the host")
        tfp64.twiddle_table.cache_clear()
        y, first_ms, first = counted(lambda: tfp64.ntt(x, w), record=True)
        replayed = replay_sf(torch, h, ks, rec, err)[0]
        _, ms, steady = counted(lambda: tfp64.ntt(x, w))
        back, inv_ms, inv_launches = counted(lambda: tfp64.ntt(y, w, inverse=True), record=True)
        replayed += replay_sf(torch, h, ks, rec, err)[0]
        if not same(back, x):
            raise AssertionError("goldilocks ntt: the inverse round trip differs from the input")
        _, inv_steady_ms, _ = counted(lambda: tfp64.ntt(y, w, inverse=True))
        kk = sorted({0, 1, n - 1} | {int(k) for k in rng.integers(0, n, SF_DFT_KAT)})
        rn = pow(r, n, p)
        for k, g in zip(kk, host_u64(y, kk)):
            wk = pow(w, k, p)
            want = cg * (1 - rn) * pow((1 - r * wk) % p, -1, p)
            want += sum((v - cg * pow(r, j, p)) * pow(wk, j, p) for j, v in repl.items())
            if g != want % p:
                raise AssertionError(f"goldilocks ntt: output {k} differs from the closed form")
        yy, tw = y.clone(), tfp64.twiddle_table(w, n // 2, str(dev))
        st_ms = h.time_ms(lambda: ks.sf_butterfly("gl64", ks.GL64, yy, tw, n), 10)
        _, st_plain = h.once_ms(lambda: ks.sf_butterfly_plain("gl64", ks.GL64, yy.clone(), tw, n))
        b_ms, b_by = h.bound(2 * n * 8 + n // 2 * 8, n // 2 * SF_MUL_COST["gl64"])
        rows["sf_butterfly"].append(dict(path="ntt_goldilocks", n=n, cols=1, m=n, ms=st_ms,
                                         plain_ms=st_plain, bound_ms=b_ms, bound_by=b_by,
                                         share_of_bound=b_ms / st_ms))
        paths["ntt_goldilocks"] = steady
        emit("ntt_goldilocks", n=n, correct=True, first_call_ms=first_ms, first_call_launches=first,
             ms=ms, launches=steady, inverse_first_ms=inv_ms, inverse_ms=inv_steady_ms,
             inverse_first_launches=inv_launches, indices=kk,
             replayed_launches=replayed, stage_ms=st_ms, stage_bound_ms=b_ms, stage_bound_by=b_by,
             stage_plain_ms=st_plain)
        del x, y, back, yy, tw
        tfp64.twiddle_table.cache_clear()
        tsf.twiddle_table.cache_clear()

        # -- every public small-field function once on the card against the CPU ----
        sweep = 0
        for mod, spec_, cpu_args in (
                (tsf, tsf.KOALABEAR, None), (tfp64, tfp64.GOLDILOCKS, None),
                (tsf64, tsf64.SmallFp64Spec((1 << 62) - (1 << 16) + 1, 3, "p62"), None)):
            vals = [0, 1, spec_.modulus - 1] + [int(v) for v in rng.integers(2, 1 << 31, 13)]
            if mod is tfp64:
                xc, yc = tfp64.from_ints(vals, "cpu"), tfp64.from_ints(vals[::-1], "cpu")
                calls = (("mul", tfp64.mul, 2), ("sqr", tfp64.sqr, 1), ("add", tfp64.add, 2),
                         ("sub", tfp64.sub, 2), ("neg", tfp64.neg, 1), ("one_like", tfp64.one_like, 1),
                         ("pow_const", lambda t: tfp64.pow_const(t, 11), 1),
                         ("inv", lambda t: tfp64.inv(spec_, t), 1),
                         ("ntt", lambda t: tfp64.ntt(t, spec_.root_of_unity(16)), 1))
            else:
                xc, yc = mod.from_ints(spec_, vals, device="cpu"), mod.from_ints(spec_, vals[::-1], device="cpu")
                mul_ = mod.mont_mul
                calls = [("mont_mul", functools.partial(mul_, spec_), 2),
                         ("add", functools.partial(mod.add, spec_), 2),
                         ("sub", functools.partial(mod.sub, spec_), 2),
                         ("neg", functools.partial(mod.neg, spec_), 1),
                         ("pow_const", lambda t, m_=mod, s_=spec_: m_.pow_const(s_, t, 11), 1),
                         ("inv", functools.partial(mod.inv, spec_), 1)]
                if mod is tsf:
                    calls += [("mont_sqr", functools.partial(tsf.mont_sqr, spec_), 1),
                              ("m31_mul", tsf.m31_mul, 2),
                              ("ntt", lambda t, s_=spec_: tsf.ntt(s_, t, s_.root_of_unity(16)), 1)]
                else:
                    calls += [("one", lambda t, s_=spec_: tsf64.one(s_, tuple(t.shape[1:]), t.device), 1)]
            for name, fn, arity in calls:
                args = (xc, yc)[:arity]
                want_c = fn(*args)
                got_c = fn(*(t_.to(dev) for t_ in args))
                if got_c.device.type != dev.type or not torch.equal(got_c.cpu(), want_c):
                    raise AssertionError(f"{mod.__name__}.{name}: the card's words differ from the CPU's")
                sweep += 1
        emit("small_field_api_sweep", calls=sweep, correct=True)

        # -- element-wise ops at 2^24, sampled indices against Python ints -------
        ne = 1 << SF_ELEM_LOG_N
        idx = sorted({0, 1, ne - 1} | {int(i) for i in rng.integers(0, ne, SF_KAT)})
        idx_t = torch.tensor(idx, device=dev)
        BB = tsf.BABYBEAR
        pb = BB.modulus
        a, b = u32_rand(pb, (ne,)), u32_rand(pb, (ne,))
        a[:3] = torch.tensor([0, BB.r_int, pb - 1], dtype=torch.int64).to(torch.uint32)
        ha = [BB.from_mont_int(int(v)) for v in pick(a, idx_t).cpu().tolist()]
        hb = [BB.from_mont_int(int(v)) for v in pick(b, idx_t).cpu().tolist()]
        checks = (("mont_mul", lambda: tsf.mont_mul(BB, a, b), [x * y % pb for x, y in zip(ha, hb)]),
                  ("add", lambda: tsf.add(BB, a, b), [(x + y) % pb for x, y in zip(ha, hb)]),
                  ("sub", lambda: tsf.sub(BB, a, b), [(x - y) % pb for x, y in zip(ha, hb)]),
                  ("neg", lambda: tsf.neg(BB, a), [-x % pb for x in ha]),
                  ("inv", lambda: tsf.inv(BB, a), [pow(x, pb - 2, pb) for x in ha]))
        elem_launches = collections.Counter()
        for (name, fn, want), (op, args, e) in zip(checks, (
                ("mul", (a, b), None), ("add", (a, b), None), ("sub", (a, b), None),
                ("neg", (a,), None), ("pow", (a,), pb - 2))):
            out, _, launches = counted(fn, record=True)
            elem_launches.update(launches)
            if [BB.from_mont_int(int(v)) for v in pick(out, idx_t).cpu().tolist()] != want:
                raise AssertionError(f"babybear {name} at 2^{SF_ELEM_LOG_N}: sampled indices differ")
            op_row("u32", BB.consts, op, args, "babybear", ne, replay_sf(torch, h, ks, rec, err)[1][0], e)
        pm = tsf.M31.modulus
        am, bm = u32_rand(pm, (ne,)), u32_rand(pm, (ne,))
        out, _, launches = counted(lambda: tsf.m31_mul(am, bm), record=True)
        elem_launches.update(launches)
        hm = pick(am, idx_t).cpu().tolist(), pick(bm, idx_t).cpu().tolist()
        if pick(out, idx_t).cpu().tolist() != [x * y % pm for x, y in zip(*hm)]:
            raise AssertionError("m31_mul at 2^24: sampled indices differ from Python ints")
        op_row("m31", ks.M31, "mul", (am, bm), "m31", ne, replay_sf(torch, h, ks, rec, err)[1][0])
        del a, b, am, bm, out
        # Goldilocks and smallfp64 (p62, mersenne61): mul and inv
        for label, fam, c, mul_fn, inv_fn, dec, pp in (
                ("goldilocks", "gl64", ks.GL64, tfp64.mul, lambda t: tfp64.inv(G, t), lambda v: v, G.modulus),
                *((s.name, "u64", s.consts, functools.partial(tsf64.mont_mul, s),
                   functools.partial(tsf64.inv, s), s.from_mont_int, s.modulus)
                  for s in (tsf64.SmallFp64Spec((1 << 62) - (1 << 16) + 1, 3, "p62"),
                            tsf64.SmallFp64Spec((1 << 61) - 1, 37, "mersenne61")))):
            a, b = u64_rand(pp, ne), u64_rand(pp, ne)
            ha = [dec(v) for v in host_u64(a, idx_t)]
            hb = [dec(v) for v in host_u64(b, idx_t)]
            for name, fn, want, op, args, e in (
                    ("mul", lambda: mul_fn(a, b), [x * y % pp for x, y in zip(ha, hb)], "mul", (a, b), None),
                    ("inv", lambda: inv_fn(a), [pow(x, pp - 2, pp) for x in ha], "pow", (a,), pp - 2)):
                out, _, launches = counted(fn, record=True)
                elem_launches.update(launches)
                if [dec(v) for v in host_u64(out, idx_t)] != want:
                    raise AssertionError(f"{label} {name} at 2^{SF_ELEM_LOG_N}: sampled indices differ")
                op_row(fam, c, op, args, label, ne, replay_sf(torch, h, ks, rec, err)[1][0], e)
            del a, b, out
        paths["small_field_elementwise"] = dict(elem_launches)
        emit("small_field_elementwise", n=ne, sampled=len(idx), correct=True,
             launches=dict(elem_launches), rows=rows["sf_op"])

        # -- the multi-device layer on a one-rank group ----------------------------
        store = _build.BUILD_DIR / f"dist_store_{os.getpid()}"
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        store.unlink(missing_ok=True)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        tdist.init_process_group(backend, store=tdist.FileStore(str(store), 1), rank=0, world_size=1)
        try:
            mesh = make_mesh(1)
            G1 = B.G1
            m = 1 << DIST_MSM_LOG_N
            px, py, ssc, kb, _bits = tt.tiled_inputs(G1, m, rng)
            want_pt = tt.expected_msm(G1, kb, ssc)
            A = affine_from_numpy(px, py, np.zeros(m, dtype=bool), dev)
            s_t = limbs_from_numpy(ssc, dev)
            got, first_ms, launches = counted(lambda: msm_sharded(G1, A, s_t, mesh))
            _, ms, _ = counted(lambda: msm_sharded(G1, A, s_t, mesh))
            ref, ref_ms, _ = counted(lambda: tmsm.msm(G1, A, s_t))
            if not all(torch.equal(u, v) for u, v in zip(got, ref)):
                raise AssertionError("msm_sharded on one rank: words differ from msm's")
            aff = tsw.xyzz_to_affine(G1, tsw.XYZZPoints(*(v[:, None] for v in got)))
            if tsw.affine_to_ints(G1, aff) != [want_pt]:
                raise AssertionError("msm_sharded on one rank differs from the host known answer")
            paths["msm_sharded"] = launches
            emit("msm_sharded", backend=backend, ranks=mesh.size, n=m, correct=True, first_call_ms=first_ms,
                 ms=ms, msm_ms=ref_ms, launches=launches)
            del A, s_t, px, py, got, ref
            FR = B.FR
            nf = 1 << DIST_FFT_LOG_N
            dom = Radix2Domain(FR, nf)
            xf = h.rand_field(FR, nf)
            want_f = dom.fft(xf)
            got_f, ms, launches = counted(lambda: fft_sharded(FR, xf, mesh, dom.group_gen_int))
            if not torch.equal(got_f, want_f) or not torch.equal(gather_shards(got_f, mesh), want_f):
                raise AssertionError("fft_sharded on one rank: words differ from Radix2Domain.fft's")
            _, dom_ms = h.once_ms(lambda: dom.fft(xf))
            paths["fft_sharded"] = launches
            emit("fft_sharded", backend=backend, ranks=mesh.size, n=nf, correct=True, ms=ms,
                 domain_fft_ms=dom_ms, launches=launches)
            del xf, want_f, got_f
        finally:
            tdist.destroy_process_group()
            store.unlink(missing_ok=True)

        # -- from_random_bytes --------------------------------------------------------
        nr = 1 << RB_LOG_N
        lanes = sorted({0, 1, nr - 1} | {int(i) for i in rng.integers(0, nr, RB_KAT)})
        G1, Fq = B.G1, B.FQ
        pq = Fq.modulus
        data = rng.integers(0, 256, size=(nr, field_byte_size(Fq, 2)), dtype=np.uint8)
        (pts, ok), ms, launches = counted(lambda: rb.sw_from_random_bytes(G1, data, device=dev))
        xs = fp.to_ints(Fq, pts.x[:, lanes])
        ys = fp.to_ints(Fq, pts.y[:, lanes])
        n_ok = 0
        for i, xv, yv in zip(lanes, xs, ys):
            v = int.from_bytes(bytes(data[i]), "little") & ((1 << Fq.bits) - 1)
            flags = int(data[i, -1]) & 0xC0
            if not ok[i]:
                continue
            n_ok += 1
            greatest = yv >= pq - yv  # the greatest root iff the negative flag is clear
            if (flags & 0x40 or xv != v or (yv * yv - xv ** 3 - G1.b_int) % pq
                    or greatest != (not flags & 0x80) and yv != 0):
                raise AssertionError(f"sw_from_random_bytes lane {i}: off the curve or the wrong root")
        paths["sw_from_random_bytes"] = launches
        emit("sw_from_random_bytes", curve=G1.name, n=nr, ok=int(ok.sum()), sampled_ok=n_ok,
             correct=True, ms=ms, launches=launches)
        J = ed_on_bls12_381.EDWARDS
        Fj = J.base
        pj = Fj.modulus
        data = rng.integers(0, 256, size=(nr, field_byte_size(Fj, 1)), dtype=np.uint8)
        (tpts, tok), ms, launches = counted(lambda: rb.te_from_random_bytes(J, data, device=dev))
        txs = fp.to_ints(Fj, tpts.x[:, lanes])
        tys = fp.to_ints(Fj, tpts.y[:, lanes])
        n_ok = 0
        for i, xv, yv in zip(lanes, txs, tys):
            if not tok[i]:
                continue
            n_ok += 1
            neg = int(data[i, -1]) & 0x80
            lhs = (J.a_int * xv * xv + yv * yv) % pj
            rhs = (1 + J.d_int * xv * xv * yv * yv) % pj
            if lhs != rhs or (xv >= pj - xv) != bool(neg) and xv != 0:
                raise AssertionError(f"te_from_random_bytes lane {i}: off the curve or the wrong root")
        paths["te_from_random_bytes"] = launches
        emit("te_from_random_bytes", curve=J.name, n=nr, ok=int(tok.sum()), sampled_ok=n_ok,
             correct=True, ms=ms, launches=launches)
        del pts, tpts, data

        # -- a derived struct: 2^16 G1 points and 2^16 Fr elements ------------------
        nd = 1 << DERIVE_LOG_N
        px, py, _, _, _ = tt.tiled_inputs(G1, nd, rng)
        P = affine_from_numpy(px, py, np.zeros(nd, dtype=bool), dev)
        ev = h.rand_field(B.FR, nd)

        @D.canonical(codecs={"pts": D.sw_points(G1, device=dev), "evals": D.fp_vec(B.FR, device=dev),
                             "label": D.STRING})
        class Proof:
            pts: object
            evals: object
            label: object

        pr = Proof(pts=P, evals=ev, label="phase15")
        sizes, walls = {}, {}
        for mode, tag in ((COMPRESSED_CHECKED, "compressed"), (UNCOMPRESSED_CHECKED, "uncompressed")):
            raw, ser_ms = h.once_ms(lambda: pr.serialize_with_mode(mode))
            back, de_ms = h.once_ms(lambda: Proof.deserialize_with_mode(raw, mode))
            if not (torch.equal(back.pts.x, P.x) and torch.equal(back.pts.y, P.y)
                    and torch.equal(back.evals, ev) and back.label == "phase15"
                    and back.serialize_with_mode(mode) == raw):
                raise AssertionError(f"derive round trip ({tag}) differs")
            sizes[tag], walls[tag] = len(raw), dict(serialize_ms=ser_ms, deserialize_ms=de_ms)
        emit("derive_round_trip", points=nd, field_elements=nd, bytes=sizes, ms=walls, correct=True)
        del P, ev, pr, back

        # -- xyzz_add_affine at p >= R/2: secp256r1 (a = -3) and secp256k1 -----------
        madd_rows, xyzz_add_rows = {}, {}
        for curve in (zoo.SECP256R1, zoo.SECP256K1):
            f = curve.base
            mod = f.modulus
            nm = 1 << MADD_TOP_LOG_N
            g = (curve.gen_x, curve.gen_y)
            pool = [tt.ec_mul(g, int(k), curve.a_int, mod) for k in rng.integers(1, 1 << 30, size=64)]
            ps, qs = [], []
            for i in range(64):
                u, v = pool[i], pool[(i * 7 + 3) % 64]
                cls = i % 6
                ps.append(None if cls in (3, 5) else u)
                qs.append(u if cls == 1 else tt.ec_neg(u, mod) if cls == 2 else None if cls in (4, 5) else v)
            tile = torch.arange(nm, device=dev) % 64
            Pk = tsw.xyzz_from_affine(curve, tsw.affine_from_ints(curve, ps, dev))
            Ak = tsw.affine_from_ints(curve, qs, dev)
            Pt = tsw.XYZZPoints(*(v[:, tile].contiguous() for v in Pk))
            At = tsw.AffinePoints(Ak.x[:, tile].contiguous(), Ak.y[:, tile].contiguous(), Ak.inf[tile])
            S, ms, launches = counted(lambda: tsw.xyzz_add_affine(curve, Pt, At))
            head = tsw.XYZZPoints(*(v[:, :64] for v in S))
            if tsw.affine_to_ints(curve, tsw.xyzz_to_affine(curve, head)) != [
                    tt.ec_add(u, v, curve.a_int, mod) for u, v in zip(ps, qs)]:
                raise AssertionError(f"xyzz_add_affine {curve.name}: sums differ from the host oracle")
            want_s, plain_ms = h.once_ms(lambda: ksw.xyzz_add_affine_plain(curve, Pt, At.x, At.y, At.inf))
            e = max(h.check_equal(f"xyzz_add_affine {curve.name} coordinate {i}", g_, w_)
                    for i, (g_, w_) in enumerate(zip(S, want_s)))
            err["xyzz_add_affine"] = max(err["xyzz_add_affine"], e)
            k_ms = h.time_ms(lambda: ksw.xyzz_add_affine(curve, Pt, At.x, At.y, At.inf), 10)
            L = f.num_limbs
            nw_ = L // 2
            mul, sqr, add = 4 * nw_ ** 2 + 3 * nw_, 3 * nw_ ** 2 + 4 * nw_, 3 * nw_
            ops_of = functools.partial(xyzz_ops, mul, sqr, add, a_is_zero=curve.a_is_zero)
            per = [ops_of("madd"), ops_of("mdbl"), ops_of("cancel"), 0, 0, 0]
            b_ms, b_by = h.bound((10 * L * 4 + 1) * nm, sum(per[i % 6] for i in range(64)) * nm // 64)
            madd_rows[curve.name] = dict(n=nm, classes=6, launches=launches, max_abs_err=e, ms=k_ms,
                                         wall_ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                         share_of_bound=b_ms / k_ms, route="PlainCallOps (p >= R/2)")
            # xyzz_add (PlainCallOps) on the same classes: P + A as XYZZ points
            Q = tsw.xyzz_from_affine(curve, At)
            got_a = ksw.xyzz_add(curve, Pt, Q)
            want_a, a_plain_ms = h.once_ms(lambda: ksw._fadd_plain(curve, tuple(Pt), tuple(Q)))
            e = max(h.check_equal(f"xyzz_add {curve.name} coordinate {i}", g_, w_)
                    for i, (g_, w_) in enumerate(zip(got_a, want_a)))
            err["xyzz_add"] = max(err["xyzz_add"], e)
            a_ms = h.time_ms(lambda: ksw.xyzz_add(curve, Pt, Q), 10)
            per_a = [ops_of("add"), ops_of("find") + ops_of("dbl"), ops_of("find"), 0, 0, 0]
            b_ms, b_by = h.bound(12 * L * 4 * nm, sum(per_a[i % 6] for i in range(64)) * nm // 64)
            xyzz_add_rows[curve.name] = dict(n=nm, classes=6, max_abs_err=e, ms=a_ms, plain_ms=a_plain_ms,
                                             bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / a_ms,
                                             route="PlainCallOps (p >= R/2)")
            del Q, got_a, want_a
            paths[f"xyzz_add_affine_{curve.name}"] = launches
            del Pk, Ak, Pt, At, S, want_s
        emit("xyzz_add_affine_top_bit", rows=madd_rows, xyzz_add_rows=xyzz_add_rows, correct=True)

        # -- the secp256r1 msm's PlainOps launches, timed against their bounds -----
        R1 = zoo.SECP256R1
        mr = 1 << R1_TIME_LOG_N
        px, py, ssc, kb, bits = tt.tiled_inputs(R1, mr, rng)
        want_pt = tt.expected_msm(R1, kb, ssc)
        A = affine_from_numpy(px, py, np.zeros(mr, dtype=bool), dev)
        s_t = limbs_from_numpy(ssc, dev)
        mrec = types.SimpleNamespace(on=False)
        restore_msm = install_msm_recorders(torch, mrec)
        try:
            mrec.on = True
            res, ms, launches = counted(lambda: tmsm.msm(R1, A, s_t, max_scalar_bits=bits))
            mrec.on = False
            calls = list(mrec.msm)
        finally:
            restore_msm()
        aff = tsw.xyzz_to_affine(R1, tsw.XYZZPoints(*(v[:, None] for v in res)))
        if tsw.affine_to_ints(R1, aff) != [want_pt]:
            raise AssertionError("secp256r1 msm: differs from the host known answer")
        replayed = replay_msm_launches(h, R1, calls)
        L = R1.base.num_limbs
        nw_ = L // 2
        mul, sqr, add = 4 * nw_ ** 2 + 3 * nw_, 3 * nw_ ** 2 + 4 * nw_, 3 * nw_
        plain_rows = collections.defaultdict(list)
        for (kernel, ins, extra), rr in zip(calls, replayed):
            err[kernel] = max(err[kernel], rr["max_abs_err"])
            if kernel == "xyzz_accum":
                fn = lambda: (ksw.xyzz_accum_grid if extra == "grid" else ksw.xyzz_accum_tiles)(R1, *ins)  # noqa: E731
            elif kernel == "horner_windows":
                fn = lambda: ksw.horner_windows(R1, ins[0], extra)  # noqa: E731
            elif kernel == "xyzz_bit_horner":
                fn = lambda: ksw.xyzz_bit_horner(R1, ins)  # noqa: E731
            elif kernel == "xyzz_tree_sum":
                fn = lambda: ksw.xyzz_tree_sum(R1, ins)  # noqa: E731
            else:
                fn = lambda: ksw._launch_xyzz(kernel, R1, *ins)  # noqa: E731
            k_ms = h.time_ms(fn, 5)
            out = fn()
            outs = out if isinstance(out, tuple) else (out,)
            nbytes = sum(t.numel() * t.element_size() for t in ins) + sum(
                t.numel() * t.element_size() for t in outs)
            b_ms, b_by = h.bound(nbytes, msm_launch_ops(R1, kernel, ins, extra, mul, sqr, add))
            plain_rows[kernel].append(dict(shape=rr["shape"], route=rr["route"], ms=k_ms,
                                           plain_ms=rr["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                                           share_of_bound=b_ms / k_ms, max_abs_err=rr["max_abs_err"]))
        paths["msm_secp256r1_plainops"] = launches
        emit("msm_secp256r1_plainops", curve=R1.name, n=mr, correct=True, ms=ms, launches=launches,
             rows=dict(plain_rows))
        del A, s_t, calls, replayed
    finally:
        restore()

    emit("phase15_launches", per_call=paths, max_abs_err=dict(err),
         seconds=time.perf_counter() - t_phase)
    report = {}
    for name in set(err) | {k for v in paths.values() for k in v}:
        report[name] = dict(launches={lbl: v[name] for lbl, v in paths.items() if v.get(name)},
                            max_abs_err=err.get(name, 0))
    for name in ("xyzz_accum", "horner_windows", "xyzz_bit_horner", "xyzz_add", "xyzz_tree_sum"):
        if plain_rows.get(name):
            report.setdefault(name, {})["plainops_secp256r1"] = plain_rows[name]
    report.setdefault("xyzz_add_affine", {})["plainops"] = madd_rows
    report.setdefault("xyzz_add", {})["plainops_edge_feed"] = xyzz_add_rows
    report["rows"] = rows
    return report


def xyzz_ops(mul, sqr, add, kind, a_is_zero=True):
    """32-bit operations of one XYZZ formula (csrc/field.cuh), given those
    of one Montgomery product (``mul``), square (``sqr``) and field addition
    (``add``); a square counts as a square, as mont_sqr's bound does. Kinds:
    "madd" (mmadd-xyzz: 8 products, 2 squares, 7 additions), "mdbl" (the
    madd's doubling branch: finding P == A, 2 products and 2 additions, then
    mdbl-2008-s-1, 4 products and 3 squares), "cancel" (finding P == -A),
    "dbl" (dbl-2008-s-1: 6 products, 3 squares, 7 additions), "add"
    (add-2008-s: 12 products, 2 squares, 7 additions), "find" (add-2008-s
    up to P == +-Q: 4 products, 2 additions). a != 0 adds to "dbl" the
    square of ZZ, its product by a and one addition, to "mdbl" one addition."""
    m, s, a = {"madd": (8, 2, 7), "mdbl": (6, 3, 9), "cancel": (2, 0, 2), "dbl": (6, 3, 7),
               "add": (12, 2, 7), "find": (4, 0, 2)}[kind]
    if not a_is_zero and kind == "dbl":
        m, s, a = m + 1, s + 1, a + 1
    elif not a_is_zero and kind == "mdbl":
        a += 1
    return m * mul + s * sqr + a * add


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from zkarray_torch import kernels
    from zkarray_torch.core.limbs import pack_pairs
    from zkarray_torch.curves import bls12_381 as B
    from zkarray_torch.ec import msm as tmsm
    from zkarray_torch.ec import sw as tsw
    from zkarray_torch.ff import fp
    from zkarray_torch.interop import affine_from_numpy, limbs_from_numpy
    from zkarray_torch.kernels import _build
    from zkarray_torch.kernels import mont as km
    from zkarray_torch.kernels import sw as ksw
    from zkarray_torch.poly import domain as tdm
    from zkarray_torch.testing import (accum_edge_rounds, accum_feed, bit_horner_edge_parts, ec_add,
                                       ec_mul, ec_neg, expected_msm, horner_edge_windows,
                                       mont_inv_chain, mont_inv_edge_words, mont_inv_model,
                                       mont_inv_ops, tiled_inputs)

    dev = torch.device(DEVICE)
    G1 = B.G1
    FQ, FR = B.FQ, B.FR
    gen = torch.Generator(device=dev).manual_seed(1234)

    # ---- 1. header and build ----------------------------------------------
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    int_ops_per_s = props.multi_processor_count * INT32_LANES_PER_SM * clock_mhz * 1e6
    emit("header", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         sms=props.multi_processor_count, max_sm_clock_mhz=clock_mhz,
         int32_ops_per_s=int_ops_per_s, hbm_bytes_per_s=HBM_BYTES_PER_S,
         host_cpu=host_cpu_model(), host_arch=platform.machine(),
         host_cpus_usable=len(os.sched_getaffinity(0)))
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    probe_src = _build.BUILD_DIR / "sass_probe.cu"
    probe_src.write_text(SASS_PROBE)
    probe_bin = probe_src.with_suffix(".cubin")
    probe = subprocess.Popen(  # built beside the sources, at the same time
        [_build._nvcc(), *_build.NVCC_FLAGS[:4], "-cubin", "-I", str(_build.CSRC), "-o",
         str(probe_bin), str(probe_src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lat_src = _build.BUILD_DIR / "latency_probe.cu"
    lat_src.write_text(LATENCY_PROBE)
    lat_lib = lat_src.with_suffix(".so")
    lat = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lat_lib), str(lat_src)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = _build.build()
    build_s = time.perf_counter() - t0
    probe_log, _ = probe.communicate()
    if probe.returncode != 0:
        raise RuntimeError(f"nvcc failed for the SASS probe:\n{probe_log}")
    lat_log, _ = lat.communicate()
    if lat.returncode != 0:
        raise RuntimeError(f"nvcc failed for the latency probe:\n{lat_log}")
    ptxas = {}
    for name in _build.SOURCES:
        log_path = _build.lib_path(name).with_suffix(".ptxas.txt")
        ptxas.update(parse_ptxas(log_path.read_text()))
    emit("build", seconds=build_s, per_source={k: v["seconds"] for k, v in built.items()},
         ptxas=ptxas)

    # instructions per field operation (probe minus probe_none) and the code
    # size of the two sw.cu kernels, NW = 12
    probes = sass_functions(probe_bin)
    base = probes["probe_none"]
    per_op = {k[len("probe_"):]: dict(instructions=v["instructions"] - base["instructions"],
                                      imad=v["imad"] - base["imad"], opcodes=v["opcodes"])
              for k, v in probes.items() if k not in ("probe_none", "probe_horner_serial")}
    sw_sass = sass_functions(_build.lib_path("sw"))

    def sw_kernel(stem):
        hits = [(k, v) for k, v in sw_sass.items() if f"{stem}ILi12E" in k and "PlainOps" not in k]
        return dict(function=hits[0][0], **hits[0][1]) if hits else None

    def ptxas_of(stem):
        return next((v for k, v in ptxas.items() if f"{stem}ILi12E" in k and "PlainOps" not in k), {})

    # the xyzz.cu and madd.cu kernels, NW = 12: registers, spills, SASS size
    xyzz_kernels = {}
    for src, stems in (("xyzz", ("xyzz_add_kernel", "xyzz_tree_sum_kernel", "xyzz_double_kernel")),
                       ("madd", ("xyzz_add_affine_kernel",))):
        code = sass_functions(_build.lib_path(src))
        for stem in stems:
            hit = next((v for k, v in code.items() if f"{stem}ILi12E" in k and "PlainOps" not in k), {})
            xyzz_kernels[stem] = dict(ptxas_of(stem), sass_instructions=hit.get("instructions"),
                                      imad=hit.get("imad"))
    sass = dict(per_op_nw12=per_op, horner_serial_code=probes["probe_horner_serial"],
                horner_windows_code=sw_kernel("horner_windows_kernel"),
                chain_mul_code=sw_kernel("chain_mul"), xyzz_accum_code=sw_kernel("xyzz_accum_kernel"),
                xyzz_kernels_nw12=xyzz_kernels)
    emit("sass", **sass)
    add_cycles = add_latency_cycles(torch, lat_lib)
    emit("latency", cycles_per_dependent_carried_add=add_cycles, max_sm_clock_mhz=clock_mhz,
         ns_per_dependent_carried_add=add_cycles / clock_mhz * 1e3)

    # ---- helpers -------------------------------------------------------------
    def sync():
        torch.cuda.synchronize()

    def time_ms(fn, iters):
        fn()
        sync()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / iters

    def once_ms(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t) * 1e3

    def rand_field(spec, n):
        """(L, n) canonical limbs below p: p's top nonzero limb t random below
        p's, the limbs above t zero (a 298-bit p in L = 20 limbs has two)."""
        L = spec.num_limbs
        t = (spec.modulus.bit_length() - 1) // 16
        x = torch.randint(0, 1 << 16, (L, n), generator=gen, device=dev, dtype=torch.int32)
        x[t] = torch.randint(0, spec.modulus >> (16 * t), (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        x[t + 1:] = 0
        return x

    def max_abs_err(a, b):
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    def check_equal(what, got, want):
        err = max_abs_err(got, want)
        if err != 0 or got.shape != want.shape:
            raise AssertionError(f"{what}: kernel differs from plain (max abs err {err})")
        return err

    def nw(spec):
        return spec.num_limbs // 2

    def mul_ops(spec):  # 32-bit ops of one CIOS product: 2 NW^2 + 2 NW^2 + NW, cond-sub 2 NW
        return 4 * nw(spec) ** 2 + 3 * nw(spec)

    def sqr_ops(spec):  # one Montgomery square: each cross product once, NW^2 + NW; then as mul_ops
        return 3 * nw(spec) ** 2 + 4 * nw(spec)

    def pow_ops(spec, e):  # mont_pow's chain: a square per bit below the top, a product per set bit
        return (e.bit_length() - 1) * sqr_ops(spec) + bin(e).count("1") * mul_ops(spec) if e else 0

    def add_ops(spec):  # carry chain + conditional subtract/add
        return 3 * nw(spec)

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / int_ops_per_s * 1e3
        return (max(tb, to), "bytes" if tb >= to else "operations")

    def strided_field(spec, shape, strides):
        """Random canonical limbs viewed with the given batch strides: limb k
        of every element in row k of an (L, width) buffer."""
        need = 1 + sum((s - 1) * st for s, st in zip(shape[1:], strides[1:]))
        ld = max(strides[0], need)
        return torch.as_strided(rand_field(spec, ld), shape, (ld,) + tuple(strides[1:]))

    def distinct_elems(t):
        """Batch elements a product kernel reads for operand ``t``: a
        broadcast (outer = 0) reads its inner run only."""
        _, _, inner, outer = km._operand(t)
        return inner if outer == 0 else t[0].numel()

    def per_launch_means(rows, shape):
        """A kernel's path figures from its per-shape rows, weighted by launches."""
        n_l = sum(r["launches"] for r in rows)
        tb = sum(r["launches"] * r["bound_bytes_ms"] for r in rows)
        to = sum(r["launches"] * r["bound_ops_ms"] for r in rows)
        return dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                    ms=sum(r["launches"] * r["ms"] for r in rows) / n_l,
                    plain_ms=sum(r["launches"] * r["plain_ms"] for r in rows) / n_l,
                    bound_ms=max(tb, to) / n_l, bound_by="bytes" if tb >= to else "operations",
                    ms_path_total=sum(r["launches"] * r["ms"] for r in rows), shape=shape)

    report = {}

    # ---- 2. kernel vs plain --------------------------------------------------
    n = 1 << LOG_N
    for spec in (FQ, FR):
        L = spec.num_limbs
        a, b = rand_field(spec, n), rand_field(spec, n)
        for name, kern, plain, args, n_in in (
            ("mont_mul", km.mont_mul, km.mont_mul_plain, (a, b), 2),
            ("mont_sqr", km.mont_sqr, km.mont_sqr_plain, (a,), 1),
        ):
            got = kern(spec, *args)
            want = plain(spec, *args)
            err = check_equal(f"{name} {spec.name}", got, want)
            ms = time_ms(lambda: kern(spec, *args), 20)
            plain_ms = time_ms(lambda: plain(spec, *args), 2)
            ops = n * (sqr_ops if name == "mont_sqr" else mul_ops)(spec)
            b_ms, b_by = bound((n_in + 1) * L * n * 4, ops)
            emit("kernel", kernel=name, field=spec.name, n=n, max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            if spec is FQ:
                report[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, shape=f"Fq, {n} elements")
        del a, b

    # xyzz_accum and horner_windows: each feed checked bit for bit against
    # the plain version, with the wrapper's wall ms (host clock, median of
    # 3), device ms (CUDA events), the bound, and the kernel's registers,
    # resident blocks per SM and waves
    f = FQ
    L = f.num_limbs
    ops_of = functools.partial(xyzz_ops, mul_ops(f), sqr_ops(f), add_ops(f),
                               a_is_zero=G1.a_is_zero)
    madd_ops, dbl_ops = ops_of("madd"), ops_of("dbl")
    fadd_ops = ops_of("add")  # generic windows: no doubling branch
    sw_lib = _build.load("sw")
    occ_blocks, occ_threads = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(sw_lib, sw_lib.zk_xyzz_accum_occupancy(nw(f), ctypes.addressof(occ_blocks),
                                                        ctypes.addressof(occ_threads)),
                 "xyzz_accum occupancy")
    resident = occ_blocks.value * occ_threads.value * props.multi_processor_count
    accum_ptxas = ptxas_of("xyzz_accum_kernel")

    def wrapper_ms(fn):
        return sorted(once_ms(fn)[1] for _ in range(3))[1]

    def accum_row(label, state, coords, vwords, tiles_too=False):
        got = ksw.xyzz_accum_grid(G1, state, coords, vwords)
        want, plain_ms = once_ms(lambda: ksw.xyzz_accum_plain(G1, state, coords, vwords))
        err = check_equal(f"xyzz_accum {label}", got, want)
        if tiles_too:
            err = max(err, check_equal(f"xyzz_accum {label} via xyzz_accum_tiles",
                                       ksw.xyzz_accum_tiles(G1, state, coords, vwords), want))
        del got, want
        run = lambda: ksw.xyzz_accum_grid(G1, state, coords, vwords)  # noqa: E731
        w_ms, ms = wrapper_ms(run), time_ms(run, 3)
        n_adds = int((vwords & 1).sum())
        b_ms, b_by = bound((coords.numel() + vwords.numel() + 2 * state.numel()) * 4,
                           n_adds * madd_ops)
        S = state.shape[1]
        row = dict(feed=label, slots=S, rounds=coords.shape[1], valid_adds=n_adds,
                   max_abs_err=err, ms=ms, wrapper_ms=w_ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, share_of_bound=b_ms / ms, ns_per_add=ms * 1e6 / max(n_adds, 1),
                   registers=accum_ptxas.get("registers"),
                   spill_stores=accum_ptxas.get("spill_stores"),
                   spill_loads=accum_ptxas.get("spill_loads"), blocks_per_sm=occ_blocks.value,
                   threads_per_block=occ_threads.value, waves=S / resident)
        emit("kernel", kernel="xyzz_accum", **row)
        return row

    def horner_row(label, win, c):
        got = ksw.horner_windows(G1, win, c)
        want, plain_ms = once_ms(lambda: ksw.horner_windows_plain(G1, win, c))
        err = check_equal(f"horner_windows {label}", got, want)
        run = lambda: ksw.horner_windows(G1, win, c)  # noqa: E731
        w_ms, ms = wrapper_ms(run), time_ms(run, 5)
        Wn = win.shape[0]
        b_ms, b_by = bound((win.numel() + got.numel()) * 4, (Wn - 1) * (c * dbl_ops + fadd_ops))
        products, depth = (Wn - 1) * (9 * c + 14), (Wn - 1) * (3 * c + 4)
        row = dict(feed=label, W=Wn, c=c, max_abs_err=err, ms=ms, wrapper_ms=w_ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, products=products,
                   critical_path_products=depth, us_per_product=ms * 1e3 / products,
                   us_per_critical_product=ms * 1e3 / depth)
        emit("kernel", kernel="horner_windows", **row)
        return row, got

    # edge classes on random field elements (the formulas need no curve
    # membership to be compared), per slot s % 11, over a slot count that is
    # not a multiple of 32 or of the block
    S, R = EDGE_SLOTS, EDGE_ROUNDS
    one = fp.one(f, (S,), dev).contiguous()
    zero = fp.zero(f, (S,), dev)
    AX = [rand_field(f, S) for _ in range(R)]
    AY = [rand_field(f, S) for _ in range(R)]
    X, Y, ZZ, ZZZ = (rand_field(f, S) for _ in range(4))
    cls = torch.arange(S, device=dev) % 11
    valid = (torch.rand((R, S), generator=gen, device=dev) < 0.75).to(torch.int32)
    sign = torch.randint(0, 2, (R, S), generator=gen, device=dev, dtype=torch.int32)

    def on(c):
        return torch.isin(cls, torch.tensor(c, device=dev))[None]

    AY[0] = torch.where(on([8]), zero, AY[0])  # doubling a y == 0 point
    same = on([1, 2, 8])  # P == A (sign 0) or P == -A (sign 1) in round 0
    X = torch.where(same, AX[0], X)
    Y = torch.where(same, AY[0], Y)
    X = torch.where(on([9]), AX[1], X)  # 9: P == A in round 1, round 0 skipped
    Y = torch.where(on([9]), AY[1], Y)
    ZZ = torch.where(same | on([9]), one, ZZ)
    ZZZ = torch.where(same | on([9]), one, ZZZ)
    p_inf = on([3, 5])  # bucket at infinity
    X, Y = torch.where(p_inf, one, X), torch.where(p_inf, one, Y)
    ZZ, ZZZ = torch.where(p_inf, zero, ZZ), torch.where(p_inf, zero, ZZZ)
    valid[0] = torch.where(on([4, 5, 9])[0], 0, 1)  # A at infinity in round 0
    valid[1] = torch.where(on([9])[0], 1, valid[1])
    sign[0] = torch.where(on([2, 6])[0], 1, torch.where(on([1, 8])[0], 0, sign[0]))
    sign[1] = torch.where(on([9])[0], 0, sign[1])
    valid[:, cls == 7] = 0  # a slot with no point in any round
    valid[R // 2 :, cls == 10] = 0  # a slot whose last rounds are all empty
    state = torch.cat([pack_pairs(v) for v in (X, Y, ZZ, ZZZ)]).contiguous()
    coords = torch.stack([pack_pairs(torch.cat([x, y])) for x, y in zip(AX, AY)], dim=1).contiguous()
    vwords = (valid | (sign << 1)).contiguous()
    accum_rows = {"edge classes": accum_row("edge classes", state, coords, vwords, tiles_too=True)}
    del AX, AY, X, Y, ZZ, ZZZ, coords, state

    # testing.accum_edge_rounds: real points, doubling and cancel with ZZ != 1
    P0, rounds = accum_edge_rounds(G1, ORACLE_SLOTS, ORACLE_ROUNDS, np.random.default_rng(3))
    accum_rows["oracle edge rounds"] = accum_row("oracle edge rounds", *accum_feed(G1, P0, rounds, dev),
                                                 tiles_too=True)
    del P0, rounds

    # the main path's band-1 shape (c = 13 at 2^20 points), random feed
    cw = tmsm.default_window_size(n)
    Wb, halfb, _, _ = tmsm._window_geometry(cw, 16 * FR.num_limbs - 2)
    R1, _ = tmsm._accum_bounds(cw, n, tmsm.ACCUM_T)
    S1 = Wb * halfb
    state = torch.cat([pack_pairs(rand_field(f, S1)) for _ in range(4)]).contiguous()
    coords = torch.cat([pack_pairs(rand_field(f, R1 * S1)) for _ in range(2)]).reshape(L, R1, S1)
    valid = (torch.rand((R1, S1), generator=gen, device=dev) < 0.9).to(torch.int32)
    vwords = (valid | (torch.randint(0, 2, (R1, S1), generator=gen, device=dev,
                                     dtype=torch.int32) << 1)).contiguous()
    band1 = accum_rows["band-1 shape"] = accum_row("band-1 shape", state, coords, vwords)
    report["xyzz_accum"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in accum_rows.values()), ms=band1["ms"],
        plain_ms=band1["plain_ms"], bound_ms=band1["bound_ms"], bound_by=band1["bound_by"],
        shape=f"{S1} slots x {R1} rounds (band-1 shape, random feed)",
        wrapper_ms=band1["wrapper_ms"], ns_per_add=band1["ns_per_add"],
        share_of_bound=band1["share_of_bound"], registers=band1["registers"],
        spill_stores=band1["spill_stores"], blocks_per_sm=band1["blocks_per_sm"],
        threads_per_block=band1["threads_per_block"], waves=band1["waves"])
    del state, coords, valid, vwords

    # horner_windows at W = 20, c = 13: random windows with window 5 at
    # infinity, and testing.horner_edge_windows (checked against the oracle)
    Wh, ch = 20, 13
    win = torch.cat([rand_field(f, Wh) for _ in range(4)]).T.contiguous()  # (W, 4L)
    win[5, 2 * L :] = 0
    horner_rows = {"random windows": horner_row("random windows", win, ch)[0]}
    win, total = horner_edge_windows(G1, Wh, ch, np.random.default_rng(4), dev)
    horner_rows["oracle edge windows"], got = horner_row("oracle edge windows", win, ch)
    res = tsw.XYZZPoints(*(got[i * L : (i + 1) * L, None] for i in range(4)))
    if tsw.affine_to_ints(G1, tsw.xyzz_to_affine(G1, res)) != [total]:
        raise AssertionError("horner_windows edge windows: total differs from the host oracle")
    rnd = horner_rows["random windows"]
    report["horner_windows"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in horner_rows.values()), ms=rnd["ms"],
        plain_ms=rnd["plain_ms"], bound_ms=rnd["bound_ms"], bound_by=rnd["bound_by"],
        shape=f"W={Wh}, c={ch}, random windows", wrapper_ms=rnd["wrapper_ms"],
        us_per_product=rnd["us_per_product"], registers=ptxas_of("horner_windows_kernel").get("registers"))

    # ---- 3. main path: msm at 2^20 --------------------------------------------
    rng = np.random.default_rng(0)
    px, py, sc, ks, bits = tiled_inputs(G1, n, rng)
    want_pt = expected_msm(G1, ks, sc)
    A = affine_from_numpy(px, py, np.zeros(n, dtype=bool), dev)
    s = limbs_from_numpy(sc, dev)
    c = tmsm.default_window_size(n)
    W, half, _, _ = tmsm._window_geometry(c, bits)
    r1b, r2b = tmsm._accum_bounds(c, n, tmsm.ACCUM_T)

    def to_affine(res):
        return tsw.xyzz_to_affine(G1, tsw.XYZZPoints(*(v[:, None] for v in res)))

    # every product-kernel launch's (kernel, field, shape) and every
    # xyzz_add/xyzz_double launch's (kernel, shape, operand maps), recorded
    # around the wrappers' own launch functions (the counts stay where they
    # are), with the inputs of the first launch of each xyzz key as the run
    # passed them; the band-2 accumulation's arguments and the window rows
    mont_shapes = collections.Counter()
    xyzz_keys = collections.Counter()
    xyzz_inputs = {}
    tree_keys = collections.Counter()
    tree_inputs = {}
    band2, path_win, div_inputs, bit_horner_inputs = [], [], [], []
    launch, launch_xyzz, accum_grid = km._launch, ksw._launch_xyzz, ksw.xyzz_accum_grid
    horner, tree_sum, bit_horner = ksw.horner_windows, ksw.xyzz_tree_sum, ksw.xyzz_bit_horner
    launch_div = km._launch_div

    def recording_launch(kernel, spec, *ins, **kw):
        mont_shapes[(kernel, spec.name, tuple(ins[0].shape))] += 1
        return launch(kernel, spec, *ins, **kw)

    def recording_div(spec, *ins):
        div_inputs.append(ins)
        return launch_div(spec, *ins)

    def recording_xyzz(kernel, curve, *coords):
        key = (kernel, tuple(coords[0].shape), tuple(tuple(km._operand(t)[1:]) for t in coords))
        xyzz_keys[key] += 1
        xyzz_inputs.setdefault(key, coords)
        return launch_xyzz(kernel, curve, *coords)

    def recording_tree(curve, P):
        key = (tuple(P[0].shape), tuple(tuple(km._operand(t)[1:]) for t in P))
        tree_keys[key] += 1
        tree_inputs.setdefault(key, tuple(P))
        return tree_sum(curve, P)

    def recording_accum(curve, state, coords, valid):
        if coords.shape[1] == r2b:
            band2.append((state, coords, valid))
        return accum_grid(curve, state, coords, valid)

    def recording_horner(curve, win, c):
        path_win.append(win)
        return horner(curve, win, c)

    def recording_bit_horner(curve, parts):
        bit_horner_inputs.append(tuple(parts))
        return bit_horner(curve, parts)

    torch.cuda.reset_peak_memory_stats()
    sync()
    km._launch, ksw._launch_xyzz, ksw.xyzz_accum_grid = recording_launch, recording_xyzz, recording_accum
    ksw.horner_windows, ksw.xyzz_tree_sum = recording_horner, recording_tree
    ksw.xyzz_bit_horner, km._launch_div = recording_bit_horner, recording_div
    try:
        kernels.reset_launches()
        aff = to_affine(tmsm.msm(G1, A, s, c, bits))
        sync()
        launches = dict(kernels.LAUNCHES)
    finally:
        km._launch, ksw._launch_xyzz, ksw.xyzz_accum_grid = launch, launch_xyzz, accum_grid
        ksw.horner_windows, ksw.xyzz_tree_sum = horner, tree_sum
        ksw.xyzz_bit_horner, km._launch_div = bit_horner, launch_div
    msm_peak = torch.cuda.max_memory_allocated()
    got_pt = tsw.affine_to_ints(G1, aff)[0]
    if got_pt != want_pt:
        raise AssertionError("msm 2^20: result differs from the host known answer")
    msm_kernels = ("mont_div", "xyzz_add", "xyzz_bit_horner", "xyzz_tree_sum", "xyzz_accum",
                   "horner_windows")
    missing = [k for k in msm_kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"msm 2^20: kernels never launched: {missing}")
    for name in ("mont_mul", "mont_sqr", "mont_pow", "mont_inv"):
        recorded = sum(v for (k, _, _), v in mont_shapes.items() if k == name)
        if recorded != launches[name]:
            raise AssertionError(f"{name}: {recorded} launches recorded, {launches[name]} counted")
    for name in ("xyzz_add", "xyzz_double"):
        recorded = sum(v for (k, _, _), v in xyzz_keys.items() if k == name)
        if recorded != launches[name]:
            raise AssertionError(f"{name}: {recorded} launches recorded, {launches[name]} counted")
    if sum(tree_keys.values()) != launches["xyzz_tree_sum"]:
        raise AssertionError(f"xyzz_tree_sum: {sum(tree_keys.values())} launches recorded, "
                             f"{launches['xyzz_tree_sum']} counted")
    # the reduce's launches by its route: per group of weight bits, one
    # xyzz_add per tree level wider than TREE_SUM_MAX and one xyzz_tree_sum;
    # one xyzz_bit_horner for all the bits and windows. The to-affine is one
    # mont_div launch: no mont_mul, mont_inv or mont_pow
    nbits = int(tmsm._bucket_weights(c, bits).max()).bit_length()
    groups = -(-nbits // tmsm._bits_per_group(G1.base.num_limbs, W, half, nbits))
    wide, m_ = 0, half
    while m_ > ksw.TREE_SUM_MAX:
        wide, m_ = wide + 1, m_ - m_ // 2
    reduce_want = {"xyzz_add": groups * wide, "xyzz_tree_sum": groups, "xyzz_bit_horner": 1,
                   "xyzz_double": 0, "mont_div": 1, "mont_mul": 0, "mont_inv": 0, "mont_pow": 0}
    if any(launches[k] != v for k, v in reduce_want.items()):
        raise AssertionError(f"msm 2^{LOG_N}: reduce and to-affine launches "
                             f"{ {k: launches[k] for k in reduce_want} }, expected {reduce_want}")
    if launches["mont_mul"] + launches["mont_sqr"] >= 100:
        raise AssertionError(f"msm 2^20: {launches['mont_mul'] + launches['mont_sqr']} product "
                             "launches; the fused kernels should leave fewer than 100")
    if not band2 or len(path_win) != 1 or len(bit_horner_inputs) != 1 or len(div_inputs) != 1:
        raise AssertionError("msm 2^20: no band-2 accumulation, window Horner, bit-Horner or "
                             "to-affine division recorded")

    # mont_mul against its plain version at every main-path shape, inputs the
    # two halves of a tensor twice as wide in its last axis (non-contiguous)
    specs = {FQ.name: FQ, FR.name: FR}
    kerns = {"mont_mul": (km.mont_mul, km.mont_mul_plain, 2),
             "mont_sqr": (km.mont_sqr, km.mont_sqr_plain, 1)}
    at_shape = {"mont_mul": [], "mont_sqr": []}
    for (name, fname, shape), count in sorted(mont_shapes.items(), key=lambda kv: -math.prod(kv[0][2])):
        if name not in kerns:
            continue  # mont_pow, mont_inv: held against their plain versions below
        spec = specs[fname]
        kern, plain, n_in = kerns[name]
        L, batch = shape[0], shape[1:]
        m = math.prod(batch)
        wide = rand_field(spec, 2 * m).reshape((L,) + batch[:-1] + (2 * batch[-1],))
        halves = (wide[..., : batch[-1]], wide[..., batch[-1] :])[:n_in]
        got = kern(spec, *halves)
        err = check_equal(f"{name} {fname} at {shape}", got, plain(spec, *halves))
        ms = time_ms(lambda: kern(spec, *halves), 20)
        plain_ms = time_ms(lambda: plain(spec, *halves), 2)
        ops = m * (sqr_ops if name == "mont_sqr" else mul_ops)(spec)
        tb, to = (n_in + 1) * L * m * 4 / HBM_BYTES_PER_S * 1e3, ops / int_ops_per_s * 1e3
        at_shape[name].append(dict(field=fname, shape=list(shape), launches=count, max_abs_err=err,
                                   ms=ms, plain_ms=plain_ms, bound_bytes_ms=tb, bound_ops_ms=to))
    for name, rows in at_shape.items():
        if not rows:
            continue  # off the MSM path: its path figures come from the fft
        emit("kernel_main_path_shapes", kernel=name, inputs="non-contiguous halves", rows=rows)
        means = per_launch_means(rows, f"mean per launch over the main path's {len(rows)} shapes")
        means["max_abs_err"] = max(report[name]["max_abs_err"], means["max_abs_err"])
        report[name].update(ms_2e20=report[name]["ms"], **means, ms_widest=rows[0]["ms"],
                            widest_shape=rows[0]["shape"])

    # xyzz_add / xyzz_double against _fadd_plain / _dbl_plain on the inputs
    # of the first launch of each recorded (shape, operand maps), strided as
    # the tree sums and the bit-Horner passed them; the bound counts the
    # operations those inputs need, lane by lane
    f = FQ
    Lq = f.num_limbs
    dbl_ops, find_ops = ops_of("dbl"), ops_of("find")  # find: U1, U2, S1, S2, P', R

    def add_lane_ops(P, Q):
        """xyzz_add's operations on these inputs: none on a lane at
        infinity; the generic formula; or finding P == +-Q, then the doubling
        where P == Q and y != 0."""
        fin = ~fp.is_zero(f, P[2]) & ~fp.is_zero(f, Q[2])
        p0 = fp.eq(km.mont_mul(f, P[0], Q[2]), km.mont_mul(f, Q[0], P[2]))
        r0 = fp.eq(km.mont_mul(f, P[1], Q[3]), km.mont_mul(f, Q[1], P[3]))
        dbl = fin & p0 & r0 & ~fp.is_zero(f, P[1])
        return (int((fin & ~p0).sum()) * fadd_ops + int((fin & p0).sum()) * find_ops
                + int(dbl.sum()) * dbl_ops)

    def dbl_lane_ops(P):
        return int((~fp.is_zero(f, P[2]) & ~fp.is_zero(f, P[1])).sum()) * dbl_ops

    xyzz_fns = {"xyzz_add": (ksw.xyzz_add, ksw._fadd_plain, add_lane_ops, 12),
                "xyzz_double": (ksw.xyzz_double, ksw._dbl_plain, dbl_lane_ops, 8)}

    def xyzz_row(name, pts, what):
        """Kernel against plain on points ``pts``: (error, ms, plain ms,
        byte-bound ms, operation-bound ms)."""
        kern, plain, lane_ops, coords = xyzz_fns[name]
        got, want = kern(G1, *pts), plain(G1, *pts)
        err = max(check_equal(f"{name} {what}, coordinate {i}", g, w_)
                  for i, (g, w_) in enumerate(zip(got, want)))
        ms = time_ms(lambda: kern(G1, *pts), 20)
        plain_ms = time_ms(lambda: plain(G1, *pts), 2)
        m = pts[0][0][0].numel()
        return (err, ms, plain_ms, coords * Lq * m * 4 / HBM_BYTES_PER_S * 1e3,
                lane_ops(*pts) / int_ops_per_s * 1e3)

    xyzz_rows = {"xyzz_add": [], "xyzz_double": []}
    for key, count in sorted(xyzz_keys.items(), key=lambda kv: -math.prod(kv[0][1])):
        name, shape, maps = key
        coords = xyzz_inputs[key]
        pts = (coords[:4], coords[4:]) if name == "xyzz_add" else (coords[:4],)
        err, ms, plain_ms, tb, to = xyzz_row(name, pts, f"at {shape} {maps}")
        xyzz_rows[name].append(dict(role="tree level" if len(shape) > 2 else "bit-Horner",
                                    shape=list(shape), operand_maps=[list(mp) for mp in maps],
                                    launches=count, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    bound_bytes_ms=tb, bound_ops_ms=to))
    del xyzz_inputs
    for name, rows in xyzz_rows.items():
        if not rows:
            continue  # xyzz_double: off the path, timed below
        emit("kernel_main_path_shapes", kernel=name, inputs="the main path's own, as it passed them",
             rows=rows)
        report[name] = per_launch_means(
            rows, f"mean per launch over the main path's {len(rows)} shapes and operand maps")
    # xyzz_double left the path with the bit-Horner's 12 launches: timed at
    # their (L, W) shape on the path's top partials, as the first of them
    # was launched (a strided view)
    top = tuple(v[:, -1] for v in bit_horner_inputs[0])
    err, ms, plain_ms, tb, to = xyzz_row("xyzz_double", (top,), "on the bit-Horner's top partials")
    report["xyzz_double"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(tb, to),
        bound_by="bytes" if tb >= to else "operations",
        shape=f"{list(top[0].shape)}, the bit-Horner's top partials (its launches before "
              "xyzz_bit_horner)")
    del top
    for role in ("tree level", "bit-Horner"):
        rows = [r for r in xyzz_rows["xyzz_add"] if r["role"] == role]
        if rows:
            report["xyzz_add"][role.replace(" ", "_").replace("-", "_")] = per_launch_means(
                rows, f"mean per launch over its {len(rows)} shapes")

    # xyzz_tree_sum against its plain version on the recorded inputs, with
    # a bound from the operations its levels need on them (each level's
    # lane classes, counted level by level with the element-wise kernel) and
    # the longest thread's dependent adds for the chain bound
    def tree_levels(m):
        hs = []
        while m > 1:
            hs.append(m // 2)
            m -= m // 2
        return hs

    def tree_ops(P):
        ops, m = 0, P[0].shape[-1]
        while m > 1:
            h = m // 2
            lo, hi = tuple(v[..., :h] for v in P), tuple(v[..., h : 2 * h] for v in P)
            ops += add_lane_ops(lo, hi)
            red = ksw.xyzz_add(G1, lo, hi)
            if m % 2:
                red = tuple(torch.cat([a, v[..., 2 * h :]], dim=-1) for a, v in zip(red, P))
            m -= h
            P = red
        return ops

    xyzz_lib = _build.load("xyzz")

    def tree_occupancy(m, plain=False):
        """(resident blocks per SM, threads per block) of xyzz_tree_sum at
        row width m, its CallOps (or PlainCallOps) instantiation, NW = 12."""
        blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
        _build.check(xyzz_lib, xyzz_lib.zk_xyzz_tree_sum_occupancy(
            nw(f), int(plain), m, ctypes.addressof(blocks), ctypes.addressof(threads)),
            "xyzz_tree_sum occupancy")
        return blocks.value, threads.value

    def tree_row(P, what, launches_=0):
        got, want = ksw.xyzz_tree_sum(G1, P), ksw.xyzz_tree_sum_plain(G1, P)
        err = max(check_equal(f"xyzz_tree_sum {what}, coordinate {i}", g, w_)
                  for i, (g, w_) in enumerate(zip(got, want)))
        ms = time_ms(lambda: ksw.xyzz_tree_sum(G1, P), 20)
        plain_ms = time_ms(lambda: ksw.xyzz_tree_sum_plain(G1, P), 2)
        m = P[0].shape[-1]
        rows_ = P[0][0].numel() // m
        blocks, _ = tree_occupancy(m)
        hs = tree_levels(m)
        # chain: the kernel's rounds, TREE_QUADS adds a block at once, each
        # ADD_DEPTH products deep; and one add a level (no design does less)
        return dict(shape=list(P[0].shape), operand_maps=[list(km._operand(t)[1:]) for t in P],
                    rows=rows_, m=m, launches=launches_, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_bytes_ms=4 * Lq * rows_ * (m + 1) * 4 / HBM_BYTES_PER_S * 1e3,
                    bound_ops_ms=tree_ops(P) / int_ops_per_s * 1e3, levels=len(hs),
                    chain_products=ADD_DEPTH * sum(-(-h // TREE_QUADS) for h in hs),
                    chain_products_one_add_a_level=ADD_DEPTH * len(hs), blocks_per_sm=blocks,
                    waves=rows_ / (blocks * props.multi_processor_count))

    tree_rows = [tree_row(tree_inputs[key], f"at {key}", count) for key, count in tree_keys.items()]
    del tree_inputs

    splits = []
    for _ in range(3):
        st0 = tsw.xyzz_zero(G1, (W, half), dev)
        st, t_acc = once_ms(lambda: tmsm.msm_accumulate(G1, A, s, c, bits, st0))
        res, t_red = once_ms(lambda: tmsm.msm_reduce(G1, st, c, bits))
        aff, t_aff = once_ms(lambda: to_affine(res))
        if tsw.affine_to_ints(G1, aff)[0] != want_pt:
            raise AssertionError("msm 2^20: timed run differs from the known answer")
        splits.append((t_acc + t_red + t_aff, t_acc, t_red, t_aff))
    total, t_acc, t_red, t_aff = sorted(splits)[1]
    sync()
    kernels.reset_launches()
    to_affine(res)
    sync()
    aff_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if aff_launches != {"mont_div": 1}:
        raise AssertionError(f"msm 2^20 to-affine: launches {aff_launches}, expected one mont_div")

    # the main path's own band-1 feed (the occupancy-sorted slots), recorded
    # from one more accumulate (not in the run above, to keep its peak
    # memory); held against the plain version below
    band1 = []

    def recording_band1(curve, state, coords, valid):
        if coords.shape[1] == r1b:
            band1.append((state, coords, valid))
        return accum_grid(curve, state, coords, valid)

    ksw.xyzz_accum_grid = recording_band1
    try:
        tmsm.msm_accumulate(G1, A, s, c, bits, tsw.xyzz_zero(G1, (W, half), dev))
        sync()
    finally:
        ksw.xyzz_accum_grid = accum_grid
    emit("msm", n=n, c=c, scalar_bits=bits, correct=True, launches=launches,
         ms_total=total, ms_accumulate=t_acc, ms_reduce=t_red, ms_to_affine=t_aff,
         to_affine_launches=aff_launches,
         ms_total_runs=[sp[0] for sp in splits], ms_reduce_runs=[sp[2] for sp in splits],
         ms_to_affine_runs=[sp[3] for sp in splits], pts_per_s=n / (total / 1e3),
         peak_mem_bytes=msm_peak, card=card)

    # one msm_reduce under torch.profiler: how much of the reduce's wall
    # time the device is busy, and on what
    kernels.reset_launches()
    res2, tr = device_trace(torch, lambda: tmsm.msm_reduce(G1, st, c, bits), t_red)
    reduce_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if tr is None:
        emit("reduce_trace", launches=reduce_launches,
             note="this torch build's profiler cannot trace CUDA activity")
    else:
        if any(not torch.equal(a, b) for a, b in zip(res2, res)):
            raise AssertionError("msm_reduce under the profiler differs from the untraced run")
        emit("reduce_trace", ms_reduce_untraced_median=t_red, launches=reduce_launches, **tr)
        for k, v in tr["port_kernels"].items():
            report.setdefault(k, {})["device_ms_per_launch_in_reduce_trace"] = v["device_ms_per_launch"]
    del A, s

    # mont_pow against its plain version for p - 2 (Fermat inversion): at
    # 2^20 Fq elements, zeros and mont_inv's edge words included, and at
    # one element, the to-affine's shape before mont_inv took its place;
    # then once through its entry, ff.fp.pow_const
    e = f.modulus - 2
    n_prod = e.bit_length() - 1 + bin(e).count("1")  # squarings + multiplications
    pow_shape = (Lq, 1)
    edge = mont_inv_edge_words(f, np.random.default_rng(6), n_random=8)
    xe = fp.from_ints(f, edge, mont=False, device=dev)  # the words themselves
    pow_rows, pow_in = {}, {}
    for label, x in (("2^20", rand_field(f, n)), ("one element", rand_field(f, 1))):
        if label == "2^20":
            x[:, ::1001] = 0
            x[:, 1 : 1 + len(edge)] = xe
        m = x[0].numel()
        got = km.mont_pow(f, x, e)
        want, plain_ms = once_ms(lambda: km.mont_pow_plain(f, x, e))
        err = check_equal(f"mont_pow at {tuple(x.shape)}", got, want)
        ms = time_ms(lambda: km.mont_pow(f, x, e), 3 if m > 1024 else 20)
        b_ms, b_by = bound(2 * Lq * m * 4, m * pow_ops(f, e))
        pow_rows[label] = dict(shape=list(x.shape), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=b_ms, bound_by=b_by)
        pow_in[label] = (x, want)
        emit("kernel", kernel="mont_pow", field=f.name, exponent="p - 2", products=n_prod,
             **pow_rows[label])
    wide, path = pow_rows["2^20"], pow_rows["one element"]
    sync()
    kernels.reset_launches()
    got = fp.pow_const(f, pow_in["one element"][0], e)
    sync()
    pow_launches = kernels.LAUNCHES["mont_pow"]
    check_equal("ff.fp.pow_const, one element", got, pow_in["one element"][1])
    report["mont_pow"] = dict(
        max_abs_err=max(wide["max_abs_err"], path["max_abs_err"]), ms=path["ms"],
        plain_ms=path["plain_ms"], bound_ms=path["bound_ms"], bound_by=path["bound_by"],
        shape=f"Fq {list(pow_shape)}, e = p - 2 ({n_prod} products)", ms_2e20=wide["ms"],
        plain_ms_2e20=wide["plain_ms"], bound_ms_2e20=wide["bound_ms"],
        bound_by_2e20=wide["bound_by"], us_per_product_one_thread=path["ms"] * 1e3 / n_prod,
        launches_main_path=launches["mont_pow"])

    # mont_inv against its plain version (the Fermat power), bit for bit: the
    # edge words (mont_inv_edge_words) in one launch and each alone, also
    # against Python's pow; the MSM's own ZZ and ZZZ at (24, 1), the
    # to-affine's denominators; (24, 2^12), the pairing's Fp12 inverse's
    # width, with zeros and the edge words; 2^20 elements (mont_pow's, the
    # edge words among them). Below GCD_WIDE elements two lanes work on an
    # element, from it on one: the three sizes take both layouts. ms by
    # CUDA events (through the wrapper: at one element that is the host's
    # launch rate), the device ms a launch from a trace of 20, the wrapper's
    # host ms. Its chain bound: testing.mont_inv_chain's dependent
    # instructions of the loop x one dependent carried add's latency (phase
    # 1); its operation bound: testing.mont_inv_ops a element.
    R, p_ = f.r_int, f.modulus
    got = km.mont_inv(f, xe)
    want = km.mont_inv_plain(f, xe)
    err = check_equal("mont_inv on the edge words", got, want)
    for j in range(len(edge)):
        err = max(err, check_equal(f"mont_inv on edge word {j} alone", km.mont_inv(f, xe[:, j : j + 1]),
                                   want[:, j : j + 1]))
    if fp.to_ints(f, got, mont=False) != [pow(w * pow(R, -1, p_), -1, p_) * R % p_ if w else 0
                                          for w in edge]:
        raise AssertionError("mont_inv: edge words differ from Python's pow")
    X_path, ZZ_path, Y_path, ZZZ_path = div_inputs[0]
    x1 = ZZ_path.contiguous()
    want, plain_ms = once_ms(lambda: km.mont_inv_plain(f, x1))
    err = max(err, check_equal("mont_inv on the path's ZZ", km.mont_inv(f, x1), want))
    err = max(err, check_equal("mont_inv on the path's ZZZ", km.mont_inv(f, ZZZ_path),
                               km.mont_inv_plain(f, ZZZ_path)))
    x12 = rand_field(f, 1 << INV_PAIRING_LOG_N)
    x12[:, ::1001] = 0
    x12[:, 1 : 1 + len(edge)] = xe
    want12, plain_ms_12 = once_ms(lambda: km.mont_inv_plain(f, x12))
    err = max(err, check_equal("mont_inv at (24, 2^12)", km.mont_inv(f, x12), want12))
    xw, want_w = pow_in["2^20"]
    err = max(err, check_equal("mont_inv at 2^20", km.mont_inv(f, xw), want_w))
    ms = time_ms(lambda: km.mont_inv(f, x1), 20)
    dev_ms, _ = traced_device_ms(torch, "mont_inv", lambda: km.mont_inv(f, x1), 20, dev)
    w_ms = wrapper_ms(lambda: km.mont_inv(f, x1))
    ms_12 = time_ms(lambda: km.mont_inv(f, x12), 20)
    dev_ms_12, _ = traced_device_ms(torch, "mont_inv", lambda: km.mont_inv(f, x12), 20, dev)
    ms_w = time_ms(lambda: km.mont_inv(f, xw), 3)
    chain = mont_inv_chain(f)
    chain_ms = chain * add_cycles / (clock_mhz * 1e3)
    inv_ops = mont_inv_ops(f)
    b_ms, b_by = bound(2 * Lq * 4, inv_ops)
    b_ms_12, b_by_12 = bound(2 * Lq * 4 << INV_PAIRING_LOG_N, inv_ops << INV_PAIRING_LOG_N)
    b_ms_w, b_by_w = bound(2 * Lq * 4 * n, n * inv_ops)
    steps_path = [mont_inv_model(f, fp.to_ints(f, t, mont=False)[0])[1] for t in (ZZ_path, ZZZ_path)]
    inv_ptxas = {k: v for k, v in ptxas.items() if "mont_inv_kernelILi12E" in k}
    report["mont_inv"] = dict(
        max_abs_err=err, ms=ms, device_ms_traced=dev_ms, wrapper_ms=w_ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, chain_bound_ms=chain_ms,
        share_of_chain_bound=chain_ms / dev_ms if dev_ms else None,
        chain_dependent_instructions=chain, batches=km.gcd_batches(f), steps_a_batch=km.GCD_STEPS,
        steps_to_zero_path=steps_path, cycles_per_dependent_add=add_cycles,
        shape=f"Fq {list(x1.shape)} (the MSM's ZZ; two lanes an element)",
        ms_2e12=ms_12, device_ms_traced_2e12=dev_ms_12, plain_ms_2e12=plain_ms_12,
        bound_ms_2e12=b_ms_12, bound_by_2e12=b_by_12, ms_2e20=ms_w, plain_ms_2e20=wide["plain_ms"],
        bound_ms_2e20=b_ms_w, bound_by_2e20=b_by_w, share_of_bound_2e20=b_ms_w / ms_w,
        lanes={"(24, 1)": 2, "(24, 2^12)": 2, "2^20": 1, "wide_from": km.GCD_WIDE},
        edge_words=len(edge), ptxas_nw12=inv_ptxas,
        mont_pow_ms_one_element=report["mont_pow"]["ms"])
    emit("kernel", kernel="mont_inv", field=f.name, **report["mont_inv"])
    del xw, want_w, pow_in, got, want, want12

    # mont_div, the to-affine in one launch, against its plain route (each
    # numerator times its batch inverse, the JAX package's), bit for bit: the
    # MSM's own X, ZZ, Y, ZZZ; the same point at infinity (ZZ = ZZZ = 0);
    # 2^16 random points with every 64th at infinity (one lane a division
    # there). ms at the path's point by CUDA events, the device ms from a
    # trace and the wrapper's host ms; at 2^16 points against the batch
    # route's ms. Its chain bound: mont_inv's and one product (mont_pow's
    # time a product in one thread).
    got = km.mont_div(f, *div_inputs[0])
    want, plain_div_ms = once_ms(lambda: km.mont_div_plain(f, *div_inputs[0]))
    err = check_equal("mont_div on the MSM's result", got, want)
    if not (torch.equal(got[0], aff.x) and torch.equal(got[1], aff.y)):
        raise AssertionError("mont_div: the path's to-affine differs from a launch on its inputs")
    z1 = torch.zeros_like(x1)
    inf_in = (X_path, z1, Y_path, z1)
    got = km.mont_div(f, *inf_in)
    err = max(err, check_equal("mont_div at infinity", got, km.mont_div_plain(f, *inf_in)))
    if bool(got.any()):
        raise AssertionError("mont_div at infinity: the quotients are not 0")
    P16 = [rand_field(f, 1 << DIV_LOG_N) for _ in range(4)]
    P16[1][:, ::64] = 0
    P16[3][:, ::64] = 0
    err = max(err, check_equal("mont_div at 2^16 points", km.mont_div(f, *P16),
                               km.mont_div_plain(f, *P16)))
    div_path = div_inputs[0]
    ms_div = time_ms(lambda: km.mont_div(f, *div_path), 20)
    dev_div, _ = traced_device_ms(torch, "mont_div", lambda: km.mont_div(f, *div_path), 20, dev)
    w_div = wrapper_ms(lambda: km.mont_div(f, *div_path))
    ms_16 = time_ms(lambda: km.mont_div(f, *P16), 3)
    route_16 = time_ms(lambda: (fp.mont_mul(f, P16[0], fp.batch_inv(f, P16[1])),
                                fp.mont_mul(f, P16[2], fp.batch_inv(f, P16[3]))), 3)
    div_chain_ms = chain_ms + report["mont_pow"]["us_per_product_one_thread"] / 1e3
    div_ops = 2 * (inv_ops + mul_ops(f))
    b_ms, b_by = bound(6 * Lq * 4, div_ops)
    b_ms_16, b_by_16 = bound(6 * Lq * 4 << DIV_LOG_N, div_ops << DIV_LOG_N)
    report["mont_div"] = dict(
        max_abs_err=err, ms=ms_div, device_ms_traced=dev_div, wrapper_ms=w_div, plain_ms=plain_div_ms,
        bound_ms=b_ms, bound_by=b_by, chain_bound_ms=div_chain_ms,
        share_of_chain_bound=div_chain_ms / dev_div if dev_div else None,
        shape=f"Fq 2 x {list(x1.shape)} (the MSM's X / ZZ and Y / ZZZ; a lane pair a division)",
        ms_2e16=ms_16, bound_ms_2e16=b_ms_16, bound_by_2e16=b_by_16,
        batch_inv_route_ms_2e16=route_16, checks=["the MSM's result", "infinity", "2^16 points"],
        ptxas_nw12={k: v for k, v in ptxas.items() if "mont_div_kernelILi12E" in k})
    emit("kernel", kernel="mont_div", field=f.name, **report["mont_div"])
    del P16, got, want

    # xyzz_accum on the main path's own feeds: band 1 (every slot, sorted by
    # occupancy) and band 2 (the top-occupancy slots' rounds beyond band 1)
    accum_rows["main path band 1"] = accum_row("main path band 1", *band1[0])
    band1.clear()
    accum_rows["main path band 2"] = accum_row("main path band 2", *band2[-1])  # the last group's
    band2.clear()
    report["xyzz_accum"]["band1_path"] = accum_rows["main path band 1"]
    report["xyzz_accum"]["band2"] = accum_rows["main path band 2"]
    report["xyzz_accum"]["edge_feeds"] = {k: accum_rows[k] for k in ("edge classes", "oracle edge rounds")}
    report["xyzz_accum"]["max_abs_err"] = max(r["max_abs_err"] for r in accum_rows.values())

    # horner_windows on the path's own window rows; every row's chain bound:
    # its critical-path products x mont_pow's time per product in one thread
    horner_rows["main path windows"] = horner_row("main path windows", path_win[0], c)[0]
    us_prod = report["mont_pow"]["us_per_product_one_thread"]
    for row in horner_rows.values():
        row["chain_bound_ms"] = row["critical_path_products"] * us_prod / 1e3
        row["share_of_chain_bound"] = row["chain_bound_ms"] / row["ms"]
    emit("horner_chain", us_per_product_one_thread=us_prod, rows=horner_rows)
    report["xyzz_add"]["chain_bound_ms"] = ADD_DEPTH * us_prod / 1e3  # one add a thread
    rnd = horner_rows["random windows"]
    report["horner_windows"].update(
        max_abs_err=max(r["max_abs_err"] for r in horner_rows.values()),
        chain_bound_ms=rnd["chain_bound_ms"], share_of_chain_bound=rnd["share_of_chain_bound"],
        path_windows=horner_rows["main path windows"], edge_windows=horner_rows["oracle edge windows"])
    del path_win

    # xyzz_bit_horner against its plain version on the path's recorded
    # partials (L, nbits, W) and on testing.bit_horner_edge_parts at their
    # shape; device ms by CUDA events and the wrapper's ms. Its chain bound:
    # (nbits - 1) doublings 3 products deep and adds 4 deep x mont_pow's time
    # per product in one thread, beside the share horner_windows reaches of
    # its own; its operation bound counts the path's generic steps (the edge
    # feed's row has none)
    hb = bit_horner_inputs[0]
    Lb, nb, Wb_ = hb[0].shape
    depth = (nb - 1) * (3 + ADD_DEPTH)
    bh_rows = {}
    for label, parts in (("main path partials", hb),
                         ("edge classes", bit_horner_edge_parts(G1, nb, Wb_, np.random.default_rng(7),
                                                                dev))):
        got = ksw.xyzz_bit_horner(G1, parts)
        want, plain_ms = once_ms(lambda: ksw.xyzz_bit_horner_plain(G1, parts))
        err = max(check_equal(f"xyzz_bit_horner {label}, coordinate {i}", g, w_)
                  for i, (g, w_) in enumerate(zip(got, want)))
        run = lambda: ksw.xyzz_bit_horner(G1, parts)  # noqa: E731
        ms, w_ms = time_ms(run, 20), wrapper_ms(run)
        b_ms, b_by = bound(4 * Lq * (nb + 1) * Wb_ * 4, (nb - 1) * Wb_ * (dbl_ops + fadd_ops))
        chain = depth * us_prod / 1e3
        bh_rows[label] = dict(shape=[Lb, nb, Wb_], max_abs_err=err, ms=ms, wrapper_ms=w_ms,
                              plain_ms=plain_ms, critical_path_products=depth, chain_bound_ms=chain,
                              share_of_chain_bound=chain / ms)
        if label == "main path partials":
            bh_rows[label].update(bound_ms=b_ms, bound_by=b_by)
        emit("kernel", kernel="xyzz_bit_horner", feed=label, **bh_rows[label])
    report.setdefault("xyzz_bit_horner", {}).update(
        bh_rows["main path partials"], max_abs_err=max(r["max_abs_err"] for r in bh_rows.values()),
        horner_windows_share_of_chain_bound=rnd["share_of_chain_bound"],
        edge_feed=bh_rows["edge classes"])
    del hb, parts, got, want

    # xyzz_add / xyzz_double on an edge-class feed of 2^20 random Fq points
    # (the formulas need no curve membership to be compared); Q is another
    # representative of +-P (ZZ scaled by lam^2) where the class says so
    ne = 1 << ELEM_LOG_N
    one = fp.one(f, (ne,), dev).contiguous()
    zero = fp.zero(f, (ne,), dev)
    X, Y, ZZ, ZZZ, X2, Y2, ZZ2, ZZZ2, lam = (rand_field(f, ne) for _ in range(9))
    l2 = km.mont_mul(f, lam, lam)
    l3 = km.mont_mul(f, l2, lam)
    cls = torch.arange(ne, device=dev) % 7

    def on(cs):
        return torch.isin(cls, torch.tensor(cs, device=dev))[None]

    Y = torch.where(on([6]), zero, Y)  # P == Q with y = 0
    same = on([1, 2, 6])  # P == Q (1, 6) or P == -Q (2)
    X2 = torch.where(same, km.mont_mul(f, X, l2), X2)
    Ys = km.mont_mul(f, Y, l3)
    Y2 = torch.where(on([1, 6]), Ys, torch.where(on([2]), fp.neg(f, Ys), Y2))
    ZZ2 = torch.where(same, km.mont_mul(f, ZZ, l2), ZZ2)
    ZZZ2 = torch.where(same, km.mont_mul(f, ZZZ, l3), ZZZ2)
    p_inf, q_inf = on([3, 5]), on([4, 5])  # 5: both at infinity
    X, Y = torch.where(p_inf, one, X), torch.where(p_inf, one, Y)
    ZZ, ZZZ = torch.where(p_inf, zero, ZZ), torch.where(p_inf, zero, ZZZ)
    X2, Y2 = torch.where(q_inf, one, X2), torch.where(q_inf, one, Y2)
    ZZ2, ZZZ2 = torch.where(q_inf, zero, ZZ2), torch.where(q_inf, zero, ZZZ2)
    P, Q = (X, Y, ZZ, ZZZ), (X2, Y2, ZZ2, ZZZ2)
    for name, pts in (("xyzz_add", (P, Q)), ("xyzz_double", (P,))):
        err, ms, plain_ms, tb, to = xyzz_row(name, pts, "on the edge feed")
        edge = dict(n=ne, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(tb, to),
                    bound_by="bytes" if tb >= to else "operations")
        emit("kernel", kernel=name, field=f.name, feed="edge classes", **edge)
        report[name]["edge_feed"] = edge
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
    # xyzz_double's path since the bit-Horner left it: its entry,
    # ec.sw.xyzz_double, once on that feed (the kernel's words, held above)
    sync()
    kernels.reset_launches()
    D = tsw.xyzz_double(G1, tsw.XYZZPoints(*P))
    sync()
    dbl_launches = kernels.LAUNCHES["xyzz_double"]
    for i, (g, w_) in enumerate(zip(D, ksw.xyzz_double(G1, P))):
        check_equal(f"ec.sw.xyzz_double on the edge feed, coordinate {i}", g, w_)
    report["xyzz_double"]["launches_main_path"] = launches["xyzz_double"]
    del D, g, w_

    # xyzz_tree_sum on rows built from that feed: row k of width m is P's and
    # Q's points k h .. k h + h - 1 side by side (h = m // 2), then P's point
    # k for an odd width, so the first level meets every class; directly at
    # odd, even and full widths, and through ec/msm.py:_tree_sum_last at
    # widths beyond TREE_SUM_MAX (element-wise levels, then the tree sum)
    def edge_rows(rows_, m):
        h = m // 2
        parts = [[v[:, : rows_ * h].reshape(Lq, rows_, h) for v in pts] for pts in (P, Q)]
        if m % 2:
            parts.append([v[:, ne - rows_ :].reshape(Lq, rows_, 1) for v in P])
        return tuple(torch.cat(cs, dim=-1) for cs in zip(*parts))

    for m in TREE_EDGE_WIDTHS:
        row = tree_row(edge_rows(TREE_EDGE_ROWS, m), f"edge rows of width {m}")
        tree_rows.append(dict(row, feed="edge classes"))
    for m in TREE_ROUTE_WIDTHS:
        E = edge_rows(8, m)
        got = tmsm._tree_sum_last(G1, tsw.XYZZPoints(*E))
        err = max(check_equal(f"ec/msm.py tree route at width {m}, coordinate {i}", g, w_)
                  for i, (g, w_) in enumerate(zip(got, ksw.xyzz_tree_sum_plain(G1, E))))
        tree_rows.append(dict(feed="edge classes, ec/msm.py tree route", rows=8, m=m, launches=0,
                              max_abs_err=err))
    del E, got
    for row in tree_rows:
        if "chain_products" in row:
            row["chain_bound_ms"] = row["chain_products"] * us_prod / 1e3
            row["share_of_chain_bound"] = row["chain_bound_ms"] / row["ms"]
            row["chain_bound_one_add_a_level_ms"] = row["chain_products_one_add_a_level"] * us_prod / 1e3
            row["share_of_operation_bound"] = row["bound_ops_ms"] / row["ms"]
    emit("kernel_main_path_shapes", kernel="xyzz_tree_sum",
         inputs="the main path's own (launches > 0), then edge rows", rows=tree_rows)
    path_tree = [r for r in tree_rows if r["launches"]]
    report.setdefault("xyzz_tree_sum", {}).update(per_launch_means(
        path_tree, f"mean per launch over the main path's {len(path_tree)} shapes"))
    tree_regs = {ops_: next((v for k, v in ptxas.items()
                             if "xyzz_tree_sum_kernel" in k and f"ILi12E{len(ops_)}{ops_}" in k), {})
                 for ops_ in ("CallOps", "PlainCallOps")}
    n_path = sum(r["launches"] for r in path_tree)
    report["xyzz_tree_sum"].update(
        max_abs_err=max(r["max_abs_err"] for r in tree_rows),
        chain_bound_ms=sum(r["launches"] * r["chain_bound_ms"] for r in path_tree) / n_path,
        chain_bound_one_add_a_level_ms=sum(
            r["launches"] * r["chain_bound_one_add_a_level_ms"] for r in path_tree) / n_path,
        share_of_operation_bound=sum(r["launches"] * r["bound_ops_ms"] for r in path_tree)
        / sum(r["launches"] * r["ms"] for r in path_tree),
        ptxas_nw12=tree_regs, blocks_per_sm=dict(zip(("CallOps", "PlainCallOps"), (
            tree_occupancy(ksw.TREE_SUM_MAX)[0], tree_occupancy(ksw.TREE_SUM_MAX, plain=True)[0]))),
        edge_rows=[r for r in tree_rows if not r["launches"]])
    report["xyzz_tree_sum"]["share_of_chain_bound"] = (
        report["xyzz_tree_sum"]["chain_bound_ms"] / report["xyzz_tree_sum"]["ms"])
    emit("xyzz_tree_sum_design", ptxas_nw12=tree_regs,
         blocks_per_sm=report["xyzz_tree_sum"]["blocks_per_sm"], threads_per_block=4 * TREE_QUADS,
         path_ms=report["xyzz_tree_sum"]["ms"], bound_ms=report["xyzz_tree_sum"]["bound_ms"],
         share_of_operation_bound=report["xyzz_tree_sum"]["share_of_operation_bound"],
         chain_bound_ms=report["xyzz_tree_sum"]["chain_bound_ms"],
         share_of_chain_bound=report["xyzz_tree_sum"]["share_of_chain_bound"], card=card)
    del X, Y, ZZ, ZZZ, X2, Y2, ZZ2, ZZZ2, lam, l2, l3, Ys, P, Q, one, zero, cls, coords, pts

    # ---- 4. ChunkedMSM at 2^21 ------------------------------------------------
    n2 = 2 * n
    px, py, sc, ks, bits = tiled_inputs(G1, n2, np.random.default_rng(1))
    want_pt = expected_msm(G1, ks, sc)
    t = time.perf_counter()
    cm = tmsm.ChunkedMSM(G1, n, max_scalar_bits=bits, device=dev)
    for lo in range(0, n2, n):
        A = affine_from_numpy(px[:, lo : lo + n], py[:, lo : lo + n], np.zeros(n, dtype=bool), dev)
        cm.add_chunk(A, limbs_from_numpy(sc[:, lo : lo + n], dev))
    got_pt = tsw.affine_to_ints(G1, to_affine(cm.result()))[0]
    chunk_s = time.perf_counter() - t
    if got_pt != want_pt:
        raise AssertionError("ChunkedMSM 2^21: result differs from the host known answer")
    emit("chunked_msm", n=n2, chunk=n, correct=True, seconds_with_transfers=chunk_s)
    del A, cm

    # ---- 5. NTT path: Radix2Domain(Fr, 2^24) ------------------------------------
    L = FR.num_limbs
    p = FR.modulus
    N = 1 << NTT_LOG_N
    dom = tdm.Radix2Domain(FR, N)
    krng = np.random.default_rng(5)
    idx = np.unique(np.concatenate([[0, 1, N - 1], krng.integers(0, N, size=2 * KAT_POINTS)]))
    idx = [int(i) for i in idx[: max(KAT_POINTS, 3)]] + [N - 1]

    def rand_int():
        return int.from_bytes(krng.bytes(32), "little") % p

    def geometric(r_int, c_int, m):
        """a_j = c r^j for j < m, built on the card (Montgomery form)."""
        return fp.mont_mul(FR, tdm.power_table(FR, r_int, m, dev), fp.const_array(FR, c_int, (1,), dev))

    def closed_form(d, r_int, c_int, m, ks):
        """f(offset w^k) = c (1 - x^m) / (1 - x), x = r offset w^k, on the host."""
        out = []
        for k in ks:
            x = r_int * d.offset_int * pow(d.group_gen_int, k, p) % p
            out.append(c_int * (1 - pow(x, m, p)) * pow(1 - x, -1, p) % p)
        return out

    def check_closed_form(what, d, ev, r_int, c_int, m, ks):
        if fp.to_ints(FR, ev[:, ks]) != closed_form(d, r_int, c_int, m, ks):
            raise AssertionError(f"{what}: evaluations differ from the host closed form")

    # the main-path run: every butterfly_dit launch's (shape, table length,
    # stride), recorded around the wrapper's own launch function, and every
    # pow_table and twiddle_mul call's arguments (the twiddle tables kept),
    # recorded around the wrappers, by run: the forward fft, then the other
    # phase-5 runs below; the counts stay where they are
    dit_shapes = collections.Counter()
    pow_keys, tw_keys, tw_tables = collections.Counter(), collections.Counter(), {}
    launch_dit, pow_table, twiddle_mul = km._launch_dit, km.pow_table, km.twiddle_mul
    run = ["fft"]

    def recording_dit(spec, x, tw, stride):
        dit_shapes[(run[0], tuple(x.shape), tw.shape[1], stride)] += 1
        return launch_dit(spec, x, tw, stride)

    def recording_pow(spec, w_int, n, device, scale_int=None, packed=False):
        pow_keys[(run[0], w_int, n, scale_int, packed)] += 1
        return pow_table(spec, w_int, n, device, scale_int, packed)

    def recording_twiddle(spec, x, tw, r0=0, c0=0, out=None):
        layout = None if out is None else (tuple(out.stride()), out.data_ptr() == x.data_ptr())
        key = (run[0], tuple(x.shape), tuple(x.stride()), r0, c0, layout)
        tw_keys[key] += 1
        tw_tables.setdefault(key, tw)
        return twiddle_mul(spec, x, tw, r0, c0, out)

    def recording(on):
        km._launch_dit = recording_dit if on else launch_dit
        km.pow_table, km.twiddle_mul = (recording_pow, recording_twiddle) if on else (pow_table, twiddle_mul)

    r_int, c_int = rand_int(), rand_int()
    a = geometric(r_int, c_int, N)
    sync()
    torch.cuda.reset_peak_memory_stats()
    ntt_mem_before = torch.cuda.memory_allocated()  # the input and what earlier phases hold
    km.clear_table_cache()  # a cold fft: it builds its tables (the counts below see them)
    recording(True)
    try:
        kernels.reset_launches()
        ev = dom.fft(a)
        sync()
        ntt_launches = dict(kernels.LAUNCHES)
    finally:
        recording(False)
    ntt_peak = torch.cuda.max_memory_allocated()
    check_closed_form("fft 2^24", dom, ev, r_int, c_int, N, idx)
    ntt_kernels = ("butterfly_dit", "twiddle_mul", "pow_table")
    missing = [k for k in ntt_kernels if ntt_launches[k] == 0]
    if missing:
        raise AssertionError(f"fft 2^24: kernels never launched: {missing}")
    if ntt_launches["mont_mul"] or ntt_launches["mont_sqr"]:
        raise AssertionError(f"fft 2^24: {ntt_launches['mont_mul']} mont_mul and "
                             f"{ntt_launches['mont_sqr']} mont_sqr launches; its tables and "
                             "twiddles should be pow_table and twiddle_mul launches")
    if ntt_launches["twiddle_mul"] != tdm.BIG_CHUNKS or ntt_launches["pow_table"] > 3:
        raise AssertionError(f"fft 2^24: {ntt_launches['twiddle_mul']} twiddle_mul launches (one "
                             f"per pass-1 block: {tdm.BIG_CHUNKS}) and {ntt_launches['pow_table']} "
                             "pow_table launches (at most 3)")
    if (sum(dit_shapes.values()) != ntt_launches["butterfly_dit"]
            or sum(pow_keys.values()) != ntt_launches["pow_table"]
            or sum(tw_keys.values()) != ntt_launches["twiddle_mul"]):
        raise AssertionError("fft 2^24: recorded launches differ from the counts")

    # the same fft warm: its tables come from kernels.mont's cache, so it
    # launches no pow_table; the cached tables are the plain version's
    # words, and they stay so through every later fft path (checked after
    # this phase, phase 13 and phase 15)
    table_snap = {}
    tables = km.cached_tables()
    for (spec_, w_t, n_t, scale_t, packed_t, _), t in tables.items():
        check_equal(f"cached pow_table n={n_t} packed={packed_t}", t,
                    km.pow_table_plain(spec_, w_t, n_t, dev, scale_t, packed_t))
    tables_seen = check_cached_tables(torch, km, table_snap)
    kernels.reset_launches()
    ev_w, warm_ms = once_ms(lambda: dom.fft(a))
    warm_launches = dict(kernels.LAUNCHES)
    check_closed_form("warm fft 2^24", dom, ev_w, r_int, c_int, N, idx)
    if warm_launches["pow_table"] or not torch.equal(ev_w, ev):
        raise AssertionError(f"warm fft 2^24: {warm_launches['pow_table']} pow_table launches "
                             "(0 expected), or its words differ from the cold fft's")
    emit("ntt_warm", n=N, correct=True, pow_table_launches=warm_launches["pow_table"],
         cold_pow_table_launches=ntt_launches["pow_table"],
         launches={k: v for k, v in warm_launches.items() if v}, ms=warm_ms,
         cached_tables=tables_seen, tables_equal_plain=True, card=card)
    del a, ev, ev_w

    # fft/ifft round trip of random coefficients; the input stays as it was
    x = rand_field(FR, N)
    x0 = x.clone()
    run[0] = "fft/ifft 2^24"
    recording(True)
    try:
        ev_x = dom.fft(x)
        back = dom.ifft(ev_x)
    finally:
        recording(False)
    if not torch.equal(back, x0) or not torch.equal(x, x0):
        raise AssertionError("fft/ifft 2^24: the round trip does not return the input")
    del x0, back

    # coset (offset 7) round trip and closed form at 2^20: fft_fourstep_core
    dc = tdm.Radix2Domain(FR, 1 << COSET_LOG_N, offset_int=FR.generator_int)
    y = rand_field(FR, 1 << COSET_LOG_N)
    r2, c2 = rand_int(), rand_int()
    run[0] = "coset 2^20"
    recording(True)
    try:
        if not torch.equal(dc.ifft(dc.fft(y)), y):
            raise AssertionError("coset fft/ifft 2^20: the round trip does not return the input")
        check_closed_form("coset fft 2^20", dc, dc.fft(geometric(r2, c2, 1 << COSET_LOG_N)), r2, c2,
                          1 << COSET_LOG_N, [k % (1 << COSET_LOG_N) for k in idx])
    finally:
        recording(False)
    del y

    # degree-aware fft: 2^22 coefficients on 2^24 points, with its peak memory
    M = 1 << DEG_LOG_M
    r3, c3 = rand_int(), rand_int()
    coeffs = geometric(r3, c3, M)
    sync()
    torch.cuda.reset_peak_memory_stats()
    deg_mem_before = torch.cuda.memory_allocated()
    run[0] = "degree-aware 2^22 -> 2^24"
    recording(True)
    try:
        ev_d = dom.fft(coeffs)
        sync()
    finally:
        recording(False)
    deg_peak = torch.cuda.max_memory_allocated()
    check_closed_form("degree-aware fft 2^22 -> 2^24", dom, ev_d, r3, c3, M, idx)
    del coeffs, ev_d

    fft_runs = []
    for _ in range(3):
        out, ms = once_ms(lambda: dom.fft(x))
        if not torch.equal(out, ev_x):
            raise AssertionError("fft 2^24: a timed run differs from the first")
        fft_runs.append(ms)
        del out
    ms_fft = sorted(fft_runs)[1]
    emit("ntt", n=N, field=FR.name, correct=True, known_answer_indices=len(idx), round_trip=True,
         coset_log_n=COSET_LOG_N, degree_aware_log_m=DEG_LOG_M, launches=ntt_launches,
         ms_fft=ms_fft, ms_fft_runs=fft_runs, elems_per_s=N / (ms_fft / 1e3),
         peak_mem_bytes=ntt_peak, mem_bytes_before_fft=ntt_mem_before,
         degree_aware_peak_mem_bytes=deg_peak, mem_bytes_before_degree_aware=deg_mem_before,
         card=card)
    _, tr = device_trace(torch, lambda: dom.fft(x), ms_fft)
    if tr is None:
        emit("ntt_trace", note="this torch build's profiler cannot trace CUDA activity")
    else:
        emit("ntt_trace", ms_fft_untraced_median=ms_fft, **tr)
    del x, ev_x
    emit("cached_tables", after="phase 5's fft paths",
         **check_cached_tables(torch, km, table_snap))

    def split_rows(kernel, rows, what="argument sets"):
        fft = [r for r in rows if r["run"] == "fft"]
        means = per_launch_means(fft, f"mean per launch over the fft's {len(fft)} {what}")
        means["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        means["other_runs"] = [r for r in rows if r["run"] != "fft"]
        emit("kernel_main_path_shapes", kernel=kernel, path=f"phase 5 (fft 2^{NTT_LOG_N} and the "
             "other NTT runs)", rows=rows)
        return means

    # butterfly_dit against its plain version at every shape of the fft (its
    # launches weight the path means) and of the other phase-5 runs
    dit_ops = mul_ops(FR) + 2 * add_ops(FR)
    dit_rows = []
    for (label, shape, T, stride), count in sorted(dit_shapes.items()):
        _, C, _, H, R = shape
        xb = rand_field(FR, C * 2 * H * R).reshape(shape)
        twb = rand_field(FR, T)
        got = km.butterfly_dit(FR, xb.clone(), twb, stride)
        err = check_equal(f"butterfly_dit at {shape}", got, km.butterfly_dit_plain(FR, xb.clone(), twb, stride))
        ms = time_ms(lambda: km.butterfly_dit(FR, xb, twb, stride), 20)
        plain_ms = time_ms(lambda: km.butterfly_dit_plain(FR, xb, twb, stride), 2)
        pairs = C * H * R
        dit_rows.append(dict(run=label, shape=list(shape), stride=stride,
                             launches=count if label == "fft" else 0, calls=count,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_bytes_ms=(4 * pairs + H) * L * 4 / HBM_BYTES_PER_S * 1e3,
                             bound_ops_ms=pairs * dit_ops / int_ops_per_s * 1e3))
        del xb, twb, got
    report["butterfly_dit"] = split_rows("butterfly_dit", dit_rows, "shapes")

    # pow_table and twiddle_mul against their plain versions (run on the card)
    # with every set of arguments phase 5 gave them: the forward fft's (its
    # launches weight the path means) and the other runs'; twiddle_mul on
    # random inputs with the call's own layout, output layout and tables.
    # Bounds count what these arguments need: a table of n entries needs
    # n - 1 products (the chain s·w^j = s·w^(j-1)·w; the kernel does one per
    # set bit of j instead) and writes n entries of L·4 bytes planar, L·2
    # packed; twiddle_mul reads x's distinct elements and the two tables
    # once and writes R x C elements, two products each. pow_table's device
    # time comes from a trace of its own calls, since the fft's trace drops
    # its first few device ops, these launches among them.
    pow_rows = []
    for (label, w_int, n_t, scale, packed), count in pow_keys.items():
        got = km.pow_table(FR, w_int, n_t, dev, scale, packed)
        err = check_equal(f"pow_table {label} n={n_t}", got,
                          km.pow_table_plain(FR, w_int, n_t, dev, scale, packed))
        ms = time_ms(lambda: km.pow_table(FR, w_int, n_t, dev, scale, packed), 20)
        plain_ms = time_ms(lambda: km.pow_table_plain(FR, w_int, n_t, dev, scale, packed), 2)
        dev_ms, dev_seen = traced_device_ms(
            torch, "pow_table", lambda: km.pow_table(FR, w_int, n_t, dev, scale, packed), 20, dev)
        sync()  # host time of a build: the wrapper's call, launch included, no wait for the card
        t = time.perf_counter()
        for _ in range(20):
            km.pow_table(FR, w_int, n_t, dev, scale, packed)
        host_us = (time.perf_counter() - t) / 20 * 1e6
        sync()
        t = time.perf_counter()
        for _ in range(20):
            km._pow_words.cache_clear()
            km._pow_words(FR, w_int, n_t, scale)
        words_us = (time.perf_counter() - t) / 20 * 1e6
        products = max(n_t - 1, 0)
        pow_rows.append(dict(run=label, n=n_t, packed=packed, scaled=scale is not None,
                             launches=count if label == "fft" else 0, calls=count, max_abs_err=err,
                             ms=ms, plain_ms=plain_ms, device_ms=dev_ms, device_launches_traced=dev_seen,
                             host_us_per_build=host_us, host_words_us=words_us, products=products,
                             bound_bytes_ms=n_t * L * (2 if packed else 4) / HBM_BYTES_PER_S * 1e3,
                             bound_ops_ms=products * mul_ops(FR) / int_ops_per_s * 1e3))
    report["pow_table"] = split_rows("pow_table", pow_rows)
    fft_pow = [r for r in pow_rows if r["run"] == "fft"]
    if all(r["device_ms"] is not None for r in fft_pow):
        report["pow_table"]["device_ms_per_launch_traced"] = (
            sum(r["launches"] * r["device_ms"] for r in fft_pow) / sum(r["launches"] for r in fft_pow))

    def strided_empty(shape, strides):
        span = 1 + sum((n_ - 1) * st for n_, st in zip(shape, strides))
        return torch.as_strided(torch.empty(span, dtype=torch.int32, device=dev), shape, strides)

    tw_rows = []
    for key, count in tw_keys.items():
        label, shape, strides, r0, c0, layout = key
        tw = tw_tables[key]
        x = strided_field(FR, shape, strides)

        def args():
            """(x, out) for one call with the recorded layout, x's values fixed."""
            if layout is None:
                return x, torch.empty(shape, dtype=torch.int32, device=dev)
            out_strides, in_place = layout
            if in_place:
                y = x.clone()
                return y, y
            return x, strided_empty(shape, out_strides)

        xk, ok = args()
        xp, op = args()
        err = check_equal(f"twiddle_mul {label} at {shape} r0={r0} c0={c0}",
                          km.twiddle_mul(FR, xk, tw, r0, c0, ok), km.twiddle_mul_plain(FR, xp, tw, r0, c0, op))
        ms = time_ms(lambda: km.twiddle_mul(FR, xk, tw, r0, c0, ok), 20)
        plain_ms = time_ms(lambda: km.twiddle_mul_plain(FR, xp, tw, r0, c0, op), 2)
        m = math.prod(shape[1:])
        read = (distinct_elems(x) + m) * L + tw.lo.numel() + tw.hi.numel()
        tw_rows.append(dict(run=label, shape=list(shape), x_strides=list(strides), r0=r0, c0=c0,
                            out=None if layout is None else ("in place" if layout[1] else list(layout[0])),
                            h=tw.h, table_entries=[tw.lo.shape[0], tw.hi.shape[0]],
                            launches=count if label == "fft" else 0, calls=count, max_abs_err=err,
                            ms=ms, plain_ms=plain_ms, bound_bytes_ms=read * 4 / HBM_BYTES_PER_S * 1e3,
                            bound_ops_ms=2 * m * mul_ops(FR) / int_ops_per_s * 1e3))
        del x, xk, ok, xp, op
    report["twiddle_mul"] = split_rows("twiddle_mul", tw_rows)
    del tw_tables
    if tr is not None:
        for k in ntt_kernels:
            if k in tr["port_kernels"]:
                report[k]["device_ms_per_launch_in_ntt_trace"] = tr["port_kernels"][k]["device_ms_per_launch"]
    # mont_mul keeps its MSM path; the fft launches it no more
    report["mont_mul"]["ntt"] = dict(launches=ntt_launches["mont_mul"])

    # ---- 6. butterfly_stage through its entry, 2^20 Fr elements ---------------
    ne = 1 << ELEM_LOG_N
    lo, hi, w = (rand_field(FR, ne) for _ in range(3))
    sync()
    kernels.reset_launches()
    got = km.butterfly_stage(FR, lo, hi, w)
    sync()
    stage_launches = kernels.LAUNCHES["butterfly_stage"]
    want = km.butterfly_stage_plain(FR, lo, hi, w)
    err = max(check_equal("butterfly_stage a", got[0], want[0]), check_equal("butterfly_stage b", got[1], want[1]))
    ms = time_ms(lambda: km.butterfly_stage(FR, lo, hi, w), 20)
    plain_ms = time_ms(lambda: km.butterfly_stage_plain(FR, lo, hi, w), 2)
    b_ms, b_by = bound(5 * L * ne * 4, ne * dit_ops)
    emit("kernel", kernel="butterfly_stage", field=FR.name, n=ne, max_abs_err=err, ms=ms,
         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    report["butterfly_stage"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, shape=f"Fr, {ne} elements")
    del lo, hi, w, got, want

    # ---- 7. xyzz_add_affine ------------------------------------------------------
    f = FQ
    mod = f.modulus
    g1 = (G1.gen_x, G1.gen_y)
    pool = [ec_mul(g1, int(k), 0, mod) for k in krng.integers(1, 1 << 30, size=MADD_KAT_BASE)]
    nb = MADD_KAT_BASE
    ps = [pool[i // nb] for i in range(nb * nb)]  # every pair, so 64 doublings
    qs = [pool[i % nb] for i in range(nb * nb)]
    for i in range(0, nb * nb, 97):
        qs[i] = ec_neg(ps[i], mod)  # cancellation
    for i in range(5, nb * nb, 101):
        qs[i] = None
    for i in range(7, nb * nb, 103):
        ps[i] = None
    Pk = tsw.xyzz_from_affine(G1, tsw.affine_from_ints(G1, ps, dev))
    Ak = tsw.affine_from_ints(G1, qs, dev)
    sync()
    kernels.reset_launches()
    Sk = tsw.xyzz_add_affine(G1, Pk, Ak)
    sync()
    madd_launches = kernels.LAUNCHES["xyzz_add_affine"]
    if tsw.affine_to_ints(G1, tsw.xyzz_to_affine(G1, Sk)) != [ec_add(u, v, 0, mod) for u, v in zip(ps, qs)]:
        raise AssertionError("xyzz_add_affine: sums of real points differ from the host oracle")

    # edge-class feed on 2^20 points: random field elements (the formulas
    # need no curve membership to be compared), per-point classes
    Lq = f.num_limbs
    one = fp.one(f, (ne,), dev).contiguous()
    zero = fp.zero(f, (ne,), dev)
    X, Y, ZZ, ZZZ, AX, AY = (rand_field(f, ne) for _ in range(6))
    cls = torch.arange(ne, device=dev) % 7

    def on(c):
        return torch.isin(cls, torch.tensor(c, device=dev))

    AY = torch.where(on([6])[None], zero, AY)  # doubling a y == 0 point
    same = on([1, 2, 6])[None]  # P == A (1, 6) or P == -A (2)
    X = torch.where(same, AX, X)
    Y = torch.where(on([1, 6])[None], AY, torch.where(on([2])[None], fp.neg(f, AY), Y))
    ZZ, ZZZ = torch.where(same, one, ZZ), torch.where(same, one, ZZZ)
    p_inf = on([3, 5])[None]  # P at infinity
    X, Y = torch.where(p_inf, one, X), torch.where(p_inf, one, Y)
    ZZ, ZZZ = torch.where(p_inf, zero, ZZ), torch.where(p_inf, zero, ZZZ)
    a_inf = on([4, 5])  # A at infinity (5: both)
    P = (X, Y, ZZ, ZZZ)
    got = ksw.xyzz_add_affine(G1, P, AX, AY, a_inf)
    want, plain_ms = once_ms(lambda: ksw.xyzz_add_affine_plain(G1, P, AX, AY, a_inf))
    err = max(check_equal(f"xyzz_add_affine edges, coordinate {i}", g, w_) for i, (g, w_) in
              enumerate(zip(got, want)))
    ms = time_ms(lambda: ksw.xyzz_add_affine(G1, P, AX, AY, a_inf), 20)
    n_of = lambda cs: int(on(cs).sum())  # noqa: E731
    ops_of = functools.partial(xyzz_ops, mul_ops(f), sqr_ops(f), add_ops(f),
                               a_is_zero=G1.a_is_zero)
    madd_ops = ops_of("madd")
    ops = n_of([0]) * madd_ops + n_of([1]) * ops_of("mdbl") + n_of([2, 6]) * ops_of("cancel")
    b_ms, b_by = bound((10 * Lq * 4 + 1) * ne, ops)
    emit("kernel", kernel="xyzz_add_affine", field=f.name, n=ne, feed="edge classes",
         known_answer_pairs=len(ps), max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
         bound_by=b_by, share_of_bound=b_ms / ms)
    edge = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                share_of_bound=b_ms / ms)
    del X, Y, ZZ, ZZZ, AX, AY, P, got, want

    # generic feed: 2^20 random finite (P, A) pairs, the traffic of the JAX
    # package's XLA accumulate route (buckets += distinct points)
    X, Y, ZZ, ZZZ, AX, AY = (rand_field(f, ne) for _ in range(6))
    a_inf = torch.zeros(ne, dtype=torch.bool, device=dev)
    P = (X, Y, ZZ, ZZZ)
    got = ksw.xyzz_add_affine(G1, P, AX, AY, a_inf)
    want, plain_ms = once_ms(lambda: ksw.xyzz_add_affine_plain(G1, P, AX, AY, a_inf))
    err = max(check_equal(f"xyzz_add_affine generic, coordinate {i}", g, w_) for i, (g, w_) in
              enumerate(zip(got, want)))
    ms = time_ms(lambda: ksw.xyzz_add_affine(G1, P, AX, AY, a_inf), 20)
    b_ms, b_by = bound((10 * Lq * 4 + 1) * ne, ne * madd_ops)
    emit("kernel", kernel="xyzz_add_affine", field=f.name, n=ne, feed="generic", max_abs_err=err,
         ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms)
    report["xyzz_add_affine"] = dict(
        max_abs_err=max(err, edge["max_abs_err"]), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, share_of_bound=b_ms / ms, shape=f"{ne} generic pairs",
        registers=ptxas_of("xyzz_add_affine_kernel").get("registers"),
        spill_stores=ptxas_of("xyzz_add_affine_kernel").get("spill_stores"),
        edge_feed=dict(edge, shape=f"{ne} points, 7 edge classes"))
    del X, Y, ZZ, ZZZ, AX, AY, P, got, want, a_inf

    # mont_sqr's path: ec.sw.xyzz_double_affine (three squares and four
    # products a call) on 2^20 points, the 64 pool points and infinity
    # tiled, held against the host oracle; the shape of every mont_sqr
    # launch recorded around the launch function (the counts stay where
    # they are). Its kernel-vs-plain row is phase 2's, at the same shape.
    dbl_pts = pool + [None]
    tile = torch.arange(ne, device=dev) % len(dbl_pts)
    A64 = tsw.affine_from_ints(G1, dbl_pts, dev)
    Ad = tsw.AffinePoints(A64.x[:, tile], A64.y[:, tile], A64.inf[tile])
    sqr_shapes = collections.Counter()

    def recording_sqr(kernel, spec, *ins, **kw):
        if kernel == "mont_sqr":
            sqr_shapes[(spec.name, tuple(ins[0].shape), ins[0].is_contiguous())] += 1
        return launch(kernel, spec, *ins, **kw)

    sync()
    km._launch = recording_sqr
    try:
        kernels.reset_launches()
        Dd = tsw.xyzz_double_affine(G1, Ad)
        sync()
        sqr_launches = kernels.LAUNCHES["mont_sqr"]
    finally:
        km._launch = launch
    Da = tsw.xyzz_to_affine(G1, Dd)
    head = tsw.AffinePoints(Da.x[:, : len(dbl_pts)], Da.y[:, : len(dbl_pts)], Da.inf[: len(dbl_pts)])
    if (tsw.affine_to_ints(G1, head) != [ec_add(u, u, 0, mod) for u in dbl_pts]
            or not all(torch.equal(v, v[..., tile]) for v in Da)):
        raise AssertionError("xyzz_double_affine 2^20: doublings differ from the host oracle")
    if set(sqr_shapes) != {(FQ.name, (Lq, ne), True)} or sum(sqr_shapes.values()) != sqr_launches:
        raise AssertionError(f"xyzz_double_affine 2^20: mont_sqr launches {dict(sqr_shapes)}, "
                             f"{sqr_launches} counted; phase 2's row is at ({Lq}, {ne})")
    emit("double_affine", n=ne, correct=True, launches_mont_sqr=sqr_launches,
         mont_sqr_shapes=[[k[0], list(k[1]), v] for k, v in sqr_shapes.items()])
    del A64, Ad, Dd, Da, head

    # ---- 8. the field and G1 group path ------------------------------------------
    helpers = types.SimpleNamespace(
        dev=dev, sync=sync, time_ms=time_ms, once_ms=once_ms, rand_field=rand_field,
        check_equal=check_equal, mul_ops=mul_ops, sqr_ops=sqr_ops, pow_ops=pow_ops, add_ops=add_ops,
        bound=bound, emit=emit,
        distinct_elems=distinct_elems)
    rec, restore = install_recorders(torch, km)
    try:
        group_report = field_group_phase(torch, helpers, rec)
        for name, r in group_report.items():
            report[name]["group"] = r

        # ---- 9. the pairing path ---------------------------------------------------
        pair_report = pairing_phase(torch, helpers, rec)

        # ---- 10. BN254, GT and the BW6 pairings; the field kernels at NW = 24 ------
        nw24_report = bn_gt_bw6_phase(torch, helpers, rec)

        # ---- 11. msm_mixed, the MNT and CP6 pairings; the field kernels at NW = 10, 26
        new_report = mixed_mnt_cp6_phase(torch, helpers, rec)
    finally:
        restore()

    # ---- 12. fp_lin on edge words and on every recorded path input -----------
    report["fp_lin"] = lin_phase(torch, helpers, rec)
    del rec
    for name in ("mont_mul", "mont_sqr", "mont_inv", "mont_pow"):
        report[name]["pairing"] = pair_report.pop(name)
    report.update(pair_report)
    for name, r in nw24_report.items():
        report[name].update(r.pop("per_path_launches"))
        report[name]["nw24"] = r
    for name, r in new_report.items():
        report[name].update(r)
        if "msm_mixed" in r:  # its MSM kernels, held on msm_mixed's own inputs
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"],
                                              r["msm_mixed"]["max_abs_err"])

    # ---- 13. the polynomial layer and the scalar-multiplication family ---------
    rec13, restore13 = install_recorders(torch, km)
    try:
        phase13 = poly_scalar_phase(torch, helpers, rec13)
    finally:
        restore13()
    del rec13
    for name, r in phase13.items():
        report.setdefault(name, {})["phase13"] = r

    emit("cached_tables", after="phase 13's paths", **check_cached_tables(torch, km, table_snap))

    # ---- 14. the other curve models and hashing to curves -----------------------
    rec14, restore14 = install_recorders(torch, km)
    try:
        phase14 = curves_h2c_phase(torch, helpers, rec14)
    finally:
        restore14()
    del rec14

    # ---- 15. the small fields, the multi-device layer, serialization ------------
    phase15 = smallfield_dist_phase(torch, helpers)
    sf_rows = phase15.pop("rows")
    emit("cached_tables", after="phase 15's paths", **check_cached_tables(torch, km, table_snap))

    # ---- 16. kernels line ----------------------------------------------------
    sources = {
        "mont_mul": ("zkarray_torch/kernels/csrc/mont.cu", "zkarray/kernels/mont.py:235"),
        "mont_sqr": ("zkarray_torch/kernels/csrc/mont.cu", "zkarray/kernels/mont.py:254"),
        "xyzz_accum": ("zkarray_torch/kernels/csrc/sw.cu",
                       "zkarray/kernels/sw.py:309 and zkarray/kernels/sw.py:213"),
        "horner_windows": ("zkarray_torch/kernels/csrc/sw.cu", "zkarray/kernels/sw.py:497"),
        "butterfly_dit": ("zkarray_torch/kernels/csrc/ntt.cu", "zkarray/kernels/mont.py:266"),
        "butterfly_stage": ("zkarray_torch/kernels/csrc/ntt.cu", "zkarray/kernels/mont.py:317"),
        "xyzz_add_affine": ("zkarray_torch/kernels/csrc/madd.cu", "zkarray/kernels/sw.py:155"),
        # no Pallas counterpart: the product kernels' launch chains, fused
        "xyzz_add": ("zkarray_torch/kernels/csrc/xyzz.cu",
                     "zkarray/kernels/mont.py:235 and zkarray/kernels/mont.py:254, "
                     "fused into zkarray/ec/sw.py:376 xyzz_add"),
        "xyzz_double": ("zkarray_torch/kernels/csrc/xyzz.cu",
                        "zkarray/kernels/mont.py:235 and zkarray/kernels/mont.py:254, "
                        "fused into zkarray/ec/sw.py:408 xyzz_double"),
        "xyzz_tree_sum": ("zkarray_torch/kernels/csrc/xyzz.cu",
                          "zkarray/ec/msm.py:495 _tree_sum_last's per-level zkarray/ec/sw.py:376 "
                          "xyzz_add calls (zkarray/kernels/mont.py:235 and :254 inside), fused"),
        "mont_pow": ("zkarray_torch/kernels/csrc/mont.cu",
                     "zkarray/kernels/mont.py:235 and zkarray/kernels/mont.py:254, "
                     "fused into zkarray/ff/fp.py:321 pow_const"),
        "mont_inv": ("zkarray_torch/kernels/csrc/mont.cu",
                     "zkarray/kernels/mont.py:235 and zkarray/kernels/mont.py:254 in "
                     "zkarray/ff/fp.py:370 inv's Fermat chain (pow_const), by a batched binary GCD"),
        "mont_div": ("zkarray_torch/kernels/csrc/mont.cu",
                     "zkarray/ec/sw.py:174 xyzz_to_affine's two zkarray/ff/fp.py batch_inv calls "
                     "(zkarray/kernels/mont.py:235 inside, and :370 inv) and two products, fused "
                     "into one batched binary GCD a coordinate"),
        "xyzz_bit_horner": ("zkarray_torch/kernels/csrc/sw.cu",
                            "zkarray/ec/msm.py:550 the bit-Horner's zkarray/ec/sw.py:408 "
                            "xyzz_double and :376 xyzz_add calls (zkarray/kernels/mont.py:235 "
                            "and :254 inside), fused"),
        "pow_table": ("zkarray_torch/kernels/csrc/twiddle.cu",
                      "zkarray/kernels/mont.py:235, fused into zkarray/poly/domain.py:39 power_table"),
        "twiddle_mul": ("zkarray_torch/kernels/csrc/twiddle.cu",
                        "zkarray/kernels/mont.py:235 and zkarray/kernels/mont.py:254, fused into "
                        "zkarray/poly/domain.py:64 twiddle_table, :160 fft_fourstep_big's body1 "
                        "and :314 the degree-aware twist"),
        "fp_add": ("zkarray_torch/kernels/csrc/fadd.cu",
                   "none: zkarray/ff/fp.py:257 add (and :264 double), which XLA fuses"),
        "fp_sub": ("zkarray_torch/kernels/csrc/fadd.cu",
                   "none: zkarray/ff/fp.py:268 sub and :277 neg, which XLA fuses"),
        "fp_lin": ("zkarray_torch/kernels/csrc/flin.cu",
                   "none: the additions of zkarray/ff/towers.py's tower products (fp.py:257 add, "
                   ":268 sub), which XLA fuses; a redesign of fp_add/fp_sub for tower glue"),
        "sf_op": ("zkarray_torch/kernels/csrc/smallfp.cu",
                  "none: zkarray/ff/smallfp.py:79 mont_mul and its element-wise ops, :158 m31_mul, "
                  "zkarray/ff/fp64.py:141 mul and zkarray/ff/smallfp64.py:93 mont_mul (and their "
                  "pow_const scans), which XLA fuses"),
        "sf_butterfly": ("zkarray_torch/kernels/csrc/smallfp.cu",
                         "none: a stage of zkarray/ff/smallfp.py:175 ntt and zkarray/ff/fp64.py:253 "
                         "ntt (mont_mul/mul, add, sub, concatenate), which XLA fuses"),
    }
    paths = {k: (f"msm 2^{LOG_N}", launches[k]) for k in msm_kernels}
    for k in ("mont_mul", "mont_inv"):  # off the MSM since the to-affine is one mont_div
        paths[k] = (f"the field and G1 group path (phase 8, 2^{GROUP_LOG_N})",
                    report[k]["group"]["launches"])
    paths["mont_sqr"] = ("ec.sw.xyzz_double_affine", sqr_launches)
    paths["mont_pow"] = ("ff.fp.pow_const (Fq, one element, e = p - 2)", pow_launches)
    paths["xyzz_double"] = (f"ec.sw.xyzz_double ({ne} edge-class points)", dbl_launches)
    for k in ntt_kernels:
        paths[k] = (f"fft 2^{NTT_LOG_N}", ntt_launches[k])
    paths["butterfly_stage"] = ("kernels.mont.butterfly_stage", stage_launches)
    paths["xyzz_add_affine"] = ("ec.sw.xyzz_add_affine", madd_launches)
    for k in ("fp_add", "fp_sub", "fp_lin"):
        paths[k] = (f"ec.pairing.bls12.pairing_each (BLS12-381, 2^{PAIR_LOG_N} pairs)",
                    report[k]["launches"])
    paths["sf_op"] = (f"ff.smallfp/fp64/smallfp64 element-wise ops at 2^{SF_ELEM_LOG_N}",
                      phase15["sf_op"]["launches"]["small_field_elementwise"])
    paths["sf_butterfly"] = (f"ff.smallfp.ntt (BabyBear, 2^{SF_NTT_LOG_N} x {SF_NTT_COLS})",
                             phase15["sf_butterfly"]["launches"]["ntt_babybear"])
    for name in ("sf_op", "sf_butterfly"):
        widest = max(sf_rows[name], key=lambda r_: (r_["bound_by"] == "bytes", r_["bound_ms"]))
        report[name] = dict(max_abs_err=phase15[name]["max_abs_err"], ms=widest["ms"],
                            plain_ms=widest["plain_ms"], bound_ms=widest["bound_ms"],
                            bound_by=widest["bound_by"], share_of_bound=widest["share_of_bound"],
                            shape=f"widest launch: {widest}", rows=sf_rows[name])
    idle = [k for k, (_, n_l) in paths.items() if n_l == 0]
    if idle:
        raise AssertionError(f"kernels never launched on their path: {idle}")
    rows = []
    for name, (src, repl) in sources.items():
        r = report[name]
        r["phase14"] = phase14.get(name, dict(launches={}, max_abs_err=None))
        r["phase15"] = phase15.get(name, dict(launches={}, max_abs_err=None))
        widths = (sorted(_build.FIELD_LIBS) if name in FIELD_KERNELS + ("fp_lin", "mont_div") else
                  sorted(_build.NTT_LIBS) if name in NTT_KERNELS else
                  ["u32", "m31", "gl64", "u64"] if name == "sf_op" else ["u32", "gl64"]
                  if name == "sf_butterfly" else [8, 12])
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                     "path": paths[name][0], "launches": paths[name][1], "library_ms": None,
                     "nw_widths": widths, **r})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
