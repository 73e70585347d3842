"""Computation-reuse (tcse) pass tests — the DAC'20 rewrite analog
(reference: src/soda/optimization/tcse.py, SURVEY.md §2.1 L6)."""

import pathlib

import numpy as np

from soda_tpu.frontend.parser import parse, parse_file
from soda_tpu.interp import numpy_interp
from soda_tpu.optimize import tcse

SODA = pathlib.Path(__file__).parent / "soda"
rng = np.random.default_rng(21)


BOX9 = (
    "kernel: box9\n"
    "input uint16: img(512, *)\n"
    "output uint16: out(0, 0) = (img(-1,-1) + img(-1,0) + img(-1,1)"
    " + img(0,-1) + img(0,0) + img(0,1)"
    " + img(1,-1) + img(1,0) + img(1,1)) / 9\n"
)


def test_box9_decomposes_two_levels():
    p = parse(BOX9)
    q = tcse.apply(p)
    # 3x3 box sum -> column sums + row sum of column sums
    assert len(q.stage_order()) == 2  # out + 1 hoisted stage
    hoisted = [n for n in q.tensors if "__cse" in n]
    assert len(hoisted) == 1
    assert tcse.count_adds(q) < tcse.count_adds(p)
    assert tcse.count_adds(q) == 4  # 2 (row sum) + 2 (column sum)


def test_box9_bit_exact_int():
    p = parse(BOX9)
    q = tcse.apply(p)
    x = rng.integers(0, 65535, (40, 56)).astype(np.uint16)
    a = numpy_interp.run(p, {"img": x})["out"]
    b = numpy_interp.run(q, {"img": x})["out"]
    # partial-sum stages widen the border-invalid rim (composed radii);
    # the valid interior is bit-exact (integer reassociation is exact)
    rim = q.valid_rim()
    sl = (slice(rim, -rim), slice(rim, -rim))
    assert np.array_equal(a[sl], b[sl])


def test_seidel_float_close():
    p = parse_file(SODA / "seidel2d.soda")
    q = tcse.apply(p)
    assert tcse.count_adds(q) < tcse.count_adds(p)
    x = rng.standard_normal((32, 48)).astype(np.float32)
    a = numpy_interp.run(p, {"s0": x})["s1"]
    b = numpy_interp.run(q, {"s0": x})["s1"]
    rim = q.valid_rim()
    sl = (slice(rim, -rim), slice(rim, -rim))
    assert np.allclose(a[sl], b[sl], rtol=1e-5, atol=1e-5)


def test_plus_shape_not_decomposed():
    # 5-point jacobi has no uniform generator/stride tiling
    p = parse_file(SODA / "jacobi2d.soda")
    q = tcse.apply(p)
    assert tcse.count_adds(q) == tcse.count_adds(p)
    assert not [n for n in q.tensors if "__cse" in n]


def test_non_sum_programs_untouched():
    for name in ("blur", "sobel2d", "denoise2d"):
        p = parse_file(SODA / f"{name}.soda")
        q = tcse.apply(p)
        x_adds = tcse.count_adds(p)
        # blur's 3-tap rows are chains (m=3, G=1): cost 2 == n-1 -> no gain
        assert tcse.count_adds(q) <= x_adds


def test_hoisted_stage_type_is_wide():
    p = parse(BOX9)
    q = tcse.apply(p)
    h = [n for n in q.tensors if "__cse" in n][0]
    assert q.tensors[h].type.width == 32  # partial sums don't mask at uint16


def test_xla_runs_tcse_program():
    from soda_tpu.parallel.host_tile import run_host_tiled

    p = parse(BOX9)
    q = tcse.apply(p)
    x = rng.integers(0, 65535, (48, 128)).astype(np.uint16)
    gold = numpy_interp.run(p, {"img": x})["out"]
    got = run_host_tiled(q, {"img": x}, tiles=(16, 64))["out"]
    rim = q.valid_rim()
    sl = (slice(rim, -rim), slice(rim, -rim))
    assert np.array_equal(got[sl], gold[sl])


def test_big_box_25():
    src = (
        "kernel: box25\n"
        "input float: a(512, *)\n"
        "output float: out(0, 0) = ("
        + " + ".join(f"a({i},{j})" for i in range(-2, 3) for j in range(-2, 3))
        + ") * 0.04f\n"
    )
    p = parse(src)
    q = tcse.apply(p)
    # 24 adds -> at worst the separable 8 (4 row + 4 column); the recursive
    # pass finds 6 via second-level reuse of pair sums
    assert tcse.count_adds(p) == 24
    assert tcse.count_adds(q) <= 8
    x = rng.standard_normal((32, 48)).astype(np.float32)
    a = numpy_interp.run(p, {"a": x})["out"]
    b = numpy_interp.run(q, {"a": x})["out"]
    rim = q.valid_rim()
    sl = (slice(rim, -rim), slice(rim, -rim))
    assert np.allclose(a[sl], b[sl], rtol=1e-4, atol=1e-5)


# ---- weighted reuse (round 2: DAC'20 coefficient sum trees) ---------------


def test_gaussian2d_weighted_chain():
    # (1,4,6,4,1) = (1+y)^4: all multiplies factor into a binomial add chain
    p = parse_file(SODA / "gaussian2d.soda")
    q = tcse.apply(p)
    assert tcse.count_muls(p) == 6 and tcse.count_adds(p) == 8
    assert tcse.count_muls(q) == 0
    assert tcse.count_adds(q) == 8
    assert tcse.count_ops(q) < tcse.count_ops(p)
    x = rng.integers(0, 65535, (48, 64)).astype(np.uint16)
    a = numpy_interp.run(p, {"g_in": x})["g_out"]
    b = numpy_interp.run(q, {"g_in": x})["g_out"]
    rim = q.valid_rim()
    sl = (slice(rim, -rim), slice(rim, -rim))
    assert sl[0].stop is not None and a[sl].size  # guard vacuous compare
    assert np.array_equal(a[sl], b[sl])


def test_gauss5x5_full_2d_factorizes():
    # the non-prefactored 25-tap 2D Gaussian: separable + binomial discovery
    p = parse_file(SODA / "gauss5x5.soda")
    q = tcse.apply(p)
    assert tcse.count_adds(p) == 24 and tcse.count_muls(p) == 21
    assert tcse.count_adds(q) == 8 and tcse.count_muls(q) == 0
    x = rng.integers(0, 65535, (48, 64)).astype(np.uint16)
    a = numpy_interp.run(p, {"q_in": x})["q_out"]
    b = numpy_interp.run(q, {"q_in": x})["q_out"]
    rim = q.valid_rim()
    sl = (slice(rim, -rim), slice(rim, -rim))
    assert a[sl].size
    assert np.array_equal(a[sl], b[sl])


def test_conv5x5_free_weights_untouched():
    # 25 independent symbolic coefficients admit no reuse; tcse must not
    # touch the program (rewriting would be unsound or useless)
    p = parse_file(SODA / "conv5x5.soda")
    q = tcse.apply(p)
    assert tcse.count_adds(q) == tcse.count_adds(p)
    assert tcse.count_muls(q) == tcse.count_muls(p)
    assert not [n for n in q.tensors if "__cse" in n]


def test_triangle_kernel_quadratic_factor():
    # (1,2,3,2,1) = (1+y+y^2)^2: needs the quadratic factor search
    src = (
        "kernel: tri\n"
        "input uint16: a(512, *)\n"
        "output uint32: out(0, 0) = a(0,-2) + 2*a(0,-1) + 3*a(0,0)"
        " + 2*a(0,1) + a(0,2)\n"
    )
    p = parse(src)
    q = tcse.apply(p)
    assert tcse.count_ops(q) < tcse.count_ops(p)
    assert tcse.count_muls(q) == 0  # (a+a'+a'') twice: 4 adds total
    x = rng.integers(0, 60000, (16, 64)).astype(np.uint16)
    a = numpy_interp.run(p, {"a": x})["out"]
    b = numpy_interp.run(q, {"a": x})["out"]
    rim = q.valid_rim()
    sl = (slice(rim, -rim), slice(rim, -rim)) if rim else (slice(None),) * 2
    assert np.array_equal(a[sl], b[sl])


def test_hoisted_type_is_int64_for_wide_parents():
    # ADVICE r1: int64/uint64 parents must hoist at 64-bit, not int32 —
    # masking partial sums to 32 bits corrupts 64-bit programs
    src = (
        "kernel: box9w\n"
        "input uint64: img(512, *)\n"
        "output uint64: out(0, 0) = img(-1,-1) + img(-1,0) + img(-1,1)"
        " + img(0,-1) + img(0,0) + img(0,1)"
        " + img(1,-1) + img(1,0) + img(1,1)\n"
    )
    p = parse(src)
    q = tcse.apply(p)
    hoisted = [n for n in q.tensors if "__cse" in n]
    assert hoisted and all(q.tensors[h].type.width == 64 for h in hoisted)
    x = rng.integers(0, 2**63, (24, 32), dtype=np.uint64)
    a = numpy_interp.run(p, {"img": x})["out"]
    b = numpy_interp.run(q, {"img": x})["out"]
    rim = q.valid_rim()
    sl = (slice(rim, -rim), slice(rim, -rim))
    assert a[sl].size
    assert np.array_equal(a[sl], b[sl])


def test_float_weighted_sum_close():
    src = (
        "kernel: fw\n"
        "input float: a(512, *)\n"
        "output float: out(0, 0) = 0.0625*a(0,-2) + 0.25*a(0,-1)"
        " + 0.375*a(0,0) + 0.25*a(0,1) + 0.0625*a(0,2)\n"
    )
    p = parse(src)
    q = tcse.apply(p)
    assert tcse.count_ops(q) < tcse.count_ops(p)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    a = numpy_interp.run(p, {"a": x})["out"]
    b = numpy_interp.run(q, {"a": x})["out"]
    rim = q.valid_rim()
    sl = (slice(rim, -rim), slice(rim, -rim)) if rim else (slice(None),) * 2
    assert np.allclose(a[sl], b[sl], rtol=1e-5, atol=1e-6)


def test_hoisted_width_from_value_bound():
    """Review r2: hoisted partial sums feeding value-dependent ops must not
    mask — the store width comes from a static value bound.  int32 taps
    near 2^31 widen the hoist to int64 (exact division); uint16 chains
    (provably < 2^31) keep int32 so the 32-bit path still runs them."""
    src = (
        "kernel: g\n"
        "input int32: a(64, *)\n"
        "output int32: out(0,0) = (a(0,-2) + 4*a(0,-1) + 6*a(0,0)"
        " + 4*a(0,1) + a(0,2)) / 16\n"
    )
    p = parse(src)
    q = tcse.apply(p)
    assert any(q.tensors[n].type.width == 64
               for n in q.tensors if "__cse" in n)
    x = np.full((8, 64), 2**28, np.int32)
    a = numpy_interp.run(p, {"a": x})["out"]
    b = numpy_interp.run(q, {"a": x})["out"]
    r = max(p.valid_rim(), q.valid_rim())
    assert np.array_equal(a[:, r:-r], b[:, r:-r])
    # the declared-uint32 gx stage is BOUNDED by its expression, so
    # gaussian2d's hoists stay int32 (no x64 mode needed)
    q2 = tcse.apply(parse_file(SODA / "gaussian2d.soda"))
    assert all(q2.tensors[n].type.width == 32
               for n in q2.tensors if "__cse" in n)


def test_big_weights_fast():
    """Review r2: divisor enumeration is O(sqrt n) — billion-scale weights
    must not hang."""
    import time

    src = (
        "kernel: b\n"
        "input int32: a(64, *)\n"
        "output int32: out(0,0) = 1000000007*a(0,-1) + 3*a(0,0)"
        " + 1000000007*a(0,1)\n"
    )
    t0 = time.perf_counter()
    tcse.apply(parse(src))
    assert time.perf_counter() - t0 < 5.0


def test_minmax_reduction_reuse():
    """Round 2: DAC'20 idempotent-reduction reuse — min/max trees factor
    via OVERLAPPING covers (legal because min/max are idempotent)."""
    # 3x3 max (dilate): separable row/col max, 8 -> 4 ops
    p = parse_file(SODA / "dilate2d.soda")
    q = tcse.apply(p)
    assert tcse.count_ops(p) == 8 and tcse.count_ops(q) == 4
    h = [n for n in q.tensors if "__cse" in n]
    assert h and all(q.tensors[n].type == p.tensors["d_in"].type for n in h)
    x = rng.integers(0, 255, (40, 64)).astype(np.uint8)
    a = numpy_interp.run(p, {"d_in": x})["d_out"]
    b = numpy_interp.run(q, {"d_in": x})["d_out"]
    r = max(p.valid_rim(), q.valid_rim())
    assert np.array_equal(a[r:-r, r:-r], b[r:-r, r:-r])

    # 5-tap 1-D min: OVERLAPPING cover (two 3-tap mins), 4 -> 3 ops
    p5 = parse(
        "kernel: m5\ninput uint16: a(64, *)\n"
        "output uint16: out(0,0) = min(min(min(a(0,-2), a(0,-1)),"
        " min(a(0,0), a(0,1))), a(0,2))\n")
    q5 = tcse.apply(p5)
    assert tcse.count_ops(q5) == 3
    y = rng.integers(0, 60000, (8, 64)).astype(np.uint16)
    a5 = numpy_interp.run(p5, {"a": y})["out"]
    b5 = numpy_interp.run(q5, {"a": y})["out"]
    r5 = max(p5.valid_rim(), q5.valid_rim())
    assert np.array_equal(a5[:, r5:-r5], b5[:, r5:-r5])

    # plus-shaped erode: the 4 outer taps pair along the diagonal (4 -> 3)
    pe = parse_file(SODA / "erode2d.soda")
    qe = tcse.apply(pe)
    assert tcse.count_ops(pe) == 4 and tcse.count_ops(qe) == 3
    z = rng.integers(0, 255, (24, 48)).astype(np.uint8)
    ae = numpy_interp.run(pe, {"e_in": z})["e_out"]
    be = numpy_interp.run(qe, {"e_in": z})["e_out"]
    re_ = max(pe.valid_rim(), qe.valid_rim())
    assert np.array_equal(ae[re_:-re_, re_:-re_], be[re_:-re_, re_:-re_])


def test_mixed_fractional_weight_untouched_group():
    """Review r2: a fractional-const tap on an int tensor alongside a
    rewritable group must rebuild, not crash (the fraction is legal DSL —
    it promotes to float)."""
    src = (
        "kernel: mx\n"
        "input uint8: a(64, *)\ninput uint8: b(64, *)\n"
        "output float: o(0,0) = 0.5 * a(0,0) + b(0,-1) + b(0,0)"
        " + b(0,1) + b(0,2)\n"
    )
    p = parse(src)
    q = tcse.apply(p)  # must not raise
    assert tcse.count_ops(q) <= tcse.count_ops(p)
    x = rng.integers(0, 255, (8, 64)).astype(np.uint8)
    y = rng.integers(0, 255, (8, 64)).astype(np.uint8)
    a = numpy_interp.run(p, {"a": x, "b": y})["o"]
    b2 = numpy_interp.run(q, {"a": x, "b": y})["o"]
    r = max(p.valid_rim(), q.valid_rim())
    sl = (slice(None), slice(r, -r)) if r else (slice(None),) * 2
    assert np.allclose(a[sl], b2[sl], rtol=1e-6, atol=1e-6)


def test_wide_hoists_stay_runnable():
    """Heavy-fuzz finding: int32-parent weighted hoists are typed int64
    for ORACLE exactness; they are synthetic, so the mesh keeps its
    32-bit path (no pair carriers) and the XLA path runs them in x64 —
    both exact vs the unrewritten program."""
    from soda_tpu.backend import xla as xb
    from soda_tpu.interp.wide64 import program_is_wide
    from soda_tpu.parallel.mesh import run_sharded

    src = (
        "kernel: w\n"
        "input int32: a(64, *)\n"
        "output int32: out(0,0) = 4*a(-1,-1) + 8*a(-1,0) + 2*a(-1,1)"
        " + 8*a(0,-1) + 16*a(0,0) + 4*a(0,1)"
        " + 8*a(1,-1) + 16*a(1,0) + 4*a(1,1)\n"
    )
    p = parse(src)
    q = tcse.apply(p)
    assert any(q.tensors[n].type.width == 64
               for n in q.tensors if "__cse" in n)
    assert not program_is_wide(q)  # internal stages exempt
    x = rng.integers(0, 500, (40, 56)).astype(np.int32)
    a = numpy_interp.run(p, {"a": x})["out"]
    r = max(p.valid_rim(), q.valid_rim())
    for b in (xb.run(q, {"a": x})["out"],
              run_sharded(q, {"a": x}, axis_sizes=[2], dims=[0])["out"]):
        assert np.array_equal(a[r:-r, r:-r], b[r:-r, r:-r])


def test_cubic_factor_global_selection():
    """VERDICT r2 #9: (1+y+y³)² has ONLY an irreducible cubic factor —
    the old quadratic-capped per-level search found no reuse; the
    Kronecker-bounded cubic search + global (multi-level memoized) cost
    selection decomposes it to the 4-add/0-mul chain, bit-exact."""
    src = ("kernel: cub\ninput int32: a(128, *)\n"
           "output int32: out(0,0) = a(0,0) + 2 * a(0,1) + a(0,2)"
           " + 2 * a(0,3) + 2 * a(0,4) + a(0,6)\n")
    p = parse(src)
    q = tcse.apply(p)
    assert len(q.tensors) == 3  # one hoisted cubic stage
    # 5 adds + 3 muls -> 4 adds + 0 muls (both levels unit-coefficient)
    assert tcse.count_adds(q) < tcse.count_adds(p)
    from soda_tpu.ir import expr as ir
    muls = sum(1 for t in q.tensors.values() if t.expr is not None
               for n in ir.walk(t.expr)
               if isinstance(n, ir.BinOp) and n.op == "*")
    assert muls == 0
    x = np.random.default_rng(0).integers(0, 1000, (16, 64)).astype(np.int32)
    g0 = numpy_interp.run(p, {"a": x})["out"]
    g1 = numpy_interp.run(q, {"a": x})["out"]
    r = max(p.valid_rim(), q.valid_rim())
    assert np.array_equal(g0[r:-r, r:-r], g1[r:-r, r:-r])


def test_global_selection_scores_full_decomposition():
    """The selector scores candidates by fully-decomposed cost: for
    (1+y)⁴ the first-level choice is the head of the 4-add binomial
    chain and the fixed point reaches it."""
    src = ("kernel: bin\ninput int32: a(128, *)\n"
           "output int32: out(0,0) = a(0,0) + 4 * a(0,1) + 6 * a(0,2)"
           " + 4 * a(0,3) + a(0,4)\n")
    p = parse(src)
    q = tcse.apply(p)
    # full binomial chain: 4 one-add stages, no multiplies
    assert tcse.count_adds(q) == 4
    x = np.random.default_rng(1).integers(0, 500, (16, 64)).astype(np.int32)
    g0 = numpy_interp.run(p, {"a": x})["out"]
    g1 = numpy_interp.run(q, {"a": x})["out"]
    r = max(p.valid_rim(), q.valid_rim())
    assert np.array_equal(g0[r:-r, r:-r], g1[r:-r, r:-r])
