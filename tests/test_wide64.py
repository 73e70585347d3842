"""Pair-carrier 64-bit mode (interp/wide64): paired-32-bit limb
arithmetic and double-single f64, unit-tested against numpy int64/float64
ground truth and integration-tested through the mesh, whose 64-bit path
shards plane pairs and evaluates with these carriers (parallel/mesh.py);
the XLA path's native x64 is checked beside it."""

import random

import numpy as np
import pytest

from soda_tpu.backend import xla as xb
from soda_tpu.frontend.parser import parse
from soda_tpu.interp import numpy_interp
from soda_tpu.interp.wide64 import (
    W, WideXP, merge_planes, program_is_wide, split_planes)
from soda_tpu.parallel.mesh import run_sharded

rng = np.random.default_rng(7)


def pair(v):
    lo, hi = split_planes(np.asarray(v))
    rep = "i" if v.dtype == np.int64 else "u"
    return W(rep, lo, hi, np)


def unpair(w, dtype):
    return merge_planes(w.a, w.b, dtype)


# ---- unit: limb arithmetic vs int64 ground truth -------------------------


def test_pair_arithmetic_exact():
    xp = WideXP(np)
    a = rng.integers(-2**62, 2**62, 4000, dtype=np.int64)
    b = rng.integers(-2**62, 2**62, 4000, dtype=np.int64)
    wa, wb = pair(a), pair(b)
    assert np.array_equal(unpair(wa + wb, np.int64), a + b)
    assert np.array_equal(unpair(wa - wb, np.int64), a - b)
    assert np.array_equal(unpair(wa * wb, np.int64), a * b)
    assert np.array_equal(unpair(-wa, np.int64), -a)
    assert np.array_equal((wa < wb).a, a < b)
    assert np.array_equal((wa >= wb).a, a >= b)
    assert np.array_equal(unpair(xp.minimum(wa, wb), np.int64),
                          np.minimum(a, b))
    assert np.array_equal(unpair(xp.abs(wa), np.int64), np.abs(a))
    assert np.array_equal(unpair(wa & wb, np.int64), a & b)
    assert np.array_equal(unpair(wa ^ wb, np.int64), a ^ b)
    assert np.array_equal(unpair(~wa, np.int64), ~a)


@pytest.mark.parametrize("s", [0, 1, 7, 31, 32, 33, 63])
def test_pair_shifts_exact(s):
    xp = WideXP(np)
    a = rng.integers(-2**62, 2**62, 2000, dtype=np.int64)
    u = rng.integers(0, 2**64, 2000, dtype=np.uint64)
    wa, wu = pair(a), pair(u)
    assert np.array_equal(unpair(xp.left_shift(wa, s), np.int64), a << s)
    assert np.array_equal(unpair(xp.right_shift(wa, s), np.int64), a >> s)
    assert np.array_equal(unpair(xp.right_shift(wu, s), np.uint64), u >> s)


def test_pair_long_division_exact():
    xp = WideXP(np)
    a = rng.integers(-2**62, 2**62, 400, dtype=np.int64)
    b = (rng.integers(1, 2**45, 400, dtype=np.int64)
         * rng.choice([-1, 1], 400).astype(np.int64))
    assert np.array_equal(unpair(xp.floor_divide(pair(a), pair(b)),
                                 np.int64), a // b)
    u = rng.integers(0, 2**64, 400, dtype=np.uint64)
    v = rng.integers(1, 2**64, 400, dtype=np.uint64)
    assert np.array_equal(unpair(xp.floor_divide(pair(u), pair(v)),
                                 np.uint64), u // v)


def test_double_single_accuracy():
    xp = WideXP(np)
    a = rng.standard_normal(4000) * 10.0 ** rng.integers(-3, 4, 4000)
    b = rng.standard_normal(4000) * 10.0 ** rng.integers(-3, 4, 4000)

    def ds(v):
        lo, hi = split_planes(v)
        return W("d", hi, lo, np)

    def err(w, want):
        got = merge_planes(w.b, w.a, np.float64)
        return np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300))

    assert err(ds(a) + ds(b), a + b) < 1e-12
    assert err(ds(a) * ds(b), a * b) < 1e-13
    assert err(ds(a) / ds(b), a / b) < 1e-13
    assert err(xp.sqrt(xp.abs(ds(a))), np.sqrt(np.abs(a))) < 1e-13
    # trunc/floor/ceil are exact on the DS-representable value
    f = rng.standard_normal(4000) * 2.0 ** rng.integers(0, 45, 4000)
    lo, hi = split_planes(f)
    x_ds = hi.astype(np.float64) + lo.astype(np.float64)
    for fn, ref in ((xp.trunc, np.trunc), (xp.floor, np.floor),
                    (xp.ceil, np.ceil)):
        w = fn(ds(f))
        assert np.array_equal(merge_planes(w.b, w.a, np.float64), ref(x_ds))


def test_pair_float_conversions():
    i = rng.integers(-2**46, 2**46, 4000, dtype=np.int64)
    w = pair(i).astype(np.float64)
    got = merge_planes(w.b, w.a, np.float64)
    assert np.max(np.abs(got - i.astype(np.float64))
                  / np.maximum(np.abs(i.astype(np.float64)), 1)) < 1e-13
    back = w.astype(np.int64)
    assert np.array_equal(merge_planes(back.a, back.b, np.int64), i)


# ---- integration: mesh pair-carrier path vs the int64 oracle -------------


def pair_run(p, ins, params=None, **kw):
    """Run `p` through the mesh's pair-carrier path on 2 devices."""
    return run_sharded(p, ins, params, axis_sizes=[2], dims=[0], **kw)


def run_both(src, ins, it=None):
    p = parse(src)
    assert program_is_wide(p)
    gold = numpy_interp.run(p, ins, iterate=it)[p.output_names[0]]
    got = pair_run(p, ins, iterate=it)[p.output_names[0]]
    r = p.valid_rim(iterate=it) if it else p.valid_rim()
    sl = tuple(slice(r, -r) if r else slice(None)
               for _ in range(gold.ndim))
    return gold[sl], got[sl]


def test_pair_i64_bit_exact():
    x = rng.integers(-2**50, 2**50, (32, 128), dtype=np.int64)
    g, o = run_both(
        "kernel: s\ninput int64: a(128, *)\n"
        "output int64: out(0,0) = a(-1,0) * a(1,0) + (a(0,-1) >> 5)"
        " - a(0,1) + int64(123456789012345)\n", {"a": x})
    assert o.dtype == np.int64 and np.array_equal(g, o)


def test_pair_u64_division_bit_exact():
    u = rng.integers(1, 2**63, (32, 128), dtype=np.uint64)
    g, o = run_both(
        "kernel: u\ninput uint64: a(128, *)\n"
        "output uint64: out(0,0) = a(0,0) / (a(0,1) % uint64(1000000007)"
        " + uint64(1)) + (a(-1,0) & a(1,0))\n", {"a": u})
    assert o.dtype == np.uint64 and np.array_equal(g, o)


def test_pair_i64_c_division_negative():
    x = rng.integers(-2**50, 2**50, (32, 128), dtype=np.int64)
    g, o = run_both(
        "kernel: s\ninput int64: a(128, *)\n"
        "output int64: out(0,0) = a(0,0) / (a(0,1) % int64(999983)"
        " + int64(1000003)) + min(a(-1,0), a(1,0))\n", {"a": x})
    assert np.array_equal(g, o)


def test_pair_f64_double_single():
    f = rng.standard_normal((32, 128))
    g, o = run_both(
        "kernel: d\ninput double: a(128, *)\n"
        "output double: out(0,0) = (a(-1,0) + a(1,0) + a(0,-1) + a(0,1)"
        " + a(0,0)) * 0.2\n", {"a": f})
    assert o.dtype == np.float64
    # double-single: far beyond f32's ~1e-7
    assert np.abs(g - o).max() / np.abs(g).max() < 1e-12


def test_pair_wide_fused_sweeps():
    """Wide iterate programs fuse 8 sweeps per halo exchange on the pair
    path (pair-carrier shrinking extents) and stay bit-exact; f64 stays
    at double-single accuracy."""
    src = ("kernel: it64\niterate: 8\ninput int64: a(128, *)\n"
           "output int64: out(0,0) = (a(-1,0) + a(1,0) + a(0,-1)"
           " + a(0,1)) / int64(4)\n")
    p = parse(src)
    x = rng.integers(-2**45, 2**45, (256, 256), dtype=np.int64)
    gold = numpy_interp.run(p, {"a": x})["out"]
    got = pair_run(p, {"a": x}, sweeps_per_exchange=8)["out"]
    r = p.valid_rim()
    assert np.array_equal(gold[r:-r, r:-r], got[r:-r, r:-r])

    src2 = ("kernel: itd\niterate: 8\ninput double: a(128, *)\n"
            "output double: out(0,0) = (a(-1,0) + a(1,0) + a(0,-1)"
            " + a(0,1) + a(0,0)) * 0.2\n")
    p2 = parse(src2)
    f = rng.standard_normal((256, 256))
    gold2 = numpy_interp.run(p2, {"a": f})["out"]
    got2 = pair_run(p2, {"a": f}, sweeps_per_exchange=8)["out"]
    r2 = p2.valid_rim()
    assert np.abs(gold2[r2:-r2, r2:-r2] - got2[r2:-r2, r2:-r2]).max() < 1e-11


def test_pair_wide_iterate_and_rank3():
    x = rng.integers(-2**45, 2**45, (32, 128), dtype=np.int64)
    g, o = run_both(
        "kernel: it\niterate: 4\ninput int64: a(128, *)\n"
        "output int64: out(0,0) = (a(-1,0) + a(1,0) + a(0,-1) + a(0,1))"
        " / int64(4)\n", {"a": x})
    assert np.array_equal(g, o)
    x3 = rng.integers(-2**40, 2**40, (16, 16, 128), dtype=np.int64)
    g3, o3 = run_both(
        "kernel: r3\ninput int64: a(16, 16, *)\n"
        "output int64: out(0,0,0) = a(-1,0,0) + a(0,1,0)"
        " + a(0,0,-1) * int64(3)\n", {"a": x3})
    assert np.array_equal(g3, o3)


def test_pair_wide_rank1():
    x = rng.integers(-2**50, 2**50, 256, dtype=np.int64)
    g, o = run_both(
        "kernel: r1\ninput int64: a(*)\n"
        "output int64: out(0) = a(-1) + a(0) * int64(7) + a(1)\n",
        {"a": x})
    assert np.array_equal(g, o)


def test_pair_mixed_narrow_wide():
    m = rng.integers(0, 60000, (32, 128)).astype(np.uint16)
    g, o = run_both(
        "kernel: m\ninput uint16: a(128, *)\n"
        "output int64: out(0,0) = int64(a(-1,0)) * int64(a(1,0))"
        " * int64(a(0,-1)) + int64(a(0,1))\n", {"a": m})
    assert np.array_equal(g, o)


def test_wide_iterate_xla_native():
    """Wide ITERATE programs run native int64 in one scan on the XLA
    path, including non-pow2 wide division, bit-exactly."""
    p3 = parse("kernel: w3\niterate: 4\ninput int64: a(128, *)\n"
               "output int64: out(0,0) = (a(0,-1) + a(0,1)) / int64(5)\n")
    x = rng.integers(-2**50, 2**50, (32, 128), dtype=np.int64)
    gold = numpy_interp.run(p3, {"a": x})["out"]
    got = xb.run(p3, {"a": x})["out"]
    r = p3.valid_rim()
    assert np.array_equal(gold[:, r:-r], got[:, r:-r])


def test_pair_wide_shifts_both_dims():
    """Pair-carrier shifts along both dims match the oracle bit-exactly."""
    p = parse("kernel: ws\ninput int64: a(128, *)\n"
              "output int64: out(0,0) = a(-1,0) * int64(3) + a(1,0)"
              " - (a(0,-1) >> 2) + a(0,1)\n")
    x = rng.integers(-2**50, 2**50, (64, 128), dtype=np.int64)
    gold = numpy_interp.run(p, {"a": x})["out"]
    got = pair_run(p, {"a": x})["out"]
    r = p.valid_rim()
    assert np.array_equal(gold[r:-r, r:-r], got[r:-r, r:-r])


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_wide_pair_bit_exact(seed):
    """Random int64 expression trees: pair carriers == int64 oracle,
    bit-exact."""
    r = random.Random(7000 + seed)
    terms = []
    used_div = False
    for _ in range(r.randint(2, 5)):
        o = f"a({r.randint(-2, 2)}, {r.randint(-2, 2)})"
        k = r.random()
        if k < 0.2:
            terms.append(f"{o} * int64({r.randint(-5, 5)})")
        elif k < 0.35:
            terms.append(f"({o} >> {r.randint(0, 40)})")
        elif k < 0.5:
            terms.append(f"max({o}, a({r.randint(-2, 2)}, 0))")
        elif k < 0.6 and not used_div:
            # at most ONE general wide division per program: each one
            # unrolls a 64-step pair long division, and XLA:CPU compile
            # time explodes superlinearly in their count (~90 s at 4
            # divisions on a multicore box).  One per
            # program keeps the division path covered across seeds.
            used_div = True
            terms.append(f"{o} / (a(0, {r.randint(-2, 2)})"
                         f" % int64({r.randint(100, 10**6)})"
                         f" + int64({10**7}))")
        elif k < 0.7:
            terms.append(f"({o} > int64(0) ? {o} : -{o})")
        else:
            terms.append(o)
    src = ("kernel: fz\ninput int64: a(64, *)\n"
           f"output int64: out(0,0) = {' + '.join(terms)}\n")
    x = np.random.default_rng(seed).integers(
        -2**55, 2**55, (24, 128), dtype=np.int64)
    g, o = run_both(src, {"a": x})
    assert np.array_equal(g, o), src


def test_pair_wide_unaligned_grids():
    """Unaligned wide grids pad-to-shard on the pair path: bit-exact,
    incl. iterate."""
    src = ("kernel: wu\ninput int64: a(128, *)\n"
           "output int64: out(0,0) = a(-1,0) * int64(3) + a(1,0)"
           " - (a(0,-1) >> 2) + a(0,1)\n")
    p = parse(src)
    for gs in ((61, 130), (33, 70)):
        x = rng.integers(-2**50, 2**50, gs, dtype=np.int64)
        gold = numpy_interp.run(p, {"a": x})["out"]
        got = pair_run(p, {"a": x})["out"]
        r = p.valid_rim()
        assert np.array_equal(gold[r:-r, r:-r], got[r:-r, r:-r]), gs

    src2 = ("kernel: wi\niterate: 4\ninput int64: a(128, *)\n"
            "output int64: out(0,0) = a(-1,0) + a(1,0) + a(0,-1)"
            " + a(0,1)\n")
    p2 = parse(src2)
    x2 = rng.integers(-2**45, 2**45, (100, 128), dtype=np.int64)
    gold2 = numpy_interp.run(p2, {"a": x2})["out"]
    got2 = pair_run(p2, {"a": x2})["out"]
    r2 = p2.valid_rim()
    assert np.array_equal(gold2[r2:-r2, r2:-r2], got2[r2:-r2, r2:-r2])


def test_tcse_composes_with_wide():
    """--tcse rewrites of 64-bit programs run the pair-carrier path
    bit-exactly (hoisted partial-sum stages stay exact: the wide
    evaluator uses the oracle-width accumulator)."""
    from soda_tpu.optimize import tcse

    src = ("kernel: wtc\ninput int64: a(128, *)\n"
           "output int64: out(0,0) = a(-1,-1) + int64(2) * a(-1,0)"
           " + a(-1,1) + int64(2) * a(0,-1) + int64(4) * a(0,0)"
           " + int64(2) * a(0,1) + a(1,-1) + int64(2) * a(1,0)"
           " + a(1,1)\n")
    p = parse(src)
    q = tcse.apply(p)
    assert tcse.count_ops(q) < tcse.count_ops(p)
    x = rng.integers(-2**40, 2**40, (48, 128), dtype=np.int64)
    gold = numpy_interp.run(p, {"a": x})["out"]
    got = pair_run(q, {"a": x})["out"]
    r = max(p.valid_rim(), q.valid_rim())
    assert np.array_equal(gold[r:-r, r:-r], got[r:-r, r:-r])


def test_unroll_iterate_composes_with_wide():
    """--unroll-iterate stage-copy unrolling of wide programs is
    bit-exact through the pair carriers."""
    from soda_tpu.optimize import unroll

    src = ("kernel: wun\niterate: 4\ninput int64: a(128, *)\n"
           "output int64: out(0,0) = (a(-1,0) + a(1,0) + a(0,-1)"
           " + a(0,1)) >> 2\n")
    p = parse(src)
    pu = unroll.unroll_iterate(p, 4)
    x = rng.integers(-2**45, 2**45, (64, 128), dtype=np.int64)
    gold = numpy_interp.run(p, {"a": x})["out"]
    got = pair_run(pu, {"a": x})[pu.output_names[0]]
    r = p.valid_rim()
    assert np.array_equal(gold[r:-r, r:-r], got[r:-r, r:-r])


# ---- traced wide path (W is a pytree) ----------------------------------


def test_wide_2d_full_grid_bit_exact():
    """Zero-preserving int64 stencils are exact on the FULL grid through
    the pair path; double rides the same carriers at double-single
    accuracy."""
    src = ("kernel: wlb\ninput int64: a(256, *)\n"
           "output int64: out(0,0) = a(-1,0) + a(1,0) * int64(7)"
           " + (a(0,-1) >> 1) + a(0,1)\n")
    p = parse(src)
    x = rng.integers(-2**50, 2**50, (64, 128), dtype=np.int64)
    gold = numpy_interp.run(p, {"a": x})["out"]
    got = pair_run(p, {"a": x})["out"]
    assert np.array_equal(gold, got)  # zero-preserving: full-grid exact

    src_d = ("kernel: wlbd\ninput double: a(256, *)\n"
             "output double: out(0,0) = (a(-1,0) + a(1,0) + a(0,-1)"
             " + a(0,1)) * 0.25\n")
    pd = parse(src_d)
    y = rng.standard_normal((64, 128))
    gd = numpy_interp.run(pd, {"a": y})["out"]
    od = pair_run(pd, {"a": y})["out"]
    assert np.abs(gd - od).max() < 1e-12


def test_wide_deep_iterate_bit_exact():
    """24 fused sweeps per exchange carry W pairs through the constant-
    extent sweeps — deep-iterate int64 stays bit-exact."""
    src = ("kernel: wdeep\niterate: 24\ninput int64: a(96, *)\n"
           "output int64: out(0,0) = a(-1,0) + a(1,0) * int64(3)"
           " + (a(0,-1) >> 2) + a(0,1)\n")
    p = parse(src)
    x = rng.integers(-2**40, 2**40, (96, 128), dtype=np.int64)
    gold = numpy_interp.run(p, {"a": x})["out"]
    got = pair_run(p, {"a": x}, sweeps_per_exchange=24)["out"]
    r = p.valid_rim()
    assert np.array_equal(gold[r:-r, r:-r], got[r:-r, r:-r])


def test_wide_jit_end_to_end():
    """Wide programs with a 64-bit param above 2^32 jit end-to-end: the
    XLA path natively under x64, the mesh over plane pairs; both match
    the oracle bit-for-bit."""
    src = ("kernel: wjit\niterate: 4\ninput int64: a(128, *)\n"
           "param int64: k\n"
           "output int64: out(0,0) = (a(-1,0) + a(1,0) + a(0,-1)"
           " + a(0,1)) * k\n")
    p = parse(src)
    x = rng.integers(-2**40, 2**40, (64, 128), dtype=np.int64)
    ps = {"k": np.int64(3_000_000_019)}
    gold = numpy_interp.run(p, {"a": x}, ps)["out"]
    r = p.valid_rim()
    for got in (xb.run(p, {"a": x}, ps)["out"],
                pair_run(p, {"a": x}, ps, sweeps_per_exchange=2)["out"]):
        assert got.dtype == np.int64
        assert np.array_equal(gold[r:-r, r:-r], got[r:-r, r:-r])


def test_ds_exp_log_accuracy():
    """VERDICT r2 #8: exp/log/exp2/log2/pow are DS-accurate (three-part
    ln2 reduction + DS series) — ~1e-12 vs the f64 oracle, far beyond
    the old f32-accuracy fallback; specials saturate like IEEE f32."""
    xp = WideXP(np)

    def ds(v):
        lo, hi = split_planes(np.asarray(v, np.float64))
        return W("d", hi, lo, np)

    def err(w, want):
        got = merge_planes(w.b, w.a, np.float64)
        return np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300))

    r = np.random.default_rng(11)
    x = r.standard_normal(20000) * 10.0 ** r.integers(-4, 2, 20000)
    pos = np.abs(x) + 1e-6
    assert err(xp.exp(ds(x)), np.exp(x)) < 1e-10
    assert err(xp.log(ds(pos)), np.log(pos)) < 1e-10
    assert err(xp.exp2(ds(x)), np.exp2(x)) < 1e-10
    assert err(xp.log2(ds(pos)), np.log2(pos)) < 1e-10
    b = r.standard_normal(20000)
    assert err(xp.power(ds(pos), ds(b)), pos ** b) < 1e-10
    sp = merge_planes(xp.exp(ds(np.array([np.inf, -np.inf, np.nan]))).b,
                      xp.exp(ds(np.array([np.inf, -np.inf, np.nan]))).a,
                      np.float64)
    assert sp[0] == np.inf and sp[1] == 0.0 and np.isnan(sp[2])
    lg = merge_planes(xp.log(ds(np.array([0.0, -1.0]))).b,
                      xp.log(ds(np.array([0.0, -1.0]))).a, np.float64)
    assert lg[0] == -np.inf and np.isnan(lg[1])


def test_ds_exp_through_pair_path_matches_f64_oracle():
    """A poisson-style double program with exp matches the f64 oracle to
    1e-10 through the pair path."""
    src = ("kernel: pexp\ninput double: a(128, *)\n"
           "output double: out(0,0) = exp((a(-1,0) + a(1,0) + a(0,-1)"
           " + a(0,1)) * 0.1) + log(abs(a(0,0)) + 1.0)\n")
    p = parse(src)
    x = rng.standard_normal((48, 128))
    gold = numpy_interp.run(p, {"a": x})["out"]
    got = pair_run(p, {"a": x})["out"]
    assert np.abs(gold - got).max() / np.abs(gold).max() < 1e-10


def test_ds_inf_nan_semantics():
    """ADVICE r2: DS x/±0 gives sign-correct ±inf (0/0 NaN); DS min/max
    propagate NaN like numpy minimum/maximum."""
    xp = WideXP(np)

    def ds(v):
        lo, hi = split_planes(np.asarray(v, np.float64))
        return W("d", hi, lo, np)

    def out(w):
        return merge_planes(w.b, w.a, np.float64)

    with np.errstate(all="ignore"):
        q = out(ds(np.array([1.0, -1.0, 0.0])) / ds(np.array([0.0, 0.0, 0.0])))
    assert q[0] == np.inf and q[1] == -np.inf and np.isnan(q[2])
    n = np.array([np.nan, 1.0, np.nan])
    m = np.array([2.0, np.nan, np.nan])
    assert np.isnan(out(xp.minimum(ds(n), ds(m)))).all()
    assert np.isnan(out(xp.maximum(ds(n), ds(m)))).all()


def test_ds_trig_accuracy():
    """sin/cos/tan/tanh are DS-accurate (two-level Cody–Waite π/2
    reduction + DS Taylor; tanh via DS exp): ~1e-10 vs the f64 oracle in
    the Cody–Waite range |x| ≤ ~1.2e7; beyond, the integer Payne–Hanek
    reduction keeps DS accuracy over the whole finite range (see
    test_ds_trig_full_range_payne_hanek)."""
    xp = WideXP(np)

    def ds(v):
        lo, hi = split_planes(np.asarray(v, np.float64))
        return W("d", hi, lo, np)

    def err(w, want):
        got = merge_planes(w.b, w.a, np.float64)
        return np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-3))

    r = np.random.default_rng(12)
    x = r.uniform(-100, 100, 20000)
    assert err(xp.sin(ds(x)), np.sin(x)) < 1e-9
    assert err(xp.cos(ds(x)), np.cos(x)) < 1e-9
    xt = r.uniform(-1.5, 1.5, 20000)
    assert err(xp.tan(ds(xt)), np.tan(xt)) < 1e-10
    xh = r.uniform(-15, 15, 20000)
    assert err(xp.tanh(ds(xh)), np.tanh(xh)) < 1e-10
    assert np.array_equal(
        merge_planes(xp.tanh(ds(np.array([25.0, -25.0]))).b,
                     xp.tanh(ds(np.array([25.0, -25.0]))).a, np.float64),
        np.array([1.0, -1.0]))


def test_ds_trig_extended_range():
    """Round-3 continuation: the two-level Cody–Waite reduction keeps
    sin/cos exact to ~1e-13 ABSOLUTE out to |x| ≈ 1.2e7, including the
    worst case (x an exact multiple of π/2, where r is tiny and the old
    3200-limit single-level reduction would have lost everything);
    beyond the limit the Payne–Hanek path engages, and inf/NaN still
    produce NaN without polluting finite lanes."""
    xp = WideXP(np)

    def ds(v):
        lo, hi = split_planes(np.asarray(v, np.float64))
        return W("d", hi, lo, np)

    def back(w):
        return merge_planes(w.b, w.a, np.float64)

    r = np.random.default_rng(13)
    x = np.concatenate([
        r.uniform(-1.1e7, 1.1e7, 20000),
        np.arange(1, 4000) * (np.pi / 2),             # near-zero residues
        r.integers(1, 7_000_000, 4000) * (np.pi / 2)
        + r.standard_normal(4000) * 1e-6,
    ])
    xw = ds(x)
    xr = back(xw)  # the DS-representable value (48-bit mantissa)
    assert np.abs(back(xp.sin(xw)) - np.sin(xr)).max() < 1e-12
    assert np.abs(back(xp.cos(xw)) - np.cos(xr)).max() < 1e-12
    # beyond the Cody–Waite limit the Payne–Hanek path is DS-accurate
    # (1e9 is exactly representable in f32); inf/NaN propagate as NaN
    with np.errstate(all="ignore"):
        w = ds(np.array([1e9, np.inf, np.nan]))
        s = back(xp.sin(w))
    assert abs(s[0] - np.sin(np.float64(np.float32(1e9)))) < 1e-12
    assert np.isnan(s[1]) and np.isnan(s[2])


def test_ds_trig_full_range_payne_hanek():
    """sin/cos keep DS accuracy over the ENTIRE finite f32-pair range
    (round 4): the 131-bit integer Payne–Hanek reduction (_ph_reduce)
    replaces the old f32-accuracy fallback beyond |x| ≈ 1.2e7.  Checked
    against big-integer ground truth (exact rational x · 2/π mod 8 via
    the same integer-Machin π), including near-multiples of π/2 where the
    remainder cancels to ~1e-6, across exponents up to f32 max."""
    import math
    from fractions import Fraction

    from soda_tpu.interp.wide64 import W as Wc, _pi_bits, _ds_sincos

    B = 500
    t_int = ((2 << (2 * (B + 8))) // _pi_bits(B + 8)) >> 8

    def true_sincos(hi, lo):
        xf = Fraction(float(hi)) + Fraction(float(lo))
        k = xf.denominator.bit_length() - 1
        qs = (xf.numerator * t_int) % (8 << (B + k))
        n = round(qs / (1 << (B + k))) % 8
        fr = (qs - round(qs / (1 << (B + k))) * (1 << (B + k))) \
            / (1 << (B + k))
        rr = fr * math.pi / 2
        v = [math.sin(rr), math.cos(rr), -math.sin(rr), -math.cos(rr)]
        return v[n % 4], v[(n + 1) % 4]

    r = np.random.default_rng(44)
    cases = []
    for _ in range(200):  # full exponent sweep
        e = int(r.integers(24, 128))
        hi = np.float32(r.standard_normal() * 2.0 ** e)
        lo = np.float32(r.standard_normal() * abs(float(hi)) * 2.0 ** -25)
        cases.append((hi, lo))
    for _ in range(200):  # DS pairs near k·π/2: deep cancellation
        kk = int(r.integers(1, 2 ** 28))
        t = kk * math.pi / 2.0
        hi = np.float32(t)
        cases.append((hi, np.float32(t - float(hi))))
    his = np.array([c[0] for c in cases], np.float32)
    los = np.array([c[1] for c in cases], np.float32)
    sv, cv = _ds_sincos(Wc("d", his, los, np))
    for i, (hi, lo) in enumerate(cases):
        st, ct = true_sincos(hi, lo)
        assert abs(float(sv.a[i]) + float(sv.b[i]) - st) < 1e-13, \
            (hi, lo, st, float(sv.a[i]) + float(sv.b[i]))
        assert abs(float(cv.a[i]) + float(cv.b[i]) - ct) < 1e-13

    # traced path agrees with numpy to DS precision (1-ulp lo-limb FMA
    # contraction is the known, gated jit channel)
    import jax
    import jax.numpy as jnp

    def f(h, lo_):
        s, c = _ds_sincos(Wc("d", h, lo_, jnp))
        return s.a, s.b, c.a, c.b

    sh, sl, ch_, cl = (np.asarray(v, np.float64)
                       for v in jax.jit(f)(jnp.asarray(his),
                                           jnp.asarray(los)))
    assert np.abs(sh + sl - (sv.a.astype(np.float64) + sv.b)).max() < 1e-14
    assert np.abs(ch_ + cl - (cv.a.astype(np.float64) + cv.b)).max() < 1e-14


def test_ds_trig_big_args_through_pair_path():
    """The Payne–Hanek path (vector bitcasts, u32 word selects, dynamic
    shifts) runs traced on the pair path: a double stencil
    with sin/cos on arguments up to ~1e18 matches the f64 oracle.  The
    inputs are constructed as EXACT f32-pair sums (lo within [2^-29,
    2^-25] of hi) so the f64 oracle argument equals the DS pair
    bit-for-bit — at these magnitudes an input off by even one f64 ulp
    shifts the reduced argument by ~100 radians."""
    src = ("kernel: ptrigbig\ninput double: a(128, *)\n"
           "output double: out(0,0) = sin(a(0,0)) + cos(a(0,1)) * 0.5\n")
    p = parse(src)
    hi = (rng.standard_normal((48, 128)) * 1e18).astype(np.float32)
    lo = (hi * rng.uniform(2.0 ** -29, 2.0 ** -25,
                           (48, 128))).astype(np.float32)
    x = hi.astype(np.float64) + lo.astype(np.float64)
    gold = numpy_interp.run(p, {"a": x})["out"]
    got = pair_run(p, {"a": x})["out"]
    assert np.abs(gold - got).max() < 1e-9


def test_ds_trig_through_pair_path():
    """A double stencil with sin/cos matches the f64 oracle to 1e-9
    through the pair path."""
    src = ("kernel: ptrig\ninput double: a(128, *)\n"
           "output double: out(0,0) = sin(a(0,0)) * cos(a(0,1))"
           " + tanh(a(-1,0) + a(1,0))\n")
    p = parse(src)
    x = rng.standard_normal((48, 128)) * 3.0
    gold = numpy_interp.run(p, {"a": x})["out"]
    got = pair_run(p, {"a": x})["out"]
    assert np.abs(gold - got).max() < 1e-9


def test_rank1_wide_mixed_inputs_jit():
    """A rank-1 wide program with a NON-wide input traces on the pair
    path (wide and narrow tensors cross the shard boundary side by
    side)."""
    p = parse("kernel: r1w\ninput int64: a(2048)\ninput float: w(2048)\n"
              "output int64: out(0) = a(-1) + a(1) + int64(w(0) * 100.0)\n")
    x = rng.integers(-2**40, 2**40, 2048).astype(np.int64)
    f = rng.standard_normal(2048).astype(np.float32)
    gold = numpy_interp.run(p, {"a": x, "w": f})["out"]
    got = pair_run(p, {"a": x, "w": f})["out"]
    assert np.array_equal(gold[1:-1], got[1:-1])


def test_ds_pow_exponent_zero_is_one():
    """Review r3 #3: IEEE pow(x, 0) = 1 for every x including inf/NaN —
    the DS exp(0*log(x)) route must not leak NaN."""
    xp = WideXP(np)

    def ds(v):
        lo, hi = split_planes(np.asarray(v, np.float64))
        return W("d", hi, lo, np)

    r = xp.power(ds(np.array([np.inf, np.nan, 5.0, -3.0, 0.0])),
                 ds(np.zeros(5)))
    got = merge_planes(r.b, r.a, np.float64)
    assert (got == 1.0).all()


def test_wide_3d_bit_exact():
    """3-D 64-bit stencils on the pair path: int64 bit-exact on the full
    grid, sharded along z and along y; double at DS accuracy (the 'd'
    rep swaps plane order (hi, lo) vs ints (lo, hi) — the output
    plane-split path must honor it)."""
    src = ("kernel: lb3w\ninput int64: u(256, 256, *)\n"
           "output int64: r(0,0,0) = (u(-1,0,0) + u(1,0,0) + u(0,-1,0)"
           " + u(0,1,0) + u(0,0,-1) + u(0,0,1)) / 8 + u(0,0,0) * int64(3)\n")
    p = parse(src)
    x = rng.integers(-2**40, 2**40, (16, 32, 64)).astype(np.int64)
    gold = numpy_interp.run(p, {"u": x})["r"]
    assert np.array_equal(gold, pair_run(p, {"u": x})["r"])
    got2 = run_sharded(p, {"u": x}, axis_sizes=[4], dims=[1])["r"]
    assert np.array_equal(gold, got2)
    src_d = ("kernel: lb3d\ninput double: u(256, 256, *)\n"
             "output double: r(0,0,0) = (u(-1,0,0) + u(1,0,0) + u(0,-1,0)"
             " + u(0,1,0) + u(0,0,-1) + u(0,0,1)) * 0.166 - u(0,0,0)\n")
    pd = parse(src_d)
    xd = rng.standard_normal((16, 32, 64))
    gd = numpy_interp.run(pd, {"u": xd})["r"]
    od = pair_run(pd, {"u": xd})["r"]
    assert np.abs(gd - od).max() < 1e-12


def test_rank4_wide_bit_exact():
    """Rank-4 64-bit programs run on the pair path."""
    p = parse("kernel: r4w\ninput int64: a(8, 8, 16, *)\n"
              "output int64: b(0,0,0,0) = a(-1,0,0,0) + a(0,1,0,0)"
              " + a(0,0,-1,0) + a(0,0,0,1) * int64(7)\n")
    x = rng.integers(-2**40, 2**40, (8, 8, 16, 64)).astype(np.int64)
    gold = numpy_interp.run(p, {"a": x})["b"]
    got = pair_run(p, {"a": x})["b"]
    assert np.array_equal(gold, got)


def test_ds_cmath_surface_accuracy():
    """Round-3 continuation: atan/asin/acos/atan2/sinh/cosh/log10/expm1/
    log1p/hypot/copysign are DS-accurate (~1e-12 vs the f64 oracle);
    trunc stays exact.  Includes the small-argument regimes where naive
    formulations lose relative precision (expm1/log1p/sinh near 0)."""
    xp = WideXP(np)

    def ds(v):
        lo, hi = split_planes(np.asarray(v, np.float64))
        return W("d", hi, lo, np)

    def err(w, want):
        got = merge_planes(w.b, w.a, np.float64)
        return np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300))

    r = np.random.default_rng(11)
    x = np.concatenate([r.standard_normal(4000),
                        r.standard_normal(4000) * 1e-9,
                        r.standard_normal(2000) * 1e7,
                        r.uniform(-85, 85, 2000)])
    inr = np.clip(r.standard_normal(4000), -1.0, 1.0)
    pos = np.abs(x) + 1e-12
    with np.errstate(all="ignore"):
        assert err(xp.arctan(ds(x)), np.arctan(x)) < 1e-10
        assert err(xp.arcsin(ds(inr)), np.arcsin(inr)) < 1e-10
        # acos near 1 is absolutely (not relatively) conditioned
        w_ = xp.arccos(ds(inr))
        assert np.max(np.abs(merge_planes(w_.b, w_.a, np.float64)
                             - np.arccos(inr))) < 1e-12
        xs = x[np.abs(x) < 88.5]
        assert err(xp.sinh(ds(xs)), np.sinh(xs)) < 1e-10
        assert err(xp.cosh(ds(xs)), np.cosh(xs)) < 1e-10
        assert err(xp.log10(ds(pos)), np.log10(pos)) < 1e-10
        assert err(xp.expm1(ds(xs)), np.expm1(xs)) < 1e-10
        lp = x[x > -1]
        assert err(xp.log1p(ds(lp)), np.log1p(lp)) < 1e-10
        y2, x2 = r.standard_normal(4000) * 10, r.standard_normal(4000) * 10
        a2 = xp.arctan2(ds(y2), ds(x2))
        assert np.max(np.abs(merge_planes(a2.b, a2.a, np.float64)
                             - np.arctan2(y2, x2))) < 1e-12
        assert err(xp.hypot(ds(y2), ds(x2)), np.hypot(y2, x2)) < 1e-12
        # copysign is exact ON THE PAIR; the 2^-48 gap is the DS split of
        # the f64 input itself
        assert err(xp.copysign(ds(y2), ds(x2)), np.copysign(y2, x2)) < 1e-13
        t = xp.trunc(ds(y2))
        assert np.array_equal(merge_planes(t.b, t.a, np.float64),
                              np.trunc(y2))


def test_ds_cmath_specials():
    """IEEE edge semantics of the new DS fns match numpy: atan(+-inf) =
    +-pi/2, atan2 zero/inf quadrants, hypot(inf, nan) = inf, asin out of
    domain = NaN, copysign on -0."""
    xp = WideXP(np)

    def ds(v):
        lo, hi = split_planes(np.asarray(v, np.float64))
        return W("d", hi, lo, np)

    def out(w):
        return merge_planes(w.b, w.a, np.float64)

    with np.errstate(all="ignore"):
        assert np.allclose(out(xp.arctan(ds(np.array([np.inf, -np.inf])))),
                           [np.pi / 2, -np.pi / 2], rtol=1e-14)
        y = np.array([0.0, 0.0, -0.0, -0.0, np.inf, np.inf, -np.inf])
        xv = np.array([1.0, -1.0, -1.0, 1.0, np.inf, -np.inf, np.inf])
        got = out(xp.arctan2(ds(y), ds(xv)))
        want = np.arctan2(y, xv)
        assert np.allclose(got, want, rtol=1e-14)
        assert np.array_equal(np.signbit(got), np.signbit(want))
        assert out(xp.hypot(ds(np.array([np.inf])),
                            ds(np.array([np.nan]))))[0] == np.inf
        assert np.isnan(out(xp.arcsin(ds(np.array([1.5, -1.5]))))).all()
        cs = out(xp.copysign(ds(np.array([3.0, -3.0])),
                             ds(np.array([-0.0, 0.0]))))
        assert np.array_equal(cs, [-3.0, 3.0])
        assert np.isnan(out(xp.arctan(ds(np.array([np.nan]))))).all()


def test_ds_eft_survives_jit():
    """XLA:CPU's algebraic simplifier rewrites sub(add(a, b), a) -> b,
    which deleted Knuth two_sum's error term under jit (observed: DS
    `const + x` degraded to f32 accuracy).  The select-anchored Fast2Sum
    must keep full DS accuracy under jax.jit — this pins the whole wide
    path's accuracy on the CPU."""
    import jax

    import jax.numpy as jnp

    r = np.random.default_rng(3)
    x = np.abs(r.standard_normal(256)) * 0.8 + 0.05
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)

    def f(h, l):
        z = W("d", h, l, jnp)
        one = W.ds_from_float(1.0, jnp)
        from soda_tpu.interp.wide64 import _ds_add, _ds_mul, _ds_sqrt
        res = _ds_sqrt(_ds_add(one, _ds_mul(z, z)))
        return res.a, res.b

    a, b = jax.jit(f)(hi, lo)
    got = np.asarray(a).astype(np.float64) + np.asarray(b).astype(np.float64)
    assert np.abs(got - np.sqrt(1 + x * x)).max() < 1e-12


def test_ds_iterate_stays_accurate():
    """Fuzz seed 77: XLA:CPU's backend optimizations corrupted the
    double-single error-free transforms in FLAT-UNROLLED multi-sweep
    graphs.  The pair path traces each sweep of a chunk separately; two
    sweeps per exchange stay at DS accuracy, with an auxiliary input
    too."""
    src = ("kernel: fw\niterate: 2\ninput double: a(64, *)\n"
           "output double: out(0, 0) = a(-1, -1) * -1.25 + a(-1, 0)"
           " + a(0, 0) * 1.5 + a(1, 1) * -0.75\n")
    p = parse(src)
    shape = (32, 128)
    x = np.random.default_rng(77).standard_normal(shape) * 10.0
    gold = numpy_interp.run(p, {"a": x})["out"]
    got = np.asarray(pair_run(p, {"a": x}, sweeps_per_exchange=2)["out"])
    sl = (slice(2, -2), slice(2, -2))
    rel = (np.abs(got[sl] - gold[sl])
           / np.maximum(np.abs(gold[sl]), 1e-30))
    assert np.median(rel) < 1e-12, np.median(rel)

    src_aux = ("kernel: fa\niterate: 4\ninput double: a(64, *)\n"
               "input double: rhs(64, *)\n"
               "output double: out(0, 0) = (a(-1, 0) + a(1, 0)"
               " + a(0, -1) + a(0, 1)) * 0.25 + rhs(0, 0)\n")
    pa = parse(src_aux)
    rhs = np.random.default_rng(78).standard_normal(shape)
    gold_a = numpy_interp.run(pa, {"a": x, "rhs": rhs})["out"]
    got_a = pair_run(pa, {"a": x, "rhs": rhs})["out"]
    r = pa.valid_rim()
    assert np.abs(gold_a[r:-r, r:-r] - got_a[r:-r, r:-r]).max() < 1e-11


def test_ds_jit_vs_eager_bitwise_canary():
    """Canary for the EFT-vs-compiler bug class (three instances found
    round 3: two_sum's error term, the Dekker split, flat multi-sweep
    graphs).  The sweep-shaped DS graph must match BITWISE under jit;
    the transcendental chain is allowed benign lo-limb rewrite noise
    (~3e-15 today) but must stay far under the ~1e-8 failure mode.  If a
    jaxlib upgrade changes XLA:CPU's rewrite behavior, this trips before
    the fuzzer does."""
    import jax
    import jax.numpy as jnp

    from soda_tpu.backend.xla import shifted_jnp

    x = np.random.default_rng(9).standard_normal((8, 16)) * 10.0
    lo, hi = split_planes(x)
    xp = WideXP(jnp)

    def one_sweep(w):
        def tp(dy, dx):
            sl = w[dy + 1:dy + 1 + 6] if dy else w[1:7]
            return shifted_jnp(sl, (0, dx))
        return (tp(-1, -1) * -1.25 + tp(-1, 0) + tp(0, 0) * 1.5
                + tp(1, 1) * -0.75)

    def graph(h, l):
        w = W("d", h, l, jnp)
        s = one_sweep(w)
        # a transcendental on top: exp exercises the reduction + Taylor
        e = xp.exp(s * 0.01)
        return s.a, s.b, e.a, e.b

    eager = graph(jnp.asarray(hi), jnp.asarray(lo))
    jitted = jax.jit(graph)(jnp.asarray(hi), jnp.asarray(lo))
    for i in (0, 1):  # the sweep: bitwise
        assert np.array_equal(np.asarray(eager[i]), np.asarray(jitted[i])), i

    def merged(t):
        return merge_planes(np.asarray(t[3]), np.asarray(t[2]), np.float64)

    em, jm = merged(eager), merged(jitted)
    rel = np.abs(jm - em) / np.maximum(np.abs(em), 1e-30)
    assert rel.max() < 1e-13, rel.max()
