"""65..128-bit integers (interp/wide128): quad-limb carriers on the
NumPy-oracle and XLA paths, __int128 in the C++ golden runner — each
verified BIT-EXACT against Python-int (arbitrary-precision) ground truth.
Host tiles run them on the same carriers; the mesh rejects >64 loudly (a
typed error naming `--backend xla`)."""

import numpy as np
import pytest

from soda_tpu.frontend.parser import parse
from soda_tpu.interp import numpy_interp
from soda_tpu.interp.wide128 import (
    INT128, V, Wide128XP, _object_to_limbs, to_object_array)

rng = np.random.default_rng(9)
M128 = (1 << 128) - 1


def rand128(n, signed, bits=128):
    vals = np.array([int.from_bytes(rng.bytes(bits // 8), "little")
                     for _ in range(n)], dtype=object)
    if signed:
        vals = np.array([v - (1 << bits) if v >= (1 << (bits - 1)) else v
                         for v in vals], dtype=object)
    return vals


def wrap(v, signed, bits=128):
    v = int(v) & ((1 << bits) - 1)
    return v - (1 << bits) if signed and v >= (1 << (bits - 1)) else v


# ---- unit: limb arithmetic vs Python-int ground truth ---------------------


def test_limb_arithmetic_exact():
    xp = Wide128XP(np)
    n = 400
    a, b = rand128(n, True), rand128(n, True)
    va, vb = _object_to_limbs(a, "i", np), _object_to_limbs(b, "i", np)

    def out(v):
        return to_object_array(v, signed=True)

    assert (out(va + vb) == [wrap(x + y, True) for x, y in zip(a, b)]).all()
    assert (out(va - vb) == [wrap(x - y, True) for x, y in zip(a, b)]).all()
    assert (out(va * vb) == [wrap(x * y, True) for x, y in zip(a, b)]).all()
    assert (out(-va) == [wrap(-x, True) for x in a]).all()
    assert ((va < vb).l == (a < b)).all()
    assert ((va >= vb).l == (a >= b)).all()
    assert (out(va & vb) == [wrap(x & y, True) for x, y in zip(a, b)]).all()
    assert (out(~va) == [wrap(~x, True) for x in a]).all()
    assert (out(xp.minimum(va, vb)) == np.minimum(a, b)).all()
    assert (out(xp.abs(va)) == [wrap(abs(x), True) for x in a]).all()
    au, bu = rand128(n, False), rand128(n, False)
    vua, vub = _object_to_limbs(au, "u", np), _object_to_limbs(bu, "u", np)
    assert ((vua < vub).l == (au < bu)).all()


@pytest.mark.parametrize("s", [0, 1, 31, 32, 63, 64, 65, 100, 127])
def test_limb_shifts_exact(s):
    a = rand128(200, True)
    u = rand128(200, False)
    from soda_tpu.interp.wide128 import _shl_const, _shr_const

    def obj(xs):
        # keep the expected side an OBJECT array: a list whose values all
        # fit int64 would coerce to int64, and numpy's object-vs-int64
        # array equality evaluates elementwise False (observed quirk)
        return np.array([int(x) for x in xs], dtype=object)

    va = _object_to_limbs(a, "i", np)
    vu = _object_to_limbs(u, "u", np)
    assert (to_object_array(_shl_const(va, s), True)
            == obj(wrap(x << s, True) for x in a)).all()
    assert (to_object_array(_shr_const(va, s), True)
            == obj(wrap(x >> s, True) for x in a)).all()
    assert (to_object_array(_shr_const(vu, s), False)
            == obj(x >> s for x in u)).all()


def test_limb_dynamic_shift_and_division():
    xp = Wide128XP(np)
    n = 200
    a = rand128(n, True)
    va = _object_to_limbs(a, "i", np)
    sh = rng.integers(0, 127, n)
    got = to_object_array(xp.right_shift(va, np.asarray(sh)), True)
    assert (got == [wrap(int(x) >> int(s), True)
                    for x, s in zip(a, sh)]).all()
    au = rand128(n, False)
    bu = np.array([max(int(x), 1) for x in rand128(n, False)], dtype=object)
    q = xp.floor_divide(_object_to_limbs(au, "u", np),
                        _object_to_limbs(bu, "u", np))
    assert (to_object_array(q, False)
            == [int(x) // int(y) for x, y in zip(au, bu)]).all()


# ---- integration: oracle == XLA == C++ vs Python ints ----------------------

SRC_U = ("kernel: w128\ninput uint128: a(128, *)\n"
         "output uint128: out(0,0) = a(-1,0) * a(1,0) + (a(0,-1) >> 7)"
         " + a(0,1) / (a(0,0) % uint128(1000003) + uint128(1))\n")
SRC_I = ("kernel: w96\niterate: 2\ninput int96: a(128, *)\n"
         "output int96: out(0,0) = (a(-1,0) + a(1,0) + a(0,-1) + a(0,1))"
         " / 4 + a(0,0) * int96(12345678901)\n")


def _py_oracle_u128(x):
    H, W = x.shape

    def tap(i, j, di, dj):
        i2, j2 = i + di, j + dj
        return int(x[i2, j2]) if 0 <= i2 < H and 0 <= j2 < W else 0

    want = np.zeros((H, W), dtype=object)
    for i in range(H):
        for j in range(W):
            d = (tap(i, j, 0, 0) % 1000003 + 1)
            want[i, j] = (tap(i, j, -1, 0) * tap(i, j, 1, 0)
                          + (tap(i, j, 0, -1) >> 7)
                          + tap(i, j, 0, 1) // d) & M128
    return want


def test_oracle_u128_bit_exact_vs_python_ints():
    p = parse(SRC_U)
    x = rand128(16 * 24, False).reshape(16, 24)
    got = numpy_interp.run(p, {"a": x})["out"]
    assert (got == _py_oracle_u128(x)).all()


def test_xla_and_cpp_match_oracle():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from soda_tpu.backend import cpp, xla as xb

    for src, signed in ((SRC_U, False), (SRC_I, True)):
        p = parse(src)
        bits = 128 if not signed else 96
        x = rand128(16 * 24, signed, bits).reshape(16, 24)
        gold = numpy_interp.run(p, {"a": x})[p.output_names[0]]
        got_x = xb.run(p, {"a": x})[p.output_names[0]]
        assert (got_x == gold).all(), "XLA quad-limb"
        got_c = cpp.compile_and_run(p, {"a": x})[p.output_names[0]]
        assert (got_c == gold).all(), "C++ __int128"


def test_host_tile_runs_128_mesh_rejects_loudly():
    """Host tiles run >64-bit programs on quad-limb carriers, exactly;
    the mesh (64-bit plane pairs at most) rejects them by name."""
    from soda_tpu.parallel.host_tile import run_host_tiled
    from soda_tpu.parallel.mesh import run_sharded

    p = parse(SRC_U)
    x = rand128(16 * 24, False).reshape(16, 24)
    gold = numpy_interp.run(p, {"a": x})[p.output_names[0]]
    got = run_host_tiled(p, {"a": x}, tiles=(8, 12))[p.output_names[0]]
    assert (got == gold).all()

    with pytest.raises(NotImplementedError, match="backend xla"):
        run_sharded(p, {"a": x}, axis_sizes=[8])


def test_float_conversions_and_casts():
    """int128 <-> float is exact to f64 precision; cast masking to
    narrower widths matches Python-int two's complement."""
    p = parse("kernel: wc\ninput int128: a(128, *)\n"
              "output int128: out(0,0) = int128(double(a(0,0)) * 0.5)"
              " + int128(int96(a(0,1)))\n")
    vals = np.array([int(v) for v in
                     rng.integers(-2**49, 2**49, (16, 128)).reshape(-1)],
                    dtype=object).reshape(16, 128)
    got = numpy_interp.run(p, {"a": vals})["out"]

    def tap(i, j, dj):
        j2 = j + dj
        return int(vals[i, j2]) if 0 <= j2 < 128 else 0

    import math

    want = np.zeros((16, 128), dtype=object)
    for i in range(16):
        for j in range(128):
            want[i, j] = (int(math.trunc(float(tap(i, j, 0)) * 0.5))
                          + wrap(tap(i, j, 1), True, 96))
    assert (got == want).all()


def test_uint_narrow_iterate_xla_scan_rep():
    """Review r3 #1: uint65..127 programs wrap inputs with the CARRIER rep
    ("i" — C promotion of narrower unsigned), so the scan-carry pytree
    stays consistent across iterate feedback on the XLA backend."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from soda_tpu.backend import xla as xb

    p = parse("kernel: u100\niterate: 2\ninput uint100: a(64, *)\n"
              "output uint100: out(0,0) = a(0,-1) + a(0,1) * uint100(3)\n")
    x = rand128(16 * 48, False, 100).reshape(16, 48)
    gold = numpy_interp.run(p, {"a": x})["out"]
    got = xb.run(p, {"a": x})["out"]
    assert (got == gold).all()
