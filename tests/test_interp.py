"""NumPy golden-model interpreter tests: independently hand-written loop
nests as the oracle-of-the-oracle (reference analog: the generated host's
naive C++ loop nest, SURVEY.md §4)."""

import pathlib

import numpy as np
import pytest

from soda_tpu.frontend.parser import parse, parse_file
from soda_tpu.interp.numpy_interp import run, shifted

SODA = pathlib.Path(__file__).parent / "soda"
rng = np.random.default_rng(42)


def test_shifted_zero_fill():
    a = np.arange(12.0).reshape(3, 4)
    s = shifted(a, (1, 0))
    assert np.array_equal(s[:2], a[1:])
    assert np.all(s[2] == 0)
    s = shifted(a, (0, -1))
    assert np.array_equal(s[:, 1:], a[:, :3])
    assert np.all(s[:, 0] == 0)


def test_blur_uint16_exact():
    p = parse_file(SODA / "blur.soda")
    x = rng.integers(0, 65535, (40, 56)).astype(np.uint16)
    out = run(p, {"input": x})["blur_y"]
    xi = x.astype(np.int64)
    xp = np.pad(xi, ((1, 1), (0, 2)))
    bx = (xp[:, 0:56] + xp[:, 1:57] + xp[:, 2:58]) // 3
    by = (bx[0:40] + bx[1:41] + bx[2:42]) // 3
    assert np.array_equal(out, (by & 0xFFFF).astype(np.uint16))


def test_jacobi2d_iterate8():
    p = parse_file(SODA / "jacobi2d.soda")
    assert p.iterate == 8
    x = rng.standard_normal((24, 32)).astype(np.float32)
    out = run(p, {"t0": x})["t1"]
    a = x.copy()
    for _ in range(8):
        ap = np.pad(a, 1)
        a = ((ap[1:25, 2:34] + ap[2:26, 1:33] + ap[1:25, 1:33]
              + ap[1:25, 0:32] + ap[0:24, 1:33]) * np.float32(0.2)).astype(np.float32)
    assert np.allclose(out, a, rtol=1e-6, atol=1e-6)


def test_jacobi3d_single_sweep():
    p = parse_file(SODA / "jacobi3d.soda")
    x = rng.standard_normal((12, 16, 20)).astype(np.float32)
    out = run(p, {"t0": x})["t1"]
    ap = np.pad(x, 1)
    Z, Y, X = x.shape
    g = (ap[1:1+Z, 1:1+Y, 1:1+X] + ap[1:1+Z, 1:1+Y, 2:2+X] + ap[1:1+Z, 1:1+Y, 0:X]
         + ap[1:1+Z, 2:2+Y, 1:1+X] + ap[1:1+Z, 0:Y, 1:1+X]
         + ap[2:2+Z, 1:1+Y, 1:1+X] + ap[0:Z, 1:1+Y, 1:1+X]) * np.float32(0.142857)
    assert np.allclose(out, g, rtol=1e-6, atol=1e-6)


def test_heat3d_iterate():
    p = parse_file(SODA / "heat3d.soda")
    assert p.iterate == 4
    x = rng.standard_normal((10, 12, 14)).astype(np.float32)
    out = run(p, {"heat_in": x})["heat_out"]
    a = x.copy()
    c = np.float32(0.125)
    two = np.float32(2.0)
    for _ in range(4):
        ap = np.pad(a, 1)
        Z, Y, X = a.shape
        ctr = ap[1:1+Z, 1:1+Y, 1:1+X]
        a = (c * (ap[2:2+Z, 1:1+Y, 1:1+X] - two * ctr + ap[0:Z, 1:1+Y, 1:1+X])
             + c * (ap[1:1+Z, 2:2+Y, 1:1+X] - two * ctr + ap[1:1+Z, 0:Y, 1:1+X])
             + c * (ap[1:1+Z, 1:1+Y, 2:2+X] - two * ctr + ap[1:1+Z, 1:1+Y, 0:X])
             + ctr).astype(np.float32)
    assert np.allclose(out, a, rtol=1e-5, atol=1e-5)


def test_sobel_multistage_casts():
    p = parse_file(SODA / "sobel2d.soda")
    img = rng.integers(0, 256, (24, 28)).astype(np.uint16)
    out = run(p, {"img": img})["mag"]
    ip = np.pad(img.astype(np.int64), 1)
    H, W = img.shape

    def at(dy, dx):
        return ip[1+dy:1+dy+H, 1+dx:1+dx+W]

    gx = at(-1, -1) - at(-1, 1) + 2 * (at(0, -1) - at(0, 1)) + at(1, -1) - at(1, 1)
    gy = at(-1, -1) - at(1, -1) + 2 * (at(-1, 0) - at(1, 0)) + at(-1, 1) - at(1, 1)
    # int16 casts wrap
    gx = ((gx & 0xFFFF) ^ 0x8000) - 0x8000
    gy = ((gy & 0xFFFF) ^ 0x8000) - 0x8000
    mag = np.minimum(gx.astype(np.float32) ** 2 + gy.astype(np.float32) ** 2,
                     np.float32(65535.0))
    gold = (np.trunc(mag).astype(np.int64) & 0xFFFF).astype(np.uint16)
    assert np.array_equal(out, gold)


def test_denoise2d_two_inputs():
    p = parse_file(SODA / "denoise2d.soda")
    u = rng.standard_normal((20, 24)).astype(np.float32)
    f = rng.standard_normal((20, 24)).astype(np.float32)
    out = run(p, {"u": u, "f": f})["out"]
    assert out.shape == u.shape and out.dtype == np.float32
    assert np.isfinite(out).all()


def test_c_division_semantics():
    # C: -7/2 == -3 (truncation), -7%2 == -1
    p = parse(
        "kernel: t\ninput int32: a(8, *)\n"
        "local int32: q(0,0) = a(0,0) / 2\n"
        "output int32: r(0,0) = q(0,0) * 100 + a(0,0) % 2\n"
    )
    x = np.array([[-7, 7, -8, 5]], dtype=np.int32)
    out = run(p, {"a": x})["r"]
    assert out.tolist() == [[-301, 301, -400, 201]]


def test_uint_wraparound_on_store():
    p = parse(
        "kernel: t\ninput uint8: a(8, *)\n"
        "output uint8: b(0,0) = a(0,0) + 200\n"
    )
    x = np.array([[100, 200]], dtype=np.uint8)
    out = run(p, {"a": x})["b"]
    assert out.tolist() == [[44, 144]]  # (300)%256, (400)%256


def test_narrow_width_mask():
    p = parse(
        "kernel: t\ninput uint4: a(8, *)\n"
        "output uint4: b(0,0) = a(0,0) + 1\n"
    )
    x = np.array([[15, 7]], dtype=np.uint8)
    out = run(p, {"a": x})["b"]
    assert out.tolist() == [[0, 8]]


def test_iterate_override():
    p = parse_file(SODA / "jacobi2d.soda")
    x = rng.standard_normal((16, 16)).astype(np.float32)
    o1 = run(p, {"t0": x}, iterate=1)["t1"]
    o2 = run(p, {"t0": x}, iterate=2)["t1"]
    o12 = run(p, {"t1_as": o1} if False else {"t0": o1}, iterate=1)["t1"]
    assert np.allclose(o2, o12, rtol=1e-6, atol=1e-6)


def test_valid_rim():
    p = parse_file(SODA / "jacobi2d.soda")
    assert p.radius() == 1
    assert p.valid_rim() == 8  # radius 1 × iterate 8
    b = parse_file(SODA / "blur.soda")
    assert b.valid_rim() == 2


def test_half_precision_storage():
    # `half` stores f16 in the oracle; the XLA path computes f32 between
    # f16 stores (doc'd)
    from soda_tpu.backend import xla as xla_backend
    p = parse(
        "kernel: t\ninput half: a(16, *)\n"
        "output half: b(0,0) = (a(0,-1) + a(0,0) + a(0,1)) / 3.0f\n"
    )
    x = rng.standard_normal((8, 16)).astype(np.float16)
    out = run(p, {"a": x})["b"]
    assert out.dtype == np.float16
    got = xla_backend.run(p, {"a": x})["b"]
    assert got.dtype == np.float16
    assert np.allclose(out.astype(np.float64), got.astype(np.float64),
                       rtol=2e-3, atol=2e-3)


def test_uint32_full_range_value_ops():
    """ADVICE r1: uint32 values >= 2^31 must get unsigned /, %, comparisons
    on every backend (type-directed carriers, not a uniform signed
    accumulator)."""
    from soda_tpu.backend import xla as xb
    from soda_tpu.parallel.host_tile import run_host_tiled

    src = (
        "kernel: u32ops\n"
        "input uint32: a(64, *)\n"
        "output uint32: out(0, 0) = (a(0,0) > a(0,1)) ? (a(0,0) / 2)"
        " : (a(0,1) % 7)\n"
    )
    p = parse(src)
    x = np.array([[3000000000, 2**31 + 5, 9, 4000000001, 17, 2**32 - 1]] * 8,
                 dtype=np.uint32)
    gold = run(p, {"a": x})["out"]
    assert gold[0, 0] == 1500000000  # signed carrier would give 7
    for got in (xb.run(p, {"a": x})["out"],
                run_host_tiled(p, {"a": x}, tiles=(4, 6))["out"]):
        assert np.array_equal(gold[:, :-1], got[:, :-1])


def test_uint64_full_range_oracle_vs_cpp():
    """Full-range uint64 value-dependent ops: oracle and C++ golden runner
    must agree above 2^63 (unsigned carrier on the 64-bit paths)."""
    from soda_tpu.backend import cpp

    src = (
        "kernel: u64ops\n"
        "input uint64: a(64, *)\n"
        "output uint64: out(0, 0) = (a(0,0) > a(0,1)) ? (a(0,0) / 3)"
        " : (a(0,1) >> 2)\n"
    )
    p = parse(src)
    y = np.array([[2**63 + 9, 2**64 - 7, 11, 2**63]] * 4, dtype=np.uint64)
    gold = run(p, {"a": y})["out"]
    # a(0,0)=2^63+9 < a(0,1)=2^64-7 only under UNSIGNED comparison; the
    # else branch then logical-shifts the unsigned value
    assert gold[0, 0] == (2**64 - 7) >> 2
    got = cpp.compile_and_run(p, {"a": y})["out"]
    assert np.array_equal(gold, got)


def test_float_to_unsigned_cast_defined():
    """Review r2: float->uint64 casts route through int64 + two's-
    complement wrap on the oracle AND the C++ runner (direct
    float->unsigned of a negative is UB in C++), so they agree."""
    from soda_tpu.backend import cpp

    src = (
        "kernel: c\n"
        "input float: a(64, *)\n"
        "output uint64: out(0,0) = uint64(a(0,0))\n"
    )
    p = parse(src)
    x = np.array([[-1.5, 2.5, -100.0, 7.9]] * 4, np.float32)
    gold = run(p, {"a": x})["out"]
    got = cpp.compile_and_run(p, {"a": x})["out"]
    assert gold[0, 0] == 2**64 - 1  # -1.5 truncates to -1, wraps
    assert np.array_equal(gold, got)


def test_half_cpp_oracle_bit_exact():
    """Review r2: `half` programs through the C++ runner — _Float16
    storage (2-byte I/O matching np.float16) with per-op rounding casts
    (GCC's excess precision would otherwise diverge from numpy)."""
    from soda_tpu.backend import cpp

    src = (
        "kernel: h\ninput half: a(16, *)\n"
        "local half: s(0,0) = (a(0,-1) + a(0,0) + a(0,1)) / 3.0f\n"
        "output half: b(0,0) = s(-1,0) * s(1,0) + a(0,0)\n"
    )
    p = parse(src)
    x = rng.standard_normal((16, 32)).astype(np.float16)
    gold = run(p, {"a": x})["b"]
    r = p.valid_rim()
    sl = (slice(r, -r), slice(r, -r))
    for got in (cpp.compile_and_run(p, {"a": x})["b"],
                cpp.NativeOracle(p, (16, 32)).run({"a": x})["b"]):
        assert got.dtype == np.float16
        assert np.array_equal(gold[sl].view(np.uint16),
                              got[sl].view(np.uint16))


def test_float_mod_matches_cpp_fmod():
    """Review r2: float % is xp.fmod (exact remainder) — the naive
    a - trunc(a/b)*b loses everything at large quotients."""
    from soda_tpu.backend import cpp, xla as xb

    src = (
        "kernel: fm\ninput float: a(16, *)\n"
        "output float: out(0,0) = a(0,0) % 0.3f\n"
    )
    p = parse(src)
    x = np.array([[1e8, -7.5, 2.5, 1e6]] * 4, np.float32)
    gold = run(p, {"a": x})["out"]
    assert abs(gold[0, 0] - np.fmod(np.float32(1e8), np.float32(0.3))) == 0
    assert gold[0, 1] == np.fmod(np.float32(-7.5), np.float32(0.3))
    got_c = cpp.compile_and_run(p, {"a": x})["out"]
    assert np.array_equal(gold, got_c)
    got_x = xb.run(p, {"a": x})["out"]
    assert np.array_equal(gold, got_x)
