"""Program shapes the compiler must handle: span math, rank 1 and 4,
unaligned grids, auxiliary inputs under iterate, mixed-sign stage chains
and 64-bit typing — each through the XLA path (whole grid and host-tiled)
against the NumPy oracle."""

import pathlib

import numpy as np

from soda_tpu.backend import cpp, xla as xb
from soda_tpu.frontend.parser import parse, parse_file
from soda_tpu.interp import numpy_interp
from soda_tpu.parallel.host_tile import run_host_tiled

SODA = pathlib.Path(__file__).parent / "soda"


def _chain3d_src(n_stages=6):
    src = "kernel: chain3d\ninput float: a(64, 64, *)\n"
    prev = "a"
    for i in range(n_stages):
        nm = f"s{i}"
        src += (f"local float: {nm}(0,0,0) = ({prev}(-2,0,0) + {prev}(2,0,0)"
                f" + {prev}(0,-2,0) + {prev}(0,2,0) + {prev}(0,0,-2)"
                f" + {prev}(0,0,2) + {prev}(0,0,0)) * 0.14f\n")
        prev = nm
    src += f"output float: out(0,0,0) = {prev}(0,0,0)\n"
    return src


def _interior(a, r):
    return a[tuple(slice(r, -r) for _ in range(a.ndim))] if r else a


def test_spans_blur():
    p = parse_file(SODA / "blur.soda")
    assert p.cumulative_span("blur_y") == ((-1, 1), (0, 2))
    assert p.chain_creep() == ((-1, 1), (0, 2))


def test_spans_multistage_denoise():
    # unew reads w at radius 1, w reads grad at 0, grad reads u at radius 1
    p = parse_file(SODA / "denoise3d.soda")
    assert p.cumulative_span("unew") == ((-2, 2), (-2, 2), (-2, 2))
    assert p.valid_rim() == 2


def test_chain3d_creep_and_rim():
    p = parse(_chain3d_src())
    assert p.chain_creep() == ((-12, 12),) * 3
    assert p.valid_rim() == 12


def test_rank1_runs_everywhere():
    """rank-1 programs run on every backend: XLA whole grid and
    host-tiled, and the C++ golden runner."""
    p = parse_file(SODA / "smooth1d.soda")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1024,)).astype(np.float32)
    gold = numpy_interp.run(p, {"w_in": x})["w_out"]
    rim = p.valid_rim()
    for got in (run_host_tiled(p, {"w_in": x}, tiles=(200,))["w_out"],
                xb.run(p, {"w_in": x})["w_out"],
                cpp.compile_and_run(p, {"w_in": x})["w_out"]):
        assert np.allclose(gold[rim:-rim], got[rim:-rim],
                           rtol=1e-5, atol=1e-6)


def test_rank4_runs():
    """Rank-general: a 4-D program matches the oracle whole-grid and in
    4-D host tiles."""
    src = (
        "kernel: blur4d\n"
        "input float: a(8, 8, 8, *)\n"
        "output float: out(0,0,0,0) = (a(-1,0,0,0) + a(0,-1,0,0)"
        " + a(0,0,-1,0) + a(0,0,0,-1) + a(0,0,0,1) + a(0,0,1,0)"
        " + a(0,1,0,0) + a(1,0,0,0) + a(0,0,0,0)) / 9.0f\n"
    )
    p = parse(src)
    gshape = (8, 8, 8, 64)
    x = np.random.default_rng(4).standard_normal(gshape).astype(np.float32)
    gold = numpy_interp.run(p, {"a": x})["out"]
    r = p.valid_rim()
    for got in (xb.run(p, {"a": x})["out"],
                run_host_tiled(p, {"a": x}, tiles=(4, 8, 4, 64))["out"]):
        assert np.allclose(_interior(gold, r), _interior(got, r),
                           rtol=1e-5, atol=1e-6)


def test_unaligned_grids_match_oracle():
    """Grid extents with no power-of-two factor: 3-D f32 and 2-D uint16
    (bit-exact), whole grid and in uneven host tiles."""
    rng = np.random.default_rng(11)
    p = parse_file(SODA / "jacobi3d.soda")
    x = rng.standard_normal((28, 37, 130)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})["t1"]
    r = p.valid_rim()
    for got in (xb.run(p, {"t0": x})["t1"],
                run_host_tiled(p, {"t0": x}, tiles=(10, 37, 130))["t1"]):
        assert np.allclose(_interior(gold, r), _interior(got, r),
                           rtol=1e-5, atol=1e-6)

    p2 = parse_file(SODA / "gaussian2d.soda")
    y = rng.integers(0, 60000, (100, 131)).astype(np.uint16)
    gold2 = numpy_interp.run(p2, {"g_in": y})["g_out"]
    r2 = p2.valid_rim()
    for got in (xb.run(p2, {"g_in": y})["g_out"],
                run_host_tiled(p2, {"g_in": y}, tiles=(33, 131))["g_out"]):
        assert np.array_equal(_interior(gold2, r2), _interior(got, r2))


def test_aux_input_iterate():
    """iterate with an auxiliary input: the aux input carries over every
    sweep, whole grid and across host passes."""
    p = parse_file(SODA / "denoise2p.soda")
    gs = (128, 128)
    rng = np.random.default_rng(9)
    u = rng.standard_normal(gs).astype(np.float32)
    f = rng.standard_normal(gs).astype(np.float32)
    gold = numpy_interp.run(p, {"u": u, "f": f})["u1"]
    r = p.valid_rim()
    it = max(p.iterate, 1)
    for got in (xb.run(p, {"u": u, "f": f})["u1"],
                run_host_tiled(p, {"u": u, "f": f}, tiles=(64, 128),
                               sweeps_per_pass=1 if it == 1 else 2)["u1"]):
        assert np.allclose(_interior(gold, r), _interior(got, r),
                           rtol=1e-4, atol=1e-5)


def test_row_stencils_uint16_bit_exact():
    """2-D uint16 stencils (gaussian2d, blur) are bit-exact at a size with
    many rows."""
    rng = np.random.default_rng(17)
    p = parse_file(SODA / "gaussian2d.soda")
    x = rng.integers(0, 60000, (256, 512)).astype(np.uint16)
    gold = numpy_interp.run(p, {"g_in": x})["g_out"]
    r = p.valid_rim()
    assert np.array_equal(_interior(gold, r),
                          _interior(xb.run(p, {"g_in": x})["g_out"], r))
    p2 = parse_file(SODA / "blur.soda")
    y = rng.integers(0, 250, (250, 512)).astype(np.uint16)
    gold2 = numpy_interp.run(p2, {"input": y})["blur_y"]
    got2 = run_host_tiled(p2, {"input": y}, tiles=(64, 512))["blur_y"]
    r2 = p2.valid_rim()
    assert np.array_equal(_interior(gold2, r2), _interior(got2, r2))


def test_rank1_uint16_runs():
    """rank-1 uint16 with a two-stage chain: bit-exact."""
    src = (
        "kernel: r1u16\ninput uint16: a(*)\n"
        "local uint16: s0(0) = a(-2) + a(2)\n"
        "output uint16: out(0) = s0(-1) + a(0) * 2 + s0(1)\n"
    )
    p = parse(src)
    x = np.random.default_rng(5).integers(0, 200, (300,)).astype(np.uint16)
    gold = numpy_interp.run(p, {"a": x})["out"]
    r = p.valid_rim()
    for got in (xb.run(p, {"a": x})["out"],
                run_host_tiled(p, {"a": x}, tiles=(64,))["out"]):
        assert np.array_equal(gold[r:-r], got[r:-r])


def test_deep_iterate_aux_input():
    """A 64-sweep iterate with an aux input runs in one scan."""
    src = (
        "kernel: dn\niterate: 64\n"
        "input float: u(1024, *)\ninput float: f(1024, *)\n"
        "output float: u1(0,0) = (u(-1,0) + u(1,0) + u(0,-1) + u(0,1)"
        " + 0.5f * f(0,0)) / 4.5f\n"
    )
    p = parse(src)
    x = np.random.default_rng(0).standard_normal((128, 128)).astype(np.float32)
    f = np.random.default_rng(1).standard_normal((128, 128)).astype(np.float32)
    gold = numpy_interp.run(p, {"u": x, "f": f})["u1"]
    got = xb.run(p, {"u": x, "f": f})["u1"]
    assert got.shape == x.shape
    assert np.allclose(gold, got, rtol=1e-4, atol=1e-4)


def test_user_tensor_named_like_cse_goes_wide():
    """The synthetic-stage exemption is a Tensor FLAG, not a
    name-substring test — USER tensors named *__cse* are 64-bit user
    types and run exactly."""
    from soda_tpu.interp.wide64 import program_is_wide

    src = ("kernel: w\ninput int64: a__cse1(64, *)\n"
           "output int64: out(0,0) = a__cse1(0,0) + a__cse1(0,1)\n")
    p = parse(src)
    assert program_is_wide(p)  # user-declared despite the __cse name
    x = np.random.default_rng(2).integers(-2**60, 2**60, (16, 64))
    gold = numpy_interp.run(p, {"a__cse1": x})["out"]
    got = xb.run(p, {"a__cse1": x})["out"]
    assert np.array_equal(gold[:, :-1], got[:, :-1])


def test_mixed_sign_multistage_chain_iterate():
    """Fuzz seed 141 regression: mixed-sign MULTI-STAGE chains under
    iterate — host-tile halos must cover the chain creep of every pass
    (a stage tapping +1 whose consumer taps -2)."""
    src = ("kernel: fw\niterate: 2\ninput int32: a(64, *)\n"
           "local int32: s0(0, 0) = a(1, 2) + a(-2, -1)"
           " + (a(-1, -2) >> 11) + a(0, 2) * 1\n"
           "local int32: s1(0, 0) = s0(-2, -2) + s0(-1, 2)"
           " + s0(-2, 0) * 4\n"
           "output int32: out(0, 0) = (s1(-1, 0) & 343597) + s1(-2, 2)\n")
    p = parse(src)
    x = np.random.default_rng(1).integers(-2**27, 2**27,
                                          (40, 128)).astype(np.int32)
    gold = numpy_interp.run(p, {"a": x})["out"]
    r = p.valid_rim()
    for got in (xb.run(p, {"a": x})["out"],
                run_host_tiled(p, {"a": x}, tiles=(20, 64))["out"]):
        assert np.array_equal(gold[r:-r, r:-r], got[r:-r, r:-r])
