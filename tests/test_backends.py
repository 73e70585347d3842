"""Backend equivalence tests: the XLA backend (whole grid and host-tiled)
and the generated C++ golden runner, all against the NumPy oracle.  The
compiled GPU run of the same checks is `chip_smoke.py`.

Border contract (`border: ignore`): the rim of width radius×sweeps is
invalid; interior must match.  Full-array equality additionally holds for
zero-preserving single-sweep programs (all backends share the zero-fill tap
convention)."""

import glob
import pathlib
import shutil

import numpy as np
import pytest

from soda_tpu.frontend.parser import parse, parse_file
from soda_tpu.interp import numpy_interp
from soda_tpu.backend import xla as xla_backend
from soda_tpu.backend import cpp as cpp_backend
from soda_tpu.parallel.host_tile import run_host_tiled

SODA = pathlib.Path(__file__).parent / "soda"
CORPUS = sorted(glob.glob(str(SODA / "*.soda")))
SHAPES = {1: (1024,), 2: (48, 128), 3: (24, 32, 128)}
rng = np.random.default_rng(11)


def make_io(p):
    ins = {}
    for n in p.input_names:
        t = p.tensors[n].type
        shape = SHAPES[p.rank]
        if t.is_float:
            ins[n] = rng.standard_normal(shape).astype(t.np_dtype())
        elif not t.is_float and t.width > 64:
            # quad-limb range: exercise the high limbs (object arrays of
            # Python ints — np_dtype() is object for >64)
            hi = rng.integers(0, 1 << (min(t.width, 127) - 65),
                              shape).astype(object)
            lo = rng.integers(0, 1 << 62, shape).astype(object)
            ins[n] = (hi << 64) | lo
        else:
            ins[n] = rng.integers(0, 250, shape).astype(t.np_dtype())
    ps = {pp.name: rng.standard_normal(pp.shape).astype(pp.type.np_dtype())
          for pp in p.params.values()}
    return ins, ps


def interior(a, rim):
    if rim == 0:
        return a
    return a[tuple(slice(rim, -rim) for _ in range(a.ndim))]


def check(p, got, gold, rtol=None, atol=None):
    # half programs compute f32 between f16-rounded stores on the XLA path
    # while the oracle rounds per op — compare at f16 scale (docs/SEMANTICS.md)
    half = any(t.type.is_float and t.type.width == 16
               for t in p.tensors.values())
    rtol = (2e-2 if half else 1e-4) if rtol is None else rtol
    atol = (2e-2 if half else 1e-4) if atol is None else atol
    rim = p.valid_rim()
    for k in gold:
        if not p.tensors[k].type.is_float:
            # integer outputs are BIT-exact on every path (a float64 cast
            # would silently truncate >53-bit values — e.g. uint128)
            assert np.array_equal(interior(got[k], rim),
                                  interior(gold[k], rim)), \
                f"{k}: integer output not bit-exact"
            continue
        g = interior(got[k], rim).astype(np.float64)
        e = interior(gold[k], rim).astype(np.float64)
        assert np.allclose(g, e, rtol=rtol, atol=atol), (
            f"{k}: max diff {np.abs(g - e).max()}")


@pytest.mark.parametrize("path", CORPUS, ids=[pathlib.Path(c).stem for c in CORPUS])
def test_xla_backend_matches_oracle(path):
    p = parse_file(path)
    ins, ps = make_io(p)
    gold = numpy_interp.run(p, ins, ps)
    got = xla_backend.run(p, ins, ps)
    check(p, got, gold)


def _half_tiles(shape):
    """Tiles that split every dim of `shape` in two (at least 2 tiles
    along each dim longer than 1)."""
    return tuple(max(n // 2, 1) for n in shape)


@pytest.mark.parametrize("path", CORPUS, ids=[pathlib.Path(c).stem for c in CORPUS])
def test_host_tiled_matches_oracle(path):
    """Every corpus program through the host-tiled XLA path with tiles
    that halve each dim: halos, zero-filled grid edges and the stitch
    must reproduce the oracle (>64-bit programs included: each tile runs
    on quad-limb carriers)."""
    p = parse_file(path)
    ins, ps = make_io(p)
    gold = numpy_interp.run(p, ins, ps)
    got = run_host_tiled(p, ins, ps, tiles=_half_tiles(SHAPES[p.rank]))
    check(p, got, gold)


@pytest.mark.parametrize("path", CORPUS, ids=[pathlib.Path(c).stem for c in CORPUS])
@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_cpp_golden_bit_exact(path, tmp_path):
    p = parse_file(path)
    ins, ps = make_io(p)
    # smaller grids: the naive C++ loop nest is O(cells × taps)
    ins = {k: v[tuple(slice(0, 24) for _ in range(v.ndim))] for k, v in ins.items()}
    gold = numpy_interp.run(p, ins, ps)
    got = cpp_backend.compile_and_run(p, ins, ps, workdir=tmp_path)
    for k in gold:
        if p.uses_libm_transcendentals():
            # exp/log/trig are not IEEE-correctly-rounded: C++ libm and
            # numpy may differ by ~1 ulp — gate at the ulp scale of the
            # program's widest float (f32 programs compute in f32 on
            # both sides, so their ulp is 2^-24, not 2^-53)
            rt = {64: 1e-13, 32: 2e-5, 16: 2e-2}[p.max_float_width()]
            assert np.allclose(got[k].astype(np.float64),
                               gold[k].astype(np.float64),
                               rtol=rt, atol=rt), f"{k} vs C++"
        else:
            assert np.array_equal(got[k], gold[k]), \
                f"{k} not bit-exact vs C++"


def test_sweep_chunking():
    """iterate chunked into host passes of 2 sweeps (4 passes) must equal
    the oracle, as the single fused scan does."""
    p = parse_file(SODA / "jacobi2d.soda")
    x = rng.standard_normal((48, 128)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})
    got = run_host_tiled(p, {"t0": x}, tiles=(48, 128), sweeps_per_pass=2)
    check(p, got, gold)
    check(p, xla_backend.run(p, {"t0": x}), gold)


def test_host_tile_3d_blocks():
    p = parse_file(SODA / "jacobi3d.soda")
    x = rng.standard_normal((24, 32, 128)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})
    got = run_host_tiled(p, {"t0": x}, tiles=(8, 16, 128))
    check(p, got, gold)


def test_zero_preserving_full_match():
    """Linear stencils match the oracle on the FULL grid incl. rim."""
    p = parse_file(SODA / "jacobi3d.soda")
    x = rng.standard_normal((24, 32, 128)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})
    got = xla_backend.run(p, {"t0": x})
    assert np.allclose(got["t1"], gold["t1"], rtol=1e-4, atol=1e-5)


def test_nondivisible_grid_shapes():
    """Grid extents not divisible by the tile must round-trip correctly."""
    p = parse_file(SODA / "jacobi2d.soda")
    x = rng.standard_normal((50, 131)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})
    check(p, xla_backend.run(p, {"t0": x}), gold)
    check(p, run_host_tiled(p, {"t0": x}, tiles=(16, 64)), gold)


def test_multi_stage_chain_3d():
    """A six-stage 3-D chain (radius 2 per stage) matches the oracle, whole
    grid and host-tiled (each tile's halo is the chain's full creep)."""
    from tests.test_programs import _chain3d_src

    p = parse(_chain3d_src())
    shape = (24, 32, 64)
    x = rng.standard_normal(shape).astype(np.float32)
    gold = numpy_interp.run(p, {"a": x})
    check(p, xla_backend.run(p, {"a": x}), gold)
    check(p, run_host_tiled(p, {"a": x}, tiles=(24, 16, 64)), gold)


def test_integer_iterate():
    """Integer multi-sweep: the scan carry must stay loop-invariant."""
    p = parse(
        "kernel: intit\niterate: 4\ninput uint16: a(64, *)\n"
        "output uint16: b(0,0) = (a(-1,0) + a(0,0) + a(1,0) + a(0,-1) + a(0,1)) / 5\n")
    x = rng.integers(0, 60000, (48, 128)).astype(np.uint16)
    gold = numpy_interp.run(p, {"a": x})
    check(p, xla_backend.run(p, {"a": x}), gold)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_native_oracle_ctypes(tmp_path):
    """In-process shared-lib C++ oracle: bit-exact, reusable across calls."""
    p = parse_file(SODA / "blur.soda")
    shape = (24, 32)
    oracle = cpp_backend.NativeOracle(p, shape, workdir=tmp_path)
    for seed in (0, 1):
        x = np.random.default_rng(seed).integers(0, 65535, shape).astype(np.uint16)
        gold = numpy_interp.run(p, {"input": x})
        got = oracle.run({"input": x})
        assert np.array_equal(got["blur_y"], gold["blur_y"])


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_native_oracle_iterate_and_params(tmp_path):
    p = parse_file(SODA / "conv5x5.soda")
    shape = (20, 24)
    oracle = cpp_backend.NativeOracle(p, shape, workdir=tmp_path)
    rng2 = np.random.default_rng(2)
    x = rng2.standard_normal(shape).astype(np.float32)
    c = rng2.standard_normal((5, 5)).astype(np.float32)
    gold = numpy_interp.run(p, {"src": x}, {"coef": c})
    got = oracle.run({"src": x}, {"coef": c})
    assert np.array_equal(got["dst"], gold["dst"])


def test_multi_output_program():
    """Two outputs from one kernel (multiple DRAM sinks)."""
    p = parse_file(SODA / "gradient2d.soda")
    x = rng.standard_normal((48, 128)).astype(np.float32)
    gold = numpy_interp.run(p, {"f": x})
    assert set(gold) == {"dx", "dy"}
    got = run_host_tiled(p, {"f": x}, tiles=(16, 128))
    check(p, got, gold)
    got_x = xla_backend.run(p, {"f": x})
    check(p, got_x, gold)


def test_multi_output_iterate_paths():
    """Multi-output iterate (docs/SEMANTICS.md): feedback = first-input <-
    FIRST-declared output; non-feedback outputs take final-sweep values.
    Covers the corpus residual2d (iterate=4) whole-grid, unrolled and
    host-tiled in passes, and a deep iterate (20 sweeps in one scan) with
    the final sweep evaluated outside the scan for the extra output."""
    from soda_tpu.optimize.unroll import unroll_iterate

    p = parse_file(SODA / "residual2d.soda")
    x = rng.standard_normal((48, 128)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})
    assert set(gold) == {"t1", "res"}
    check(p, numpy_interp.run(unroll_iterate(p), {"t0": x}), gold)
    check(p, xla_backend.run(p, {"t0": x}), gold)
    xr = rng.standard_normal((50, 128)).astype(np.float32)
    gold_r = numpy_interp.run(p, {"t0": xr})
    check(p, run_host_tiled(p, {"t0": xr}, tiles=(25, 128),
                            sweeps_per_pass=2), gold_r)

    q = parse(
        "kernel: mo20\niterate: 20\ninput float: a(64, *)\n"
        "output float: b(0,0) = (a(-1,0) + a(0,0) + a(1,0)) / 3.0f\n"
        "output float: r(0,0) = b(0,0) - a(0,0)\n")
    xq = rng.standard_normal((64, 128)).astype(np.float32)
    gold_q = numpy_interp.run(q, {"a": xq})
    check(q, xla_backend.run(q, {"a": xq}), gold_q)


def test_unroll_iterate_equivalence():
    """Temporal unrolling (the reference's iterate implementation) must
    match the fused-loop execution and the oracle."""
    from soda_tpu.optimize.unroll import unroll_iterate
    p = parse_file(SODA / "jacobi2d.soda")  # iterate 8
    q = unroll_iterate(p)
    assert q.iterate == 1 and len(q.stage_order()) == 8
    x = rng.standard_normal((48, 128)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})
    got_interp = numpy_interp.run(q, {"t0": x})
    check(p, {"t1": got_interp["t1"]}, gold)
    check(p, xla_backend.run(q, {"t0": x}), gold)
    # partial unroll: 2 sweeps per copy-chain, iterate 4 remains
    h = unroll_iterate(p, 2)
    assert h.iterate == 4 and len(h.stage_order()) == 2
    got_h = xla_backend.run(h, {"t0": x})
    check(p, got_h, gold)


def test_operator_coverage_program():
    """One program exercising every DSL operator, agreed across backends."""
    from soda_tpu.frontend.parser import parse
    src = (
        "kernel: ops\n"
        "input int16: a(64, *)\n"
        "local int32: t(0,0) = ((a(0,0) << 2) >> 1) & 0xff | (a(0,1) ^ 3)\n"
        "local int32: u(0,0) = (t(0,0) > 10 && t(0,-1) < 100) ? -t(0,0)"
        " : ~t(1,0) % 7\n"
        "local float: v(0,0) = float(u(0,0)) / 3.0f + sqrt(abs(float(a(0,0))))"
        " - min(float(t(0,0)), 5.0f) * max(1.0f, float(!u(0,1)))\n"
        "output int16: out(0,0) = int16(v(0,0)) + int16(pow(2.0f, 3.0f))\n"
    )
    p = parse(src)
    x = rng.integers(-100, 100, (32, 48)).astype(np.int16)
    gold = numpy_interp.run(p, {"a": x})
    rim = p.valid_rim()
    got_x = xla_backend.run(p, {"a": x})
    got_t = run_host_tiled(p, {"a": x}, tiles=(16, 24))
    for got in (got_x, got_t):
        g = interior(got["out"], rim).astype(np.float64)
        e = interior(gold["out"], rim).astype(np.float64)
        # float->int truncation may differ by 1 ulp at exact boundaries
        assert np.mean(np.abs(g - e) <= 1) > 0.999
        assert np.max(np.abs(g - e)) <= 1


def test_host_tile_nondivisible_grid():
    """Tiles that do not divide the grid: the clipped last tile stitches
    only its real rows."""
    p = parse_file(SODA / "jacobi2d.soda")
    shape = (200, 384)
    x = rng.standard_normal(shape).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})
    check(p, run_host_tiled(p, {"t0": x}, tiles=(64, 384)), gold)


def test_sweeps_per_pass_must_divide_iterate():
    """A pass depth that does not divide iterate would silently
    under-execute sweeps (iterate=10, 3 per pass -> 9): refused; a divisor
    runs every sweep."""
    p = parse(
        "kernel: t\niterate: 10\ninput float: a(64, *)\n"
        "output float: b(0,0) = (a(-1,0) + a(0,0) + a(1,0)) / 3.0f\n")
    x = rng.standard_normal((64, 128)).astype(np.float32)
    with pytest.raises(ValueError, match="must divide iterate"):
        run_host_tiled(p, {"a": x}, tiles=(32, 128), sweeps_per_pass=3)
    gold = numpy_interp.run(p, {"a": x})
    check(p, run_host_tiled(p, {"a": x}, tiles=(32, 128),
                            sweeps_per_pass=5), gold)


def test_output_consumed_within_group():
    """A program output read by another stage of the same sweep."""
    from soda_tpu.frontend.parser import parse
    p = parse(
        "kernel: t\ninput float: a(64, *)\n"
        "output float: o1(0,0) = (a(-1,0) + a(0,0) + a(1,0)) / 3.0f\n"
        "output float: o2(0,0) = (o1(0,-1) + o1(0,0) + o1(0,1)) / 3.0f\n")
    x = rng.standard_normal((48, 128)).astype(np.float32)
    gold = numpy_interp.run(p, {"a": x})
    check(p, xla_backend.run(p, {"a": x}), gold)
    check(p, run_host_tiled(p, {"a": x}, tiles=(16, 64)), gold)


def test_float_mod_and_round_c_semantics():
    """Float % is C fmod (sign of dividend) and round() is half-away-from-
    zero — bit-exact against the C++ golden runner."""
    from soda_tpu.frontend.parser import parse
    p = parse(
        "kernel: t\ninput float: a(64, *)\n"
        "local float: m(0,0) = a(0,0) % 2.0f\n"
        "output float: r(0,0) = round(m(0,0) * 2.0f) + round(a(0,0))\n")
    x = np.array([[-1.5, 1.5, -2.5, 2.5, 0.25, -0.75, 3.75, -3.25]],
                 dtype=np.float32)
    gold = numpy_interp.run(p, {"a": x})
    got_x = xla_backend.run(p, {"a": x})
    assert np.array_equal(got_x["r"], gold["r"])
    if shutil.which("g++"):
        import tempfile
        got_c = cpp_backend.compile_and_run(p, {"a": x},
                                            workdir=tempfile.mkdtemp())
        assert np.array_equal(got_c["r"], gold["r"]), (got_c["r"], gold["r"])


def test_wide_int_runs_on_xla_path():
    """int64 runs native under x64 on the XLA path, bit-exactly (a tiny
    grid of 2 rows)."""
    p = parse("kernel: t\ninput int64: a(8, *)\noutput int64: b(0,0) = a(0,0) + 1\n")
    x = np.arange(16, dtype=np.int64).reshape(2, 8)
    out = numpy_interp.run(p, {"a": x})["b"]
    assert out.dtype == np.int64
    got = xla_backend.run(p, {"a": x})["b"]
    assert got.dtype == np.int64 and np.array_equal(got, out)


def test_xla_wide_mode_64bit():
    """>32-bit programs run on the XLA backend in wide mode — exact
    uint64 (value-dependent ops above 2^63) and native float64."""
    from soda_tpu.backend import xla as xb

    src = (
        "kernel: u64w\n"
        "input uint64: a(64, *)\n"
        "output uint64: out(0, 0) = (a(0,0) > a(0,1)) ? (a(0,0) / 3)"
        " : (a(0,1) >> 2)\n"
    )
    p = parse(src)
    y = (rng.integers(0, 2**62, (8, 128), dtype=np.uint64) + 2**63)
    gold = numpy_interp.run(p, {"a": y})["out"]
    got = xb.run(p, {"a": y})["out"]
    assert got.dtype == np.uint64
    assert np.array_equal(gold[:, :-1], got[:, :-1])

    src2 = (
        "kernel: d64w\n"
        "input double: a(64, *)\n"
        "output double: out(0, 0) = (a(0,-1) + a(0,0) + a(0,1)) / 3.0\n"
    )
    p2 = parse(src2)
    x = rng.standard_normal((8, 128)).astype(np.float64)
    g2 = numpy_interp.run(p2, {"a": x})["out"]
    t2 = xb.run(p2, {"a": x})["out"]
    assert t2.dtype == np.float64
    # far beyond f32 (~1e-7)
    assert np.abs(g2[:, 1:-1] - t2[:, 1:-1]).max() < 1e-12


def test_wide_tensors_on_mesh_pair_path():
    """User int64 tensors shard as paired-32-bit carriers (interp/wide64)
    on the mesh, bit-exact vs the int64 oracle."""
    from soda_tpu.parallel.mesh import run_sharded

    src = (
        "kernel: wide\n"
        "input int64: a(64, *)\n"
        "output int64: out(0, 0) = a(0, 0) * a(0, 1) + (a(0, -1) >> 7)\n"
    )
    p = parse(src)
    x = rng.integers(-2**50, 2**50, (16, 128)).astype(np.int64)
    gold = numpy_interp.run(p, {"a": x})["out"]
    got = run_sharded(p, {"a": x}, axis_sizes=[4], dims=[0])["out"]
    assert got.dtype == np.int64
    assert np.array_equal(gold[:, 1:-1], got[:, 1:-1])


def test_wide_params_on_mesh_pair_path():
    """>32-bit PARAMS cross the shard boundary as plane pairs — a uint64
    param above 2^32 arrives exactly (an int32 cast would truncate it) —
    and natively on the XLA path."""
    from soda_tpu.interp.wide64 import program_is_wide
    from soda_tpu.parallel.mesh import run_sharded

    src = (
        "kernel: wp\n"
        "param uint64: k\n"
        "input uint16: a(64, *)\n"
        "output uint64: out(0, 0) = uint64(a(0, 0)) * k + uint64(a(0, 1))\n"
    )
    p = parse(src)
    assert program_is_wide(p)
    x = rng.integers(0, 60000, (16, 128)).astype(np.uint16)
    k = np.uint64(10_000_000_019)  # > 2^32
    gold = numpy_interp.run(p, {"a": x}, {"k": k})["out"]
    for got in (run_sharded(p, {"a": x}, {"k": k}, axis_sizes=[2],
                            dims=[0])["out"],
                xla_backend.run(p, {"a": x}, {"k": k})["out"]):
        assert got.dtype == np.uint64
        assert np.array_equal(gold[:, 1:-1], got[:, 1:-1])


def test_mixed_sign_chain_constant_extent_margins():
    """Extended-fuzz finding: a stage reading its parent at +z consumed at
    -z does NOT cancel under constant-extent evaluation (host tiles, mesh
    sweeps) — halos must use the non-cancelling chain creep.  This
    multi-tile 3-D case is wrong at every tile boundary row without it."""
    src = (
        "kernel: mc\n"
        "input float: a(64, 64, *)\n"
        "local float: s0(0,0,0) = a(2, 0, 0) + a(1, 0, 0)\n"
        "output float: out(0,0,0) = s0(-2, 0, 0) + s0(1, 0, 0)\n"
    )
    p = parse(src)
    assert p.chain_creep()[0] == (-2, 3)   # vs composed span (-1, 3)
    x = np.random.default_rng(1).standard_normal((32, 16, 128)).astype(np.float32)
    gold = numpy_interp.run(p, {"a": x})["out"]
    got = run_host_tiled(p, {"a": x}, tiles=(8, 16, 128))["out"]
    r = p.valid_rim()
    sl = tuple(slice(r, -r) for _ in range(3))
    assert np.allclose(gold[sl], got[sl], rtol=1e-5, atol=1e-6)


def test_mixed_sign_chain_sharded():
    """Same cancellation hazard on the mesh path (constant-extent
    sweeps_on with halo-exchange margins)."""
    from soda_tpu.parallel.mesh import run_sharded

    src = (
        "kernel: mc2\n"
        "input float: a(64, *)\n"
        "local float: s0(0,0) = a(2, 0) + a(1, 0)\n"
        "output float: out(0,0) = s0(-2, 0) + s0(1, 0)\n"
    )
    p = parse(src)
    x = np.random.default_rng(2).standard_normal((64, 96)).astype(np.float32)
    gold = numpy_interp.run(p, {"a": x})["out"]
    got = run_sharded(p, {"a": x}, axis_sizes=[4], dims=[0])["out"]
    r = p.valid_rim()
    sl = (slice(r, -r), slice(r, -r))
    assert np.allclose(gold[sl], got[sl], rtol=1e-5, atol=1e-6)


def test_half_program_xla_and_report():
    """half tensors store f16 (2 B/cell in the ideal traffic) and the XLA
    path matches the oracle at f16 scale."""
    from soda_tpu.utils.report import analyze

    p = parse_file(SODA / "smooth_half.soda")
    assert analyze(p, (2048, 2048)).ideal_bytes_per_cell_sweep == 4.0
    x = rng.standard_normal((64, 128)).astype(np.float16)
    gold = numpy_interp.run(p, {"h_in": x})["h_out"]
    got = xla_backend.run(p, {"h_in": x})["h_out"]
    assert got.dtype == np.float16
    r = p.valid_rim()
    d = np.abs(gold[r:-r, r:-r].astype(np.float32)
               - got[r:-r, r:-r].astype(np.float32))
    assert d.max() < 2e-2
