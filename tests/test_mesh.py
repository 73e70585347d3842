"""Sharded execution tests on the simulated 8-device CPU mesh:
shard_map + ppermute halo exchange vs the NumPy oracle.

(The conftest forces an 8-device CPU platform; the same code path runs on
the cards of one host over NVLink — device count and axis shape are
parameters.  `chip_smoke.py --four-cards` runs it on four GPUs.)"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from soda_tpu.frontend.parser import parse_file
from soda_tpu.interp import numpy_interp
from soda_tpu.parallel.mesh import build_sharded_fn, halo_exchange, make_mesh, run_sharded

SODA = pathlib.Path(__file__).parent / "soda"
rng = np.random.default_rng(5)


def interior(a, rim):
    if rim == 0:
        return a
    return a[tuple(slice(rim, -rim) for _ in range(a.ndim))]


def check(p, got, gold, rim=None, rtol=1e-4, atol=1e-4):
    rim = p.valid_rim() if rim is None else rim
    for k in gold:
        g = interior(got[k], rim).astype(np.float64)
        e = interior(gold[k], rim).astype(np.float64)
        assert np.allclose(g, e, rtol=rtol, atol=atol), (
            f"{k}: max diff {np.abs(g - e).max()}")


def test_eight_devices_available():
    assert len(jax.devices()) == 8
    assert jax.devices()[0].platform == "cpu"


def test_halo_exchange_matches_zero_fill():
    mesh = make_mesh([4], ["x"])
    x = rng.standard_normal((32, 16)).astype(np.float32)

    def f(x):
        return halo_exchange(x, 0, 2, 2, "x")

    y = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P_ROW, out_specs=P_ROW))(x)
    y = np.asarray(y)
    # each shard of 8 rows becomes 12; reassembled: 4*12 = 48 rows
    assert y.shape == (48, 16)
    # shard 0: zero low halo then rows 0..8 then rows 8..10 from shard 1
    assert np.all(y[0:2] == 0)
    assert np.array_equal(y[2:10], x[0:8])
    assert np.array_equal(y[10:12], x[8:10])
    # last shard: high halo zero
    assert np.all(y[-2:] == 0)


from jax.sharding import PartitionSpec

P_ROW = PartitionSpec("x", None)


@pytest.mark.parametrize("name", ["jacobi2d", "seidel2d"])
def test_sharded_2d_iterate(name):
    p = parse_file(SODA / f"{name}.soda")
    x = rng.standard_normal((64, 96)).astype(np.float32)
    gold = numpy_interp.run(p, {p.input_names[0]: x})
    got = run_sharded(p, {p.input_names[0]: x}, axis_sizes=[8])
    check(p, got, gold)


def test_sharded_2d_exchange_every_sweep():
    p = parse_file(SODA / "jacobi2d.soda")
    x = rng.standard_normal((64, 96)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})
    got = run_sharded(p, {"t0": x}, axis_sizes=[8], sweeps_per_exchange=1)
    check(p, got, gold)
    got2 = run_sharded(p, {"t0": x}, axis_sizes=[8], sweeps_per_exchange=4)
    check(p, got2, gold)


def test_sharded_3d_2d_mesh():
    p = parse_file(SODA / "jacobi3d.soda")
    x = rng.standard_normal((16, 32, 48)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})
    got = run_sharded(p, {"t0": x}, axis_sizes=[2, 4], dims=[0, 1])
    check(p, got, gold)
    # full-array match for the linear zero-preserving stencil
    assert np.allclose(got["t1"], gold["t1"], rtol=1e-4, atol=1e-5)


def test_sharded_multistage_multi_input():
    p = parse_file(SODA / "denoise3d.soda")
    u = rng.standard_normal((16, 32, 48)).astype(np.float32)
    f = rng.standard_normal((16, 32, 48)).astype(np.float32)
    gold = numpy_interp.run(p, {"u": u, "rhs": f})
    got = run_sharded(p, {"u": u, "rhs": f}, axis_sizes=[4], dims=[0])
    check(p, got, gold)


def test_sharded_uint16_blur():
    p = parse_file(SODA / "blur.soda")
    x = rng.integers(0, 60000, (64, 64)).astype(np.uint16)
    gold = numpy_interp.run(p, {"input": x})
    got = run_sharded(p, {"input": x}, axis_sizes=[8])
    check(p, got, gold)


def test_sharded_heat3d_iterate4():
    p = parse_file(SODA / "heat3d.soda")
    x = rng.standard_normal((24, 32, 40)).astype(np.float32)
    gold = numpy_interp.run(p, {"heat_in": x})
    got = run_sharded(p, {"heat_in": x}, axis_sizes=[8], dims=[0])
    check(p, got, gold)


def test_sharded_3d_along_z():
    """jacobi3d sharded along z over 4 devices."""
    p = parse_file(SODA / "jacobi3d.soda")
    x = rng.standard_normal((16, 32, 128)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})
    got = run_sharded(p, {"t0": x}, axis_sizes=[4], dims=[0])
    check(p, got, gold)


def test_sharded_iterate_cadence_2():
    p = parse_file(SODA / "jacobi2d.soda")
    x = rng.standard_normal((64, 96)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})
    got = run_sharded(p, {"t0": x}, axis_sizes=[4], dims=[0],
                      sweeps_per_exchange=2)
    check(p, got, gold)


def test_sharded_multi_output_iterate():
    """Multi-output iterate over the mesh (docs/SEMANTICS.md): feedback =
    first-input <- FIRST-declared output, the residual output takes its
    final-sweep value — exchanging every sweep and with a chunked
    cadence."""
    p = parse_file(SODA / "residual2d.soda")
    x = rng.standard_normal((64, 96)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})
    assert set(gold) == {"t1", "res"}
    got = run_sharded(p, {"t0": x}, axis_sizes=[8])
    check(p, got, gold)
    got2 = run_sharded(p, {"t0": x}, axis_sizes=[4], dims=[0],
                       sweeps_per_exchange=2)
    check(p, got2, gold)


def test_overlap_mode_equals_synchronous():
    """Comms/compute-overlap mode must give identical results to the
    synchronous path (interior from local data, boundary from the
    exchanged halo)."""
    for name, it_kwargs in (("jacobi2d", {}), ("blur", {})):
        p = parse_file(SODA / f"{name}.soda")
        shape = (64, 96)
        x = (rng.standard_normal(shape).astype(np.float32)
             if p.tensors[p.input_names[0]].type.is_float else
             rng.integers(0, 60000, shape).astype(np.uint16))
        ins = {p.input_names[0]: x}
        sync = run_sharded(p, ins, axis_sizes=[4], dims=[0])
        over = run_sharded(p, ins, axis_sizes=[4], dims=[0], overlap=True)
        for k in sync:
            assert np.allclose(sync[k].astype(np.float64),
                               over[k].astype(np.float64),
                               rtol=1e-6, atol=1e-6), (name, k)
        gold = numpy_interp.run(p, ins)
        check(p, over, gold)


def test_sharded_aux_input_iterate():
    """Round 2: iterate with an auxiliary (non-feedback) input — the aux
    tensor must be exchanged and carried across sweeps/chunks."""
    p = parse_file(SODA / "denoise2p.soda")
    u = rng.standard_normal((64, 128)).astype(np.float32)
    f = rng.standard_normal((64, 128)).astype(np.float32)
    gold = numpy_interp.run(p, {"u": u, "f": f})
    got = run_sharded(p, {"u": u, "f": f}, axis_sizes=[4])
    check(p, got, gold)


def test_sharded_aux_input_chunked():
    """Aux input with sweeps_per_exchange < iterate (chunked feedback)."""
    p = parse_file(SODA / "denoise2p.soda")
    u = rng.standard_normal((64, 128)).astype(np.float32)
    f = rng.standard_normal((64, 128)).astype(np.float32)
    gold = numpy_interp.run(p, {"u": u, "f": f})
    got = run_sharded(p, {"u": u, "f": f}, axis_sizes=[4],
                      sweeps_per_exchange=2)
    check(p, got, gold)


def test_overlap_mode_2d_mesh_and_3d():
    """Overlap mode on 1-D and 2-D meshes — identical results to the
    synchronous path and the oracle (corners exact via halo-carrying
    strip slabs)."""
    p = parse_file(SODA / "jacobi2d.soda")
    shape = (64, 64, )
    x = rng.standard_normal(shape).astype(np.float32)
    ins = {p.input_names[0]: x}
    gold = numpy_interp.run(p, ins)
    # 2-D mesh, xla local backend
    sync = run_sharded(p, ins, axis_sizes=[2, 2], dims=[0, 1])
    over = run_sharded(p, ins, axis_sizes=[2, 2], dims=[0, 1], overlap=True)
    for k in sync:
        assert np.allclose(sync[k], over[k], rtol=1e-6, atol=1e-6)
    check(p, over, gold)
    # 1-D mesh
    overp = run_sharded(p, ins, axis_sizes=[4], dims=[0], overlap=True)
    check(p, overp, gold)
    # 2-D mesh + iterate exchanging every sweep on a 3D program
    p3 = parse_file(SODA / "heat3d.soda")
    x3 = rng.standard_normal((32, 32, 128)).astype(np.float32)
    ins3 = {p3.input_names[0]: x3}
    gold3 = numpy_interp.run(p3, ins3)
    over3 = run_sharded(p3, ins3, axis_sizes=[2, 2], dims=[0, 1],
                        overlap=True, sweeps_per_exchange=1)
    check(p3, over3, gold3)


def test_multihop_halo_exchange():
    """Round 2: halos wider than one shard gather from k-hop neighbors
    (e.g. 8 devices on 16 rows -> 2-row shards with a 4-row halo)."""
    p = parse_file(SODA / "gaussian2d.soda")  # cumulative radius 2 on dim 0
    x = rng.integers(0, 60000, (8, 128)).astype(np.uint16)  # 1-row shards
    ins = {"g_in": x}
    gold = numpy_interp.run(p, ins)
    got = run_sharded(p, ins, axis_sizes=[8], dims=[0])
    check(p, got, gold, rtol=0, atol=0)

    # iterate with fused sweeps pushing the halo past two shards: 8 sweeps
    # x radius 1 = 8-row halo over 4-row shards (explicit nf is honored)
    p2 = parse_file(SODA / "jacobi2d.soda")
    x2 = rng.standard_normal((32, 128)).astype(np.float32)
    ins2 = {p2.input_names[0]: x2}
    gold2 = numpy_interp.run(p2, ins2, iterate=8)
    got2 = run_sharded(p2, ins2, axis_sizes=[8], dims=[0], iterate=8,
                       sweeps_per_exchange=8)
    check(p2, got2, gold2, rim=p2.valid_rim(iterate=8))


def test_mesh_wide_i64_bit_exact():
    """64-bit programs shard as plane pairs — per-plane ppermute halo
    exchange + pair-carrier local compute — bit-exact vs the int64 oracle,
    at the auto cadence and exchanging every sweep."""
    from soda_tpu.frontend.parser import parse

    src = ("kernel: m64\niterate: 4\ninput int64: a(128, *)\n"
           "output int64: out(0,0) = a(-1,0) + a(1,0) * int64(3)"
           " + (a(0,-1) >> 2) + a(0,1)\n")
    p = parse(src)
    x = np.random.default_rng(0).integers(-2**48, 2**48, (64, 128),
                                          dtype=np.int64)
    gold = numpy_interp.run(p, {"a": x})["out"]
    got = run_sharded(p, {"a": x}, axis_sizes=[8])["out"]
    r = p.valid_rim()
    assert got.dtype == np.int64
    assert np.array_equal(gold[r:-r, r:-r], got[r:-r, r:-r])
    got_p = run_sharded(p, {"a": x}, axis_sizes=[8],
                        sweeps_per_exchange=1)["out"]
    assert got_p.dtype == np.int64
    assert np.array_equal(gold[r:-r, r:-r], got_p[r:-r, r:-r])


def test_mesh_wide_f64_and_nested_cadence():
    """double over a 2-D mesh (double-single local compute, ~1e-13) and
    int64 under the nested multi-slice cadence schedule (bit-exact)."""
    from soda_tpu.frontend.parser import parse

    p2 = parse_file(SODA / "poisson_f64.soda")
    f = np.random.default_rng(1).standard_normal((64, 96))
    gold2 = numpy_interp.run(p2, {"u": f})["r"]
    mesh = make_mesh([2, 4], ["dcn", "x"])
    got2 = run_sharded(p2, {"u": f}, mesh=mesh)["r"]
    assert got2.dtype == np.float64
    assert np.abs(gold2[1:-1, 1:-1] - got2[1:-1, 1:-1]).max() < 1e-11

    src3 = ("kernel: mw\niterate: 8\ninput int64: a(128, *)\n"
            "output int64: out(0,0) = a(-1,0) + a(1,0) + a(0,-1)"
            " + a(0,1)\n")
    p3 = parse(src3)
    x3 = np.random.default_rng(2).integers(-2**40, 2**40, (64, 96),
                                           dtype=np.int64)
    gold3 = numpy_interp.run(p3, {"a": x3})["out"]
    got3 = run_sharded(p3, {"a": x3}, mesh=mesh,
                       sweeps_per_exchange={"dcn": 4, "x": 2})["out"]
    r3 = p3.valid_rim()
    assert np.array_equal(gold3[r3:-r3, r3:-r3], got3[r3:-r3, r3:-r3])


def test_overlap_multihop_falls_back():
    """Review r2: overlap mode with a halo wider than one shard must fall
    back to the synchronous path (the strip geometry can't host it)."""
    p = parse_file(SODA / "jacobi2d.soda")
    x = rng.standard_normal((32, 128)).astype(np.float32)
    ins = {p.input_names[0]: x}
    gold = numpy_interp.run(p, ins, iterate=8)
    got = run_sharded(p, ins, axis_sizes=[8], dims=[0], iterate=8,
                      sweeps_per_exchange=8, overlap=True)
    check(p, got, gold, rim=p.valid_rim(iterate=8))


def test_sharded_aux_input_unaligned_grid():
    """Aux-input iterate on an unaligned grid sharded along x (the aux
    input must carry over every sweep)."""
    p = parse_file(SODA / "denoise2p.soda")
    u = rng.standard_normal((100, 128)).astype(np.float32)
    f = rng.standard_normal((100, 128)).astype(np.float32)
    gold = numpy_interp.run(p, {"u": u, "f": f})
    got = run_sharded(p, {"u": u, "f": f}, axis_sizes=[2], dims=[1])
    check(p, got, gold)


# ---- slow-link (dcn) meshes: per-axis exchange cadence -------------------


def test_nested_cadence_explicit():
    """A 2x4 mesh with per-axis exchange cadences (dcn every 4 sweeps,
    x every 2) matches the oracle; the
    nested schedule exchanges the slow axis's deeper halo less often."""
    p = parse_file(SODA / "jacobi2d.soda")
    x = rng.standard_normal((64, 96)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})
    mesh = make_mesh([2, 4], ["dcn", "x"])
    got = run_sharded(p, {"t0": x}, mesh=mesh,
                      sweeps_per_exchange={"dcn": 4, "x": 2})
    check(p, got, gold)


def test_nested_cadence_deep_slow_axis():
    """Nested cadence with the slow axis exchanging once in 8 sweeps."""
    p = parse_file(SODA / "jacobi2d.soda")
    x = rng.standard_normal((64, 96)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})
    mesh = make_mesh([2, 4], ["dcn", "x"])
    got = run_sharded(p, {"t0": x}, mesh=mesh,
                      sweeps_per_exchange={"dcn": 8, "x": 2})
    check(p, got, gold)


def test_nested_cadence_aux_input():
    """Nested cadence with an auxiliary (non-feedback) iterate input."""
    p = parse_file(SODA / "denoise2p.soda")
    u = rng.standard_normal((64, 64)).astype(np.float32)
    f = rng.standard_normal((64, 64)).astype(np.float32)
    gold = numpy_interp.run(p, {"u": u, "f": f}, iterate=4)
    mesh = make_mesh([2, 2], ["dcn", "x"])
    got = run_sharded(p, {"u": u, "f": f}, mesh=mesh, iterate=4,
                      sweeps_per_exchange={"dcn": 4, "x": 2})
    check(p, got, gold, rim=p.valid_rim(iterate=4))


def test_auto_cadence_from_link_classes():
    """link_classes auto-picks per-axis cadences from the link costs (a
    calibrated slow dcn deeper than nvlink on 3-D production shapes) and
    the sharded run matches the oracle; a dcn axis without a calibrated
    cost is refused."""
    from soda_tpu.parallel.mesh import (LINK_MODEL, choose_exchange_cadence,
                                        set_link_model)

    p = parse_file(SODA / "heat3d.soda")
    mesh = make_mesh([2, 4], ["dcn", "x"])
    links = {"dcn": "dcn", "x": "nvlink"}
    saved = dict(LINK_MODEL)
    try:
        LINK_MODEL.clear()
        with pytest.raises(ValueError, match="link-model"):
            choose_exchange_cadence(p, (512, 512, 512), mesh, (0, 1), 16,
                                    links)
        set_link_model("dcn=0.5:1e-4")
        cad = choose_exchange_cadence(
            p, (512, 512, 512), mesh, (0, 1), 16, links)
        assert cad["dcn"] > cad["x"], cad
        assert cad["dcn"] % cad["x"] == 0  # divisor chain

        x = rng.standard_normal((32, 32, 64)).astype(np.float32)
        gold = numpy_interp.run(p, {"heat_in": x})
        got = run_sharded(p, {"heat_in": x}, mesh=mesh, link_classes=links)
        check(p, got, gold)
    finally:
        LINK_MODEL.clear()
        LINK_MODEL.update(saved)


def test_cadence_divisor_chain_rejected():
    """Cadences that don't nest (3 vs 2) are rejected loudly."""
    p = parse_file(SODA / "jacobi2d.soda")
    x = rng.standard_normal((64, 96)).astype(np.float32)
    mesh = make_mesh([2, 4], ["dcn", "x"])
    with pytest.raises(ValueError, match="divisor chain"):
        run_sharded(p, {"t0": x}, mesh=mesh, iterate=6,
                    sweeps_per_exchange={"dcn": 3, "x": 2})


def test_uniform_mapping_cadence_uses_flat_path():
    """A per-axis mapping with EQUAL cadences collapses to the uniform
    (single-level, overlap-capable) schedule and stays correct."""
    p = parse_file(SODA / "jacobi2d.soda")
    x = rng.standard_normal((64, 96)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})
    mesh = make_mesh([2, 4], ["dcn", "x"])
    got = run_sharded(p, {"t0": x}, mesh=mesh,
                      sweeps_per_exchange={"dcn": 2, "x": 2}, overlap=True)
    check(p, got, gold)


def test_mesh_wide_overlap_equals_synchronous():
    """Round 2 follow-up: the comms/compute overlap path is pair-aware
    (per-plane strip slicing + dynamic-update-slice) — wide overlap ==
    synchronous == oracle on 1-D and 2-D meshes, bit-exact."""
    from soda_tpu.frontend.parser import parse

    src = ("kernel: m64o\niterate: 4\ninput int64: a(128, *)\n"
           "output int64: out(0,0) = a(-1,0) + a(1,0) * int64(3)"
           " + (a(0,-1) >> 2) + a(0,1)\n")
    p = parse(src)
    x = np.random.default_rng(0).integers(-2**48, 2**48, (64, 128),
                                          dtype=np.int64)
    gold = numpy_interp.run(p, {"a": x})["out"]
    got_s = run_sharded(p, {"a": x}, axis_sizes=[8])["out"]
    got_o = run_sharded(p, {"a": x}, axis_sizes=[8], overlap=True)["out"]
    assert np.array_equal(got_s, got_o)
    r = p.valid_rim()
    assert np.array_equal(gold[r:-r, r:-r], got_o[r:-r, r:-r])
    mesh = make_mesh([2, 4], ["y", "x"])
    got_o2 = run_sharded(p, {"a": x}, mesh=mesh, overlap=True)["out"]
    assert np.array_equal(gold[r:-r, r:-r], got_o2[r:-r, r:-r])


def test_mesh_half_program():
    """half programs shard with f32 local compute and f16 outputs (the
    local path value-casts) — f16-scale agreement with the oracle."""
    p = parse_file(SODA / "smooth_half.soda")
    x = rng.standard_normal((64, 96)).astype(np.float16)
    gold = numpy_interp.run(p, {"h_in": x})["h_out"]
    got = run_sharded(p, {"h_in": x}, axis_sizes=[8])["h_out"]
    assert got.dtype == np.float16
    r = p.valid_rim()
    d = np.abs(gold[r:-r, r:-r].astype(np.float32)
               - got[r:-r, r:-r].astype(np.float32)).max()
    assert d < 2e-2


# ---- uneven (non-divisible) grids: pad-to-shard with masked outputs -----
# VERDICT r2 #1b: the reference host tiles ARBITRARY grids with overlapping
# halos (SURVEY.md §2.1 host-codegen row); the mesh path pads each sharded
# dim to a mesh-axis multiple, re-zeros the pad region after every exchange
# chunk (so exchanged halos keep the zero-fill contract), and slices back.


def test_uneven_1d_exchange_every_sweep_bit_exact():
    """100×252 over 8 devices (shard 13, pad to 104): exchange-every-sweep
    is BIT-exact vs the oracle on the whole grid, rim included."""
    p = parse_file(SODA / "jacobi2d.soda")
    x = rng.standard_normal((100, 252)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})
    got = run_sharded(p, {"t0": x}, axis_sizes=[8], sweeps_per_exchange=1)
    assert got["t1"].shape == (100, 252)
    assert np.array_equal(got["t1"], gold["t1"])


def test_uneven_1d_deep_cadence_interior_exact():
    """Deeper exchange cadences on uneven grids deviate only inside the
    border-invalid rim (border: ignore) — interior matches the oracle."""
    p = parse_file(SODA / "jacobi2d.soda")
    x = rng.standard_normal((100, 252)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})
    got = run_sharded(p, {"t0": x}, axis_sizes=[8], sweeps_per_exchange=2)
    check(p, got, gold)


def test_uneven_2d_mesh_3d_grid_bit_exact():
    """Both sharded dims non-divisible (20/4=5, 21/2=10.5→pad 22)."""
    p = parse_file(SODA / "jacobi3d.soda")
    x = rng.standard_normal((20, 21, 128)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x}, iterate=2)
    got = run_sharded(p, {"t0": x}, axis_sizes=[4, 2], dims=[0, 1],
                      iterate=2, sweeps_per_exchange=1)
    assert np.array_equal(got["t1"], gold["t1"])


def test_uneven_wide_i64_bit_exact():
    """64-bit pair carriers pad per plane (zero planes ARE the zero
    value) — uneven int64 grids stay bit-exact."""
    p = parse_file(SODA / "accum64.soda")
    x = rng.integers(-(1 << 40), 1 << 40, (50, 251)).astype(np.int64)
    gold = numpy_interp.run(p, {p.input_names[0]: x})
    got = run_sharded(p, {p.input_names[0]: x}, axis_sizes=[8])
    k = p.output_names[0]
    assert got[k].shape == (50, 251)
    assert np.array_equal(got[k], gold[k])


def test_uneven_overlap_and_synchronous():
    """The comms/compute-overlap path and the synchronous path both honor
    pad-to-shard masking."""
    p = parse_file(SODA / "jacobi2d.soda")
    x = rng.standard_normal((100, 251)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})
    got_o = run_sharded(p, {"t0": x}, axis_sizes=[8], sweeps_per_exchange=1,
                        overlap=True)
    assert np.array_equal(got_o["t1"], gold["t1"])
    got_p = run_sharded(p, {"t0": x}, axis_sizes=[8], sweeps_per_exchange=1)
    assert np.array_equal(got_p["t1"], gold["t1"])


def test_uneven_grid_smaller_than_mesh():
    """Degenerate: a 5-row grid over 8 devices leaves whole shards in the
    pad region; they compute zeros and never pollute real shards."""
    p = parse_file(SODA / "jacobi2d.soda")
    x = rng.standard_normal((5, 128)).astype(np.float32)
    gold = numpy_interp.run(p, {"t0": x})
    got = run_sharded(p, {"t0": x}, axis_sizes=[8], sweeps_per_exchange=1)
    assert got["t1"].shape == (5, 128)
    assert np.array_equal(got["t1"], gold["t1"])


def test_link_model_calibration_hook():
    """--link-model / set_link_model recalibrates the constants that
    drive auto cadence choice: an extremely slow DCN pushes the chosen
    cadence deeper (fewer, larger exchanges)."""
    from soda_tpu.parallel.mesh import (LINK_MODEL, choose_exchange_cadence,
                                        make_mesh, set_link_model)

    p = parse_file(SODA / "jacobi2d.soda")  # iterate 8
    mesh = make_mesh([2, 4], ["dcn", "x"])
    links = {"dcn": "dcn", "x": "nvlink"}
    saved = dict(LINK_MODEL)
    try:
        set_link_model("dcn=6.25:1e-4")
        cad_fast = choose_exchange_cadence(
            p, (256, 2048), mesh, [0, 1], 8, links)
        set_link_model("dcn=0.01:0.5")  # pathologically slow link
        cad_slow = choose_exchange_cadence(
            p, (256, 2048), mesh, [0, 1], 8, links)
        assert cad_slow["dcn"] >= cad_fast["dcn"]
        assert cad_slow["dcn"] == 8  # exchange once: latency dominates
    finally:
        LINK_MODEL.clear()
        LINK_MODEL.update(saved)
    import pytest as _pytest
    with _pytest.raises(ValueError, match="link-model"):
        set_link_model("garbage")


def test_rank1_mesh_sharding_uneven():
    """Rank-1 programs shard over the mesh too (999 cells over 8 devices
    — pad-to-shard on the only dim)."""
    p = parse_file(SODA / "smooth1d.soda")
    x = rng.standard_normal(999).astype(np.float32)
    gold = numpy_interp.run(p, {p.input_names[0]: x})
    got = run_sharded(p, {p.input_names[0]: x}, axis_sizes=[8], dims=[0])
    k = p.output_names[0]
    r = p.valid_rim()
    assert np.allclose(got[k][r:-r], gold[k][r:-r], rtol=1e-5, atol=1e-5)
