"""Host-side sequential tiling (parallel/host_tile.py) vs the NumPy
oracle: the single-chip answer to grids larger than device HBM — the
reference host's overlapping-tile loop (SURVEY.md §2.1 host-codegen row).

The at-size run on the GPU (jacobi3d 1024^3 under a 1 GiB budget) is
phase 4 of chip_smoke.py."""

import pathlib

import numpy as np
import pytest

from soda_tpu.frontend.parser import parse_file
from soda_tpu.interp import numpy_interp
from soda_tpu.parallel.host_tile import (
    choose_host_tiles,
    normalize_tiles,
    plan_host_tiling,
    run_host_tiled,
)
from soda_tpu.utils.testing import assert_outputs_match, rand_inputs

SODA = pathlib.Path(__file__).parent / "soda"
rng = np.random.default_rng(7)


def _inputs(p, gs):
    # shared with the hardware gate — one definition of distributions
    return rand_inputs(p, gs, rng)


def _check(p, got, gold, rim=None):
    assert_outputs_match(p, got, gold, rim)


CASES = [
    # (program, grid, tiles, kwargs)
    ("blur.soda", (70, 200), (32, 96), {}),            # single stage 2-D
    ("sobel2d.soda", (50, 170), (30, 90), {}),         # multi-stage DAG
    ("jacobi2d.soda", (60, 180), (40, 64), {}),        # iterate, 1 pass
    ("jacobi2d.soda", (60, 180), (40, 64),
     dict(sweeps_per_pass=2)),                         # chunked passes
    ("jacobi3d.soda", (20, 30, 140), (8, 16, 70), {}),  # 3-D
    ("denoise3d.soda", (16, 24, 140), (8, 12, 70), {}),  # 3-D multi-stage
    ("residual2d.soda", (40, 150), (20, 80), {}),      # multi-output iterate
    ("smooth1d.soda", (700,), (256,), {}),             # rank 1
    ("accum64.soda", (48, 160), (24, 80), {}),         # 64-bit (x64)
    ("smooth_half.soda", (48, 160), (24, 80), {}),     # half
]


@pytest.mark.parametrize("name,gs,tiles,kw", CASES,
                         ids=[f"{c[0]}-{c[3]}" for c in CASES])
def test_host_tile_matches_oracle(name, gs, tiles, kw):
    p = parse_file(SODA / name)
    ins, ps = _inputs(p, gs)
    got = run_host_tiled(p, ins, ps, tiles=tiles, **kw)
    gold = numpy_interp.run(p, ins, ps)
    _check(p, got, gold)


def test_single_pass_cadence_bit_exact_everywhere():
    """sweeps_per_pass=1 matches the oracle on the WHOLE grid for a
    single-stage integer program (same contract as the mesh's
    exchange-every-sweep — docs/SEMANTICS.md)."""
    p = parse_file(SODA / "erode2d.soda")
    gs = (40, 150)
    ins, ps = _inputs(p, gs)
    got = run_host_tiled(p, ins, ps, tiles=(16, 64), sweeps_per_pass=1)
    gold = numpy_interp.run(p, ins, ps)
    _check(p, got, gold, rim=0)


def test_uneven_edge_tiles():
    """Tile sizes that do not divide the grid: edge tiles clip."""
    p = parse_file(SODA / "blur.soda")
    gs = (67, 201)
    ins, ps = _inputs(p, gs)
    got = run_host_tiled(p, ins, ps, tiles=(32, 96))
    gold = numpy_interp.run(p, ins, ps)
    _check(p, got, gold)


def test_plan_geometry():
    p = parse_file(SODA / "jacobi2d.soda")  # iterate 8, radius 1
    tiles, halos, ext, nt, nf, passes, ov = plan_host_tiling(
        p, (64, 256), (32, 128))
    assert tiles == (32, 128) and nt == (2, 2)
    assert halos == ((8, 8), (8, 8))  # creep 1 x 8 fused sweeps
    assert ext == (48, 144)
    assert nf == 8 and passes == 1
    assert ov == pytest.approx(48 * 144 / (32 * 128))
    # chunked: halo shrinks with the per-pass sweep count
    _, halos2, _, _, nf2, passes2, _ = plan_host_tiling(
        p, (64, 256), (32, 128), sweeps_per_pass=2)
    assert halos2 == ((2, 2), (2, 2)) and nf2 == 2 and passes2 == 4
    # untiled dims carry no halo
    _, halos3, _, _, _, _, _ = plan_host_tiling(p, (64, 256), (32, 0))
    assert halos3 == ((8, 8), (0, 0))
    with pytest.raises(ValueError):
        plan_host_tiling(p, (64, 256), (32, 128), sweeps_per_pass=3)


def test_choose_host_tiles_fits_budget():
    p = parse_file(SODA / "jacobi3d.soda")
    gs = (2048, 2048, 2048)  # 32 GiB f32 x (in+out): beyond one card
    tiles = choose_host_tiles(p, gs, 12 * 2**30)
    assert tiles[-1] == gs[-1]  # lane dim never cut
    _, _, ext, _, _, _, _ = plan_host_tiling(p, gs, tiles)
    cells = int(np.prod(ext))
    assert cells * 4 * 2 * 2 <= 12 * 2**30
    # small grids stay untiled
    assert choose_host_tiles(p, (128, 128, 128), 12 * 2**30) == \
        (128, 128, 128)


def test_choose_host_tiles_mesh_aware():
    """Under mesh composition the budget is per DEVICE: an 8-device mesh
    must admit tiles ~8x larger than the single-chip chooser picks."""
    from soda_tpu.parallel.host_tile import model_mesh_exchange
    p = parse_file(SODA / "jacobi3d.soda")
    gs = (2048, 2048, 2048)
    solo = choose_host_tiles(p, gs, 12 * 2**30)
    meshed = choose_host_tiles(p, gs, 12 * 2**30, mesh_shape=(4, 2))
    assert np.prod(meshed) > np.prod(solo)  # budget divided over devices
    # per-shard footprint (incl. mesh halos) fits the per-device budget
    _, _, ext, _, nf, _, _ = plan_host_tiling(p, gs, meshed)
    xbytes, shard = model_mesh_exchange(p, ext, (4, 2), None, nf)
    assert int(np.prod(shard)) * 4 * 2 * 2 <= 12 * 2**30
    # exchange model: both sharded axes move 2 sides x nf x r x cross
    creep = p.chain_creep()
    want = 0
    for m, d in ((4, 0), (2, 1)):
        r = max(-creep[d][0], creep[d][1])
        want += 2 * nf * r * (np.prod(shard) // shard[d]) * 4
    assert xbytes == want
    # mesh axes of size 1 exchange nothing
    assert model_mesh_exchange(p, ext, (1, 1), None, nf)[0] == 0


def test_choose_sweeps_per_pass():
    """Auto cadence scores every divisor of iterate by streamed traffic:
    untiled grids take one deep pass; tiny tiles with deep halos prefer
    shallower passes once halo recompute dominates the extra streaming."""
    from soda_tpu.parallel.host_tile import choose_sweeps_per_pass
    p = parse_file(SODA / "jacobi2d.soda")  # iterate=8, creep r=1
    # untiled: halos are free, so all-in-one-pass wins
    nf, ts = choose_sweeps_per_pass(p, (64, 256), tiles=(64, 256))
    assert (nf, ts) == (8, (64, 256))
    # ONE tiled dim: read cost = it·t/nf + const, so deep still wins
    assert choose_sweeps_per_pass(p, (64, 256), tiles=(8, 256))[0] == 8
    # TWO tiled dims, halo-dominated 4x4 tiles of 64x64: reads grow
    # ~nf², writes are grid-constant per pass.  Per-nf cost
    # (8/nf)·(256·(4+2nf)² + 4096) = 106496, 81920, 81920, 106496 for
    # nf = 1, 2, 4, 8 — interior optimum, tie broken toward deeper
    assert choose_sweeps_per_pass(p, (64, 64), tiles=(4, 4))[0] == 4
    # joint mode (tiles=None): tiles come back sized for the chosen nf
    nf3, ts3 = choose_sweeps_per_pass(p, (64, 256), tiles=None,
                                      hbm_budget=64 * 2**10)
    _, _, ext3, _, _, _, _ = plan_host_tiling(p, (64, 256), ts3, nf3)
    assert int(np.prod(ext3)) * 4 * 2 * 2 <= 64 * 2**10


def test_normalize_tiles_validation():
    assert normalize_tiles((64, 256), (0, 300)) == (64, 256)
    with pytest.raises(ValueError):
        normalize_tiles((64, 256), (32,))


def test_host_tile_over_mesh():
    """Host tiles x mesh shards (3-level decomposition): each tile runs
    sharded over the simulated 8-device mesh with ppermute halo exchange
    inside the tile."""
    from soda_tpu.parallel.host_tile import run_host_tiled
    from soda_tpu.parallel.mesh import make_mesh

    p = parse_file(SODA / "jacobi2d.soda")
    gs = (64, 192)
    ins, ps = _inputs(p, gs)
    mesh = make_mesh([4], ["x"])
    got = run_host_tiled(p, ins, ps, tiles=(32, 96), mesh=mesh)
    gold = numpy_interp.run(p, ins, ps)
    _check(p, got, gold)


def test_host_tile_over_mesh_wide():
    """Wide pair carriers through the mesh-composed tile path (the
    sharded fn owns the 64-bit plane boundary)."""
    from soda_tpu.parallel.host_tile import run_host_tiled
    from soda_tpu.parallel.mesh import make_mesh

    p = parse_file(SODA / "accum64.soda")
    gs = (48, 160)
    ins, ps = _inputs(p, gs)
    mesh = make_mesh([2, 2], ["x", "y"])
    got = run_host_tiled(p, ins, ps, tiles=(24, 80), mesh=mesh)
    gold = numpy_interp.run(p, ins, ps)
    _check(p, got, gold)


def test_pass_depth_dividing_iterate():
    """iterate=12 in passes of 6 sweeps: every one of the 12 sweeps runs
    (2 passes x 6) and matches the oracle."""
    p = parse_file(SODA / "jacobi2d.soda")
    gs = (48, 160)
    ins, ps = _inputs(p, gs)
    gold = numpy_interp.run(p, ins, ps, iterate=12)
    got = run_host_tiled(p, ins, ps, tiles=(24, 80), iterate=12,
                         sweeps_per_pass=6)
    _check(p, got, gold, rim=p.valid_rim(iterate=12))


def test_plan_rejects_non_divisor_pass():
    """A pass depth that does not divide the executed iterate raises
    instead of silently under-executing."""
    p = parse_file(SODA / "jacobi2d.soda")
    with pytest.raises(ValueError, match="must divide iterate"):
        plan_host_tiling(p, (48, 160), (24, 80), sweeps_per_pass=6)
