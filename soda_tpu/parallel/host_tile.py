"""Host-side sequential tiling: run grids LARGER THAN DEVICE MEMORY through
one device as a loop over overlapping tiles.

Replacement for the second half of the reference's generated host program
(src/soda/codegen/xilinx/host.py per SURVEY.md §2.1 host-codegen row,
reconstructed — empty mount): the reference host splits an arbitrary full
grid into `tile_size` tiles with overlapping halos and feeds them through
the FPGA kernel sequentially, recomputing the overlap.  `parallel/mesh.py`
is the scale-OUT answer (shard over a device mesh); this module is the
scale-UP answer on ONE device: the full grid lives in host RAM as numpy
arrays, each tile is extended by a zero-filled halo, runs through the
compiled XLA path (`backend.xla.Runner`), and the tile interior is
stitched back on the host.  Only tile + halo ever touches device memory,
so the grid size is bounded by host RAM, not by the card.

Correctness contract (same as the mesh path, docs/SEMANTICS.md):
- halo width per tiled dim = per-sweep chain creep × sweeps_per_pass, so
  every stitched cell is at least `creep × nf` deep in its extended tile
  and its value equals the whole-grid zero-fill evaluation;
- `sweeps_per_pass == 1` is bit-exact against the NumPy oracle on the
  WHOLE grid (ints bitwise; floats to f32 tolerance — XLA fusion);
  deeper passes deviate only inside the border-invalid rim
  (`border: ignore`, width radius × iterate), exactly like the mesh's
  exchange cadence;
- all tiles share one padded shape, so ONE compiled executable serves
  every tile and every pass (grid edges zero-pad: zero IS the
  out-of-grid tap value).

Cost model (reported by `--report` when --host-tile is active): per pass
each tile reads (T+2h)^d cells to produce T^d — the same halo-recompute
overhead the reference host pays — and `passes = iterate / nf` passes
each stream the full grid host -> device -> host once.
"""
from __future__ import annotations

import itertools
import logging
import math
from typing import Mapping

import numpy as np

from ..ir.program import StencilProgram

logger = logging.getLogger(__name__)


def _slice_zero_fill(a: np.ndarray, starts, sizes) -> np.ndarray:
    """a[starts : starts+sizes] with zero fill outside a's bounds (zero is
    the out-of-grid tap value under `border: ignore`)."""
    out = np.zeros(tuple(sizes), dtype=a.dtype)
    src, dst = [], []
    for st, sz, n in zip(starts, sizes, a.shape):
        s0, s1 = max(st, 0), min(st + sz, n)
        if s0 >= s1:
            return out
        src.append(slice(s0, s1))
        dst.append(slice(s0 - st, s1 - st))
    out[tuple(dst)] = a[tuple(src)]
    return out


def normalize_tiles(grid_shape, tiles) -> tuple[int, ...]:
    """Clamp the requested tile shape to the grid; 0/None = full extent."""
    if len(tiles) != len(grid_shape):
        raise ValueError(
            f"--host-tile rank {len(tiles)} != grid rank {len(grid_shape)}")
    out = []
    for t, n in zip(tiles, grid_shape):
        t = n if not t else min(int(t), n)
        if t < 1:
            raise ValueError(f"tile size {t} must be >= 1")
        out.append(t)
    return tuple(out)


def plan_host_tiling(program: StencilProgram, grid_shape, tiles,
                     sweeps_per_pass: int | None = None,
                     iterate: int | None = None):
    """Geometry shared by run_host_tiled and the report: returns
    (tiles, halos, ext_shape, n_tiles, nf, passes, overhead) where
    `overhead` is the per-pass read amplification prod(ext/tile)."""
    it = max(program.iterate if iterate is None else iterate, 1)
    nf = it if sweeps_per_pass is None else int(sweeps_per_pass)
    if nf < 1 or it % nf != 0:
        raise ValueError(
            f"sweeps_per_pass {nf} must divide iterate {it}")
    tiles = normalize_tiles(grid_shape, tiles)
    creep = program.chain_creep()
    halos = tuple(
        (-creep[d][0] * nf, creep[d][1] * nf) if tiles[d] < grid_shape[d]
        else (0, 0)
        for d in range(program.rank))
    ext_shape = tuple(t + lo + hi for t, (lo, hi) in zip(tiles, halos))
    n_tiles = tuple(-(-n // t) for n, t in zip(grid_shape, tiles))
    overhead = math.prod(ext_shape) / math.prod(tiles)
    return tiles, halos, ext_shape, n_tiles, nf, it // nf, overhead


def _shard_ext_shape(program: StencilProgram, ext_shape, mesh_shape,
                     mesh_dims, nf: int) -> tuple[int, ...]:
    """Per-DEVICE tensor shape when a (halo-extended) host tile of
    `ext_shape` is sharded over a mesh of `mesh_shape` along `mesh_dims`
    (default: leading dims, matching mesh.build_sharded_fn): each sharded
    dim becomes ceil(ext/m) plus the mesh exchange halo, bounded above by
    chain-creep × nf (the auto cadence only ever shrinks it)."""
    if mesh_dims is None:
        mesh_dims = tuple(range(len(mesh_shape)))
    creep = program.chain_creep()
    shard = list(ext_shape)
    for m, d in zip(mesh_shape, mesh_dims):
        lo, hi = -creep[d][0] * nf, creep[d][1] * nf
        shard[d] = -(-ext_shape[d] // int(m)) + lo + hi
    return tuple(shard)


def model_mesh_exchange(program: StencilProgram, ext_shape, mesh_shape,
                        mesh_dims, nf: int):
    """Modeled halo-exchange traffic for ONE mesh-sharded host tile
    over one pass of `nf` sweeps: per device, each sharded axis moves
    creep-deep halo slabs totalling nf × r cells per side regardless of
    the exchange cadence (cadence k moves k·r-deep halos nf/k times —
    the product is cadence-invariant; only the latency count differs).
    Returns (per_device_bytes, shard_shape).  Exchanged payload = the
    live state, i.e. the program inputs at their storage widths
    (storage widths; 64-bit tensors at 8 B/cell)."""
    if mesh_dims is None:
        mesh_dims = tuple(range(len(mesh_shape)))
    shard = _shard_ext_shape(program, ext_shape, mesh_shape, mesh_dims, nf)
    creep = program.chain_creep()
    state_bytes = sum(program.tensors[n].type.tpu_storage_bytes
                     for n in program.input_names)
    per_dev = 0
    for m, d in zip(mesh_shape, mesh_dims):
        if int(m) <= 1:
            continue
        r = max(-creep[d][0], creep[d][1])
        cross = math.prod(shard) // shard[d]
        per_dev += 2 * nf * r * cross * state_bytes
    return per_dev, shard


def choose_sweeps_per_pass(program: StencilProgram, grid_shape,
                           tiles=None, hbm_budget: int | None = None,
                           iterate: int | None = None, mesh_shape=None,
                           mesh_dims=None):
    """Pick `sweeps_per_pass` minimizing modeled streamed traffic — the
    host-tiling analog of the mesh's `choose_exchange_cadence`: each pass
    streams every (halo-extended) tile through PCIe+HBM once, and halos
    grow with chain-creep × nf, so small nf pays more passes while large
    nf pays halo recompute (and can outgrow the tile).  Scores every
    divisor nf of iterate by passes × Σ_tiles prod(ext); ties prefer the
    DEEPER nf (fewer passes, less dispatch latency).  With tiles=None
    ('--host-tile auto'), tiles are re-chosen per candidate under
    `hbm_budget` so each nf is scored at the tiles it would actually run.
    Returns (nf, tiles)."""
    if tiles is None and hbm_budget is None:
        raise ValueError(
            "choose_sweeps_per_pass needs explicit tiles or an "
            "hbm_budget to choose them under")
    it = max(program.iterate if iterate is None else iterate, 1)
    divisors = [k for k in range(1, it + 1) if it % k == 0]
    in_b = sum(program.tensors[n].type.tpu_storage_bytes
               for n in program.input_names)
    out_b = sum(program.tensors[n].type.tpu_storage_bytes
                for n in program.output_names)
    best = None  # (cost, -nf, nf, tiles)
    for nf in divisors:
        try:
            ts = tiles if tiles is not None else choose_host_tiles(
                program, grid_shape, hbm_budget, nf, iterate,
                mesh_shape, mesh_dims)
            _, _, ext, nt, _, passes, _ = plan_host_tiling(
                program, grid_shape, ts, nf, iterate)
        except ValueError:
            continue  # nf's halos don't fit any admissible tile
        # per pass: every tile streams its halo-extended inputs H2D and
        # its stitched interior (the whole grid) back D2H — both scale
        # with the pass count, so the write term matters too
        cost = passes * (math.prod(nt) * math.prod(ext) * in_b
                         + math.prod(grid_shape) * out_b)
        key = (cost, -nf)
        if best is None or key < best[0]:
            best = (key, nf, ts)
    if best is None:
        raise ValueError(
            f"no sweeps_per_pass admits a tile of grid "
            f"{tuple(grid_shape)} under the budget; raise --hbm-budget")
    logger.info("--host-tile-sweeps auto -> %d (of iterate %d)",
                best[1], it)
    return best[1], best[2]


def choose_host_tiles(program: StencilProgram, grid_shape,
                      hbm_budget: int, sweeps_per_pass: int | None = None,
                      iterate: int | None = None, mesh_shape=None,
                      mesh_dims=None) -> tuple[int, ...]:
    """Pick a tile shape whose device footprint fits `hbm_budget` bytes:
    repeatedly halve the largest leading dim until the estimated per-tile
    footprint fits.  Footprint = every program tensor at the
    halo-extended tile shape in its XLA compute dtype (4 B/cell up to 32
    bits, 8 for 64-bit, 16 for the quad-limb carriers) × 2 (the scan's
    double-buffered feedback copies).  With `mesh_shape` (the tile runs sharded — run_host_tiled
    mesh composition), the budget is PER DEVICE: the footprint is taken at
    the per-shard shape including mesh exchange halos, so a whole-pod run
    auto-picks tiles mesh-size× larger than a single chip would."""
    tiles = list(normalize_tiles(grid_shape, (0,) * len(grid_shape)))

    def footprint(ts) -> int:
        _, _, ext, _, nf, _, _ = plan_host_tiling(
            program, grid_shape, ts, sweeps_per_pass, iterate)
        if mesh_shape:
            ext = _shard_ext_shape(program, ext, mesh_shape, mesh_dims, nf)
        cells = math.prod(ext)
        per_cell = sum(4 if t.type.width <= 32 else
                       8 if t.type.width <= 64 else 16
                       for t in program.tensors.values())
        return cells * per_cell * 2

    rank = program.rank
    while footprint(tiles) > hbm_budget:
        # prefer cutting leading dims (the contiguous last dim keeps
        # transfers and loads coalesced); it is the LAST resort, floored
        # at 256
        cut = [i for i in range(rank - 1) if tiles[i] > 8] or (
            [rank - 1] if tiles[rank - 1] > 256 else [])
        if not cut:
            raise ValueError(
                f"cannot tile grid {tuple(grid_shape)} under hbm budget "
                f"{hbm_budget} bytes: minimum tile footprint is "
                f"{footprint(tiles)} bytes (tiles {tuple(tiles)}); raise "
                f"--hbm-budget or pass --host-tile explicitly")
        d = max(cut, key=lambda i: tiles[i])
        tiles[d] = -(-tiles[d] // 2)
    return tuple(tiles)


def run_host_tiled(program: StencilProgram, inputs, params=None, *,
                   tiles, grid_shape=None, sweeps_per_pass=None,
                   iterate=None, mesh=None, mesh_dims=None,
                   sweeps_per_exchange=None, overlap=False,
                   link_classes=None) -> dict:
    """Execute `program` over a grid held in HOST memory by looping
    overlapping tiles through the compiled XLA path.  Returns numpy
    outputs in declared dtypes (same surface as xla.run).

    With `mesh` (a jax.sharding.Mesh), each tile runs SHARDED over the
    mesh (`parallel/mesh.py` — ppermute halo exchange inside the tile):
    the decomposition for grids larger than all the devices' memory
    together — host tiles -> mesh shards.  Stitched interiors sit at
    least `creep × nf` inside their tile, outside the mesh cadence's
    rim-deviation zone, so the contract is unchanged."""
    import jax
    import jax.numpy as jnp

    from ..backend import xla
    from ..interp.wide64 import program_is_wide

    params = dict(params or {})
    xla.check_io(program, inputs, params)
    inputs = {k: np.asarray(v) for k, v in inputs.items()}
    if grid_shape is None:
        grid_shape = tuple(next(iter(inputs.values())).shape)
    for n in program.input_names:
        if tuple(inputs[n].shape) != tuple(grid_shape):
            # _slice_zero_fill would silently zero-fill the mismatch
            raise ValueError(
                f"input {n!r} has shape {inputs[n].shape}, expected grid "
                f"shape {tuple(grid_shape)}")
    tiles, halos, ext_shape, n_tiles, nf, passes, overhead = \
        plan_host_tiling(program, grid_shape, tiles, sweeps_per_pass,
                         iterate)
    logger.info(
        "host tiling %s: %s tiles of %s (+halo -> %s), %d pass(es) of %d "
        "sweep(s), read amplification %.3fx/pass",
        program.name, "x".join(map(str, n_tiles)),
        "x".join(map(str, tiles)), "x".join(map(str, ext_shape)),
        passes, nf, overhead)

    # one executable for EVERY tile and pass: all tiles share ext_shape
    if mesh is not None:
        from .mesh import build_sharded_fn

        fn = build_sharded_fn(
            program, mesh, dims=mesh_dims, iterate=nf,
            sweeps_per_exchange=sweeps_per_exchange,
            grid_shape=ext_shape, overlap=overlap,
            link_classes=link_classes)
        if program_is_wide(program):
            # the wide sharded fn splits/merges 64-bit planes on the host
            # itself (numpy in, numpy out; its shard_map is jitted)
            def dispatch(tile_in):
                return fn(tile_in, params)
        else:
            jfn = jax.jit(fn)

            def dispatch(tile_in):
                return jfn({k: jnp.asarray(v) for k, v in tile_in.items()},
                           params)

        def fetch(outs):
            return xla.finalize_outputs(program, outs)
    else:
        runner = xla.Runner(program, iterate=nf)

        def dispatch(tile_in):
            return runner.dispatch(tile_in, params)

        fetch = runner.fetch

    in_name = program.input_names[0]
    out0 = program.output_names[0]
    values = dict(inputs)  # full-grid host arrays, declared dtypes
    host_out: dict[str, np.ndarray] = {}
    for _ in range(passes):
        host_out = {
            n: np.empty(grid_shape, dtype=program.tensors[n].type.np_dtype())
            for n in program.output_names}
        # two tiles in flight: dispatch() returns before the device
        # finishes, so tile k+1's host slicing, host-to-device transfer
        # and launch overlap with fetching tile k's outputs — the
        # host-tiling analog of the reference host's overlapped DMA.
        # Bounds device memory at ~2 tiles.
        pending = None  # (dst, src, device outputs)

        def _flush(p):
            dst, src, douts = p
            nouts = fetch(douts)
            for n in program.output_names:
                host_out[n][dst] = nouts[n][src]

        for idx in itertools.product(*(range(k) for k in n_tiles)):
            starts = tuple(i * t for i, t in zip(idx, tiles))
            tile_in = {
                n: _slice_zero_fill(
                    values[n],
                    tuple(s - lo for s, (lo, _) in zip(starts, halos)),
                    ext_shape)
                for n in program.input_names}
            outs = dispatch(tile_in)
            # stitch the tile interior (edge tiles: clip to the real grid)
            dst = tuple(
                slice(s, min(s + t, n))
                for s, t, n in zip(starts, tiles, grid_shape))
            src = tuple(
                slice(lo, lo + (sl.stop - sl.start))
                for (lo, _), sl in zip(halos, dst))
            if pending is not None:
                _flush(pending)
            pending = (dst, src, outs)
        _flush(pending)
        if passes > 1:
            # feedback between passes: first output -> first input on the
            # host; auxiliary inputs carry over (same convention as the
            # xla backend's scan)
            values = {n: inputs[n] for n in program.input_names}
            values[in_name] = host_out[out0]
    return host_out
