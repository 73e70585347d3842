"""Cross-device grid sharding: `shard_map` over a device mesh with
`ppermute` halo exchange.

Replacement for the reference's host-side tiling of large grids into
overlapping tiles (src/soda/codegen/xilinx/host.py per SURVEY.md §2.3/§5
"long-context" row, reconstructed — empty mount): instead of the host
re-computing halo overlaps per tile, the grid is sharded over a device
mesh and each sweep (or fused sweep-chunk) exchanges halo slabs with
neighbor devices (NVLink between the cards of one host; XLA hands the
ppermutes to NCCL).  This is the stencil world's ring/neighbor exchange
(the context-parallelism analog).  The mesh follows the algorithm alone:
the cards of one host reach each other at the same rate.

Boundary convention: `jax.lax.ppermute` leaves non-received outputs ZERO,
which is exactly the program's zero-fill border convention — edge devices
get a zero halo for free.

Uneven (non-divisible) grids pad-to-shard: each sharded dim is zero-padded
to a mesh-axis multiple at the host boundary, outputs re-zero the pad
region after every exchange chunk (exchanged halos keep the zero-fill
contract), and results are sliced back — bit-exact at exchange-every-sweep,
rim-only deviation at deeper cadences (docs/SEMANTICS.md).

Local per-device compute is the XLA backend's sweep evaluation.  64-bit
programs shard as pairs of 32-bit planes (interp/wide64.py carriers).
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..backend import xla as xla_backend
from ..interp.evaluator import EvalContext, eval_expr, store_cast
from ..ir.program import StencilProgram


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str] | None = None,
              devices=None) -> Mesh:
    """Create a Mesh of the requested shape from available devices."""
    import numpy as np

    axis_names = tuple(axis_names or [f"ax{i}" for i in range(len(axis_sizes))])
    n = math.prod(axis_sizes)
    devices = list(devices if devices is not None else jax.devices())[:n]
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh(np.array(devices).reshape(tuple(axis_sizes)), axis_names)


def halo_exchange(x: jax.Array, dim: int, lo: int, hi: int,
                  axis_name: str) -> jax.Array:
    """Extend `x` along `dim` with halo slabs from mesh neighbors.

    Device i receives the top `lo` rows of device i-1 as its low halo and
    the bottom `hi` rows of device i+1 as its high halo; edge devices get
    zeros (ppermute non-received outputs are zero — matches the border
    convention).  Halos WIDER than one shard gather from k-hop neighbors
    with one ppermute per hop (XLA can overlap the independent sends).  64-bit pair carriers (interp/wide64.W) exchange
    per plane — zero planes ARE the zero value."""
    from ..interp.wide64 import W

    if isinstance(x, W):
        return x.map(lambda p: halo_exchange(p, dim, lo, hi, axis_name))
    n = jax.lax.axis_size(axis_name)
    n_loc = x.shape[dim]
    parts = []
    if lo > 0:
        hops = -(-lo // n_loc)
        for k in range(hops, 0, -1):  # farthest neighbor first (top-down)
            cnt = min(n_loc, lo - (k - 1) * n_loc)
            send = jax.lax.slice_in_dim(x, n_loc - cnt, n_loc, axis=dim)
            recv = jax.lax.ppermute(send, axis_name,
                                    [(j, j + k) for j in range(n - k)])
            parts.append(recv)
    parts.append(x)
    if hi > 0:
        hops = -(-hi // n_loc)
        for k in range(1, hops + 1):  # nearest neighbor first (top-down)
            cnt = min(n_loc, hi - (k - 1) * n_loc)
            send = jax.lax.slice_in_dim(x, 0, cnt, axis=dim)
            recv = jax.lax.ppermute(send, axis_name,
                                    [(j, j - k) for j in range(k, n)])
            parts.append(recv)
    if len(parts) == 1:
        return x
    return jnp.concatenate(parts, axis=dim)


# ---- link model --------------------------------------------------------
# Per-device link costs (GB/s each way, per-exchange latency s) that drive
# the auto cadence choice.  The "nvlink" class (every axis not named dcn*)
# comes from the device table (utils/device.py).  A "dcn" class — a slower
# link between hosts — has no default: one machine of cards has none to
# model, so a dcn* axis needs `sodac --link-model 'dcn=GBPS:LAT'` (or
# set_link_model()).  Only the RATIO of link to compute cost drives the
# choice; calibrate with measured numbers.
LINK_MODEL: dict[str, tuple[float, float]] = {}


def set_link_model(spec: str) -> None:
    """Override link constants from 'class=GB/s:latency_s[,...]', e.g.
    'nvlink=400:8e-6,dcn=25:1e-4' — the calibration hook."""
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            name, val = part.split("=", 1)
            bw, lat = val.split(":", 1)
            LINK_MODEL[name.strip()] = (float(bw), float(lat))
        except ValueError as e:
            raise ValueError(
                f"bad --link-model entry {part!r}: expected "
                f"class=GBps:latency_s (e.g. nvlink=450:1e-5)") from e


def link_cost(link_class: str, spec) -> tuple[float, float]:
    """(GB/s, latency s) of a link class: a calibrated override, else the
    device table's NVLink row; a class with neither is an error."""
    if link_class in LINK_MODEL:
        return LINK_MODEL[link_class]
    if link_class == "nvlink":
        return spec.link_bytes_per_s / 1e9, spec.link_latency_s
    raise ValueError(
        f"link class {link_class!r} has no default cost on one machine; "
        f"give it with --link-model '{link_class}=GBPS:LATENCY_S'")


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def choose_exchange_cadence(
    program: StencilProgram,
    grid_shape: tuple[int, ...],
    mesh: Mesh,
    dims: Sequence[int],
    iterate: int,
    link_classes: Mapping[str, str],
) -> dict[str, int]:
    """Pick per-axis sweeps-per-exchange from the modeled link costs.

    For each mesh axis (independently), scores every divisor k of
    `iterate` by  (it/k)·(latency + halo_bytes(k)/bw)  +  it·extra_cells(k)
    /vpu_rate — fewer, deeper exchanges amortize slow-link latency and
    bandwidth at the price of halo recompute — then rounds the choices to
    a divisor chain (slow axes exchange at multiples of fast axes' cadence)
    so the exchange schedule nests — the analog of multi-host training's
    'communicate over the slow link less often'.  Compute and NVLink
    rates come from the device table row of the mesh's devices."""
    from ..utils.device import device_spec
    from ..utils.opcount import ops_per_cell

    spec = device_spec(mesh.devices.flat[0].device_kind)
    it = max(iterate, 1)
    out_span = program.chain_creep()
    mesh_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    ops = max(ops_per_cell(program), 1)
    cell_s = ops / spec.f32_flops_per_s
    # bytes per cell moved/computed: use the widest tensor container
    dtype_b = max(t.type.tpu_storage_bytes for t in program.tensors.values())

    cad: dict[str, int] = {}
    for ax, d in zip(mesh.axis_names, dims):
        bw_gbps, lat = link_cost(link_classes.get(ax, "nvlink"), spec)
        r = (-out_span[d][0]) + out_span[d][1]
        if r == 0 or it == 1:
            cad[ax] = it
            continue
        # local cross-section: the shard's area perpendicular to d
        local_shape = []
        for e in range(len(grid_shape)):
            sz = grid_shape[e]
            for a2, d2 in zip(mesh.axis_names, dims):
                if d2 == e:
                    sz //= mesh_sizes[a2]
            local_shape.append(sz)
        cross = math.prod(local_shape) // max(local_shape[d], 1)
        best_k, best_t = 1, float("inf")
        for k in _divisors(it):
            halo_bytes = k * r * cross * dtype_b
            comm = (it // k) * (lat + halo_bytes / (bw_gbps * 1e9))
            extra = it * (k * r) * cross * cell_s
            t = comm + extra
            if t < best_t:
                best_k, best_t = k, t
        cad[ax] = best_k
    # round to a divisor chain (sorted descending, each divides the prior)
    order = sorted(cad, key=lambda a: -cad[a])
    for prev, nxt in zip(order, order[1:]):
        k = cad[nxt]
        while cad[prev] % k != 0:
            k -= 1
        cad[nxt] = k
    return cad


def _slice_dim(x, start, stop, axis):
    """lax.slice_in_dim that maps over 64-bit pair carriers."""
    from ..interp.wide64 import slice_dim

    return slice_dim(x, start, stop, axis)


def _dus(x, upd, start):
    """dynamic_update_slice that maps over 64-bit pair carriers."""
    from ..interp.wide64 import W

    if isinstance(x, W):
        return W(x.rep,
                 jax.lax.dynamic_update_slice(
                     x.a, upd.a.astype(x.a.dtype), start),
                 jax.lax.dynamic_update_slice(
                     x.b, upd.b.astype(x.b.dtype), start), x.xp)
    return jax.lax.dynamic_update_slice(x, upd.astype(x.dtype), start)


def build_sharded_fn(
    program: StencilProgram,
    mesh: Mesh,
    *,
    dims: Sequence[int] | None = None,
    iterate: int | None = None,
    sweeps_per_exchange: int | Mapping[str, int] | None = None,
    grid_shape: tuple[int, ...] | None = None,
    overlap: bool = False,
    link_classes: Mapping[str, str] | None = None,
):
    """Build fn(inputs, params) -> outputs, sharded over `mesh`.

    `dims[k]` is the tensor dim sharded over mesh axis k (default: leading
    dims).  Per exchange, halo width = sweeps_per_exchange × per-sweep span
    along each sharded dim; local compute runs that many fused sweeps on
    the halo-extended shard, then slices the center (overlapped tiling
    across devices — SODA's host tiling, but over the device links).

    Slow links: pass `link_classes` mapping mesh axis name →
    "nvlink"|"dcn" and either a per-axis `sweeps_per_exchange` mapping or
    None (auto: `choose_exchange_cadence` picks deeper cadences on slow
    dcn axes from the modeled link costs).  Differing per-axis cadences
    run a NESTED exchange schedule — slowest axis outermost — and fall
    back to the synchronous (non-overlap) path."""
    it = max(program.iterate if iterate is None else iterate, 1)
    from ..interp import wide64

    # 64-bit programs shard as PLANE PAIRS: each wide tensor crosses the
    # shard_map boundary as two 32-bit plane arrays, halo-exchanged per
    # plane, and the local compute runs the pair-carrier evaluator
    # (exact s64/u64, double-single f64).
    # Synthetic compiler-generated int64 partial sums in 32-bit programs
    # keep int32 local compute (documented).
    from ..interp.wide128 import program_is_128

    if program_is_128(program):
        raise NotImplementedError(
            f"program {program.name!r} uses >64-bit integers: the mesh "
            "path shards up to 64-bit plane pairs; run single-chip with "
            "`--backend xla` (quad-limb carriers)")
    wide = wide64.program_is_wide(program)
    axis_names = mesh.axis_names
    if dims is None:
        dims = tuple(range(len(axis_names)))
    if len(dims) != len(axis_names):
        raise ValueError("one tensor dim per mesh axis")

    # normalize the exchange cadence: uniform int (legacy), explicit
    # per-axis mapping, or auto per-axis when a dcn axis is declared
    cad: dict[str, int] | None = None
    if isinstance(sweeps_per_exchange, Mapping):
        cad = {ax: int(sweeps_per_exchange.get(ax, it)) for ax in axis_names}
    elif (sweeps_per_exchange is None and link_classes
          and grid_shape is not None and it > 1
          and any(link_classes.get(ax) == "dcn" for ax in axis_names)):
        cad = choose_exchange_cadence(
            program, grid_shape, mesh, dims, it, link_classes)
    if cad is not None:
        for ax, k in cad.items():
            if k < 1 or it % k != 0:
                raise ValueError(
                    f"cadence {k} for mesh axis {ax!r} must divide "
                    f"iterate {it}")
        chain = sorted(cad.values(), reverse=True)
        for a, b in zip(chain, chain[1:]):
            if a % b != 0:
                raise ValueError(
                    f"per-axis exchange cadences must form a divisor chain "
                    f"(slow axes exchange at multiples of fast axes); "
                    f"got {cad}")
        if len(set(cad.values())) == 1:
            sweeps_per_exchange, cad = chain[0], None
    nf = (sweeps_per_exchange
          if isinstance(sweeps_per_exchange, int) else None) or it
    if it % nf != 0:
        raise ValueError(f"sweeps_per_exchange {nf} must divide iterate {it}")

    # per-sweep margin for the shard-local CONSTANT-EXTENT evaluation
    # (sweeps_on / halo-extended shards): the non-cancelling chain creep,
    # not the composed span — mixed-sign stage chains need more
    out_span = program.chain_creep()

    # Non-divisible grids PAD-TO-SHARD (the reference host tiles arbitrary
    # grids with overlapping halos — SURVEY.md §2.1 host-codegen row): each
    # sharded dim is zero-padded up to a multiple of its mesh axis at the
    # host boundary (zero IS the out-of-grid tap value), the pad region of
    # every output is re-zeroed after each exchange chunk so exchanged
    # halos always carry correct zero-fill semantics, and outputs are
    # sliced back.  Exchange-every-sweep (nf=1) is bit-exact everywhere;
    # deeper cadences deviate only inside the border-invalid rim
    # (`border: ignore`, width creep×sweeps — docs/SEMANTICS.md).
    pad_dims: dict[int, tuple[str, int, int]] = {}  # d -> (ax, real, shard)
    padded_shape: tuple[int, ...] | None = None
    if grid_shape is not None:
        mesh_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        pshape = list(grid_shape)
        for ax, d in zip(mesh.axis_names, dims):
            m = mesh_sizes[ax]
            padded = -(-grid_shape[d] // m) * m
            shard = padded // m
            if padded != grid_shape[d]:
                pad_dims[d] = (ax, grid_shape[d], shard)
                pshape[d] = padded
            r = max(-out_span[d][0], out_span[d][1])
            # auto-chosen nf prefers halos within one shard (single-hop
            # exchange); an EXPLICIT sweeps_per_exchange is honored — wider
            # halos gather from k-hop neighbors in halo_exchange
            if sweeps_per_exchange is None and cad is None:
                while nf > 1 and (nf * r > shard or it % nf != 0):
                    nf -= 1
        padded_shape = tuple(pshape)

    halos = {}
    for ax, d in zip(axis_names, dims):
        halos[d] = (-out_span[d][0] * nf, out_span[d][1] * nf, ax)

    def _mask_pad_dim(outs: dict, d: int) -> dict:
        """Zero the pad-to-shard rows of dim `d` in every tensor of `outs`
        (wide pairs: both planes — zero planes ARE the zero value).  Runs
        INSIDE shard_map: the device's global position comes from
        axis_index, so only the trailing shard(s) holding pad rows mask
        anything."""
        if d not in pad_dims:
            return outs
        ax, real, shard = pad_dims[d]
        idx = jax.lax.axis_index(ax)
        valid = real - idx * shard  # rows of this shard inside the real grid

        def m(x):
            iota = jax.lax.broadcasted_iota(jnp.int32, x.shape, d)
            return jnp.where(iota < valid, x, jnp.zeros_like(x))

        return {n: (v.map(m) if isinstance(v, wide64.W) else m(v))
                for n, v in outs.items()}

    def _mask_pad(outs: dict) -> dict:
        for d in pad_dims:
            outs = _mask_pad_dim(outs, d)
        return outs

    in_name = program.input_names[0]
    out_names = program.output_names
    params_spec = {n: P() for n in program.params}

    def spec_for_tensor():
        parts: list = [None] * program.rank
        for ax, d in zip(axis_names, dims):
            parts[d] = ax
        return P(*parts)

    tspec = spec_for_tensor()

    def _eval_ctx(tap, params):
        if wide:
            return EvalContext(program=program, xp=wide64.WideXP(jnp),
                               tap=tap, params=params, int_width=64,
                               pair_wide=True)
        return EvalContext(program=program, xp=jnp, tap=tap,
                           params=params, int_width=32)

    def sweeps_on(arrs: dict, params: dict) -> dict:
        """nf zero-fill sweeps on whatever extents `arrs` has."""
        out = dict(arrs)
        for s in range(nf):
            ctx = _eval_ctx(
                lambda name, off: xla_backend.shifted_jnp(out[name], off),
                params)
            for name in program.stage_order():
                t = program.tensors[name]
                v, vt = eval_expr(t.expr, ctx)
                out[name] = store_cast(ctx, v, vt, t.type)
            if nf > 1 and s + 1 < nf:
                # feedback: output -> first input; aux inputs carry over
                nxt = {n: out[n] for n in program.input_names}
                nxt[in_name] = out[out_names[0]]
                out = nxt
        return out

    def local_chunk_overlap(arrays: dict, params: dict) -> dict:
        """Comms/compute overlap (any mesh rank): the shard interior is computed from purely local data
        while the ppermute halo exchange is in flight (XLA overlaps the
        async collective with the independent interior computation); only
        thin boundary strips per sharded dim are recomputed from the
        exchanged arrays and stitched in with in-place
        dynamic-update-slices.  Identical results to the synchronous path —
        the interior is exactly the region unaffected by halo data, and
        strip slabs carry the other dims' halos so corners are exact."""
        # interior: full local compute on the RAW shard (zero-filled edges;
        # invalid only within the lo/hi bands replaced below)
        local_out = sweeps_on(arrays, params)

        ext = {}
        for n, x in arrays.items():
            for d, (lo, hi, ax) in halos.items():
                x = halo_exchange(x, d, lo, hi, ax)
            ext[n] = x

        out = {n: local_out[n] for n in out_names}
        shard = next(iter(arrays.values())).shape
        for d, (lo, hi, _ax) in halos.items():
            # low strip: local rows [0, lo) need ext rows [0, 2lo + hi);
            # high strip symmetric.  Slabs keep the OTHER dims' halos, so
            # after evaluation the other dims are cropped to their centers.
            slabs = []
            if lo > 0:
                slabs.append(("lo", {
                    n: _slice_dim(x, 0, 2 * lo + hi, d)
                    for n, x in ext.items()}))
            if hi > 0:
                slabs.append(("hi", {
                    n: _slice_dim(x, x.shape[d] - (2 * hi + lo),
                                  x.shape[d], d)
                    for n, x in ext.items()}))
            for side, slab_in in slabs:
                slab_out = sweeps_on(slab_in, params)
                for n in out_names:
                    v = slab_out[n]
                    # crop other sharded dims to their shard centers
                    for e, (lo_e, hi_e, _axe) in halos.items():
                        if e != d:
                            v = _slice_dim(v, lo_e, lo_e + shard[e], e)
                    sz = v.shape[d]
                    if side == "lo":
                        strip = _slice_dim(v, lo, 2 * lo, d)
                        pos = 0
                    else:
                        strip = _slice_dim(v, sz - 2 * hi, sz - hi, d)
                        pos = shard[d] - hi
                    start = [0] * program.rank
                    start[d] = pos
                    out[n] = _dus(out[n], strip, tuple(start))
        return out

    def local_chunk(arrays: dict, params: dict) -> dict:
        """nf fused sweeps on halo-extended shards; returns center shards."""
        shard = next(iter(arrays.values())).shape
        # overlap's strip geometry needs the halo within one shard
        # (slab = 2*lo+hi rows of the extended array); multi-hop halos
        # take the synchronous path instead of crashing
        overlap_ok = all(lo <= shard[d] and hi <= shard[d]
                         for d, (lo, hi, _ax) in halos.items())
        if overlap and halos and overlap_ok:
            return local_chunk_overlap(arrays, params)
        ext = {}
        for n, x in arrays.items():
            for d, (lo, hi, ax) in halos.items():
                x = halo_exchange(x, d, lo, hi, ax)
            ext[n] = x

        arrs = sweeps_on(dict(ext), params)

        out = {}
        for n in out_names:
            x = arrs[n]
            for d, (lo, hi, _ax) in halos.items():
                x = _slice_dim(x, lo, x.shape[d] - hi, d)
            out[n] = x
        return out

    def _local_cast(inputs: dict) -> dict:
        out = {}
        for n in program.input_names:
            v = inputs[n]
            if isinstance(v, wide64.W):
                out[n] = v  # pair carriers are already in compute form
            else:
                out[n] = jnp.asarray(
                    v, jnp.float32 if program.tensors[n].type.is_float
                    else jnp.int32)
        return out

    def local_fn(inputs: dict, params: dict) -> dict:
        arrays = _local_cast(inputs)
        # mask after EVERY chunk: the next chunk's halo exchange (and the
        # feedback input) must see zeros in the pad region, preserving the
        # out-of-grid-taps-read-zero contract across devices
        outs = _mask_pad(local_chunk(arrays, params))
        for _ in range(it // nf - 1):
            nxt = {n: arrays[n] for n in program.input_names}
            nxt[in_name] = outs[out_names[0]]
            outs = _mask_pad(local_chunk(nxt, params))
        return outs

    # ---- nested per-axis cadence (slow-link) schedule ----------------------
    # Slowest axis outermost: each level exchanges its own halo every
    # cad[ax] sweeps and recurses; the innermost runs cad[min] constant-
    # extent zero-fill sweeps.  Validity creep
    # along an outer dim stays within that level's k*creep halo exactly as
    # in the uniform case; inner exchanges operate on outer-extended arrays
    # whose extension validity is symmetric across the inner axis, so
    # received halo slabs carry the same (in)validity as local rows.
    if cad is not None:
        order = sorted(zip(axis_names, dims), key=lambda t: -cad[t[0]])

        def sweeps_n(arrs: dict, params: dict, n: int) -> dict:
            out = dict(arrs)
            for s in range(n):
                ctx = _eval_ctx(
                    lambda name, off: xla_backend.shifted_jnp(
                        out[name], off), params)
                for name in program.stage_order():
                    t = program.tensors[name]
                    v, vt = eval_expr(t.expr, ctx)
                    out[name] = store_cast(ctx, v, vt, t.type)
                if s + 1 < n:
                    nxt = {n2: out[n2] for n2 in program.input_names}
                    nxt[in_name] = out[out_names[0]]
                    out = nxt
            return out

        def run_level(arrays: dict, level: int, sweeps: int,
                      params: dict) -> dict:
            if level == len(order):
                res = sweeps_n(arrays, params, sweeps)
                return {n: res[n] for n in out_names}
            ax, d = order[level]
            k = cad[ax]
            lo, hi = -out_span[d][0] * k, out_span[d][1] * k
            outs = None
            for _ in range(sweeps // k):
                if outs is None:
                    cur = arrays
                else:
                    cur = {n: arrays[n] for n in program.input_names}
                    cur[in_name] = outs[out_names[0]]
                ext = {n: halo_exchange(x, d, lo, hi, ax)
                       for n, x in cur.items()}
                res = run_level(ext, level + 1, k, params)
                outs = {n: (_slice_dim(res[n], lo,
                                       res[n].shape[d] - hi, d)
                            if lo or hi else res[n])
                        for n in out_names}
                # each level re-zeros its own dim's pad rows before its
                # next exchange (outs are shard-sized along d here; the
                # extension along outer dims does not shift d's indexing)
                outs = _mask_pad_dim(outs, d)
            return outs

        def local_fn_nested(inputs: dict, params: dict) -> dict:
            return run_level(_local_cast(inputs), 0, it, params)

        local_fn = local_fn_nested

    if not wide:
        sharded = jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=({n: tspec for n in program.input_names}, params_spec),
            out_specs={n: tspec for n in out_names},
            check_vma=False,
        )
        if not pad_dims:
            return sharded

        def sharded_padded(inputs: dict, params: dict) -> dict:
            # zero-pad each sharded dim up to a mesh-axis multiple (zeros
            # = the out-of-grid tap value), run, slice back to the real
            # grid.  Jit-compatible: pads are static.
            pin = {}
            for n2 in program.input_names:
                v = jnp.asarray(inputs[n2])
                pw = [(0, 0)] * program.rank
                for d in pad_dims:
                    pw[d] = (0, padded_shape[d] - v.shape[d])
                pin[n2] = jnp.pad(v, pw)
            outs = sharded(pin, params)
            res = {}
            for n2 in out_names:
                x = outs[n2]
                for d, (_ax, real, _s) in pad_dims.items():
                    x = jax.lax.slice_in_dim(x, 0, real, axis=d)
                res[n2] = x
            return res

        return sharded_padded

    # ---- 64-bit plane boundary: wide tensors cross shard_map as two
    # 32-bit plane arrays (n//lo, n//hi); the local fn wraps them into
    # pair carriers and unwraps its outputs ---------------------------
    def _keys(n):
        return ((n + "//lo", n + "//hi")
                if wide64.is_wide(program.tensors[n].type) else (n,))

    def _pkeys(n):
        return ((n + "//lo", n + "//hi")
                if wide64.is_wide(program.params[n].type) else (n,))

    inner_fn = local_fn

    def local_fn_planes(pinputs: dict, params: dict) -> dict:
        vals = {}
        for n in program.input_names:
            t = program.tensors[n].type
            if wide64.is_wide(t):
                vals[n] = wide64.wrap_planes(
                    t, pinputs[n + "//lo"], pinputs[n + "//hi"], jnp)
            else:
                vals[n] = pinputs[n]
        # 64-bit params cross as plane pairs too (jnp.asarray would have
        # silently truncated them to 32 bits)
        pr = {}
        for n in program.params:
            t = program.params[n].type
            if wide64.is_wide(t):
                pr[n] = wide64.wrap_planes(
                    t, params[n + "//lo"], params[n + "//hi"], jnp)
            else:
                pr[n] = params[n]
        outs = inner_fn(vals, pr)
        pouts = {}
        for n in out_names:
            t = program.tensors[n].type
            if wide64.is_wide(t):
                lo, hi = wide64.unwrap_planes(
                    t, outs[n].astype(t.np_dtype()))
                pouts[n + "//lo"], pouts[n + "//hi"] = lo, hi
            else:
                pouts[n] = outs[n]
        return pouts

    in_keys = [k for n in program.input_names for k in _keys(n)]
    out_keys = [k for n in out_names for k in _keys(n)]
    pkeys = [k for n in program.params for k in _pkeys(n)]
    sharded_planes = jax.jit(jax.shard_map(
        local_fn_planes,
        mesh=mesh,
        in_specs=({k: tspec for k in in_keys}, {k: P() for k in pkeys}),
        out_specs={k: tspec for k in out_keys},
        check_vma=False,
    ))

    def sharded_wide(inputs: dict, params: dict) -> dict:
        import numpy as np

        def _pad(a: "np.ndarray") -> "np.ndarray":
            if not pad_dims:
                return a
            pw = [(0, 0)] * program.rank
            for d in pad_dims:
                pw[d] = (0, padded_shape[d] - a.shape[d])
            return np.pad(a, pw)

        pin = {}
        for n in program.input_names:
            t = program.tensors[n].type
            if wide64.is_wide(t):
                lo, hi = wide64.split_planes(
                    _pad(np.asarray(inputs[n]).astype(t.np_dtype())))
                pin[n + "//lo"] = jnp.asarray(lo)
                pin[n + "//hi"] = jnp.asarray(hi)
            else:
                pin[n] = jnp.asarray(_pad(np.asarray(inputs[n])))
        ppar = {}
        for n in program.params:
            t = program.params[n].type
            if wide64.is_wide(t):
                lo, hi = wide64.split_planes(
                    np.asarray(params[n]).astype(t.np_dtype()))
                ppar[n + "//lo"] = jnp.asarray(lo)
                ppar[n + "//hi"] = jnp.asarray(hi)
            else:
                ppar[n] = jnp.asarray(params[n])
        pouts = sharded_planes(pin, ppar)

        def _unpad(a):
            for d, (_ax, real, _s) in pad_dims.items():
                a = a[tuple(slice(None) if e != d else slice(0, real)
                            for e in range(program.rank))]
            return a

        res = {}
        for n in out_names:
            t = program.tensors[n].type
            if wide64.is_wide(t):
                res[n] = _unpad(wide64.merge_planes(
                    np.asarray(pouts[n + "//lo"]),
                    np.asarray(pouts[n + "//hi"]), t.np_dtype()))
            else:
                res[n] = _unpad(np.asarray(pouts[n]))
        return res

    return sharded_wide


def run_sharded(
    program: StencilProgram,
    inputs: Mapping[str, "jnp.ndarray"],
    params: Mapping[str, "jnp.ndarray"] | None = None,
    *,
    mesh: Mesh | None = None,
    axis_sizes: Sequence[int] | None = None,
    dims: Sequence[int] | None = None,
    iterate: int | None = None,
    sweeps_per_exchange: int | Mapping[str, int] | None = None,
    overlap: bool = False,
    jit: bool = True,
    link_classes: Mapping[str, str] | None = None,
    axis_names: Sequence[str] | None = None,
):
    """Convenience wrapper: shard inputs over a mesh, run, gather numpy."""
    import numpy as np

    xla_backend.check_io(program, inputs, params or {})
    if mesh is None:
        mesh = make_mesh(axis_sizes or [len(jax.devices())],
                         axis_names=axis_names)
    grid_shape = tuple(np.asarray(next(iter(inputs.values()))).shape)
    fn = build_sharded_fn(
        program, mesh, dims=dims, iterate=iterate,
        sweeps_per_exchange=sweeps_per_exchange, grid_shape=grid_shape,
        overlap=overlap, link_classes=link_classes)
    from ..interp.wide64 import program_is_wide

    if program_is_wide(program):
        # wide wrapper splits/merges 64-bit planes on the host (numpy) —
        # inputs AND params (jnp.asarray would truncate 64-bit params);
        # the inner plane-level shard_map is already jitted
        outs = fn({k: np.asarray(v) for k, v in inputs.items()},
                  {k: np.asarray(v) for k, v in (params or {}).items()})
    else:
        params = {k: jnp.asarray(v) for k, v in (params or {}).items()}
        if jit:
            fn = jax.jit(fn)
        outs = fn({k: jnp.asarray(v) for k, v in inputs.items()}, params)
    return xla_backend.finalize_outputs(program, outs)
