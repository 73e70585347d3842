"""`sodac` — the CLI driver.

Keeps the reference's CLI shape (src/sodac per SURVEY.md §2.1 L1,
reconstructed — empty mount): positional `.soda` file, DSL-overriding knob
flags (--unroll-factor/--tile-size/--iterate/--burst-width/--dram-in/--dram-out,
CLI beats DSL), artifact-target flags.  The Xilinx artifact targets are
replaced by:

  --cpp-golden FILE     emit the native C++ golden runner source (the
                        reference's generated-host golden model, standalone)
  --report              print the compile report (program-derived traffic,
                        ops, halo creep and compile wall-clock)
  --run                 execute on random input, verify vs the NumPy oracle
  --benchmark           time the compiled program on the device

Execution runs the XLA backend (backend/xla.py), alone, over host tiles
(--host-tile) or sharded over a device mesh (--mesh).
"""

from __future__ import annotations

import argparse
import logging
import math
import sys
import time

import numpy as np

logger = logging.getLogger("soda_tpu")


def _parse_int_list(s: str) -> tuple[int, ...]:
    return tuple(int(x) for x in s.replace("x", ",").split(",") if x)


def _parse_mesh(s: str):
    """'2,4' (or legacy '2x4') or 'dcn:2,x:4' -> (sizes, names,
    link_classes).

    An axis named dcn* is classed as a slow link between hosts (its cost
    must come from --link-model); all others ride NVLink.  Unnamed axes
    get ax0, ax1, ...  The legacy 'x' separator applies only to the
    UNNAMED form ('x' is a legitimate axis name in the named form)."""
    if ":" not in s:
        s = s.replace("x", ",")
    sizes, names = [], []
    for i, part in enumerate(p for p in s.split(",") if p):
        if ":" in part:
            name, sz = part.split(":", 1)
        else:
            name, sz = f"ax{i}", part
        names.append(name)
        sizes.append(int(sz))
    links = {n: ("dcn" if n.startswith("dcn") else "nvlink") for n in names}
    return tuple(sizes), tuple(names), links


def _parse_cadence(s: str | None, axis_names):
    """'4' (uniform) or '4,2' (per mesh axis) -> int | dict | None."""
    if s is None:
        return None
    ks = [int(x) for x in s.split(",") if x]
    if len(ks) == 1:
        return ks[0]
    if len(ks) != len(axis_names):
        raise SystemExit(
            f"--sweeps-per-exchange: {len(ks)} values for "
            f"{len(axis_names)} mesh axes")
    return dict(zip(axis_names, ks))


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sodac",
        description="soda_tpu: stencil compiler for the .soda DSL, "
                    "lowered to JAX/XLA",
    )
    ap.add_argument("soda_src", help="input .soda file")
    # DSL-overriding knobs (reference-compatible; CLI beats DSL)
    ap.add_argument("--unroll-factor", type=int, default=None,
                    help="accepted for compatibility; vectorization is "
                         "XLA's")
    ap.add_argument("--tile-size", type=_parse_int_list, default=None,
                    help="override input tile size, e.g. 512,512")
    ap.add_argument("--iterate", type=int, default=None)
    ap.add_argument("--burst-width", type=int, default=None,
                    help="accepted for compatibility; memory transfers "
                         "are XLA's")
    ap.add_argument("--dram-in", type=str, default=None)
    ap.add_argument("--dram-out", type=str, default=None)
    ap.add_argument("--border", type=str, default=None, choices=["ignore"])
    ap.add_argument("--cluster", type=str, default=None, choices=["none"])
    # grid / execution
    ap.add_argument("--grid-shape", type=_parse_int_list, default=None,
                    help="concrete extents for '*' dims, e.g. 512,512,512")
    ap.add_argument("--backend", choices=["xla", "numpy"], default="xla",
                    help="xla: the compiled path (default); numpy: the "
                         "oracle interpreter alone")
    ap.add_argument("--mesh", type=str, default=None,
                    help="shard over a device mesh: sizes ('2,2') or named "
                         "axes ('dcn:2,x:4' — an axis named dcn* is a slow "
                         "link between hosts, whose cost --link-model must "
                         "give; its halo is exchanged less often)")
    ap.add_argument("--sweeps-per-exchange", type=str, default=None,
                    metavar="K[,K...]",
                    help="halo-exchange cadence for --mesh: one value, or "
                         "one per mesh axis (each must divide iterate and "
                         "form a divisor chain); default: modeled auto")
    ap.add_argument("--mesh-overlap", action="store_true",
                    help="overlap the halo exchange with interior compute "
                         "under --mesh (identical results; see "
                         "parallel/mesh.py)")
    ap.add_argument("--link-model", type=str, default=None,
                    metavar="CLASS=GBPS:LAT[,...]",
                    help="link costs driving the mesh's auto cadence, e.g. "
                         "'nvlink=400:8e-6,dcn=25:1e-4'; nvlink defaults to "
                         "the device table, dcn has no default")
    ap.add_argument("--host-tile", type=str, default=None,
                    metavar="T0,T1,...|auto",
                    help="run grids larger than device memory on ONE "
                         "device by looping overlapping tiles through the "
                         "XLA path (the reference host's sequential "
                         "tiling); 'auto' picks tiles fitting "
                         "--hbm-budget. 0 = full extent along a dim")
    ap.add_argument("--host-tile-sweeps", type=str, default=None,
                    metavar="K|auto",
                    help="sweeps per host-tiling pass (must divide "
                         "iterate; default: all in one pass). K=1 is "
                         "bit-exact vs the oracle on the whole grid; "
                         "deeper K deviates only in the border-invalid "
                         "rim, like --sweeps-per-exchange. 'auto' picks "
                         "the K minimizing modeled streamed traffic "
                         "(passes x halo-extended tile reads)")
    ap.add_argument("--hbm-budget", type=int, default=None,
                    help="device memory budget (bytes) for --host-tile "
                         "auto; default: the device's reported limit less "
                         "a quarter for XLA's temporaries "
                         "(utils/device.py). Required where the device "
                         "reports none (CPU)")
    ap.add_argument("--unroll-iterate", type=int, nargs="?", const=0,
                    default=None, metavar="N",
                    help="unroll N temporal sweeps into chained stage "
                         "copies (the reference's iterate implementation); "
                         "no N = unroll fully. Enables exact shrinking "
                         "extents for iterate programs")
    ap.add_argument("--tcse", action="store_true",
                    help="computation-reuse rewrite (DAC'20 tcse analog): "
                         "hoist shifted repeated partial sums into stages; "
                         "reassociates float sums and widens the "
                         "border-invalid rim")
    # artifact targets
    ap.add_argument("--cpp-golden", type=str, default=None, metavar="FILE")
    # reference-compatible artifact spellings: emit the C++ golden pair so
    # flows that expected --xocl-* outputs still get compilable C++
    ap.add_argument("--xocl-kernel", type=str, default=None, metavar="FILE")
    ap.add_argument("--xocl-host", type=str, default=None, metavar="FILE")
    ap.add_argument("--xocl-header", type=str, default=None, metavar="FILE")
    ap.add_argument("--profile", type=str, default=None, metavar="DIR",
                    help="write a jax.profiler trace of --run/--benchmark")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--run", action="store_true")
    ap.add_argument("--benchmark", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-v", "--verbose", action="count", default=0)
    return ap


def _overrides(args) -> dict:
    ov = {}
    for k in ("unroll_factor", "iterate", "burst_width", "border", "cluster"):
        v = getattr(args, k)
        if v is not None:
            ov[k] = v
    if args.tile_size is not None:
        ov["tile_size"] = args.tile_size
    if args.dram_in is not None:
        ov["dram_in"] = _parse_int_list(args.dram_in)
    if args.dram_out is not None:
        ov["dram_out"] = _parse_int_list(args.dram_out)
    return ov


def _hbm_budget(args) -> int:
    from ..utils.device import hbm_budget

    budget = args.hbm_budget or hbm_budget()
    if budget is None:
        raise SystemExit(
            "--host-tile auto needs --hbm-budget: the device reports no "
            "memory limit")
    return budget


def _host_tiles(program, grid_shape, args) -> tuple[int, ...]:
    from ..parallel.host_tile import choose_host_tiles, normalize_tiles
    if args.host_tile == "auto":
        # under --mesh each tile runs sharded, so the budget is per
        # DEVICE: size tiles to the per-shard footprint (mesh-size× larger)
        mesh_shape = _parse_mesh(args.mesh)[0] if args.mesh else None
        tiles = choose_host_tiles(program, grid_shape, _hbm_budget(args),
                                  args.host_tile_sweeps,
                                  mesh_shape=mesh_shape)
        logger.info("--host-tile auto -> %s", "x".join(map(str, tiles)))
        return tiles
    return normalize_tiles(grid_shape, _parse_int_list(args.host_tile))


def _grid_shape(program, args) -> tuple[int, ...]:
    if args.grid_shape is not None:
        if len(args.grid_shape) != program.rank:
            raise SystemExit(
                f"--grid-shape rank {len(args.grid_shape)} != program rank "
                f"{program.rank}")
        return args.grid_shape
    # derive from the input tile size; '*' dims default to 512
    t = program.tensors[program.input_names[0]]
    return tuple(512 if d is None else d for d in (t.tile_size or ()))


def _random_inputs(program, grid_shape, seed):
    rng = np.random.default_rng(seed)
    ins = {}
    for n in program.input_names:
        t = program.tensors[n].type
        if t.is_float:
            ins[n] = rng.standard_normal(grid_shape).astype(t.np_dtype())
        elif t.kind == "int":
            # signed types draw negatives too, so verification exercises
            # sign-dependent C semantics (/, %, >>) — ADVICE r1.  64-bit
            # types draw ABOVE the 32-bit range so the pair-carrier path
            # is actually exercised past int32
            hi = 1 << (40 if t.width > 32 else min(t.width - 1, 14))
            ins[n] = rng.integers(-hi, hi, grid_shape).astype(t.np_dtype())
        else:
            hi = ((1 << 40) if t.width > 32
                  else min(1 << min(t.width, 16), 1 << 15))
            ins[n] = rng.integers(0, hi, grid_shape).astype(t.np_dtype())
    ps = {p.name: rng.standard_normal(p.shape).astype(p.type.np_dtype())
          for p in program.params.values()}
    return ins, ps


def _verify(program, outs, gold, grid_shape) -> bool:
    """Oracle check with the gates of utils/testing.py: integers bit-exact,
    floats at the program's tolerance, the border-invalid rim excluded.
    Prints one line per output with its rule and max |diff|."""
    from ..utils.testing import interior, output_tolerance

    rim = program.valid_rim()
    ok = True
    for k in gold:
        a, b = interior(np.asarray(outs[k]), rim), interior(gold[k], rim)
        if a.size == 0:
            # np.allclose on empty arrays is vacuously True — refuse to
            # claim PASS without comparing anything
            raise SystemExit(
                f"grid too small to verify: valid rim {rim} leaves "
                f"no interior for output {k!r} on {grid_shape}")
        tol = output_tolerance(program, k)
        if tol is None:
            good = np.array_equal(a, b)
            rule = f"bit-exact, {np.count_nonzero(a != b)} cells differ"
        else:
            a, b = a.astype(np.float64), b.astype(np.float64)
            good = np.allclose(a, b, rtol=tol, atol=tol)
            rule = f"rtol=atol={tol:g}, max |diff| {np.abs(a - b).max()}"
        print(f"  {k}: {rule}: {'ok' if good else 'MISMATCH'}")
        ok = ok and good
    print("verification vs NumPy oracle:", "PASS" if ok else "FAIL")
    return ok


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose >= 2 else
        logging.INFO if args.verbose == 1 else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s")

    from ..frontend.parser import parse_file
    from ..utils.compile_cache import enable_compile_cache
    from ..utils.report import analyze, compile_seconds

    enable_compile_cache()
    if args.link_model:
        from ..parallel.mesh import set_link_model
        set_link_model(args.link_model)

    program = parse_file(args.soda_src, overrides=_overrides(args))
    updates_per_cell = 1
    if args.unroll_iterate is not None:
        from ..optimize.unroll import unroll_iterate
        factor = args.unroll_iterate or max(program.iterate, 1)
        if program.iterate <= 1 or factor <= 1:
            logger.warning("--unroll-iterate has no effect: iterate=%d",
                           program.iterate)
            factor = 1
        if factor >= 8:
            logger.warning(
                "unroll factor %d creates a %d-deep stage chain; compile "
                "time grows with it", factor,
                factor * len(program.stage_order()))
        program = unroll_iterate(program, factor)
        updates_per_cell = factor
    if args.tcse:
        from ..optimize import tcse
        before = tcse.count_adds(program)
        program = tcse.apply(program)
        logger.info("tcse: %d adds -> %d", before, tcse.count_adds(program))
    logger.info("parsed program:\n%s", program.describe())
    grid_shape = _grid_shape(program, args)

    host_tiling = None
    if args.host_tile:
        # resolve --host-tile-sweeps before anything consumes it as an int
        if args.host_tile_sweeps == "auto":
            from ..parallel.host_tile import (choose_sweeps_per_pass,
                                              normalize_tiles)
            mesh_shape = _parse_mesh(args.mesh)[0] if args.mesh else None
            tiles_arg = (None if args.host_tile == "auto" else
                         normalize_tiles(grid_shape,
                                         _parse_int_list(args.host_tile)))
            nf, ts = choose_sweeps_per_pass(
                program, grid_shape, tiles_arg,
                _hbm_budget(args) if tiles_arg is None else None,
                mesh_shape=mesh_shape)
            args.host_tile_sweeps = nf
            if args.host_tile == "auto":
                # keep the jointly-chosen tiles (scored WITH this nf)
                args.host_tile = ",".join(map(str, ts))
        elif args.host_tile_sweeps is not None:
            args.host_tile_sweeps = int(args.host_tile_sweeps)
        from ..parallel.host_tile import plan_host_tiling
        host_tiling = plan_host_tiling(
            program, grid_shape, _host_tiles(program, grid_shape, args),
            args.host_tile_sweeps)
    elif not args.mesh and args.backend == "xla":
        # whole-grid footprint sanity: inputs + outputs + a working copy
        # vs the device budget — a grid that cannot fit should point at
        # the host-tiling path instead of failing for memory at run time
        from ..utils.device import hbm_budget
        budget = args.hbm_budget or hbm_budget()
        foot = 2 * math.prod(grid_shape) * sum(
            program.tensors[n].type.tpu_storage_bytes
            for n in program.input_names + program.output_names)
        if budget is not None and foot > budget:
            logger.warning(
                "grid %s needs ~%.1f GiB of device memory (budget %.1f "
                "GiB): a single-device run will likely fail — use "
                "--host-tile auto (sequential overlapping tiles) or --mesh",
                grid_shape, foot / 2**30, budget / 2**30)

    did_something = False

    if args.report:
        did_something = True
        # host tiling compiles the PER-TILE program at the halo-extended
        # tile shape and pass depth — that is what runs
        shape, nf = grid_shape, None
        if host_tiling is not None:
            shape, nf = host_tiling[2], host_tiling[4]
        csec = (compile_seconds(program, shape, nf)
                if args.backend == "xla" and not args.mesh else None)
        rep = analyze(program, grid_shape, updates_per_cell, csec)
        print(rep.pretty())
        # flag-compat honesty: knobs accepted for reference-CLI parity that
        # have no behavioral meaning here (XLA subsumes them)
        inert = []
        if program.unroll_factor > 1:
            inert.append(f"unroll factor {program.unroll_factor} "
                         "(vectorization is XLA's)")
        if program.burst_width:
            inert.append(f"burst width {program.burst_width} "
                         "(memory transfers are XLA's)")
        if any(t.dram != (1,) for t in program.tensors.values()):
            inert.append("dram channel lists (one device memory)")
        if program.cluster and program.cluster != "none":
            inert.append(f"cluster {program.cluster}")
        for line in inert:
            print(f"  accepted-inert: {line}")
        if host_tiling is not None:
            tiles, halos, ext, nt, nf, passes, ov = host_tiling
            print(f"  host tiling: {'x'.join(map(str, nt))} tiles of "
                  f"{'x'.join(map(str, tiles))} (+halo -> "
                  f"{'x'.join(map(str, ext))}), {passes} pass(es) x {nf} "
                  f"sweep(s); read amplification {ov:.3f}x per pass "
                  f"(halo recompute, as in the reference host); effective "
                  f"ideal {rep.ideal_bytes_per_cell_update * ov:.3f} "
                  f"B/cell-update = ideal x amplification")
            if args.mesh:
                from ..parallel.host_tile import model_mesh_exchange
                sizes, _names, _links = _parse_mesh(args.mesh)
                xbytes, shard = model_mesh_exchange(
                    program, ext, sizes, None, nf)
                per_dev = math.prod(ext) * sum(
                    program.tensors[n].type.tpu_storage_bytes
                    for n in program.input_names) / math.prod(sizes)
                xh = (f"{xbytes / 2**20:.1f} MiB" if xbytes >= 2**20
                      else f"{xbytes / 2**10:.1f} KiB")
                print(f"  mesh per tile: shards of "
                      f"{'x'.join(map(str, shard))} over "
                      f"{'x'.join(map(str, sizes))} devices; modeled "
                      f"halo exchange {xh}/device/pass "
                      f"({xbytes / max(per_dev, 1) * 100:.2f}% of the "
                      f"shard's state bytes; cadence-invariant total — "
                      f"see parallel/host_tile.model_mesh_exchange)")

    if args.cpp_golden or args.xocl_kernel or args.xocl_host:
        did_something = True
        from ..backend import cpp
        src = cpp.generate(program, grid_shape)
        for path, banner in ((args.cpp_golden, None),
                             (args.xocl_kernel,
                              "// --xocl-kernel compatibility artifact: this\n"
                              "// compiler has no HLS kernel; this is the golden\n"
                              "// loop nest with identical semantics.\n"),
                             (args.xocl_host, None)):
            if path:
                with open(path, "w") as f:
                    if banner:
                        f.write(banner)
                    f.write(src)
                print(f"wrote C++ golden runner: {path}")

    if args.xocl_header:
        did_something = True
        lines = [f"// generated by soda_tpu for kernel `{program.name}`",
                 "#pragma once"]
        for d, n in enumerate(grid_shape):
            lines.append(f"#define SODA_DIM_{d} {n}")
        lines.append(f"#define SODA_ITERATE {max(program.iterate, 1)}")
        lines.append(f"#define SODA_VALID_RIM {program.valid_rim()}")
        with open(args.xocl_header, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote header: {args.xocl_header}")

    if args.run or args.benchmark:
        did_something = True
        if args.benchmark and (args.mesh or args.host_tile
                               or args.backend == "numpy"):
            # reject from argv BEFORE the (possibly hours-long) run
            raise SystemExit(
                "--benchmark times the single-device xla backend (got "
                f"{'mesh' if args.mesh else 'host-tile' if args.host_tile else args.backend})")
        ins, ps = _random_inputs(program, grid_shape, args.seed)
        from ..interp import numpy_interp

        profile_ctx = None
        if args.profile:
            import jax
            profile_ctx = jax.profiler.trace(args.profile)
            profile_ctx.__enter__()

        t0 = time.perf_counter()
        if args.host_tile:
            from ..parallel.host_tile import run_host_tiled
            mesh_kw = {}
            if args.mesh:
                # host tiles x mesh shards: each tile runs sharded over
                # the mesh (grids larger than all devices' memory)
                from ..parallel.mesh import make_mesh
                sizes, names, links = _parse_mesh(args.mesh)
                mesh_kw = dict(
                    mesh=make_mesh(sizes, names), link_classes=links,
                    sweeps_per_exchange=_parse_cadence(
                        args.sweeps_per_exchange, names),
                    overlap=args.mesh_overlap)
            outs = run_host_tiled(
                program, ins, ps, tiles=_host_tiles(program, grid_shape, args),
                sweeps_per_pass=args.host_tile_sweeps, **mesh_kw)
        elif args.mesh:
            from ..parallel.mesh import run_sharded
            sizes, names, links = _parse_mesh(args.mesh)
            spe = _parse_cadence(args.sweeps_per_exchange, names)
            outs = run_sharded(program, ins, ps, axis_sizes=sizes,
                               axis_names=names, link_classes=links,
                               sweeps_per_exchange=spe,
                               overlap=args.mesh_overlap)
        elif args.backend == "xla":
            from ..backend import xla as xb
            outs = xb.run(program, ins, ps)
        else:
            outs = numpy_interp.run(program, ins, ps)
        wall = time.perf_counter() - t0
        print(f"executed {program.name} on {grid_shape} "
              f"({args.backend}{' mesh' if args.mesh else ''}"
              f"{' host-tiled' if args.host_tile else ''}): {wall:.3f}s "
              f"(incl. compile)")

        if args.run and args.backend != "numpy":
            gold = numpy_interp.run(program, ins, ps)
            if not _verify(program, outs, gold, grid_shape):
                return 1

        if args.benchmark:
            _benchmark(program, grid_shape, ins, ps, updates_per_cell)

        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)
            print(f"profiler trace written to {args.profile}")

    if not did_something:
        print(analyze(program, grid_shape, updates_per_cell).pretty())
    return 0


def _benchmark(program, grid_shape, ins, ps, updates_per_cell) -> None:
    """Time the compiled XLA program (warm, block_until_ready) and name
    the device it ran on."""
    import jax

    from ..utils.report import xla_bytes_per_update
    from ..utils.timing import time_program

    r = time_program(program, grid_shape, ins, ps, updates_per_cell)
    dev = jax.devices()[0]
    print(f"benchmark (xla on {dev.platform} {dev.device_kind!r}, "
          f"{len(jax.devices())} device(s)): {r['seconds']*1e3:.3f} ms/call, "
          f"{r['gcell_updates_per_s']:.2f} GCell-updates/s, "
          f"{r['ideal_gb_per_s']:.1f} GB/s of ideal traffic; compile "
          f"{r['compile_s']:.2f}s")
    xbpc = xla_bytes_per_update(r["compiled"], r["updates"])
    if xbpc is not None:
        print(f"xla cost model: {xbpc:.3f} B/update")


if __name__ == "__main__":
    sys.exit(main())
