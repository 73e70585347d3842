#!/usr/bin/env python
"""Smoke test of the compiler's main path on the GPU, in one process.

    python chip_smoke.py               # one card: phases 1-5
    python chip_smoke.py --four-cards  # four cards: the mesh phase only

Phases (each prints its lines; any failure makes the exit code non-zero
and the result line is not printed):

1. device: the card line (`nvidia-smi` name, power limit) and what JAX
   reports; stops unless the platform is `gpu`.
2. corpus: every tests/soda/*.soda through `sodac --run` at small shapes,
   checked against the NumPy oracle.
3. at size: programs through `sodac --run` with every array >= 200 MB
   (4x the H100's 50 MB L2), oracle-checked.
4. host tiling: jacobi3d 1024^3 through `sodac --host-tile auto` under a
   1 GiB device budget, oracle-checked.
5. timing: the XLA path on jacobi3d 512^3 and 1024^3 and a 1 GiB device
   copy, warm, with `block_until_ready`, beside the card line.

--four-cards runs jacobi3d 1024^3, iterate 4, through `sodac --mesh 4`
and `--mesh 2,2` (oracle-checked), and compares each with the one-card
run of the same input: bit-exact at exchange-every-sweep.

Oracle tolerances (utils/testing.py, printed per output by sodac):
integers bit-exact; f32 1e-4 (XLA contracts multiply-adds to FMA and sums
in its own order; no program has a matrix product, so TF32 never
arises); f32 with libm transcendentals 2e-3; all-f64 programs 1e-10;
programs with half 2e-2.

The last line of standard output is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

import argparse
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from soda_tpu.cli import sodac  # noqa: E402
from soda_tpu.utils import timing  # noqa: E402
from soda_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

SODA = HERE / "tests" / "soda"
SMALL = {1: (2048,), 2: (48, 128), 3: (24, 32, 128)}

# (program, grid) — every array >= 200 MB
AT_SIZE = [
    ("jacobi3d", (512, 512, 512)),
    ("jacobi3d", (1024, 1024, 1024)),
    ("jacobi2d", (8192, 8192)),          # iterate 8 from the DSL
    ("denoise3d", (512, 512, 512)),      # 3 stages
    ("poisson_f64", (8192, 8192)),
    ("accum64", (8192, 8192)),
    ("smooth_half", (16384, 16384)),
]
HOST_TILE = ("jacobi3d", (1024, 1024, 1024), 1 << 30)
TIMED = (512, 1024)
COPY_BYTES = 1 << 30
MESH = ("jacobi3d", (1024, 1024, 1024), 4)

# the same phases at sizes the CPU runs in seconds (tests/test_chip_smoke.py)
TINY = dict(
    at_size=[("jacobi3d", (16, 24, 32)), ("jacobi2d", (64, 96)),
             ("denoise3d", (16, 24, 32)), ("poisson_f64", (64, 96)),
             ("accum64", (64, 96)), ("smooth_half", (64, 96))],
    host_tile=("jacobi3d", (24, 32, 40), 200_000),
    timed=(16, 24),
    copy_bytes=1 << 22,
    mesh=("jacobi3d", (16, 24, 32), 4),
)


def _shape(s) -> str:
    return ",".join(map(str, s))


def _sodac(argv, failures: list) -> None:
    print(f"$ sodac {' '.join(argv)}", flush=True)
    rc = sodac.main(argv)
    if rc != 0:
        failures.append(" ".join(argv))


def phase_device(platform: str):
    import jax

    print("card:", timing.card_line())
    devs = jax.devices()
    dev = devs[0]
    print(f"jax: platform={dev.platform} kind={dev.device_kind!r} "
          f"count={len(devs)}")
    if dev.platform != platform:
        raise SystemExit(f"platform {dev.platform!r}, need {platform!r}")
    return dev, len(devs)


def phase_corpus(failures: list) -> None:
    from soda_tpu.frontend.parser import parse_file

    print("--- corpus (small shapes) ---")
    for f in sorted(SODA.glob("*.soda")):
        rank = parse_file(f).rank
        _sodac([str(f), "--grid-shape", _shape(SMALL[rank]), "--run"],
               failures)


def phase_at_size(configs, failures: list) -> None:
    print("--- at size ---")
    for name, grid in configs:
        _sodac([str(SODA / f"{name}.soda"), "--grid-shape", _shape(grid),
                "--run"], failures)


def phase_host_tile(cfg, failures: list) -> None:
    name, grid, budget = cfg
    print("--- host tiling ---")
    _sodac([str(SODA / f"{name}.soda"), "--grid-shape", _shape(grid),
            "--host-tile", "auto", "--hbm-budget", str(budget), "--run",
            "--report"], failures)


def phase_timing(sizes, copy_bytes: int) -> None:
    from soda_tpu.frontend.parser import parse_file

    card = timing.card_line()
    print(f"--- timing [{card}] ---")
    program = parse_file(SODA / "jacobi3d.soda")
    for i, n in enumerate(sizes):
        r = timing.time_program(program, (n, n, n))
        if i == 0:
            print(f"memory analysis (xla jacobi3d {n}^3): "
                  f"{r['compiled'].memory_analysis()}")
        print(f"xla jacobi3d {n}^3: {r['seconds'] * 1e3:.4f} ms/call, "
              f"{r['gcell_updates_per_s']:.2f} GCell-updates/s, "
              f"{r['ideal_gb_per_s']:.1f} GB/s of ideal traffic, compile "
              f"{r['compile_s']:.2f}s [{card}]")
    copy = timing.copy_bytes_per_s(copy_bytes)
    print(f"copy x*2 over {copy_bytes >> 20} MiB: {copy / 1e9:.1f} GB/s "
          f"[{card}]")


def phase_four_cards(cfg, failures: list) -> None:
    import numpy as np

    from soda_tpu.backend import xla
    from soda_tpu.frontend.parser import parse_file
    from soda_tpu.parallel.mesh import run_sharded

    name, grid, it = cfg
    path = str(SODA / f"{name}.soda")
    print("--- four cards: mesh vs one card ---")
    for mesh in ("4", "2,2"):
        _sodac([path, "--grid-shape", _shape(grid), "--iterate", str(it),
                "--mesh", mesh, "--sweeps-per-exchange", "1", "--run"],
               failures)
    program = parse_file(path, overrides={"iterate": it})
    ins, ps = sodac._random_inputs(program, grid, 0)
    one = xla.run(program, ins, ps)
    for sizes in ((4,), (2, 2)):
        got = run_sharded(program, ins, ps, axis_sizes=sizes,
                          dims=list(range(len(sizes))),
                          sweeps_per_exchange=1)
        for k in one:
            same = np.array_equal(got[k], one[k])
            d = np.abs(got[k].astype(np.float64)
                       - one[k].astype(np.float64)).max()
            print(f"mesh {sizes} vs one card, {k}: "
                  f"{'bit-exact' if same else 'DIFFERS'} (max |diff| {d})")
            if not same:
                failures.append(f"mesh {sizes} vs one card")


def main(argv=None, *, tiny: bool = False, platform: str = "gpu") -> int:
    """`tiny`/`platform` exist for the CPU rehearsal in the test suite;
    the command line always runs the full sizes on the GPU."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    enable_compile_cache()
    dev, count = phase_device(platform)
    failures: list[str] = []
    if args.four_cards:
        if count < 4:
            raise SystemExit(f"--four-cards needs 4 devices, have {count}")
        phase_four_cards(TINY["mesh"] if tiny else MESH, failures)
    else:
        phase_corpus(failures)
        phase_at_size(TINY["at_size"] if tiny else AT_SIZE, failures)
        phase_host_tile(TINY["host_tile"] if tiny else HOST_TILE, failures)
        phase_timing(TINY["timed"] if tiny else TIMED,
                     TINY["copy_bytes"] if tiny else COPY_BYTES)
    if failures:
        print("FAILED:", *failures, sep="\n  ")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
