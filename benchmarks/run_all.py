#!/usr/bin/env python
"""Time the corpus at production sizes on one GPU.

Prints the card line, then per program: grid, iterate, compile seconds,
ms per call, GCell-updates/s and GB/s of ideal traffic (utils/report.py),
all through the main path (`sodac`'s XLA backend), warm, with
`block_until_ready`.  Exits non-zero without a GPU.

    python benchmarks/run_all.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

CONFIGS = [
    # (program, grid shape, iterate override or None)
    ("blur", (2048, 4096), None),
    ("sobel2d", (2048, 4096), None),
    ("denoise2d", (2048, 4096), None),
    ("gaussian2d", (2048, 4096), None),
    ("laplace2d", (2048, 4096), None),
    ("erode2d", (2048, 4096), None),
    ("conv5x5", (2048, 4096), None),
    ("jacobi2d", (2048, 2048), None),          # iterate 8 from the DSL
    ("seidel2d", (2048, 2048), None),          # iterate 4
    ("jacobi3d", (512, 512, 512), None),       # headline single sweep
    ("jacobi3d", (1024, 1024, 1024), None),    # 4 GiB arrays
    ("jacobi3d", (512, 512, 512), 8),
    ("heat3d", (256, 256, 256), None),         # iterate 4
    ("denoise3d", (256, 256, 256), None),
    ("gradmag3d", (256, 256, 512), None),
    ("smooth_half", (4096, 4096), None),
    ("accum64", (2048, 2048), None),
    ("poisson_f64", (2048, 2048), None),
    ("poisson3d_f64", (256, 256, 256), None),
    ("reaction_f64", (2048, 2048), None),
]


def main() -> int:
    from soda_tpu.utils.compile_cache import enable_compile_cache
    from soda_tpu.utils.timing import card_line, require_gpu, time_program

    enable_compile_cache()
    dev = require_gpu()
    from soda_tpu.frontend.parser import parse_file

    here = pathlib.Path(__file__).resolve().parents[1] / "tests" / "soda"
    print(card_line())
    print(f"device: {dev.platform} {dev.device_kind!r}")
    hdr = (f"{'program':<14} {'grid':<16} {'it':>3} {'compile s':>9} "
           f"{'ms/call':>9} {'GCell/s':>9} {'ideal GB/s':>10}")
    print(hdr)
    print("-" * len(hdr))
    for name, shape, it in CONFIGS:
        program = parse_file(here / f"{name}.soda",
                             overrides={"iterate": it} if it else None)
        r = time_program(program, shape)
        print(f"{name:<14} {'x'.join(map(str, shape)):<16} "
              f"{max(program.iterate, 1):>3} {r['compile_s']:>9.2f} "
              f"{r['seconds'] * 1e3:>9.3f} {r['gcell_updates_per_s']:>9.2f} "
              f"{r['ideal_gb_per_s']:>10.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
