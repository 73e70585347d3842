#!/usr/bin/env python
"""Headline benchmark: jacobi-3d 512^3, one sweep, on one GPU.

Runs the main path (`sodac`'s XLA backend) compiled, times it warm with
`block_until_ready`, and measures a 1 GiB device copy in the same process
as the bandwidth yardstick.  Prints the card line (name, power limit) and
ONE JSON line that names the device.  Exits non-zero without a GPU.

    python bench.py
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

N = 512


def main() -> int:
    from soda_tpu.utils.compile_cache import enable_compile_cache
    from soda_tpu.utils.timing import (card_line, copy_bytes_per_s,
                                       require_gpu, time_program)

    enable_compile_cache()
    dev = require_gpu()
    import jax

    from soda_tpu.frontend.parser import parse_file

    here = pathlib.Path(__file__).resolve().parent
    program = parse_file(here / "tests" / "soda" / "jacobi3d.soda")
    res = time_program(program, (N, N, N))
    copy = copy_bytes_per_s()
    print(card_line())
    print(json.dumps({
        "metric": "jacobi3d_512cubed_single_sweep",
        "value": res["gcell_updates_per_s"],
        "unit": "GCell-updates/s",
        "ideal_gb_per_s": res["ideal_gb_per_s"],
        "copy_gb_per_s": copy / 1e9,
        "share_of_copy": res["ideal_gb_per_s"] / (copy / 1e9),
        "seconds_per_call": res["seconds"],
        "compile_s": res["compile_s"],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
