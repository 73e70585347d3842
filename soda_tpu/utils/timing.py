"""Device timing shared by `bench.py`, `benchmarks/run_all.py` and
`chip_smoke.py`: the GPU gate, the card line, warm `block_until_ready`
timing of a compiled program, and a device copy as the bandwidth yardstick.

Every measurement path fails without a GPU; none falls back to the CPU.
"""

from __future__ import annotations

import math
import shutil
import subprocess
import time


def require_gpu():
    """The first JAX device, or SystemExit when JAX found no GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind!r}); this measures the card only")
    return dev


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit`, one line per card: the
    card's name and power limit go beside every number kept."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi: not found"
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def time_call(fn, *args, reps: int = 5) -> float:
    """Seconds per call of an already-compiled `fn`, warm: one untimed
    call, then `reps` calls inside one `block_until_ready`."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def copy_bytes_per_s(nbytes: int = 2**30, reps: int = 10) -> float:
    """Achieved device-memory bandwidth of `x * 2` over an f32 array of
    `nbytes` (read once + written once: 2 * nbytes moved).  An
    elementwise op XLA cannot elide — the yardstick a stencil's rate is
    compared with in the same call."""
    import jax
    import jax.numpy as jnp

    n = nbytes // 4
    x = jnp.ones((n,), jnp.float32)
    f = jax.jit(lambda a: a * 2).lower(x).compile()
    dt = time_call(f, x, reps=reps)
    del x
    return 2 * nbytes / dt


def time_program(program, grid_shape, inputs=None, params=None,
                 updates_per_cell: int = 1, reps: int = 5) -> dict:
    """Compile `program` on the XLA path at `grid_shape` and time it warm,
    on `inputs`/`params` (default: random, made on the host from seed 0).
    Returns compile seconds, seconds per call, GCell-updates/s, GB/s of
    ideal traffic (utils/report.py) and the compiled program."""
    import jax
    import numpy as np

    from ..backend.xla import Runner
    from .report import analyze
    from .testing import rand_inputs

    ins, ps = inputs, params
    if ins is None:
        ins, ps = rand_inputs(program, grid_shape, np.random.default_rng(0))
    runner = Runner(program)
    with runner.x64():
        args = jax.device_put(runner.device_args(ins, ps))
        del ins
        t0 = time.perf_counter()
        compiled = runner.fn.lower(*args).compile()
        csec = time.perf_counter() - t0
        dt = time_call(compiled, *args, reps=reps)
    # each sweep of an unroll_iterate'd program performs updates_per_cell
    # cell-updates
    updates = (math.prod(grid_shape) * max(program.iterate, 1)
               * updates_per_cell)
    rep = analyze(program, grid_shape, updates_per_cell)
    return {
        "compile_s": csec,
        "seconds": dt,
        "updates": updates,
        "gcell_updates_per_s": updates / dt / 1e9,
        "ideal_gb_per_s": rep.ideal_bytes_per_cell_update * updates / dt / 1e9,
        "compiled": compiled,
    }
