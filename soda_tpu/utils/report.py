"""Compile report: the analog of the reference's HLS report surface
(II/latency/resource from Vivado logs — SURVEY.md §5 'tracing' row).

Every quantity here is taken from the program itself, never from a device
model: the ideal device-memory traffic per cell-update in storage dtypes,
operations per cell (utils/opcount.py), halo creep and the border-invalid
rim, and — when measured — the compile wall-clock of the XLA path.

Ideal traffic: a sweep that keeps every intermediate on chip reads each
program input and writes each program output once, in their storage
dtypes (8 B/cell for an f32 stencil).  With `iterate` sweeps fused the
same bytes serve every sweep, so the per-UPDATE ideal is the per-sweep
ideal ÷ sweeps.  Measured rates are compared against these by the
benchmark, on the card.
"""

from __future__ import annotations

import dataclasses
import time

from ..ir.program import StencilProgram


@dataclasses.dataclass
class CompileReport:
    program: str
    grid_shape: tuple[int, ...]
    sweeps: int                          # cell-updates per cell per call
    ideal_bytes_per_cell_sweep: float
    ideal_bytes_per_cell_update: float
    ops_per_cell_update: float
    chain_creep: tuple[tuple[int, int], ...]
    valid_rim: int
    compile_seconds: float | None = None

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["grid_shape"] = list(self.grid_shape)
        d["chain_creep"] = [list(c) for c in self.chain_creep]
        return d

    def pretty(self) -> str:
        shape = "x".join(map(str, self.grid_shape))
        out = [f"=== soda_tpu compile report: {self.program} {shape} ===",
               f"  sweeps per call: {self.sweeps}",
               f"  ideal traffic: {self.ideal_bytes_per_cell_sweep:.3f} "
               f"B/cell per sweep (inputs read + outputs written once, "
               f"storage dtypes); {self.ideal_bytes_per_cell_update:.3f} "
               f"B/cell-update with all {self.sweeps} sweep(s) fused",
               f"  ops per cell-update: {self.ops_per_cell_update:.1f} "
               f"(weighted; utils/opcount.py)",
               f"  halo creep per sweep: "
               + " ".join(f"[{lo},{hi}]" for lo, hi in self.chain_creep)
               + f"; border-invalid rim {self.valid_rim}"]
        if self.compile_seconds is not None:
            out.append(f"  compile wall-clock: {self.compile_seconds:.2f}s")
        return "\n".join(out)


def analyze(program: StencilProgram, grid_shape, updates_per_cell: int = 1,
            compile_seconds: float | None = None) -> CompileReport:
    from .opcount import ops_per_cell

    sweeps = max(program.iterate, 1) * max(updates_per_cell, 1)
    per_sweep = float(sum(
        program.tensors[n].type.tpu_storage_bytes
        for n in program.input_names + program.output_names))
    return CompileReport(
        program=program.name,
        grid_shape=tuple(grid_shape),
        sweeps=sweeps,
        ideal_bytes_per_cell_sweep=per_sweep,
        ideal_bytes_per_cell_update=per_sweep / sweeps,
        ops_per_cell_update=ops_per_cell(program) / max(updates_per_cell, 1),
        chain_creep=tuple(program.chain_creep()),
        valid_rim=program.valid_rim(),
        compile_seconds=compile_seconds,
    )


def compile_seconds(program: StencilProgram, grid_shape,
                    iterate: int | None = None) -> float | None:
    """Wall-clock of lowering + compiling the XLA path at `grid_shape`
    (abstract inputs: no data is made).  None for >64-bit programs, whose
    quad-limb inputs are built from data."""
    import jax

    from ..backend.xla import Runner

    runner = Runner(program, iterate)
    if runner.w128:
        return None
    with runner.x64():
        ins = {n: jax.ShapeDtypeStruct(tuple(grid_shape),
                                       program.tensors[n].type.np_dtype())
               for n in program.input_names}
        pars = {p.name: jax.ShapeDtypeStruct(p.shape, p.type.np_dtype())
                for p in program.params.values()}
        t0 = time.perf_counter()
        runner.fn.lower(ins, pars).compile()
        return time.perf_counter() - t0


def xla_bytes_per_update(compiled, updates: int) -> float | None:
    """XLA's cost-model bytes per cell update for a whole compiled program
    (sum of its 'bytes accessed' entries).  None when the backend has no
    cost model."""
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else None
    if not ca:
        return None
    total = sum(v for k, v in ca.items() if k.startswith("bytes accessed"))
    return total / float(updates)
