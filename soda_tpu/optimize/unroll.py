"""Temporal unrolling: replicate the stage chain `factor` times as renamed
copies — exactly the reference's implementation of `iterate`
(src/soda/core.py: "iterate>1 → replicate stage chain N times (renamed
copies)", SURVEY.md §3(a); reconstructed — empty mount).

The unrolled program is a plain single-sweep (or iterate/factor-sweep)
multi-stage DAG, which XLA fuses as one sweep: `factor` updates per pass
over device memory instead of one.

Semantics: identical to running `factor` sweeps (same op order per sweep;
the boundary rim differs only inside the invalid region, as any chained
multi-stage program's does)."""

from __future__ import annotations

from ..ir import expr as ir
from ..ir.program import StencilProgram, Tensor


def unroll_iterate(program: StencilProgram, factor: int | None = None
                   ) -> StencilProgram:
    """Unroll `factor` sweeps (default: all) into chained stage copies.

    Requires iterate > 1.  The feedback pair is first-input <-
    FIRST-declared output; with multiple outputs the intermediate sweeps'
    copies of non-feedback outputs are dead stages (no consumer), which
    XLA drops — exactly the reference's replication semantics.
    The result has iterate = program.iterate // factor."""
    it = max(program.iterate, 1)
    factor = it if factor is None else factor
    if it <= 1 or factor <= 1:
        return program
    if it % factor != 0:
        raise ValueError(f"unroll factor {factor} must divide iterate {it}")

    in_name = program.input_names[0]
    out_name = program.output_names[0]
    stage_names = program.stage_order()

    tensors: dict[str, Tensor] = {}
    for n in program.input_names:
        t = program.tensors[n]
        tensors[n] = Tensor(n, t.type, None, t.dram, t.tile_size)

    prev_out = in_name
    final_names: dict[str, str] = {}
    for sweep in range(factor):
        last = sweep == factor - 1
        mapping = {in_name: prev_out}
        for s in stage_names:
            mapping[s] = s if last else f"{s}__it{sweep}"
        for s in stage_names:
            t = program.tensors[s]
            body = ir.rename(t.expr, mapping)
            nm = mapping[s]
            tensors[nm] = Tensor(
                nm, t.type, body, t.dram,
                is_output=(last and t.is_output))
        prev_out = mapping[out_name]

    return StencilProgram(
        name=program.name,
        tensors=tensors,
        params=program.params,
        rank=program.rank,
        burst_width=program.burst_width,
        iterate=it // factor,
        unroll_factor=program.unroll_factor,
        border=program.border,
        cluster=program.cluster,
    )
