"""Analytic per-cell operation counts from the IR — the compute half of
the roofline (the reference's analog is HLS resource/II reports,
SURVEY.md §5 'tracing' row).

Counts ops per output cell for each stage: arithmetic/select/compare as
1 op, transcendentals (sqrt/exp/log/trig/pow) at a configurable weight
(they run on a slower path).  The report prints it; the mesh's cadence
model divides it by the device table's f32 rate.
"""

from __future__ import annotations

from ..ir import expr as ir
from ..ir.program import StencilProgram

TRANSCENDENTAL_WEIGHT = 8.0
_TRANSCENDENTALS = {"sqrt", "rsqrt", "exp", "exp2", "log", "log2", "sin",
                    "cos", "tan", "tanh", "pow", "atan", "atan2", "asin",
                    "acos", "sinh", "cosh", "log10", "expm1", "log1p",
                    "hypot"}


def expr_ops(e: ir.Expr) -> float:
    """Weighted op count over DISTINCT subexpressions: XLA CSEs repeated
    subtrees (e.g. heat3d's center tap appearing in all three directional
    terms), so counting every occurrence would overstate the compute.
    IR nodes are frozen dataclasses — structural equality dedups exactly."""
    ops = 0.0
    seen: set = set()
    for n in ir.walk(e):
        if n in seen:
            continue
        seen.add(n)
        if isinstance(n, ir.BinOp):
            ops += 1
        elif isinstance(n, ir.UnOp):
            ops += 0 if n.op == "+" else 1
        elif isinstance(n, ir.Select):
            ops += 1
        elif isinstance(n, ir.Call):
            if n.fn in _TRANSCENDENTALS:
                ops += TRANSCENDENTAL_WEIGHT
            else:
                # k-ary reductions (min/max/...) cost k-1 ops — consistent
                # with tcse.count_minmax
                ops += max(len(n.args) - 1, 1)
        elif isinstance(n, ir.Cast):
            ops += 1
    return ops


def ops_per_cell(program: StencilProgram) -> float:
    """Weighted ops per cell for ONE sweep of all stages."""
    return sum(expr_ops(t.expr) for t in program.tensors.values()
               if t.expr is not None)
