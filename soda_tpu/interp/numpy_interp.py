"""NumPy golden-model interpreter.

Analog of the reference's generated host-side golden model: the
generated OpenCL host embeds a naive C++ loop nest over the full grid and
verifies kernel output element-wise (reference: src/soda/codegen/xilinx/
host.py per SURVEY.md §2.1/§4; reconstructed — empty reference mount).
Here the oracle is a standalone interpreter over the IR, so every backend
(XLA, host-tiled, sharded, C++ golden runner) checks against the same
semantics.

Border convention: `border: ignore` — out-of-grid taps read zeros, and the
rim of width radius×sweeps is semantically invalid; comparisons may exclude
it (all backends share the zero-fill convention, so full-array comparisons
also pass for single-chip paths).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from ..ir.program import StencilProgram
from .evaluator import EvalContext, eval_expr, store_cast


def shifted(a: np.ndarray, offsets: tuple[int, ...]) -> np.ndarray:
    """out[i] = a[i + off] with zero fill out of bounds."""
    out = np.zeros_like(a)
    src = []
    dst = []
    for n, off in zip(a.shape, offsets):
        lo_src = max(off, 0)
        hi_src = min(n + off, n)
        if hi_src <= lo_src:
            return out
        src.append(slice(lo_src, hi_src))
        dst.append(slice(lo_src - off, hi_src - off))
    out[tuple(dst)] = a[tuple(src)]
    return out


def run_once(
    program: StencilProgram,
    arrays: dict[str, np.ndarray],
    params: Mapping[str, np.ndarray],
) -> None:
    """Evaluate every stage once (one sweep), updating `arrays` in place."""
    ctx = EvalContext(
        program=program,
        xp=np,
        tap=lambda name, off: shifted(arrays[name], off),
        params=dict(params),
        int_width=64,
    )
    for name in program.stage_order():
        t = program.tensors[name]
        v, vt = eval_expr(t.expr, ctx)
        arrays[name] = np.asarray(store_cast(ctx, v, vt, t.type))


def run_once_128(
    program: StencilProgram,
    arrays: dict,
    params: Mapping,
) -> None:
    """One sweep of a >64-bit program: the SAME evaluator walk with the
    quad-limb namespace (interp/wide128.Wide128XP) at int_width=128 —
    values flow as V limb vectors (ints >64) or plain numpy arrays."""
    from . import wide128

    def tap(name, off):
        v = arrays[name]
        if isinstance(v, wide128.V):
            return v.map(lambda p: shifted(p, off))
        return shifted(v, off)

    ctx = EvalContext(
        program=program,
        xp=wide128.Wide128XP(np),
        tap=tap,
        params=dict(params),
        int_width=128,
    )
    for name in program.stage_order():
        t = program.tensors[name]
        v, vt = eval_expr(t.expr, ctx)
        s = store_cast(ctx, v, vt, t.type)
        if isinstance(s, wide128.V) and s.rep == "p":
            s = np.asarray(s.l)
        arrays[name] = s


def run(
    program: StencilProgram,
    inputs: Mapping[str, np.ndarray],
    params: Mapping[str, np.ndarray] | None = None,
    iterate: int | None = None,
) -> dict[str, np.ndarray]:
    """Run the full program (including temporal iteration) on full grids.

    Returns {output_name: array}.  For iterate>1 the FIRST-declared
    output feeds back into the first input each sweep (reference
    `iterate` semantics: the stage pipeline is chained N times, SURVEY.md
    §3(d)); further outputs take their final-sweep values
    (docs/SEMANTICS.md "multi-output iterate")."""
    from . import wide128

    it = program.iterate if iterate is None else iterate
    params = dict(params or {})
    w128 = wide128.program_is_128(program)
    arrays: dict = {}
    for n in program.input_names:
        t = program.tensors[n]
        a = np.asarray(inputs[n], dtype=t.type.np_dtype())
        if a.ndim != program.rank:
            raise ValueError(f"input {n!r} rank {a.ndim} != program rank {program.rank}")
        if w128 and t.type.is_int and t.type.width > 64:
            # >64-bit inputs: object arrays of Python ints -> limb vectors
            # in the CARRIER rep (only full-width unsigned stays "u" —
            # matches evaluator.acc_of, keeping iterate feedback reps
            # consistent with stored stage values)
            rep = ("u" if (not t.type.is_signed and t.type.width >= 128)
                   else "i")
            a = wide128._object_to_limbs(np.asarray(a, dtype=object),
                                         rep, np)
        arrays[n] = a

    for p in program.params.values():
        if p.name not in params:
            raise ValueError(f"missing param {p.name!r}")
        pv = np.asarray(params[p.name], dtype=p.type.np_dtype())
        if tuple(pv.shape) != tuple(p.shape):
            raise ValueError(
                f"param {p.name!r} shape {pv.shape} != declared {p.shape}")
        if w128 and p.type.is_int and p.type.width > 64:
            rep = ("u" if (not p.type.is_signed and p.type.width >= 128)
                   else "i")
            pv = wide128._object_to_limbs(np.asarray(pv, dtype=object),
                                          rep, np)
        params[p.name] = pv

    for sweep in range(max(it, 1)):
        if w128:
            run_once_128(program, arrays, params)
        else:
            run_once(program, arrays, params)
        if it > 1 and sweep + 1 < it:
            arrays[program.input_names[0]] = arrays[program.output_names[0]]

    out = {}
    for n in program.output_names:
        v = arrays[n]
        if isinstance(v, wide128.V):
            t = program.tensors[n].type
            out[n] = (wide128.to_object_array(v, t.is_signed)
                      if v.rep != "p" else np.asarray(v.l))
        else:
            out[n] = v
    return out
