"""XLA backend: the main execution path.

Each sweep evaluates every stage over the full grid with `jax.numpy`;
`iterate` sweeps run as one `lax.scan` inside one jitted function.  XLA
fuses the zero-fill shifted taps and the stage arithmetic of a sweep into
loop fusions, so no padded copy of a grid is ever written.  The same
function is the per-tile compute of host tiling (parallel/host_tile.py)
and the per-shard compute of the mesh (parallel/mesh.py).

Semantics match the NumPy oracle: zero-fill taps, wide-int accumulators
(int32 for programs of 32-bit types — see ir/types.py), C division,
masking at stores.  Programs with >32-bit types run native int64/float64
under `jax.enable_x64`.
"""

from __future__ import annotations

import contextlib
from typing import Mapping

import jax
import jax.numpy as jnp
import numpy as np

from ..ir.program import StencilProgram
from ..interp.evaluator import EvalContext, eval_expr, store_cast


def shifted_jnp(a: jax.Array, offsets: tuple[int, ...]) -> jax.Array:
    """out[i] = a[i + off], zero fill out of bounds (static shapes)."""
    from ..interp.wide64 import W
    from ..interp.wide128 import V

    if isinstance(a, (W, V)):  # limb carriers: shift each plane/limb
        return a.map(lambda p: shifted_jnp(p, offsets))
    pads = [(max(-off, 0), max(off, 0)) for off in offsets]
    ap = jnp.pad(a, pads)
    out_slices = [
        slice(off + hi, off + hi + n)
        for n, off, (hi, _lo) in zip(a.shape, offsets, pads)
    ]
    return ap[tuple(out_slices)]


def _needs_wide(program: StencilProgram) -> bool:
    """True when any tensor/param is wider than 32 bits
    (incl. synthetic stages: running them in x64 wide mode keeps the
    oracle-exact semantics their int64 typing exists for)."""
    types = [t.type for t in program.tensors.values()]
    types += [p.type for p in program.params.values()]
    return any(t.width > 32 for t in types)


def _compute_dtype(program: StencilProgram, name: str, wide: bool = False):
    t = program.tensors[name].type
    if t.is_float:
        return jnp.float64 if wide and t.width > 32 else jnp.float32
    if wide:
        return jnp.int64
    return jnp.int32


def _sweep(program: StencilProgram, arrays: dict, params: dict,
           int_width: int = 32) -> dict:
    """One sweep over full grids; returns updated tensor dict."""
    if int_width == 128:
        from ..interp.wide128 import Wide128XP

        xp = Wide128XP(jnp)
    else:
        xp = jnp
    ctx = EvalContext(
        program=program,
        xp=xp,
        tap=lambda name, off: shifted_jnp(arrays[name], off),
        params=params,
        int_width=int_width,
    )
    for name in program.stage_order():
        t = program.tensors[name]
        v, vt = eval_expr(t.expr, ctx)
        arrays[name] = store_cast(ctx, v, vt, t.type)
    return arrays


def build_fn(program: StencilProgram, iterate: int | None = None):
    """Build a jittable fn(inputs: dict, params: dict) -> dict of outputs.

    Arrays are in compute dtypes (float32 / int32).  Programs with
    >32-bit types run in WIDE mode: native int64 accumulators and
    float64; requires jax x64 — Runner wraps the call in
    jax.enable_x64(True).  The caller converts to declared storage
    dtypes (Runner.fetch does this)."""
    from ..interp.wide128 import V, program_is_128

    it = program.iterate if iterate is None else iterate
    it = max(it, 1)
    in_name = program.input_names[0]
    out_name = program.output_names[0]
    w128 = program_is_128(program)
    wide = _needs_wide(program)
    int_width = 128 if w128 else (64 if wide else 32)

    def fn(inputs: Mapping[str, jax.Array], params: Mapping[str, jax.Array]):
        if wide and not jax.config.jax_enable_x64:
            raise RuntimeError(
                f"program {program.name!r} uses >32-bit types: run under "
                "jax.enable_x64(True) (xla.Runner does this "
                "automatically)")
        arrays = {}
        for n in program.input_names:
            v = inputs[n]
            if isinstance(v, V):
                arrays[n] = v  # quad-limb carriers arrive pre-wrapped
            else:
                arrays[n] = jnp.asarray(
                    v, _compute_dtype(program, n, wide))
        params_c = {k: (v if isinstance(v, V) else jnp.asarray(v))
                    for k, v in params.items()}

        if it == 1:
            arrays = _sweep(program, arrays, params_c, int_width)
            return {n: arrays[n] for n in program.output_names}

        def body(arrs, _):
            arrs = dict(arrs)
            arrs = _sweep(program, arrs, params_c, int_width)
            # feedback: first output -> first input; aux inputs carry over
            nxt = {n: arrs[n] for n in program.input_names}
            nxt[in_name] = arrs[out_name]
            return nxt, None

        # it-1 sweeps in the scan, then ONE final sweep outside it: the
        # final full-DAG evaluation yields every output's last-sweep value
        # (multi-output iterate: non-feedback outputs are final-sweep-only)
        state = {n: arrays[n] for n in program.input_names}
        if it > 1:
            state, _ = jax.lax.scan(body, state, None, length=it - 1)
        final = _sweep(program, dict(state), params_c, int_width)
        return {n: final[n] for n in program.output_names}

    return fn


def check_io(program: StencilProgram, inputs, params) -> None:
    missing = [n for n in program.input_names if n not in inputs]
    if missing:
        raise ValueError(
            f"missing input tensor(s) {missing}; program {program.name!r} "
            f"expects inputs {program.input_names}")
    missing_p = [n for n in program.params if n not in params]
    if missing_p:
        raise ValueError(
            f"missing param(s) {missing_p}; program {program.name!r} "
            f"declares params {list(program.params)}")


def finalize_outputs(program: StencilProgram, outs) -> dict:
    """Convert backend outputs to declared storage dtypes with narrow-
    width mask + sign extension (shared by the xla, host-tile and mesh
    run paths)."""
    res = {}
    for n, v in outs.items():
        t = program.tensors[n].type
        a = np.asarray(v)
        if t.is_int and t.needs_mask:
            a = a & ((1 << t.width) - 1)
            if t.kind == "int":
                sign = 1 << (t.width - 1)
                a = (a ^ sign) - sign
        res[n] = a.astype(t.np_dtype())
    return res


class Runner:
    """One program compiled at one iterate: numpy in, numpy out.

    `dispatch` starts the computation and returns device outputs without
    waiting; `fetch` brings them to the host in declared storage dtypes.
    Host tiling uses the split to keep one tile in flight while the
    previous one is fetched."""

    def __init__(self, program: StencilProgram, iterate: int | None = None):
        from ..interp.wide128 import program_is_128

        self.program = program
        self.w128 = program_is_128(program)
        self.wide = self.w128 or _needs_wide(program)
        self.fn = jax.jit(build_fn(program, iterate))

    def x64(self):
        """Context that the jitted call (and its argument conversion) runs
        under: 64-bit mode for programs with >32-bit types."""
        return jax.enable_x64(True) if self.wide else contextlib.nullcontext()

    def device_args(self, inputs: Mapping, params: Mapping | None = None):
        """(inputs, params) as the jitted fn takes them.  >64-bit ints
        arrive as object arrays of Python ints and become quad-limb V
        carriers (a pytree)."""
        from ..interp import wide128

        params = dict(params or {})
        if not self.w128:
            return dict(inputs), params

        def to_v(v, t):
            if t.is_int and t.width > 64 and not isinstance(v, wide128.V):
                # the CARRIER rep (evaluator.acc_of): only full-width
                # unsigned stays "u"; narrower unsigned (e.g. uint100)
                # promotes to the signed int128 carrier — "u" here would
                # flip the scan-carry pytree metadata between input and
                # stored stage value and crash iterate>1 programs
                rep = "u" if (not t.is_signed and t.width >= 128) else "i"
                return wide128._object_to_limbs(
                    np.asarray(v, dtype=object), rep, jnp)
            return v

        prog = self.program
        ins = {n: to_v(inputs[n], prog.tensors[n].type)
               for n in prog.input_names}
        pars = {n: to_v(v, prog.params[n].type) for n, v in params.items()}
        return ins, pars

    def dispatch(self, inputs: Mapping, params: Mapping | None = None):
        ins, pars = self.device_args(inputs, params)
        with self.x64():
            return self.fn(ins, pars)

    def fetch(self, outs) -> dict:
        from ..interp import wide128

        res = {}
        for n, v in outs.items():
            if isinstance(v, wide128.V):
                t = self.program.tensors[n].type
                res[n] = (wide128.to_object_array(v, t.is_signed)
                          if v.rep != "p" else np.asarray(v.l))
            else:
                res[n] = np.asarray(v)
        return finalize_outputs(self.program, res)

    def __call__(self, inputs: Mapping, params: Mapping | None = None):
        return self.fetch(self.dispatch(inputs, params))


def run(program: StencilProgram, inputs: Mapping, params: Mapping | None = None,
        iterate: int | None = None) -> dict:
    """Execute and return numpy outputs in declared storage dtypes."""
    check_io(program, inputs, params or {})
    return Runner(program, iterate)(inputs, params)
