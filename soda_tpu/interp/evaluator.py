"""Shared typed expression evaluator with C-like semantics.

One evaluator serves every execution path — the NumPy oracle, the XLA
(jnp) backend and the mesh's per-shard compute — parameterized by the
array namespace (`xp`) and a tap callback that materializes tensor refs.
This replaces the reference's per-backend expression printers (src/soda/codegen/*): instead of printing C++ per backend, the same
IR walk *builds the computation* in whichever array language is in scope.

Integer semantics (see ir/types.py for the rationale):
  * arithmetic in a wide accumulator (int64 for the NumPy oracle, int32
    on the XLA path for programs of 32-bit types);
  * `/` and `%` follow C: truncation toward zero, remainder takes the
    dividend's sign (numpy floor-division is corrected);
  * values are masked/sign-extended to the declared width ONLY at explicit
    casts and at stage stores — matching ap_int's exact width-growth
    behavior for all practical widths.
Float semantics: float literals are float32 (documented deviation from
C's double literals), computation in the promoted width, no
reassociation (the IR tree is evaluated exactly as written).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..ir import expr as ir
from ..ir.program import StencilProgram
from ..ir.types import ScalarType, promote

INT32 = ScalarType("int", 32)
FLOAT32 = ScalarType("float", 32)


@dataclasses.dataclass
class EvalContext:
    program: StencilProgram
    xp: Any                                   # numpy or jax.numpy
    tap: Callable[[str, tuple[int, ...]], Any]  # materialize Ref
    params: dict[str, Any]
    int_width: int = 64                        # 64 oracle, 32 XLA narrow
    # pair-carrier wide mode (interp/wide64.WideXP shim, the mesh's 64-bit
    # path): 64-bit values ride paired-32-bit carriers, but NARROW types
    # keep the 32-bit path's semantics (f32 compute for half, int32 stage
    # storage)
    pair_wide: bool = False

    def int_dtype(self, signed: bool = True):
        if self.int_width == 128:
            # quad-limb carriers (interp/wide128.Wide128XP namespace)
            return self.xp.int128 if signed else self.xp.uint128
        if self.int_width == 64:
            return self.xp.int64 if signed else self.xp.uint64
        return self.xp.int32 if signed else self.xp.uint32

    def acc_of(self, t: ScalarType):
        """Carrier dtype for an integer DSL type: the signed accumulator,
        EXCEPT unsigned types at/above the accumulator width, which ride an
        unsigned carrier so value-dependent ops (/ % < >>) see true values.
        (C integer promotion: narrower unsigned types promote to signed int,
        so only full-width unsigned stays unsigned — uint32 on the 32-bit
        path, uint64 on the 64-bit paths.)"""
        unsigned = t.is_int and t.kind == "uint" and t.width >= self.int_width
        return self.int_dtype(signed=not unsigned)

    def float_dtype(self, width: int):
        if self.int_width == 32:  # 32-bit path: f32 compute
            return self.xp.float32
        if self.pair_wide and width <= 32:  # half computes as f32
            return self.xp.float32
        return {16: self.xp.float16, 32: self.xp.float32, 64: self.xp.float64}[width]


def _c_div(xp, a, b):
    """C integer division: truncation toward zero."""
    q = xp.floor_divide(a, b)
    r = a - q * b
    fix = (r != 0) & ((a < 0) != (b < 0))
    return q + fix.astype(q.dtype)


def _const_pow2(e: "ir.Expr") -> int | None:
    """Literal positive power-of-two divisor (seen through casts), or
    None.  `x / int64(4)` parses as Cast(Const(4)) — unwrap, but only
    when every cast REPRESENTS the literal unchanged: `x / int8(128)`
    wraps to -128 at runtime and must keep the general division path."""
    casts: list[ScalarType] = []
    while isinstance(e, ir.Cast):
        casts.append(e.type)
        e = e.operand
    if not (isinstance(e, ir.Const) and isinstance(e.value, int)):
        return None
    v = e.value
    for t in casts:
        if t.is_float:
            return None  # float-typed divisor: not an integer shift
        if t.kind == "int":
            if not (-(1 << (t.width - 1)) <= v < (1 << (t.width - 1))):
                return None  # cast would wrap the value
        else:
            if not (0 <= v < (1 << t.width)):
                return None
    if v > 0 and (v & (v - 1)) == 0:
        return v
    return None


def _c_div_pow2(ctx: EvalContext, a, v: int, signed: bool):
    """C truncating division by a constant 2^k: bias-then-shift (the
    64-step pair long division would otherwise dominate kernel size —
    and it's faster on every path)."""
    xp = ctx.xp
    k = v.bit_length() - 1
    if k == 0:
        return a
    if signed:
        bias = xp.where(a < 0, a - a + (v - 1), a - a)
        a = a + bias
    return xp.right_shift(a, k)


def _c_mod(xp, a, b):
    q = _c_div(xp, a, b)
    return a - q * b


def _mask_to(ctx: EvalContext, v, t: ScalarType):
    """Wrap an integer value (held in the wide accumulator) to declared
    width with sign extension; floats convert."""
    xp = ctx.xp
    if t.is_float:
        return xp.asarray(v).astype(ctx.float_dtype(t.width))
    if t.width >= ctx.int_width:
        # full-width: reinterpret into the type's carrier (mod 2^w — the
        # astype between same-width int dtypes wraps, which IS the masking)
        return xp.asarray(v).astype(ctx.acc_of(t))
    acc = ctx.int_dtype(signed=True)
    v = xp.asarray(v).astype(acc)
    mask = (1 << t.width) - 1
    v = xp.bitwise_and(v, mask)
    if t.kind == "int":
        sign = 1 << (t.width - 1)
        v = xp.where(xp.bitwise_and(v, sign) != 0, v - (1 << t.width), v)
    return v.astype(acc)


def _to_float(ctx: EvalContext, v, width: int = 32):
    return ctx.xp.asarray(v).astype(ctx.float_dtype(width))


def _trunc_float_to_int(ctx: EvalContext, v, t: ScalarType):
    xp = ctx.xp
    v = xp.trunc(xp.asarray(v))
    if (t.is_int and t.kind == "uint"
            and ctx.int_width == 32 and t.width >= 32):
        # 32-bit path float->uint32: direct unsigned convert (XLA defines it),
        # keeping values in [2^31, 2^32) exact — the signed int32 carrier
        # would clamp them
        v = v.astype(ctx.acc_of(t))
    else:
        # route through the SIGNED carrier then reinterpret: matches the
        # C++ golden runner's defined (int64_t)trunc + two's-complement
        # wrap (direct float->uint64 is platform-dependent in numpy/C)
        v = v.astype(ctx.int_dtype(signed=True))
    return _mask_to(ctx, v, t)


_FLOAT_FNS = {
    "sqrt": "sqrt", "rsqrt": None, "exp": "exp", "exp2": "exp2",
    "log": "log", "log2": "log2", "sin": "sin", "cos": "cos",
    "tan": "tan", "tanh": "tanh", "floor": "floor", "ceil": "ceil",
    "fabs": "abs",
    # round-3 continuation C-math surface (names mapped to the np/jnp
    # spelling; WideXP exposes matching DS-accurate methods)
    "atan": "arctan", "asin": "arcsin", "acos": "arccos",
    "sinh": "sinh", "cosh": "cosh", "log10": "log10",
    "expm1": "expm1", "log1p": "log1p", "trunc": "trunc",
}

# two-arg float fns: both operands promoted to the common float type
_FLOAT_FNS2 = {"atan2": "arctan2", "copysign": "copysign",
               "hypot": "hypot"}

def eval_expr(e: ir.Expr, ctx: EvalContext) -> tuple[Any, ScalarType]:
    """Evaluate to (array_value, dsl_type).  Integer values are carried in
    the wide accumulator dtype; floats in their promoted width."""
    xp = ctx.xp
    prog = ctx.program

    if isinstance(e, ir.Const):
        if isinstance(e.value, float):
            t = e.type or FLOAT32
            return xp.asarray(e.value, dtype=ctx.float_dtype(t.width)), t
        t = e.type or INT32
        return xp.asarray(e.value, dtype=ctx.int_dtype(True)), t

    if isinstance(e, ir.Ref):
        t = prog.tensors[e.name].type
        v = ctx.tap(e.name, e.offsets)
        if t.is_float:
            return xp.asarray(v).astype(ctx.float_dtype(t.width)), t
        # widen storage dtype into the type's carrier (sign-correct: storage
        # dtype already carries the sign of the declared type; full-width
        # unsigned rides an unsigned carrier — see acc_of)
        return xp.asarray(v).astype(ctx.acc_of(t)), t

    if isinstance(e, ir.ParamRef):
        p = ctx.params[e.name]
        v = p[e.indices] if e.indices else p
        t = prog.params[e.name].type
        if t.is_float:
            return xp.asarray(v).astype(ctx.float_dtype(t.width)), t
        return xp.asarray(v).astype(ctx.acc_of(t)), t

    if isinstance(e, ir.Var):
        t = prog.params[e.name].type
        v = ctx.params[e.name]
        if t.is_float:
            return xp.asarray(v).astype(ctx.float_dtype(t.width)), t
        return xp.asarray(v).astype(ctx.acc_of(t)), t

    if isinstance(e, ir.Cast):
        v, vt = eval_expr(e.operand, ctx)
        t = e.type
        if t.is_float:
            return _to_float(ctx, v, t.width), t
        if vt.is_float:
            return _trunc_float_to_int(ctx, v, t), t
        return _mask_to(ctx, v, t), t

    if isinstance(e, ir.UnOp):
        v, vt = eval_expr(e.operand, ctx)
        if e.op == "-":
            return -v, vt
        if e.op == "+":
            return v, vt
        if e.op == "!":
            return (v == 0).astype(ctx.int_dtype(True)), INT32
        if e.op == "~":
            return xp.bitwise_not(v), vt
        raise ValueError(f"unknown unop {e.op}")

    if isinstance(e, ir.Select):
        c, _ = eval_expr(e.cond, ctx)
        a, at = eval_expr(e.on_true, ctx)
        b, bt = eval_expr(e.on_false, ctx)
        t = promote(at, bt)
        a, b = _coerce_pair(ctx, a, at, b, bt, t)
        return xp.where(c != 0, a, b), t

    if isinstance(e, ir.BinOp):
        a, at = eval_expr(e.lhs, ctx)
        b, bt = eval_expr(e.rhs, ctx)
        op = e.op
        if op in ("&&", "||"):
            an = (a != 0)
            bn = (b != 0)
            v = (an & bn) if op == "&&" else (an | bn)
            return v.astype(ctx.int_dtype(True)), INT32
        if op in ("==", "!=", "<", ">", "<=", ">="):
            t = promote(at, bt)
            a, b = _coerce_pair(ctx, a, at, b, bt, t)
            v = {"==": a == b, "!=": a != b, "<": a < b,
                 ">": a > b, "<=": a <= b, ">=": a >= b}[op]
            return v.astype(ctx.int_dtype(True)), INT32
        if op in ("<<", ">>"):
            # shift in the lhs type's carrier: unsigned full-width types get
            # a LOGICAL right shift (C), signed get arithmetic; the shift
            # amount must match the value dtype (mixed-kind shifts promote
            # unpredictably in numpy)
            a = xp.asarray(a).astype(ctx.acc_of(at) if at.is_int
                                     else ctx.int_dtype(True))
            sh = xp.asarray(b).astype(a.dtype)
            if op == "<<":
                return xp.left_shift(a, sh), at
            return xp.right_shift(a, sh), at
        t = promote(at, bt)
        a, b = _coerce_pair(ctx, a, at, b, bt, t)
        if op == "+":
            return a + b, t
        if op == "-":
            return a - b, t
        if op == "*":
            return a * b, t
        if op == "/":
            if t.is_float:
                return a / b, t
            p2 = _const_pow2(e.rhs)
            if p2 is not None:
                return _c_div_pow2(ctx, a, p2,
                                   signed=t.kind != "uint"
                                   or t.width < ctx.int_width), t
            return _c_div(xp, a, b), t
        if op == "%":
            if not t.is_float:
                p2 = _const_pow2(e.rhs)
                if p2 is not None:
                    q = _c_div_pow2(ctx, a, p2,
                                    signed=t.kind != "uint"
                                    or t.width < ctx.int_width)
                    return a - q * b, t
            if t.is_float:
                # C fmod: exact remainder, sign of the dividend.  xp.fmod
                # matches std::fmod bit-for-bit in numpy AND jnp (verified
                # incl. the large-quotient case 1e8 % 0.3f where the naive
                # a - trunc(a/b)*b formula loses everything to rounding);
                # xp.mod would be floor modulo (sign of divisor) — wrong.
                return xp.fmod(a, b), t
            return _c_mod(xp, a, b), t
        if op in ("&", "|", "^"):
            v = {"&": xp.bitwise_and, "|": xp.bitwise_or, "^": xp.bitwise_xor}[op](a, b)
            return v, t
        raise ValueError(f"unknown binop {op}")

    if isinstance(e, ir.Call):
        vals = [eval_expr(a, ctx) for a in e.args]
        if e.fn in ("min", "max", "fmin", "fmax"):
            t = vals[0][1]
            for _, u in vals[1:]:
                t = promote(t, u)
            if e.fn in ("fmin", "fmax") and not t.is_float:
                t = FLOAT32
            coerced = [_coerce_to(ctx, v, vt, t) for v, vt in vals]
            out = coerced[0]
            f = xp.minimum if e.fn in ("min", "fmin") else xp.maximum
            for v in coerced[1:]:
                out = f(out, v)
            return out, t
        if e.fn == "abs":
            v, vt = vals[0]
            return xp.abs(v), vt
        if e.fn == "pow":
            t = promote(promote(vals[0][1], vals[1][1]), FLOAT32)
            a = _coerce_to(ctx, *vals[0], t)
            b = _coerce_to(ctx, *vals[1], t)
            return xp.power(a, b), t
        if e.fn == "rsqrt":
            t = promote(vals[0][1], FLOAT32)
            v = _coerce_to(ctx, *vals[0], t)
            one = xp.asarray(1.0, dtype=ctx.float_dtype(t.width))
            return one / xp.sqrt(v), t
        if e.fn == "round":
            # C std::round: half away from zero (np/jnp.round is banker's
            # rounding and would disagree with the C++ golden runner)
            t = promote(vals[0][1], FLOAT32)
            v = _coerce_to(ctx, *vals[0], t)
            half = xp.where(v >= 0, 0.5, -0.5).astype(v.dtype)
            return xp.trunc(v + half), t
        if e.fn in _FLOAT_FNS:
            t = promote(vals[0][1], FLOAT32)
            v = _coerce_to(ctx, *vals[0], t)
            return getattr(xp, _FLOAT_FNS[e.fn])(v), t
        if e.fn in _FLOAT_FNS2:
            t = promote(promote(vals[0][1], vals[1][1]), FLOAT32)
            a = _coerce_to(ctx, *vals[0], t)
            b = _coerce_to(ctx, *vals[1], t)
            return getattr(xp, _FLOAT_FNS2[e.fn])(a, b), t
        raise ValueError(f"unknown function {e.fn}")

    raise TypeError(f"cannot evaluate {e!r}")


def _coerce_to(ctx: EvalContext, v, vt: ScalarType, t: ScalarType):
    if t.is_float and not vt.is_float:
        return _to_float(ctx, v, t.width)
    if t.is_float and vt.is_float and vt.width != t.width:
        return _to_float(ctx, v, t.width)
    if t.is_int and not vt.is_float:
        # align both operands on the promoted type's carrier so mixed
        # signed/unsigned ops follow C conversions (int32 -> uint32 wraps)
        return ctx.xp.asarray(v).astype(ctx.acc_of(t))
    return v


def _coerce_pair(ctx, a, at, b, bt, t):
    return _coerce_to(ctx, a, at, t), _coerce_to(ctx, b, bt, t)


def store_cast(ctx: EvalContext, v, vt: ScalarType, t: ScalarType, storage=True):
    """Cast a computed stage value to its declared type for storing."""
    xp = ctx.xp
    if t.is_float:
        out = _to_float(ctx, v, t.width)
        return out
    if vt.is_float:
        v = _trunc_float_to_int(ctx, v, t)
    else:
        v = _mask_to(ctx, v, t)
    if storage:
        return v.astype(_storage_dtype(ctx, t))
    return v


def _storage_dtype(ctx: EvalContext, t: ScalarType):
    xp = ctx.xp
    if ctx.int_width == 128:
        # quad-limb path: >64-bit ints stay limb vectors; narrower types
        # and floats use native numpy dtypes
        if t.is_int and t.width > 64:
            return ctx.acc_of(t)
        if t.is_float:
            return {16: xp.float16, 32: xp.float32,
                    64: xp.float64}[t.width]
        return t.np_dtype()
    if ctx.int_width == 32:
        # the 32-bit path computes uniformly in int32 (masking at stores
        # preserves semantics for widths <= 16; full-range uint32 is
        # documented as unsupported on the 32-bit path)
        return xp.int32
    if ctx.pair_wide:
        # pair-carrier wide mode: 64-bit stays paired; narrow stages keep
        # the 32-bit path's storage (int32/float32)
        if t.is_float:
            return xp.float64 if t.width == 64 else xp.float32
        if t.width > 32:
            return xp.int64 if t.is_signed else xp.uint64
        return xp.int32
    return t.np_dtype()
