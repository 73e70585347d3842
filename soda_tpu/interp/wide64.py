"""64-bit arithmetic as pairs of 32-bit values — the mesh's 64-bit mode.

The mesh path (parallel/mesh.py) shards 64-bit tensors as pairs of 32-bit
planes and evaluates them with this module, a small wrapped array
language that carries

  * ``int64``/``uint64`` as two uint32 limbs (lo, hi) with exact
    two's-complement semantics — add/sub/mul/compare/shift/bitwise and a
    64-step restoring long division, all BIT-EXACT vs the int64 oracle;
  * ``double`` as a double-single (hi, lo) pair of float32 with
    error-free transforms (Knuth two_sum, Dekker split/two_prod): +,-,*,/
    and sqrt carry ~2^-47 relative accuracy (docs/SEMANTICS.md); the C-math
    surface is DS-accurate too (~1e-12), including sin/cos/tan over the
    ENTIRE finite range via an integer Payne–Hanek reduction (_ph_reduce).

The evaluator (interp/evaluator.py) is already parameterized by an array
namespace ``xp``; ``WideXP(jnp)`` plugs in as that namespace so the SAME
typed walk that serves NumPy and XLA emits paired-limb code per shard.  Values flow as ``W`` wrappers: rep "p" = plain 32-bit
array, rep "i"/"u" = int64/uint64 limb pair, rep "d" = double-single.
``W.astype`` accepts ordinary numpy dtypes — np.int64/np.uint64/np.float64
select the pair reps — so the evaluator's dtype plumbing works unchanged.

The XLA backend runs the same types natively under x64; the pair
carriers remain only on the mesh path, and ROADMAP.md (Design 1) plans
their removal there too.
"""

from __future__ import annotations

import numpy as np

_MASK32 = np.uint32(0xFFFFFFFF)
_SIGNBIT = 0x80000000
_SPLIT = np.float32(4097.0)  # 2^12 + 1: Dekker split constant for f32


def _u32(xp, v):
    return xp.asarray(v).astype(np.uint32)


class W:
    """A wrapped value: plain 32-bit array, 64-bit limb pair, or
    double-single float pair."""

    __slots__ = ("rep", "a", "b", "xp")
    __array_priority__ = 200  # beat numpy's operator dispatch

    def __init__(self, rep: str, a, b=None, xp=None):
        self.rep = rep  # "p" plain | "i" int64 | "u" uint64 | "d" ds-f64
        self.a = a      # plain array | lo limb (u32) | ds hi (f32)
        self.b = b      # None        | hi limb (u32) | ds lo (f32)
        self.xp = xp

    # ---- constructors -----------------------------------------------------

    @staticmethod
    def plain(x, xp):
        return W("p", x, None, xp)

    @staticmethod
    def from_int_scalar(v: int, rep: str, xp):
        v64 = int(v) & 0xFFFFFFFFFFFFFFFF
        return W(rep, _u32(xp, np.uint32(v64 & 0xFFFFFFFF)),
                 _u32(xp, np.uint32(v64 >> 32)), xp)

    @staticmethod
    def ds_from_float(v: float, xp):
        hi = np.float32(v)
        lo = np.float32(np.float64(v) - np.float64(hi))
        return W("d", xp.asarray(hi), xp.asarray(lo), xp)

    # ---- shape plumbing (windows/taps slice wrapped values) ---------------

    @property
    def shape(self):
        return self.a.shape

    @property
    def dtype(self):
        if self.rep == "i":
            return np.dtype(np.int64)
        if self.rep == "u":
            return np.dtype(np.uint64)
        if self.rep == "d":
            return np.dtype(np.float64)
        return self.a.dtype

    def map(self, f):
        """Apply an array->array function to every component (slicing,
        lane shifts, padding — geometry only, value-preserving)."""
        return W(self.rep, f(self.a),
                 None if self.b is None else f(self.b), self.xp)

    def __getitem__(self, sl):
        return self.map(lambda x: x[sl])

    # ---- pytree protocol ---------------------------------------------------
    # W is registered as a JAX pytree node (see _register_pytree below), so
    # pair carriers flow through jit / fori_loop carries / shard_map /
    # dynamic_update_slice trees — the whole wide path is traceable
    # end-to-end instead of host-driven.

    def tree_flatten(self):
        return (self.a, self.b), (self.rep, self.xp)

    @classmethod
    def tree_unflatten(cls, aux, children):
        rep, xp = aux
        a, b = children
        return cls(rep, a, b, xp)

    # ---- rep conversion ----------------------------------------------------

    def astype(self, dtype):
        d = np.dtype(dtype) if not isinstance(dtype, str) else np.dtype(dtype)
        xp = self.xp
        if d == np.int64 or d == np.uint64:
            rep = "i" if d == np.int64 else "u"
            if self.rep in ("i", "u"):
                return W(rep, self.a, self.b, xp)
            if self.rep == "d":
                return _ds_to_pair(self, rep)
            return _plain_to_pair(self, rep)
        if d == np.float64:
            if self.rep == "d":
                return self
            if self.rep in ("i", "u"):
                return _pair_to_ds(self)
            a = self.a
            if a.dtype == np.bool_:
                a = a.astype(np.float32)
            return W("d", a.astype(np.float32),
                     xp.zeros_like(a, np.float32), xp)
        # narrow target: materialize a plain array
        if self.rep in ("i", "u"):
            if np.dtype(d).kind == "f":
                ds = _pair_to_ds(self)
                return W.plain((ds.a + ds.b).astype(d), xp)
            return W.plain(self.a.astype(d), xp)  # truncate to low limb
        if self.rep == "d":
            if np.dtype(d).kind == "f":
                return W.plain(self.a.astype(d), xp)
            p = _ds_to_pair(self, "i")
            return W.plain(p.a.astype(d), xp)
        return W.plain(self.a.astype(d), xp)

    # ---- arithmetic --------------------------------------------------------

    def _lift(self, other):
        """Coerce (self, other) to a common rep."""
        xp = self.xp
        if not isinstance(other, W):
            if isinstance(other, (bool, np.bool_)):
                other = W.plain(xp.asarray(other), xp)
            elif isinstance(other, (int, np.integer)):
                if self.rep in ("i", "u"):
                    other = W.from_int_scalar(int(other), self.rep, xp)
                elif self.rep == "d":
                    other = W.ds_from_float(float(other), xp)
                else:
                    other = W.plain(xp.asarray(other, self.a.dtype), xp)
            elif isinstance(other, (float, np.floating)):
                if self.rep == "d":
                    other = W.ds_from_float(float(other), xp)
                else:
                    other = W.plain(xp.asarray(other), xp)
            else:
                other = W.plain(xp.asarray(other), xp)
        a, b = self, other
        order = {"p": 0, "i": 1, "u": 2, "d": 3}
        if order[b.rep] > order[a.rep]:
            a = a.astype({"i": np.int64, "u": np.uint64,
                          "d": np.float64}[b.rep])
        elif order[a.rep] > order[b.rep] and b.rep != a.rep:
            b = b.astype({"i": np.int64, "u": np.uint64,
                          "d": np.float64}[a.rep])
        return a, b

    def __add__(self, other):
        a, b = self._lift(other)
        if a.rep == "p":
            return W.plain(a.a + b.a, a.xp)
        if a.rep == "d":
            return _ds_add(a, b)
        return _pair_add(a, b)

    __radd__ = __add__

    def __sub__(self, other):
        a, b = self._lift(other)
        if a.rep == "p":
            return W.plain(a.a - b.a, a.xp)
        if a.rep == "d":
            return _ds_add(a, _ds_neg(b))
        return _pair_add(a, _pair_neg(b))

    def __rsub__(self, other):
        a, b = self._lift(other)
        return b - a

    def __mul__(self, other):
        a, b = self._lift(other)
        if a.rep == "p":
            return W.plain(a.a * b.a, a.xp)
        if a.rep == "d":
            return _ds_mul(a, b)
        return _pair_mul(a, b)

    __rmul__ = __mul__

    def __truediv__(self, other):
        a, b = self._lift(other)
        if a.rep == "p":
            return W.plain(a.a / b.a, a.xp)
        if a.rep == "d":
            return _ds_div(a, b)
        raise TypeError("use floor_divide/_c_div for integer pairs")

    def __neg__(self):
        if self.rep == "p":
            return W.plain(-self.a, self.xp)
        if self.rep == "d":
            return _ds_neg(self)
        return _pair_neg(self)

    def __pos__(self):
        return self

    # comparisons return PLAIN boolean arrays
    def _cmp(self, other, op):
        a, b = self._lift(other)
        xp = a.xp
        if a.rep == "p":
            import operator
            v = getattr(operator, op)(a.a, b.a)
            return W.plain(v, xp)
        if a.rep == "d":
            lt = (a.a < b.a) | ((a.a == b.a) & (a.b < b.b))
            eq = (a.a == b.a) & (a.b == b.b)
        else:
            ah, bh = a.b, b.b
            if a.rep == "i":  # signed compare: flip the sign bit
                ah = ah ^ np.uint32(_SIGNBIT)
                bh = bh ^ np.uint32(_SIGNBIT)
            lt = (ah < bh) | ((ah == bh) & (a.a < b.a))
            eq = (a.b == b.b) & (a.a == b.a)
        v = {"lt": lt, "le": lt | eq, "eq": eq, "ne": ~eq,
             "gt": ~(lt | eq), "ge": ~lt}[op]
        return W.plain(v, xp)

    def __lt__(self, other):
        return self._cmp(other, "lt")

    def __le__(self, other):
        return self._cmp(other, "le")

    def __gt__(self, other):
        return self._cmp(other, "gt")

    def __ge__(self, other):
        return self._cmp(other, "ge")

    def __eq__(self, other):  # noqa: A003 - array-style equality
        return self._cmp(other, "eq")

    def __ne__(self, other):
        return self._cmp(other, "ne")

    __hash__ = None

    def __and__(self, other):
        a, b = self._lift(other)
        if a.rep == "p":
            return W.plain(a.a & b.a, a.xp)
        return W(a.rep, a.a & b.a, a.b & b.b, a.xp)

    __rand__ = __and__

    def __or__(self, other):
        a, b = self._lift(other)
        if a.rep == "p":
            return W.plain(a.a | b.a, a.xp)
        return W(a.rep, a.a | b.a, a.b | b.b, a.xp)

    __ror__ = __or__

    def __xor__(self, other):
        a, b = self._lift(other)
        if a.rep == "p":
            return W.plain(a.a ^ b.a, a.xp)
        return W(a.rep, a.a ^ b.a, a.b ^ b.b, a.xp)

    __rxor__ = __xor__

    def __invert__(self):
        if self.rep == "p":
            return W.plain(~self.a, self.xp)
        return W(self.rep, ~self.a, ~self.b, self.xp)


def _register_pytree() -> None:
    """Make W a JAX pytree node: pair carriers then cross jit boundaries,
    ride fori_loop carries (the wide constant-extent fused-sweep path) and
    shard_map, with (rep, xp) as static aux data."""
    try:
        from jax import tree_util as _jtu
    except ImportError:  # numpy-only environments never trace W
        return
    _jtu.register_pytree_node(
        W, lambda w: w.tree_flatten(), W.tree_unflatten)


_register_pytree()


# ---- integer pair primitives (uint32 limbs, two's complement) -------------


def _pair_add(a: W, b: W) -> W:
    xp = a.xp
    lo = a.a + b.a
    carry = (lo < a.a).astype(np.uint32)
    hi = a.b + b.b + carry
    return W(a.rep, lo, hi, xp)


def _pair_neg(a: W) -> W:
    xp = a.xp
    lo = (~a.a) + np.uint32(1)
    carry = (lo == 0).astype(np.uint32)  # only -0 wraps
    hi = (~a.b) + carry
    return W(a.rep, lo, hi, xp)


def _mul32_wide(xp, a, b):
    """32x32 -> (lo32, hi32) via 16-bit half products (no widening
    multiply in 32-bit lanes)."""
    a0 = a & np.uint32(0xFFFF)
    a1 = a >> np.uint32(16)
    b0 = b & np.uint32(0xFFFF)
    b1 = b >> np.uint32(16)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = (p00 >> np.uint32(16)) + (p01 & np.uint32(0xFFFF)) \
        + (p10 & np.uint32(0xFFFF))
    lo = (p00 & np.uint32(0xFFFF)) | (mid << np.uint32(16))
    hi = p11 + (p01 >> np.uint32(16)) + (p10 >> np.uint32(16)) \
        + (mid >> np.uint32(16))
    return lo, hi


def _pair_mul(a: W, b: W) -> W:
    """Low 64 bits of the product (two's complement: same for i64/u64)."""
    xp = a.xp
    lo, hi = _mul32_wide(xp, a.a, b.a)
    hi = hi + a.a * b.b + a.b * b.a  # wrapping low-32 products
    return W(a.rep, lo, hi, xp)


def _pair_is_neg(a: W):
    return (a.b & np.uint32(_SIGNBIT)) != 0


def _pair_abs(a: W) -> W:
    neg = _pair_is_neg(a)
    n = _pair_neg(a)
    return _pair_select(a.xp, neg, n, a)


def _pair_select(xp, c, a: W, b: W) -> W:
    return W(a.rep, xp.where(c, a.a, b.a), xp.where(c, a.b, b.b), a.xp)


def _pair_shl(a: W, s) -> W:
    """Left shift by a scalar/array amount s in [0, 64)."""
    xp = a.xp
    s = xp.asarray(s).astype(np.uint32)
    s_ = s & np.uint32(31)
    big = s >= np.uint32(32)
    # shift within limbs by s_ (s_ == 0 handled: hi gets lo >> 32 -> 0 via
    # the two-step (31, 1) split to avoid UB-style full-width shifts)
    lo_s = a.a << s_
    spill = xp.where(s_ == 0, xp.zeros_like(a.a),
                     a.a >> (np.uint32(32) - xp.where(s_ == 0,
                                                      np.uint32(1), s_)))
    hi_s = (a.b << s_) | spill
    lo = xp.where(big, xp.zeros_like(lo_s), lo_s)
    hi = xp.where(big, a.a << s_, hi_s)
    return W(a.rep, lo, hi, xp)


def _pair_shr(a: W, s) -> W:
    """Right shift by amount in [0, 64): logical for u64, arithmetic for
    i64."""
    xp = a.xp
    s = xp.asarray(s).astype(np.uint32)
    s_ = s & np.uint32(31)
    big = s >= np.uint32(32)
    arith = a.rep == "i"
    spill = xp.where(s_ == 0, xp.zeros_like(a.b),
                     a.b << (np.uint32(32) - xp.where(s_ == 0,
                                                      np.uint32(1), s_)))
    lo_small = (a.a >> s_) | spill
    if arith:
        hi_i = a.b.astype(np.int32)
        hi_small = (hi_i >> s_).astype(np.uint32)
        hi_big = (hi_i >> np.uint32(31)).astype(np.uint32)  # sign fill
        lo_big = (hi_i >> s_).astype(np.uint32)
    else:
        hi_small = a.b >> s_
        hi_big = xp.zeros_like(a.b)
        lo_big = a.b >> s_
    lo = xp.where(big, lo_big, lo_small)
    hi = xp.where(big, hi_big, hi_small)
    return W(a.rep, lo, hi, xp)


def _pair_divmod_unsigned(a: W, b: W):
    """Restoring long division on unsigned pairs: 64 statically-unrolled
    steps (exact; used only by programs that divide 64-bit values)."""
    xp = a.xp
    zero = xp.zeros_like(a.a)
    q = W("u", zero, zero, xp)
    r = W("u", zero, zero, xp)
    for i in range(63, -1, -1):
        # r = (r << 1) | bit_i(a)
        bit = ((a.a if i < 32 else a.b) >> np.uint32(i & 31)) & np.uint32(1)
        r = _pair_shl(r, 1)
        r = W("u", r.a | bit, r.b, xp)
        ge = ~(r._cmp(b, "lt").a)
        r = _pair_select(xp, ge, _pair_add(r, _pair_neg(b)), r)
        if i < 32:
            q = W("u", q.a | (ge.astype(np.uint32) << np.uint32(i)), q.b, xp)
        else:
            q = W("u", q.a,
                  q.b | (ge.astype(np.uint32) << np.uint32(i & 31)), xp)
    return q, r


def _pair_floordiv(a: W, b: W) -> W:
    xp = a.xp
    if a.rep == "u":
        q, _ = _pair_divmod_unsigned(a, b)
        return W("u", q.a, q.b, xp)
    qa, ra = _pair_abs(a), _pair_abs(b)
    q, r = _pair_divmod_unsigned(W("u", qa.a, qa.b, xp),
                                 W("u", ra.a, ra.b, xp))
    neg = _pair_is_neg(a) != _pair_is_neg(b)
    nz = (r.a != 0) | (r.b != 0)
    qs = _pair_select(xp, neg, _pair_neg(q), q)
    # floor: negative quotient with remainder rounds away from zero
    qfix = _pair_add(qs, W.from_int_scalar(-1, "i", xp))
    out = _pair_select(xp, neg & nz, qfix, qs)
    return W("i", out.a, out.b, xp)


# ---- double-single (f32 pair) primitives -----------------------------------


def _two_sum(xp, a, b):
    """Error-free sum: s + err == a + b exactly.

    Select-anchored Fast2Sum, NOT Knuth's branch-free form: XLA:CPU's
    algebraic simplifier rewrites sub(add(a, b), a) -> b (observed this
    round: two_sum(1.0, x) lost its error term under jit, degrading every
    downstream DS value to f32 accuracy), which is exactly Knuth's
    `bb = s - a` step.  Routing the anchor through a where() blocks the
    pattern match, and Fast2Sum is exact whenever |anchor| >= |other| —
    guaranteed by the select."""
    s = a + b
    aa = xp.abs(a)
    ab = xp.abs(b)
    big = xp.where(aa >= ab, a, b)
    small = xp.where(aa >= ab, b, a)
    return s, small - (s - big)


_SPLIT_MASK = np.int32(np.uint32(0xFFFFF000).view(np.int32))


def _split(xp, a):
    """Error-free 12|12 split of an f32 into hi + lo with ≤12 significant
    bits each (so all four cross products in _two_prod are exact).

    Uses MANTISSA MASKING (truncate the low 12 stored bits), NOT the
    arithmetic Dekker/Veltkamp split `c - (c - a)`: XLA:CPU's algebraic
    simplifier rewrites that sub-of-sub shape in large fused graphs and
    deletes the low part — every DS product silently degrades to f32
    (found round 3 by the wide fuzzer, seed 77: a two-sweep trapezoid
    jitted as one graph; the same simplifier class already forced the
    select-anchored _two_sum).  Bit ops cannot be algebraically
    rewritten, and unlike Dekker the mask never overflows (SPLIT*a was
    inf for |a| > ~8e34).  Truncation keeps hi at ≤12 significant bits
    and lo = a - hi exact (same-exponent-range subtraction), so the
    two_prod error term is IDENTICAL to the rounding split's.

    0-d values (DS scalar constants) keep the arithmetic form: the scalar
    rejects scalar bitcasts, and constants fold at trace time where no
    graph rewrite applies."""
    if getattr(a, "ndim", 0) == 0 and xp is not np:
        c = _SPLIT * a
        hi = c - (c - a)
        return hi, a - hi
    if xp is np:
        bits = np.asarray(a, np.float32).view(np.int32)
        hi = (bits & _SPLIT_MASK).view(np.float32)
    else:
        import jax

        bits = jax.lax.bitcast_convert_type(a, np.int32)
        hi = jax.lax.bitcast_convert_type(bits & _SPLIT_MASK, np.float32)
    return hi, a - hi


def _two_prod(xp, a, b):
    p = a * b
    a1, a2 = _split(xp, a)
    b1, b2 = _split(xp, b)
    err = ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2
    return p, err


def _ds_norm(xp, hi, lo):
    s, e = _two_sum(xp, hi, lo)
    return s, e


def _quick_two_sum(xp, a, b):
    """two_sum when |a| >= |b| is guaranteed.  Uses the same select-
    anchored form as _two_sum: the classic `b - (s - a)` is the exact
    sub(add(a, b), a) shape XLA:CPU's simplifier deletes (see _two_sum)."""
    return _two_sum(xp, a, b)


def _ds_add(a: W, b: W) -> W:
    """Accurate double-double add (two two_sums + renorm, ~2 ulp)."""
    xp = a.xp
    s1, s2 = _two_sum(xp, a.a, b.a)
    t1, t2 = _two_sum(xp, a.b, b.b)
    s2 = s2 + t1
    s1, s2 = _quick_two_sum(xp, s1, s2)
    s2 = s2 + t2
    hi, lo = _quick_two_sum(xp, s1, s2)
    return W("d", hi, lo, xp)


def _ds_neg(a: W) -> W:
    return W("d", -a.a, -a.b, a.xp)


def _ds_mul(a: W, b: W) -> W:
    xp = a.xp
    p, e = _two_prod(xp, a.a, b.a)
    e = e + (a.a * b.b + a.b * b.a)
    hi, lo = _ds_norm(xp, p, e)
    return W("d", hi, lo, xp)


def _ds_div(a: W, b: W) -> W:
    xp = a.xp
    q1 = a.a / b.a
    # r = a - b*q1 (DS)
    p, e = _two_prod(xp, b.a, q1)
    r = _ds_add(a, W("d", -p, -(e + b.b * q1), xp))
    q2 = (r.a + r.b) / b.a
    hi, lo = _ds_norm(xp, q1, q2)
    # x/0 and x/inf guard (ADVICE r2, extended r3): the refinement turns
    # q1=±inf into NaN via 0*inf (and q1=±0 for infinite b into NaN via
    # inf*0 in two_prod); IEEE semantics want the sign-correct ±inf / ±0
    # the f32 head division already produced
    dz = (b.a == 0.0) | xp.isinf(b.a)
    return W("d", xp.where(dz, q1, hi),
             xp.where(dz, xp.zeros_like(lo), lo), xp)


def _ds_sqrt(a: W) -> W:
    xp = a.xp
    s = xp.sqrt(a.a)
    p, e = _two_prod(xp, s, s)
    # one Newton step in DS: s + (a - s*s)/(2 s)
    d = _ds_add(a, W("d", -p, -e, xp))
    corr = (d.a + d.b) / (2.0 * s)
    hi, lo = _ds_norm(xp, s, corr)
    # sqrt(0) guard: 0/0 -> nan; exact zero stays zero
    z = a.a == 0.0
    return W("d", xp.where(z, xp.zeros_like(hi), hi),
             xp.where(z, xp.zeros_like(lo), lo), xp)


# ---- DS-accurate exp/log (VERDICT r2 #8): argument reduction with a
# three-part ln2 split + DS Taylor/atanh series — ~1e-12 relative on the
# hi+lo value, vs the old f32-accuracy (~1e-7) fallback.  The DS "double"
# carries f32 EXPONENT range, so exp saturates at |x| ≈ 88.7 (f32 inf /
# subnormal territory) — documented in docs/SEMANTICS.md.
_LN2_HI = np.float32(0.693145751953125)        # 0x3F317200: 17-bit mantissa,
#                                                n*_LN2_HI exact for |n|<=2^7
_LN2_LO = np.float32(1.4286068203094633e-06)   # f32(ln2 - _LN2_HI)
_LN2_LO2 = np.float32(
    float(np.log(np.float64(2.0)) - np.float64(_LN2_HI)
          - np.float64(_LN2_LO)))               # residual ~1.6e-13
_INV_LN2 = np.float32(1.4426950408889634)
_EXP_COEF = [1.0 / 479001600.0, 1.0 / 39916800.0, 1.0 / 3628800.0,
             1.0 / 362880.0, 1.0 / 40320.0, 1.0 / 5040.0, 1.0 / 720.0,
             1.0 / 120.0, 1.0 / 24.0, 1.0 / 6.0, 0.5, 1.0]  # 1/12! .. 1/1!


def _exp2_int(xp, n):
    """EXACT 2^n (f32) for integer-valued f32 n — built from the exponent
    bit field.  XLA lowers exp2 as exp(n·ln2), which is NOT exact
    (jnp.exp2(13) returned 8192.004 on XLA:CPU — found by the DS exp
    accuracy test); exact powers of two are load-bearing for the DS
    argument reductions.  n is half-split so each factor's exponent stays
    in [-63, 64] and the product covers the full [-126, 128] range."""
    n1 = xp.floor(n * np.float32(0.5))
    n2 = n - n1

    def one(m):
        bits = ((m.astype(np.int32) + np.int32(127))
                << np.int32(23)).astype(np.int32)
        if xp is np:
            return bits.view(np.float32)
        import jax

        return jax.lax.bitcast_convert_type(bits, np.float32)

    return one(n1), one(n2)


def _ds_exp(a: W) -> W:
    """exp in double-single: n = round(x/ln2); r = x - n*ln2 (three-part
    split, |r| <= ln2/2); degree-12 DS Taylor; scale by exact 2^n."""
    xp = a.xp
    n = xp.round(a.a * _INV_LN2)
    r = _ds_add(a, W("d", -n * _LN2_HI, xp.zeros_like(n), xp))
    r = _ds_add(r, _ds_mul(W("d", n, xp.zeros_like(n), xp),
                           W("d", -_LN2_LO, -_LN2_LO2, xp)))
    acc = W.ds_from_float(_EXP_COEF[0], xp)
    for c in _EXP_COEF[1:]:
        acc = _ds_add(_ds_mul(acc, r), W.ds_from_float(c, xp))
    acc = _ds_add(_ds_mul(acc, r), W.ds_from_float(1.0, xp))
    s1, s2 = _exp2_int(xp, n)  # exact powers of two (see _exp2_int)
    hi = (acc.a * s1) * s2
    lo = (acc.b * s1) * s2
    x0 = a.a
    inf = xp.asarray(np.float32(np.inf))
    zero = xp.zeros_like(hi)
    # range guards: beyond f32 range the DS pair cannot represent the
    # result — saturate like f32 exp (inf / +0); NaN propagates via acc
    hi = xp.where(x0 > np.float32(88.72), inf, hi)
    lo = xp.where(x0 > np.float32(88.72), zero, lo)
    hi = xp.where(x0 < np.float32(-87.33), zero, hi)
    lo = xp.where(x0 < np.float32(-87.33), zero, lo)
    return W("d", hi, lo, xp)


def _ds_log(a: W) -> W:
    """log in double-single: scale by exact 2^-e into [~0.707, 1.414),
    atanh series t = (y-1)/(y+1) to t^15, then add e*ln2 in DS."""
    xp = a.xp
    hi0 = a.a
    e = xp.floor(xp.log2(hi0))  # NaN for hi<0 (propagates), -inf for 0
    # exact 2^-e scaling (XLA's exp2 is exp(x·ln2) — inexact); log2's own
    # rounding can put m one octave off near powers of two, so nudge e
    # until m lands in [sqrt(1/2), sqrt(2)) — the series domain
    e = xp.where(xp.isfinite(e), e, xp.zeros_like(e))

    def scaled(e_):
        s1, s2 = _exp2_int(xp, -e_)
        return (hi0 * s1) * s2, s1, s2

    m, s1, s2 = scaled(e)
    adj_up = m >= np.float32(1.4142135)
    e = xp.where(adj_up, e + np.float32(1.0), e)
    adj_dn = m < np.float32(0.70710677)
    e = xp.where(adj_dn, e - np.float32(1.0), e)
    m, s1, s2 = scaled(e)
    y = W("d", m, (a.b * s1) * s2, xp)
    one = W.ds_from_float(1.0, xp)
    t = _ds_div(_ds_add(y, _ds_neg(one)), _ds_add(y, one))
    t2 = _ds_mul(t, t)
    acc = W.ds_from_float(1.0 / 15.0, xp)
    for c in (13.0, 11.0, 9.0, 7.0, 5.0, 3.0):
        acc = _ds_add(_ds_mul(acc, t2), W.ds_from_float(1.0 / c, xp))
    acc = _ds_add(_ds_mul(acc, t2), one)
    lg = _ds_mul(_ds_mul(acc, t), W.ds_from_float(2.0, xp))
    # + e*ln2: e*_LN2_HI exact (17+8 bits); the tail rides a DS two_prod
    res = _ds_add(lg, W("d", e * _LN2_HI, xp.zeros_like(e), xp))
    res = _ds_add(res, _ds_mul(W("d", e, xp.zeros_like(e), xp),
                               W("d", _LN2_LO, _LN2_LO2, xp)))
    # specials (the e-clamp above suppressed log2's own inf/NaN): 0 ->
    # -inf, negative/NaN -> NaN, +inf -> +inf — IEEE log semantics
    zero_in = hi0 == 0.0
    bad = ~(hi0 >= 0.0)  # negative or NaN
    pinf = hi0 == np.float32(np.inf)
    ninf = xp.asarray(np.float32(-np.inf))
    nan = xp.asarray(np.float32(np.nan))
    hi = xp.where(zero_in, ninf, res.a)
    hi = xp.where(bad, nan, hi)
    hi = xp.where(pinf, -ninf, hi)
    lo = xp.where(zero_in | bad | pinf, xp.zeros_like(res.b), res.b)
    return W("d", hi, lo, xp)


def _pi_bits(bits: int) -> int:
    """π·2^bits as an exact integer, via Machin's formula with integer
    arithmetic (π = 16·atan(1/5) − 4·atan(1/239)); error < ~60 ulp at
    2^-bits, far below the chunk tail this feeds."""
    B = bits + 16  # guard bits against the per-term floor truncation

    def at(q: int) -> int:
        s, k, sign = 0, 0, 1
        while True:
            d = (2 * k + 1) * q ** (2 * k + 1)
            t = (1 << B) // d
            if t == 0:
                return s
            s += sign * t
            sign = -sign
            k += 1

    return (16 * at(5) - 4 * at(239)) >> (B - bits)


def _pio2_chunks(nchunks: int = 6, bits: int = 12) -> list[np.float32]:
    """π/2 as a sum of `nchunks` f32 values of ≤ `bits` significant bits
    each (taken from the top of the running remainder), covering at least
    nchunks·bits bits of π/2.  Each chunk is EXACT in f32 and n·chunk is
    exact for integer |n| ≤ 2^(24-bits) — the Cody–Waite requirement."""
    B = 130
    rem = _pi_bits(B) >> 1  # (π/2)·2^B
    chunks = []
    for _ in range(nchunks):
        top = rem.bit_length() - 1
        keep = max(top - (bits - 1), 0)
        c = (rem >> keep) << keep
        rem -= c
        chunks.append(np.float32(float(c) * 2.0 ** (-B)))
    return chunks


_PIO2 = float(np.pi) / 2.0
# trig reduction tables: 6 × 12-bit chunks of π/2 (72+ bits) and the
# same chunks pre-scaled by 2^11 for the split-quotient products
_PIO2_CHUNKS = _pio2_chunks()
_PIO2_CHUNKS_HI = [np.float32(float(c) * 2048.0) for c in _PIO2_CHUNKS]
# 2/π as a DS pair (hi + lo carries ~49 bits) so the quotient estimate
# n = round(x·2/π) lands on the true nearest multiple
_INV_PIO2 = np.float32(2.0 / np.pi)
_INV_PIO2_LO = np.float32(2.0 / np.pi - float(_INV_PIO2))
# exact-reduction range: n ≤ 2^23 keeps every split product exact
_TRIG_EXACT_LIMIT = np.float32(1.2e7)

# ---- Payne–Hanek quadrant reduction (|x| beyond the Cody–Waite range) ----
# x·(2/π) mod 8 computed EXACTLY in 131-bit fixed point (3 integer bits
# for the mod-8 quadrant, _PH_F = 128 fractional bits) from the f32 limb
# decomposition x = ±m·2^(e-150): the per-limb product m·u needs only the
# 131-bit window u = (2/π)·2^(e-150) mod 8 of a precomputed (2/π)·2^320
# integer, extracted by a data-dependent shift (u32 word selects + vector
# shifts — all plain vector ops; no gather).  m < 2^24 rides _mul32_wide.
# Per-limb truncation < 2^-103 absolute in the mod-8 product; both limbs
# of a DS value are accumulated in INTEGER form before the quadrant is
# extracted, so near-total cancellation between the limbs costs nothing.
_PH_B = 320  # bits of 2/π carried (window reads stay inside for all e)
_PH_F = 128  # fixed-point fractional bits (mod-8 value has 131 bits)


def _ph_two_opi_words() -> list[np.uint32]:
    """floor((2/π)·2^_PH_B) as little-endian u32 words (exact to 1 ulp:
    derived from the integer-Machin π of _pi_bits with 8 guard bits)."""
    t = ((2 << (2 * (_PH_B + 8))) // _pi_bits(_PH_B + 8)) >> 8
    return [np.uint32((t >> (32 * k)) & 0xFFFFFFFF) for k in range(10)]


_PH_WORDS = _ph_two_opi_words()


def _ph_limb131(xp, v):
    """131-bit two's-complement fixed point of v·(2/π) mod 8 for ONE f32
    limb, as five u32 words (little-endian; word 4 holds bits 128..130).
    Exact to < 2^-103 absolute for any finite v; inf/NaN lanes produce
    finite garbage the caller must mask (no FP ops here, so no NaN spam)."""
    if xp is np:
        bits = np.asarray(v, np.float32).view(np.uint32)
    else:
        import jax

        bits = jax.lax.bitcast_convert_type(v, np.uint32)
    e = (bits >> np.uint32(23)) & np.uint32(0xFF)
    m = (bits & np.uint32(0x7FFFFF)) | xp.where(
        e > 0, np.uint32(0x800000), np.uint32(0))
    e_eff = xp.where(e > 0, e, np.uint32(1))  # denormals: m·2^(1-150)
    sign = bits >> np.uint32(31)
    # window start bit of (2/π)·2^_PH_B: u = T >> (_PH_B - _PH_F - (e-150))
    shift = np.uint32(_PH_B - _PH_F + 150) - e_eff
    w = shift >> np.uint32(5)
    b = shift & np.uint32(31)

    def pick(idx):  # T word by small dynamic index (w ∈ [2, 10])
        acc = xp.zeros_like(idx)
        for k in range(2, 10):
            acc = xp.where(idx == np.uint32(k), _PH_WORDS[k], acc)
        return acc

    p = [pick(w + np.uint32(k)) for k in range(6)]
    bm = xp.where(b == 0, np.uint32(1), b)  # avoid the UB-style <<32
    u = []
    for j in range(5):
        hi_part = xp.where(b == 0, xp.zeros_like(p[j]),
                           p[j + 1] << (np.uint32(32) - bm))
        u.append((p[j] >> b) | hi_part)
    u[4] = u[4] & np.uint32(7)
    # R = m·u mod 2^131 (m ≤ 2^24 so every hi word leaves carry room)
    r = [None] * 5
    r[0], ch = _mul32_wide(xp, m, u[0])
    for j in range(1, 4):
        lo, hi = _mul32_wide(xp, m, u[j])
        s = lo + ch
        r[j] = s
        ch = hi + (s < lo).astype(np.uint32)
    lo4, _ = _mul32_wide(xp, m, u[4])
    r[4] = (lo4 + ch) & np.uint32(7)
    # negative limb: two's-complement negate over the 131 bits
    c = sign
    out = []
    for j in range(5):
        nt = xp.where(sign != 0, ~r[j], r[j])
        s = nt + c
        c = (s < c).astype(np.uint32)
        out.append(s)
    out[4] = out[4] & np.uint32(7)
    return out


def _ph_add131(xp, a, b):
    """Sum of two 131-bit word vectors mod 2^131."""
    c = xp.zeros_like(a[0])
    out = []
    for j in range(5):
        s = a[j] + b[j]
        c1 = (s < a[j]).astype(np.uint32)
        s2 = s + c
        c2 = (s2 < s).astype(np.uint32)
        out.append(s2)
        c = c1 + c2  # mutually exclusive: ≤ 1
    out[4] = out[4] & np.uint32(7)
    return out


def _ph_reduce(a: W):
    """Payne–Hanek reduction of a DS value of ANY finite magnitude:
    n = nearest-multiple count mod 8 (integer-valued f32) and
    r = x − n·π/2 in DS, |r| ≤ π/4.  Both f32 limbs are reduced in the
    shared 131-bit integer accumulator, so the remainder keeps full DS
    RELATIVE accuracy unless the true remainder is below ~2^-80 (no
    representable DS pair is known to come near that).  Replaces the old
    f32-accuracy fallback for |x| > _TRIG_EXACT_LIMIT."""
    xp = a.xp
    rr = _ph_add131(xp, _ph_limb131(xp, a.a), _ph_limb131(xp, a.b))
    # round: n = (R + 2^127) >> 128 mod 8; fr = R − n·2^128 ∈ [−1/2, 1/2)
    s3 = rr[3] + np.uint32(0x80000000)
    carry = (s3 < rr[3]).astype(np.uint32)
    n_u = (rr[4] + carry) & np.uint32(7)
    f4 = (rr[4] - n_u) & np.uint32(7)
    neg = (f4 >> np.uint32(2)) & np.uint32(1)  # bit 130 = sign of fr
    cc = neg
    aw = []
    for wrd in (rr[0], rr[1], rr[2], rr[3], f4):
        nt = xp.where(neg != 0, ~wrd, wrd)
        s = nt + cc
        cc = (s < cc).astype(np.uint32)
        aw.append(s)
    # |fr|·2^128 (words 0..3; word 4 is 0 for |fr| ≤ 2^127) → DS, top-down
    # in exact u16-half terms (i32-routed converts, no u32↔f32)
    acc_hi = xp.zeros_like(a.a)
    acc_lo = xp.zeros_like(a.a)
    for j in (3, 2, 1, 0):
        for half, sh in ((aw[j] >> np.uint32(16), 16),
                         (aw[j] & np.uint32(0xFFFF), 0)):
            term = half.astype(np.int32).astype(np.float32) * np.float32(
                2.0 ** (32 * j + sh))
            s_ = _ds_add(W("d", acc_hi, acc_lo, xp),
                         W("d", term, xp.zeros_like(term), xp))
            acc_hi, acc_lo = s_.a, s_.b
    # the 2^-128 rescale is split as 2^-64 on the value and 2^-64 folded
    # into the π/2 constant: a fused 2^-128 scale constant is DENORMAL in
    # f32 and XLA's constant folder flushes it to zero (observed on
    # XLA:CPU: jit(_ph_reduce) returned r ≡ 0 — the fourth EFT-vs-compiler
    # gotcha; eager was exact).  Both halves stay normal at every step.
    sc = np.float32(2.0 ** -64)
    sgn = xp.where(neg != 0, np.float32(-1.0), np.float32(1.0))
    fr64 = W("d", acc_hi * sc * sgn, acc_lo * sc * sgn, xp)  # fr·2^64
    n_f = n_u.astype(np.int32).astype(np.float32)
    # r = fr·(π/2) in DS; constant = (π/2)·2^-64 as a DS pair (normal)
    pio2_64 = _ds_const(xp, float(np.float64(np.pi) / 2.0) * 2.0 ** -64)
    return n_f, _ds_mul(fr64, pio2_64)


def _reduce_pio2(a: W):
    """(n, r): n = round(x·2/π) as an integer-valued f32 and
    r = x − n·π/2 in DS, absolute error ~2^-47, valid for
    |x| ≤ _TRIG_EXACT_LIMIT (n ≤ 2^23).

    Two-level Cody–Waite: n splits as n_hi·2^11 + n_lo (|n_hi| ≤ 2^12,
    |n_lo| ≤ 2^10) so every product against a 12-bit π/2 chunk is EXACT
    in f32 (12+12 ≤ 24 mantissa bits); the 12 products + both input
    limbs are then distilled with an error-free two_sum cascade (three
    passes: the dropped pass-3 residue is < 2^-49).  This subsumes the
    old 3-chunk single-level reduction (exact only to |n| ≤ 2^11,
    |x| ≤ ~3200)."""
    xp = a.xp
    # quotient from a DS product with 2/π: error ~|x|·2^-45 → n is the
    # true nearest multiple up to half-ulp ties (harmless: |r| grows by
    # at most that tie margin)
    p, pe = _two_prod(xp, a.a, _INV_PIO2)
    n = xp.round(p + (pe + (a.a * _INV_PIO2_LO + a.b * _INV_PIO2)))
    n_hi = xp.round(n * np.float32(2.0**-11))
    n_lo = n - n_hi * np.float32(2048.0)  # exact: small-integer diff

    hi = [n_hi * c for c in _PIO2_CHUNKS_HI]  # n_hi·2^11·h_k, exact
    lo = [n_lo * c for c in _PIO2_CHUNKS]     # n_lo·h_k, exact
    # descending magnitude (hi_k ~ x·2^-12(k-1), lo_k ~ 2^10.6·2^-12(k-1),
    # a.b ≤ x·2^-24): ordering only shrinks the collected error terms —
    # two_sum is exact unconditionally
    seq = [hi[0], hi[1], lo[0], hi[2], -a.b, lo[1], hi[3], lo[2],
           hi[4], lo[3], hi[5], lo[4], lo[5]]
    s = a.a
    errs = []
    for t in seq:
        s, e = _two_sum(xp, s, -t)
        errs.append(e)
    s2 = errs[0]
    errs2 = []
    for e in errs[1:]:
        s2, e2 = _two_sum(xp, s2, e)
        errs2.append(e2)
    e3 = errs2[0]
    for e in errs2[1:]:  # plain sum: terms ≤ 2^-33, residue < 2^-49
        e3 = e3 + e
    h, l = _two_sum(xp, s, s2)
    h, l = _ds_norm(xp, h, l + e3)
    return n, W("d", h, l, xp)


# Taylor coefficients on |r| <= pi/4: sin to r^15, cos to r^16
_SIN_COEF = [-1.0 / 1307674368000.0, 1.0 / 6227020800.0,
             -1.0 / 39916800.0, 1.0 / 362880.0, -1.0 / 5040.0,
             1.0 / 120.0, -1.0 / 6.0]
_COS_COEF = [1.0 / 20922789888000.0, -1.0 / 87178291200.0,
             1.0 / 479001600.0, -1.0 / 3628800.0, 1.0 / 40320.0,
             -1.0 / 720.0, 1.0 / 24.0, -0.5]


def _sincos_taylor(r: W) -> tuple[W, W]:
    """(sin r, cos r) by DS Taylor — accurate for |r| ≤ ~0.85 (the
    truncated sin r^17 term is < 8e-17 there); callers with reduced
    arguments (|r| ≤ π/4) and the asin Newton step (|r| ≤ 0.81) both
    qualify."""
    xp = r.xp
    r2 = _ds_mul(r, r)
    s_acc = W.ds_from_float(_SIN_COEF[0], xp)
    for c in _SIN_COEF[1:]:
        s_acc = _ds_add(_ds_mul(s_acc, r2), W.ds_from_float(c, xp))
    # sin(r) = r + r³·(poly) = r·(1 + r²·poly)
    s = _ds_mul(r, _ds_add(_ds_mul(s_acc, r2), W.ds_from_float(1.0, xp)))
    c_acc = W.ds_from_float(_COS_COEF[0], xp)
    for c in _COS_COEF[1:]:
        c_acc = _ds_add(_ds_mul(c_acc, r2), W.ds_from_float(c, xp))
    c_ = _ds_add(_ds_mul(c_acc, r2), W.ds_from_float(1.0, xp))
    return s, c_


def _ds_sincos(a: W) -> tuple[W, W]:
    """(sin, cos) in double-single: n = round(x·2/π), r = x − n·π/2 via
    the two-level Cody–Waite cascade (_reduce_pio2, exact for
    |x| ≤ ~1.2e7) or, beyond that, the integer Payne–Hanek reduction
    (_ph_reduce — DS-accurate over the ENTIRE finite f32-pair range);
    DS Taylor on [-π/4, π/4], quadrant selection by n mod 4."""
    xp = a.xp
    # sanitize the masked-out big/inf lanes BEFORE the Cody–Waite
    # reduction: their quotient n would exceed the exact-product range and
    # overflow the Taylor squares (inf/NaN in discarded lanes still spam
    # warnings and trip NaN-debug modes); NaN inputs keep flowing through
    # (NaN > lim is False, so they take the computed path and propagate)
    big = xp.abs(a.a) > _TRIG_EXACT_LIMIT
    zero = xp.zeros_like(a.a)
    isinf = xp.isinf(a.a)
    a_small = W("d", xp.where(big, zero, a.a), xp.where(big, zero, a.b), xp)
    n_s, r_s = _reduce_pio2(a_small)
    # Payne–Hanek on the raw limbs: integer-only, so inf/NaN lanes yield
    # finite garbage (masked below) and small lanes' results are unused.
    # Cody–Waite keeps the small range: its error is RELATIVE at every
    # magnitude, while the fixed-point path resolves only 2^-103 absolute.
    # 0-d traced values (DS scalar constants fold at trace time) keep the
    # old f32-accuracy fallback: a SCALAR bitcast is avoided
    # _ph_limb131 needs — merged at the end via f32_fallback.
    f32_fallback = getattr(a.a, "ndim", 0) == 0 and xp is not np
    if f32_fallback:
        n, r = n_s, r_s
        x32 = a.a + a.b
    else:
        n_b, r_b = _ph_reduce(a)
        n = xp.where(big, n_b, n_s)
        r = _pair_select(xp, big, r_b, r_s)
    s, c_ = _sincos_taylor(r)
    # quadrant k = n mod 4 (f32 integer arithmetic is exact here)
    k = n - 4.0 * xp.floor(n * 0.25)

    def sel(k0, v_sin, v_cos):
        hi = xp.where(k0 == 0, v_sin.a, xp.where(k0 == 1, v_cos.a,
                      xp.where(k0 == 2, -v_sin.a, -v_cos.a)))
        lo = xp.where(k0 == 0, v_sin.b, xp.where(k0 == 1, v_cos.b,
                      xp.where(k0 == 2, -v_sin.b, -v_cos.b)))
        return W("d", hi, lo, xp)

    sin_v = sel(k, s, c_)
    # cos(x) = sin(x + π/2): shift quadrant by one
    k2 = k + 1.0 - 4.0 * xp.floor((k + 1.0) * 0.25)
    cos_v = sel(k2, s, c_)
    if f32_fallback:
        sin_v = W("d", xp.where(big, xp.sin(x32), sin_v.a),
                  xp.where(big, zero, sin_v.b), xp)
        cos_v = W("d", xp.where(big, xp.cos(x32), cos_v.a),
                  xp.where(big, zero, cos_v.b), xp)
        return sin_v, cos_v
    # sin/cos(±inf) = NaN: the integer reduction produced finite garbage
    # for those lanes (NaN inputs propagated through the small path)
    nan = np.float32(np.nan)
    sin_v = W("d", xp.where(isinf, nan + zero, sin_v.a),
              xp.where(isinf, zero, sin_v.b), xp)
    cos_v = W("d", xp.where(isinf, nan + zero, cos_v.a),
              xp.where(isinf, zero, cos_v.b), xp)
    return sin_v, cos_v


def _ds_tanh(a: W) -> W:
    """tanh via DS exp: (e^{2x} − 1)/(e^{2x} + 1); saturates to ±1 for
    |x| > 20 (e^{2x} overflows f32 range there)."""
    xp = a.xp
    two_x = _ds_add(a, a)
    t = _ds_exp(two_x)
    one = W.ds_from_float(1.0, xp)
    v = _ds_div(_ds_add(t, _ds_neg(one)), _ds_add(t, one))
    big = a.a > np.float32(20.0)
    return W("d", xp.where(big, xp.ones_like(v.a), v.a),
             xp.where(big, xp.zeros_like(v.b), v.b), xp)


def _ds_abs(a: W) -> W:
    """|a| in DS, signbit-aware so abs(-0) = +0 (normalized DS pairs have
    lo = 0 whenever hi = ±0, so flipping both limbs on signbit is exact)."""
    xp = a.xp
    neg = xp.signbit(a.a)
    return _pair_select(xp, neg, _ds_neg(a), a)


def _ds_flip_sign(a: W, flip) -> W:
    return _pair_select(a.xp, flip, _ds_neg(a), a)


def _ds_const(xp, v: float) -> W:
    """DS constant from a python float: hi = f32(v), lo = f32(v - hi)."""
    hi = np.float32(v)
    lo = np.float32(float(np.float64(v) - np.float64(hi)))
    return W("d", xp.asarray(hi), xp.asarray(lo), xp)


def _ds_expm1(a: W) -> W:
    """expm1 in double-single, full RELATIVE accuracy down to tiny x:
    |x| < 0.5 reuses the exp Taylor WITHOUT the leading 1 (the series'
    leading term is x itself, so no cancellation); larger |x| pays the
    benign exp(x) - 1 cancellation (bounded by a factor ~2)."""
    xp = a.xp
    acc = W.ds_from_float(_EXP_COEF[0], xp)
    for c in _EXP_COEF[1:]:  # ends at 1/1!: acc*x = x + x^2/2! + ...
        acc = _ds_add(_ds_mul(acc, a), W.ds_from_float(c, xp))
    small = _ds_mul(acc, a)
    big = _ds_add(_ds_exp(a), W.ds_from_float(-1.0, xp))
    return _pair_select(xp, xp.abs(a.a) < np.float32(0.5), small, big)


def _ds_scale_pow2(a: W, s: float) -> W:
    """Multiply a DS value by an exact power of two LIMB-WISE — _ds_mul's
    Dekker split overflows f32 for |hi| > ~8e34 (SPLIT*hi = inf), which a
    plain per-limb scale avoids (power-of-two scaling is error-free)."""
    xp = a.xp
    s32 = np.float32(s)
    return W("d", a.a * s32, a.b * s32, xp)


def _ds_log1p(a: W) -> W:
    """log1p in double-single.  |x| >= 0.25: DS log of the two_sum pair.
    Smaller |x|: the pair (1, x) only carries x to SINGLE precision (lo
    is one f32), so go direct — atanh series on t = x/(2+x), which keeps
    x's full DS relative precision (same series as _ds_log)."""
    xp = a.xp
    one = W.ds_from_float(1.0, xp)
    big = _ds_log(_ds_add(one, a))
    t = _ds_div(a, _ds_add(W.ds_from_float(2.0, xp), a))
    t2 = _ds_mul(t, t)
    acc = W.ds_from_float(1.0 / 15.0, xp)
    for c in (13.0, 11.0, 9.0, 7.0, 5.0, 3.0):
        acc = _ds_add(_ds_mul(acc, t2), W.ds_from_float(1.0 / c, xp))
    small = _ds_scale_pow2(
        _ds_mul(t, _ds_add(_ds_mul(acc, t2), one)), 2.0)
    return _pair_select(xp, xp.abs(a.a) < np.float32(0.25), small, big)


def _ds_sinh(a: W) -> W:
    """sinh via DS expm1 (cancellation-free at small x):
    e^x - e^-x = em + em/(em+1) where em = expm1(x)."""
    xp = a.xp
    # compute on |x| and flip: for x < -1 the pair em = (-1, e^x) only
    # carries e^x to single precision, polluting the dominant em/(em+1)
    # term; on |x| both terms keep full DS relative precision
    az = _ds_abs(a)
    em = _ds_expm1(az)
    den = _ds_add(em, W.ds_from_float(1.0, xp))
    v = _ds_scale_pow2(_ds_add(em, _ds_div(em, den)), 0.5)
    # |x| > 30: e^{-|x|} < 9e-27 is invisible at DS precision, and the
    # em/(em+1) division's Dekker split would overflow f32 past e^~80 —
    # use e^{|x|}/2 with limb-wise scaling (inf-clean: _ds_exp saturates
    # to (inf, 0) itself)
    halfexp = _ds_scale_pow2(_ds_exp(az), 0.5)
    v = _pair_select(xp, az.a > np.float32(30.0), halfexp, v)
    return _ds_flip_sign(v, xp.signbit(a.a))


def _ds_cosh(a: W) -> W:
    """cosh = (t + 1/t)/2 with t = e^{|x|} (no cancellation; t >= 1)."""
    xp = a.xp
    t = _ds_exp(_ds_abs(a))
    one = W.ds_from_float(1.0, xp)
    v = _ds_scale_pow2(_ds_add(t, _ds_div(one, t)), 0.5)
    # |x| > 30: drop the e^{-|x|} term (< 9e-27 relative; the 1/t
    # division's Dekker split would overflow f32 past e^~80)
    halfexp = _ds_scale_pow2(t, 0.5)
    return _pair_select(xp, xp.abs(a.a) > np.float32(30.0), halfexp, v)


def _ds_log10(a: W) -> W:
    return _ds_mul(_ds_log(a), _ds_const(a.xp, 1.0 / float(np.log(10.0))))


# atan Taylor coefficients (-1)^k/(2k+1), k = 10..1; the constant 1 term
# is applied in Horner's last step.  After two half-angle reductions the
# series argument is <= tan(pi/8)/~2.08 ~= 0.199, so the truncated k=11
# term is ~1e-16 relative — below DS precision.
_ATAN_COEF = [1.0 / 21.0, -1.0 / 19.0, 1.0 / 17.0, -1.0 / 15.0,
              1.0 / 13.0, -1.0 / 11.0, 1.0 / 9.0, -1.0 / 7.0,
              1.0 / 5.0, -1.0 / 3.0]


def _ds_atan(a: W) -> W:
    """atan in double-single: reduce |x| <= 1 via the reciprocal identity,
    two half-angle steps z <- z/(1 + sqrt(1+z^2)), degree-21 Taylor, undo
    (x4, pi/2 complement, sign).  +-inf lands on the reciprocal branch as
    z = 0 -> +-pi/2 exactly; NaN propagates through the seed compare."""
    xp = a.xp
    one = W.ds_from_float(1.0, xp)
    az = _ds_abs(a)
    inv = az.a > np.float32(1.0)
    rec = _ds_div(one, az)
    z = _pair_select(xp, inv, rec, az)
    for _ in range(2):
        z = _ds_div(z, _ds_add(one, _ds_sqrt(_ds_add(one, _ds_mul(z, z)))))
    z2 = _ds_mul(z, z)
    acc = W.ds_from_float(_ATAN_COEF[0], xp)
    for c in _ATAN_COEF[1:]:
        acc = _ds_add(_ds_mul(acc, z2), W.ds_from_float(c, xp))
    r = _ds_mul(z, _ds_add(_ds_mul(acc, z2), one))
    r = _ds_mul(r, W.ds_from_float(4.0, xp))
    comp = _ds_add(_ds_const(xp, _PIO2), _ds_neg(r))
    res = _pair_select(xp, inv, comp, r)
    return _ds_flip_sign(res, xp.signbit(a.a))


def _ds_asin_newton(y: W) -> W:
    """One DS Newton step on sin(t) = y from the f32 arcsin seed; the
    caller guarantees |y| <~ 0.72 so cos(t) >= ~0.69 (well-conditioned:
    residual error ~ seed_err^2 * tan(t) ~ 1e-14)."""
    from . import mathfns

    xp = y.xp
    # composed f32 asin seed (interp/mathfns.py)
    t0 = mathfns.f32_asin(xp, xp.minimum(xp.maximum(
        y.a + y.b, np.float32(-1.0)), np.float32(1.0)))
    T0 = W("d", t0, xp.zeros_like(t0), xp)
    # |T0| <= asin(0.72) ~= 0.81: inside the direct Taylor domain, so
    # skip the full pi/2 reduction (pure overhead here)
    s, c = _sincos_taylor(T0)
    return _ds_add(T0, _ds_div(_ds_add(y, _ds_neg(s)), c))


def _ds_asin(a: W) -> W:
    """asin in double-single: Newton-on-sin for |x| <= 0.7; the
    complementary identity asin(x) = pi/2 - asin(sqrt((1-x)(1+x))) near
    +-1 (the complement w <= 0.72 lands on the Newton branch).  |x| > 1
    gives NaN via the negative radicand."""
    xp = a.xp
    one = W.ds_from_float(1.0, xp)
    az = _ds_abs(a)
    r_small = _ds_asin_newton(az)
    w = _ds_sqrt(_ds_mul(_ds_add(one, _ds_neg(az)), _ds_add(one, az)))
    r_comp = _ds_add(_ds_const(xp, _PIO2), _ds_neg(_ds_asin_newton(w)))
    res = _pair_select(xp, az.a > np.float32(0.7), r_comp, r_small)
    # NaN for |x| > 1: the radicand is negative -> w = NaN on the
    # complement branch (selected there); make it explicit for az.a > 1
    nan = xp.asarray(np.float32(np.nan))
    bad = az.a > np.float32(1.0)
    res = W("d", xp.where(bad, nan, res.a),
            xp.where(bad, xp.zeros_like(res.b), res.b), xp)
    return _ds_flip_sign(res, xp.signbit(a.a))


def _ds_acos(a: W) -> W:
    """acos = pi/2 - asin in DS (DS adds are error-free transforms, so
    the cancellation near x = 1 reconstructs asin's complement branch
    exactly)."""
    return _ds_add(_ds_const(a.xp, _PIO2), _ds_neg(_ds_asin(a)))


def _ds_atan2(y: W, x: W) -> W:
    """atan2 in double-single with IEEE quadrant/zero/inf fixups matching
    numpy and C (atan2(+-0, -x) = +-pi, inf/inf quadrant diagonals)."""
    xp = y.xp
    q = _ds_atan(_ds_div(y, x))
    pi_w = _ds_const(xp, float(np.pi))
    sgn_y = xp.signbit(y.a)
    adj = _ds_flip_sign(pi_w, sgn_y)
    r = _pair_select(xp, xp.signbit(x.a), _ds_add(q, adj), q)
    # x = +-0: +-pi/2 by the sign of y (y = 0 handled below)
    pio2 = _ds_const(xp, _PIO2)
    r = _pair_select(xp, x.a == 0.0, _ds_flip_sign(pio2, sgn_y), r)
    # y = +-0: magnitude pi when x's SIGN BIT is set (x < 0 or -0), else 0
    zero_mag = _pair_select(xp, xp.signbit(x.a), pi_w,
                            W("d", xp.zeros_like(r.a),
                              xp.zeros_like(r.b), xp))
    r = _pair_select(xp, y.a == 0.0, _ds_flip_sign(zero_mag, sgn_y), r)
    # inf/inf diagonals: +-pi/4 (x > 0) / +-3pi/4 (x < 0)
    both_inf = xp.isinf(y.a) & xp.isinf(x.a)
    diag = _pair_select(xp, xp.signbit(x.a),
                        _ds_const(xp, 3.0 * float(np.pi) / 4.0),
                        _ds_const(xp, float(np.pi) / 4.0))
    r = _pair_select(xp, both_inf, _ds_flip_sign(diag, sgn_y), r)
    return r


def _ds_hypot(a: W, b: W) -> W:
    """hypot in double-single: scale by m = max(|hi|) so the squares stay
    in f32 range, sqrt(za^2 + zb^2) * m; 0 and inf fixups."""
    xp = a.xp
    m = xp.maximum(xp.abs(a.a), xp.abs(b.a))
    # scale both by the EXACT power of two 2^-e (limb-wise — error-free,
    # and immune to the Dekker-split f32 overflow a division by m would
    # hit for m > ~8e34); operands land in [0.5, 2]
    e = xp.floor(xp.log2(m))
    e = xp.where(xp.isfinite(e), e, xp.zeros_like(e))
    s1, s2 = _exp2_int(xp, -e)

    def scale(v: W, f1, f2) -> W:
        return W("d", (v.a * f1) * f2, (v.b * f1) * f2, xp)

    za = scale(a, s1, s2)
    zb = scale(b, s1, s2)
    r = _ds_sqrt(_ds_add(_ds_mul(za, za), _ds_mul(zb, zb)))
    t1, t2 = _exp2_int(xp, e)
    res = scale(r, t1, t2)
    zero = m == 0.0
    inf = xp.isinf(a.a) | xp.isinf(b.a)  # IEEE: hypot(inf, NaN) = inf
    nan_in = (xp.isnan(a.a) | xp.isnan(b.a)) & ~inf
    hi = xp.where(zero, xp.zeros_like(res.a), res.a)
    hi = xp.where(inf, xp.asarray(np.float32(np.inf)), hi)
    hi = xp.where(nan_in, xp.asarray(np.float32(np.nan)), hi)
    lo = xp.where(zero | inf | nan_in, xp.zeros_like(res.b), res.b)
    return W("d", hi, lo, xp)


def _ds_lt(a: W, b: W):
    return (a.a < b.a) | ((a.a == b.a) & (a.b < b.b))


def _ds_trunc(a: W) -> W:
    xp = a.xp
    th = xp.trunc(a.a)
    tl = xp.trunc(a.b)
    # when hi is integral the fraction lives in lo; otherwise lo's sign
    # can still carry the value across the integer boundary of trunc(hi)
    # (e.g. hi = n + eps, lo < -eps -> true trunc is n-1), so correct by
    # one toward the true value afterwards
    frac_in_lo = th == a.a
    hi2, lo2 = _two_sum(xp, th, xp.where(frac_in_lo, tl,
                                         xp.zeros_like(tl)))
    t = W("d", hi2, lo2, xp)
    one = W("d", xp.asarray(np.float32(1.0)),
            xp.asarray(np.float32(0.0)), xp)
    pos = a.a >= 0
    down = _ds_add(t, _ds_neg(one))
    up = _ds_add(t, one)
    # candidate is within 1 of the true trunc; one conditional step fixes
    # it: positive x wants floor (t>x -> down, t+1<=x -> up), negative
    # wants ceil (t<x -> up, t-1>=x -> down)
    step_down = (pos & _ds_lt(a, t)) | ((~pos) & ~_ds_lt(down, a))
    step_up = ((~pos) & _ds_lt(t, a)) | (pos & ~_ds_lt(a, up))
    hi3 = xp.where(step_down, down.a, xp.where(step_up, up.a, t.a))
    lo3 = xp.where(step_down, down.b, xp.where(step_up, up.b, t.b))
    return W("d", hi3, lo3, xp)


def _pair_to_ds(a: W) -> W:
    """64-bit pair -> double-single, accurate to the DS ulp (~2^-48 rel):
    the magnitude is decomposed into four EXACT <=16-bit f32 components
    (each chunk*2^k is exactly representable) accumulated with the
    accurate DS add."""
    xp = a.xp
    neg = _pair_is_neg(a) if a.rep == "i" else None
    m = _pair_abs(a) if a.rep == "i" else a
    c16 = np.uint32(0xFFFF)

    def _chunk_f32(u):
        # 16-bit chunk -> f32 via int32: no u32<->f32 casts
        # (hardware-verified failure mode); the chunk fits i32 exactly
        return u.astype(np.int32).astype(np.float32)

    parts = [
        (_chunk_f32(m.b >> np.uint32(16)), np.float32(2.0 ** 48)),
        (_chunk_f32(m.b & c16), np.float32(2.0 ** 32)),
        (_chunk_f32(m.a >> np.uint32(16)), np.float32(2.0 ** 16)),
        (_chunk_f32(m.a & c16), np.float32(1.0)),
    ]
    acc = W("d", parts[0][0] * parts[0][1],
            xp.zeros_like(parts[0][0]), xp)
    for chunk, scale in parts[1:]:
        acc = _ds_add(acc, W("d", chunk * scale,
                             xp.zeros_like(chunk), xp))
    if neg is not None:
        acc = W("d", xp.where(neg, -acc.a, acc.a),
                xp.where(neg, -acc.b, acc.b), xp)
    return acc


def _f32_int_to_u32(xp, f):
    """Exact u32 of an integral f32 value in [0, 2^32): split at 2^16 so
    each chunk fits int32 (no f32<->u32 casts; f32->i32 of
    sub-2^16 chunks is exact)."""
    two16 = np.float32(65536.0)
    top = xp.floor(f / two16)
    bot = f - top * two16  # exact (common ulp)
    return ((top.astype(np.int32).astype(np.uint32) << np.uint32(16))
            + bot.astype(np.int32).astype(np.uint32))


def _ds_to_pair(a: W, rep: str) -> W:
    """trunc(double) -> 64-bit pair.  The integral DS magnitude is split
    exactly: q = floor(m / 2^32) and r = m - q*2^32 in DS (power-of-two
    scaling and the subtraction are error-free), then each integral DS
    component converts exactly through 16-bit chunks."""
    xp = a.xp
    t = _ds_trunc(a)
    neg = (t.a < 0) | ((t.a == 0) & (t.b < 0))
    m = W("d", xp.where(neg, -t.a, t.a), xp.where(neg, -t.b, t.b), xp)
    inv32 = np.float32(2.0 ** -32)
    two32 = np.float32(4294967296.0)
    q = _ds_trunc(W("d", m.a * inv32, m.b * inv32, xp))
    r = _ds_add(m, W("d", -(q.a * two32), -(q.b * two32), xp))
    # r in [0, 2^32): components are integral f32s summing exactly to r
    lo = _f32_int_to_u32(xp, r.a) + r.b.astype(np.int32).astype(np.uint32)
    hi = _f32_int_to_u32(xp, q.a) + q.b.astype(np.int32).astype(np.uint32)
    out = W(rep, lo, hi, xp)
    return _pair_select(xp, neg, _pair_neg(out), out)


def _plain_to_pair(v: W, rep: str) -> W:
    """Widen a plain 32-bit (or narrower) array into a limb pair:
    sign-extend signed sources, zero-extend unsigned/bool."""
    xp = v.xp
    a = v.a
    if a.dtype == np.bool_:
        a = a.astype(np.uint32)
    if np.dtype(a.dtype).kind == "f":
        return _ds_to_pair(W("d", a.astype(np.float32),
                             xp.zeros_like(a, np.float32), xp), rep)
    signed_src = np.dtype(a.dtype).kind == "i"
    lo = a.astype(np.int32).astype(np.uint32) if signed_src \
        else a.astype(np.uint32)
    if signed_src:
        hi = (a.astype(np.int32) >> np.uint32(31)).astype(np.uint32)
    else:
        hi = xp.zeros_like(lo)
    return W(rep, lo, hi, xp)


# ---- the xp shim ------------------------------------------------------------


class WideXP:
    """numpy-like namespace over W values, backed by `base` (numpy or
    jax.numpy).  Exposes exactly the function surface the shared evaluator
    uses."""

    int64 = np.int64
    uint64 = np.uint64
    float64 = np.float64
    int32 = np.int32
    uint32 = np.uint32
    float32 = np.float32
    float16 = np.float16

    def __init__(self, base):
        self.base = base

    # -- construction / conversion
    def asarray(self, v, dtype=None):
        if isinstance(v, W):
            return v.astype(dtype) if dtype is not None else v
        if dtype is not None and np.dtype(dtype) in (np.dtype(np.int64),
                                                     np.dtype(np.uint64)):
            if isinstance(v, (int, np.integer)):
                rep = "i" if np.dtype(dtype) == np.dtype(np.int64) else "u"
                return W.from_int_scalar(int(v), rep, self.base)
            return W.plain(self.base.asarray(v), self.base).astype(dtype)
        if dtype is not None and np.dtype(dtype) == np.dtype(np.float64):
            if isinstance(v, (float, int, np.floating, np.integer)):
                return W.ds_from_float(float(v), self.base)
            return W.plain(self.base.asarray(v), self.base).astype(dtype)
        x = self.base.asarray(v) if dtype is None \
            else self.base.asarray(v, dtype)
        return W.plain(x, self.base)

    def zeros_like(self, v):
        if isinstance(v, W):
            return v.map(self.base.zeros_like)
        return W.plain(self.base.zeros_like(v), self.base)

    def _plain(self, v):
        return v.a if isinstance(v, W) and v.rep == "p" else v

    # -- selection
    def where(self, c, a, b):
        c = self._plain(c)
        if not isinstance(a, W):
            a = self.asarray(a)
        a, b = a._lift(b)
        if a.rep == "p":
            return W.plain(self.base.where(c, a.a, b.a), self.base)
        return W(a.rep, self.base.where(c, a.a, b.a),
                 self.base.where(c, a.b, b.b), self.base)

    def _minmax_nan(self, sel: W, a2: W, b2: W) -> W:
        """NaN propagation for DS min/max (ADVICE r2): numpy's
        minimum/maximum return NaN when either operand is NaN, but a
        comparison-select drops it — patch the selected value."""
        isnan = (a2.a != a2.a) | (b2.a != b2.a)
        nan_hi = self.base.where(isnan, a2.a + b2.a, sel.a)
        nan_lo = self.base.where(isnan, self.base.zeros_like(sel.b), sel.b)
        return W("d", nan_hi, nan_lo, self.base)

    def minimum(self, a, b):
        if not isinstance(a, W):
            a = self.asarray(a)
        a2, b2 = a._lift(b)
        if a2.rep == "p":
            return W.plain(self.base.minimum(a2.a, b2.a), self.base)
        sel = self.where(a2._cmp(b2, "le"), a2, b2)
        return self._minmax_nan(sel, a2, b2) if a2.rep == "d" else sel

    def maximum(self, a, b):
        if not isinstance(a, W):
            a = self.asarray(a)
        a2, b2 = a._lift(b)
        if a2.rep == "p":
            return W.plain(self.base.maximum(a2.a, b2.a), self.base)
        sel = self.where(a2._cmp(b2, "ge"), a2, b2)
        return self._minmax_nan(sel, a2, b2) if a2.rep == "d" else sel

    def abs(self, a):
        if a.rep == "p":
            return W.plain(self.base.abs(a.a), self.base)
        if a.rep == "d":
            neg = a.a < 0
            return W("d", self.base.where(neg, -a.a, a.a),
                     self.base.where(neg, -a.b, a.b), self.base)
        if a.rep == "u":
            return a
        return _pair_abs(a)

    # -- integer ops the evaluator calls
    def floor_divide(self, a, b):
        a, b = a._lift(b) if isinstance(a, W) else self.asarray(a)._lift(b)
        if a.rep == "p":
            return W.plain(self.base.floor_divide(a.a, b.a), self.base)
        if a.rep == "d":
            return _ds_trunc(_ds_div(a, b))  # only via _c_div on ints
        return _pair_floordiv(a, b)

    def left_shift(self, a, s):
        if a.rep == "p":
            return W.plain(self.base.left_shift(a.a, self._plain(s)),
                           self.base)
        sv = s.a if isinstance(s, W) else s
        return _pair_shl(a, sv)

    def right_shift(self, a, s):
        if a.rep == "p":
            return W.plain(self.base.right_shift(a.a, self._plain(s)),
                           self.base)
        sv = s.a if isinstance(s, W) else s
        return _pair_shr(a, sv)

    def bitwise_and(self, a, b):
        if not isinstance(a, W):
            a = self.asarray(a)
        return a & b

    def bitwise_or(self, a, b):
        if not isinstance(a, W):
            a = self.asarray(a)
        return a | b

    def bitwise_xor(self, a, b):
        if not isinstance(a, W):
            a = self.asarray(a)
        return a ^ b

    def bitwise_not(self, a):
        return ~a

    # -- float ops
    def sqrt(self, a):
        if a.rep == "d":
            return _ds_sqrt(a)
        return W.plain(self.base.sqrt(a.a), self.base)

    def trunc(self, a):
        if a.rep == "d":
            return _ds_trunc(a)
        return W.plain(self.base.trunc(a.a), self.base)

    def floor(self, a):
        if a.rep == "d":
            t = _ds_trunc(a)
            gt = _ds_lt(a, t)  # trunc > x happens only for x < 0
            one = W.ds_from_float(1.0, self.base)
            return self.where(W.plain(gt, self.base),
                              _ds_add(t, _ds_neg(one)), t)
        return W.plain(self.base.floor(a.a), self.base)

    def ceil(self, a):
        if a.rep == "d":
            t = _ds_trunc(a)
            lt = _ds_lt(t, a)
            return self.where(W.plain(lt, self.base),
                              _ds_add(t, W.ds_from_float(1.0, self.base)), t)
        return W.plain(self.base.ceil(a.a), self.base)

    def fmod(self, a, b):
        a, b = a._lift(b)
        if a.rep == "p":
            return W.plain(self.base.fmod(a.a, b.a), self.base)
        # DS fmod: a - trunc(a/b)*b (documented: large quotients lose
        # precision, as any emulated f64 does)
        q = _ds_trunc(_ds_div(a, b))
        return _ds_add(a, _ds_neg(_ds_mul(q, b)))

    def exp(self, a):
        if isinstance(a, W) and a.rep == "d":
            return _ds_exp(a)
        return self._plain_fn("exp", a)

    def log(self, a):
        if isinstance(a, W) and a.rep == "d":
            return _ds_log(a)
        return self._plain_fn("log", a)

    def exp2(self, a):
        if isinstance(a, W) and a.rep == "d":
            return _ds_exp(_ds_mul(a, W("d", _LN2_HI, _LN2_LO, self.base)))
        return self._plain_fn("exp2", a)

    def log2(self, a):
        if isinstance(a, W) and a.rep == "d":
            inv_hi = np.float32(_INV_LN2)
            inv_lo = np.float32(
                float(1.0 / np.log(np.float64(2.0))
                      - np.float64(inv_hi)))
            return _ds_mul(_ds_log(a), W("d", inv_hi, inv_lo, self.base))
        return self._plain_fn("log2", a)

    def sin(self, a):
        if isinstance(a, W) and a.rep == "d":
            return _ds_sincos(a)[0]
        return self._plain_fn("sin", a)

    def cos(self, a):
        if isinstance(a, W) and a.rep == "d":
            return _ds_sincos(a)[1]
        return self._plain_fn("cos", a)

    def tan(self, a):
        if isinstance(a, W) and a.rep == "d":
            s, c = _ds_sincos(a)
            return _ds_div(s, c)
        return self._plain_fn("tan", a)

    def tanh(self, a):
        if isinstance(a, W) and a.rep == "d":
            return _ds_tanh(a)
        return self._plain_fn("tanh", a)

    # round-3 continuation C-math surface: DS-accurate single-arg fns
    # (the __getattr__ f32 fallback would lose the lo limb).  rep-"p"
    # (narrow f32) values use the COMPOSED implementations from
    # interp/mathfns — the same formula on every platform.

    def _p_or_ds(self, a, ds_fn, composed):
        from . import mathfns

        if isinstance(a, W) and a.rep == "d":
            return ds_fn(a)
        v = a.a if isinstance(a, W) else a
        return W.plain(getattr(mathfns, composed)(self.base, v), self.base)

    def arctan(self, a):
        return self._p_or_ds(a, _ds_atan, "f32_atan")

    def arcsin(self, a):
        return self._p_or_ds(a, _ds_asin, "f32_asin")

    def arccos(self, a):
        return self._p_or_ds(a, _ds_acos, "f32_acos")

    def sinh(self, a):
        return self._p_or_ds(a, _ds_sinh, "f32_sinh")

    def cosh(self, a):
        return self._p_or_ds(a, _ds_cosh, "f32_cosh")

    def expm1(self, a):
        return self._p_or_ds(a, _ds_expm1, "f32_expm1")

    def log10(self, a):
        if isinstance(a, W) and a.rep == "d":
            return _ds_log10(a)
        return self._plain_fn("log10", a)

    def log1p(self, a):
        if isinstance(a, W) and a.rep == "d":
            return _ds_log1p(a)
        return self._plain_fn("log1p", a)

    # two-arg fns: the __getattr__ fallback cannot lift the second W arg

    def arctan2(self, a, b):
        from . import mathfns

        a2, b2 = a._lift(b)
        if a2.rep == "d":
            return _ds_atan2(a2, b2)
        return W.plain(mathfns.f32_atan2(self.base, a2.a, b2.a), self.base)

    def copysign(self, a, b):
        a2, b2 = a._lift(b)
        if a2.rep == "d":
            # exact: flip both limbs when the sign bits differ; hi via
            # the native copysign so +-0 magnitudes keep b's sign
            flip = self.base.signbit(a2.a) != self.base.signbit(b2.a)
            return _ds_flip_sign(a2, flip)
        return W.plain(self.base.copysign(a2.a, b2.a), self.base)

    def hypot(self, a, b):
        a2, b2 = a._lift(b)
        if a2.rep == "d":
            return _ds_hypot(a2, b2)
        return W.plain(self.base.hypot(a2.a, b2.a), self.base)

    def power(self, a, b):
        if a.rep == "d" or (isinstance(b, W) and b.rep == "d"):
            a2, b2 = a._lift(b)
            # positive base: DS-accurate exp(b*log(a)); else (negative
            # base integer exponents, 0^y specials) fall back to f32 pow
            # on the hi+lo value — matching the old documented behavior
            v_ds = _ds_exp(_ds_mul(b2, _ds_log(a2)))
            v_f = self.base.power(a2.a + a2.b, b2.a + b2.b)
            pos = a2.a > 0
            hi = self.base.where(pos, v_ds.a, v_f)
            lo = self.base.where(pos, v_ds.b, self.base.zeros_like(v_f))
            # IEEE pow(x, 0) = 1 for EVERY x (inf and NaN included) —
            # the exp(0·log(x)) route would give exp(NaN) for x=inf/NaN
            exp0 = (b2.a == 0) & (b2.b == 0)
            hi = self.base.where(exp0, self.base.ones_like(hi), hi)
            lo = self.base.where(exp0, self.base.zeros_like(lo), lo)
            return W("d", hi, lo, self.base)
        return W.plain(self.base.power(a.a, self._plain(b)), self.base)

    def _plain_fn(self, name, a, *args):
        fn = getattr(self.base, name)
        if isinstance(a, W):
            return W.plain(fn(a.a, *args), self.base)
        return W.plain(fn(a, *args), self.base)

    def __getattr__(self, name):
        # transcendental fallbacks (sin/cos/tan/tanh/...): f32 accuracy
        # on the hi component for DS values — documented limitation
        # (exp/log/exp2/log2/sqrt are DS-accurate methods above)
        fn = getattr(self.base, name)

        def wrapped(a, *args):
            if isinstance(a, W):
                if a.rep == "d":
                    v = fn(a.a + a.b, *args)
                    return W("d", v, self.base.zeros_like(v), self.base)
                return W.plain(fn(a.a, *args), self.base)
            return W.plain(fn(a, *args), self.base)

        return wrapped


# ---- host-side plane split/merge -------------------------------------------


def split_planes(x: np.ndarray):
    """Host: one 64-bit numpy array -> (lo, hi) int32-container planes
    (uint32 reinterpreted as int32 for transfer neutrality)."""
    if x.dtype == np.float64:
        hi = x.astype(np.float32)
        lo = (x - hi.astype(np.float64)).astype(np.float32)
        return lo, hi
    u = x.astype(np.uint64)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (u >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def merge_planes(lo, hi, dtype) -> np.ndarray:
    """Host: (lo, hi) planes -> one 64-bit numpy array."""
    lo = np.asarray(lo)
    hi = np.asarray(hi)
    if np.dtype(dtype) == np.float64:
        return hi.astype(np.float64) + lo.astype(np.float64)
    u = (hi.astype(np.uint64) << np.uint64(32)) \
        | lo.astype(np.uint64)
    return u.astype(dtype)


def is_wide(t) -> bool:
    """True for DSL types that need the pair carrier on the mesh path."""
    return (t.is_int and t.width > 32) or (t.is_float and t.width == 64)


def rep_for(t) -> str:
    """Pair rep tag for a wide DSL type."""
    if t.is_float:
        return "d"
    return "i" if t.is_signed else "u"


def slice_dim(x, start, stop, axis):
    """lax.slice_in_dim that maps over pair carriers (shared by the mesh
    layer and the hybrid rim path — keep the W layout logic in ONE
    place)."""
    import jax

    if isinstance(x, W):
        return x.map(
            lambda p: jax.lax.slice_in_dim(p, start, stop, axis=axis))
    return jax.lax.slice_in_dim(x, start, stop, axis=axis)


def wrap_planes(t, p_lo, p_hi, xp) -> W:
    """(lo, hi) storage planes -> W value for DSL type t (ints: limbs;
    double: (hi, lo) double-single components)."""
    if t.is_float:
        return W("d", p_hi, p_lo, xp)
    return W(rep_for(t), p_lo.astype(np.uint32), p_hi.astype(np.uint32), xp)


def unwrap_planes(t, w: W):
    """W value -> (lo, hi) storage planes for DSL type t."""
    if t.is_float:
        return w.b, w.a
    return w.a, w.b


def program_is_wide(program) -> bool:
    """True when USER-declared tensors or params need pair carriers.
    Synthetic (compiler-generated) int64 partial sums in otherwise-32-bit
    programs keep the documented int32 behavior and do NOT trigger the
    wide path."""
    return any(is_wide(t.type) and not t.synthetic
               for t in program.tensors.values()) \
        or any(is_wide(p.type) for p in program.params.values())
