"""Arbitrary-width integers up to 128 bits as limb vectors — the oracle /
XLA wide-int engine above 64 bits.

Reference parity (SURVEY.md §2.4, reconstructed — empty mount): the
reference's `ap_int<N>`/`ap_uint<N>` are arbitrary-width.  This compiler
supports 1..64-bit ints everywhere (32-bit, and 33..64 as native int64 on
the XLA path or pairs on the mesh — interp/wide64.py) and 65..128-bit ints
on the NumPy-oracle and XLA backends (whole grid and host tiles) via FOUR
32-bit limbs (this module); the mesh rejects >64 loudly (quad-plane
carriers are future work; the typed error names `--backend xla`).  Widths above 128 remain rejected at parse
time (PARITY.md deviation).

Design mirrors interp/wide64: a wrapped value class (`V`: rep "p" plain
array | "i"/"u" 128-bit limb vector, little-endian uint32 limbs) plus a
numpy-like namespace (`Wide128XP`) the SAME shared evaluator walks
unchanged.  All limb arithmetic is exact two's complement mod 2^128:
add/sub (carry chains), schoolbook mul (uint64 intermediate products),
compares, bitwise, dynamic shifts (7 conditional power-of-two steps), and
a 128-step restoring long division — each verified against a Python-int
oracle (`tests/test_wide128.py`).

Floats in >64-bit programs stay native f32/f64 (the XLA path runs under
jax.enable_x64, like the 64-bit wide mode).  int128 <-> float conversions
are exact up to f64 precision (53 bits), matching C's semantics for
in-range values.
"""

from __future__ import annotations

import numpy as np

NL = 4  # limbs per value: 4 x 32 = 128 bits
_M32 = 0xFFFFFFFF


class _DtypeToken:
    """Sentinel 'dtype' for 128-bit carriers (numpy has none): compared by
    identity, carried through EvalContext.int_dtype/acc_of."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return self.name


INT128 = _DtypeToken("int128")
UINT128 = _DtypeToken("uint128")


def _u32(xp, a):
    return xp.asarray(a).astype(np.uint32)


def _u64(a):
    return a.astype(np.uint64)


class V:
    """Wrapped value: plain array, or 128-bit limb vector (little-endian
    uint32 limbs, two's complement)."""

    __slots__ = ("rep", "l", "xp")
    __array_priority__ = 300

    def __init__(self, rep: str, l, xp=None):
        self.rep = rep      # "p" plain | "i" int128 | "u" uint128
        self.l = l          # plain array | tuple of NL uint32 arrays
        self.xp = xp

    # ---- constructors ----------------------------------------------------

    @staticmethod
    def plain(x, xp):
        return V("p", x, xp)

    @staticmethod
    def from_int_scalar(v: int, rep: str, xp):
        v &= (1 << 128) - 1
        limbs = tuple(_u32(xp, np.uint32((v >> (32 * k)) & _M32))
                      for k in range(NL))
        return V(rep, limbs, xp)

    @property
    def shape(self):
        return self.l.shape if self.rep == "p" else self.l[0].shape

    def map(self, f):
        if self.rep == "p":
            return V("p", f(self.l), self.xp)
        return V(self.rep, tuple(f(x) for x in self.l), self.xp)

    def __getitem__(self, sl):
        return self.map(lambda x: x[sl])

    # ---- rep / dtype conversion -----------------------------------------

    def astype(self, dtype):
        xp = self.xp
        if dtype is INT128 or dtype is UINT128:
            rep = "i" if dtype is INT128 else "u"
            if self.rep in ("i", "u"):
                return V(rep, self.l, xp)
            return _plain_to_limbs(self, rep)
        d = np.dtype(dtype) if not isinstance(dtype, str) else np.dtype(dtype)
        if self.rep == "p":
            return V("p", self.l.astype(d), xp)
        if d.kind == "f":
            return V("p", _limbs_to_float(self).astype(d), xp)
        # narrow to a native int dtype: low 64 bits, wrapped (astype
        # between int dtypes wraps — C conversion semantics)
        lo64 = (_u64(self.l[0]) | (_u64(self.l[1]) << np.uint64(32)))
        return V("p", lo64.astype(np.int64).astype(d), xp)

    @property
    def dtype(self):
        if self.rep == "i":
            return INT128
        if self.rep == "u":
            return UINT128
        return self.l.dtype

    def _lift(self, other) -> tuple["V", "V"]:
        """Coerce `other` to this value's rep for a binary op."""
        xp = self.xp
        if not isinstance(other, V):
            if self.rep in ("i", "u") and isinstance(other, (int, np.integer)):
                return self, V.from_int_scalar(int(other), self.rep, xp)
            other = V.plain(xp_base(xp).asarray(other), xp)
        if self.rep == other.rep:
            return self, other
        if self.rep == "p" and other.rep in ("i", "u"):
            return _plain_to_limbs(self, other.rep), other
        if other.rep == "p" and self.rep in ("i", "u"):
            return self, _plain_to_limbs(other, self.rep)
        # i vs u: unify on this value's rep (the evaluator coerces both
        # operands onto the promoted carrier before ops)
        return self, V(self.rep, other.l, xp)

    # ---- arithmetic (two's complement mod 2^128) -------------------------

    def __add__(self, other):
        a, b = self._lift(other)
        if a.rep == "p":
            return V.plain(a.l + b.l, a.xp)
        return _add(a, b)

    __radd__ = __add__

    def __sub__(self, other):
        a, b = self._lift(other)
        if a.rep == "p":
            return V.plain(a.l - b.l, a.xp)
        return _add(a, _neg(b))

    def __rsub__(self, other):
        a, b = self._lift(other)
        return b - a if a.rep != "p" else V.plain(b.l - a.l, a.xp)

    def __mul__(self, other):
        a, b = self._lift(other)
        if a.rep == "p":
            return V.plain(a.l * b.l, a.xp)
        return _mul(a, b)

    __rmul__ = __mul__

    def __neg__(self):
        if self.rep == "p":
            return V.plain(-self.l, self.xp)
        return _neg(self)

    def __invert__(self):
        if self.rep == "p":
            return V.plain(~self.l, self.xp)
        return V(self.rep, tuple(~x for x in self.l), self.xp)

    def __and__(self, other):
        a, b = self._lift(other)
        if a.rep == "p":
            return V.plain(a.l & b.l, a.xp)
        return V(a.rep, tuple(x & y for x, y in zip(a.l, b.l)), a.xp)

    def __or__(self, other):
        a, b = self._lift(other)
        if a.rep == "p":
            return V.plain(a.l | b.l, a.xp)
        return V(a.rep, tuple(x | y for x, y in zip(a.l, b.l)), a.xp)

    def __xor__(self, other):
        a, b = self._lift(other)
        if a.rep == "p":
            return V.plain(a.l ^ b.l, a.xp)
        return V(a.rep, tuple(x ^ y for x, y in zip(a.l, b.l)), a.xp)

    # ---- comparisons (plain bool arrays out) -----------------------------

    def _cmp(self, other, kind: str):
        a, b = self._lift(other)
        if a.rep == "p":
            import operator

            ops = {"lt": operator.lt, "le": operator.le, "gt": operator.gt,
                   "ge": operator.ge, "eq": operator.eq, "ne": operator.ne}
            return ops[kind](a.l, b.l)
        if kind == "eq":
            r = a.l[0] == b.l[0]
            for x, y in zip(a.l[1:], b.l[1:]):
                r = r & (x == y)
            return r
        if kind == "ne":
            return ~a._cmp(b, "eq")
        lt = _less(a, b, signed=a.rep == "i")
        if kind == "lt":
            return lt
        if kind == "ge":
            return ~lt
        gt = _less(b, a, signed=a.rep == "i")
        if kind == "gt":
            return gt
        return ~gt  # le

    # public comparisons wrap the bool array in a plain V (matching
    # wide64.W, so evaluator idioms like `fix.astype(dtype)` work)

    def __lt__(self, other):
        return V.plain(self._cmp(other, "lt"), self.xp)

    def __le__(self, other):
        return V.plain(self._cmp(other, "le"), self.xp)

    def __gt__(self, other):
        return V.plain(self._cmp(other, "gt"), self.xp)

    def __ge__(self, other):
        return V.plain(self._cmp(other, "ge"), self.xp)

    def __eq__(self, other):  # noqa: D105
        return V.plain(self._cmp(other, "eq"), self.xp)

    def __ne__(self, other):  # noqa: D105
        return V.plain(self._cmp(other, "ne"), self.xp)

    __hash__ = None


def xp_base(xp):
    """The underlying array module (np or jnp) from a V.xp field."""
    return xp


def _register_pytree() -> None:
    """V as a JAX pytree node (like wide64.W): limb vectors cross jit /
    scan carries on the XLA wide-int path."""
    try:
        from jax import tree_util as _jtu
    except ImportError:
        return
    _jtu.register_pytree_node(
        V,
        lambda v: ((v.l,), (v.rep, v.xp)),
        lambda aux, children: V(aux[0], children[0], aux[1]))


_register_pytree()


# ---- limb primitives -------------------------------------------------------


def _add(a: V, b: V) -> V:
    xp = a.xp
    out = []
    carry = None
    for x, y in zip(a.l, b.l):
        s = _u64(x) + _u64(y)
        if carry is not None:
            s = s + carry
        out.append(s.astype(np.uint32))
        carry = (s >> np.uint64(32)).astype(np.uint64)
    return V(a.rep, tuple(out), xp)


def _neg(a: V) -> V:
    xp = a.xp
    out = []
    carry = np.uint64(1)
    for x in a.l:
        s = _u64(~x) + carry
        out.append(s.astype(np.uint32))
        carry = (s >> np.uint64(32)).astype(np.uint64)
    return V(a.rep, tuple(out), xp)


def _is_neg(a: V):
    return (a.l[NL - 1] >> np.uint32(31)) != 0


def _abs(a: V) -> V:
    xp = a.xp
    n = _is_neg(a)
    neg = _neg(a)
    return V(a.rep, tuple(xp.where(n, y, x) for x, y in zip(a.l, neg.l)), xp)


def _mul(a: V, b: V) -> V:
    """Schoolbook product mod 2^128: 32-bit limb partial products in
    uint64, carry-propagated column by column."""
    xp = a.xp
    cols = [None] * NL          # uint64 accumulators per output limb
    carry_cols = [None] * NL
    for i in range(NL):
        ai = _u64(a.l[i])
        for j in range(NL - i):
            p = ai * _u64(b.l[j])
            k = i + j
            lo = p & np.uint64(_M32)
            hi = p >> np.uint64(32)
            cols[k] = lo if cols[k] is None else cols[k] + lo
            if k + 1 < NL:
                carry_cols[k + 1] = hi if carry_cols[k + 1] is None \
                    else carry_cols[k + 1] + hi
    out = []
    carry = np.uint64(0)
    for k in range(NL):
        s = cols[k] + carry
        if carry_cols[k] is not None:
            s = s + carry_cols[k]
        out.append(s.astype(np.uint32))
        carry = s >> np.uint64(32)
    return V(a.rep, tuple(out), xp)


def _less(a: V, b: V, signed: bool):
    """a < b over limb vectors."""
    if signed:
        # flip the top limb's sign bit: signed compare == unsigned compare
        # of bias-flipped values
        at = a.l[NL - 1] ^ np.uint32(0x80000000)
        bt = b.l[NL - 1] ^ np.uint32(0x80000000)
    else:
        at, bt = a.l[NL - 1], b.l[NL - 1]
    r = at < bt
    eq = at == bt
    for k in range(NL - 2, -1, -1):
        r = r | (eq & (a.l[k] < b.l[k]))
        eq = eq & (a.l[k] == b.l[k])
    return r


def _shl_const(a: V, s: int) -> V:
    """Left shift by a Python-int amount in [0, 128)."""
    xp = a.xp
    if s == 0:
        return a
    if s >= 128:
        z = a.l[0] * np.uint32(0)
        return V(a.rep, tuple(z for _ in range(NL)), xp)
    word, bit = divmod(s, 32)
    out = []
    for k in range(NL):
        src = k - word
        v = a.l[src] if src >= 0 else a.l[0] * np.uint32(0)
        if bit:
            lo_src = src - 1
            lo = a.l[lo_src] if lo_src >= 0 else a.l[0] * np.uint32(0)
            v = (v << np.uint32(bit)) | (lo >> np.uint32(32 - bit))
        out.append(v)
    return V(a.rep, tuple(out), xp)


def _shr_const(a: V, s: int) -> V:
    """Right shift by a Python-int amount in [0, 128): logical for "u",
    arithmetic for "i"."""
    xp = a.xp
    if s == 0:
        return a
    sign_fill = None
    if a.rep == "i":
        sign_fill = (xp.where(_is_neg(a), np.uint32(_M32), np.uint32(0))
                     .astype(np.uint32))
    zero = a.l[0] * np.uint32(0)
    fill = sign_fill if sign_fill is not None else zero
    if s >= 128:
        return V(a.rep, tuple(fill for _ in range(NL)), xp)
    word, bit = divmod(s, 32)
    out = []
    for k in range(NL):
        src = k + word
        v = a.l[src] if src < NL else fill
        if bit:
            hi_src = src + 1
            hi = a.l[hi_src] if hi_src < NL else fill
            v = (v >> np.uint32(bit)) | (hi << np.uint32(32 - bit))
        out.append(v)
    return V(a.rep, tuple(out), xp)


def _select(xp, c, a: V, b: V) -> V:
    return V(a.rep, tuple(xp.where(c, x, y) for x, y in zip(a.l, b.l)), a.xp)


def _shift_dyn(a: V, s, left: bool) -> V:
    """Shift by a per-element amount: 8 conditional power-of-two steps
    (1, 2, 4, ..., 128) — C behavior for s in [0, 128]."""
    xp = a.xp
    sv = s.l if isinstance(s, V) and s.rep == "p" else s
    if isinstance(sv, V):  # limb-vector amount: low limb carries it
        sv = sv.l[0]
    if isinstance(sv, (int, np.integer)):
        return _shl_const(a, int(sv)) if left else _shr_const(a, int(sv))
    sv = _u32(xp, sv)
    out = a
    for k in range(8):  # 2^7 = 128 covers the full range
        step = 1 << k
        cond = (sv & np.uint32(step)) != 0
        shifted = _shl_const(out, step) if left else _shr_const(out, step)
        out = _select(xp, cond, shifted, out)
    return out


def _divmod_unsigned(a: V, b: V) -> tuple[V, V]:
    """128-step restoring long division, MSB-shift form: every step uses
    only STATIC limb indices (the dividend shifts left one bit per step
    and its top bit feeds the remainder), so the jnp path runs a compact
    fori_loop with a (acc, q, r) V-tuple carry instead of tracing 128
    unrolled multi-limb steps."""
    xp = a.xp
    zero = a.l[0] * np.uint32(0)
    q0 = V("u", tuple(zero for _ in range(NL)), xp)
    r0 = V("u", tuple(zero for _ in range(NL)), xp)
    acc0 = V("u", a.l, xp)
    bu = V("u", b.l, xp)

    def step(carry):
        acc, q, r = carry
        bit = acc.l[NL - 1] >> np.uint32(31)
        acc = _shl_const(acc, 1)
        r = _shl_const(r, 1)
        r = V("u", (r.l[0] | bit,) + r.l[1:], xp)
        ge = ~_less(r, bu, signed=False)
        r = _select(xp, ge, _add(r, _neg(bu)), r)
        q = _shl_const(q, 1)
        q = V("u", (q.l[0] | ge.astype(np.uint32),) + q.l[1:], xp)
        return acc, q, r

    if xp is np:
        carry = (acc0, q0, r0)
        for _ in range(128):
            carry = step(carry)
        _, q, r = carry
        return q, r
    import jax

    _, q, r = jax.lax.fori_loop(0, 128, lambda _, c: step(c),
                                (acc0, q0, r0))
    return q, r


def _floordiv(a: V, b: V) -> V:
    """FLOOR division (matches numpy floor_divide — the evaluator's
    _c_div applies the trunc-toward-zero fix on top, exactly as on the
    other integer paths)."""
    xp = a.xp
    if a.rep == "u":
        q, _ = _divmod_unsigned(a, b)
        return V("u", q.l, xp)
    q, r = _divmod_unsigned(_abs(a), _abs(b))
    neg = _is_neg(a) != _is_neg(b)
    nz = r._cmp(V.from_int_scalar(0, "u", xp), "ne")
    qs = _select(xp, neg, _neg(V("i", q.l, xp)), V("i", q.l, xp))
    qfix = _add(qs, V.from_int_scalar(-1, "i", xp))
    return V("i", _select(xp, neg & nz, qfix, qs).l, xp)


def _limbs_to_float(a: V):
    """Limb vector -> float64 value (exact to f64 precision)."""
    xp = a.xp
    if a.rep == "u":
        v = a.l[0].astype(np.float64) * 0.0
        for k in range(NL):
            v = v + a.l[k].astype(np.float64) * float(2 ** (32 * k))
        return v
    m = _abs(a)
    v = m.l[0].astype(np.float64) * 0.0
    for k in range(NL):
        v = v + m.l[k].astype(np.float64) * float(2 ** (32 * k))
    return xp.where(_is_neg(a), -v, v)


def _plain_to_limbs(a: V, rep: str) -> V:
    """Plain native array -> limb vector (ints exact; floats truncate,
    exact to f64 precision — C cast semantics for in-range values)."""
    xp = a.xp
    x = a.l
    if hasattr(x, "dtype") and x.dtype.kind == "f":
        t = xp.trunc(x.astype(np.float64))
        neg = t < 0
        ax = xp.where(neg, -t, t)
        limbs = []
        for k in range(NL):
            d = ax / float(2 ** (32 * k))
            limb = xp.floor(d - xp.floor(d / float(2 ** 32))
                            * float(2 ** 32))
            limbs.append(limb.astype(np.int64).astype(np.uint32))
        v = V(rep, tuple(limbs), xp)
        return _select(xp, neg, _neg(v), v)
    # integer: sign-extend through int64
    x64 = x.astype(np.int64)
    lo = (x64 & np.int64(_M32)).astype(np.uint32)
    hi = ((x64 >> np.int64(32)) & np.int64(_M32)).astype(np.uint32)
    sign = ((x64 >> np.int64(63)) & np.int64(1)).astype(np.uint32) \
        * np.uint32(_M32)
    return V(rep, (lo, hi, sign, sign), xp)


# ---- numpy-like namespace ---------------------------------------------------


class Wide128XP:
    """numpy-like namespace over V values, backed by `base` (numpy or
    jax.numpy).  Mirrors WideXP's surface — the shared evaluator walks it
    unchanged with int_width=128."""

    int128 = INT128
    uint128 = UINT128
    int64 = np.int64
    uint64 = np.uint64
    float64 = np.float64
    int32 = np.int32
    uint32 = np.uint32
    float32 = np.float32
    float16 = np.float16

    def __init__(self, base):
        self.base = base

    def asarray(self, v, dtype=None):
        if isinstance(v, V):
            return v.astype(dtype) if dtype is not None else v
        if dtype is INT128 or dtype is UINT128:
            rep = "i" if dtype is INT128 else "u"
            if isinstance(v, (int, np.integer)):
                return V.from_int_scalar(int(v), rep, self.base)
            if (isinstance(v, np.ndarray) and v.dtype == object):
                return _object_to_limbs(v, rep, self.base)
            return V.plain(self.base.asarray(v), self.base).astype(dtype)
        if (isinstance(v, np.ndarray) and v.dtype == object):
            # object arrays of Python ints: route through the limb rep
            return _object_to_limbs(v, "i", self.base)
        x = self.base.asarray(v) if dtype is None \
            else self.base.asarray(v, dtype)
        return V.plain(x, self.base)

    def zeros_like(self, v):
        if isinstance(v, V):
            return v.map(self.base.zeros_like)
        return V.plain(self.base.zeros_like(v), self.base)

    def _plain(self, v):
        return v.l if isinstance(v, V) and v.rep == "p" else v

    def where(self, c, a, b):
        c = self._plain(c)
        if not isinstance(a, V):
            a = self.asarray(a)
        a, b = a._lift(b)
        if a.rep == "p":
            return V.plain(self.base.where(c, a.l, b.l), self.base)
        return _select(self.base, c, a, b)

    def minimum(self, a, b):
        if not isinstance(a, V):
            a = self.asarray(a)
        a2, b2 = a._lift(b)
        if a2.rep == "p":
            return V.plain(self.base.minimum(a2.l, b2.l), self.base)
        return self.where(a2._cmp(b2, "le"), a2, b2)

    def maximum(self, a, b):
        if not isinstance(a, V):
            a = self.asarray(a)
        a2, b2 = a._lift(b)
        if a2.rep == "p":
            return V.plain(self.base.maximum(a2.l, b2.l), self.base)
        return self.where(a2._cmp(b2, "ge"), a2, b2)

    def abs(self, a):
        if a.rep == "p":
            return V.plain(self.base.abs(a.l), self.base)
        if a.rep == "u":
            return a
        return _abs(a)

    def floor_divide(self, a, b):
        if not isinstance(a, V):
            a = self.asarray(a)
        a, b = a._lift(b)
        if a.rep == "p":
            return V.plain(self.base.floor_divide(a.l, b.l), self.base)
        return _floordiv(a, b)

    def left_shift(self, a, s):
        if a.rep == "p":
            return V.plain(self.base.left_shift(a.l, self._plain(s)),
                           self.base)
        return _shift_dyn(a, s, left=True)

    def right_shift(self, a, s):
        if a.rep == "p":
            return V.plain(self.base.right_shift(a.l, self._plain(s)),
                           self.base)
        return _shift_dyn(a, s, left=False)

    def bitwise_and(self, a, b):
        if not isinstance(a, V):
            a = self.asarray(a)
        return a & b

    def bitwise_or(self, a, b):
        if not isinstance(a, V):
            a = self.asarray(a)
        return a | b

    def bitwise_xor(self, a, b):
        if not isinstance(a, V):
            a = self.asarray(a)
        return a ^ b

    def bitwise_not(self, a):
        return ~a

    def trunc(self, a):
        if isinstance(a, V) and a.rep == "p":
            return V.plain(self.base.trunc(a.l), self.base)
        return a  # limb ints are integral

    def __getattr__(self, name):
        fn = getattr(self.base, name)

        def wrapped(a, *args):
            if isinstance(a, V):
                if a.rep != "p":
                    a = a.astype(np.float64)
                return V.plain(fn(a.l, *args), self.base)
            return V.plain(fn(a, *args), self.base)

        return wrapped


# ---- host conversion helpers -----------------------------------------------


def _object_to_limbs(arr: np.ndarray, rep: str, base) -> V:
    """Object array of Python ints -> limb vector V."""
    flat = [int(x) & ((1 << 128) - 1) for x in arr.reshape(-1)]
    limbs = []
    for k in range(NL):
        limbs.append(base.asarray(np.array(
            [(v >> (32 * k)) & _M32 for v in flat],
            dtype=np.uint32).reshape(arr.shape)))
    return V(rep, tuple(limbs), base)


def to_object_array(v: V, signed: bool) -> np.ndarray:
    """Limb vector -> object array of Python ints (the Python-int oracle
    boundary for >64-bit outputs)."""
    ls = [np.asarray(x, dtype=np.uint32) for x in v.l]
    shape = ls[0].shape
    flat = np.zeros(ls[0].size, dtype=object)
    for k in range(NL):
        flat += ls[k].reshape(-1).astype(object) << (32 * k)
    if signed:
        flat = np.where(flat >= (1 << 127), flat - (1 << 128), flat)
    return flat.reshape(shape)


def program_is_128(program) -> bool:
    """True when any tensor/param is wider than 64 bits."""
    return any(t.type.is_int and t.type.width > 64
               for t in program.tensors.values()) \
        or any(p.type.is_int and p.type.width > 64
               for p in program.params.values())
