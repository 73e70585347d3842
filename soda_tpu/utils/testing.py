"""Shared oracle-comparison helpers for the CPU test suite, `sodac --run`
and `chip_smoke.py` — one definition of the random input distributions
and the rim-excluded comparison gates, so a tolerance cannot silently
diverge between them.

Gates (docs/SEMANTICS.md), per output:
- integer outputs compare BIT-exact (a float64 cast would hide dropped
  low-limb carries beyond 2^53 on the wide paths);
- `half` programs gate at 2e-2, f16 scale (the oracle rounds per op, the
  XLA path computes f32 between f16 stores);
- f32 programs with libm transcendentals gate at 2e-3: XLA's vector
  exp/log/trig are approximations, not correctly rounded like libm;
- other f32 outputs gate at 1e-4: XLA contracts multiply-adds to FMA and
  sums in its own order.  No program has a matrix product, so TF32 never
  arises;
- outputs of programs whose floats are all 64-bit gate at 1e-10.
"""
from __future__ import annotations

import numpy as np


def rand_inputs(p, shape, rng):
    """Random inputs + params for `p`: signed ints draw negatives
    (sign-dependent C semantics), >32-bit draws exercise the pair/limb
    carriers past int32, >64-bit builds object arrays of Python ints."""
    ins = {}
    for n in p.input_names:
        t = p.tensors[n].type
        if t.is_float:
            ins[n] = rng.standard_normal(shape).astype(t.np_dtype())
        elif t.kind == "int" and t.width > 64:
            hi = rng.integers(0, 1 << (min(t.width, 127) - 65),
                              shape).astype(object)
            lo = rng.integers(0, 1 << 62, shape).astype(object)
            ins[n] = (hi << 64) | lo
        elif t.kind == "int" and t.width > 32:
            ins[n] = rng.integers(-(1 << 40), 1 << 40, shape).astype(
                t.np_dtype())
        elif t.kind == "int":
            hi = 1 << min(t.width - 1, 12)
            ins[n] = rng.integers(-hi, hi, shape).astype(t.np_dtype())
        elif t.width > 32:
            ins[n] = rng.integers(0, 1 << 40, shape).astype(t.np_dtype())
        else:
            ins[n] = rng.integers(0, min(250, (1 << t.width) - 1),
                                  shape).astype(t.np_dtype())
    ps = {pp.name: rng.standard_normal(pp.shape).astype(pp.type.np_dtype())
          for pp in p.params.values()}
    return ins, ps


def interior(a, rim: int):
    """`a` without its border-invalid rim of width `rim`."""
    if rim == 0:
        return a
    return a[tuple(slice(rim, -rim) for _ in range(a.ndim))]


def output_tolerance(p, name: str) -> float | None:
    """rtol = atol for output `name` of program `p`; None = bit-exact."""
    if not p.tensors[name].type.is_float:
        return None
    widths = {t.type.width for t in p.tensors.values() if t.type.is_float}
    widths |= {q.type.width for q in p.params.values() if q.type.is_float}
    if 16 in widths:
        return 2e-2
    if widths == {64}:
        return 1e-10
    if p.uses_libm_transcendentals() and p.max_float_width() == 32:
        return 2e-3
    return 1e-4


def compare_outputs(p, got, gold, rim) -> bool:
    """Rim-excluded comparison at `output_tolerance`.  Returns False
    (never raises); refuses a vacuous pass on an all-rim grid."""
    for k in gold:
        a = interior(np.asarray(got[k]), rim)
        b = interior(np.asarray(gold[k]), rim)
        if a.size == 0:
            return False
        tol = output_tolerance(p, k)
        if tol is None:
            if not np.array_equal(a, b):
                return False
        elif not np.allclose(a.astype(np.float64), b.astype(np.float64),
                             rtol=tol, atol=tol):
            return False
    return True


def assert_outputs_match(p, got, gold, rim=None) -> None:
    """pytest-friendly wrapper: same gates, with a max-diff message."""
    rim = p.valid_rim() if rim is None else rim
    assert compare_outputs(p, got, gold, rim), "; ".join(
        f"{k}: max diff "
        f"{np.abs(np.asarray(got[k]).astype(np.float64) - np.asarray(gold[k]).astype(np.float64)).max()}"
        for k in gold)
