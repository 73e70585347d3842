#!/usr/bin/env python
"""Heavy fuzz for the 64-bit types: random expression trees over
int64/uint64/double/half (casts both ways, dynamic shift amounts, pow2
and general div/mod, min/max, ternaries, bitwise), random grids
(aligned/unaligned), random iterate — the XLA path (native x64) vs the
64-bit NumPy oracle.  Integers must be BIT-EXACT; doubles within 1e-10.
Not part of CI (takes minutes): run ad hoc after touching the evaluator
or the wide plumbing.

    python scripts/fuzz_wide.py [n_seeds]
    python scripts/fuzz_wide.py [n_seeds] --w128   # 65..128-bit quad-limb fuzz
                                  # (oracle vs __int128 C++ vs XLA)
"""

import pathlib
import random
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def gen(rng: random.Random) -> tuple[str, str, bool]:
    """Random wide program; returns (source, base_type, low_mag).

    Integer seeds split into two profiles: HIGH-magnitude (2^48 inputs,
    exercising limb carries/high bits — no double() roundtrip casts, whose
    double-single channel is only ~2^-48-accurate and amplifies through
    ternaries) and LOW-magnitude (2^28 inputs — values stay below 2^47
    where the i64<->f64 double-single channel is EXACT, so casts are
    fair game for bit-exact comparison)."""
    base = rng.choice(["int64", "uint64", "double", "half"])
    is_f = base in ("double", "half")
    low_mag = (not is_f) and rng.random() < 0.5
    # ~20% rank-3 (exercises the pair-aware 3-D z-march line buffer and
    # 3-D strips on wide carriers); the rest rank-2
    rank3 = rng.random() < 0.2
    decl = "a(24, 32, *)" if rank3 else "a(64, *)"
    lines = [f"kernel: fw", f"input {base}: {decl}"]
    prev = ["a"]

    def off():
        if rank3:
            return (f"{rng.randint(-1, 1)}, {rng.randint(-1, 1)}, "
                    f"{rng.randint(-2, 2)}")
        return f"{rng.randint(-2, 2)}, {rng.randint(-2, 2)}"

    def lit(v):
        if is_f:
            return f"{float(v)}"
        return f"{base}({v})"

    def term(src):
        r = f"{src}({off()})"
        k = rng.random()
        if is_f:
            if k < 0.2:
                return f"{r} * {round(rng.uniform(-2, 2), 4)}"
            if k < 0.3:
                return f"abs({r})"
            if k < 0.4:
                return f"min({r}, {src}({off()}))"
            if k < 0.5:
                return f"({r} > 0.0 ? {r} : {src}({off()}))"
            if k < 0.58:
                # denominator is a SQUARE + 1 (>= 1): x*y + 1 can pass
                # arbitrarily close to zero, where the documented
                # DS/f16 precision channels amplify unboundedly
                d = f"{src}({off()})"
                return f"{r} / ({d} * {d} + 1.0)"
            if k < 0.64:
                return f"sqrt(abs({r}))"
            if k < 0.72:
                # round-3 C-math surface: domains kept safe via
                # tanh/square-plus-one so errors stay at DS/f16 scale
                d = f"{src}({off()})"
                return rng.choice([
                    # asin's conditioning blows up at |y| -> 1
                    # (asin' = 1/sqrt(1-y^2)): the *0.9 keeps the
                    # composition well-conditioned, same as the corpus
                    # mathfn programs (soak seed 189: unbounded asin о
                    # tanh amplified DS-vs-f64 noise 1e-12 -> 1e-8 abs)
                    f"atan({r})", f"asin(tanh({r}) * 0.9)",
                    f"log1p({r} * {r})", f"expm1(tanh({r}))",
                    f"hypot({r}, {d})",
                    f"atan2({r}, {d} * {d} + 1.0)",
                    f"copysign({r}, {d})", f"sinh(tanh({r}))",
                    f"log10({r} * {r} + 1.0)",
                ])
            if k < 0.78 and base == "double":
                return f"double(int64({r}))"  # f64 -> i64 -> f64
            return r
        if k < 0.15:
            return f"{r} * {lit(rng.randint(1, 9))}"
        if k < 0.25:
            return f"max({r}, {src}({off()}))"
        if k < 0.35:
            return f"({r} >> {rng.randint(0, 50)})"
        if k < 0.42:
            # dynamic shift amount (a tap value masked to [0, 16))
            return f"({r} >> ({src}({off()}) & {lit(15)}))"
        if k < 0.5:
            return f"({r} > {lit(10)} ? {r} : {src}({off()}))"
        if k < 0.58:
            return f"{r} / {lit(2 ** rng.randint(1, 12))}"  # pow2 shift path
        if k < 0.64:
            return f"{r} % {lit(rng.randint(3, 10**6))}"    # long division
        if k < 0.7:
            return f"({r} & {lit(2 ** rng.randint(4, 40) - 1)})"
        if k < 0.76 and low_mag:
            return f"{base}(double({r}) * 0.5)"  # i64 -> f64 -> i64
        return r

    n_stages = rng.randint(1, 3)
    anchor = "(0, 0, 0)" if rank3 else "(0, 0)"
    for s in range(n_stages):
        src = rng.choice(prev)
        nterms = rng.randint(2, 4)
        expr = " + ".join(term(src) for _ in range(nterms))
        name = f"s{s}" if s + 1 < n_stages else "out"
        kind = "local" if s + 1 < n_stages else "output"
        lines.append(f"{kind} {base}: {name}{anchor} = {expr}")
        prev.append(name)
    it = 1 if rank3 else rng.choice([1, 1, 1, 2, 4])
    if it > 1:
        lines.insert(1, f"iterate: {it}")
    return "\n".join(lines) + "\n", base, low_mag


def gen128(rng: random.Random) -> tuple[str, str]:
    """Random 65..128-bit integer program (pure int ops: float round-trips
    are excluded — C++ casts (float)__int128 round once while the
    quad-limb path rounds via f64, a documented 1-ulp channel)."""
    base = rng.choice(["int96", "uint128", "int128", "uint100"])
    lines = [f"kernel: fq", f"input {base}: a(64, *)"]
    prev = ["a"]

    def off():
        return f"{rng.randint(-2, 2)}, {rng.randint(-2, 2)}"

    def term(src):
        r = f"{src}({off()})"
        k = rng.random()
        if k < 0.12:
            return f"{r} * {base}({rng.randint(1, 10**12)})"
        if k < 0.22:
            return f"max({r}, {src}({off()}))"
        if k < 0.32:
            return f"({r} >> {rng.randint(0, 100)})"
        if k < 0.4:
            return f"({r} >> ({src}({off()}) & {base}(31)))"
        if k < 0.48:
            return f"({r} > {base}(10) ? {r} : {src}({off()}))"
        if k < 0.56:
            return f"{r} / {base}({2 ** rng.randint(1, 40)})"
        if k < 0.64:
            return f"{r} % {base}({rng.randint(3, 10**9)})"
        if k < 0.72:
            return f"({r} & {base}({2 ** rng.randint(8, 100) - 1}))"
        if k < 0.8:
            return f"{base}(int64({r}))"  # narrow-and-widen cast chain
        return r

    n_stages = rng.randint(1, 2)
    for s in range(n_stages):
        src = rng.choice(prev)
        expr = " + ".join(term(src) for _ in range(rng.randint(2, 3)))
        name = f"s{s}" if s + 1 < n_stages else "out"
        kind = "local" if s + 1 < n_stages else "output"
        lines.append(f"{kind} {base}: {name}(0, 0) = {expr}")
        prev.append(name)
    if rng.random() < 0.3:
        lines.insert(1, "iterate: 2")
    return "\n".join(lines) + "\n", base


def fuzz_128(n: int) -> int:
    """oracle (quad-limb numpy) vs C++ (__int128) vs XLA (quad-limb jnp,
    subsampled) — three independent implementations, bit-equal required."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from soda_tpu.backend import cpp as cpp_backend, xla as xb
    from soda_tpu.frontend.parser import parse
    from soda_tpu.interp import numpy_interp

    failures = 0
    for seed in range(n):
        rng = random.Random(7_128_000 + seed)
        src, base = gen128(rng)
        p = parse(src)
        shape = rng.choice([(16, 48), (13, 33), (24, 64)])
        bits = int("".join(c for c in base if c.isdigit()))
        signed = not base.startswith("u")
        nprng = np.random.default_rng(seed)
        vals = [int.from_bytes(nprng.bytes(16), "little") & ((1 << bits) - 1)
                for _ in range(shape[0] * shape[1])]
        if signed:
            vals = [v - (1 << bits) if v >= (1 << (bits - 1)) else v
                    for v in vals]
        x = np.array(vals, dtype=object).reshape(shape)
        try:
            gold = numpy_interp.run(p, {"a": x})["out"]
            got_c = cpp_backend.compile_and_run(p, {"a": x})["out"]
            ok = bool((got_c == gold).all())
            tag = "cpp"
            if seed % 4 == 0:
                got_x = xb.run(p, {"a": x})["out"]
                ok = ok and bool((got_x == gold).all())
                tag = "cpp+xla"
        except Exception as e:  # noqa: BLE001
            print(f"seed {seed}: RUN FAILED {type(e).__name__}: {e}\n{src}")
            failures += 1
            continue
        print(f"seed {seed} [{base}, {tag}]: {'OK' if ok else 'MISMATCH'}")
        if not ok:
            print(src)
            failures += 1
    print(f"{failures} failures / {n} seeds (128-bit)")
    return 1 if failures else 0


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() \
        else 40
    if "--w128" in sys.argv:
        return fuzz_128(n)

    from soda_tpu.backend import xla as xb
    from soda_tpu.frontend.parser import parse
    from soda_tpu.interp import numpy_interp

    failures = 0
    for seed in range(n):
        rng = random.Random(910_000 + seed)
        src, base, low_mag = gen(rng)
        p = parse(src)
        if p.rank == 3:
            shape = rng.choice([(16, 24, 128), (24, 32, 128),
                                (17, 25, 130)])
        else:
            shape = rng.choice([(32, 128), (40, 128), (33, 130), (64, 256)])
        nprng = np.random.default_rng(seed)
        hi_bits = 28 if low_mag else 48
        if base == "half":
            # small values: mid-chain f16 overflow-to-inf in the per-op
            # oracle vs finite f32 kernel compute is a documented
            # deviation, not a bug signal
            x = (nprng.standard_normal(shape) * 0.5).astype(np.float16)
        elif base == "double":
            x = nprng.standard_normal(shape) * 10.0
        elif base == "int64":
            x = nprng.integers(-2**hi_bits, 2**hi_bits, shape,
                               dtype=np.int64)
        else:
            x = nprng.integers(0, 2**(hi_bits + 1), shape,
                               dtype=np.uint64)
        gold = numpy_interp.run(p, {"a": x})["out"]
        rim = p.valid_rim()
        sl = tuple(slice(rim, -rim) if rim else slice(None)
                   for _ in range(p.rank))
        if gold[sl].size == 0:
            continue
        try:
            got = xb.run(p, {"a": x})["out"]
        except Exception as e:  # noqa: BLE001
            print(f"seed {seed}: RUN FAILED {type(e).__name__}: {e}\n{src}")
            failures += 1
            continue
        if base in ("double", "half"):
            g = gold[sl].astype(np.float64)
            o = got[sl].astype(np.float64)
            rel = np.abs(g - o) / np.maximum(np.abs(g), 1.0)
            if base == "half":
                # oracle rounds per op; the XLA path computes f32
                # between f16-rounded stores (docs/SEMANTICS.md).  Near-zero
                # ternary/min-max comparisons flip under that channel
                # (f16 rounds tiny sums to exact 0 where f32 keeps a
                # sign) and iterate feedback spreads the flipped cells
                # (~0.6% observed at iterate=4).  ADVICE r2: at
                # iterate=1 flips cannot SPREAD, but one flip between
                # DISTANT branch values is still an O(branch-gap) error
                # at that cell (soak seed 191: ternary on a computed
                # near-zero value selecting unrelated taps), so both
                # regimes gate the FRACTION of cells beyond f16
                # tolerance — tight (0.5%) without feedback, 1.2% with
                # (above the ~0.6% spread rate observed at iterate=4,
                # below a corrupted row: 248/13888 = 1.79% on (64,256))
                if p.iterate <= 1:
                    ok = np.mean(rel >= 3e-2) < 0.005
                else:
                    ok = np.mean(rel >= 3e-2) < 0.012
            else:
                ok = rel.max() < 1e-10
        else:
            ok = np.array_equal(gold[sl], got[sl])
        print(f"seed {seed} [{base}]: {'OK' if ok else 'MISMATCH'}")
        if not ok:
            print(src)
            failures += 1
    print(f"{failures} failures / {n} seeds")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
