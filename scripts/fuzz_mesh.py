#!/usr/bin/env python
"""Mesh-layer fuzz: random stencil programs sharded over random simulated
CPU meshes vs the NumPy oracle.

Covers the axes the unit tests sample only pointwise: UNEVEN grids
(pad-to-shard with masked outputs), 1-D/2-D meshes, exchange cadences
(every sweep / chunked / full), comms-compute overlap, multi-stage
programs, and 64-bit plane-pair sharding.

Gates: SINGLE-STAGE programs at exchange-every-sweep compare on the
whole grid, rim included (a single stage's constant-extent zero-fill
evaluation IS the oracle's semantics): INTEGERS bit-exact, floats at f32
tolerance (XLA contracts mul+add into FMA where numpy rounds separately
— the documented cross-backend float channel).  Multi-stage chains and
deeper cadences compare with the border-invalid rim excluded: stage
values at virtual out-of-grid rows are computed from zero-filled inputs
rather than defined as zero, so mixed-sign chains legitimately deviate
inside the rim (docs/SEMANTICS.md, border: ignore).

    python scripts/fuzz_mesh.py [n_seeds]

Not part of CI (minutes); run ad hoc after touching parallel/mesh.py.
"""

import pathlib
import random
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8"
                           ).strip()

import numpy as np


def gen(rng: random.Random) -> tuple[str, str, int]:
    base = rng.choice(["float", "float", "uint16", "int64"])
    it = rng.choice([1, 1, 2, 4])
    lines = [f"kernel: fm", f"input {base}: a(64, *)"]
    if it > 1:
        lines.insert(1, f"iterate: {it}")

    def off():
        return f"{rng.randint(-2, 2)}, {rng.randint(-2, 2)}"

    def term(src):
        r = f"{src}({off()})"
        k = rng.random()
        if base == "float":
            if k < 0.3:
                return f"{r} * {round(rng.uniform(-1, 1), 3)}f"
            if k < 0.45:
                return f"min({r}, {src}({off()}))"
            return r
        if k < 0.25:
            return f"{r} * {base}({rng.randint(1, 7)})"
        if k < 0.4:
            return f"max({r}, {src}({off()}))"
        if k < 0.55:
            return f"({r} >> {rng.randint(0, 8)})"
        return r

    n_stages = 1 if it > 1 else rng.randint(1, 2)
    prev = ["a"]
    for s in range(n_stages):
        src = rng.choice(prev)
        expr = " + ".join(term(src) for _ in range(rng.randint(2, 4)))
        name = f"s{s}" if s + 1 < n_stages else "out"
        kind = "local" if s + 1 < n_stages else "output"
        lines.append(f"{kind} {base}: {name}(0, 0) = {expr}")
        prev.append(name)
    return "\n".join(lines) + "\n", base, it


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() \
        else 40

    import jax

    jax.config.update("jax_platforms", "cpu")
    from soda_tpu.frontend.parser import parse
    from soda_tpu.interp import numpy_interp
    from soda_tpu.parallel.mesh import run_sharded

    failures = 0
    for seed in range(n):
        rng = random.Random(5_777_000 + seed)
        src, base, it = gen(rng)
        p = parse(src)
        nprng = np.random.default_rng(seed)
        # uneven shapes on purpose: pad-to-shard must stay exact
        shape = rng.choice([(64, 96), (100, 131), (61, 96), (96, 250),
                            (40, 128)])
        if base == "float":
            x = nprng.standard_normal(shape).astype(np.float32)
        elif base == "uint16":
            x = nprng.integers(0, 60000, shape).astype(np.uint16)
        else:
            x = nprng.integers(-2**45, 2**45, shape).astype(np.int64)

        mesh_cfg = rng.choice([
            dict(axis_sizes=[8], dims=[0]),
            dict(axis_sizes=[4], dims=[0]),
            dict(axis_sizes=[2, 4], dims=[0, 1]),
            dict(axis_sizes=[4, 2], dims=[0, 1]),
        ])
        spe = rng.choice([1, 1, None, it if it > 1 else None])
        overlap = rng.random() < 0.3
        kw = dict(mesh_cfg)
        if spe is not None:
            kw["sweeps_per_exchange"] = spe
        if overlap:
            kw["overlap"] = True
        try:
            gold = numpy_interp.run(p, {"a": x})["out"]
            got = run_sharded(p, {"a": x}, **kw)["out"]
        except Exception as e:  # noqa: BLE001
            print(f"seed {seed}: RUN FAILED {type(e).__name__}: {e}\n{src}")
            failures += 1
            continue
        single_stage = len(p.stage_order()) == 1
        exact_everywhere = single_stage and (spe == 1 or it == 1)
        r = 0 if exact_everywhere else p.valid_rim()
        sl = tuple(slice(r, -r) if r else slice(None) for _ in range(2))
        g, o = gold[sl], got[sl]
        if g.size == 0:
            print(f"seed {seed}: rim leaves no interior, skipped")
            continue
        if exact_everywhere and base != "float":
            # single-stage + exchange-every-sweep: integers BIT-exact,
            # rim included (floats stay at f32 tolerance below — XLA's
            # FMA contraction differs from numpy's per-op rounding)
            ok = np.array_equal(g, o)
        elif base == "float":
            ok = np.allclose(g.astype(np.float64), o.astype(np.float64),
                             rtol=1e-4, atol=1e-4)
        else:
            ok = np.array_equal(g, o)
        cfg = (f"{'x'.join(map(str, mesh_cfg['axis_sizes']))}mesh "
               f"spe={spe} ov={int(overlap)}")
        print(f"seed {seed} [{base} it={it} {shape} {cfg}]: "
              f"{'OK' if ok else 'MISMATCH'}")
        if not ok:
            print(src)
            failures += 1
    print(f"{failures} failures / {n} seeds (mesh)")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
