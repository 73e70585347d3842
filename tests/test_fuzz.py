"""Property-based cross-backend fuzzing: random stencil programs must
agree across NumPy oracle, the XLA backend (whole grid and host-tiled),
and the generated C++ golden runner.

Seeded and deterministic.  Programs are generated from a small grammar of
safe expressions (no division by dynamic values; bounded tap radii)."""

import random
import shutil

import numpy as np
import pytest

from soda_tpu.frontend.parser import parse
from soda_tpu.interp import numpy_interp
from soda_tpu.backend import xla as xla_backend
from soda_tpu.backend import cpp as cpp_backend
from soda_tpu.parallel.host_tile import run_host_tiled


def gen_program(rng: random.Random, rank: int) -> str:
    """Random 1-3 stage program over one input."""
    ftype = rng.choice(["float", "int16", "uint16", "int32"])
    is_float = ftype == "float"
    n_stages = rng.randint(1, 3)
    tile = ", ".join(["64"] * (rank - 1) + ["*"])
    lines = [f"kernel: fuzz", f"input {ftype}: a({tile})"]
    prev = ["a"]

    def off():
        return ", ".join(str(rng.randint(-2, 2)) for _ in range(rank))

    def term(src):
        r = f"{src}({off()})"
        if is_float:
            k = rng.random()
            if k < 0.25:
                return f"{r} * {round(rng.uniform(-2, 2), 3)}f"
            if k < 0.35:
                return f"abs({r})"
            if k < 0.45:
                return f"min({r}, {src}({off()}))"
            if k < 0.55:
                return f"({r} > 0.0f ? {r} : {src}({off()}))"
            if k < 0.65:
                # round-3 C-math surface, SMOOTH fns on safe domains only
                # (discontinuous fns cross-accuracy branch-flip — see
                # docs/SEMANTICS.md discontinuity rule)
                d = f"{src}({off()})"
                return rng.choice([
                    f"atan({r})", f"expm1(tanh({r}))",
                    f"log1p({r} * {r})", f"hypot({r}, {d})"])
            return r
        k = rng.random()
        if k < 0.25:
            return f"{r} * {rng.randint(1, 3)}"
        if k < 0.35:
            return f"max({r}, {src}({off()}))"
        if k < 0.45:
            return f"({r} >> {rng.randint(0, 2)})"
        if k < 0.55:
            return f"({r} > {rng.randint(10, 100)} ? {r} : {src}({off()}))"
        if k < 0.62:
            return f"int32({r} & {2**rng.randint(4, 10) - 1})"
        return r

    for s in range(n_stages):
        src = rng.choice(prev)
        nterms = rng.randint(2, 5)
        expr = " + ".join(term(src) for _ in range(nterms))
        if rng.random() < 0.4:
            expr = f"({expr}) / {rng.choice(['2', '4'] if not is_float else ['2.0f', '4.0f'])}"
        kind = "output" if s == n_stages - 1 else "local"
        name = "out" if kind == "output" else f"s{s}"
        anchor = ", ".join(["0"] * rank)
        lines.append(f"{kind} {ftype}: {name}({anchor}) = {expr}")
        prev.append(name)
    return "\n".join(lines) + "\n"


def make_input(p, shape, rng_np):
    t = p.tensors["a"].type
    if t.is_float:
        return rng_np.standard_normal(shape).astype(t.np_dtype())
    return rng_np.integers(0, 200, shape).astype(t.np_dtype())


def interior(a, rim):
    if rim == 0:
        return a
    return a[tuple(slice(rim, -rim) for _ in range(a.ndim))]


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("rank", [2, 3])
def test_fuzz_backends_agree(seed, rank):
    rng = random.Random(1000 * rank + seed)
    src = gen_program(rng, rank)
    p = parse(src)
    shape = (32, 48) if rank == 2 else (16, 24, 48)
    x = make_input(p, shape, np.random.default_rng(seed))
    gold = numpy_interp.run(p, {"a": x})["out"]
    rim = p.valid_rim()

    got_x = xla_backend.run(p, {"a": x})["out"]
    assert np.allclose(interior(got_x, rim).astype(np.float64),
                       interior(gold, rim).astype(np.float64),
                       rtol=1e-4, atol=1e-4), f"xla mismatch:\n{src}"

    tiles = tuple(max(n // 2, 1) for n in shape)
    got_t = run_host_tiled(p, {"a": x}, tiles=tiles)["out"]
    assert np.allclose(interior(got_t, rim).astype(np.float64),
                       interior(gold, rim).astype(np.float64),
                       rtol=1e-4, atol=1e-4), f"host-tile mismatch:\n{src}"


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_fuzz_cpp_bit_exact(seed, tmp_path):
    rng = random.Random(seed)
    src = gen_program(rng, 2)
    p = parse(src)
    x = make_input(p, (24, 32), np.random.default_rng(seed))
    gold = numpy_interp.run(p, {"a": x})["out"]
    got = cpp_backend.compile_and_run(p, {"a": x}, workdir=tmp_path)["out"]
    if p.uses_libm_transcendentals():
        # libm vs numpy differ by ~1 ulp at the f32 scale (same gate as
        # test_cpp_golden_bit_exact / the hardware gate)
        assert np.allclose(got.astype(np.float64), gold.astype(np.float64),
                           rtol=2e-5, atol=2e-5), f"C++ mismatch:\n{src}"
    else:
        assert np.array_equal(got, gold), f"C++ mismatch:\n{src}"


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_tcse_preserves_semantics(seed):
    """tcse applied to random programs stays interior-equal (exact for
    ints, tolerance for floats)."""
    from soda_tpu.optimize import tcse

    rng = random.Random(7000 + seed)
    src = gen_program(rng, 2)
    p = parse(src)
    q = tcse.apply(p)
    x = make_input(p, (32, 48), np.random.default_rng(seed))
    a = numpy_interp.run(p, {"a": x})["out"]
    b = numpy_interp.run(q, {"a": x})["out"]
    rim = max(p.valid_rim(), q.valid_rim())
    ga = interior(a, rim).astype(np.float64)
    gb = interior(b, rim).astype(np.float64)
    if p.tensors["a"].type.is_int:
        assert np.array_equal(ga, gb), f"tcse int mismatch:\n{src}"
    else:
        assert np.allclose(ga, gb, rtol=1e-4, atol=1e-4), f"tcse:\n{src}"


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_fuzz_cpp_bit_exact_3d(seed, tmp_path):
    rng = random.Random(500 + seed)
    src = gen_program(rng, 3)
    p = parse(src)
    x = make_input(p, (10, 12, 16), np.random.default_rng(seed))
    gold = numpy_interp.run(p, {"a": x})["out"]
    got = cpp_backend.compile_and_run(p, {"a": x}, workdir=tmp_path)["out"]
    assert np.array_equal(got, gold), f"C++ 3D mismatch:\n{src}"


def gen_two_input_program(rng: random.Random) -> str:
    lines = ["kernel: fuzz2", "input float: a(64, *)", "input float: b(64, *)"]

    def off():
        return f"{rng.randint(-2, 2)}, {rng.randint(-2, 2)}"

    expr = " + ".join(
        f"{rng.choice(['a', 'b'])}({off()}) * {round(rng.uniform(-2, 2), 3)}f"
        for _ in range(rng.randint(3, 6)))
    lines.append(f"local float: s0(0, 0) = {expr}")
    expr2 = " + ".join(
        f"{rng.choice(['a', 'b', 's0'])}({off()})" for _ in range(3))
    lines.append(f"output float: out(0, 0) = {expr2}")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_two_inputs(seed):
    rng = random.Random(9000 + seed)
    src = gen_two_input_program(rng)
    p = parse(src)
    rnp = np.random.default_rng(seed)
    a = rnp.standard_normal((32, 48)).astype(np.float32)
    b = rnp.standard_normal((32, 48)).astype(np.float32)
    gold = numpy_interp.run(p, {"a": a, "b": b})["out"]
    rim = p.valid_rim()
    got = run_host_tiled(p, {"a": a, "b": b}, tiles=(16, 48))["out"]
    assert np.allclose(interior(got, rim).astype(np.float64),
                       interior(gold, rim).astype(np.float64),
                       rtol=1e-4, atol=1e-4), f"two-input mismatch:\n{src}"


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_unaligned_grids(seed):
    """Random (often non-power-of-two) grid shapes must match the oracle,
    whole grid and in host tiles that do not divide the grid."""
    rng = random.Random(3000 + seed)
    rank = rng.choice([2, 3])
    src = gen_program(rng, rank)
    p = parse(src)
    if rank == 2:
        shape = (rng.randint(24, 70), rng.choice([48, 64, 100, 130]))
    else:
        shape = (rng.randint(12, 30), rng.randint(16, 40),
                 rng.choice([48, 100, 130]))
    x = make_input(p, shape, np.random.default_rng(seed))
    gold = numpy_interp.run(p, {"a": x})["out"]
    rim = p.valid_rim()
    ga = interior(gold, rim)
    if ga.size == 0:
        pytest.skip("grid smaller than rim")
    tiles = tuple(n // 3 + 1 for n in shape)
    for got in (xla_backend.run(p, {"a": x})["out"],
                run_host_tiled(p, {"a": x}, tiles=tiles)["out"]):
        assert np.allclose(interior(got, rim).astype(np.float64),
                           ga.astype(np.float64), rtol=1e-4, atol=1e-4), \
            f"unaligned {shape}:\n{src}"


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_trapezoid_iterate(seed):
    """Random programs iterated 2-16 sweeps must match the oracle's
    sweep-by-sweep feedback, in one scan and over host passes."""
    rng = random.Random(4000 + seed)
    src = gen_program(rng, 2)
    # the feedback requires matching in/out types; gen_program reuses one
    # type everywhere so any generated program qualifies
    it = rng.randint(2, 16)
    p = parse(src)
    shape = (64, 64) if it <= 8 else (128, 128)
    x = make_input(p, shape, np.random.default_rng(seed))
    gold = numpy_interp.run(p, {"a": x}, iterate=it)["out"]
    rim = p.valid_rim(iterate=it)
    ga = interior(gold, rim)
    if ga.size == 0:
        pytest.skip("grid smaller than iterated rim")
    spp = min(k for k in range(2, it + 1) if it % k == 0)
    for got in (xla_backend.run(p, {"a": x}, iterate=it)["out"],
                run_host_tiled(p, {"a": x}, tiles=(shape[0] // 2, 0),
                               iterate=it, sweeps_per_pass=spp)["out"]):
        assert np.allclose(interior(got, rim).astype(np.float64),
                           ga.astype(np.float64),
                           rtol=1e-3, atol=1e-3), f"iterate={it}:\n{src}"


def gen_weighted_program(rng: random.Random) -> str:
    """Random CONSTANT-weight sums (separable/binomial-ish patterns mixed
    with arbitrary ones) — the weighted-tcse surface."""
    lines = ["kernel: fw", "input int32: a(64, *)"]
    taps = []
    # half the seeds use an outer-product (separable) weight pattern
    if rng.random() < 0.5:
        wr = [rng.randint(1, 4) for _ in range(rng.randint(2, 4))]
        wc = [rng.randint(1, 4) for _ in range(rng.randint(2, 4))]
        for i, a in enumerate(wr):
            for j, b in enumerate(wc):
                taps.append((a * b, (i - len(wr) // 2, j - len(wc) // 2)))
    else:
        seen = set()
        for _ in range(rng.randint(3, 9)):
            o = (rng.randint(-2, 2), rng.randint(-2, 2))
            if o in seen:
                continue
            seen.add(o)
            taps.append((rng.randint(1, 6), o))
    expr = " + ".join(
        (f"{w} * a({i}, {j})" if w != 1 else f"a({i}, {j})")
        for w, (i, j) in taps)
    lines.append(f"output int32: out(0, 0) = {expr}")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_weighted_tcse_bit_exact(seed):
    """Weighted tcse on random constant-weight sums: bit-exact for int32,
    and never an op-count regression."""
    from soda_tpu.optimize import tcse

    rng = random.Random(6000 + seed)
    src = gen_weighted_program(rng)
    p = parse(src)
    q = tcse.apply(p)
    assert tcse.count_ops(q) <= tcse.count_ops(p), f"op regression:\n{src}"
    x = np.random.default_rng(seed).integers(
        0, 1000, (32, 48)).astype(np.int32)
    a = numpy_interp.run(p, {"a": x})["out"]
    b = numpy_interp.run(q, {"a": x})["out"]
    rim = max(p.valid_rim(), q.valid_rim())
    assert np.array_equal(interior(a, rim), interior(b, rim)), \
        f"weighted tcse mismatch:\n{src}"


def gen_minmax_program(rng: random.Random) -> str:
    """Random min/max reduction trees over one tensor (idempotent-reuse
    surface): random tap sets, sometimes rectangular (separable)."""
    fn = rng.choice(["min", "max"])
    taps = set()
    if rng.random() < 0.5:
        for i in range(rng.randint(2, 3)):
            for j in range(rng.randint(2, 4)):
                taps.add((i - 1, j - 1))
    else:
        while len(taps) < rng.randint(3, 9):
            taps.add((rng.randint(-2, 2), rng.randint(-2, 2)))
    leaves = [f"a({i}, {j})" for i, j in sorted(taps)]
    expr = leaves[0]
    for leaf in leaves[1:]:
        expr = f"{fn}({expr}, {leaf})"
    return (f"kernel: mm\ninput uint16: a(64, *)\n"
            f"output uint16: out(0, 0) = {expr}\n")


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_minmax_tcse_bit_exact(seed):
    """min/max reuse on random reduction trees: bit-exact, never an
    op-count regression, and still exact through the XLA backend."""
    from soda_tpu.optimize import tcse

    rng = random.Random(8000 + seed)
    src = gen_minmax_program(rng)
    p = parse(src)
    q = tcse.apply(p)
    assert tcse.count_ops(q) <= tcse.count_ops(p), f"op regression:\n{src}"
    x = np.random.default_rng(seed).integers(
        0, 60000, (32, 48)).astype(np.uint16)
    a = numpy_interp.run(p, {"a": x})["out"]
    b = numpy_interp.run(q, {"a": x})["out"]
    rim = max(p.valid_rim(), q.valid_rim())
    assert np.array_equal(interior(a, rim), interior(b, rim)), \
        f"minmax tcse mismatch:\n{src}"
    got = xla_backend.run(q, {"a": x})["out"]
    assert np.array_equal(interior(a, rim), interior(got, rim)), \
        f"minmax xla mismatch:\n{src}"


def gen_signed_chain(rng: random.Random, rank: int) -> str:
    """Chains engineered for MIXED-SIGN offsets — the constant-extent
    margin hazard (see StencilProgram.chain_creep)."""
    n = rng.randint(2, 4)
    tile = ", ".join(["64"] * (rank - 1) + ["*"])
    lines = ["kernel: sc", f"input float: a({tile})"]
    prev = "a"
    for i in range(n):
        offs = [tuple(rng.choice([-2, -1, 1, 2]) for _ in range(rank))
                for _ in range(rng.randint(1, 3))]
        expr = " + ".join(f"{prev}({', '.join(map(str, o))})" for o in offs)
        kind = "output" if i == n - 1 else "local"
        nm = "out" if kind == "output" else f"s{i}"
        anchor = ", ".join(["0"] * rank)
        lines.append(f"{kind} float: {nm}({anchor}) = ({expr}) * 0.4f")
        prev = nm
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_mixed_sign_chains(seed):
    """Mixed-sign stage chains through multi-tile host tiling and iterate —
    guards the non-cancelling chain-creep halos."""
    rng = random.Random(1500 + seed)
    rank = rng.choice([2, 3])
    src = gen_signed_chain(rng, rank)
    p = parse(src)
    it = rng.choice([1, 2, 4])
    shape = (64, 96) if rank == 2 else (24, 32, 64)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    gold = numpy_interp.run(p, {"a": x}, iterate=it)["out"]
    rim = p.valid_rim(iterate=it)
    ga = interior(gold, rim)
    if ga.size == 0:
        pytest.skip("rim exceeds grid")
    tiles = tuple(n // 2 for n in shape)
    got = run_host_tiled(p, {"a": x}, tiles=tiles, iterate=it,
                         sweeps_per_pass=1)["out"]
    assert np.allclose(interior(got, rim).astype(np.float64),
                       ga.astype(np.float64),
                       rtol=1e-3, atol=1e-3), f"mixed-sign:\n{src}"


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_host_tiling(seed):
    """Random programs (incl. mixed-sign chains) through the host-side
    sequential tiling path with random tile shapes and pass cadences —
    guards the tile halo/stitch geometry (parallel/host_tile.py)."""
    rng = random.Random(2500 + seed)
    rank = rng.choice([2, 3])
    src = (gen_signed_chain(rng, rank) if rng.random() < 0.5
           else gen_program(rng, rank))
    p = parse(src)
    it = rng.choice([1, 1, 2, 4])
    shape = (64, 96) if rank == 2 else (24, 32, 64)
    tiles = tuple(rng.choice([0, n // 2, n // 3 + 1, n])
                  for n in shape[:-1]) + (
        rng.choice([0, shape[-1], shape[-1] // 2]),)
    spp = rng.choice([None, 1, it])
    x = make_input(p, shape, np.random.default_rng(seed))
    gold = numpy_interp.run(p, {"a": x}, iterate=it)["out"]
    rim = p.valid_rim(iterate=it)
    ga = interior(gold, rim)
    if ga.size == 0:
        pytest.skip("rim exceeds grid")
    got = run_host_tiled(p, {"a": x}, tiles=tiles, iterate=it,
                         sweeps_per_pass=spp)["out"]
    assert np.allclose(interior(got, rim).astype(np.float64),
                       ga.astype(np.float64), rtol=1e-3, atol=1e-3), \
        f"host-tile mismatch (tiles={tiles}, spp={spp}, it={it}):\n{src}"
