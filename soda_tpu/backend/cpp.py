"""C++ golden-runner generator: the native correctness oracle.

The reference's generated OpenCL host embeds a naive C++ loop nest as its
golden model (src/soda/codegen/xilinx/host.py per SURVEY.md §2.2/§4,
reconstructed — empty mount).  This module preserves that property: it
generates a standalone C++ program implementing the same
stencil semantics (zero-fill taps, int64 accumulators, C division, width
masking at stores, float32 literals), compiles it with g++, and runs it on
raw binary tensors, so device results are validated against native C++
exactly as the reference validates FPGA results.

Expression evaluation order is preserved verbatim from the IR (no
reassociation), matching the bit-consistency requirement of the north star.
"""

from __future__ import annotations

import pathlib
import subprocess
import tempfile
from typing import Mapping

import numpy as np

from ..ir import expr as ir
from ..ir.program import StencilProgram
from ..ir.types import ScalarType

_HEADER = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

static inline int64_t mask_int(int64_t v, int width, bool is_signed) {
  if (width >= 64) return v;
  uint64_t m = (uint64_t(1) << width) - 1;
  uint64_t u = uint64_t(v) & m;
  if (is_signed) {
    uint64_t sign = uint64_t(1) << (width - 1);
    if (u & sign) return int64_t(u) - (int64_t(1) << width);
  }
  return int64_t(u);
}
// 128-bit carrier variants (gcc native __int128 — quad-limb DSL widths)
static inline __int128 mask_int128(__int128 v, int width, bool is_signed) {
  if (width >= 128) return v;
  unsigned __int128 m = (((unsigned __int128)1) << width) - 1;
  unsigned __int128 u = (unsigned __int128)v & m;
  if (is_signed && ((u >> (width - 1)) & 1)) u |= ~m;
  return (__int128)u;
}
template <typename T> static inline T c_div(T a, T b) { return a / b; }  // C trunc
template <typename T> static inline T c_mod(T a, T b) { return a % b; }
template <typename T> static inline T c_abs(T a) { return a < 0 ? T(-a) : a; }
"""


def _cpp_float(v: float, width: int) -> str:
    if width == 64:
        return repr(float(v))
    return f"{float(np.float32(v))!r}f"


class _Gen:
    """Expression -> C++ with DSL type tracking.

    Integers are carried as int64_t; floats as float/double.  Matches
    interp/evaluator.py semantics operation for operation."""

    def __init__(self, program: StencilProgram, idx_vars: list[str]):
        from ..interp.wide128 import program_is_128

        self.p = program
        self.idx = idx_vars
        # >64-bit programs carry ALL ints in gcc __int128 (matching the
        # evaluator's int_width=128 wide-accumulator semantics)
        self.acc128 = program_is_128(program)

    def ctype(self, t: ScalarType) -> str:
        if t.is_float:
            # _Float16 arithmetic rounds per-op exactly like numpy float16
            # (both compute via f32 and round back), keeping the oracle
            # chain bit-exact for `half` programs
            return {16: "_Float16", 64: "double"}.get(t.width, "float")
        if self.acc128:
            # full-width unsigned rides unsigned (matches acc_of at 128)
            return ("unsigned __int128"
                    if t.kind == "uint" and t.width >= 128 else "__int128")
        # full-width unsigned rides an unsigned carrier so value-dependent
        # ops (/ % < >>) see true values (matches evaluator.acc_of)
        return "uint64_t" if t.kind == "uint" and t.width >= 64 else "int64_t"

    def int_literal(self, v: int) -> str:
        if not self.acc128:
            return f"int64_t({v})"
        if -(2 ** 63) <= v < 2 ** 63:
            return f"(__int128)INT64_C({v})"
        u = v & ((1 << 128) - 1)
        hi, lo = u >> 64, u & ((1 << 64) - 1)
        return (f"((__int128)(((unsigned __int128){hi}ULL << 64) "
                f"| {lo}ULL))")

    def cast_to(self, code: str, src: ScalarType, dst: ScalarType) -> str:
        if dst.is_float:
            return f"({self.ctype(dst)})({code})"
        if src.is_float:
            if self.acc128:
                # double -> __int128 is defined for in-range values and
                # matches the oracle's f64-precision conversion
                code = f"(__int128)std::trunc({code})"
            else:
                # route through int64 then reinterpret: float->unsigned of
                # a negative value is UB in C++, while float->int64 +
                # two's-complement wrap is defined for |v| < 2^63 and
                # matches the oracle's conversion
                code = f"(int64_t)std::trunc({code})"
        mask_fn = "mask_int128" if self.acc128 else "mask_int"
        return (f"({self.ctype(dst)}){mask_fn}({code}, {dst.width}, "
                f"{str(dst.kind == 'int').lower()})")

    def tap(self, name: str, off: tuple[int, ...]) -> tuple[str, ScalarType]:
        t = self.p.tensors[name].type
        idx = [f"({v} + ({o}))" for v, o in zip(self.idx, off)]
        bounds = " && ".join(
            f"({i} >= 0 && {i} < (int64_t)d{d})" for d, i in enumerate(idx))
        at = f"{name}_a[" + self._lin(idx) + "]"
        zero = "0" if t.is_int else ("0.0" if t.width == 64 else "0.0f")
        val = f"(({bounds}) ? ({self.ctype(t)})({at}) : {zero})"
        return val, t

    def _lin(self, idx: list[str]) -> str:
        out = idx[0]
        for d in range(1, len(idx)):
            out = f"({out}) * (int64_t)d{d} + ({idx[d]})"
        return out

    def emit(self, e: ir.Expr) -> tuple[str, ScalarType]:
        from ..ir.types import promote

        F32 = ScalarType("float", 32)
        I32 = ScalarType("int", 32)
        if isinstance(e, ir.Const):
            if isinstance(e.value, float):
                t = e.type or F32
                return _cpp_float(e.value, t.width), t
            return self.int_literal(e.value), e.type or I32
        if isinstance(e, ir.Ref):
            return self.tap(e.name, e.offsets)
        if isinstance(e, ir.ParamRef):
            p = self.p.params[e.name]
            lin = 0
            for i, d in zip(e.indices, p.shape):
                lin = lin * d + i
            c = f"{e.name}_p[{lin}]"
            if p.type.is_int:
                c = f"({self.ctype(p.type)}){c}"
            return c, p.type
        if isinstance(e, ir.Var):
            p = self.p.params[e.name]
            c = f"{e.name}_p[0]"
            if p.type.is_int:
                c = f"({self.ctype(p.type)}){c}"
            return c, p.type
        if isinstance(e, ir.Cast):
            c, src = self.emit(e.operand)
            return self.cast_to(c, src, e.type), e.type
        if isinstance(e, ir.UnOp):
            c, t = self.emit(e.operand)
            if e.op == "!":
                acc = "__int128" if self.acc128 else "int64_t"
                return f"({acc})(!({c}))", I32
            if e.op == "~":
                return f"(~({c}))", t
            return f"({e.op}({c}))", t
        if isinstance(e, ir.Select):
            cc, _ = self.emit(e.cond)
            ac, at = self.emit(e.on_true)
            bc, bt = self.emit(e.on_false)
            t = promote(at, bt)
            ac = self._coerce(ac, at, t)
            bc = self._coerce(bc, bt, t)
            return f"(({cc}) ? ({ac}) : ({bc}))", t
        if isinstance(e, ir.BinOp):
            ac, at = self.emit(e.lhs)
            bc, bt = self.emit(e.rhs)
            op = e.op
            acc_c = "__int128" if self.acc128 else "int64_t"
            if op in ("&&", "||"):
                return f"({acc_c})(({ac}) != 0 {op} ({bc}) != 0)", I32
            if op in ("==", "!=", "<", ">", "<=", ">="):
                t = promote(at, bt)
                return f"({acc_c})(({self._coerce(ac, at, t)}) {op} ({self._coerce(bc, bt, t)}))", I32
            if op in ("<<", ">>"):
                return f"(({ac}) {op} ({bc}))", at
            t = promote(at, bt)
            ac = self._coerce(ac, at, t)
            bc = self._coerce(bc, bt, t)
            uw = 128 if self.acc128 else 64
            if op == "/" and t.is_int:
                if t.kind == "uint" and t.width >= uw:
                    return f"(({ac}) / ({bc}))", t  # unsigned / is already trunc
                return f"c_div({ac}, {bc})", t
            if op == "%" and t.is_int:
                if t.kind == "uint" and t.width >= uw:
                    return f"(({ac}) % ({bc}))", t
                return f"c_mod({ac}, {bc})", t
            if op == "%":
                return f"std::fmod({ac}, {bc})", t
            if t.is_float and t.width == 16:
                # force per-op rounding: GCC evaluates chained _Float16
                # arithmetic with f32 excess precision, but numpy float16
                # rounds after EVERY op — the explicit cast restores that
                return f"(_Float16)(({ac}) {op} ({bc}))", t
            return f"(({ac}) {op} ({bc}))", t
        if isinstance(e, ir.Call):
            args = [self.emit(a) for a in e.args]
            from ..ir.types import promote as pr

            if e.fn in ("min", "max", "fmin", "fmax"):
                t = args[0][1]
                for _, u in args[1:]:
                    t = pr(t, u)
                if e.fn in ("fmin", "fmax") and not t.is_float:
                    t = F32
                fn = "std::min" if e.fn in ("min", "fmin") else "std::max"
                cs = [self._coerce(c, u, t) for c, u in args]
                out = cs[0]
                for c in cs[1:]:
                    out = f"{fn}<{self.ctype(t)}>({out}, {c})"
                return out, t
            if e.fn == "abs":
                c, t = args[0]
                if t.is_int and t.kind == "uint" and t.width >= 64:
                    return c, t  # abs of unsigned is the identity
                if t.is_int and self.acc128:
                    return f"c_abs({c})", t  # std::abs lacks __int128
                return (f"std::abs({c})", t)
            if e.fn == "pow":
                t = pr(pr(args[0][1], args[1][1]), F32)
                return (f"std::pow({self._coerce(args[0][0], args[0][1], t)}, "
                        f"{self._coerce(args[1][0], args[1][1], t)})", t)
            if e.fn == "rsqrt":
                t = pr(args[0][1], F32)
                one = "1.0" if t.width == 64 else "1.0f"
                return f"({one} / std::sqrt({self._coerce(args[0][0], args[0][1], t)}))", t
            if e.fn in ("atan2", "copysign", "hypot"):
                t = pr(pr(args[0][1], args[1][1]), F32)
                return (f"std::{e.fn}({self._coerce(args[0][0], args[0][1], t)}, "
                        f"{self._coerce(args[1][0], args[1][1], t)})", t)
            cpp = {"fabs": "std::fabs", "round": "std::round"}.get(
                e.fn, f"std::{e.fn}")
            t = pr(args[0][1], F32)
            return f"{cpp}({self._coerce(args[0][0], args[0][1], t)})", t
        raise TypeError(f"cannot emit {e!r}")

    def _coerce(self, code: str, src: ScalarType, dst: ScalarType) -> str:
        if dst.is_float and (src.is_int or src.width != dst.width):
            return f"({self.ctype(dst)})({code})"
        if dst.is_int and src.is_int and self.ctype(src) != self.ctype(dst):
            return f"({self.ctype(dst)})({code})"  # signed<->unsigned carrier
        return code


def generate(program: StencilProgram, grid_shape: tuple[int, ...],
             iterate: int | None = None) -> str:
    """Generate a standalone C++ golden runner.

    CLI of the generated binary:
        ./golden <in0.bin> [<in1.bin> ...] [<param0.bin> ...] <out0.bin> [...]
    Raw little-endian row-major arrays in declared storage dtypes."""
    it = max(program.iterate if iterate is None else iterate, 1)
    rank = program.rank
    dims = ", ".join(str(d) for d in grid_shape)
    idx = [f"i{d}" for d in range(rank)]
    g = _Gen(program, idx)

    lines = [_HEADER]
    lines.append(f"// generated by soda_tpu for kernel `{program.name}`")
    lines.append("int main(int argc, char** argv) {")
    for d, n in enumerate(grid_shape):
        lines.append(f"  const size_t d{d} = {n};")
    lines.append(f"  const size_t total = {'*'.join(f'd{d}' for d in range(rank))};")

    order = program.stage_order()
    all_tensors = program.input_names + order
    argi = 1
    loads = []
    for n in program.input_names:
        t = program.tensors[n].type
        lines.append(f"  std::vector<{t.cpp_type()}> {n}_a(total);")
        loads.append((n, t, argi))
        argi += 1
    for p in program.params.values():
        cnt = int(np.prod(p.shape)) if p.shape else 1
        lines.append(f"  std::vector<{p.type.cpp_type()}> {p.name}_p({cnt});")
        loads.append((p.name + "_p@", p.type, argi))
        argi += 1
    for n in order:
        t = program.tensors[n].type
        lines.append(f"  std::vector<{t.cpp_type()}> {n}_a(total);")
    out_args = {}
    for n in program.output_names:
        out_args[n] = argi
        argi += 1
    lines.append(f"  if (argc != {argi}) {{ std::fprintf(stderr, \"expected {argi-1} file args\\n\"); return 2; }}")
    for name, t, ai in loads:
        vec = name[:-1] if name.endswith("@") else name + "_a"
        lines.append(f"  {{ FILE* f = std::fopen(argv[{ai}], \"rb\");")
        lines.append(f"    if (!f || std::fread({vec}.data(), sizeof({t.cpp_type()}), {vec}.size(), f) != {vec}.size()) {{ std::fprintf(stderr, \"read %s failed\\n\", argv[{ai}]); return 2; }} std::fclose(f); }}")

    lines.append(f"  for (int sweep = 0; sweep < {it}; ++sweep) {{")
    for n in order:
        t = program.tensors[n].type
        body, bt = g.emit(program.tensors[n].expr)
        loop = "    "
        for d in range(rank):
            lines.append(f"{loop}for (int64_t i{d} = 0; i{d} < (int64_t)d{d}; ++i{d})")
            loop += "  "
        store = g.cast_to(f"__v_{n}", bt, t)
        lin = g._lin([f"i{d}" for d in range(rank)])
        lines.append(f"{loop}{{ {g.ctype(bt)} __v_{n} = {body};")
        lines.append(f"{loop}  {n}_a[{lin}] = ({t.cpp_type()})({store}); }}")
    if it > 1:
        i0, o0 = program.input_names[0], program.output_names[0]
        lines.append(f"    if (sweep + 1 < {it}) {i0}_a = {o0}_a;")
    lines.append("  }")

    for n, ai in out_args.items():
        t = program.tensors[n].type
        lines.append(f"  {{ FILE* f = std::fopen(argv[{ai}], \"wb\");")
        lines.append(f"    std::fwrite({n}_a.data(), sizeof({t.cpp_type()}), {n}_a.size(), f); std::fclose(f); }}")
    lines.append("  return 0;\n}")
    return "\n".join(lines)


_SHARED_TEMPLATE = r"""
// shared-library entry: in-process oracle callable via ctypes
extern "C" int soda_golden_run(%(args)s) {
%(body)s
  return 0;
}
"""


def generate_shared(program: StencilProgram, grid_shape: tuple[int, ...],
                    iterate: int | None = None) -> str:
    """Generate a shared-library variant of the golden runner.

    Exposes `int soda_golden_run(const <t0>* in0, ..., const <p0>* par0,
    ..., <o0>* out0, ...)` operating on caller-owned row-major buffers — the
    in-process native oracle (ctypes binding in NativeOracle), avoiding
    subprocess + file IO per verification."""
    it = max(program.iterate if iterate is None else iterate, 1)
    rank = program.rank
    idx = [f"i{d}" for d in range(rank)]
    g = _Gen(program, idx)
    order = program.stage_order()

    args = []
    for n in program.input_names:
        args.append(f"const {program.tensors[n].type.cpp_type()}* {n}_in")
    for p in program.params.values():
        args.append(f"const {p.type.cpp_type()}* {p.name}_p")
    for n in program.output_names:
        args.append(f"{program.tensors[n].type.cpp_type()}* {n}_out")

    body = []
    for d, n in enumerate(grid_shape):
        body.append(f"  const size_t d{d} = {n};")
    body.append(f"  const size_t total = {'*'.join(f'd{d}' for d in range(rank))};")
    for n in program.input_names:
        t = program.tensors[n].type
        body.append(f"  std::vector<{t.cpp_type()}> {n}_a({n}_in, {n}_in + total);")
    for n in order:
        t = program.tensors[n].type
        body.append(f"  std::vector<{t.cpp_type()}> {n}_a(total);")
    body.append(f"  for (int sweep = 0; sweep < {it}; ++sweep) {{")
    for n in order:
        t = program.tensors[n].type
        expr_code, bt = g.emit(program.tensors[n].expr)
        loop = "    "
        for d in range(rank):
            body.append(f"{loop}for (int64_t i{d} = 0; i{d} < (int64_t)d{d}; ++i{d})")
            loop += "  "
        store = g.cast_to(f"__v_{n}", bt, t)
        lin = g._lin([f"i{d}" for d in range(rank)])
        body.append(f"{loop}{{ {g.ctype(bt)} __v_{n} = {expr_code};")
        body.append(f"{loop}  {n}_a[{lin}] = ({t.cpp_type()})({store}); }}")
    if it > 1:
        i0, o0 = program.input_names[0], program.output_names[0]
        body.append(f"    if (sweep + 1 < {it}) {i0}_a = {o0}_a;")
    body.append("  }")
    for n in program.output_names:
        t = program.tensors[n].type
        body.append(
            f"  std::memcpy({n}_out, {n}_a.data(), total * sizeof({t.cpp_type()}));")

    return _HEADER + _SHARED_TEMPLATE % {
        "args": ", ".join(args), "body": "\n".join(body)}


class NativeOracle:
    """In-process C++ golden oracle: g++-compiled shared library bound via
    ctypes (the native verification data path — no subprocess, no file IO).
    """

    def __init__(self, program: StencilProgram, grid_shape: tuple[int, ...],
                 iterate: int | None = None,
                 workdir: str | pathlib.Path | None = None):
        import ctypes

        self.program = program
        self.grid_shape = tuple(grid_shape)
        src = generate_shared(program, self.grid_shape, iterate)
        tmp = pathlib.Path(workdir) if workdir else pathlib.Path(
            tempfile.mkdtemp(prefix=f"soda_oracle_{program.name}_"))
        tmp.mkdir(parents=True, exist_ok=True)
        cpp_path = tmp / "oracle.cpp"
        cpp_path.write_text(src)
        so = tmp / "oracle.so"
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
             "-o", str(so), str(cpp_path)],
            check=True, capture_output=True)
        self._lib = ctypes.CDLL(str(so))
        self._fn = self._lib.soda_golden_run
        self._fn.restype = ctypes.c_int

    def run(self, inputs: Mapping[str, np.ndarray],
            params: Mapping[str, np.ndarray] | None = None
            ) -> dict[str, np.ndarray]:
        import ctypes

        params = dict(params or {})
        p = self.program
        bufs = []
        for n in p.input_names:
            t = p.tensors[n].type
            a = np.ascontiguousarray(np.asarray(inputs[n], dtype=t.np_dtype()))
            if a.shape != self.grid_shape:
                raise ValueError(f"input {n!r} shape {a.shape} != {self.grid_shape}")
            bufs.append(a)
        for pr in p.params.values():
            bufs.append(np.ascontiguousarray(
                np.asarray(params[pr.name], dtype=pr.type.np_dtype())))
        outs = {}
        for n in p.output_names:
            t = p.tensors[n].type
            outs[n] = np.empty(self.grid_shape, dtype=t.np_dtype())
            bufs.append(outs[n])
        rc = self._fn(*(b.ctypes.data_as(ctypes.c_void_p) for b in bufs))
        if rc != 0:
            raise RuntimeError(f"native oracle failed rc={rc}")
        return outs


def compile_and_run(
    program: StencilProgram,
    inputs: Mapping[str, np.ndarray],
    params: Mapping[str, np.ndarray] | None = None,
    iterate: int | None = None,
    workdir: str | pathlib.Path | None = None,
) -> dict[str, np.ndarray]:
    """Generate, g++ -O2 compile, and execute the golden runner."""
    params = dict(params or {})
    grid_shape = tuple(np.asarray(next(iter(inputs.values()))).shape)
    src = generate(program, grid_shape, iterate)
    tmp = pathlib.Path(workdir) if workdir else pathlib.Path(
        tempfile.mkdtemp(prefix=f"soda_golden_{program.name}_"))
    tmp.mkdir(parents=True, exist_ok=True)
    cpp = tmp / "golden.cpp"
    cpp.write_text(src)
    exe = tmp / "golden"
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", str(exe), str(cpp)],
                   check=True, capture_output=True)
    def _tofile(arr, t: ScalarType, f: pathlib.Path):
        if t.np_dtype() == np.dtype(object):
            # >64-bit ints: 16-byte little-endian per element (matches
            # sizeof(unsigned __int128) layout on x86)
            a = np.asarray(arr, dtype=object).reshape(-1)
            f.write_bytes(b"".join(
                (int(v) & ((1 << 128) - 1)).to_bytes(16, "little")
                for v in a))
            return
        np.ascontiguousarray(np.asarray(arr, dtype=t.np_dtype())).tofile(f)

    args = [str(exe)]
    for n in program.input_names:
        t = program.tensors[n].type
        f = tmp / f"in_{n}.bin"
        _tofile(inputs[n], t, f)
        args.append(str(f))
    for p in program.params.values():
        f = tmp / f"par_{p.name}.bin"
        _tofile(params[p.name], p.type, f)
        args.append(str(f))
    out_files = {}
    for n in program.output_names:
        f = tmp / f"out_{n}.bin"
        out_files[n] = f
        args.append(str(f))
    subprocess.run(args, check=True, capture_output=True)
    res = {}
    for n, f in out_files.items():
        t = program.tensors[n].type
        if t.np_dtype() == np.dtype(object):
            raw = f.read_bytes()
            vals = [int.from_bytes(raw[i * 16:(i + 1) * 16], "little")
                    for i in range(len(raw) // 16)]
            if t.is_signed:
                vals = [v - (1 << 128) if v >= (1 << 127) else v
                        for v in vals]
            res[n] = np.array(vals, dtype=object).reshape(grid_shape)
        else:
            res[n] = np.fromfile(f, dtype=t.np_dtype()).reshape(grid_shape)
    return res
