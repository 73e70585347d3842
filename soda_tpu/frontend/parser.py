"""`.soda` parser: hand-written recursive descent -> raw statement objects
-> StencilProgram.

Analog of the reference's src/sodac frontend dispatch + src/soda/grammar.py
textX semantic classes (SodaProgram, InputStmt, LocalStmt, OutputStmt,
ParamStmt, directive stmts) — reconstructed per SURVEY.md §2.1/§2.4 (empty
reference mount; no file:line cites possible).

Surface (one statement per line, `#` starts a comment):

    kernel: NAME            burst width: INT        iterate: INT
    unroll factor: INT      border: NAME            cluster: NAME
    input [dram INT(,INT)*] TYPE: NAME(TILE, ...)         TILE = INT | *
    local TYPE: NAME(SINT, ...) = EXPR
    output [dram INT(,INT)*] TYPE: NAME(SINT, ...) = EXPR
    param TYPE(, dup INT | , partition NAME [factor = INT])*: NAME([INT])*

Expressions use C precedence (?: || && | ^ & ==/!= relational shifts
additive multiplicative unary) over casts `TYPE(e)`, applications
`name(e, ...)`, param subscripts `name[e]...`, bare names and numbers.
Statement keywords are also legal tensor names (the canonical blur example
names its input tensor `input`).

Ref-vs-call disambiguation: `t(0, 1)` parses as a generic Apply; the builder
resolves it to a tensor Ref when `t` is a declared tensor (offsets must fold
to integer constants) and to a math Call otherwise.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re
from typing import Any

from ..ir import expr as ir
from ..ir.program import Param, StencilProgram, Tensor
from ..ir.types import ScalarType


# ---- raw statements ----------------------------------------------------------


@dataclasses.dataclass
class _Apply(ir.Expr):
    """Unresolved name(args...) — becomes Ref or Call during build."""

    name: str
    args: tuple[ir.Expr, ...]

    def children(self):
        return self.args


@dataclasses.dataclass
class RawInput:
    type: ScalarType
    name: str
    tile_size: tuple[int | None, ...]
    dram: tuple[int, ...]


@dataclasses.dataclass
class RawStage:
    kind: str  # 'local' | 'output'
    type: ScalarType
    name: str
    anchor: tuple[int, ...]
    expr: ir.Expr
    dram: tuple[int, ...]


@dataclasses.dataclass
class RawParam:
    type: ScalarType
    name: str
    shape: tuple[int, ...]
    dup: int | None
    partition: str | None


@dataclasses.dataclass
class RawProgram:
    name: str | None = None
    burst_width: int = 512
    iterate: int = 1
    unroll_factor: int = 1
    border: str = "ignore"
    cluster: str = "none"
    inputs: list[RawInput] = dataclasses.field(default_factory=list)
    stages: list[RawStage] = dataclasses.field(default_factory=list)
    params: list[RawParam] = dataclasses.field(default_factory=list)


# ---- lexer -------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>[ \t]+|\#[^\n]*)
  | (?P<nl>(?:\r?\n)+)
  | (?P<hex>0[xX][0-9a-fA-F]+)
  | (?P<float>(?:(?:\d+\.\d*|\.\d+)(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)[fF]?|\d+[fF])
  | (?P<int>\d+)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>\|\||&&|==|!=|<=|>=|<<|>>|[-+*/%<>&|^!~?:(),\[\]=])
""", re.VERBOSE)

_TYPE_RE = re.compile(r"u?int[0-9]+|float(?:16|32|64)?|double|half")

# binary operators by precedence level, loosest first (C order)
_BINARY_LEVELS = (
    ("||",), ("&&",), ("|",), ("^",), ("&",), ("==", "!="),
    ("<", ">", "<=", ">="), ("<<", ">>"), ("+", "-"), ("*", "/", "%"),
)


@dataclasses.dataclass(frozen=True)
class _Tok:
    kind: str  # nl | hex | float | int | name | op | eof
    text: str
    pos: int


class _SyntaxError(Exception):
    def __init__(self, pos: int):
        super().__init__(pos)
        self.pos = pos


def _tokenize(text: str) -> list[_Tok]:
    toks = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise _SyntaxError(pos)
        if m.lastgroup != "ws":
            toks.append(_Tok(m.lastgroup, m.group(), pos))
        pos = m.end()
    toks.append(_Tok("eof", "", len(text)))
    return toks


class _Parser:
    """Recursive descent over the token list; one method per rule."""

    def __init__(self, text: str):
        self.toks = _tokenize(text)
        self.i = 0

    # -- token helpers
    @property
    def tok(self) -> _Tok:
        return self.toks[self.i]

    def fail(self):
        raise _SyntaxError(self.tok.pos)

    def at(self, text: str) -> bool:
        return self.tok.kind in ("op", "name") and self.tok.text == text

    def accept(self, text: str) -> bool:
        if self.at(text):
            self.i += 1
            return True
        return False

    def expect(self, text: str) -> None:
        if not self.accept(text):
            self.fail()

    def take(self, kind: str) -> str:
        if self.tok.kind != kind:
            self.fail()
        self.i += 1
        return self.toks[self.i - 1].text

    def name(self) -> str:
        return self.take("name")

    def integer(self) -> int:
        return int(self.take("int"))

    def signed_int(self) -> int:
        if self.accept("-"):
            return -self.integer()
        self.accept("+")
        return self.integer()

    def type(self) -> ScalarType:
        if self.tok.kind != "name" or not _TYPE_RE.fullmatch(self.tok.text):
            self.fail()
        return ScalarType.parse(self.take("name"))

    # -- program
    def program(self) -> RawProgram:
        prog = RawProgram()
        while True:
            while self.tok.kind == "nl":
                self.i += 1
            if self.tok.kind == "eof":
                return prog
            self.statement(prog)
            if self.tok.kind not in ("nl", "eof"):
                self.fail()

    def statement(self, prog: RawProgram) -> None:
        kw = self.name()
        if kw in ("kernel", "border", "cluster"):
            self.expect(":")
            setattr(prog, "name" if kw == "kernel" else kw, self.name())
        elif kw in ("burst", "unroll"):
            self.expect("width" if kw == "burst" else "factor")
            self.expect(":")
            setattr(prog, "burst_width" if kw == "burst" else "unroll_factor",
                    self.integer())
        elif kw == "iterate":
            self.expect(":")
            prog.iterate = self.integer()
        elif kw == "input":
            dram = self.dram_spec()
            typ = self.type()
            self.expect(":")
            name = self.name()
            self.expect("(")
            tiles = [self.tile_dim()]
            while self.accept(","):
                tiles.append(self.tile_dim())
            self.expect(")")
            prog.inputs.append(RawInput(typ, name, tuple(tiles), dram))
        elif kw in ("local", "output"):
            dram = self.dram_spec() if kw == "output" else (1,)
            typ = self.type()
            self.expect(":")
            name = self.name()
            self.expect("(")
            anchor = [self.signed_int()]
            while self.accept(","):
                anchor.append(self.signed_int())
            self.expect(")")
            self.expect("=")
            prog.stages.append(RawStage(kw, typ, name, tuple(anchor),
                                        self.expr(), dram))
        elif kw == "param":
            typ = self.type()
            dup = part = None
            while self.accept(","):
                if self.accept("dup"):
                    dup = self.integer()
                else:
                    self.expect("partition")
                    part = self.name()
                    if self.accept("factor"):
                        self.expect("=")
                        part += f":{self.integer()}"
            self.expect(":")
            name = self.name()
            shape = []
            while self.accept("["):
                shape.append(self.integer())
                self.expect("]")
            prog.params.append(RawParam(typ, name, tuple(shape), dup, part))
        else:
            self.i -= 1
            self.fail()

    def dram_spec(self) -> tuple[int, ...]:
        if not self.accept("dram"):
            return (1,)
        banks = [self.integer()]
        while self.accept(","):
            banks.append(self.integer())
        return tuple(banks)

    def tile_dim(self) -> int | None:
        return None if self.accept("*") else self.integer()

    # -- expressions
    def expr(self) -> Any:
        cond = self.binary(0)
        if not self.accept("?"):
            return cond
        on_true = self.expr()
        self.expect(":")
        return ir.Select(cond, on_true, self.expr())

    def binary(self, level: int) -> Any:
        if level == len(_BINARY_LEVELS):
            return self.unary()
        lhs = self.binary(level + 1)
        while self.tok.kind == "op" and self.tok.text in _BINARY_LEVELS[level]:
            op = self.take("op")
            lhs = ir.BinOp(op, lhs, self.binary(level + 1))
        return lhs

    def unary(self) -> Any:
        if self.tok.kind == "op" and self.tok.text in ("-", "+", "!", "~"):
            op = self.take("op")
            return ir.UnOp(op, self.unary())
        return self.atom()

    def atom(self) -> Any:
        kind, text = self.tok.kind, self.tok.text
        if kind == "int":
            return ir.Const(int(self.take("int")))
        if kind == "hex":
            return ir.Const(int(self.take("hex"), 16))
        if kind == "float":
            return ir.Const(float(self.take("float").rstrip("fF")))
        if self.accept("("):
            e = self.expr()
            self.expect(")")
            return e
        name = self.name()
        if self.accept("("):
            args = [self.expr()]
            while self.accept(","):
                args.append(self.expr())
            self.expect(")")
            if _TYPE_RE.fullmatch(text):
                if len(args) != 1:
                    self.fail()
                return ir.Cast(ScalarType.parse(text), args[0])
            return _Apply(name, tuple(args))
        if self.at("["):
            idxs = []
            while self.accept("["):
                idxs.append(self.expr())
                self.expect("]")
            return ("param_ref", name, tuple(idxs))
        return ("var", name)


def parse_raw(text: str) -> RawProgram:
    return _Parser(text).program()


# ---- build: raw -> StencilProgram --------------------------------------------


def _fold_int(e: ir.Expr) -> int | None:
    """Fold an expression to an int constant (for ref offsets)."""
    if isinstance(e, ir.Const) and isinstance(e.value, int):
        return e.value
    if isinstance(e, ir.UnOp) and e.op in ("-", "+"):
        v = _fold_int(e.operand)
        if v is not None:
            return -v if e.op == "-" else v
    return None


def _resolve(e: Any, tensor_names: set[str], param_names: set[str]) -> ir.Expr:
    """Resolve _Apply/var/param_ref placeholders into typed IR nodes."""
    if isinstance(e, _Apply):
        args = tuple(_resolve(a, tensor_names, param_names) for a in e.args)
        if e.name in tensor_names:
            offs = tuple(_fold_int(a) for a in args)
            if any(o is None for o in offs):
                raise ValueError(
                    f"tensor ref {e.name}(...) requires integer constant offsets")
            return ir.Ref(e.name, offs)  # type: ignore[arg-type]
        if e.name in ir.MATH_FNS:
            return ir.Call(e.name, args)
        raise ValueError(
            f"{e.name!r} is neither a declared tensor nor a known function "
            f"(known fns: {sorted(ir.MATH_FNS)})")
    if isinstance(e, tuple) and len(e) == 3 and e[0] == "param_ref":
        _, name, idx_exprs = e
        if name not in param_names:
            raise ValueError(f"subscripted name {name!r} is not a declared param")
        idxs = []
        for ie in idx_exprs:
            iv = _fold_int(_resolve(ie, tensor_names, param_names))
            if iv is None:
                raise ValueError(f"param index of {name!r} must be a constant")
            idxs.append(iv)
        return ir.ParamRef(name, tuple(idxs))
    if isinstance(e, tuple) and len(e) == 2 and e[0] == "var":
        name = e[1]
        if name in param_names:
            return ir.Var(name)
        raise ValueError(f"bare identifier {name!r} is not a declared param")
    if isinstance(e, ir.BinOp):
        return ir.BinOp(e.op, _resolve(e.lhs, tensor_names, param_names),
                        _resolve(e.rhs, tensor_names, param_names))
    if isinstance(e, ir.UnOp):
        return ir.UnOp(e.op, _resolve(e.operand, tensor_names, param_names))
    if isinstance(e, ir.Cast):
        return ir.Cast(e.type, _resolve(e.operand, tensor_names, param_names))
    if isinstance(e, ir.Select):
        return ir.Select(_resolve(e.cond, tensor_names, param_names),
                         _resolve(e.on_true, tensor_names, param_names),
                         _resolve(e.on_false, tensor_names, param_names))
    if isinstance(e, ir.Call):
        return ir.Call(e.fn, tuple(_resolve(a, tensor_names, param_names) for a in e.args))
    if isinstance(e, ir.Const):
        return e
    raise TypeError(f"unexpected node {e!r}")


def build_program(raw: RawProgram, overrides: dict | None = None) -> StencilProgram:
    """RawProgram -> validated StencilProgram.

    `overrides` mirrors the reference CLI-beats-DSL precedence
    (--unroll-factor / --iterate / --burst-width / --tile-size / --dram-*).
    """
    ov = overrides or {}
    if raw.name is None:
        raise ValueError("missing `kernel:` statement")
    if not raw.inputs:
        raise ValueError("missing `input` statement")
    rank = len(raw.inputs[0].tile_size)

    tensor_names = {i.name for i in raw.inputs} | {s.name for s in raw.stages}
    param_names = {p.name for p in raw.params}

    tensors: dict[str, Tensor] = {}
    for i, rinp in enumerate(raw.inputs):
        tile = ov.get("tile_size", rinp.tile_size)
        dram = ov.get("dram_in", rinp.dram)
        tensors[rinp.name] = Tensor(
            name=rinp.name, type=rinp.type, expr=None,
            dram=tuple(dram), tile_size=tuple(tile))
    for st in raw.stages:
        body = _resolve(st.expr, tensor_names, param_names)
        # normalize: shift refs so the stage's own anchor is zero
        # (reference: mutator.shift offset normalization)
        if any(a != 0 for a in st.anchor):
            body = ir.shift(body, tuple(-a for a in st.anchor))
        dram = ov.get("dram_out", st.dram) if st.kind == "output" else st.dram
        tensors[st.name] = Tensor(
            name=st.name, type=st.type, expr=body,
            dram=tuple(dram), is_output=(st.kind == "output"))

    params = {
        p.name: Param(p.name, p.type, p.shape, p.dup, p.partition)
        for p in raw.params
    }

    return StencilProgram(
        name=raw.name,
        tensors=tensors,
        params=params,
        rank=rank,
        burst_width=int(ov.get("burst_width", raw.burst_width)),
        iterate=int(ov.get("iterate", raw.iterate)),
        unroll_factor=int(ov.get("unroll_factor", raw.unroll_factor)),
        border=str(ov.get("border", raw.border)),
        cluster=str(ov.get("cluster", raw.cluster)),
    )


def parse(text: str, overrides: dict | None = None) -> StencilProgram:
    """Parse `.soda` source text into a validated StencilProgram."""
    try:
        raw = parse_raw(text)
    except _SyntaxError as e:
        lines = text.splitlines() or [""]
        ln = text.count("\n", 0, e.pos) + 1
        if ln > len(lines):
            # truncated input: point at the end of the source
            ln = len(lines)
            col = len(lines[-1]) + 1
        else:
            col = e.pos - (text.rfind("\n", 0, e.pos) + 1) + 1
        raise ValueError(
            f".soda syntax error at line {ln}, column {col}:\n"
            f"  {lines[ln - 1]}\n  {' ' * max(col - 1, 0)}^") from None
    return build_program(raw, overrides)


def parse_file(path: str | pathlib.Path, overrides: dict | None = None) -> StencilProgram:
    return parse(pathlib.Path(path).read_text(), overrides)
