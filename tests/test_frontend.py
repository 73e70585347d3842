"""Frontend tests: grammar, AST building, normalization, validation.

Mirrors the reference's unit tests for grammar parse / mutator shifts
(SURVEY.md §4, reconstructed)."""

import glob
import pathlib

import pytest

from soda_tpu.frontend.parser import parse, parse_file
from soda_tpu.ir import expr as ir
from soda_tpu.ir.types import ScalarType, promote

CORPUS = sorted(glob.glob(str(pathlib.Path(__file__).parent / "soda" / "*.soda")))


def test_corpus_parses():
    assert len(CORPUS) >= 8
    for f in CORPUS:
        p = parse_file(f)
        assert p.name
        assert p.rank in (1, 2, 3)
        assert p.output_names


def test_blur_structure():
    p = parse_file(pathlib.Path(__file__).parent / "soda" / "blur.soda")
    assert p.name == "blur"
    assert p.burst_width == 512
    assert p.unroll_factor == 16
    assert p.input_names == ["input"]  # tensor legally named `input`
    assert p.output_names == ["blur_y"]
    assert p.stage_order() == ["blur_x", "blur_y"]
    assert p.tensors["input"].tile_size == (2000, None)  # '*' streaming dim
    # blur_x taps: (0,0) (0,1) (0,2)
    w = p.tensors["blur_x"].window()
    assert sorted(w["input"]) == [(0, 0), (0, 1), (0, 2)]
    # cumulative span of blur_y covers rows -1..1, cols 0..2
    assert p.cumulative_span("blur_y") == ((-1, 1), (0, 2))
    assert p.radius() == 2


def test_anchor_normalization():
    # non-zero anchor on the LHS is normalized away (mutator.shift analog)
    p = parse(
        "kernel: t\n"
        "input float: a(64, *)\n"
        "output float: b(1, 1) = a(1, 1) + a(2, 1)\n"
    )
    w = p.tensors["b"].window()
    assert sorted(w["a"]) == [(0, 0), (1, 0)]


def test_cli_overrides_beat_dsl():
    src = "kernel: t\niterate: 2\nunroll factor: 4\ninput float: a(64, *)\noutput float: b(0,0) = a(0,0)\n"
    p = parse(src, overrides={"iterate": 8, "unroll_factor": 16, "burst_width": 256})
    assert p.iterate == 8
    assert p.unroll_factor == 16
    assert p.burst_width == 256


def test_expression_precedence():
    p = parse(
        "kernel: t\ninput int32: a(64, *)\n"
        "output int32: b(0,0) = a(0,0) + a(0,1) * 2 - a(1,0) / 4\n"
    )
    e = p.tensors["b"].expr
    # ((a + (a*2)) - (a/4))
    assert isinstance(e, ir.BinOp) and e.op == "-"
    assert isinstance(e.lhs, ir.BinOp) and e.lhs.op == "+"
    assert isinstance(e.lhs.rhs, ir.BinOp) and e.lhs.rhs.op == "*"
    assert isinstance(e.rhs, ir.BinOp) and e.rhs.op == "/"


def test_ternary_and_compare():
    p = parse(
        "kernel: t\ninput float: a(64, *)\n"
        "output float: b(0,0) = a(0,0) > 0.5f ? a(0,0) : 0.0f\n"
    )
    assert isinstance(p.tensors["b"].expr, ir.Select)


def test_param_and_call():
    p = parse(
        "kernel: t\nparam float, dup 3: c[3]\ninput float: a(64, *)\n"
        "output float: b(0,0) = max(a(0,0) * c[0], sqrt(a(0,1)))\n"
    )
    assert p.params["c"].shape == (3,)
    assert p.params["c"].dup == 3
    e = p.tensors["b"].expr
    assert isinstance(e, ir.Call) and e.fn == "max"


def test_undefined_tensor_rejected():
    with pytest.raises(ValueError, match="neither a declared tensor nor a known function"):
        parse("kernel: t\ninput float: a(64, *)\noutput float: b(0,0) = nosuch(0,0)\n")


def test_rank_mismatch_rejected():
    with pytest.raises(ValueError, match="rank"):
        parse("kernel: t\ninput float: a(64, 64, *)\noutput float: b(0,0) = a(0,0)\n")


def test_cycle_rejected():
    with pytest.raises(ValueError, match="cycle"):
        parse(
            "kernel: t\ninput float: a(64, *)\n"
            "local float: x(0,0) = y(0,0)\n"
            "local float: y(0,0) = x(0,1)\n"
            "output float: b(0,0) = x(0,0) + a(0,0)\n"
        )


def test_iterate_feedback_rules():
    # round 2: extra inputs are allowed as sweep-invariant auxiliaries; the
    # FIRST input is the iterated state and must type-match the output
    p = parse(
        "kernel: t\niterate: 2\n"
        "input float: a(64, *)\ninput float: c(64, *)\n"
        "output float: b(0,0) = a(0,0) + c(0,0)\n"
    )
    assert p.input_names[0] == "a"
    with pytest.raises(ValueError, match="feedback"):
        parse(
            "kernel: t\niterate: 2\n"
            "input uint16: a(64, *)\n"
            "output float: b(0,0) = a(0,0) + 1.0f\n"
        )


def test_types():
    assert ScalarType.parse("uint12").storage_width == 16
    assert ScalarType.parse("uint12").needs_mask
    assert not ScalarType.parse("uint16").needs_mask
    assert str(ScalarType.parse("double")) == "double"
    f32 = ScalarType.parse("float")
    i16 = ScalarType.parse("int16")
    u16 = ScalarType.parse("uint16")
    assert promote(f32, i16) == f32
    assert promote(i16, u16) == u16      # unsigned wins at equal width
    assert promote(i16, ScalarType.parse("int32")).width == 32


def test_shift_mutator():
    e = ir.BinOp("+", ir.Ref("a", (0, 1)), ir.Ref("b", (2, -1)))
    s = ir.shift(e, (1, 1))
    refs = ir.get_load_set(s)
    assert refs == [ir.Ref("a", (1, 2)), ir.Ref("b", (3, 0))]
    only_a = ir.shift(e, (1, 1), names={"a"})
    assert ir.get_load_set(only_a) == [ir.Ref("a", (1, 2)), ir.Ref("b", (2, -1))]


def test_substitute_inlining():
    # consumer reads producer at offset; inlining shifts producer body
    producer = ir.BinOp("+", ir.Ref("in", (0, 0)), ir.Ref("in", (0, 1)))
    consumer = ir.Ref("p", (1, 0))
    inlined = ir.substitute(consumer, "p", lambda off: ir.shift(producer, off))
    assert ir.get_load_set(inlined) == [ir.Ref("in", (1, 0)), ir.Ref("in", (1, 1))]


def test_comments_and_blank_lines():
    p = parse("# hello\n\nkernel: t\n# mid\ninput float: a(8, *)\n\noutput float: b(0,0) = a(0,0)  # trailing\n")
    assert p.name == "t"


def test_syntax_error_names_location():
    """Malformed .soda (e.g. missing ':') gets a friendly error naming the
    line and column, not a raw parser exception."""
    with pytest.raises(ValueError, match="syntax error at line 1"):
        parse("kernel blur\ninput float: a(*)\noutput float: b(0) = a(0)\n")


def test_multi_output_iterate_parses():
    """iterate > 1 with two outputs is SUPPORTED (docs/SEMANTICS.md
    "multi-output iterate"): the feedback pair is first-input <-
    FIRST-declared output; further outputs take their final-sweep values.
    The feedback pair's types must still match."""
    src = ("kernel: mo\niterate: 4\ninput float: a(64, *)\n"
           "output float: b(0,0) = a(-1,0) + a(1,0)\n"
           "output float: c(0,0) = a(0,-1) + a(0,1)\n")
    p = parse(src)
    assert p.output_names == ["b", "c"] and p.iterate == 4
    with pytest.raises(ValueError, match="matching feedback"):
        parse(src.replace("output float: b", "output int32: b"))


def test_uint256_rejected_with_documented_message():
    """Integer widths above 128 fail loudly, naming the supported surface
    (reference ap_uint<N> is arbitrary-width — PARITY.md deviation).
    uint65..uint128 PARSE and run on the oracle/XLA quad-limb paths
    (tests/test_wide128.py)."""
    src = ("kernel: w256\ninput uint256: a(64, *)\n"
           "output uint256: b(0,0) = a(0,0) + a(0,1)\n")
    with pytest.raises(ValueError, match="int1..int128.*PARITY"):
        parse(src)
    p = parse(src.replace("uint256", "uint128"))  # 128 parses
    assert p.tensors["a"].type.width == 128


def _to_source(p) -> str:
    """Print a StencilProgram back as `.soda` text (stage expressions via
    their str(), anchors normalized to zero)."""
    lines = [f"kernel: {p.name}", f"burst width: {p.burst_width}",
             f"iterate: {p.iterate}", f"unroll factor: {p.unroll_factor}",
             f"border: {p.border}", f"cluster: {p.cluster}"]
    for q in p.params.values():
        attrs = f", dup {q.dup}" if q.dup is not None else ""
        if q.partition is not None:
            kind, _, factor = q.partition.partition(":")
            attrs += f", partition {kind}" + (
                f" factor = {factor}" if factor else "")
        lines.append(f"param {q.type}{attrs}: {q.name}"
                     + "".join(f"[{d}]" for d in q.shape))
    for n, t in p.tensors.items():
        dram = "dram " + ", ".join(map(str, t.dram)) + " "
        if t.is_input:
            tiles = ", ".join("*" if d is None else str(d)
                              for d in t.tile_size)
            lines.append(f"input {dram}{t.type}: {n}({tiles})")
        else:
            anchor = ", ".join(["0"] * p.rank)
            kind = f"output {dram}" if t.is_output else "local "
            lines.append(f"{kind}{t.type}: {n}({anchor}) = {t.expr}")
    return "\n".join(lines) + "\n"


def _fields(p):
    return (p.name, p.rank, p.burst_width, p.iterate, p.unroll_factor,
            p.border, p.cluster, p.tensors, p.params)


@pytest.mark.parametrize("path", CORPUS,
                         ids=[pathlib.Path(c).stem for c in CORPUS])
def test_parse_print_roundtrip(path):
    """parse -> print (str of every expression) -> parse gives an equal
    program: precedence, unary minus, casts, refs vs calls and param
    subscripts all survive the round trip."""
    p = parse_file(path)
    q = parse(_to_source(p))
    assert _fields(q) == _fields(p)
    assert _to_source(q) == _to_source(p)


def test_keywords_as_names_and_attributes():
    """Statement keywords are legal tensor names; param attributes and
    dram lists parse."""
    p = parse("kernel: output\ninput dram 0, 1 uint16: input(8, *)\n"
              "param float, dup 2, partition cyclic factor = 4: c[2][3]\n"
              "output dram 2 uint16: output(0, 0) = input(0, 1) + "
              "uint16(c[1][2])\n")
    assert p.name == "output"
    assert p.tensors["input"].dram == (0, 1)
    assert p.tensors["output"].dram == (2,)
    assert p.params["c"].shape == (2, 3)
    assert p.params["c"].dup == 2
    assert p.params["c"].partition == "cyclic:4"


def test_syntax_error_at_end_of_input():
    """Truncated input points past the end of the last line."""
    with pytest.raises(ValueError, match="line 3, column 23"):
        parse("kernel: t\ninput float: a(8, *)\noutput float: b(0,0) =")
