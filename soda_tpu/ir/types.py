"""Scalar types for the soda_tpu IR.

Mirrors the type surface of the reference DSL (uint<N>/int<N> of arbitrary
width — HLS ``ap_uint<N>``/``ap_int<N>`` — plus float/double/half; reference:
haoda.ir types, reconstructed per SURVEY.md §0/§2.4).

Semantics decision (documented, differs from bit-exact ap_int width
growth): integer expressions are evaluated in a wide accumulator (int64
in the NumPy/C++ oracles, int32 on the XLA path for programs of 32-bit
types) and masked to the declared width only at stores and explicit
casts.  HLS ap_int arithmetic grows widths exactly (add -> w+1, mul ->
w1+w2), so exact-width evaluation never overflows mid-expression; a
64-bit accumulator reproduces that behavior for all widths <= 32 used in
practice.  The 32-bit path is validated against the int64 oracle by the
test suite; programs with >32-bit types run the XLA path in x64.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

_TYPE_RE = re.compile(r"^(u?int)([0-9]+)$")

_ALIASES = {
    "float": ("float", 32),
    "float32": ("float", 32),
    "double": ("float", 64),
    "float64": ("float", 64),
    "half": ("float", 16),
    "float16": ("float", 16),
}


@dataclasses.dataclass(frozen=True, order=True)
class ScalarType:
    """A DSL scalar type: kind in {'uint','int','float'} plus bit width."""

    kind: str
    width: int

    @staticmethod
    def parse(s: str) -> "ScalarType":
        s = s.strip()
        if s in _ALIASES:
            kind, width = _ALIASES[s]
            return ScalarType(kind, width)
        m = _TYPE_RE.match(s)
        if not m:
            raise ValueError(f"unknown type {s!r}")
        kind = "uint" if m.group(1) == "uint" else "int"
        width = int(m.group(2))
        if not 1 <= width <= 128:
            # The reference's ap_[u]int<N> is arbitrary-width; this
            # compiler supports 1..128 (1..64 native, 65..128 as
            # quad-limb carriers on the oracle/XLA paths —
            # interp/wide128.py).  Wider would need more limbs; deviation
            # recorded in PARITY.md.
            raise ValueError(
                f"unsupported integer width {width} in {s!r}: this "
                f"compiler supports int1..int128/uint1..uint128 "
                f"(65..128-bit via quad-limb carriers on the NumPy/XLA "
                f"backends); widths above 128 are not implemented "
                f"(PARITY.md deviation)")
        return ScalarType(kind, width)

    # ---- properties -----------------------------------------------------

    @property
    def is_float(self) -> bool:
        return self.kind == "float"

    @property
    def is_int(self) -> bool:
        return not self.is_float

    @property
    def is_signed(self) -> bool:
        return self.kind in ("int", "float")

    @property
    def storage_width(self) -> int:
        """Next power-of-two width >= declared width (storage container)."""
        w = 8
        while w < self.width:
            w *= 2
        return w

    @property
    def needs_mask(self) -> bool:
        """True when the declared width is narrower than its container."""
        return self.is_int and self.width != self.storage_width

    # ---- numpy mapping ---------------------------------------------------

    def np_dtype(self) -> np.dtype:
        """Storage dtype (what arrays of this type are held in).  >64-bit
        ints have no native numpy dtype: they live in OBJECT arrays of
        Python ints at the host boundary (exact; interp/wide128.py holds
        them as quad-limb vectors in compute)."""
        if self.kind == "float":
            return np.dtype({16: np.float16, 32: np.float32, 64: np.float64}[self.width])
        w = self.storage_width
        if w > 64:
            return np.dtype(object)
        if self.kind == "uint":
            return np.dtype({8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}[w])
        return np.dtype({8: np.int8, 16: np.int16, 32: np.int32, 64: np.int64}[w])

    @property
    def tpu_storage_bytes(self) -> int:
        """Bytes per cell of the storage dtype (16 for the >64-bit
        quad-limb carriers)."""
        if self.kind == "float":
            if self.width == 16:
                return 2
            return 8 if self.width == 64 else 4
        if self.width <= 8:
            return 1
        if self.width <= 16:
            return 2
        if self.width <= 32:
            return 4
        return 8 if self.width <= 64 else 16

    # ---- C++ mapping (golden runner) --------------------------------------

    def cpp_type(self) -> str:
        """STORAGE type in generated C++ (compute carriers are chosen by
        the printer).  half -> _Float16 (GCC >= 12; bit-identical to
        np.float16, so 2-byte I/O buffers match the Python side and every
        store rounds through f16 exactly like the oracle)."""
        if self.kind == "float":
            return {16: "_Float16", 32: "float", 64: "double"}[self.width]
        if self.storage_width > 64:
            # gcc's native 128-bit integers — the C++ golden runner keeps
            # exact semantics for the quad-limb DSL widths
            return ("unsigned __int128" if self.kind == "uint"
                    else "__int128")
        return ("uint" if self.kind == "uint" else "int") + f"{self.storage_width}_t"

    def __str__(self) -> str:
        if self.kind == "float":
            return {16: "half", 32: "float", 64: "double"}[self.width]
        return f"{self.kind}{self.width}"


def promote(a: ScalarType, b: ScalarType) -> ScalarType:
    """Usual arithmetic conversions over DSL types (C-like, as in haoda):
    float beats int; wider beats narrower; unsigned beats signed at equal
    width (C semantics)."""
    if a.is_float or b.is_float:
        if a.is_float and b.is_float:
            return a if a.width >= b.width else b
        return a if a.is_float else b
    if a.width != b.width:
        return a if a.width > b.width else b
    if a.kind == b.kind:
        return a
    return a if a.kind == "uint" else b


FLOAT32 = ScalarType("float", 32)
INT32 = ScalarType("int", 32)
