"""resource.Quantity: parse, canonical format, arithmetic, comparison.

Analog of apimachinery `pkg/api/resource/quantity.go`. A Quantity is a
fixed-point decimal with binary-SI (Ki/Mi/...), decimal-SI (k/M/...), and
decimal-exponent (e3/E3) suffix forms. We store an exact integer count of
*milli-units* (the reference's internal int64+scale covers the same range for
every practical cluster quantity; milli is its smallest legal scale —
quantity.go "No fraction smaller than milli may be specified").
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from decimal import Decimal, ROUND_CEILING
from typing import Union

_QTY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>[0-9]+(?:\.[0-9]*)?|\.[0-9]+)"
    r"(?:(?P<suffix>[kKMGTPE]i?|m)|[eE](?P<exp>[+-]?[0-9]+))?$"
)

_DECIMAL_POW = {"k": 3, "M": 6, "G": 9, "T": 12, "P": 15, "E": 18}
_BINARY_POW = {"Ki": 10, "Mi": 20, "Gi": 30, "Ti": 40, "Pi": 50, "Ei": 60}

# Canonicalization ladders (quantity.go Suffixer): binary suffixes for
# BinarySI-formatted values, decimal for DecimalSI.
_BINARY_LADDER = [("Ei", 60), ("Pi", 50), ("Ti", 40), ("Gi", 30), ("Mi", 20), ("Ki", 10)]
_DECIMAL_LADDER = [("E", 18), ("P", 15), ("T", 12), ("G", 9), ("M", 6), ("k", 3)]

BINARY_SI = "BinarySI"
DECIMAL_SI = "DecimalSI"


class QuantityError(ValueError):
    pass


@dataclass(frozen=True, order=False)
class Quantity:
    """Exact quantity in milli-units with remembered format."""

    milli: int
    fmt: str = DECIMAL_SI

    # -- comparisons (Cmp) -------------------------------------------------- #
    def __lt__(self, o: "Quantity") -> bool:
        return self.milli < o.milli

    def __le__(self, o: "Quantity") -> bool:
        return self.milli <= o.milli

    def __gt__(self, o: "Quantity") -> bool:
        return self.milli > o.milli

    def __ge__(self, o: "Quantity") -> bool:
        return self.milli >= o.milli

    def __add__(self, o: "Quantity") -> "Quantity":
        return Quantity(self.milli + o.milli, self.fmt)

    def __sub__(self, o: "Quantity") -> "Quantity":
        return Quantity(self.milli - o.milli, self.fmt)

    def is_zero(self) -> bool:
        return self.milli == 0

    # -- accessors ---------------------------------------------------------- #
    def value(self) -> int:
        """Quantity.Value(): ceil to integer units."""
        return -(-self.milli // 1000) if self.milli >= 0 else -((-self.milli) // 1000)

    def milli_value(self) -> int:
        return self.milli

    # -- canonical string (String / CanonicalizeBytes) ---------------------- #
    def __str__(self) -> str:
        m = self.milli
        if m == 0:
            return "0"
        sign = "-" if m < 0 else ""
        m = abs(m)
        if m % 1000 != 0:
            # milli remainder: always formatted with the m suffix
            return f"{sign}{m}m"
        units = m // 1000
        ladder = _BINARY_LADDER if self.fmt == BINARY_SI else None
        if ladder:
            for suf, pow2 in ladder:
                if units % (1 << pow2) == 0:
                    return f"{sign}{units >> pow2}{suf}"
            return f"{sign}{units}"
        for suf, pow10 in _DECIMAL_LADDER:
            if units % (10 ** pow10) == 0:
                return f"{sign}{units // 10 ** pow10}{suf}"
        return f"{sign}{units}"


def parse(s: Union[str, int, float]) -> Quantity:
    """resource.ParseQuantity."""
    if isinstance(s, bool):
        raise QuantityError(f"bad quantity {s!r}")
    if isinstance(s, int):
        return Quantity(s * 1000)
    if isinstance(s, float):
        return _from_decimal(Decimal(str(s)), DECIMAL_SI)
    m = _QTY_RE.match(s.strip())
    if not m:
        raise QuantityError(f"bad quantity {s!r}")
    num = Decimal(m.group("num"))
    if m.group("sign") == "-":
        num = -num
    suffix = m.group("suffix")
    exp = m.group("exp")
    fmt = DECIMAL_SI
    if suffix == "m":
        return _from_decimal(num / 1000, DECIMAL_SI)
    if suffix in _BINARY_POW:
        num *= 1 << _BINARY_POW[suffix]
        fmt = BINARY_SI
    elif suffix in _DECIMAL_POW:
        num *= Decimal(10) ** _DECIMAL_POW[suffix]
    elif exp is not None:
        num *= Decimal(10) ** int(exp)
    return _from_decimal(num, fmt)


def _from_decimal(d: Decimal, fmt: str) -> Quantity:
    # Quantities may not be smaller than 1m; sub-milli rounds up
    # (quantity.go: "Fractional digits smaller than milli are rounded up").
    milli = int((d * 1000).to_integral_value(rounding=ROUND_CEILING))
    return Quantity(milli, fmt)


def parse_milli(s: Union[str, int, float]) -> int:
    return parse(s).milli


def add_resources(a: dict, b: dict) -> dict:
    """Sum two {resourceName: quantityString} maps (quota.Add)."""
    out = dict(a)
    for k, v in b.items():
        if k in out:
            out[k] = str(parse(out[k]) + parse(v))
        else:
            out[k] = v
    return out


def cmp(a: Union[str, int], b: Union[str, int]) -> int:
    qa, qb = parse(a), parse(b)
    return (qa.milli > qb.milli) - (qa.milli < qb.milli)
