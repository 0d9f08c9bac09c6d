"""Label selectors: parse + match.

Analog of apimachinery `pkg/labels/selector.go` (Parse, Requirement.Matches)
and `pkg/apis/meta/v1/helpers.go` (LabelSelectorAsSelector). Supports the full
string syntax the reference parser accepts:

    a=b, c==d, e!=f, g in (x,y), h notin (z), i, !j, k>5, l<9

An empty selector string selects everything; a metav1.LabelSelector dict of
None selects nothing (per LabelSelectorAsSelector).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# Operators (labels/selector.go:42-52)
EQUALS = "="
DOUBLE_EQUALS = "=="
NOT_EQUALS = "!="
IN = "in"
NOT_IN = "notin"
EXISTS = "exists"
DOES_NOT_EXIST = "!"
GREATER_THAN = "gt"
LESS_THAN = "lt"

_LABEL_KEY_RE = re.compile(
    r"^([a-zA-Z0-9][-a-zA-Z0-9_.]*[a-zA-Z0-9]/)?"
    r"[a-zA-Z0-9]([-a-zA-Z0-9_.]*[a-zA-Z0-9])?$"
)
_LABEL_VAL_RE = re.compile(r"^([a-zA-Z0-9]([-a-zA-Z0-9_.]*[a-zA-Z0-9])?)?$")


class SelectorParseError(ValueError):
    pass


def validate_label_key(key: str) -> None:
    if not key or len(key) > 317 or not _LABEL_KEY_RE.match(key):
        raise SelectorParseError(f"invalid label key: {key!r}")


def validate_label_value(val: str) -> None:
    if len(val) > 63 or not _LABEL_VAL_RE.match(val):
        raise SelectorParseError(f"invalid label value: {val!r}")


@dataclass(frozen=True)
class Requirement:
    """labels.Requirement (selector.go:117): key op values."""

    key: str
    op: str
    values: Tuple[str, ...] = ()

    def matches(self, lbls: Dict[str, str]) -> bool:
        """Requirement.Matches (selector.go:192-215)."""
        if self.op in (IN, EQUALS, DOUBLE_EQUALS):
            return self.key in lbls and lbls[self.key] in self.values
        if self.op in (NOT_IN, NOT_EQUALS):
            # NotIn/NotEquals match when the key is absent too
            return self.key not in lbls or lbls[self.key] not in self.values
        if self.op == EXISTS:
            return self.key in lbls
        if self.op == DOES_NOT_EXIST:
            return self.key not in lbls
        if self.op in (GREATER_THAN, LESS_THAN):
            if self.key not in lbls:
                return False
            try:
                lhs = int(lbls[self.key])
                rhs = int(self.values[0])
            except (ValueError, IndexError):
                return False
            return lhs > rhs if self.op == GREATER_THAN else lhs < rhs
        return False

    def __str__(self) -> str:
        if self.op == EXISTS:
            return self.key
        if self.op == DOES_NOT_EXIST:
            return f"!{self.key}"
        if self.op in (IN, NOT_IN):
            return f"{self.key} {self.op} ({','.join(self.values)})"
        if self.op == GREATER_THAN:
            return f"{self.key}>{self.values[0]}"
        if self.op == LESS_THAN:
            return f"{self.key}<{self.values[0]}"
        return f"{self.key}{self.op}{self.values[0]}"


@dataclass(frozen=True)
class Selector:
    """internalSelector: AND of requirements; empty = Everything()."""

    requirements: Tuple[Requirement, ...] = ()
    nothing: bool = False  # labels.Nothing(): matches no object

    def matches(self, lbls: Optional[Dict[str, str]]) -> bool:
        if self.nothing:
            return False
        lbls = lbls or {}
        return all(r.matches(lbls) for r in self.requirements)

    def empty(self) -> bool:
        return not self.nothing and not self.requirements

    def __str__(self) -> str:
        return ",".join(str(r) for r in self.requirements)


EVERYTHING = Selector()
NOTHING = Selector(nothing=True)


# --------------------------------------------------------------------------- #
# String-syntax parser (labels.Parse)
# --------------------------------------------------------------------------- #

_TOKEN_RE = re.compile(
    r"\s*(?:"
    r"(?P<comma>,)|(?P<open>\()|(?P<close>\))|"
    r"(?P<op>==|=|!=|>|<)|(?P<bang>!)|"
    r"(?P<word>[^\s,()=!<>]+)"
    r")"
)


def _tokenize(s: str) -> List[Tuple[str, str]]:
    toks, i = [], 0
    while i < len(s):
        m = _TOKEN_RE.match(s, i)
        if not m or m.end() == i:
            raise SelectorParseError(f"unparseable selector at {s[i:]!r}")
        i = m.end()
        for kind in ("comma", "open", "close", "op", "bang", "word"):
            if m.group(kind):
                toks.append((kind, m.group(kind)))
                break
    return toks


def parse(s: str) -> Selector:
    """labels.Parse: the general selector string syntax."""
    s = s.strip()
    if not s:
        return EVERYTHING
    toks = _tokenize(s)
    reqs: List[Requirement] = []
    i = 0

    def peek(k: int = 0) -> Optional[Tuple[str, str]]:
        return toks[i + k] if i + k < len(toks) else None

    while i < len(toks):
        kind, val = toks[i]
        if kind == "bang":
            nxt = peek(1)
            if not nxt or nxt[0] != "word":
                raise SelectorParseError("expected key after '!'")
            validate_label_key(nxt[1])
            reqs.append(Requirement(nxt[1], DOES_NOT_EXIST))
            i += 2
        elif kind == "word":
            key = val
            validate_label_key(key)
            nxt = peek(1)
            if nxt is None or nxt[0] == "comma":
                reqs.append(Requirement(key, EXISTS))
                i += 1
            elif nxt[0] == "op":
                op_tok = nxt[1]
                v = peek(2)
                if not v or v[0] != "word":
                    raise SelectorParseError(f"expected value after {key}{op_tok}")
                if op_tok in ("=", "=="):
                    validate_label_value(v[1])
                    reqs.append(Requirement(key, IN, (v[1],)))
                elif op_tok == "!=":
                    validate_label_value(v[1])
                    reqs.append(Requirement(key, NOT_IN, (v[1],)))
                elif op_tok == ">":
                    reqs.append(Requirement(key, GREATER_THAN, (v[1],)))
                else:
                    reqs.append(Requirement(key, LESS_THAN, (v[1],)))
                i += 3
            elif nxt[0] == "word" and nxt[1] in (IN, NOT_IN):
                op = nxt[1]
                if not peek(2) or peek(2)[0] != "open":
                    raise SelectorParseError(f"expected '(' after {op}")
                i += 3
                vals: List[str] = []
                while True:
                    t = peek()
                    if t is None:
                        raise SelectorParseError("unterminated value list")
                    if t[0] == "close":
                        i += 1
                        break
                    if t[0] == "comma":
                        i += 1
                        continue
                    if t[0] != "word":
                        raise SelectorParseError(f"bad token in value list: {t[1]!r}")
                    validate_label_value(t[1])
                    vals.append(t[1])
                    i += 1
                if not vals:
                    raise SelectorParseError(f"{op} requires at least one value")
                reqs.append(Requirement(key, op, tuple(sorted(vals))))
            else:
                raise SelectorParseError(f"unexpected token after key: {nxt[1]!r}")
        else:
            raise SelectorParseError(f"unexpected token {val!r}")
        # consume a separating comma
        t = peek()
        if t and t[0] == "comma":
            i += 1
            if i == len(toks):
                raise SelectorParseError("trailing comma")
    return Selector(tuple(reqs))


def selector_from_set(match_labels: Dict[str, str]) -> Selector:
    """labels.SelectorFromSet."""
    return Selector(tuple(
        Requirement(k, IN, (v,)) for k, v in sorted(match_labels.items())
    ))


def from_label_selector(ls: Optional[Dict]) -> Selector:
    """metav1.LabelSelectorAsSelector: dict {matchLabels, matchExpressions}.

    nil selector → Nothing; empty selector → Everything (helpers.go:34-40).
    """
    if ls is None:
        return NOTHING
    reqs: List[Requirement] = [
        Requirement(k, IN, (v,))
        for k, v in sorted((ls.get("matchLabels") or {}).items())
    ]
    for expr in ls.get("matchExpressions") or []:
        op = expr.get("operator", "")
        key = expr.get("key", "")
        vals = tuple(sorted(expr.get("values") or []))
        mapped = {"In": IN, "NotIn": NOT_IN, "Exists": EXISTS,
                  "DoesNotExist": DOES_NOT_EXIST}.get(op)
        if mapped is None:
            raise SelectorParseError(f"bad matchExpressions operator {op!r}")
        if mapped in (IN, NOT_IN) and not vals:
            raise SelectorParseError(f"{op} requires values")
        if mapped in (EXISTS, DOES_NOT_EXIST) and vals:
            raise SelectorParseError(f"{op} forbids values")
        reqs.append(Requirement(key, mapped, vals))
    return Selector(tuple(reqs))
