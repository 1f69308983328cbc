"""Protobuf text-format (``.prototxt``) parser (counterpart of
``bigdl_tpu/interop/prototxt.py``; BigDL's ``utils/CaffeLoader.scala:63-66``
reads the model definition with ``TextFormat.merge``). Schemaless: the
loader needs field names and values only.

    message  := (field (';')?)*
    field    := ident ':' scalar
              | ident ('{' message '}' | '<' message '>')
              | ident ':' '[' scalar (',' scalar)* ']'
    scalar   := string+ | number | true/false | enum-ident
    comments := '#' to end of line

``parse`` gives ``{field_name: [value, ...]}``: every field is a list (the
text format repeats a field by repeating it), a nested message is a dict,
and adjacent string literals concatenate.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple, Union

Message = Dict[str, List[Any]]

_TOKEN_RE = re.compile(r"""
    \s+ | \#[^\n]*                         # whitespace / comment (skipped)
  | (?P<str>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<punct>[:{}<>\[\],;])
  | (?P<atom>[^\s:{}<>\[\],;#"']+)
""", re.VERBOSE)

_NUM_RE = re.compile(
    r"[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|\.\d+(?:[eE][-+]?\d+)?"
    r"|0[xX][0-9a-fA-F]+|inf|nan)$")


class PrototxtError(ValueError):
    pass


def _tokenize(text: str) -> List[Tuple[str, str]]:
    tokens, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise PrototxtError(f"bad character at offset {pos}: "
                                f"{text[pos:pos + 20]!r}")
        pos = m.end()
        if m.lastgroup is not None:
            tokens.append((m.lastgroup, m.group(m.lastgroup)))
    return tokens


def _unquote(tok: str) -> str:
    body = tok[1:-1]
    return re.sub(r"\\(.)", lambda m: {"n": "\n", "t": "\t", "r": "\r"}
                  .get(m.group(1), m.group(1)), body)


def _coerce(kind: str, tok: str) -> Any:
    if kind == "str":
        return _unquote(tok)
    if tok in ("true", "True"):
        return True
    if tok in ("false", "False"):
        return False
    if _NUM_RE.match(tok):
        try:
            return int(tok, 0)
        except ValueError:
            return float(tok)
    return tok  # enum identifier


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.tokens = tokens
        self.pos = 0

    def _peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def _next(self):
        tok = self._peek()
        if tok is None:
            raise PrototxtError("unexpected end of input")
        self.pos += 1
        return tok

    def message(self, closing: str = "") -> Message:
        out: Message = {}
        while True:
            tok = self._peek()
            if tok is None:
                if closing:
                    raise PrototxtError(f"missing closing {closing!r}")
                return out
            if tok == ("punct", closing):
                self._next()
                return out
            if tok == ("punct", ";"):
                self._next()
                continue
            kind, name = self._next()
            if kind != "atom":
                raise PrototxtError(f"expected field name, got {name!r}")
            out.setdefault(name, []).extend(self._field_value())

    def _field_value(self) -> List[Any]:
        tok = self._peek()
        if tok == ("punct", "{"):
            self._next()
            return [self.message("}")]
        if tok == ("punct", "<"):
            self._next()
            return [self.message(">")]
        if tok != ("punct", ":"):
            raise PrototxtError(f"expected ':' or '{{' after field name, "
                                f"got {tok and tok[1]!r}")
        self._next()
        tok = self._peek()
        if tok == ("punct", "{"):   # "name: { ... }" is legal text format
            self._next()
            return [self.message("}")]
        if tok == ("punct", "<"):
            self._next()
            return [self.message(">")]
        if tok == ("punct", "["):   # short repeated form: name: [v, v, ...]
            self._next()
            vals: List[Any] = []
            while True:
                t = self._peek()
                if t == ("punct", "]"):
                    self._next()
                    return vals
                if t == ("punct", ","):
                    self._next()
                    continue
                vals.append(self._scalar())
        return [self._scalar()]

    def _scalar(self) -> Any:
        kind, tok = self._next()
        if kind == "punct":
            raise PrototxtError(f"expected value, got {tok!r}")
        if kind == "str":
            # adjacent string literals concatenate ("ab" "cd" == "abcd")
            parts = [_unquote(tok)]
            while self._peek() and self._peek()[0] == "str":
                parts.append(_unquote(self._next()[1]))
            return "".join(parts)
        return _coerce(kind, tok)


def parse(text: str) -> Message:
    """Parse prototxt text into ``{field: [values...]}``."""
    return _Parser(_tokenize(text)).message()


def parse_file(path: str) -> Message:
    with open(path, encoding="utf-8") as f:
        return parse(f.read())


def first(msg: Message, name: str, default: Any = None) -> Any:
    """The first value of a field, or ``default``."""
    vals = msg.get(name)
    return vals[0] if vals else default
