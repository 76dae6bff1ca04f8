"""A small reader for the YAML that linearham's inputs use.

Two shapes occur:

* partis cluster files are JSON-style flow YAML (partis writes them with a
  JSON encoder), so ``json`` reads them directly;
* partis HMM parameter files are block mappings and sequences whose leaf
  values are plain or quoted scalars and inline flow maps and lists
  (``transitions: {IGHV_ex_star_01_0: 0.66, insert_left_N: 0.34}``).

Block files may also carry what ``yaml.safe_dump`` writes for such data:
nested block sequences (``- - a``) and anchors with aliases (``&id001``,
``*id001``).  Scalars resolve as PyYAML's ``safe_load`` resolves them
(YAML 1.1 nulls, booleans, ints and floats).  Tags, block scalars (``|``,
``>``) and multi-document streams are not supported and raise ValueError.
"""

from __future__ import annotations

import json
import re
from typing import Any, List, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$")


def load(text: str) -> Any:
    """Parse one YAML document of the shapes above."""
    try:
        return json.loads(text)
    except ValueError:
        pass
    return _Block(_logical_lines(text)).document()


def load_file(path: str) -> Any:
    with open(path) as fh:
        return load(fh.read())


def _scalar(tok: str) -> Any:
    tok = tok.strip()
    if tok in _NULL:
        return None
    if tok in _TRUE:
        return True
    if tok in _FALSE:
        return False
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok):
        t = tok.replace("_", "").lower()
        if t.endswith("nan"):
            return float("nan")
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        return float(t)
    if tok[:1] in "&*!|>%@`":
        raise ValueError(f"unsupported YAML construct: {tok!r}")
    return tok


def _strip_comment(line: str) -> str:
    quote = None
    for k, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (k == 0 or line[k - 1] in " \t"):
            return line[:k]
    return line


def _logical_lines(text: str) -> List[Tuple[int, str]]:
    out = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        body = line.lstrip(" ")
        out.append((len(line) - len(body), body))
    return out


def _is_item(body: str) -> bool:
    return body == "-" or body.startswith("- ")


def _split_key(body: str):
    """(key, rest) when ``body`` starts a mapping entry, else None."""
    quote, depth = None, 0
    for k, ch in enumerate(body):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'" and k == 0:
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and depth == 0 and (
                k + 1 == len(body) or body[k + 1] in " \t"):
            key = body[:k].strip()
            if key[:1] in "\"'":
                key = _Flow(key).value()
            return key, body[k + 1:].strip()
    return None


class _Block:
    """Block-structure parser over (indent, text) logical lines."""

    def __init__(self, lines):
        self.lines = lines
        self.anchors = {}

    def document(self):
        if not self.lines:
            return None
        value, i = self.node(0, self.lines[0][0])
        if i != len(self.lines):
            raise ValueError(
                f"unexpected content at line: {self.lines[i][1]!r}")
        return value

    def node(self, i, indent):
        if _is_item(self.lines[i][1]):
            return self.sequence(i, indent)
        return self.mapping(i, indent)

    def inline(self, i, indent, rest, item=False):
        """The value that starts with ``rest`` on line i (after a key or,
        with ``item``, a sequence dash): an alias, an anchored node, or a
        flow value.  Returns (value, next line)."""
        if rest.startswith("*"):
            name = rest[1:].strip()
            if name not in self.anchors:
                raise ValueError(f"undefined alias *{name}")
            return self.anchors[name], i + 1
        if rest.startswith("&"):
            name, _, rest = rest[1:].partition(" ")
            rest = rest.strip()
            if rest:
                value, i = self.inline(i, indent, rest, item)
            else:
                value, i = self.child(i, indent, item)
            self.anchors[name] = value
            return value, i
        return _Flow(rest).whole(), i + 1

    def child(self, i, indent, item=False):
        """The block node nested under line i (None if there is none).
        A mapping key's sequence may sit at the key's own indent; a
        sequence item's child must be indented further."""
        nxt = self.lines[i + 1] if i + 1 < len(self.lines) else None
        if nxt is not None and (nxt[0] > indent or (
                not item and nxt[0] == indent and _is_item(nxt[1]))):
            return self.node(i + 1, nxt[0])
        return None, i + 1

    def sequence(self, i, indent):
        lines = self.lines
        items = []
        while i < len(lines) and lines[i][0] == indent \
                and _is_item(lines[i][1]):
            body = lines[i][1]
            rest = body[1:].lstrip()
            col = indent + len(body) - len(rest)
            if not rest:
                value, i = self.child(i, indent, item=True)
            elif _is_item(rest) or (_split_key(rest) is not None
                                    and rest[:1] not in "{[&*"):
                # "- - x" or "- key: v": a block node starting mid-line.
                lines[i] = (col, rest)
                value, i = self.node(i, col)
            else:
                value, i = self.inline(i, indent, rest, item=True)
            items.append(value)
        return items, i

    def mapping(self, i, indent):
        lines = self.lines
        out = {}
        while i < len(lines) and lines[i][0] == indent \
                and not _is_item(lines[i][1]):
            kv = _split_key(lines[i][1])
            if kv is None:
                raise ValueError(f"expected 'key: value': {lines[i][1]!r}")
            key, rest = kv
            if rest:
                out[key], i = self.inline(i, indent, rest)
            else:
                out[key], i = self.child(i, indent)
        return out, i


class _Flow:
    """Flow-style value parser: {a: 1, b: [x, y]}, quoted and plain
    scalars."""

    def __init__(self, s: str):
        self.s, self.i = s, 0

    def whole(self):
        v = self.value()
        self._ws()
        if self.i != len(self.s):
            raise ValueError(f"trailing characters in {self.s!r}")
        return v

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self, stop=""):
        self._ws()
        c = self.s[self.i:self.i + 1]
        if c == "{":
            return self._mapping()
        if c == "[":
            return self._sequence()
        if c in ("'", '"'):
            return self._quoted()
        return _scalar(self._plain(stop))

    def _plain(self, stop):
        start = self.i
        while self.i < len(self.s):
            ch = self.s[self.i]
            if ch in stop:
                break
            if ch == ":" and ":" in stop and (
                    self.i + 1 == len(self.s) or self.s[self.i + 1] in " ,}"):
                break
            self.i += 1
        return self.s[start:self.i]

    def _quoted(self):
        q = self.s[self.i]
        j = self.i + 1
        buf = []
        while j < len(self.s):
            ch = self.s[j]
            if q == "'" and ch == "'":
                if self.s[j + 1:j + 2] == "'":
                    buf.append("'")
                    j += 2
                    continue
                break
            if q == '"' and ch == "\\":
                buf.append(self.s[j:j + 2])
                j += 2
                continue
            if q == '"' and ch == '"':
                break
            buf.append(ch)
            j += 1
        else:
            raise ValueError(f"unterminated string in {self.s!r}")
        self.i = j + 1
        text = "".join(buf)
        return json.loads('"' + text + '"') if q == '"' else text

    def _expect(self, ch):
        self._ws()
        if self.s[self.i:self.i + 1] != ch:
            raise ValueError(f"expected {ch!r} at {self.i} in {self.s!r}")
        self.i += 1

    def _mapping(self):
        self._expect("{")
        out = {}
        self._ws()
        if self.s[self.i:self.i + 1] == "}":
            self.i += 1
            return out
        while True:
            key = self.value(stop=":,}")
            self._expect(":")
            self._ws()
            nxt = self.s[self.i:self.i + 1]
            out[key] = None if nxt in (",", "}") else self.value(stop=",}")
            self._ws()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
                continue
            self._expect("}")
            return out

    def _sequence(self):
        self._expect("[")
        out = []
        self._ws()
        if self.s[self.i:self.i + 1] == "]":
            self.i += 1
            return out
        while True:
            out.append(self.value(stop=",]"))
            self._ws()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
                continue
            self._expect("]")
            return out
