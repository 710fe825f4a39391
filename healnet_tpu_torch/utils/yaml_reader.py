"""A reader for the subset of YAML the repository's configs use.

The machine with the GPU has no PyYAML, so the port reads its configs and
sweep specs with this module. It resolves scalars as PyYAML's ``FullLoader``
does (YAML 1.1): ``1.0e-07`` is a float and ``1e-07`` a string, ``null``
and ``~`` are ``None`` while ``None`` is the string ``"None"``, ``true`` /
``yes`` / ``on`` are ``True``, and ints take the 1.1 forms (``0x1f``,
``017``, ``1_000``, ``1:30``).

The subset:

- block mappings and block sequences (a sequence may sit at its key's
  indentation, as YAML allows), nested to any depth;
- flow sequences and mappings on one line (``[2048, 4096, 8192]``);
- comments, plain scalars on one line, single- and double-quoted scalars;
- anchors (``&name``) and aliases (``*name``);
- the ``!include`` tag, handed to a callback.

Anything else (block scalars ``|`` / ``>``, multi-line plain scalars, merge
keys ``<<``, complex keys ``?``, other tags, timestamps, document markers,
tabs in indentation) raises :class:`YamlSubsetError`, naming the line.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

IncludeFn = Callable[[str], Any]


class YamlSubsetError(ValueError):
    """A document outside the subset, or malformed; the message names the line."""


class _Line(NamedTuple):
    no: int  # 1-based line number in the source
    indent: int
    text: str  # content without indentation or comment


# PyYAML's implicit resolvers (resolver.py), tried in its order
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                        (?:[Tt]|[ \t]+)[0-9][0-9]?
                        :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/",
            "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(value: str, cast) -> Any:
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _to_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _to_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


class _Reader:
    def __init__(self, text: str, name: str, include: Optional[IncludeFn]):
        self.name = name
        self.include = include
        self.anchors: Dict[str, Any] = {}
        self.lines = self._split(text)

    # ---------------------------------------------------------------- lines
    def fail(self, no: int, msg: str):
        raise YamlSubsetError(f"{self.name}, line {no}: {msg}")

    def _split(self, text: str) -> List[_Line]:
        lines = []
        for no, raw in enumerate(text.splitlines(), 1):
            body = self._strip_comment(raw, no).rstrip()
            content = body.lstrip(" ")
            if not content:
                continue
            if content[0] == "\t":
                self.fail(no, "a tab in the indentation")
            if len(body) == len(content) and content in ("---", "...") or \
                    content.startswith(("--- ", "%")):
                self.fail(no, "document markers and directives are outside the subset")
            lines.append(_Line(no, len(body) - len(content), content))
        return lines

    def _strip_comment(self, raw: str, no: int) -> str:
        """The line up to an unquoted ``#`` that starts it or follows a space."""
        quote = None
        i = 0
        while i < len(raw):
            c = raw[i]
            if quote == "'":
                if c == "'":
                    if raw[i + 1:i + 2] == "'":
                        i += 1
                    else:
                        quote = None
            elif quote == '"':
                if c == "\\":
                    i += 1
                elif c == '"':
                    quote = None
            elif c in "'\"" and (i == 0 or raw[i - 1] in " [{,:-"):
                quote = c
            elif c == "#" and (i == 0 or raw[i - 1] in " \t"):
                return raw[:i]
            i += 1
        if quote is not None:
            self.fail(no, "a quoted scalar that does not end on its line")
        return raw

    # ---------------------------------------------------------------- blocks
    def document(self) -> Any:
        if not self.lines:
            return None
        value, i = self.block(0)
        if i < len(self.lines):
            self.fail(self.lines[i].no, "unexpected indentation")
        return value

    @staticmethod
    def _is_item(text: str) -> bool:
        return text == "-" or text.startswith("- ")

    def block(self, i: int) -> Tuple[Any, int]:
        line = self.lines[i]
        if self._is_item(line.text):
            return self.sequence(i, line.indent)
        if self._split_key(line) is not None:
            return self.mapping(i, line.indent)
        value = self.inline(line.text, line.no)
        i += 1
        if i < len(self.lines) and self.lines[i].indent > line.indent:
            self.fail(self.lines[i].no, "multi-line scalars are outside the subset")
        return value, i

    def mapping(self, i: int, indent: int) -> Tuple[Dict[Any, Any], int]:
        out: Dict[Any, Any] = {}
        while i < len(self.lines) and self.lines[i].indent == indent:
            line = self.lines[i]
            split = self._split_key(line)
            if split is None:
                self.fail(line.no, "expected a mapping key")
            key, rest = split
            anchor, tag, rest = self._properties(rest, line.no)
            i += 1
            if rest:
                value = self.inline(rest, line.no, tag)
                if i < len(self.lines) and self.lines[i].indent > indent:
                    self.fail(self.lines[i].no, "multi-line scalars are outside the subset")
            else:
                if tag is not None:
                    self.fail(line.no, f"the tag {tag} needs a scalar on its line")
                nxt = self.lines[i] if i < len(self.lines) else None
                if nxt is not None and (nxt.indent > indent or (
                        nxt.indent == indent and self._is_item(nxt.text))):
                    value, i = self.block(i)
                else:
                    value = None
            if anchor is not None:
                self.anchors[anchor] = value
            out[key] = value
        return out, i

    def sequence(self, i: int, indent: int) -> Tuple[List[Any], int]:
        out: List[Any] = []
        while (i < len(self.lines) and self.lines[i].indent == indent
               and self._is_item(self.lines[i].text)):
            line = self.lines[i]
            content = line.text[1:].lstrip(" ")
            if content:
                # the item's content as a line of its own at its column
                col = indent + len(line.text) - len(content)
                self.lines[i] = _Line(line.no, col, content)
                value, i = self.block(i)
            else:
                i += 1
                if i < len(self.lines) and self.lines[i].indent > indent:
                    value, i = self.block(i)
                else:
                    value = None
            out.append(value)
        return out, i

    def _split_key(self, line: _Line) -> Optional[Tuple[Any, str]]:
        """(key, the rest of the line) when the line is a mapping entry."""
        text = line.text
        if text.startswith("? ") or text == "?":
            self.fail(line.no, "complex keys are outside the subset")
        if text[0] in "'\"":
            key, end = self._quoted(text, 0, line.no)
            rest = text[end:]
            if rest.startswith(":") and (len(rest) == 1 or rest[1] == " "):
                return key, rest[1:].strip()
            return None
        if text[0] in "[{":
            return None
        for m in re.finditer(r":( |$)", text):
            key_text = text[:m.start()].rstrip()
            if key_text.startswith(("&", "*", "!")):
                self.fail(line.no, "anchors, aliases and tags on keys are outside the subset")
            if key_text == "<<":
                self.fail(line.no, "merge keys (<<) are outside the subset")
            return self.plain(key_text, line.no), text[m.end():].strip()
        return None

    # ---------------------------------------------------------------- nodes
    def _properties(self, text: str, no: int) -> Tuple[Optional[str], Optional[str], str]:
        """(anchor, tag, the rest) of a node's text."""
        anchor = tag = None
        while text[:1] in ("&", "!"):
            head, _, text = text.partition(" ")
            text = text.strip()
            if head[0] == "&":
                if anchor is not None or len(head) == 1:
                    self.fail(no, "a malformed anchor")
                anchor = head[1:]
            else:
                if tag is not None:
                    self.fail(no, "two tags on one node")
                tag = head
        if tag not in (None, "!include"):
            self.fail(no, f"the tag {tag} is outside the subset (only !include)")
        return anchor, tag, text

    def inline(self, text: str, no: int, tag: Optional[str] = None) -> Any:
        """A node written on one line: properties, then an alias, a flow
        collection, a quoted or a plain scalar."""
        anchor, own_tag, text = self._properties(text, no)
        tag = own_tag or tag
        if not text:
            value = None
        elif tag == "!include":
            if text[0] in "'\"":
                target, end = self._quoted(text, 0, no)
                if text[end:].strip():
                    self.fail(no, "text after a quoted scalar")
            else:
                target = text
            if self.include is None:
                self.fail(no, "!include is not allowed here")
            value = self.include(target)
        elif text[0] == "*":
            name = text[1:]
            if not name or " " in name:
                self.fail(no, "a malformed alias")
            if name not in self.anchors:
                self.fail(no, f"the alias *{name} names no anchor defined before it")
            value = self.anchors[name]
        elif text[0] in "[{":
            value, end = self.flow(text, 0, no)
            if text[end:].strip():
                self.fail(no, "text after a flow collection")
        elif text[0] in "'\"":
            value, end = self._quoted(text, 0, no)
            if text[end:].strip():
                self.fail(no, "text after a quoted scalar")
        else:
            value = self.plain(text, no)
        if anchor is not None:
            self.anchors[anchor] = value
        return value

    def plain(self, text: str, no: int) -> Any:
        """A plain scalar, resolved as PyYAML's FullLoader resolves it."""
        if text and (text[0] in "|>%@`,]}" or text[:2] in ("? ", ": ", "- ")
                     or text in ("?", ":", "-")):
            self.fail(no, f"the scalar {text!r} is outside the subset")
        if ": " in text:
            self.fail(no, "a mapping inside a plain scalar")
        if _BOOL.match(text):
            return text.lower() in ("yes", "true", "on")
        if _FLOAT.match(text):
            return _to_float(text)
        if _INT.match(text):
            return _to_int(text)
        if _NULL.match(text):
            return None
        if _TIMESTAMP.match(text):
            self.fail(no, f"timestamps ({text}) are outside the subset")
        if text == "=":
            self.fail(no, "the value key (=) is outside the subset")
        return text

    def _quoted(self, text: str, pos: int, no: int) -> Tuple[str, int]:
        """A quoted scalar starting at ``text[pos]``: (value, index after it)."""
        quote, out, i = text[pos], [], pos + 1
        while i < len(text):
            c = text[i]
            if quote == "'":
                if c == "'":
                    if text[i + 1:i + 2] == "'":
                        out.append("'")
                        i += 2
                        continue
                    return "".join(out), i + 1
                out.append(c)
            elif c == '"':
                return "".join(out), i + 1
            elif c == "\\":
                esc = text[i + 1:i + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    i += 1
                elif esc in _HEX_ESCAPES:
                    width = _HEX_ESCAPES[esc]
                    digits = text[i + 2:i + 2 + width]
                    if len(digits) != width or not all(
                            d in "0123456789abcdefABCDEF" for d in digits):
                        self.fail(no, f"a malformed escape \\{esc}{digits}")
                    out.append(chr(int(digits, 16)))
                    i += 1 + width
                else:
                    self.fail(no, f"the escape \\{esc} is outside the subset")
            else:
                out.append(c)
            i += 1
        self.fail(no, "a quoted scalar that does not end on its line")

    def flow(self, text: str, pos: int, no: int) -> Tuple[Any, int]:
        """A flow collection starting at ``text[pos]``: (value, index after it)."""
        close = "]" if text[pos] == "[" else "}"
        out: Any = [] if close == "]" else {}
        pos += 1
        while True:
            pos = self._skip(text, pos)
            if pos >= len(text):
                self.fail(no, "a flow collection that does not end on its line")
            if text[pos] == close:
                return out, pos + 1
            if close == "]":
                value, pos = self._flow_node(text, pos, no, ",]")
                out.append(value)
            else:
                key, pos = self._flow_node(text, pos, no, ":,}")
                pos = self._skip(text, pos)
                if text[pos:pos + 1] == ":":
                    value, pos = self._flow_node(text, pos + 1, no, ",}")
                else:
                    value = None
                out[key] = value
            pos = self._skip(text, pos)
            if text[pos:pos + 1] == ",":
                pos += 1
            elif text[pos:pos + 1] != close:
                self.fail(no, "a malformed flow collection")

    @staticmethod
    def _skip(text: str, pos: int) -> int:
        while pos < len(text) and text[pos] == " ":
            pos += 1
        return pos

    def _flow_node(self, text: str, pos: int, no: int, stops: str) -> Tuple[Any, int]:
        pos = self._skip(text, pos)
        c = text[pos:pos + 1]
        if c in ("[", "{"):
            return self.flow(text, pos, no)
        if c in ("'", '"'):
            return self._quoted(text, pos, no)
        if c in ("&", "*", "!"):
            self.fail(no, "anchors, aliases and tags inside flow collections are outside "
                          "the subset")
        end, key = pos, ":" in stops
        while end < len(text) and text[end] not in stops.replace(":", ""):
            # a flow mapping's key ends at a ":" before a space, a stop or the end
            if key and text[end] == ":" and text[end + 1:end + 2] in ("", " ", ",", "}"):
                break
            end += 1
        raw = text[pos:end].strip()
        if not raw or any(c in raw for c in "[]{}"):
            self.fail(no, "a malformed entry in a flow collection")
        return self.plain(raw, no), end


def loads(text: str, name: str = "<string>", include: Optional[IncludeFn] = None) -> Any:
    """The document in ``text``; ``include(target)`` builds an ``!include``
    node's value (``!include`` raises when it is None); ``name`` is what
    errors call the source."""
    return _Reader(text, name, include).document()


def load(path, include: Optional[IncludeFn] = None) -> Any:
    """The document in the file at ``path`` (see :func:`loads`)."""
    with open(path, "r") as f:
        return loads(f.read(), name=str(path), include=include)
