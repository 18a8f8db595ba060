"""A reader of the YAML subset that the planner configs use.

The configs (``configs/*.yaml``) need nested block mappings, block lists
(``- a``), flow lists (``[a, b]``), ``#`` comments and these scalars:

* ``null``, ``Null``, ``NULL``, ``~`` and an empty value: ``None``;
* ``true``/``True``/``TRUE`` and ``false``/``False``/``FALSE``;
* decimal integers (``0``, ``-12``, ``1500``);
* floats with a point or an exponent (``0.1``, ``-2.``, ``.5``, ``1e-3``);
* single- and double-quoted strings, and plain strings.

It gives what ``yaml.safe_load`` gives on that subset, with one
difference: a number with an exponent but without a point or without the
exponent's sign (``1e-3``, ``1.0e3``) is a float here, as YAML 1.2 reads
it, where PyYAML's YAML 1.1 resolver leaves a string.
Everything outside the subset raises ``ValueError`` naming the file and
the line: anchors, aliases, tags, block scalars, flow mappings, document
markers, tabs in indentation, multi-line plain scalars, duplicate keys, and
the plain scalars that YAML 1.1 would read otherwise (``yes``/``no``/
``on``/``off``, octal-looking ``012``, ``.inf``, ``0x1f``, ``1_000``,
dates).
"""
from __future__ import annotations

import re
from typing import List, Tuple

_NULL = {"null", "Null", "NULL", "~", ""}
_TRUE = {"true", "True", "TRUE"}
_FALSE = {"false", "False", "FALSE"}
# words YAML 1.1 reads as booleans and the number forms outside the subset
_AMBIGUOUS = re.compile(
    r"^(yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF"
    r"|[-+]?\.(inf|Inf|INF|nan|NaN|NAN)"
    r"|[-+]?0[0-9]+|[-+]?0[xXoObB][0-9a-fA-F]+"
    r"|[-+]?[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?"
    r"|[-+]?\.?[0-9][0-9_.]*_.*"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}([Tt ].*)?)$")
_INT = re.compile(r"^[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^[-+]?([0-9]+\.[0-9]*|\.[0-9]+|[0-9]+)"
                    r"([eE][-+]?[0-9]+)?$")
_INDICATORS = "&*!|>{}%@`"


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


def load(path: str):
    """The document in the file at ``path``."""
    with open(path, "r", encoding="utf-8") as f:
        return parse(f.read(), name=str(path))


def parse(text: str, name: str = "<string>"):
    """The document in ``text``; ``name`` names it in errors."""
    lines = _lines(text, name)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0].indent, name)
    if i != len(lines):
        _fail(name, lines[i].no, "content outside the document's block")
    return value


def _fail(name: str, no: int, what: str):
    raise ValueError(f"{name}:{no}: {what} (outside the YAML subset of "
                     "the planner configs)")


def _strip_comment(s: str) -> str:
    """``s`` without a trailing ``#`` comment (a ``#`` at the start or after
    whitespace, outside quotes)."""
    i = 0
    while i < len(s):
        ch = s[i]
        if ch in "'\"" and (i == 0 or s[i - 1] in " \t[,:-"):
            end = _quoted_end(s[i:])
            if end is None:
                return s
            i += end
            continue
        if ch == "#" and (i == 0 or s[i - 1] in " \t"):
            return s[:i]
        i += 1
    return s


def _lines(text: str, name: str) -> List[_Line]:
    out = []
    for no, raw in enumerate(text.splitlines(), start=1):
        body = _strip_comment(raw).rstrip()
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t"):
            _fail(name, no, "a tab in indentation")
        if stripped in ("---", "...") or stripped.startswith(("--- ", "%")):
            _fail(name, no, f"document marker or directive {stripped!r}")
        out.append(_Line(no, len(body) - len(stripped), stripped))
    return out


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _split_key(text: str):
    """(key, rest) of a mapping line ``key: rest`` or ``key:``, else None."""
    if text[:1] in "'\"":
        end = _quoted_end(text)
        if end is not None and text[end:end + 1] == ":" and (
                len(text) == end + 1 or text[end + 1] == " "):
            return text[:end], text[end + 1:].strip()
        return None
    m = re.match(r"^([^:]*?):( |$)", text)
    if m is None:
        return None
    return m.group(1), text[m.end():].strip()


def _quoted_end(text: str):
    """Index just past the quoted scalar that opens ``text``, or None."""
    q = text[0]
    i = 1
    while i < len(text):
        if q == "'" and text[i] == "'":
            if text[i + 1:i + 2] == "'":
                i += 2
                continue
            return i + 1
        if q == '"':
            if text[i] == "\\":
                i += 2
                continue
            if text[i] == '"':
                return i + 1
        i += 1
    return None


def _block(lines: List[_Line], i: int, indent: int, name: str):
    """The block node starting at line ``i`` with indentation ``indent``;
    returns (value, index of the first line after it)."""
    if _is_item(lines[i].text):
        return _block_list(lines, i, indent, name)
    return _block_map(lines, i, indent, name)


def _child(lines, i, indent, name, list_ok_at_same):
    """The value of a key or item with nothing after its indicator: a
    nested block on the following lines, or None."""
    if i < len(lines):
        nxt = lines[i]
        if nxt.indent > indent or (list_ok_at_same and nxt.indent == indent
                                   and _is_item(nxt.text)):
            return _block(lines, i, nxt.indent, name)
    return None, i


def _block_map(lines, i, indent, name) -> Tuple[dict, int]:
    out = {}
    while i < len(lines) and lines[i].indent == indent:
        ln = lines[i]
        if _is_item(ln.text):
            _fail(name, ln.no, "a list item among mapping keys")
        kv = _split_key(ln.text)
        if kv is None:
            _fail(name, ln.no, f"not a 'key: value' line: {ln.text!r}")
        key = _scalar(kv[0], name, ln.no)
        if isinstance(key, list):
            _fail(name, ln.no, "a flow list as a mapping key")
        if key in out:
            _fail(name, ln.no, f"duplicate key {key!r}")
        i += 1
        if kv[1]:
            out[key] = _inline(kv[1], name, ln.no)
        else:
            out[key], i = _child(lines, i, indent, name, True)
        if i < len(lines) and lines[i].indent > indent:
            _fail(name, lines[i].no, "a continuation line or misplaced "
                  "indentation")
    if i < len(lines) and lines[i].indent > indent:
        _fail(name, lines[i].no, "misplaced indentation")
    return out, i


def _block_list(lines, i, indent, name) -> Tuple[list, int]:
    out = []
    while (i < len(lines) and lines[i].indent == indent
           and _is_item(lines[i].text)):
        ln = lines[i]
        rest = ln.text[1:].strip()
        i += 1
        if not rest:
            value, i = _child(lines, i, indent, name, False)
        else:
            if _is_item(rest) or _split_key(rest) is not None:
                _fail(name, ln.no, "a nested list or mapping on an item's "
                      "line")
            value = _inline(rest, name, ln.no)
        out.append(value)
        if i < len(lines) and lines[i].indent > indent:
            _fail(name, lines[i].no, "a continuation line or misplaced "
                  "indentation")
    return out, i


def _inline(text: str, name: str, no: int):
    """A value written on the line of its key or item."""
    if text.startswith("["):
        value, end = _flow_list(text, 0, name, no)
        if text[end:].strip():
            _fail(name, no, f"text after a flow list: {text[end:]!r}")
        return value
    return _scalar(text, name, no)


def _flow_list(text: str, i: int, name: str, no: int):
    """The flow list opening at ``text[i]``; (list, index past ``]``)."""
    out = []
    i += 1
    expect_item = True
    while True:
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text):
            _fail(name, no, "an unclosed flow list (flow lists take one "
                  "line)")
        ch = text[i]
        if ch == "]":
            if expect_item and out:
                _fail(name, no, "an empty item in a flow list")
            return out, i + 1
        if not expect_item:
            if ch != ",":
                _fail(name, no, f"expected ',' or ']' in a flow list at "
                      f"{text[i:]!r}")
            i += 1
            expect_item = True
            continue
        if ch == "[":
            item, i = _flow_list(text, i, name, no)
        elif ch in "'\"":
            end = _quoted_end(text[i:])
            if end is None:
                _fail(name, no, "an unclosed quoted string")
            item = _scalar(text[i:i + end], name, no)
            i += end
        else:
            j = i
            while j < len(text) and text[j] not in ",]":
                j += 1
            item = _scalar(text[i:j].strip(), name, no)
            i = j
        if item == "" and ch not in "'\"":
            _fail(name, no, "an empty item in a flow list")
        out.append(item)
        expect_item = False


def _scalar(text: str, name: str, no: int):
    """A scalar (or a flow list) of the subset."""
    if text.startswith("["):
        return _inline(text, name, no)
    if text[:1] in "'\"":
        end = _quoted_end(text)
        if end is None or text[end:].strip():
            _fail(name, no, f"a malformed quoted string {text!r}")
        body = text[1:end - 1]
        if text[0] == "'":
            return body.replace("''", "'")
        return _unescape(body, name, no)
    if text[:1] in _INDICATORS or text.startswith(("- ", "? ", ": ")):
        _fail(name, no, f"an indicator at the start of {text!r}")
    if ": " in text or text.endswith(":") or " #" in text:
        _fail(name, no, f"a plain scalar holding ': ' or ' #': {text!r}")
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _AMBIGUOUS.match(text):
        _fail(name, no, f"{text!r} reads differently under YAML 1.1 and "
              "1.2")
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    return text


_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/", "0": "\0"}


def _unescape(body: str, name: str, no: int) -> str:
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch == "\\":
            esc = body[i + 1:i + 2]
            if esc not in _ESCAPES:
                _fail(name, no, f"the escape '\\{esc}'")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        out.append(ch)
        i += 1
    return "".join(out)
