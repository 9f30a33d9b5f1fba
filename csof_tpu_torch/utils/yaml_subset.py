"""A YAML reader and writer for the subset that experiment configs use, so
that the port needs no PyYAML.

``safe_dump`` writes what ``yaml.safe_dump(data, sort_keys=False)`` writes
for a tree of dicts with str keys, lists and tuples, None, bool, int, float
and str: block mappings and sequences at PyYAML's indentation, ``[]`` and
``{}`` for empty ones, PyYAML's float spelling (``1.0e-05``, ``.inf``) and
its quoting of strings (plain, else single-quoted). A string that PyYAML
would double-quote (control or non-ASCII characters) or fold over lines is
outside the subset and raises.

``safe_load`` reads, as ``yaml.safe_load`` does (YAML 1.1 scalars): block
mappings and sequences (a sequence may sit at its key's indentation, an
item may open a mapping), flow sequences and mappings on one line
(``[8, 16]``), null, bool, int (decimal, ``0x``, ``0o``-style ``0``-prefixed
octal, ``0b``), float (``1.0e-05``, ``.5``, ``.inf``, ``.nan``; ``1e-5``
without a dot is a string, as in PyYAML), plain, single- and double-quoted
strings, comments, and one leading ``---``. Anything else (anchors,
aliases, tags, block scalars, complex keys, several documents, multi-line
scalars, tabs in indentation, sexagesimal numbers, timestamps) raises
:class:`YamlSubsetError` with its line number.
"""

from __future__ import annotations

import math
import re
from typing import Any

_NULL = {"", "~", "null", "Null", "NULL"}
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                                   "OFF")})
_INT = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|0|[1-9][0-9_]*|0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_SEXAGESIMAL = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_TIMESTAMP = re.compile(r"(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
                        r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[ \t]+)[0-9][0-9]?"
                        r":[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
                        r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")
_WIDTH = 80  # PyYAML's best_width: longer plain scalars with spaces are folded


class YamlSubsetError(ValueError):
    """YAML outside the subset this module reads or writes."""


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def _resolves_to_non_str(s: str) -> bool:
    return (s in _NULL or s in _BOOL or bool(_INT.match(s)) or bool(_FLOAT.match(s))
            or bool(_SEXAGESIMAL.match(s)) or bool(_TIMESTAMP.match(s)) or s in ("<<", "="))


def _str_style(s: str) -> str:
    """'' (plain) or "'" as PyYAML's emitter chooses them in block context;
    raises where it would choose double quotes."""
    if any(not (" " <= ch <= "~") for ch in s):
        raise YamlSubsetError(f"string {s!r}: PyYAML double-quotes non-printable or non-ASCII "
                              "characters, which this writer does not")
    if _resolves_to_non_str(s) or s.startswith(("---", "...")):
        return "'"
    if s[0] == " " or s[-1] == " ":
        return "'"
    for i, ch in enumerate(s):
        followed_by_space = i + 1 == len(s) or s[i + 1] == " "
        if i == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                return "'"
            if ch in "?:-" and followed_by_space:
                return "'"
        else:
            if ch == ":" and followed_by_space:
                return "'"
            if ch == "#" and s[i - 1] == " ":
                return "'"
    return ""


def _scalar(value: Any, column: int) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        style = _str_style(value)
        text = value if not style else "'" + value.replace("'", "''") + "'"
        if " " in value and column + len(text) > _WIDTH:
            raise YamlSubsetError(f"string {value!r}: PyYAML folds it over lines at width "
                                  f"{_WIDTH}, which this writer does not")
        return text
    raise YamlSubsetError(f"value of type {type(value).__name__} is outside the subset")


def _emit(value: Any, indent: int, lines: list[str], prefix: str) -> None:
    """Append ``prefix`` + value; prefix is "key:" or "-" (or "" at the top)."""
    pad = " " * indent
    if isinstance(value, dict):
        if not value:
            lines.append(f"{pad}{prefix} {{}}" if prefix else "{}")
            return
        if prefix:
            lines.append(pad + prefix)
        inner = indent + 2 if prefix.endswith(":") else indent
        for key, item in value.items():
            if not isinstance(key, str):
                raise YamlSubsetError(f"mapping key {key!r}: only str keys are in the subset")
            _emit(item, inner, lines, _scalar(key, inner) + ":")
        return
    if isinstance(value, (list, tuple)):
        if not value:
            lines.append(f"{pad}{prefix} []" if prefix else "[]")
            return
        if prefix:
            lines.append(pad + prefix)
        for item in value:
            if isinstance(item, (dict, list, tuple)) and item:
                raise YamlSubsetError("a non-empty collection inside a sequence is outside the "
                                      "subset")
            _emit(item, indent, lines, "-")
        return
    text = _scalar(value, indent + len(prefix) + 1)
    lines.append(f"{pad}{prefix} {text}" if prefix else text)


def safe_dump(data: Any) -> str:
    """``yaml.safe_dump(data, sort_keys=False)`` for the subset."""
    lines: list[str] = []
    _emit(data, 0, lines, "")
    if not isinstance(data, (dict, list, tuple)):
        lines.append("...")  # PyYAML closes a bare top-level scalar
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


def _fail(lineno: int, msg: str):
    raise YamlSubsetError(f"YAML line {lineno}: {msg}")


def _strip_comment(text: str, lineno: int) -> str:
    """``text`` without a trailing comment (a # at the start or after a
    space, outside quotes)."""
    quote = None
    i = 0
    while i < len(text):
        ch = text[i]
        if quote:
            if ch == "\\" and quote == '"':
                i += 1
            elif ch == quote:
                if quote == "'" and i + 1 < len(text) and text[i + 1] == "'":
                    i += 1
                else:
                    quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " [{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    if quote:
        _fail(lineno, "a quoted scalar that spans lines is outside the subset")
    return text.rstrip()


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _double_quoted(body: str, lineno: int) -> str:
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        if i + 1 >= len(body):
            _fail(lineno, "a double-quoted scalar ends in a backslash")
        code = body[i + 1]
        if code in _ESCAPES:
            out.append(_ESCAPES[code])
            i += 2
        elif code in _HEX_ESCAPES:
            n = _HEX_ESCAPES[code]
            digits = body[i + 2:i + 2 + n]
            if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                _fail(lineno, f"bad escape \\{code}{digits}")
            out.append(chr(int(digits, 16)))
            i += 2 + n
        else:
            _fail(lineno, f"unknown escape \\{code}")
    return "".join(out)


def _resolve_plain(text: str, lineno: int) -> Any:
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        sign = -1 if text[0] == "-" else 1
        digits = text.lstrip("+-").replace("_", "")
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        if len(digits) > 1 and digits[0] == "0":
            return sign * int(digits, 8)
        return sign * int(digits)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return -math.inf if t[0] == "-" else math.inf
        if t.endswith(".nan"):
            return math.nan
        return float(t)
    if _SEXAGESIMAL.match(text) or _TIMESTAMP.match(text) or text in ("<<", "="):
        _fail(lineno, f"scalar {text!r} (sexagesimal, timestamp, merge or value key) is "
                      "outside the subset")
    if (": " in text or text.endswith(":") or text in ("-", "?")
            or text.startswith(("- ", "? ", ": "))):
        _fail(lineno, f"plain scalar {text!r}: an indicator PyYAML refuses there")
    if text[0] in "&*!|>%@`":
        _fail(lineno, f"{text[0]!r} (anchor, alias, tag, block scalar or directive) is outside "
                      "the subset")
    return text


def _scalar_token(text: str, lineno: int) -> Any:
    """One scalar: a whole quoted token (as ``_flow`` cuts it) or plain text."""
    if text[:1] == "'":
        if len(text) < 2 or text[-1] != "'":
            _fail(lineno, f"unterminated single-quoted scalar {text!r}")
        return text[1:-1].replace("''", "'")
    if text[:1] == '"':
        if len(text) < 2 or text[-1] != '"':
            _fail(lineno, f"unterminated double-quoted scalar {text!r}")
        return _double_quoted(text[1:-1], lineno)
    return _resolve_plain(text, lineno)


def _flow(text: str, pos: int, lineno: int) -> tuple[Any, int]:
    """Parse a flow node of ``text`` from ``pos``; returns (value, next pos)."""
    while pos < len(text) and text[pos] == " ":
        pos += 1
    if pos >= len(text):
        _fail(lineno, "unterminated flow collection")
    ch = text[pos]
    if ch in "[{":
        close = "]" if ch == "[" else "}"
        items: Any = [] if ch == "[" else {}
        pos += 1
        while True:
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if pos < len(text) and text[pos] == close:
                return items, pos + 1
            if ch == "[":
                value, pos = _flow(text, pos, lineno)
                items.append(value)
            else:
                key, pos = _flow(text, pos, lineno)
                if pos >= len(text) or text[pos] != ":":
                    _fail(lineno, f"flow mapping entry without ':' in {text!r}")
                value, pos = _flow(text, pos + 1, lineno)
                if isinstance(key, (list, dict)):
                    _fail(lineno, "a collection as a mapping key is outside the subset")
                items[key] = value
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if pos < len(text) and text[pos] == ",":
                pos += 1
            elif pos >= len(text) or text[pos] != close:
                _fail(lineno, f"expected ',' or {close!r} in {text!r}")
    if ch in "'\"":
        end = pos + 1
        while end < len(text):
            if text[end] == "\\" and ch == '"':
                end += 2
                continue
            if text[end] == ch:
                if ch == "'" and end + 1 < len(text) and text[end + 1] == "'":
                    end += 2
                    continue
                break
            end += 1
        return _scalar_token(text[pos:end + 1], lineno), end + 1
    end = pos
    while end < len(text) and text[end] not in ",]}" and not (
            text[end] == ":" and (end + 1 == len(text) or text[end + 1] in " ,]}")):
        end += 1
    return _scalar_token(text[pos:end].strip(), lineno), end


def _value(text: str, lineno: int) -> Any:
    """An inline value: a flow collection, a quoted scalar or a plain one."""
    if text[:1] in "[{'\"":
        value, end = _flow(text, 0, lineno)
        if text[end:].strip():
            _fail(lineno, f"text after a flow collection or quoted scalar: {text[end:]!r}")
        return value
    return _scalar_token(text, lineno)


def _split_key(text: str, lineno: int) -> tuple[str, str] | None:
    """(key, rest) of a "key: value" line, or None if it is not one."""
    if text[:1] in "'\"":
        value, end = _flow(text, 0, lineno)
        if text[end:end + 1] == ":" and (end + 1 == len(text) or text[end + 1] == " "):
            return value, text[end + 1:].strip()
        return None
    m = re.match(r"(.*?):(?: |$)", text)
    if not m or m.group(1).startswith(("[", "{")):
        return None
    return _resolve_plain(m.group(1).strip(), lineno), text[m.end():].strip()


class _Lines:
    def __init__(self, source: str):
        self.items: list[tuple[int, int, str]] = []  # (lineno, indent, text)
        started = False
        for lineno, raw in enumerate(source.splitlines(), 1):
            stripped = raw.lstrip(" ")
            if stripped.startswith("\t") or (not stripped.strip() and "\t" in raw
                                             and raw.strip()):
                _fail(lineno, "a tab in indentation is outside the subset")
            text = _strip_comment(stripped, lineno)
            if not text:
                continue
            if text == "---" or text.startswith("--- "):
                if started or text != "---":
                    _fail(lineno, "several documents, or content after '---', are outside "
                                  "the subset")
                started = True
                continue
            if text == "..." or text.startswith("%"):
                _fail(lineno, "document end markers and directives are outside the subset")
            started = True
            self.items.append((lineno, len(raw) - len(stripped), text))
        self.pos = 0

    def peek(self):
        return self.items[self.pos] if self.pos < len(self.items) else None


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines: _Lines, indent: int) -> Any:
    lineno, ind, text = lines.peek()
    if text == "?" or text.startswith("? "):
        _fail(lineno, "complex keys ('?') are outside the subset")
    if _is_item(text):
        return _sequence(lines, ind)
    if _split_key(text, lineno) is not None:
        return _mapping(lines, ind)
    lines.pos += 1
    nxt = lines.peek()
    if nxt is not None and nxt[1] > indent:
        _fail(nxt[0], "a multi-line scalar is outside the subset")
    return _value(text, lineno)


def _child(lines: _Lines, parent_indent: int, lineno: int, allow_same_indent_seq: bool) -> Any:
    """The block value under a "key:" or "-" with nothing after it."""
    nxt = lines.peek()
    if nxt is None:
        return None
    if nxt[1] > parent_indent:
        return _block(lines, parent_indent)
    if allow_same_indent_seq and nxt[1] == parent_indent and _is_item(nxt[2]):
        return _sequence(lines, parent_indent)
    return None


def _mapping(lines: _Lines, indent: int) -> dict:
    out: dict = {}
    while (cur := lines.peek()) is not None and cur[1] == indent and not _is_item(cur[2]):
        lineno, _, text = cur
        kv = _split_key(text, lineno)
        if kv is None:
            _fail(lineno, f"expected 'key: value', got {text!r}")
        key, rest = kv
        if isinstance(key, (list, dict)):
            _fail(lineno, "a collection as a mapping key is outside the subset")
        lines.pos += 1
        out[key] = _value(rest, lineno) if rest else _child(lines, indent, lineno, True)
    cur = lines.peek()
    if cur is not None and cur[1] > indent:
        _fail(cur[0], f"unexpected indentation {cur[1]} (mapping at {indent})")
    return out


def _sequence(lines: _Lines, indent: int) -> list:
    out: list = []
    while (cur := lines.peek()) is not None and cur[1] == indent and _is_item(cur[2]):
        lineno, _, text = cur
        rest = text[1:].lstrip(" ")
        if not rest:
            lines.pos += 1
            out.append(_child(lines, indent, lineno, False))
            continue
        # "- key: v" or "- - v": the rest opens a node at its own column
        column = indent + len(text) - len(rest)
        if _is_item(rest) or _split_key(rest, lineno) is not None:
            lines.items[lines.pos] = (lineno, column, rest)
            out.append(_block(lines, column))
        else:
            lines.pos += 1
            out.append(_value(rest, lineno))
    cur = lines.peek()
    if cur is not None and cur[1] > indent:
        _fail(cur[0], f"unexpected indentation {cur[1]} (sequence at {indent})")
    return out


def safe_load(source: str) -> Any:
    """``yaml.safe_load(source)`` for the subset; None for an empty document."""
    lines = _Lines(source)
    if lines.peek() is None:
        return None
    first = lines.peek()
    value = _block(lines, first[1] - 1)
    rest = lines.peek()
    if rest is not None:
        _fail(rest[0], f"unexpected content {rest[2]!r} after the document's top node")
    return value
