"""A reader for the block-style YAML of the repository's configs, for hosts
without PyYAML.

It reads what ``configs/*.yaml`` use: nested block mappings, block
sequences (of scalars or of mappings), flow sequences and flow mappings of
scalars, single- and double-quoted strings, and ``#`` comments. Scalars
resolve as PyYAML's YAML 1.1 resolver does them (``1e-05`` without a dot is
a string, ``yes``/``on`` are booleans, ``~`` is null), so a file read here
gives the dict ``yaml.safe_load`` gives. Anchors, tags, multi-line scalars
and documents separators are not read: :func:`safe_load` raises
``ValueError`` on them rather than guess.
"""

from __future__ import annotations

import json
import re
from typing import Any, List, Tuple

_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_BOOLS = {"yes": True, "Yes": True, "YES": True, "true": True,
          "True": True, "TRUE": True, "on": True, "On": True, "ON": True,
          "no": False, "No": False, "NO": False, "false": False,
          "False": False, "FALSE": False, "off": False, "Off": False,
          "OFF": False}
_NULLS = {"", "~", "null", "Null", "NULL"}


def _strip_comment(line: str) -> str:
    """``line`` without a trailing ``#`` comment (a ``#`` inside quotes, or
    not after whitespace, is kept)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str) -> Any:
    s = text.strip()
    if s.startswith("'"):
        if not s.endswith("'") or len(s) < 2:
            raise ValueError(f"unterminated quoted scalar {s!r}")
        return s[1:-1].replace("''", "'")
    if s.startswith('"'):
        return json.loads(s)
    if s.startswith("["):
        return [_scalar(p) for p in _split_flow(s, "[", "]")]
    if s.startswith("{"):
        out = {}
        for part in _split_flow(s, "{", "}"):
            k, v = _split_key(part)
            if k is None:
                raise ValueError(f"flow mapping entry without a key: {part!r}")
            out[k] = _scalar(v)
        return out
    if s[:1] in ("&", "*", "!", "|", ">") or s in ("---", "..."):
        raise ValueError(f"unsupported YAML construct {s!r}")
    if s in _NULLS:
        return None
    if s in _BOOLS:
        return _BOOLS[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        low = s.lower()
        if low.endswith("inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low.endswith("nan"):
            return float("nan")
        return float(s.replace("_", ""))
    return s


def _split_flow(s: str, open_: str, close: str) -> List[str]:
    """The comma-separated items of a one-line flow collection of
    scalars."""
    if not s.endswith(close):
        raise ValueError(f"unterminated flow collection {s!r}")
    body = s[1:-1]
    items, depth, quote, cur = [], 0, None, ""
    for ch in body:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
            continue
        if ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(cur)
            cur = ""
            continue
        cur += ch
    if cur.strip():
        items.append(cur)
    return [i.strip() for i in items]


def _split_key(content: str) -> Tuple[Any, str]:
    """``(key, rest)`` of a ``key: value`` line, or ``(None, content)``
    when the line is not a mapping entry."""
    quote = None
    for i, ch in enumerate(content):
        if quote:
            if ch == quote:
                quote = None
            continue
        if ch in "'\"" and i == 0:
            quote = ch
        elif ch == ":" and (i + 1 == len(content) or content[i + 1] in " \t"):
            key = _scalar(content[:i])
            return key, content[i + 1:].strip()
        elif ch in "[{" and i == 0:
            return None, content
    return None, content


class _Lines:
    def __init__(self, text: str):
        self.items: List[Tuple[int, str]] = []
        for raw in text.splitlines():
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise ValueError("tabs in indentation are not YAML")
            line = _strip_comment(raw).rstrip()
            if not line.strip():
                continue
            if line.strip() in ("---", "..."):
                raise ValueError("multi-document YAML is not read")
            self.items.append((len(line) - len(line.lstrip()), line.strip()))


def _parse_node(lines: _Lines, i: int, indent: int) -> Tuple[Any, int]:
    content = lines.items[i][1]
    if content == "-" or content.startswith("- "):
        return _parse_seq(lines, i, indent)
    return _parse_map(lines, i, indent)


def _parse_seq(lines: _Lines, i: int, indent: int) -> Tuple[list, int]:
    out: list = []
    items = lines.items
    while i < len(items) and items[i][0] == indent and (
            items[i][1] == "-" or items[i][1].startswith("- ")):
        rest = items[i][1][1:]
        stripped = rest.lstrip()
        if not stripped:
            if i + 1 < len(items) and items[i + 1][0] > indent:
                value, i = _parse_node(lines, i + 1, items[i + 1][0])
            else:
                value, i = None, i + 1
            out.append(value)
            continue
        col = indent + 1 + (len(rest) - len(stripped))
        key, _ = _split_key(stripped)
        if key is not None or stripped.startswith("- "):
            # the item is a nested node whose first line starts here
            items[i] = (col, stripped)
            value, i = _parse_node(lines, i, col)
        else:
            value, i = _scalar(stripped), i + 1
        out.append(value)
    if i < len(items) and items[i][0] > indent:
        raise ValueError(f"bad indentation at {items[i][1]!r}")
    return out, i


def _parse_map(lines: _Lines, i: int, indent: int) -> Tuple[dict, int]:
    out: dict = {}
    items = lines.items
    while i < len(items) and items[i][0] == indent:
        content = items[i][1]
        if content == "-" or content.startswith("- "):
            break
        key, rest = _split_key(content)
        if key is None:
            raise ValueError(f"expected 'key: value', got {content!r}")
        i += 1
        if rest:
            out[key] = _scalar(rest)
        elif i < len(items) and items[i][0] > indent:
            out[key], i = _parse_node(lines, i, items[i][0])
        elif i < len(items) and items[i][0] == indent and (
                items[i][1] == "-" or items[i][1].startswith("- ")):
            out[key], i = _parse_seq(lines, i, indent)
        else:
            out[key] = None
    if i < len(items) and items[i][0] > indent:
        raise ValueError(f"bad indentation at {items[i][1]!r}")
    return out, i


def safe_load(text: str) -> Any:
    """The document in ``text`` (None when it holds nothing)."""
    lines = _Lines(text)
    if not lines.items:
        return None
    first_indent = lines.items[0][0]
    if len(lines.items) == 1 and _split_key(lines.items[0][1])[0] is None \
            and not lines.items[0][1].startswith("- "):
        return _scalar(lines.items[0][1])
    value, i = _parse_node(lines, 0, first_indent)
    if i != len(lines.items):
        raise ValueError(f"unparsed YAML from {lines.items[i][1]!r}")
    return value
