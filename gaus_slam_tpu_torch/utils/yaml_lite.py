"""A reader for the subset of YAML that the dataset profiles use
(configs/data/*.yaml), so the loaders need no YAML package.

Covered: nested mappings by indentation, ``#`` comments, plain scalars
resolved as YAML 1.1 (PyYAML's ``full_load``) resolves them — null, bool,
decimal int, float, else string — quoted strings, and flow lists
``[a, b]`` of scalars. Anything else (block lists, anchors, tags,
multi-line scalars, octal / hex / sexagesimal numbers, dates, duplicate
keys) raises ``ValueError`` with the line number.
"""
from __future__ import annotations

import re

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# plain scalars YAML 1.1 would read as something this reader does not
# build: other int bases, sexagesimal numbers, timestamps, merge keys
_REFUSED = re.compile(r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$"
                      r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"
                      r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}|<<$|=$")
_INDICATORS = "&*!|>%@`{}-?,["
_NUMERIC_START = re.compile(r"[-+.]?[0-9.]")


def _strip_comment(text: str) -> str:
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
    return text


def _scalar(tok: str, lineno: int):
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        body = tok[1:-1]
        if tok[0] == "'":
            return body.replace("''", "'")
        if "\\" in body:
            raise ValueError(f"line {lineno}: escapes in double-quoted "
                             f"strings are not read")
        return body
    if tok[:1] in ("'", '"') or (tok[:1] in _INDICATORS and tok != "-"
                                 and not _NUMERIC_START.match(tok)):
        raise ValueError(f"line {lineno}: unsupported scalar {tok!r}")
    if ": " in tok or tok.endswith(":") or " #" in tok:
        raise ValueError(f"line {lineno}: unsupported scalar {tok!r}")
    if tok in _NULL:
        return None
    if tok in _TRUE:
        return True
    if tok in _FALSE:
        return False
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok):
        return float(tok.replace("_", ""))
    if _INF.match(tok):
        return float("-inf") if tok[0] == "-" else float("inf")
    if _NAN.match(tok):
        return float("nan")
    if _REFUSED.match(tok):
        raise ValueError(f"line {lineno}: unsupported scalar {tok!r}")
    return tok


def _value(text: str, lineno: int):
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]") or "[" in text[1:] or "{" in text:
            raise ValueError(f"line {lineno}: only flat flow lists are read")
        body = text[1:-1].strip()
        return [] if not body else [_scalar(t, lineno)
                                    for t in body.split(",")]
    return _scalar(text, lineno)


def loads(text: str) -> dict:
    """The mapping of a YAML document (None for an empty one, as
    ``yaml.full_load`` gives)."""
    root: dict = {}
    # (indent of the mapping's keys, the mapping)
    stack: list = [(0, root)]
    pending = None  # (key's indent, parent, key) of a key awaiting a block
    seen = False
    for lineno, line in enumerate(text.splitlines(), 1):
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f"line {lineno}: tab in indentation")
        body = _strip_comment(line).rstrip()
        if not body.strip():
            continue
        if body.strip() in ("---", "...") and not line.startswith(" "):
            raise ValueError(f"line {lineno}: document markers are not read")
        indent = len(body) - len(body.lstrip())
        stripped = body.strip()
        if stripped.startswith("- ") or stripped == "-":
            raise ValueError(f"line {lineno}: block lists are not read")
        m = re.match(r"""((?:"[^"]*"|'[^']*'|[^:#'"]+?)):(?:\s+(.*))?$""",
                     stripped)
        if m is None:
            raise ValueError(f"line {lineno}: expected 'key: value', got "
                             f"{stripped!r}")
        seen = True
        if pending is not None:
            p_indent, parent, key = pending
            if indent > p_indent:
                child: dict = {}
                parent[key] = child
                stack.append((indent, child))
            else:
                parent[key] = None
            pending = None
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError(f"line {lineno}: indentation does not match "
                             f"any open mapping")
        mapping = stack[-1][1]
        key = _scalar(m.group(1), lineno)
        if key in mapping:
            raise ValueError(f"line {lineno}: duplicate key {key!r}")
        rest = m.group(2)
        if rest is None or not rest.strip():
            mapping[key] = None
            pending = (indent, mapping, key)
        else:
            mapping[key] = _value(rest, lineno)
    return root if seen else None


def load(path: str) -> dict:
    with open(path) as f:
        return loads(f.read())
