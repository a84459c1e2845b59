"""Minimal HOCON parser + ConfigTree.

The reference stack (kofinandi/pixel-nerf-yolo) drives everything through
pyhocon HOCON files with ``include required(...)`` layering
(reference src/util/args.py:6,89-99, conf/default_mv.conf).  pyhocon is
not available in this environment, so we implement the HOCON subset the
framework needs:

  * ``#`` and ``//`` comments (full-line and trailing)
  * ``include required("relative/path.conf")`` / ``include "path"``
  * nested objects ``name { ... }`` with deep-merge on duplicate keys
  * ``key = value`` and ``key : value`` and ``key { ... }``
  * scalars: int, float, bool (true/false/True/False), quoted + bare strings
  * (nested) lists, possibly spanning multiple lines
  * dotted-path lookup: ``conf["model.mlp_coarse.yolo"]``

The Config object mirrors the pyhocon ConfigTree API surface used by the
reference (``get_bool/get_int/get_float/get_string/get_list/get_config``).
"""

from __future__ import annotations

import os
import re
from typing import Any, Iterator, Optional


class ConfigMissingError(KeyError):
    pass


class Config:
    """Nested configuration tree with dotted-path access."""

    def __init__(self, data: Optional[dict] = None):
        self._data: dict = data if data is not None else {}

    # -- dict-ish interface -------------------------------------------------
    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def __len__(self) -> int:
        return len(self._data)

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, Config):
            return self._data == other._data
        if isinstance(other, dict):
            return self._data == other
        return NotImplemented

    def to_dict(self) -> dict:
        def conv(v):
            if isinstance(v, Config):
                return v.to_dict()
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, list):
                return [conv(x) for x in v]
            return v

        return {k: conv(v) for k, v in self._data.items()}

    # -- path access --------------------------------------------------------
    _MISSING = object()

    def _resolve(self, path: str, default=_MISSING):
        node: Any = self._data
        for part in path.split("."):
            if isinstance(node, Config):
                node = node._data
            if not isinstance(node, dict) or part not in node:
                if default is Config._MISSING:
                    raise ConfigMissingError(path)
                return default
            node = node[part]
        if isinstance(node, dict):
            return Config(node)
        return node

    def __getitem__(self, path: str):
        return self._resolve(path)

    def __contains__(self, path: str) -> bool:
        try:
            self._resolve(path)
            return True
        except ConfigMissingError:
            return False

    def get(self, path: str, default=None):
        return self._resolve(path, default)

    def get_config(self, path: str, default=_MISSING) -> "Config":
        v = self._resolve(path, default)
        if isinstance(v, dict):
            return Config(v)
        return v

    def get_bool(self, path: str, default=_MISSING) -> bool:
        v = self._resolve(path, default)
        if isinstance(v, str):
            return v.lower() in ("true", "yes", "on", "1")
        return bool(v)

    def get_int(self, path: str, default=_MISSING) -> int:
        return int(self._resolve(path, default))

    def get_float(self, path: str, default=_MISSING) -> float:
        return float(self._resolve(path, default))

    def get_string(self, path: str, default=_MISSING) -> str:
        v = self._resolve(path, default)
        return v if v is None else str(v)

    def get_list(self, path: str, default=_MISSING) -> list:
        v = self._resolve(path, default)
        if v is None or isinstance(v, list):
            return v
        raise TypeError(f"config key {path!r} is not a list: {v!r}")

    # -- mutation (used by tests / programmatic config) ----------------------
    def put(self, path: str, value) -> None:
        parts = path.split(".")
        node = self._data
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
                node[p] = nxt
            node = nxt
        if isinstance(value, Config):
            value = value.to_dict()
        node[parts[-1]] = value


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------

_INCLUDE_RE = re.compile(
    r'^\s*include\s+(?:required\s*\(\s*)?"(?P<path>[^"]+)"\s*\)?\s*$'
)


def _strip_comment(line: str) -> str:
    """Remove # / // comments outside of quoted strings."""
    out = []
    in_str = False
    i = 0
    while i < len(line):
        ch = line[i]
        if in_str:
            out.append(ch)
            if ch == '"':
                in_str = False
            i += 1
            continue
        if ch == '"':
            in_str = True
            out.append(ch)
            i += 1
            continue
        if ch == "#" or line.startswith("//", i):
            break
        out.append(ch)
        i += 1
    return "".join(out)


def _coerce_scalar(tok: str):
    t = tok.strip()
    if t.startswith('"') and t.endswith('"') and len(t) >= 2:
        return t[1:-1]
    low = t.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "none"):
        return None
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    return t


def _parse_value(text: str):
    text = text.strip()
    if text.startswith("["):
        val, rest = _parse_list(text)
        if rest.strip():
            raise ValueError(f"trailing data after list: {rest!r}")
        return val
    return _coerce_scalar(text)


def _parse_list(text: str):
    """Parse a (possibly nested) ``[...]`` literal; returns (value, remainder)."""
    assert text[0] == "["
    items: list = []
    i = 1
    buf = ""

    def flush():
        nonlocal buf
        if buf.strip():
            items.append(_coerce_scalar(buf))
        buf = ""

    while i < len(text):
        ch = text[i]
        if ch == "[":
            sub, rest = _parse_list(text[i:])
            items.append(sub)
            text = text[:i] + rest
            continue
        if ch == "]":
            flush()
            return items, text[i + 1 :]
        if ch == ",":
            flush()
            i += 1
            continue
        buf += ch
        i += 1
    raise ValueError("unterminated list literal")


def _deep_merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def _parse_lines(lines: list[str], base_dir: str) -> dict:
    root: dict = {}
    stack: list[dict] = [root]
    i = 0
    n = len(lines)
    while i < n:
        raw = _strip_comment(lines[i]).strip()
        i += 1
        if not raw:
            continue

        m = _INCLUDE_RE.match(raw)
        if m:
            inc_path = m.group("path")
            if not os.path.isabs(inc_path):
                inc_path = os.path.join(base_dir, inc_path)
            included = parse_file(inc_path)
            _deep_merge(stack[-1], included.to_dict())
            continue

        if raw == "}":
            if len(stack) == 1:
                raise ValueError("unbalanced '}'")
            stack.pop()
            continue

        # "name {"  (object open)
        if raw.endswith("{"):
            name = raw[:-1].strip().rstrip("=").rstrip(":").strip()
            node = stack[-1].setdefault(name, {})
            if not isinstance(node, dict):
                node = {}
                stack[-1][name] = node
            stack.append(node)
            continue

        # inline object: "name { k = v }"
        mo = re.match(r"^([\w.\-]+)\s*[:=]?\s*\{(.*)\}\s*$", raw)
        if mo and "{" not in mo.group(2):
            name, body = mo.group(1), mo.group(2)
            node = stack[-1].setdefault(name, {})
            sub = _parse_lines([s.strip() for s in body.split(",")], base_dir)
            _deep_merge(node, sub)
            continue

        # key = value  (value may be a multi-line list)
        kv = re.match(r"^([\w.\-]+)\s*[:=]\s*(.*)$", raw)
        if kv:
            key, val_text = kv.group(1), kv.group(2).strip()
            if val_text.startswith("["):
                # accumulate lines until brackets balance
                depth = val_text.count("[") - val_text.count("]")
                while depth > 0 and i < n:
                    nxt = _strip_comment(lines[i]).strip()
                    i += 1
                    val_text += " " + nxt
                    depth += nxt.count("[") - nxt.count("]")
            value = _parse_value(val_text)
            # dotted keys create nested objects (HOCON path expressions)
            target = stack[-1]
            parts = key.split(".")
            for p in parts[:-1]:
                nxt_node = target.setdefault(p, {})
                if not isinstance(nxt_node, dict):
                    nxt_node = {}
                    target[p] = nxt_node
                target = nxt_node
            if (
                parts[-1] in target
                and isinstance(target[parts[-1]], dict)
                and isinstance(value, dict)
            ):
                _deep_merge(target[parts[-1]], value)
            else:
                target[parts[-1]] = value
            continue

        raise ValueError(f"cannot parse config line: {raw!r}")

    if len(stack) != 1:
        raise ValueError("unbalanced '{' in config")
    return root


def _normalize(text: str) -> list[str]:
    """Split object braces onto separate lines (outside strings / list
    literals) so ``model { a = 1 }`` parses the same as the multi-line form."""
    lines_out = []
    depth = 0  # [] nesting — carried ACROSS lines: a list literal may
    # wrap over several physical lines, and its commas must survive
    for raw in text.splitlines():
        line = _strip_comment(raw)
        buf = ""
        in_str = False
        for ch in line:
            if in_str:
                buf += ch
                if ch == '"':
                    in_str = False
                continue
            if ch == '"':
                in_str = True
                buf += ch
                continue
            if ch == "[":
                depth += 1
            elif ch == "]":
                depth -= 1
            if depth == 0 and ch == "{":
                lines_out.append(buf + " {")
                buf = ""
                continue
            if depth == 0 and ch == "}":
                if buf.strip():
                    lines_out.append(buf)
                lines_out.append("}")
                buf = ""
                continue
            if depth == 0 and ch == ",":
                # comma-separated object members (HOCON inline form:
                # "yolo { a = 1, b = 2 }") become separate lines; commas
                # inside [] list literals are preserved above
                if buf.strip():
                    lines_out.append(buf)
                buf = ""
                continue
            buf += ch
        if buf.strip():
            lines_out.append(buf)
    return lines_out


def parse_string(text: str, base_dir: str = ".") -> Config:
    return Config(_parse_lines(_normalize(text), base_dir))


def parse_file(path: str) -> Config:
    with open(path, "r") as f:
        text = f.read()
    return Config(_parse_lines(_normalize(text), os.path.dirname(os.path.abspath(path))))
