"""Config system: YAML files, deep merge, ``${a.b}`` interpolation,
attribute access and round-trip save.

Counterpart of ``d3net_tpu/config.py`` (``Config``, ``load``, ``merge``,
``save``) with its own YAML reader and writer, so the port needs no
PyYAML. The reader covers the subset that ``conf/**/*.yaml`` uses and
resolves its plain scalars as ``yaml.safe_load`` does (YAML 1.1: ``True``,
``null``, decimal ints, ``5.0e-5`` is a float and ``1e-5`` a string):

- block mappings and block sequences (items indented under their key or
  level with it), a sequence item holding a mapping;
- flow mappings and sequences on one line (``{a: 1, b: [2, 3]}``);
- plain, single- and double-quoted scalars; comments; empty values.

Anchors, aliases, tags, block scalars (``|``, ``>``), multi-line flow
collections and the scalar forms conf/ does not use (``yes``/``no``/``on``/
``off``, octal, hex and binary ints, ``.inf``, ``.nan``) raise
``ValueError``; a date stays a string. The writer emits block style in the key
order given, and its output reads back equal through both readers.
"""

from __future__ import annotations

import copy
import json
import math
import re
from typing import Any, Dict, List, Optional, Tuple

_INTERP = re.compile(r"\$\{([^}]+)\}")


class Config:
    """Attribute/key access wrapper over a nested dict with interpolation."""

    def __init__(self, data: Dict[str, Any], root: Optional["Config"] = None):
        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "_root", root if root is not None else self)

    # -- access ----------------------------------------------------------
    def _resolve(self, value):
        if isinstance(value, dict):
            return Config(value, self._root)
        if isinstance(value, list):
            return [self._resolve(v) for v in value]
        if isinstance(value, str) and "${" in value:
            return self._interpolate(value)
        return value

    def _interpolate(self, s: str):
        def node_at(path: str):
            node: Any = self._root
            for part in path.split("."):
                node = node[part]
            return node

        full = _INTERP.fullmatch(s)
        if full:
            return node_at(full.group(1))
        return _INTERP.sub(lambda m: str(node_at(m.group(1))), s)

    def __getattr__(self, key):
        try:
            return self._resolve(self._data[key])
        except KeyError as e:
            raise AttributeError(key) from e

    def __getitem__(self, key):
        return self._resolve(self._data[key])

    def __setattr__(self, key, value):
        self._data[key] = value

    def __setitem__(self, key, value):
        self._data[key] = value

    def __contains__(self, key):
        return key in self._data

    def get(self, key, default=None):
        if key in self._data:
            return self._resolve(self._data[key])
        return default

    def keys(self):
        return self._data.keys()

    def items(self):
        return [(k, self._resolve(v)) for k, v in self._data.items()]

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._data)

    def __repr__(self):
        return f"Config({self._data!r})"

    def __reduce__(self):
        # attribute access falls through to the data, so pickle (the
        # spawned ranks of a run get their config so) rebuilds from it
        root = self._root
        return (Config, (self._data, None if root is self else root))


def _deep_merge(base: Dict, over: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load(*paths: str) -> Config:
    """Load and deep-merge YAML files left-to-right (later wins)."""
    merged: Dict[str, Any] = {}
    for p in paths:
        with open(p) as f:
            data = parse_yaml(f.read()) or {}
        merged = _deep_merge(merged, data)
    return Config(merged)


def merge(*configs) -> Config:
    merged: Dict[str, Any] = {}
    for c in configs:
        d = c.to_dict() if isinstance(c, Config) else c
        merged = _deep_merge(merged, d)
    return Config(merged)


def save(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        f.write(dump_yaml(cfg.to_dict()))


# ---------------------------------------------------------------------------
# YAML reader (the subset above)

# PyYAML's implicit resolvers (YAML 1.1) for the plain scalars conf/ uses:
# true/false, null, decimal ints and floats; its other forms raise
_BOOL = {f: w == "true" for w in ("true", "false")
         for f in (w, w.capitalize(), w.upper())}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?")
_OTHER = re.compile(r"yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF"
                    r"|[-+]?0[0-9bx_].*|[-+]?\.(?:inf|Inf|INF|nan|NaN|NAN)"
                    r"|[&*!|>%@`].*")


def _plain(text: str):
    """A plain scalar as ``yaml.safe_load`` resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if _OTHER.fullmatch(text):
        raise ValueError(f"YAML form outside the supported subset: {text!r}")
    return text


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment (at the start or after a space, not quoted)."""
    quote = None
    skip = False
    for i, ch in enumerate(line):
        if skip:
            skip = False
        elif quote:
            if quote == '"' and ch == "\\":
                skip = True
            elif ch == quote:
                if quote == "'" and line[i + 1:i + 2] == "'":
                    skip = True
                else:
                    quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t:[{,-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _quoted(s: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``s[i]``; returns (value, end)."""
    q = s[i]
    j = i + 1
    while j < len(s):
        if q == '"' and s[j] == "\\":
            j += 2
            continue
        if s[j] == q:
            if q == "'" and j + 1 < len(s) and s[j + 1] == "'":
                j += 2
                continue
            break
        j += 1
    else:
        raise ValueError(f"unterminated quoted scalar: {s[i:]!r}")
    body = s[i:j + 1]
    value = json.loads(body) if q == '"' else body[1:-1].replace("''", "'")
    return value, j + 1


class _Flow:
    """Recursive descent over one line of flow YAML."""

    def __init__(self, s: str):
        self.s, self.i = s, 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def _peek(self) -> str:
        self._ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def _more(self, close: str) -> bool:
        ch = self._peek()
        if not ch:
            raise ValueError(f"unterminated flow collection: {self.s!r}")
        return ch != close

    def _expect(self, ch: str):
        if self._peek() != ch:
            raise ValueError(f"expected {ch!r} at {self.i} in {self.s!r}")
        self.i += 1

    def value(self, stops: str):
        ch = self._peek()
        if ch == "[":
            self.i += 1
            out = []
            while self._more("]"):
                out.append(self.value(",]"))
                if self._peek() == ",":
                    self.i += 1
            self._expect("]")
            return out
        if ch == "{":
            self.i += 1
            out = {}
            while self._more("}"):
                key = self.value(":,}")
                if self._peek() == ":":
                    self.i += 1
                    out[key] = self.value(",}")
                else:
                    out[key] = None
                if self._peek() == ",":
                    self.i += 1
            self._expect("}")
            return out
        if ch in "'\"":
            v, self.i = _quoted(self.s, self.i)
            return v
        j = self.i
        while j < len(self.s) and self.s[j] not in stops:
            # ':' ends a flow key only before a space or a flow indicator
            if (self.s[j] == ":" and ":" in stops and j + 1 < len(self.s)
                    and self.s[j + 1] not in " ,]}"):
                j += 1
                continue
            j += 1
        text = self.s[self.i:j].strip()
        self.i = j
        return _plain(text)

    def parse(self):
        v = self.value("")
        if self._peek():
            raise ValueError(f"trailing text in {self.s!r}")
        return v


def _inline(text: str):
    """A value written on its key's (or item's) line."""
    if text[0] in "[{":
        return _Flow(text).parse()
    if text[0] in "'\"":
        v, end = _quoted(text, 0)
        if text[end:].strip():
            raise ValueError(f"trailing text after quoted scalar {text!r}")
        return v
    return _plain(text)


_KEY = re.compile(r"""(?P<key>'[^']*'|"[^"]*"|[^'"\s#\-\[{][^:#]*?|-[^\s:][^:]*?)"""
                  r"""\s*:(?:\s+(?P<rest>.*))?$""")


def _split_key(content: str):
    """``key: rest`` -> (key, rest or ""), or None if not a mapping entry."""
    m = _KEY.match(content)
    if m is None:
        return None
    key = m.group("key")
    if key[0] in "'\"":
        key = _quoted(key, 0)[0]
    else:
        key = _plain(key.strip())
    return key, (m.group("rest") or "").strip()


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def parse_yaml(text: str):
    """YAML text (the subset in the module note) -> Python objects."""
    lines: List[List] = []
    for raw in text.splitlines():
        body = _strip_comment(raw).rstrip()
        if not body.strip() or body.strip() in ("---", "..."):
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t"):
            raise ValueError("tab indentation is not YAML")
        lines.append([len(body) - len(stripped), stripped])
    if not lines:
        return None
    node, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected indentation at: {lines[i][1]!r}")
    return node


def _block(lines, i: int, indent: int):
    if _is_item(lines[i][1]):
        return _sequence(lines, i, indent)
    if _split_key(lines[i][1]) is None:
        if i + 1 < len(lines) and lines[i + 1][0] > indent:
            raise ValueError("multi-line scalars are not supported: "
                             f"{lines[i][1]!r}")
        return _inline(lines[i][1]), i + 1
    return _mapping(lines, i, indent)


def _nested(lines, i: int, indent: int, same_level_seq: bool):
    """The block value that starts on line ``i`` under a line at
    ``indent``, or None when nothing is nested there."""
    if i < len(lines):
        ind, content = lines[i]
        if ind > indent:
            return _block(lines, i, ind)
        if same_level_seq and ind == indent and _is_item(content):
            return _sequence(lines, i, indent)
    return None, i


def _mapping(lines, i: int, indent: int):
    out: Dict[Any, Any] = {}
    while i < len(lines) and lines[i][0] == indent \
            and not _is_item(lines[i][1]):
        kv = _split_key(lines[i][1])
        if kv is None:
            raise ValueError(f"expected 'key: value', got {lines[i][1]!r}")
        key, rest = kv
        if rest:
            out[key], i = _inline(rest), i + 1
        else:
            out[key], i = _nested(lines, i + 1, indent, True)
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"unexpected indentation at: {lines[i][1]!r}")
    return out, i


def _sequence(lines, i: int, indent: int):
    out: List[Any] = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        rest = lines[i][1][1:].lstrip(" ")
        if not rest:
            value, i = _nested(lines, i + 1, indent, False)
        elif _is_item(rest) or _split_key(rest) is not None:
            # the item holds a block: re-read its text as the first line of
            # a block at the text's own column
            lines[i] = [indent + len(lines[i][1]) - len(rest), rest]
            value, i = _block(lines, i, lines[i][0])
        else:
            value, i = _inline(rest), i + 1
        out.append(value)
    return out, i


# ---------------------------------------------------------------------------
# YAML writer: block style (JSON is no substitute: it writes 5e-05, which
# YAML 1.1 reads as a string)

_SAFE_PLAIN = re.compile(r"[A-Za-z_/.$][A-Za-z0-9_./${}+-]*")


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if not math.isfinite(v):
            raise ValueError(f"cannot write {v} in the supported YAML subset")
        r = repr(v)
        if "." not in r:          # 1e-05 reads as a string in YAML 1.1
            r = r.replace("e", ".0e") if "e" in r else r + ".0"
        return r
    if isinstance(v, str):
        try:
            plain = bool(_SAFE_PLAIN.fullmatch(v)) and _plain(v) == v
        except ValueError:          # a YAML 1.1 form the reader refuses
            plain = False
        return v if plain else json.dumps(v, ensure_ascii=False)
    raise TypeError(f"cannot write {type(v).__name__} as YAML: {v!r}")


def _dump(node, indent: int) -> List[str]:
    pad = " " * indent
    lines: List[str] = []
    if isinstance(node, dict):
        for k, v in node.items():
            key = _scalar(k)
            if isinstance(v, dict) and v:
                lines.append(f"{pad}{key}:")
                lines += _dump(v, indent + 2)
            elif isinstance(v, list) and v:
                lines.append(f"{pad}{key}:")
                lines += _dump(v, indent)
            else:
                lines.append(f"{pad}{key}: {_inline_text(v)}")
    else:
        for v in node:
            if isinstance(v, (dict, list)) and v:
                sub = _dump(v, indent + 2)
                lines.append(f"{pad}- {sub[0][indent + 2:]}")
                lines += sub[1:]
            else:
                lines.append(f"{pad}- {_inline_text(v)}")
    return lines


def _inline_text(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, list):
        return "[]"
    return _scalar(v)


def dump_yaml(data: Dict[str, Any]) -> str:
    """A mapping as block-style YAML text."""
    return "\n".join(_dump(data, 0)) + "\n" if data else "{}\n"
