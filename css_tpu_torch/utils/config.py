"""The pipeline config reader: the subset of YAML that
``configs/infer_{1ch,7ch}.yaml`` use, without PyYAML.

    from css_tpu_torch.utils.config import load_config
    config = load_config("configs/infer_1ch.yaml")

What it reads, with the types ``yaml.safe_load`` gives them:
  * block mappings nested by indentation (spaces), ``key: value`` and
    ``key:`` opening a deeper mapping (or null when none follows);
  * ``#`` comments, on a line of their own or after a value;
  * scalars resolved as PyYAML's YAML 1.1 resolvers resolve them: decimal
    ints, floats (``0.8``, ``1.0e-4``, ``.inf``; ``1e-4`` without a dot
    stays a string, as in PyYAML), booleans (``True``, ``false``, ``yes``,
    ``off`` ...), null (``null``, ``~``, nothing), single- and
    double-quoted strings, and plain strings such as ``1,0;2,0``.
Anything else (sequences, flow collections, anchors and aliases, tags,
block scalars, documents, tabs, octal or hex or sexagesimal numbers)
raises a ``ValueError`` that names the file and the line. The reader is
the port's only config reader; PyYAML is never consulted.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                              "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF")}}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"([-+]?[0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)"
                    r"([eE][-+][0-9]+)?$")
_SPECIAL_FLOAT = {".inf": float("inf"), ".Inf": float("inf"),
                  ".INF": float("inf"), "-.inf": float("-inf"),
                  "-.Inf": float("-inf"), "-.INF": float("-inf"),
                  "+.inf": float("inf"), "+.Inf": float("inf"),
                  "+.INF": float("inf"), ".nan": float("nan"),
                  ".NaN": float("nan"), ".NAN": float("nan")}
# what PyYAML would read as another int form (binary, octal, hex,
# sexagesimal) or a timestamp: outside the subset
_OTHER_NUMBER = re.compile(
    r"[-+]?(0b[01_]+|0[0-7_]+|0x[0-9a-fA-F_]+|[0-9][0-9_]*(:[0-5]?[0-9])+"
    r"(\.[0-9_]*)?)$|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
# a plain scalar may not start with these indicators
_INDICATORS = set("[]{},&*!|>'\"%@`-?:#")
_DQ_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/",
               "0": "\0", "r": "\r"}


def _fail(where: str, what: str):
    raise ValueError(f"{where}: {what} is outside the YAML subset the config "
                 f"reader takes (nested mappings of scalars)")


def _resolve_plain(text: str, where: str) -> Any:
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if text in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _OTHER_NUMBER.match(text):
        _fail(where, f"the number or date {text!r}")
    if text[0] in _INDICATORS and not (text[0] in "-?:" and len(text) > 1
                                       and text[1] not in " "):
        _fail(where, f"the scalar {text!r}")
    if ": " in text or text.endswith(":") or " #" in text:
        _fail(where, f"the scalar {text!r}")
    return text


def _quoted(text: str, where: str) -> Tuple[str, str]:
    """A quoted scalar at the start of ``text`` -> (its value, the rest)."""
    q = text[0]
    out: List[str] = []
    i = 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1: i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and c == "\\":
            esc = text[i + 1: i + 2]
            if esc not in _DQ_ESCAPES:
                _fail(where, f"the escape \\{esc}")
            out.append(_DQ_ESCAPES[esc])
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), text[i + 1:]
        out.append(c)
        i += 1
    _fail(where, "a quoted string that does not end on its line")


def _value(text: str, where: str) -> Any:
    """The scalar after ``key:`` (comment included), resolved."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, where)
        rest = rest.strip()
        if rest and not rest.startswith("#"):
            _fail(where, f"text after a quoted string ({rest!r})")
        return value
    m = re.search(r"(^|\s)#", text)
    if m:
        text = text[: m.start()].rstrip()
    return _resolve_plain(text, where)


def loads(text: str, name: str = "<config>") -> Dict[str, Any]:
    """Parse config text; ``name`` labels the errors."""
    root: Dict[str, Any] = {}
    # open mappings: (indent of their keys, the dict); the root's keys sit
    # at column 0. ``pending`` is a key whose value is the mapping that the
    # next deeper line opens (None while none is open)
    stack: List[Tuple[int, Dict[str, Any]]] = [(0, root)]
    pending = None  # (indent of the key, its parent dict, the key)
    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f"{name}, line {lineno}"
        if "\t" in raw and not raw.lstrip().startswith("#"):
            _fail(where, "a tab")
        body = raw.strip()
        if not body or body.startswith("#"):
            continue
        indent = len(raw) - len(raw.lstrip(" "))
        if body.startswith(("---", "...")) or body[0] in "-?[{&*!|>%":
            _fail(where, f"the line {body!r}")
        if pending is not None:
            p_indent, parent, key = pending
            if indent > p_indent:
                child: Dict[str, Any] = {}
                parent[key] = child
                stack.append((indent, child))
            pending = None
        while stack and indent < stack[-1][0]:
            stack.pop()
        if not stack or indent != stack[-1][0]:
            _fail(where, "an indentation that matches no open mapping")
        mapping = stack[-1][1]
        if body[:1] in ("'", '"'):
            _fail(where, "a quoted key")
        m = re.match(r"([^:#]*?)\s*:(\s|$)", body)
        if m is None:
            _fail(where, f"the line {body!r} (not `key: value`)")
        key = _resolve_plain(m.group(1), where) if m.group(1) else None
        if not isinstance(key, str):
            _fail(where, f"the key {m.group(1)!r} (not a string)")
        rest = body[m.end():]
        if not rest.strip() or rest.strip().startswith("#"):
            mapping[key] = None
            pending = (indent, mapping, key)
        else:
            mapping[key] = _value(rest, where)
    return root


def load_config(path) -> Dict[str, Any]:
    """The config file at ``path`` as nested dicts of scalars."""
    with open(path) as fh:
        return loads(fh.read(), str(path))
