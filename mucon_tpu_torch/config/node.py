"""The hierarchical config (mucon_tpu/config/node.py), without yaml at import.

* Python defaults (a nested tree of typed leaves, `config/defaults.py`),
* file overrides (`merge_from_file`),
* dotted inline overrides (`merge_from_list(["a.b.c", "1", ...])`),
* freeze / defrost, clone, and the `config.yaml` round trip of a run folder.

The JAX package reads `--set` strings and files with pyyaml, which the card
may not have.  Here:

* `--set` strings go through `parse_scalar`, which gives the value that
  pyyaml's `safe_load` (YAML 1.1) gives for a plain scalar (null, the
  bools yes/no/on/off/true/false in their three spellings, ints in
  decimal, octal `0..`, hex, binary and base 60, floats with a dot, `.inf`,
  `.nan`), a quoted string or a flow list `[a, b, ...]` of those;
* `dump` writes JSON, which is YAML flow syntax, so the JAX package's
  `merge_from_file` reads a port's `config.yaml` back to the same dict.
  A float is written with a dot (`1.0e-05`): pyyaml reads `1e-05` as a
  string;
* `merge_from_file` reads JSON directly and anything else (a JAX run
  folder's block-style `config.yaml`, `configs/*.yaml`) through a lazy
  `import yaml`.
"""

from __future__ import annotations

import copy
import json
import math
import re
from typing import Any, List

_VALID_LEAF_TYPES = (int, float, bool, str, type(None))

# pyyaml's implicit resolvers (yaml/resolver.py), timestamps left out
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"),
                         False)}
_NULL = ("", "~", "null", "Null", "NULL")
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


def _base60(text: str, cast):
    value = 0
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _to_int(text: str) -> int:
    """pyyaml's SafeConstructor.construct_yaml_int."""
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    text = text.lstrip("+-")
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _base60(text, int)
    return sign * int(text)


def _to_float(text: str) -> float:
    """pyyaml's SafeConstructor.construct_yaml_float."""
    text = text.replace("_", "").lower()
    sign = -1.0 if text[0] == "-" else 1.0
    text = text.lstrip("+-")
    if text == ".inf":
        return sign * math.inf
    if text == ".nan":
        return math.nan
    if ":" in text:
        return sign * _base60(text, float)
    return sign * float(text)


def _split_flow(body: str) -> List[str]:
    """Top-level comma-separated items of a flow list's body."""
    items, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(body):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(body[start:i])
            start = i + 1
    tail = body[start:]
    if tail.strip() or items:
        items.append(tail)
    return [x.strip() for x in items]


def parse_scalar(text: str) -> Any:
    """The value yaml.safe_load gives a plain scalar, a quoted string or a
    flow list (see the module docstring); any other text stays a string."""
    s = text.strip()
    if s.startswith("[") and s.endswith("]"):
        return [parse_scalar(x) for x in _split_flow(s[1:-1])]
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return json.loads(s) if s[0] == '"' else s[1:-1].replace("''", "'")
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _FLOAT.match(s):
        return _to_float(s)
    if _INT.match(s):
        return _to_int(s)
    return s


def _yaml_float(x: float) -> str:
    """A float as YAML 1.1 reads it back: with a dot before any exponent."""
    if math.isnan(x):
        return ".nan"
    if math.isinf(x):
        return ".inf" if x > 0 else "-.inf"
    text = repr(x)
    if "." not in text:
        mant, _, exp = text.partition("e")
        text = f"{mant}.0" + (f"e{exp}" if exp else "")
    return text


def _dump_value(v: Any, indent: int) -> str:
    pad = " " * indent
    if isinstance(v, dict):
        if not v:
            return "{}"
        inner = ",\n".join(f"{pad}  {json.dumps(str(k))}: {_dump_value(x, indent + 2)}"
                           for k, x in v.items())
        return "{\n" + inner + "\n" + pad + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_value(x, indent) for x in v) + "]"
    if isinstance(v, bool) or v is None:
        return json.dumps(v)
    if isinstance(v, float):
        return _yaml_float(v)
    if isinstance(v, int):
        return str(v)
    return json.dumps(str(v))


class ConfigNode(dict):
    """Nested attribute-accessible config dict with yacs-like semantics."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: dict | None = None):
        super().__init__()
        self.__dict__[ConfigNode.IMMUTABLE] = False
        if init_dict:
            for k, v in init_dict.items():
                if isinstance(v, dict):
                    v = ConfigNode(v)
                self[k] = v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, key: str, value: Any) -> None:
        if self.__dict__.get(ConfigNode.IMMUTABLE, False):
            raise AttributeError(f"Attempted to set '{key}' on an immutable ConfigNode")
        super().__setitem__(key, value)

    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return self.__dict__[ConfigNode.IMMUTABLE]

    def _set_immutable(self, value: bool) -> None:
        self.__dict__[ConfigNode.IMMUTABLE] = value
        for v in self.values():
            if isinstance(v, ConfigNode):
                v._set_immutable(value)

    def clone(self) -> "ConfigNode":
        out = copy.deepcopy(self)
        out.defrost()
        return out

    def merge_from_other(self, other: "ConfigNode") -> None:
        _merge_into(other, self, [])

    def merge_from_file(self, filename: str) -> None:
        with open(filename) as f:
            text = f.read()
        try:
            loaded = json.loads(text)
        except ValueError:
            import yaml

            loaded = yaml.safe_load(text)
        if loaded is None:
            return
        _merge_into(ConfigNode(loaded), self, [])

    def merge_from_list(self, opts: List[str]) -> None:
        """Merge from a flat list of dotted key / value string pairs."""
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list must have even length, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            node[leaf] = _coerce(value, node[leaf], key)

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, ConfigNode) else v for k, v in self.items()}

    def dump(self) -> str:
        """JSON text, which YAML reads as a flow mapping."""
        return _dump_value(self.to_dict(), 0) + "\n"

    def dump_to_file(self, filename: str) -> None:
        with open(filename, "w") as f:
            f.write(self.dump())

    def __str__(self) -> str:
        def _render(node: "ConfigNode", indent: int) -> str:
            lines = []
            for k in sorted(node.keys()):
                v = node[k]
                if isinstance(v, ConfigNode):
                    lines.append(" " * indent + f"{k}:")
                    lines.append(_render(v, indent + 2))
                else:
                    lines.append(" " * indent + f"{k}: {v!r}")
            return "\n".join(lines)

        return _render(self, 0)

    def __repr__(self) -> str:
        return f"ConfigNode({super().__repr__()})"

    def __deepcopy__(self, memo):
        out = ConfigNode()
        memo[id(self)] = out
        for k, v in self.items():
            dict.__setitem__(out, k, copy.deepcopy(v, memo))
        out.__dict__[ConfigNode.IMMUTABLE] = self.__dict__[ConfigNode.IMMUTABLE]
        return out


def _merge_into(src: ConfigNode, dst: ConfigNode, path: List[str]) -> None:
    for k, v in src.items():
        full = ".".join(path + [k])
        if k not in dst:
            raise KeyError(f"Non-existent config key: {full}")
        if isinstance(dst[k], ConfigNode):
            if not isinstance(v, ConfigNode):
                raise TypeError(f"Cannot overwrite subtree {full} with a leaf")
            _merge_into(v, dst[k], path + [k])
        else:
            dst[k] = _coerce(v, dst[k], full)


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Coerce an override value to the type of the existing leaf
    (mucon_tpu/config/node.py _coerce)."""
    if isinstance(value, str):
        if value.strip() == "" and isinstance(old, str):
            return value  # "" would parse as None; string leaves keep ""
        value = parse_scalar(value)
    if old is None or value is None:
        return value
    if isinstance(old, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            if value.lower() in ("true", "1", "yes"):
                return True
            if value.lower() in ("false", "0", "no"):
                return False
        if isinstance(value, int):
            return bool(value)
        raise TypeError(f"Cannot coerce {value!r} to bool for key {key}")
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if isinstance(old, (list, tuple)):
        if not isinstance(value, (list, tuple)):
            raise TypeError(f"Cannot coerce {value!r} to list for key {key}")
        return list(value)
    if old == "auto" and isinstance(value, (bool, int)):
        # tri-state leaves ("auto" | literal), e.g. tpu.use_pallas
        return value
    if type(old) is not type(value):
        if isinstance(old, _VALID_LEAF_TYPES) and isinstance(value, _VALID_LEAF_TYPES):
            raise TypeError(
                f"Type mismatch for key {key}: {type(old).__name__} vs "
                f"{type(value).__name__} ({value!r})"
            )
    return value


def update_config(default_config: ConfigNode, file_configs: List[str] = (),
                  set_configs: List[str] = ()) -> ConfigNode:
    """Compose defaults <- files <- dotted overrides, then freeze."""
    cfg = default_config.clone()
    for f in file_configs:
        cfg.merge_from_file(f)
    if set_configs:
        cfg.merge_from_list(list(set_configs))
    cfg.freeze()
    return cfg
