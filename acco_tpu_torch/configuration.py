"""Hydra-style configuration composition over the shared ``config/`` tree.

Counterpart of ``acco_tpu/configuration.py``: the same ``defaults`` list,
group overrides (``train=dpu``), dotted value overrides
(``train.learning_rate=1e-3``), additions (``+train.x=1``), attribute
access and ``to_container()``, and the same float coercion of
exponent-only scalars (``6e-4``), which YAML 1.1 leaves as strings.

The machine with the card has no PyYAML, so :func:`load_yaml` reads the
subset of YAML that ``config/`` uses, with PyYAML's YAML 1.1 scalar
typing: block mappings and sequences, flow mappings and sequences of
scalars, quoted and plain scalars, comments; :func:`dump_yaml` writes a
composed config (the run dir's ``config.yaml``) in a form it reads back.

:func:`check_supported` rejects, by name, the keys this port cannot run
yet, pointing at the ROADMAP item that brings each. TPU-only knobs
(``scan_unroll``, ``comm_impl``) are read and ignored. ``warmup_compile``
takes JAX's meaning and default (true: the kernel libraries built in the
background from the trainer's constructor on and every round program
captured before the first round; ``compile/``). ``compile_cache_dir``
is read and ignored: a CUDA graph cannot outlive its process, and the
kernel libraries are already kept in ``build/`` by the hash of their
sources and flags (``compile/cache.py``).
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Iterable

# Scalars like '6e-4' that YAML 1.1 leaves as strings but OmegaConf treats
# as floats. Requires an exponent to avoid touching int-like strings.
_FLOAT_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")

# PyYAML's YAML 1.1 implicit resolvers (yaml/resolver.py), for the
# scalar forms the configs use.
_BOOL = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False),
}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT_RE = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT11_RE = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$"
)
_INF_RE = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN_RE = re.compile(r"^\.(?:nan|NaN|NAN)$")


def parse_scalar(text: str) -> Any:
    """One plain or quoted scalar, typed as PyYAML's safe_load types it."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        return body.replace("''", "'") if text[0] == "'" else body
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT_RE.match(text):
        return int(text.replace("_", ""))
    if _FLOAT11_RE.match(text):
        return float(text.replace("_", ""))
    if _INF_RE.match(text):
        return float("-inf") if text.startswith("-") else float("inf")
    if _NAN_RE.match(text):
        return float("nan")
    return text


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that is not inside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_flow(body: str) -> list[str]:
    """Split a flow collection's body on top-level commas."""
    parts, depth, quote, cur = [], 0, None, ""
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
            continue
        cur += ch
    if cur.strip():
        parts.append(cur)
    return parts


def parse_value(text: str) -> Any:
    """A scalar or a one-line flow collection (``{dp: 1, sp: 16}``)."""
    text = text.strip()
    if text.startswith("{") and text.endswith("}"):
        out = {}
        for item in _split_flow(text[1:-1]):
            key, _, val = item.partition(":")
            out[parse_scalar(key)] = parse_value(val)
        return out
    if text.startswith("[") and text.endswith("]"):
        return [parse_value(item) for item in _split_flow(text[1:-1])]
    return parse_scalar(text)


def _split_key(content: str):
    """``key: rest`` -> (key, rest), or None when the line is no mapping entry."""
    m = re.match(r"^((?:'[^']*'|\"[^\"]*\"|[^:'\"]+?)):(?:\s+(.*)|$)", content)
    if not m:
        return None
    return parse_scalar(m.group(1)), (m.group(2) or "").strip()


def load_yaml_text(text: str) -> Any:
    """Parse the YAML subset described in the module docstring."""
    lines = []
    for raw in text.splitlines():
        stripped = _strip_comment(raw)
        if stripped.strip() and stripped.strip() != "---":
            lines.append((len(stripped) - len(stripped.lstrip(" ")), stripped.strip()))
    if not lines:
        return None
    node, pos = _parse_block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"unexpected YAML structure at: {lines[pos][1]!r}")
    return node


def _parse_block(lines, pos, indent):
    if lines[pos][1].startswith("- ") or lines[pos][1] == "-":
        return _parse_seq(lines, pos, indent)
    return _parse_map(lines, pos, indent)


def _parse_map(lines, pos, indent):
    out = {}
    while pos < len(lines) and lines[pos][0] == indent:
        kv = _split_key(lines[pos][1])
        if kv is None:
            raise ValueError(f"expected 'key: value', got {lines[pos][1]!r}")
        key, rest = kv
        pos += 1
        if rest:
            out[key] = parse_value(rest)
        elif pos < len(lines) and (
            lines[pos][0] > indent
            or (lines[pos][0] == indent and lines[pos][1].startswith("-"))
        ):
            out[key], pos = _parse_block(lines, pos, lines[pos][0])
        else:
            out[key] = None
    return out, pos


def _parse_seq(lines, pos, indent):
    out = []
    while pos < len(lines) and lines[pos][0] == indent and lines[pos][1].startswith("-"):
        item = lines[pos][1][1:].strip()
        pos += 1
        if not item:
            value, pos = _parse_block(lines, pos, lines[pos][0])
            out.append(value)
            continue
        kv = _split_key(item) if not item.startswith(("{", "[", "'", '"')) else None
        if kv is None:
            out.append(parse_value(item))
            continue
        # "- key: value" opens a mapping whose further keys sit two
        # columns in
        key, rest = kv
        entry = {key: parse_value(rest) if rest else None}
        if pos < len(lines) and lines[pos][0] > indent:
            more, pos = _parse_map(lines, pos, lines[pos][0])
            entry.update(more)
        out.append(entry)
    return out, pos


def load_yaml(path: str) -> dict:
    with open(path, "r") as f:
        return load_yaml_text(f.read()) or {}


def _yaml_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, float) and not math.isfinite(value):
        return ".nan" if value != value else (".inf" if value > 0 else "-.inf")
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_yaml_scalar(v) for v in value) + "]"
    if isinstance(value, dict):
        return "{" + ", ".join(f"{k}: {_yaml_scalar(v)}" for k, v in value.items()) + "}"
    return "'" + str(value).replace("'", "''") + "'"


def dump_yaml(tree: dict, indent: int = 0) -> str:
    """A config tree as block YAML that :func:`load_yaml_text` reads back
    to the same tree: nested dicts as block mappings, lists as flow
    sequences, strings single-quoted."""
    lines = []
    for key, value in tree.items():
        pad = " " * indent
        if isinstance(value, dict) and value:
            lines.append(f"{pad}{key}:")
            lines.append(dump_yaml(value, indent + 2).rstrip("\n"))
        else:
            lines.append(f"{pad}{key}: {_yaml_scalar(value)}")
    return "\n".join(lines) + "\n"


class ConfigNode(dict):
    """A dict with attribute access, YAML-typed values, and deep merge."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return ConfigNode({k: ConfigNode.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ConfigNode.wrap(v) for v in obj]
        if isinstance(obj, str) and _FLOAT_RE.match(obj):
            return float(obj)
        return obj

    def to_container(self) -> dict:
        def unwrap(obj: Any) -> Any:
            if isinstance(obj, dict):
                return {k: unwrap(v) for k, v in obj.items()}
            if isinstance(obj, list):
                return [unwrap(v) for v in obj]
            return obj

        return unwrap(self)

    def merge(self, other: dict) -> None:
        """Deep-merge ``other`` into self (other wins)."""
        for key, value in other.items():
            if key in self and isinstance(self[key], dict) and isinstance(value, dict):
                node = self[key]
                if not isinstance(node, ConfigNode):
                    node = ConfigNode.wrap(node)
                    self[key] = node
                node.merge(value)
            else:
                self[key] = ConfigNode.wrap(value)

    def select(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_dotted(self, dotted: str, value: Any, allow_new: bool = True) -> None:
        parts = dotted.split(".")
        node: Any = self
        for part in parts[:-1]:
            if part in node and not isinstance(node[part], dict):
                if not allow_new:
                    raise KeyError(
                        f"Could not override '{dotted}': '{part}' holds the "
                        f"non-dict value {node[part]!r}. Prefix with '+' to "
                        f"replace it with a subtree."
                    )
                node[part] = ConfigNode()
            elif part not in node:
                if not allow_new:
                    raise KeyError(
                        f"Could not override '{dotted}': no key '{part}'. "
                        f"Prefix with '+' to add a new key."
                    )
                node[part] = ConfigNode()
            node = node[part]
        if parts[-1] not in node and not allow_new:
            raise KeyError(
                f"Could not override '{dotted}': no key '{parts[-1]}'. "
                f"Prefix with '+' to add a new key."
            )
        node[parts[-1]] = ConfigNode.wrap(value)


def compose_config(
    config_dir: str,
    overrides: Iterable[str] = (),
    config_name: str = "config",
) -> ConfigNode:
    """Compose the run config the way ``@hydra.main`` would (see
    ``acco_tpu.configuration.compose_config``)."""
    root = load_yaml(os.path.join(config_dir, config_name + ".yaml"))
    defaults = root.pop("defaults", [])
    root.pop("hydra", None)

    selections: dict[str, str] = {}
    order: list[str] = []
    for entry in defaults:
        if isinstance(entry, dict):
            for group, option in entry.items():
                selections[str(group)] = str(option)
                order.append(str(group))
        elif isinstance(entry, str) and entry != "_self_":
            selections[entry] = entry
            order.append(entry)

    value_overrides: list[tuple[str, Any, bool]] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override '{ov}' is not of the form key=value")
        key, _, raw = ov.partition("=")
        additive = key.startswith("+")
        key = key.lstrip("+")
        if key in selections and "." not in key:
            if additive:
                raise ValueError(
                    f"'+{key}={raw}': group '{key}' is already selected by the "
                    f"defaults list; use '{key}={raw}' to re-select it."
                )
            selections[key] = raw
        else:
            value_overrides.append((key, parse_value(raw), additive))

    cfg = ConfigNode()
    for group in order:
        option = selections[group]
        group_path = os.path.join(config_dir, group, option + ".yaml")
        if not os.path.exists(group_path):
            available = sorted(
                f[:-5]
                for f in os.listdir(os.path.join(config_dir, group))
                if f.endswith(".yaml")
            )
            raise FileNotFoundError(
                f"Config group '{group}' has no option '{option}'. "
                f"Available: {available}"
            )
        cfg[group] = ConfigNode.wrap(load_yaml(group_path))
    cfg.merge(root)

    for key, value, additive in value_overrides:
        cfg.set_dotted(key, value, allow_new=additive or cfg.select(key) is not None)
    return cfg


def check_supported(train_cfg: dict) -> None:
    """Raise, before any data is read, for train keys the port cannot run
    as given: a misspelt ``remat`` mode, a mesh with an unknown axis or a
    size below 1 (``fused_loss`` is resolved against the model:
    ops.losses.resolve_fused_loss), and a malformed ``fault_injection``
    spec."""
    from acco_tpu_torch.ops.attention import normalize_remat
    from acco_tpu_torch.resilience.faults import parse_fault_specs

    parse_fault_specs(train_cfg.get("fault_injection"))
    normalize_remat(train_cfg.get("remat", False))  # a misspelt mode raises here
    from acco_tpu_torch.parallel.mesh import check_mesh

    check_mesh(train_cfg.get("mesh_shape"))
