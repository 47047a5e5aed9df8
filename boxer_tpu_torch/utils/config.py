"""Hierarchical YAML configuration system; port of
`boxer_tpu/utils/config.py`.

Re-creates the reference's OmegaConf-based surface (reference
`e2edet/utils/configuration.py:21-248`) without the OmegaConf dependency:

- recursive ``includes:`` composition (reference `configuration.py:21-55`)
- default.yaml <- user yaml <- CLI dotlist override merge order
- dotlist overrides ``a.b=value`` / ``a.b[0]=value`` with literal_eval typing
  (reference `configuration.py:99-179`)
- ``${a.b.c}`` interpolation and the ``${device_count:}`` resolver
  (reference `configuration.py:93-97`): the visible CUDA cards on
  ``cuda``, 1 on ``cpu``
- struct freeze after trainer build (reference `configuration.py:181-185`)
"""

from __future__ import annotations

import ast
import copy
import os
import re
from typing import Any, Dict, List, Optional

import yaml

_INTERP_RE = re.compile(r"\$\{([^}]*)\}")


class Config:
    """Nested attribute/items access over a plain dict tree, with freeze."""

    __slots__ = ("_data", "_frozen")

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", dict(data or {}))
        object.__setattr__(self, "_frozen", False)

    # -- dict-like --------------------------------------------------------
    def __getitem__(self, key):
        value = self._data[key]
        return Config._wrap(value)

    def __setitem__(self, key, value):
        if self._frozen:
            raise AttributeError(f"Config is frozen; cannot set '{key}'")
        self._data[key] = Config._unwrap(value)

    def __contains__(self, key):
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return ((k, Config._wrap(v)) for k, v in self._data.items())

    def values(self):
        return (Config._wrap(v) for v in self._data.values())

    def get(self, key, default=None):
        if key in self._data:
            return Config._wrap(self._data[key])
        return default

    def setdefault(self, key, default=None):
        if key not in self._data:
            self[key] = default
        return self[key]

    def update(self, other):
        for k, v in dict(other).items():
            self[k] = v

    def pop(self, key, *default):
        if self._frozen:
            raise AttributeError("Config is frozen")
        return self._data.pop(key, *default)

    # -- attribute access --------------------------------------------------
    def __getattr__(self, key):
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(f"Config has no key '{key}'") from e

    def __setattr__(self, key, value):
        self[key] = value

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _wrap(value):
        if isinstance(value, dict):
            cfg = Config.__new__(Config)
            object.__setattr__(cfg, "_data", value)
            object.__setattr__(cfg, "_frozen", False)
            return cfg
        return value

    @staticmethod
    def _unwrap(value):
        if isinstance(value, Config):
            return value._data
        return value

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._data)

    def freeze(self):
        object.__setattr__(self, "_frozen", True)
        return self

    def defrost(self):
        object.__setattr__(self, "_frozen", False)
        return self

    def pretty(self) -> str:
        return yaml.safe_dump(self.to_dict(), default_flow_style=False, sort_keys=False)

    def __repr__(self):
        return f"Config({self._data!r})"


# ---------------------------------------------------------------------------
# YAML loading with recursive includes
# ---------------------------------------------------------------------------

def load_yaml(path: str, _seen: Optional[set] = None) -> Dict[str, Any]:
    """Load a YAML file, recursively merging files listed under ``includes:``.

    Include semantics follow the reference (`configuration.py:21-55`): included
    files are merged first (in order), then the including file's own keys are
    merged on top. Include paths are resolved relative to the including file,
    then relative to the package ``config/`` root.
    """
    path = os.path.abspath(path)
    _seen = _seen or set()
    if path in _seen:
        raise ValueError(f"Circular include detected at {path}")
    _seen = _seen | {path}

    with open(path) as f:
        mapping = yaml.safe_load(f) or {}
    if not isinstance(mapping, dict):
        raise ValueError(f"Top level of {path} must be a mapping")

    includes = mapping.pop("includes", [])
    if isinstance(includes, str):
        includes = [includes]

    base: Dict[str, Any] = {}
    for inc in includes:
        candidates = [
            os.path.join(os.path.dirname(path), inc),
            os.path.join(_config_root(), inc),
            inc,
        ]
        for cand in candidates:
            if os.path.exists(cand):
                inc_mapping = load_yaml(cand, _seen)
                base = merge_dicts(base, inc_mapping)
                break
        else:
            raise FileNotFoundError(f"Included config not found: {inc} (from {path})")

    return merge_dicts(base, mapping)


def _config_root() -> str:
    """The port's own copy of the shipped yaml tree."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "config")


def merge_dicts(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Deep merge: override wins; nested dicts merged recursively."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


# ---------------------------------------------------------------------------
# Dotlist overrides:  a.b=3  a.b[0]=x  a.b.c="[1, 2]"
# ---------------------------------------------------------------------------

_IDX_RE = re.compile(r"^(.*)\[(\d+)\]$")


def _decode_value(raw: str) -> Any:
    raw = raw.strip()
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        lowered = raw.lower()
        if lowered == "true":
            return True
        if lowered == "false":
            return False
        if lowered in ("null", "none", "~"):
            return None
        return raw


def apply_overrides(tree: Dict[str, Any], opts: List[str]) -> Dict[str, Any]:
    """Apply ``key.path=value`` overrides in-place-ish (returns the tree)."""
    if not opts:
        return tree
    # Support both ["a=1", "b=2"] and the argparse leftover style
    # ["a", "1", "b", "2"] that the reference tolerates.
    pairs: List[str] = []
    pending = None
    for tok in opts:
        if "=" in tok:
            if pending is not None:
                raise ValueError(f"Dangling override key '{pending}'")
            pairs.append(tok)
        elif pending is None:
            pending = tok
        else:
            pairs.append(f"{pending}={tok}")
            pending = None
    if pending is not None:
        raise ValueError(f"Dangling override key '{pending}'")

    for pair in pairs:
        key, _, raw = pair.partition("=")
        value = _decode_value(raw)
        node = tree
        parts = key.strip().split(".")
        for i, part in enumerate(parts):
            m = _IDX_RE.match(part)
            name, idx = (m.group(1), int(m.group(2))) if m else (part, None)
            last = i == len(parts) - 1
            if last:
                if idx is None:
                    node[name] = value
                else:
                    node[name][idx] = value
            else:
                if idx is None:
                    node = node.setdefault(name, {})
                else:
                    node = node[name][idx]
    return tree


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------

def device_count(device: str) -> int:
    """The reference's `${device_count:}` (configuration.py:93-97): the
    devices taking part in training, the CUDA cards on `cuda`, 1 on `cpu`."""
    if device == "cpu":
        return 1
    import torch

    return torch.cuda.device_count()


def _resolve_ref(root: Dict[str, Any], expr: str, device: str) -> Any:
    expr = expr.strip()
    if expr == "device_count:":
        return device_count(device)
    node: Any = root
    for part in expr.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            raise KeyError(f"Cannot resolve interpolation '${{{expr}}}'")
    return node


def resolve_interpolations(tree: Dict[str, Any],
                           device: str = "cuda") -> Dict[str, Any]:
    """Resolve ``${a.b.c}`` references against the root of the tree."""

    def resolve(node: Any, depth: int = 0) -> Any:
        if depth > 16:
            raise ValueError("Interpolation recursion limit exceeded")
        if isinstance(node, dict):
            return {k: resolve(v, depth) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve(v, depth) for v in node]
        if isinstance(node, str):
            full = _INTERP_RE.fullmatch(node.strip())
            if full:
                return resolve(_resolve_ref(tree, full.group(1), device),
                               depth + 1)
            # partial interpolation inside a longer string -> stringify
            def sub(m):
                return str(resolve(_resolve_ref(tree, m.group(1), device),
                                   depth + 1))

            return _INTERP_RE.sub(sub, node)
        return node

    return resolve(tree)


# ---------------------------------------------------------------------------
# Configuration: the top-level object the CLI builds
# ---------------------------------------------------------------------------

class Configuration:
    """default.yaml ⊕ user yaml ⊕ CLI dotlist, with interpolation + freeze.

    Mirrors the reference `Configuration` surface (`configuration.py:58-248`).
    `device` ("cuda" or "cpu") is what `${device_count:}` counts.
    """

    def __init__(
        self,
        config_path: Optional[str] = None,
        opts: Optional[List[str]] = None,
        extra: Optional[Dict[str, Any]] = None,
        device: str = "cuda",
    ):
        default_path = os.path.join(_config_root(), "default.yaml")
        tree: Dict[str, Any] = {}
        if os.path.exists(default_path):
            tree = load_yaml(default_path)
        if config_path:
            tree = merge_dicts(tree, load_yaml(config_path))
        if extra:
            tree = merge_dicts(tree, extra)
        tree = apply_overrides(tree, list(opts or []))
        tree = resolve_interpolations(tree, device)
        self._tree = tree
        self.config = Config(tree)

    def get_config(self) -> Config:
        return self.config

    def freeze(self):
        self.config.freeze()

    def defrost(self):
        self.config.defrost()

    def pretty_print(self, writer=None):
        text = self.config.pretty()
        if writer is not None:
            writer.write(text)
        else:
            print(text)
        return text
