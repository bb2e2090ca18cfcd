"""Configuration layer: .properties and HOCON-subset readers with typed getters.

The reference has a two-tier config system (SURVEY.md §5):
  (a) Hadoop jobs: flat ``.properties`` passed via ``-Dconf.path=``, loaded by
      chombo ``Utility.setConfiguration`` (bayesian/BayesianDistribution.java:67),
      keys namespaced by per-job prefixes (``dtb.*``, ``bap.*``, ``nen.*`` ...)
      plus globals ``field.delim.regex``, ``num.reducer``, ``debug.on``.
  (b) Spark jobs: Typesafe-config HOCON with a top-level app block
      (spark/.../SimulatedAnnealing.scala:56-59, resource/opt.conf).

This module reads both formats into one ``Config`` object so that existing
reference config files drive the new framework without modification.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence


class ConfigError(KeyError):
    pass


class Config:
    """Flat key->string map with typed getters and mandatory-param assertions
    (the surface of chombo's Utility.get*ConfigParam / assert*ConfigParam)."""

    def __init__(self, data: Optional[Dict[str, str]] = None):
        self._data: Dict[str, str] = dict(data or {})

    # ---- raw access ----
    def __contains__(self, key: str) -> bool:
        return key in self._data and self._data[key] != ""

    def raw(self) -> Dict[str, str]:
        return dict(self._data)

    def set(self, key: str, value: Any) -> None:
        self._data[key] = str(value)

    def update(self, other: Dict[str, str]) -> None:
        self._data.update(other)

    # ---- typed getters with defaults ----
    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        v = self._data.get(key)
        if v is None or v == "":
            return default
        return v

    def get_int(self, key: str, default: Optional[int] = None) -> Optional[int]:
        v = self.get(key)
        return int(v) if v is not None else default

    def get_float(self, key: str, default: Optional[float] = None) -> Optional[float]:
        v = self.get(key)
        return float(v) if v is not None else default

    def get_boolean(self, key: str, default: bool = False) -> bool:
        v = self.get(key)
        return v.strip().lower() == "true" if v is not None else default

    def get_list(self, key: str, default: Optional[Sequence[str]] = None,
                 delim: str = ",") -> Optional[List[str]]:
        v = self.get(key)
        if v is None:
            return list(default) if default is not None else None
        return [t.strip() for t in v.split(delim)]

    def get_int_list(self, key: str, default: Optional[Sequence[int]] = None,
                     delim: str = ",") -> Optional[List[int]]:
        v = self.get_list(key, None, delim)
        if v is None:
            return list(default) if default is not None else None
        return [int(t) for t in v]

    def get_float_list(self, key: str, default: Optional[Sequence[float]] = None,
                       delim: str = ",") -> Optional[List[float]]:
        v = self.get_list(key, None, delim)
        if v is None:
            return list(default) if default is not None else None
        return [float(t) for t in v]

    # ---- mandatory getters (assertXConfigParam equivalents) ----
    def _must(self, key: str, msg: Optional[str]) -> str:
        v = self.get(key)
        if v is None:
            raise ConfigError(msg or f"missing mandatory configuration parameter {key!r}")
        return v

    def must_get(self, key: str, msg: Optional[str] = None) -> str:
        return self._must(key, msg)

    def must_get_int(self, key: str, msg: Optional[str] = None) -> int:
        return int(self._must(key, msg))

    def must_get_float(self, key: str, msg: Optional[str] = None) -> float:
        return float(self._must(key, msg))

    def must_get_list(self, key: str, msg: Optional[str] = None,
                      delim: str = ",") -> List[str]:
        return [t.strip() for t in self._must(key, msg).split(delim)]

    # ---- namespacing ----
    def scoped(self, prefix: str) -> "ScopedConfig":
        return ScopedConfig(self, prefix)

    # ---- common globals of the reference ----
    @property
    def field_delim_regex(self) -> str:
        return self.get("field.delim.regex", ",")

    @property
    def field_delim_out(self) -> str:
        return self.get("field.delim.out", self.get("field.delim", ","))

    @property
    def debug_on(self) -> bool:
        return self.get_boolean("debug.on", False)


class ScopedConfig(Config):
    """View of a Config under a job prefix: ``get('max.depth')`` looks up
    ``<prefix>.max.depth`` first, then the bare key (so globals like
    ``field.delim.regex`` resolve through the same object)."""

    def __init__(self, base: Config, prefix: str):
        super().__init__()
        self._base = base
        self._prefix = prefix.rstrip(".")

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        v = self._base.get(f"{self._prefix}.{key}")
        if v is not None:
            return v
        return self._base.get(key, default)

    def set(self, key: str, value: Any) -> None:
        self._base.set(f"{self._prefix}.{key}", value)

    def update(self, other: Dict[str, str]) -> None:
        for k, v in other.items():
            self.set(k, v)

    def raw(self) -> Dict[str, str]:
        prefix = self._prefix + "."
        return {k[len(prefix):]: v for k, v in self._base.raw().items()
                if k.startswith(prefix)}

    def __contains__(self, key: str) -> bool:
        return f"{self._prefix}.{key}" in self._base or key in self._base


# --------------------------------------------------------------------------
# .properties parsing
# --------------------------------------------------------------------------

def parse_properties(text: str) -> Dict[str, str]:
    """java.util.Properties-flavoured parsing: ``key=value`` lines, ``#``/``!``
    comments, later keys override earlier ones, values may be empty."""
    out: Dict[str, str] = {}
    for rawline in text.splitlines():
        line = rawline.strip()
        if not line or line.startswith("#") or line.startswith("!"):
            continue
        if "=" in line:
            key, _, value = line.partition("=")
        elif ":" in line:
            key, _, value = line.partition(":")
        else:
            key, value = line, ""
        out[key.strip()] = value.strip()
    return out


def load_properties(path: str) -> Config:
    with open(path, "r") as fh:
        return Config(parse_properties(fh.read()))


# --------------------------------------------------------------------------
# HOCON-subset parsing (enough for the reference's .conf files: one level of
# named blocks with key = value pairs; nested blocks flatten with dots)
# --------------------------------------------------------------------------

_HOCON_KV = re.compile(r"^\s*([^=:{}\s][^=:{}]*?)\s*[=:]\s*(.*?)\s*,?\s*$")


def parse_hocon(text: str) -> Dict[str, str]:
    """Parse the HOCON subset used by resource/*.conf: named blocks containing
    ``key = value`` lines.  Returns flat keys ``block.key``; list values are
    rendered as comma-joined strings; quoted strings are unquoted."""
    out: Dict[str, str] = {}
    stack: List[str] = []
    for rawline in text.splitlines():
        # strip '//' comments only at start of line or after whitespace, so
        # values like "file:///path" (resource/atmTrans.conf) survive
        line = re.split(r"(?:^|\s)//", rawline, maxsplit=1)[0].strip()
        if not line or line.startswith("#"):
            continue
        # block open:  name {          (possibly 'name { key = v }' is not supported)
        m = re.match(r"^([^={}\s][^={}]*?)\s*\{\s*$", line)
        if m:
            stack.append(m.group(1).strip())
            continue
        if line == "}":
            if stack:
                stack.pop()
            continue
        m = _HOCON_KV.match(line)
        if m:
            key, val = m.group(1).strip(), m.group(2).strip()
            if val.startswith("[") and val.endswith("]"):
                items = [v.strip().strip('"') for v in val[1:-1].split(",") if v.strip()]
                val = ",".join(items)
            elif len(val) >= 2 and val[0] == '"' and val[-1] == '"':
                val = val[1:-1]
            full = ".".join(stack + [key]) if stack else key
            out[full] = val
    return out


def load_hocon(path: str, app: Optional[str] = None) -> Config:
    """Load a HOCON .conf file.  If ``app`` is given, keys under that block are
    exposed without the block prefix (mirrors JobConfiguration's
    ``config.getConfig(appName)`` in the Spark jobs)."""
    with open(path, "r") as fh:
        flat = parse_hocon(fh.read())
    if app is not None:
        prefix = app + "."
        flat = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    return Config(flat)


def load_config(path: str, app: Optional[str] = None) -> Config:
    """Dispatch on extension: .properties / .props -> properties, .conf -> HOCON."""
    if path.endswith(".conf"):
        return load_hocon(path, app)
    return load_properties(path)
