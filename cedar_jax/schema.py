"""Config schema validation.

The analogue of the reference's JSON-schema + validator pair
(reference: src/config/schema.json, src/config/validate.py).  The reference
validates offline with jsonschema; here validation runs at solver
construction so a typo'd key or invalid enum fails fast instead of silently
becoming a default (the reference's schema is also advisory-only and
syntactically incomplete — this validator is strictly tighter).

Rules:

* every key under a known namespace must be a known key (catches typos like
  ``nrelax_pre`` for ``nrelax-pre``);
* enum-valued keys must hold a valid member;
* scalar keys must hold the right JSON type;
* ``cg-config`` / ``plane-config`` are validated recursively.

Unknown TOP-level keys are rejected too, except keys explicitly reserved for
applications (the reference tolerates arbitrary top-level keys; we reserve
an ``app`` namespace for that instead).
"""

from __future__ import annotations

from typing import Any

# sentinel types
_BOOL = "bool"
_INT = "int"
_NUM = "num"
_STR = "str"
_LIST = "list"
_CONF = "conf"      # nested config, validated recursively


class ConfigError(ValueError):
    """Raised when a configuration fails schema validation."""


_RELAX = {"point", "line-x", "line-y", "line-xy",
          "plane-xy", "plane-xz", "plane-yz", "plane-xyz"}
_CYCLES = {"v", "f"}
_CG = {"LU", "cedar", "redist"}
_STRATS = {"manual", "coarsen", "astar"}
_BACKENDS = {"auto", "xla", "pallas"}
_LOGS = {"status", "info", "error", "memory", "debug", "timer"}
# reference also names these; accepted as no-ops for file compatibility
_HALO = {"msg", "tausch"}

#: path -> type or (type, allowed-values)
SCHEMA: dict[str, Any] = {
    "log": (_LIST, _LOGS),
    "log-planes": _BOOL,
    "halo-exchange": (_STR, _HALO),     # accepted for compatibility (no-op)
    "cg-config": _CONF,
    "plane-config": _CONF,
    "kernels.backend": (_STR, _BACKENDS),
    "solver.relaxation": (_STR, _RELAX),
    "solver.cycle.type": (_STR, _CYCLES),
    "solver.cycle.nrelax-pre": _INT,
    "solver.cycle.nrelax-post": _INT,
    "solver.tol": _NUM,
    "solver.max-iter": _INT,
    "solver.min-coarse": _INT,
    "solver.min_coarse": _INT,          # reference quirk: underscore accepted
    "solver.num-levels": _INT,
    "solver.cg-solver": (_STR, _CG),
    "solver.definite": _BOOL,
    "solver.relax-symmetric": _BOOL,
    "solver.ml-relax.enabled": _BOOL,
    "solver.ml-relax.min-gsz": _INT,
    "solver.ml-relax.factorize": _BOOL,
    "redist.search.strategy": (_STR, _STRATS),
    "redist.search.path": _LIST,
    "redist.min-local": _INT,
    "machine.bandwidth": _NUM,
    "machine.latency": _NUM,
    "machine.fp_perf": _NUM,
    "machine.hbm-bandwidth": _NUM,
    "machine.overhead": _NUM,
    "grid.periodic": _LIST,
    "grid.local": _BOOL,
    "grid.n": _LIST,
    "grid.np": _LIST,
    # application-reserved namespace: never validated
    "app": _CONF,
}


def _check_type(path: str, val: Any, spec: Any) -> None:
    allowed = None
    if isinstance(spec, tuple):
        spec, allowed = spec
    ok = {
        _BOOL: lambda v: isinstance(v, bool),
        _INT: lambda v: isinstance(v, int) and not isinstance(v, bool),
        _NUM: lambda v: isinstance(v, (int, float))
        and not isinstance(v, bool),
        _STR: lambda v: isinstance(v, str),
        _LIST: lambda v: isinstance(v, list),
        _CONF: lambda v: isinstance(v, dict),
    }[spec]
    if not ok(val):
        raise ConfigError(f"config key '{path}' has invalid type "
                          f"{type(val).__name__} (expected {spec})")
    if allowed is not None:
        vals = val if spec == _LIST else [val]
        for v in vals:
            if v not in allowed:
                raise ConfigError(
                    f"config key '{path}' has invalid value {v!r} "
                    f"(allowed: {sorted(allowed)})"
                )


def _walk(node: dict, prefix: str, errors: list[str]) -> None:
    for key, val in node.items():
        path = f"{prefix}.{key}" if prefix else key
        if path in SCHEMA:
            spec = SCHEMA[path]
            base = spec[0] if isinstance(spec, tuple) else spec
            if base == _CONF and path in ("cg-config", "plane-config"):
                # nested solver configs validate against the full schema
                _check_type(path, val, spec)
                _walk(val, "", errors)
            elif base == _CONF:
                _check_type(path, val, spec)
            else:
                try:
                    _check_type(path, val, spec)
                except ConfigError as e:
                    errors.append(str(e))
        elif isinstance(val, dict) and any(
            k.startswith(path + ".") for k in SCHEMA
        ):
            _walk(val, path, errors)
        else:
            known = sorted(
                k for k in SCHEMA
                if k.rsplit(".", 1)[0] == (prefix or k.rsplit(".", 1)[0])
                and (not prefix or k.startswith(prefix + "."))
            )
            hint = f" (known: {known})" if prefix else ""
            errors.append(f"unknown config key '{path}'{hint}")


def validate(conf) -> None:
    """Validate a Config/dict against the schema; raise ConfigError.

    Collects ALL violations before raising so a bad config reports every
    problem at once.
    """
    root = conf.to_dict() if hasattr(conf, "to_dict") else dict(conf)
    errors: list[str] = []
    _walk(root, "", errors)
    if errors:
        raise ConfigError("invalid configuration:\n  " + "\n  ".join(errors))
