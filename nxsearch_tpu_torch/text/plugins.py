"""User-defined filter plugins (Python code).

The reference supports Lua-scripted filters: a source blob returning a
table of ``create/destroy/filter/cleanup`` handlers, with ``filter``
mandatory (src/core/filters_lua.c:74-264, docs/lua-filters-api.md).
The idiomatic equivalent here is a Python source blob defining the same
handlers as module-level functions:

    def create(json_params):   # optional
        import json
        return json.loads(json_params)

    def filter(ctx, value):    # mandatory
        return value.lower()   # return None to discard; raise on error

    def destroy(ctx): ...      # optional
    def cleanup(): ...         # optional

Filters are auto-loaded from ``$NXS_BASEDIR/filters/*.py`` (the
reference auto-loads ``*.lua`` from the same place) and can be posted
through the REST service when NXS_ENABLE_PY_POST is set (the analogue
of NXS_ENABLE_LUA_POST).

NOTE: like the reference's Lua feature, loading plugin code executes
arbitrary trusted code; the service gates it behind an env flag.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Optional

from ..errors import ErrorCode, NxsError
from ..params import Params
from .filters import FilterOps, FilterRegistry


def _compile_handlers(name: str, source: str) -> dict:
    namespace: dict[str, Any] = {"__name__": f"nxs_filter_{name}"}
    try:
        exec(compile(source, f"<filter:{name}>", "exec"), namespace)
    except Exception as e:
        raise NxsError(ErrorCode.INVALID,
                       f"failed to load filter `{name}': {e}")
    if not callable(namespace.get("filter")):
        raise NxsError(ErrorCode.INVALID,
                       f"filter `{name}' does not define filter()")
    return namespace


def load_filter(registry: FilterRegistry, name: str, source: str) -> None:
    """nxs_luafilter_load equivalent: compile + register the plugin."""
    ns = _compile_handlers(name, source)
    user_filter = ns["filter"]
    user_create = ns.get("create")
    user_destroy = ns.get("destroy")

    def _create(params: Params, _sysctx: Any) -> Any:
        if callable(user_create):
            # The reference passes params as a JSON string
            # (filters_lua.c: params serialized to JSON for create()).
            return user_create(params.tojson())
        return None

    def _destroy(ctx: Any) -> None:
        if callable(user_destroy):
            user_destroy(ctx)

    def _filter(ctx: Any, value: str) -> Optional[str]:
        result = user_filter(ctx, value)
        if result is None:
            return None
        if not isinstance(result, str):
            raise NxsError(ErrorCode.FATAL,
                           f"filter `{name}' returned a non-string")
        return result

    registry.register(name, FilterOps(
        filter=_filter, create=_create, destroy=_destroy,
        sysfini=(lambda _ctx: ns["cleanup"]()) if callable(ns.get("cleanup"))
        else None,
    ))


def autoload_filters(registry: FilterRegistry, basedir: str) -> list[str]:
    """Load every ``filters/*.py`` plugin from the basedir.

    Mirrors the service loading all ``$NXS_BASEDIR/filters/*.lua`` at
    worker init (svc-src/nxsearch_svc.lua:24-34).
    """
    loaded = []
    for path in sorted(glob.glob(os.path.join(basedir, "filters", "*.py"))):
        name = os.path.splitext(os.path.basename(path))[0]
        with open(path, "r", encoding="utf-8") as f:
            load_filter(registry, name, f.read())
        loaded.append(name)
    return loaded


def store_filter(basedir: str, name: str, source: str) -> str:
    """Persist a posted filter (the service's ?store flag)."""
    path = os.path.join(basedir, "filters")
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, f"{name}.py")
    with open(target, "w", encoding="utf-8") as f:
        f.write(source)
    return target
