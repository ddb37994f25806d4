"""Dataclass-based config with CLI override: the port of
``harp_tpu.utils.config`` (pure Python, copied).

Each app has one config dataclass; :func:`parse_into` turns any dataclass
into an argparse CLI (field name → ``--flag``, type-checked, defaults
shown), so every launcher is two lines and knobs are discoverable with
``--help``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Type, TypeVar

T = TypeVar("T")


def parse_into(cfg_cls: Type[T], argv=None, description: str | None = None,
               **overrides: Any) -> T:
    """Build ``cfg_cls`` from CLI args (``--field-name value``)."""
    if not dataclasses.is_dataclass(cfg_cls):
        raise TypeError(f"parse_into needs a dataclass, not {cfg_cls!r}")
    p = argparse.ArgumentParser(description=description or cfg_cls.__name__)
    for f in dataclasses.fields(cfg_cls):
        if not f.init:
            continue
        flag = "--" + f.name.replace("_", "-")
        default = f.default
        if (default is dataclasses.MISSING
                and f.default_factory is not dataclasses.MISSING):
            default = f.default_factory()
        default = overrides.get(f.name, default)
        if f.type in (bool, "bool") or isinstance(default, bool):
            p.add_argument(flag, action=argparse.BooleanOptionalAction,
                           default=default)
        elif isinstance(default, (int, float, str)):
            p.add_argument(flag, type=type(default), default=default)
        elif isinstance(default, (tuple, list)) and default:
            elem_t = type(default[0])
            ctor = type(default)

            def conv(s, _t=elem_t, _c=ctor):
                return _c(_t(tok) for tok in str(s).replace(",", " ").split())

            p.add_argument(flag, type=conv, default=default,
                           help=f"comma/space-separated {elem_t.__name__}s")
        else:
            p.add_argument(flag, default=default)
    ns = p.parse_args(argv)
    kwargs = {f.name: getattr(ns, f.name) for f in dataclasses.fields(cfg_cls)
              if f.init and hasattr(ns, f.name)}
    return cfg_cls(**kwargs)
