"""Minimal JSON<->dataclass mapping with unknown-key tolerance (the port's
copy of ``shifu_tpu.config.jsonbean``).

The reference stores pipeline state in ``ModelConfig.json`` / ``ColumnConfig.json``
(Jackson beans, reference ``container/obj/``).  We keep the exact camelCase key
contract so model sets written by the reference load here unchanged, and vice
versa.  Unknown keys are preserved round-trip in ``extra`` instead of erroring,
mirroring Jackson's permissive deserialization config.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import json
import typing
from typing import Any, Dict, Type, TypeVar, get_args, get_origin, get_type_hints

T = TypeVar("T")


def _unwrap_optional(tp):
    if get_origin(tp) is typing.Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _coerce(tp, value):
    """Coerce a JSON value into the annotated type ``tp``."""
    if value is None:
        return None
    tp = _unwrap_optional(tp)
    origin = get_origin(tp)
    if origin in (list, typing.List):
        (elem,) = get_args(tp) or (Any,)
        scalar = _unwrap_optional(elem)
        if scalar is float:          # the bin lists: one dispatch a list
            return [float(v) if isinstance(v, (int, float)) else v
                    for v in value]
        return [_coerce(elem, v) for v in value]
    if origin in (dict, typing.Dict):
        args = get_args(tp)
        vt = args[1] if len(args) == 2 else Any
        return {k: _coerce(vt, v) for k, v in value.items()}
    if isinstance(tp, type) and dataclasses.is_dataclass(tp):
        return from_dict(tp, value)
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        if isinstance(tp, type) and isinstance(value, tp):
            return value
        return parse_enum(tp, value)
    if tp is float and isinstance(value, (int, float)):
        return float(value)
    if tp is int and isinstance(value, float) and value == int(value):
        return int(value)
    if tp is bool and isinstance(value, str):
        return value.strip().lower() in ("true", "1", "yes")
    return value


def parse_enum(enum_cls, value):
    """Case-insensitive enum parse, accepting both names and values.

    Mirrors the reference's forgiving deserializers (e.g. ``NormTypeDeserializer``)
    which accept ``"zscale"``/``"ZSCALE"`` alike.
    """
    if isinstance(value, enum_cls):
        return value
    s = str(value).strip()
    for member in enum_cls:
        if member.name.lower() == s.lower() or str(member.value).lower() == s.lower():
            return member
    raise ValueError(f"{s!r} is not a valid {enum_cls.__name__} "
                     f"(choices: {[m.name for m in enum_cls]})")


@functools.lru_cache(maxsize=None)
def _class_info(cls):
    """(type hints, field names) of dataclass ``cls``, resolved once."""
    return get_type_hints(cls), frozenset(f.name
                                          for f in dataclasses.fields(cls))


def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    """Build dataclass ``cls`` from a JSON dict; unknown keys land in ``extra``."""
    if data is None:
        return None
    hints, field_names = _class_info(cls)
    kwargs = {}
    extra = {}
    for key, value in data.items():
        if key in field_names and key != "extra":
            kwargs[key] = _coerce(hints[key], value)
        else:
            extra[key] = value
    obj = cls(**kwargs)
    if extra and "extra" in field_names:
        obj.extra = extra
    return obj


def to_dict(obj) -> Any:
    """Dataclass -> JSON-ready dict (camelCase keys preserved, enums -> names)."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            if f.name == "extra":
                continue
            out[f.name] = to_dict(getattr(obj, f.name))
        extra = getattr(obj, "extra", None)
        if extra:
            out.update(extra)
        return out
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, list):
        return [to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if isinstance(obj, float) and obj != obj:  # NaN is not valid JSON
        return None
    return obj


def dumps(obj, **kw) -> str:
    kw.setdefault("indent", 2)
    return json.dumps(to_dict(obj), **kw)


def loads(cls: Type[T], s: str) -> T:
    return from_dict(cls, json.loads(s))
