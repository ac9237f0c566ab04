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


def _identity(value):
    return value


@functools.lru_cache(maxsize=None)
def _coercer(tp):
    """The function that coerces a JSON value into the annotated type
    ``tp`` (None stays None), built once a type: a ColumnConfig.json of a
    few hundred columns holds tens of thousands of values."""
    tp = _unwrap_optional(tp)
    origin = get_origin(tp)
    if origin in (list, typing.List):
        (elem,) = get_args(tp) or (Any,)
        if _unwrap_optional(elem) is float:   # the bin lists
            return lambda value: None if value is None else [
                float(v) if isinstance(v, (int, float)) else v
                for v in value]
        each = _coercer(elem)
        if each is _identity:
            return lambda value: None if value is None else list(value)
        return lambda value: None if value is None else [
            each(v) for v in value]
    if origin in (dict, typing.Dict):
        args = get_args(tp)
        each = _coercer(args[1] if len(args) == 2 else Any)
        return lambda value: None if value is None else {
            k: each(v) for k, v in value.items()}
    if isinstance(tp, type) and dataclasses.is_dataclass(tp):
        return lambda value: None if value is None else from_dict(tp, value)
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return lambda value: None if value is None else parse_enum(tp, value)
    if tp is float:
        return lambda value: float(value) \
            if isinstance(value, (int, float)) else value
    if tp is int:
        return lambda value: int(value) \
            if isinstance(value, float) and value == int(value) else value
    if tp is bool:
        return lambda value: value.strip().lower() in ("true", "1", "yes") \
            if isinstance(value, str) else value
    return _identity


def _coerce(tp, value):
    """Coerce a JSON value into the annotated type ``tp``."""
    return _coercer(tp)(value)


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
    """(a coercer a field, field names) of dataclass ``cls``, resolved
    once."""
    hints = get_type_hints(cls)
    names = frozenset(f.name for f in dataclasses.fields(cls))
    return {n: _coercer(hints[n]) for n in names if n in hints}, names


def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    """Build dataclass ``cls`` from a JSON dict; unknown keys land in ``extra``."""
    if data is None:
        return None
    coercers, field_names = _class_info(cls)
    kwargs = {}
    extra = {}
    for key, value in data.items():
        if key in field_names and key != "extra":
            kwargs[key] = coercers[key](value)
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
