"""A cell's ``request`` settings, with each pool entry's own fields, as the
port's ``SearchRequest`` objects.

Every key is a ``SearchRequest`` field by its name, converted by the field's
type: an enum (``ResultType``, ``QueryType``, ``SearchMode``) from the
member's name, a request dataclass (``QueryFacet``, ``FacetFilter``,
``ResultSort``, ``Highlight``, ``Ranges``) from a dict of its own fields, a
list of them from a list of dicts, a tuple from a list.  A key that names no
field raises and names it, at any depth.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import types
import typing


def search_requests(st, cell: dict, base: list[dict]) -> list:
    """One SearchRequest a pool entry: the cell's ``request`` settings, then
    the entry's own fields (``query``, ``query_vector``, ...)."""
    return [build(st.SearchRequest, {**cell["request"], **b}) for b in base]


def build(cls, values: dict, where: str = ""):
    """An instance of the dataclass `cls` from `values`, keyed by field."""
    where = where or cls.__name__
    if not isinstance(values, dict):
        raise TypeError(f"{where}: a dict of {cls.__name__} fields, not "
                        f"{values!r}")
    hints, names = _fields(cls)
    for key in values:
        if key not in names:
            raise ValueError(f"{where}: {cls.__name__} has no field {key!r}")
    return cls(**{key: convert(v, hints[key], f"{where}.{key}")
                  for key, v in values.items()})


@functools.lru_cache(maxsize=None)
def _fields(cls):
    """(type hints, field names) of a dataclass: worked out once a class,
    not once a request (4,096 a pool)."""
    return (typing.get_type_hints(cls),
            frozenset(f.name for f in dataclasses.fields(cls)))


def convert(value, hint, where: str):
    """`value`, as JSON gives it, as the type `hint` asks for."""
    origin, args = typing.get_origin(hint), typing.get_args(hint)
    if origin in (typing.Union, types.UnionType):     # X | None
        if value is None:
            return None
        (hint,) = (a for a in args if a is not type(None))
        return convert(value, hint, where)
    if isinstance(hint, type) and issubclass(hint, enum.Enum):
        if value not in hint.__members__:
            raise ValueError(f"{where}: {hint.__name__} has no member "
                             f"{value!r}")
        return hint[value]
    if dataclasses.is_dataclass(hint):
        return build(hint, value, where)
    if origin is list:
        return [convert(v, args[0], f"{where}[{i}]")
                for i, v in enumerate(_sequence(value, where))]
    if hint is tuple or origin is tuple:
        return tuple(_sequence(value, where))
    if hint is bool:
        if not isinstance(value, bool):
            raise TypeError(f"{where}: true or false, not {value!r}")
        return value
    if hint is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise TypeError(f"{where}: a whole number, not {value!r}")
        return value
    if hint is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise TypeError(f"{where}: a number, not {value!r}")
        return float(value)
    if hint is str and not isinstance(value, str):
        raise TypeError(f"{where}: a string, not {value!r}")
    return value


def _sequence(value, where: str):
    if not isinstance(value, (list, tuple)):
        raise TypeError(f"{where}: a list, not {value!r}")
    return value
