"""Record-field stringification and numeric parsing, without pandas.

The port's copy of ``shifu_tpu.data.reader.record_field_str`` and
``parse_numeric``.  The reference parses with
``pd.to_numeric(pd.Series(values, dtype=str).str.strip(), errors="coerce")``,
whose grammar is NOT Python's ``float()``: pandas' C tokenizer
(``precise_xstrtod``) accepts ASCII digits only (``"1_000"``, ``"0x10"``,
``"１２"`` are invalid), reads at most 17 significant digits and scales by
a power-of-ten table (so long mantissas round differently from
``float()``), stops at an embedded NUL, accepts ``inf``/``infinity`` in any
case with an optional sign, and never parses ``nan``.  A batch whose every
entry is a plain integer string is converted through Python ``int`` instead
(pandas' integer path), so ``"-0"`` or a 19-digit id parse differently in
an all-integer batch than beside a float or a missing value.
:func:`parse_numeric` reproduces all of that, value for value, so a record
bins identically in both packages.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

_ASCII_SPACE = b" \t\n\v\f\r"
_MAX_DIGITS = 17                       # precise_xstrtod's mantissa window
_POW10 = [float(f"1e{i}") for i in range(309)]
_INF_WORDS = {b"inf": 1.0, b"+inf": 1.0, b"-inf": -1.0, b"infinity": 1.0,
              b"+infinity": 1.0, b"-infinity": -1.0}
_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1
_UINT64_MAX = (1 << 64) - 1


def record_field_str(v) -> str:
    """A JSON field value as the string cell the offline CSV reader would
    have produced (``None`` -> ``""``, ``True`` -> ``"True"``, numbers by
    ``repr``) — the serving path stringifies through HERE, then parses
    through :func:`parse_numeric` / ``ColumnBinner``."""
    if v is None:
        return ""
    if isinstance(v, bool):
        return str(v)
    return v if isinstance(v, str) else repr(v)


def _xstrtod(b: bytes) -> Tuple[float, bool, bool]:
    """pandas' ``precise_xstrtod`` over NUL-terminated UTF-8 bytes:
    ``(value, parsed, looks_like_int)``."""
    n, p = len(b), 0
    while p < n and b[p] in _ASCII_SPACE:
        p += 1
    negative = p < n and b[p] == 0x2D
    if p < n and b[p] in b"+-":
        p += 1
    number, exponent, num_digits, maybe_int = 0.0, 0, 0, True
    while p < n and 0x30 <= b[p] <= 0x39:
        if num_digits < _MAX_DIGITS:
            number = number * 10.0 + (b[p] - 0x30)
            num_digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and b[p] == 0x2E:
        maybe_int = False
        p += 1
        num_decimals = 0
        while num_digits < _MAX_DIGITS and p < n and 0x30 <= b[p] <= 0x39:
            number = number * 10.0 + (b[p] - 0x30)
            p += 1
            num_digits += 1
            num_decimals += 1
        while p < n and 0x30 <= b[p] <= 0x39:      # beyond the window
            p += 1
        exponent -= num_decimals
    if num_digits == 0:
        return 0.0, False, False
    if negative:
        number = -number
    if p < n and b[p] in b"eE":
        # the exponent is read like C ``strtol``: leading whitespace,
        # a sign, then every digit (no 17-digit cut)
        maybe_int = False
        q = p + 1
        while q < n and b[q] in _ASCII_SPACE:
            q += 1
        exp_negative = q < n and b[q] == 0x2D
        if q < n and b[q] in b"+-":
            q += 1
        e, e_digits = 0, 0
        while q < n and 0x30 <= b[q] <= 0x39:
            e = e * 10 + (b[q] - 0x30)
            e_digits += 1
            q += 1
        if e_digits:                   # a bare 'e' stays unconsumed
            exponent += -e if exp_negative else e
            p = q
    if exponent > 308:
        number = 0.0 if number == 0.0 else (
            float("-inf") if number < 0 else float("inf"))
    elif exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -308:
        if exponent < -616:
            number = 0.0
        else:
            number /= _POW10[-308 - exponent]
            number /= _POW10[308]
    else:
        number /= _POW10[-exponent]
    while p < n and b[p] in _ASCII_SPACE:
        p += 1
    return number, p == n, maybe_int


def _floatify(s: str) -> Tuple[float, bool, bool]:
    """pandas' ``floatify``: the tokenizer, then the inf spellings
    (ASCII case-insensitive, as ``strcasecmp``)."""
    try:
        b = s.encode("utf-8")
    except UnicodeEncodeError:              # lone surrogate: unparseable
        return float("nan"), False, False
    cut = b.find(b"\0")
    if cut >= 0:
        b = b[:cut]
    v, ok, maybe_int = _xstrtod(b)
    if ok:
        return v, True, maybe_int
    sign = _INF_WORDS.get(b.lower())
    if sign is not None:
        return sign * float("inf"), True, False
    return float("nan"), False, False


def parse_numeric(values: Sequence, missing_values: Sequence[str] = ()
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized string->float parse: ``(floats, valid_mask)`` where
    invalid/missing entries are NaN and masked out — value for value the
    reference's pandas coercion (see the module docs)."""
    strs: List[str] = [str(v).strip() for v in values]
    floats = np.empty(len(strs), np.float64)
    ints: List[int] = []
    all_int = True                # pandas returns its int array only when
    saw_neg = saw_big = False     # every entry took the integer path
    for i, s in enumerate(strs):
        v, ok, maybe_int = _floatify(s)
        floats[i] = v if ok else np.nan
        if not ok:
            all_int = False
            continue
        if not maybe_int:
            all_int = False
            continue
        try:
            iv = int(s)
        except ValueError:           # e.g. digits, then a NUL, then more
            floats[i] = np.nan
            all_int = False
            continue
        if iv < _INT64_MIN or iv > _UINT64_MAX:
            all_int = False
        saw_neg |= iv < 0
        saw_big |= iv > _INT64_MAX
        ints.append(iv)
    if all_int and strs and not (saw_neg and saw_big):
        floats = np.asarray([float(iv) for iv in ints], np.float64)
    valid = ~np.isnan(floats)
    if len(missing_values):
        missing_set = {m.strip().lower() for m in missing_values}
        is_missing = np.fromiter((s.lower() in missing_set for s in strs),
                                 bool, len(strs))
        valid &= ~is_missing
        floats = np.where(is_missing, np.nan, floats)
    return floats, valid
