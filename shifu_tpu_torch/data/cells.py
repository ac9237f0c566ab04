"""A column batch of string cells as one fixed-width ``S`` array of the
stripped cells, and its distinct cells — the numpy view that
:func:`~shifu_tpu_torch.data.reader.parse_numeric`, the stats step's
categorical path and the auto-type sketches (:mod:`shifu_tpu_torch.ops.
sketches`) share, so none of them walks the cells one Python object at a
time.

:func:`stripped_cells` converts and strips a batch once, in C.  Only a
batch of ASCII strings without a NUL (``S`` values drop trailing NULs) or
a control character in 0x1c-0x1f (which ``str.strip`` strips and
``bytes.strip`` keeps) has this view: any other batch gets None, and
callers take their per-object path for it.  For ASCII, ``bytes.strip`` and
``bytes.lower`` act as ``str.strip`` and ``str.lower`` do, and byte order
is code-point order, so :func:`distinct` (one ``np.unique`` over the ``S``
values, comparisons in C) gives the distinct cells, first indices and
counts that ``np.unique`` over the Python strings gives.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Set

import numpy as np

#: characters that ``str.strip`` strips and ``bytes.strip`` keeps
_STR_ONLY_SPACE = ("\x1c", "\x1d", "\x1e", "\x1f")


class Distinct(NamedTuple):
    """Each distinct cell once, in sorted order: as Python ``str``
    (``values``) and as ``S`` bytes (``keys``, their lengths
    ``widths``), with the index of its first appearance (``first``), its
    count (``counts``), and each cell's index into them (``inverse``)."""
    values: List[str]
    keys: np.ndarray
    widths: np.ndarray
    first: np.ndarray
    counts: np.ndarray
    inverse: np.ndarray


def stripped_cells(values: Sequence) -> Optional[np.ndarray]:
    """The cells ``str(v).strip()`` of a batch of strings as one ``S``
    array, or None for a batch outside the view (a value that is not a
    ``str``, a NUL, a character outside ASCII or in 0x1c-0x1f)."""
    try:
        joined = "".join(values)
    except TypeError:
        return None
    if "\0" in joined or any(c in joined for c in _STR_ONLY_SPACE):
        return None
    try:
        return np.char.strip(np.array(values, dtype="S"))
    except UnicodeEncodeError:
        return None


def as_str(cells: np.ndarray, i: int) -> str:
    """Cell ``i`` of an ``S`` view as the Python string it came from."""
    return cells[i].decode("ascii")


def byte_columns(cells: np.ndarray, width: int) -> np.ndarray:
    """[w, n] uint8, w = min(width, the array's item size): byte j of
    every cell in row j (0 past a cell's end), for column-at-a-time
    arithmetic over the first bytes."""
    n = len(cells)
    mat = cells.view(np.uint8).reshape(n, cells.dtype.itemsize)
    return np.ascontiguousarray(mat[:, :min(width, mat.shape[1])].T)


def distinct(cells: np.ndarray, drop_empty: bool = False) -> Distinct:
    """The distinct cells of an ``S`` view (see :class:`Distinct`),
    without the empty cell if ``drop_empty`` (then they are the distinct
    cells of the non-empty ones, in the same order, and the empty cells'
    ``inverse`` is -1)."""
    keys, first, inverse, counts = np.unique(
        cells, return_index=True, return_inverse=True, return_counts=True)
    inverse = inverse.reshape(-1)
    widths = np.char.str_len(keys)
    if drop_empty and len(keys) and widths[0] == 0:   # b"" sorts first
        keys, first, counts, widths = keys[1:], first[1:], counts[1:], \
            widths[1:]
        inverse = inverse - 1
    return Distinct([k.decode("ascii") for k in keys.tolist()], keys, widths,
                    first, counts, inverse)


def missing_mask(cells: np.ndarray, missing: Set[str]) -> np.ndarray:
    """[n] bool: ``cell.lower() in missing`` for each cell of an ``S``
    view.  An ASCII cell lowers as ASCII, so only an ASCII missing value
    can match one: one vectorised compare each, lowering only the cells of
    its length where it has letters."""
    out = np.zeros(len(cells), bool)
    lens = None
    for m in missing:
        if not m.isascii() or "\0" in m:
            continue
        key = m.encode("ascii")
        if key.lower() == key.upper():        # no letters: lower is a no-op
            out |= cells == key
            continue
        if lens is None:
            lens = np.char.str_len(cells)
        at = np.flatnonzero(lens == len(key))
        out[at] |= np.char.lower(cells[at]) == key
    return out
