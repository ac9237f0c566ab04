"""Columnar streaming reader and numeric parsing, without pandas — the
port's copy of ``shifu_tpu.data.reader``.

:class:`DataSource` streams delimited text files as chunks of string
columns: local or remote (any fsspec scheme but the gated Hadoop ones),
plain or compressed as ``compression="infer"`` reads them (``.gz``,
``.bz2``, ``.xz``, ``.zip``, ``.tar``; ``.zst`` fails as it fails without
the ``zstandard`` package), or parquet files.  ``fsspec`` and ``pyarrow``
are imported only inside the functions that read such sources.  With
``shifu.data.badThreshold`` > 0, unreadable files are quarantined.  The reference reads them with ``pd.read_csv``'s
C engine (``sep``, ``header=None``, ``names=header``, ``dtype=str``,
``na_filter=False``, ``quoting=3``, ``on_bad_lines="skip"``, ``chunksize``);
:meth:`DataSource.iter_chunks` reproduces that tokenizer's rules cell for
cell and chunk for chunk (see :func:`_file_batches`), since a shifted chunk
boundary changes which rows a ``sampleRate < 1`` run keeps.

The reference parses numbers with
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
bins identically in both packages.  (pandas' ``str.strip`` removes exactly
the characters Python's ``str.strip`` does, so the port strips with the
latter.)
"""

from __future__ import annotations

import glob
import gzip
import io
import logging
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

_ASCII_SPACE = b" \t\n\v\f\r"
_MAX_DIGITS = 17                       # precise_xstrtod's mantissa window
_POW10 = [float(f"1e{i}") for i in range(309)]
_INF_WORDS = {b"inf": 1.0, b"+inf": 1.0, b"-inf": -1.0, b"infinity": 1.0,
              b"+infinity": 1.0, b"-infinity": -1.0}
_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1
_UINT64_MAX = (1 << 64) - 1
# a plain decimal of at most 15 digits: an exact integer over an exact
# power of ten, one correctly rounded division in precise_xstrtod — the
# same double Python's float() gives, so it skips the byte loop
_PLAIN = re.compile(r"[+-]?([0-9]*)(\.([0-9]*))?")


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


def _parse_cell(s: str) -> Tuple[float, bool, Optional[int]]:
    """One stripped cell by the full grammar: ``(value, parsed, integer)``
    where ``integer`` is the Python int of a cell that took pandas'
    integer path (None otherwise); an integer-looking cell that Python's
    ``int`` refuses (digits, a NUL, more digits) does not parse."""
    m = _PLAIN.fullmatch(s)
    if m is not None:
        whole, frac = m.group(1, 3)
        n_digits = len(whole) + (len(frac) if frac is not None else 0)
    if m is not None and 0 < n_digits <= 15:
        v, ok, maybe_int = float(s), True, frac is None
    else:
        v, ok, maybe_int = _floatify(s)
    if not (ok and maybe_int):
        return v, ok, None
    try:
        return v, True, int(s)
    except ValueError:               # e.g. digits, then a NUL, then more
        return float("nan"), False, None


#: the longest plain cell: a sign, 15 digits and a '.'
_PLAIN_WIDTH = 17
#: the first bytes a parseable cell can start with (after the strip)
_NUMBER_HEAD = np.zeros(256, bool)
_NUMBER_HEAD[np.frombuffer(b"+-.0123456789iI", np.uint8)] = True


def _plain_cells(cells: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The plain classes of a batch's ``S`` view, all at once: ``(plain,
    integer, values)`` — a cell is plain when it is an optional sign, then
    1-15 ASCII digits with at most one '.' among them (``integer`` when
    there is none); its value is the exact integer of its digits over an
    exact power of ten, one correctly rounded division, which is what
    both Python's ``float`` and ``precise_xstrtod`` give it."""
    from .cells import byte_columns
    n = len(cells)
    lens = np.char.str_len(cells)
    cols = byte_columns(cells, _PLAIN_WIDTH)
    n_dig = np.zeros(n, np.int64)
    n_dot = np.zeros(n, np.int64)
    dec = np.zeros(n, np.int64)
    mant = np.zeros(n, np.int64)
    seen_dot = np.zeros(n, bool)
    for c in cols:                        # byte j of every cell at once
        d = c.astype(np.int64) - 0x30
        digit = (d >= 0) & (d <= 9)
        dot = c == 0x2E
        mant = np.where(digit, mant * 10 + d, mant)
        dec += digit & seen_dot
        seen_dot |= dot
        n_dig += digit
        n_dot += dot
    signed = (cols[0] == 0x2B) | (cols[0] == 0x2D)
    plain = (lens > 0) & (lens == n_dig + n_dot + signed) & (n_dot <= 1) \
        & (n_dig >= 1) & (n_dig <= 15)
    values = mant / np.power(10.0, np.where(plain, dec, 0))
    values = np.where(cols[0] == 0x2D, -values, values)
    return plain, plain & (n_dot == 0), values


def parse_numeric(values: Sequence, missing_values: Sequence[str] = ()
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized string->float parse: ``(floats, valid_mask)`` where
    invalid/missing entries are NaN and masked out — value for value the
    reference's pandas coercion (see the module docs).  A batch with an
    ``S`` view (``data.cells.stripped_cells``) is stripped, classified and
    converted at once: only cells that start like a number but are not
    plain (exponents, inf spellings, 16+ digits) go cell by cell.  Any
    other batch goes cell by cell."""
    from .cells import stripped_cells
    cells = stripped_cells(values)
    if cells is None:
        return parse_objects([str(v).strip() for v in values],
                             missing_values)
    return parse_cells(cells, missing_values)


def parse_cells(cells: np.ndarray, missing_values: Sequence[str] = ()
                ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`parse_numeric` of a batch's ``S`` view of stripped cells."""
    from .cells import as_str, missing_mask
    n = len(cells)
    plain, integer, floats = _plain_cells(cells)
    empty = np.char.str_len(cells) == 0
    # a cell that does not start like a number or an inf spelling cannot
    # parse: NaN here, no per-cell pass
    head = cells.view(np.uint8).reshape(n, -1)[:, 0] if n else \
        np.zeros(0, np.uint8)
    other = ~plain & ~empty & _NUMBER_HEAD[head]
    floats[~plain] = np.nan
    # pandas returns its int array only when every entry took the integer
    # path; "-0" is then 0.0, not -0.0
    all_int = n > 0 and bool((integer | other).all())
    saw_neg = bool((integer & (floats < 0)).any())
    floats, valid = _finish(floats, [(i, as_str(cells, i))
                                     for i in np.flatnonzero(other).tolist()],
                            all_int, saw_neg)
    if len(missing_values):
        is_missing = missing_mask(cells, {m.strip().lower()
                                          for m in missing_values})
        valid &= ~is_missing
        floats = np.where(is_missing, np.nan, floats)
    return floats, valid


def parse_objects(strs: List[str], missing_values: Sequence[str] = ()
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`parse_numeric` of stripped cells one by one (a batch with no
    ``S`` view)."""
    n = len(strs)
    floats, valid = _finish(np.full(n, np.nan), list(enumerate(strs)),
                            n > 0, False)
    if len(missing_values):
        missing_set = {m.strip().lower() for m in missing_values}
        is_missing = np.fromiter((s.lower() in missing_set for s in strs),
                                 bool, n)
        valid &= ~is_missing
        floats = np.where(is_missing, np.nan, floats)
    return floats, valid


def _finish(floats: np.ndarray, rest: List[Tuple[int, str]], all_int: bool,
            saw_neg: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Parses the ``rest`` cells one by one into ``floats`` and applies
    pandas' integer path when every entry took it (``all_int`` so far,
    with ``saw_neg`` for the entries already classified)."""
    saw_big = False
    ints = {}
    for i, s in rest:
        v, ok, iv = _parse_cell(s)
        floats[i] = v if ok else np.nan
        if iv is None or iv < _INT64_MIN or iv > _UINT64_MAX:
            all_int = False
        if iv is not None:
            saw_neg |= iv < 0
            saw_big |= iv > _INT64_MAX
            ints[i] = iv
    if all_int and not (saw_neg and saw_big):
        floats = floats + 0.0                       # -0.0 -> 0.0
        for i, iv in ints.items():
            floats[i] = float(iv)
    return floats, ~np.isnan(floats)


def tag_to_target(values: Sequence, pos_tags: Sequence[str],
                  neg_tags: Sequence[str]) -> np.ndarray:
    """Map tag strings -> {1.0 pos, 0.0 neg, NaN neither}; with no negTags
    every non-positive tag is 0 (the reference's binary rule)."""
    pos = {str(t).strip() for t in pos_tags}
    neg = {str(t).strip() for t in neg_tags}
    out = np.full(len(values), np.nan, dtype=np.float64)
    for i, v in enumerate(values):
        s = str(v).strip()
        if s in pos:
            out[i] = 1.0
        if neg:
            if s in neg:
                out[i] = 0.0
        elif pos and s not in pos:
            out[i] = 0.0
    return out


def tag_to_class(values: Sequence, tags: Sequence[str]) -> np.ndarray:
    """Map tag strings -> float class index (position in ``tags``, the last
    position winning a duplicate tag), NaN for unknown tags."""
    index = {str(t).strip(): float(k) for k, t in enumerate(tags)}
    return np.fromiter((index.get(str(v).strip(), np.nan) for v in values),
                       np.float64, len(values))


def parse_weight(values: Optional[Sequence], n: int) -> np.ndarray:
    """Row weights: the parsed column where it is a positive number, else
    1 (no weight column: all 1)."""
    if values is None:
        return np.ones(n, dtype=np.float64)
    w, valid = parse_numeric(values)
    return np.where(valid & (w > 0), w, 1.0)


# ------------------------------------------------------------------ files
# Hadoop-cluster filesystems stay gated (no libhdfs client); object stores
# and any other fsspec scheme stream directly
_GATED_SCHEMES = ("hdfs://", "viewfs://", "arrow_hdfs://")

# pandas' ``compression="infer"`` table, in its order (a lower-cased
# suffix match, so ``.tar.gz`` is a tar archive)
_COMPRESSIONS = ((".tar", "tar"), (".tar.gz", "tar"), (".tar.bz2", "tar"),
                 (".tar.xz", "tar"), (".gz", "gzip"), (".bz2", "bz2"),
                 (".zip", "zip"), (".xz", "xz"), (".zst", "zstd"))


def _is_remote(path: str) -> bool:
    return "://" in path and not path.startswith("file://")


def _local(path: str) -> str:
    return path[len("file://"):] if path.startswith("file://") else path


def _is_parquet(path: str) -> bool:
    return path.endswith((".parquet", ".pq"))


def _fsspec_paths(path: str):
    """(fs, expanded paths) for a remote URL — the one place that gates
    Hadoop schemes and turns fsspec's failures into coded errors.
    ``fsspec`` is imported here, only when a remote source is read."""
    from ..config.errors import ErrorCode, ShifuError
    for scheme in _GATED_SCHEMES:
        if path.startswith(scheme):
            raise ShifuError(
                ErrorCode.ERROR_REMOTE_SOURCE,
                f"{path!r}: no native {scheme[:-3]} client in this "
                "runtime — point dataPath at the cluster's WebHDFS "
                "gateway instead (webhdfs://namenode:9870/path streams "
                "directly), stage the files locally (hdfs dfs -get), or "
                "serve them from object storage (gs://, s3://)")
    import fsspec
    try:
        fs, _, paths = fsspec.get_fs_token_paths(path)
    except ImportError as e:                   # backend package missing
        raise ShifuError(
            ErrorCode.ERROR_REMOTE_SOURCE,
            f"{path!r}: the fsspec backend for this scheme is not "
            f"installed ({e}) — stage the files locally (gsutil -m cp -r "
            "/ aws s3 sync) and set the path to the local copy") from e
    except ValueError as e:                    # unknown protocol / bad URL
        raise ShifuError(
            ErrorCode.ERROR_REMOTE_SOURCE,
            f"{path!r}: {e} — use a known scheme (gs://, s3://, file://) "
            "or stage the files locally") from e
    return fs, paths


def _resolve_remote(data_path: str) -> List[str]:
    """Expand a remote (fsspec) path / directory / glob into full URLs,
    one detail listing per directory, markers (``.*``, ``_*``) skipped."""
    from ..config.errors import ErrorCode, ShifuError
    fs, paths = _fsspec_paths(data_path)
    proto = fs.protocol if isinstance(fs.protocol, str) else fs.protocol[0]

    def url(p: str) -> str:
        if "://" in p:
            return p
        if proto == "memory":                  # ls yields "/bucket/file"
            return f"memory://{p.lstrip('/')}"
        return f"{proto}://{p}"                # s3/gs ls yields bucket/key

    out: List[str] = []
    for p in paths:
        if fs.isdir(p):
            entries = fs.ls(p, detail=True)
            out.extend(
                url(e["name"]) for e in sorted(entries,
                                               key=lambda e: e["name"])
                if e.get("type") == "file"
                and not os.path.basename(e["name"]).startswith((".", "_")))
        elif fs.isfile(p):
            out.append(url(p))
    if not out:
        raise ShifuError(ErrorCode.ERROR_INPUT_NOT_FOUND, data_path)
    return out


def resolve_data_files(data_path: str) -> List[str]:
    """Expand a file / directory / glob into an ordered list of data
    files, skipping hidden files and markers (``.pig_header``,
    ``_SUCCESS``).  Remote fsspec schemes (``gs://``, ``s3://``,
    ``memory://``, ...) resolve through :func:`_resolve_remote`; Hadoop
    filesystems are a coded error."""
    from ..config.errors import ErrorCode, ShifuError
    if _is_remote(data_path):
        return _resolve_remote(data_path)
    data_path = _local(data_path)
    if os.path.isdir(data_path):
        files = [f for f in sorted(
            os.path.join(data_path, f) for f in os.listdir(data_path)
            if not f.startswith(".") and not f.startswith("_"))
            if os.path.isfile(f)]
        if not files:
            raise ShifuError(ErrorCode.ERROR_INPUT_NOT_FOUND,
                             f"{data_path} holds no data files (markers "
                             "like _SUCCESS are skipped)")
        return files
    if os.path.isfile(data_path):
        return [data_path]
    files = sorted(glob.glob(data_path))
    if not files:
        raise ShifuError(ErrorCode.ERROR_INPUT_NOT_FOUND, data_path)
    return files


def _path_exists(path: str) -> bool:
    if _is_remote(path):
        fs, paths = _fsspec_paths(path)
        return bool(paths) and fs.exists(paths[0])
    return os.path.isfile(_local(path))


def _open_text(path: str):
    """A text stream over a header or first data line, as the reference
    opens it: a remote URL through fsspec with inferred compression, a
    local ``.gz`` through gzip, any other local file as plain text."""
    if _is_remote(path):
        import fsspec
        _fsspec_paths(path)            # gate + coded errors first
        return fsspec.open(path, "rt", compression="infer",
                           encoding="utf-8", errors="replace").open()
    path = _local(path)
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8",
                                errors="replace")
    return open(path, encoding="utf-8", errors="replace")


def _compression(path: str) -> Optional[str]:
    p = path.split("::")[0].lower()
    for ext, method in _COMPRESSIONS:
        if p.endswith(ext):
            return method
    return None


def _open_data(path: str):
    """A strict UTF-8 text stream (``newline=""``) over one data file,
    decompressed as ``pd.read_csv(compression="infer")`` does, and failing
    where and as it fails: a stream that is not of its suffix's format
    raises at open (its first block is read here), a zip or tar archive
    must hold exactly one file, and ``.zst`` needs the ``zstandard``
    package, which the port does not use."""
    method = _compression(path)
    if method == "zstd":
        raise ImportError("`Import zstandard` failed.  Use pip or conda to "
                          "install the zstandard package.")
    if _is_remote(path):
        import fsspec
        _fsspec_paths(path)
        raw = fsspec.open(path, "rb").open()
    else:
        raw = open(_local(path), "rb")
    try:
        if method == "gzip":
            f = gzip.GzipFile(fileobj=raw, mode="rb")
            f.peek(1)
        elif method == "bz2":
            import bz2
            f = bz2.BZ2File(raw, "rb")
            f.peek(1)
        elif method == "xz":
            import lzma
            f = lzma.LZMAFile(raw, "rb")
            f.peek(1)
        elif method == "zip":
            import zipfile
            zf = zipfile.ZipFile(raw)
            names = zf.namelist()
            if not names:
                raise ValueError(f"Zero files found in ZIP file {path}")
            if len(names) > 1:
                raise ValueError("Multiple files found in ZIP file. Only "
                                 f"one file per ZIP: {names}")
            f = zf.open(names[0])
        elif method == "tar":
            import tarfile
            tf = tarfile.open(fileobj=raw, mode="r")
            names = tf.getnames()
            if not names:
                raise ValueError(f"Zero files found in TAR archive {path}")
            if len(names) > 1:
                raise ValueError("Multiple files found in TAR archive. "
                                 f"Only one file per TAR archive: {names}")
            f = tf.extractfile(names[0])
        else:
            f = raw
    except BaseException:
        raw.close()
        raise
    return io.TextIOWrapper(f, encoding="utf-8", errors="strict",
                            newline="")


def read_header(header_path: Optional[str], header_delimiter: str,
                data_files: Optional[Sequence[str]] = None,
                data_delimiter: str = "|") -> List[str]:
    """Column names from a header file, or from the first data line (named,
    or ``column_<i>`` when any field parses as a number)."""
    if header_path and _path_exists(header_path):
        with _open_text(header_path) as f:
            line = f.readline().rstrip("\r\n")
        return [c.strip() for c in line.split(header_delimiter)]
    if not data_files:
        raise ValueError("neither header file nor data files to infer "
                         "header from")
    with _open_text(data_files[0]) as f:
        line = f.readline().rstrip("\r\n")
    fields = line.split(data_delimiter)

    def _is_num(s: str) -> bool:
        try:
            float(s)
            return True
        except ValueError:
            return False
    if any(_is_num(x) for x in fields):
        return [f"column_{i}" for i in range(len(fields))]
    return [c.strip() for c in fields]


_WHITESPACE = r"\s+"
_WHITESPACE_RUN = re.compile(r"[ \t]+")


def check_delimiter(delimiter: str) -> None:
    """Refuse a delimiter that ``read_csv(engine="c")`` refuses: longer
    than one character and not ``\\s+``, with its ``ValueError``."""
    if len(delimiter) > 1 and delimiter != _WHITESPACE:
        raise ValueError("the 'c' engine does not support regex separators "
                         "(separators > 1 char and different from '\\s+' "
                         "are interpreted as regex)")


def _file_batches(f, delimiter: str, n_names: int,
                  chunk_rows: int) -> Iterator[List[List[str]]]:
    """The rows of one open file (``newline=""``) in batches of ``chunk_rows``, as pandas' C
    tokenizer cuts them for ``read_csv(chunksize=chunk_rows)``:

    - a line ends at ``\\n``, ``\\r`` or ``\\r\\n``; a UTF-8 BOM at the start
      of the file is dropped; undecodable bytes raise;
    - a line of nothing but spaces and tabs is blank and skipped;
    - quotes are literal (QUOTE_NONE);
    - the first line sets the width W = max(its fields, names); when it has
      more fields than names, its leading W - names fields become the
      index (dropped here) on every row;
    - the first line of each batch is taken whatever its length (cut to
      W); any other line with more than W fields is skipped and does not
      count toward the batch;
    - a short line is padded with empty fields;
    - the delimiter ``\\s+`` splits at runs of spaces and tabs and ignores
      them at both ends of a line.

    Outside this contract: NUL bytes, and a line that starts with a space
    or tab after a bare ``\r`` line end — pandas' tokenizer then re-reads
    every line since the last ``\n`` of its read buffer (a duplicate-row
    quirk the port does not reproduce).
    """
    if delimiter == _WHITESPACE:
        blank = " \t"

        def split(line: str) -> List[str]:
            return _WHITESPACE_RUN.split(line.strip(blank))
    else:
        blank = " \t".replace(delimiter, "")

        def split(line: str) -> List[str]:
            return line.split(delimiter)
    width = lead = None
    batch: List[List[str]] = []
    for i, line in enumerate(f):
        if i == 0 and line.startswith("﻿"):
            line = line[1:]
        line = line.rstrip("\r\n")
        if not line.strip(blank):
            continue
        fields = split(line)
        if width is None:
            width = max(len(fields), n_names)
            lead = width - n_names
        if len(fields) > width:
            if batch:
                continue
            fields = fields[:width]
        elif len(fields) < width:
            fields += [""] * (width - len(fields))
        batch.append(fields[lead:])
        if len(batch) == chunk_rows:
            yield batch
            batch = []
    if batch or width is None:
        yield batch


@dataclass
class RawChunk:
    """A chunk of raw rows in columnar string form: column name -> object
    array of ``str`` ("" for an empty field)."""
    columns: List[str]
    data: Dict[str, np.ndarray]

    def __len__(self) -> int:
        return len(next(iter(self.data.values()))) if self.data else 0

    def col(self, name: str) -> np.ndarray:
        return self.data[name]

    def take(self, keep: np.ndarray) -> "RawChunk":
        """The rows where the boolean mask ``keep`` is set."""
        return RawChunk(self.columns,
                        {k: v[keep] for k, v in self.data.items()})


def _columns(header: List[str], rows: List[List[str]]) -> Dict[str, np.ndarray]:
    out = {}
    for name, col in zip(header, zip(*rows) if rows else
                         [()] * len(header)):
        a = np.empty(len(col), dtype=object)
        a[:] = col
        out[name] = a
    return out


class DataSource:
    """Streaming columnar reader over one dataset (dataPath + delimiter)."""

    def __init__(self, data_path: str, data_delimiter: str = "|",
                 header: Optional[List[str]] = None,
                 header_path: Optional[str] = None,
                 header_delimiter: str = "|"):
        self.files = resolve_data_files(data_path)
        self.delimiter = data_delimiter or "|"
        self.parquet = all(_is_parquet(f) for f in self.files) \
            and bool(self.files)
        if header is None:
            if self.parquet:
                header = _parquet_schema_names(self.files[0])
            else:
                header = read_header(header_path,
                                     header_delimiter or self.delimiter,
                                     self.files, self.delimiter)
        self.header = header

    def iter_chunks(self, chunk_rows: int = 262144) -> Iterator[RawChunk]:
        """Yield RawChunks of up to ``chunk_rows`` rows, file by file (a
        file's last chunk may be short).  A first row equal to the header
        is dropped from each file.

        Transient ``OSError``s on a file's open ride the bounded-retry
        ladder (``ioutil.io_retry``).  With ``shifu.data.badThreshold`` >
        0, bad input — an unreadable file, a read that dies mid-stream —
        is quarantined (counted, logged with provenance, dropped) instead
        of ending the run; the run still fails with the coded
        ``ERROR_BAD_DATA_THRESHOLD`` when the quarantined share of rows or
        files passes the threshold.  Any other exception (a
        ``UnicodeDecodeError``, a corrupt zip) is let through."""
        from .. import faults, obs
        from ..config import environment
        from ..config.errors import ErrorCode, ShifuError
        from ..ioutil import io_retry
        # each call is one full raw-plane traversal (cache-served passes
        # never get here)
        obs.counter("ingest.disk_passes").inc()
        if self.parquet:
            yield from self._iter_parquet(chunk_rows)
            return
        bytes_c = obs.counter("ingest.bytes_read")
        bad_threshold = environment.get_float("shifu.data.badThreshold", 0.0)
        q_rows = obs.counter("data.quarantined_rows")
        q_shards = obs.counter("data.quarantined_shards")
        quarantined_rows = yielded_rows = quarantined_files = 0
        provenance: List[str] = []

        def quarantine(what: str, rows: int = 0, files: int = 0) -> None:
            nonlocal quarantined_rows, quarantined_files
            quarantined_rows += rows
            quarantined_files += files
            q_rows.inc(rows)
            q_shards.inc(files)
            provenance.append(what)
            log.warning("bad input quarantined: %s (%d rows, %d files "
                        "quarantined so far)", what,
                        quarantined_rows, quarantined_files)

        header = list(self.header)
        for fi, path in enumerate(self.files):
            if not _is_remote(path):
                try:
                    bytes_c.inc(os.path.getsize(_local(path)))
                except OSError:
                    pass

            def _open(path=path, fi=fi):
                faults.fire("reader", "file", fi, path=path)
                check_delimiter(self.delimiter)
                return _open_data(path)
            try:
                f = io_retry(_open, "shard open", path)
            except OSError as e:
                if bad_threshold > 0:
                    quarantine(f"{path}: unreadable ({e})", files=1)
                    continue
                raise
            with f:
                try:
                    for chunk in self._file_chunks(path, f, header,
                                                   chunk_rows):
                        yielded_rows += len(chunk)
                        yield chunk
                except OSError as e:
                    if bad_threshold <= 0:
                        raise
                    quarantine(f"{path}: read died mid-stream ({e})",
                               files=1)

        if quarantined_rows or quarantined_files:
            frac_rows = quarantined_rows / max(
                yielded_rows + quarantined_rows, 1)
            frac_files = quarantined_files / max(len(self.files), 1)
            if max(frac_rows, frac_files) > bad_threshold:
                raise ShifuError(
                    ErrorCode.ERROR_BAD_DATA_THRESHOLD,
                    f"quarantined {quarantined_rows} row(s) / "
                    f"{quarantined_files} file(s) exceeds "
                    f"shifu.data.badThreshold={bad_threshold}; first "
                    f"offender: {provenance[0]}")

    def _file_chunks(self, path: str, f, header: List[str],
                     chunk_rows: int) -> Iterator[RawChunk]:
        first = True
        for rows in _file_batches(f, self.delimiter, len(header),
                                  chunk_rows):
            if first:
                first = False
                if not rows:                # no data line: pandas' empty
                    raise IndexError(       # frame has no row 0
                        f"{path}: no data rows")
                if rows[0] == header:
                    rows = rows[1:]
                    if not rows:
                        continue
            yield RawChunk(header, _columns(header, rows))

    def _iter_parquet(self, chunk_rows: int) -> Iterator[RawChunk]:
        """Columnar parquet ingest: record batches of ``chunk_rows`` rows,
        every column cast to strings in Arrow (an int64 column renders
        ``'1'`` whatever the nulls of its batch), nulls as ``""`` (the
        missing marker).  ``pyarrow`` is imported here, only when a
        parquet source is read."""
        import pyarrow as pa
        import pyarrow.compute as pc
        for path in self.files:
            pf = _open_parquet(path)
            for batch in pf.iter_batches(batch_size=chunk_rows,
                                         columns=list(self.header)):
                cols = {}
                for name, col in zip(batch.schema.names, batch.columns):
                    sc = pc.fill_null(pc.cast(col, pa.string()), "")
                    a = np.empty(len(sc), dtype=object)
                    a[:] = sc.to_pylist()
                    cols[name] = a
                yield RawChunk(list(self.header),
                               {c: cols[c] for c in self.header})


def _open_parquet(path: str):
    """A ``pyarrow.parquet.ParquetFile`` over local or fsspec storage."""
    import pyarrow.parquet as pq
    if _is_remote(path):
        import fsspec
        _fsspec_paths(path)            # gate + coded errors first
        return pq.ParquetFile(fsspec.open(path, "rb").open())
    return pq.ParquetFile(_local(path))


def _parquet_schema_names(path: str) -> List[str]:
    return list(_open_parquet(path).schema_arrow.names)
