"""Row filtering + sampling — the port's copy of
``shifu_tpu.data.purifier`` (reference ``core/DataPurifier.java`` and
``core/DataSampler.java``).

The reference evaluates ``dataSet.filterExpressions`` with ``pandas.eval``
over the chunk's columns.  The port evaluates it with a small interpreter
over a whitelisted ``ast`` tree — it never runs the string as Python —
and keeps ``pandas.eval``'s meaning where it differs from Python's:

- **Precedence.** ``&`` and ``|`` are rewritten to ``and`` and ``or``
  before parsing, so ``a > 1 & b < 2`` means ``(a > 1) and (b < 2)``;
  ``and`` / ``or`` then act elementwise, and ``not`` is ``~``.
- **Columns.** Per chunk, a column is numeric where the reference's
  ``pd.to_numeric(errors="coerce")`` parses any of its cells (the port's
  :func:`~shifu_tpu_torch.data.reader.parse_numeric`, whose all-integer
  batches stay integers), else a column of strings.  So a column can be
  numeric in one chunk and strings in the next.
- **Missing values.** NaN compares False, except ``!=``.
- **Membership.** ``==`` / ``!=`` with a string or a list on either side
  is ``in`` / ``not in``, an ``isin`` over the values; so a numeric column
  ``== 'T'`` is all False, not an error.
- **Errors keep all rows.** A syntax error, an unknown name, a type
  mismatch (a string column against a number in ``<``, arithmetic on
  strings, ``~`` on floats) or a result that is not one value per row
  keeps every row of the chunk.  A result that is one value per row but
  not boolean keeps its truthy rows, as ``np.asarray(res, dtype=bool)``
  does.

Supported: names (backtick-quoted too), numbers, strings, ``True`` /
``False``, lists and tuples of constants, comparisons (chained ones are
``and``-ed), ``in`` / ``not in``, ``and`` / ``or`` / ``&`` / ``|`` on
booleans, ``not`` / ``~``, unary ``+`` / ``-``, ``+ - * / // % **``, and
the reference's math functions (``abs``, ``log``, ``sqrt``, ...).
Anything else — attributes, subscripts, ``^``, ``@`` locals — keeps all
rows, as it does in the reference (ROADMAP Queue 3, C14, lists what the
two do not share).
"""

from __future__ import annotations

import ast
import io
import keyword
import logging
import operator
import tokenize
from typing import Optional

import numpy as np

from .reader import parse_numeric

log = logging.getLogger(__name__)


class _Unsupported(Exception):
    """An expression the filter grammar does not cover."""


def _unbacktick(expr: str) -> str:
    """A backtick-quoted name outside string literals becomes that name
    when it is a Python identifier, else a name no chunk has (the
    reference mangles it to one its ``local_dict`` does not hold)."""
    out, quote, i = [], None, 0
    while i < len(expr):
        c = expr[i]
        if quote:
            if c == "\\":
                out.append(expr[i:i + 2])
                i += 2
                continue
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "`":
            j = expr.find("`", i + 1)
            if j < 0:
                raise SyntaxError("unterminated backtick")
            name = expr[i + 1:j]
            out.append(name if name.isidentifier()
                       and not keyword.iskeyword(name)
                       else "BACKTICK_QUOTED_STRING_")
            i = j + 1
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _preparse(expr: str) -> str:
    """``pandas.eval``'s token rewrite: ``&`` -> ``and``, ``|`` -> ``or``."""
    expr = _unbacktick(expr)
    out = []
    for tok in tokenize.generate_tokens(io.StringIO(expr).readline):
        if tok.type == tokenize.OP and tok.string in ("&", "|"):
            out.append((tokenize.NAME, "and" if tok.string == "&" else "or"))
        else:
            out.append((tok.type, tok.string))
    return tokenize.untokenize(out)


def _column(values: np.ndarray):
    """A chunk column as the reference's eval sees it: numeric (int64 when
    every cell took pandas' integer path, else float64 with NaN) where any
    cell parses, else the strings."""
    f, valid = parse_numeric(values)
    if not valid.any():
        return np.asarray(values, dtype=object)
    if valid.all() and _all_integer(values):
        return np.array([int(str(v).strip()) for v in values],
                        dtype=np.int64)
    return f


def _all_integer(values) -> bool:
    for v in values:
        s = str(v).strip()
        t = s[1:] if s[:1] in "+-" else s
        if not (t.isascii() and t.isdigit()):
            return False
        if not -(1 << 63) <= int(s) < (1 << 63):
            return False
    return True


def _is_arr(v) -> bool:
    return isinstance(v, np.ndarray)


def _kind(v) -> str:
    if _is_arr(v):
        return "s" if v.dtype == object else ("b" if v.dtype == bool
                                               else "n")
    if isinstance(v, (list, tuple)):
        return "l"
    if isinstance(v, str):
        return "str"
    return "sc"


def _isin(x, values) -> np.ndarray:
    vals = list(values.tolist() if _is_arr(values) else values)
    has_nan = any(isinstance(v, float) and v != v for v in vals)
    keys = set()
    for v in vals:
        try:
            keys.add(v)
        except TypeError:
            raise _Unsupported("unhashable membership value")
    out = np.empty(len(x), dtype=bool)
    for i, v in enumerate(x.tolist()):
        if isinstance(v, float) and v != v:
            out[i] = has_nan
        else:
            out[i] = v in keys
    return out


def _membership(x, y, negate: bool):
    """The reference's ``_in`` / ``_not_in``: ``x.isin(y)``, else (``x``
    a list) ``y.isin(x)``, else Python's ``in``."""
    if _is_arr(x):
        if not (_is_arr(y) or isinstance(y, (list, tuple))):
            raise _Unsupported("isin of a scalar")
        res = _isin(x, y)
    elif isinstance(x, (list, tuple)) and _is_arr(y):
        res = _isin(y, x)
    else:
        try:
            return (x not in y) if negate else (x in y)
        except TypeError:
            raise _Unsupported("membership of scalars")
    return ~res if negate else res


_CMP = {ast.Lt: operator.lt, ast.LtE: operator.le, ast.Gt: operator.gt,
        ast.GtE: operator.ge, ast.Eq: operator.eq, ast.NotEq: operator.ne}


def _compare(op, left, right, terms: bool):
    """One comparison.  ``terms``: both sides are names, constants or
    lists, where the reference turns a string into a one-element list and
    ``==`` / ``!=`` beside a string or a list into ``in`` / ``not in``."""
    kinds = (_kind(left), _kind(right))
    member = type(op) in (ast.In, ast.NotIn)
    if terms and ("str" in kinds or "l" in kinds):
        left = [left] if kinds[0] == "str" else left
        right = [right] if kinds[1] == "str" else right
        member = member or type(op) in (ast.Eq, ast.NotEq)
    if member:
        return _membership(left, right, type(op) in (ast.NotIn, ast.NotEq))
    if "l" in kinds:
        raise _Unsupported("comparison against a list")
    if not (_is_arr(left) or _is_arr(right)):
        try:
            return bool(_CMP[type(op)](left, right))
        except TypeError:
            raise _Unsupported("comparison of scalars")
    strs = [k in ("s", "str") for k in kinds]
    if any(strs) and not all(strs):
        if type(op) is ast.Eq:
            return np.zeros(len(left if _is_arr(left) else right), bool)
        if type(op) is ast.NotEq:
            return np.ones(len(left if _is_arr(left) else right), bool)
        raise _Unsupported("ordering strings against numbers")
    with np.errstate(invalid="ignore"):
        res = _CMP[type(op)](left, right)
    return np.asarray(res, dtype=bool)


class _BoolInt(int):
    """``~`` of a scalar boolean: Python's integer invert (``~True`` is
    -2), still typed boolean for the reference's scalar rule below."""


def _bool_typed(v) -> bool:
    return _is_arr(v) and v.dtype == bool or isinstance(v, (bool, _BoolInt))


def _logical(op, left, right):
    """``&`` / ``|``: beside a scalar both sides must be boolean-typed (the
    reference's "scalar only bool ops" rule), and an inverted scalar acts
    bitwise on the column's 0/1; two columns may also be integers
    (bitwise), never floats or strings."""
    if not (_is_arr(left) and _is_arr(right)):
        if not (_bool_typed(left) and _bool_typed(right)):
            raise _Unsupported("scalar boolean op on a non-boolean")
        if isinstance(left, _BoolInt) or isinstance(right, _BoolInt):
            ints = [v.astype(np.int64) if _is_arr(v) else int(v)
                    for v in (left, right)]
            return op(*ints) != 0
    elif not all(v.dtype.kind in "biu" for v in (left, right)):
        raise _Unsupported("boolean op on floats or strings")
    return op(left, right)


def _arith(op, left, right):
    kinds = {_kind(left), _kind(right)}
    if op is operator.add and kinds in ({"s"}, {"str"}):
        return op(left, right)          # string columns or literals: concat
    if kinds & {"s", "str", "l"}:
        raise _Unsupported("arithmetic on strings")
    if not (_is_arr(left) or _is_arr(right)):
        try:
            return op(left, right)
        except ArithmeticError:
            raise _Unsupported("scalar arithmetic")
    ints = all(_is_arr(v) and v.dtype.kind in "iub" or
               isinstance(v, (int, bool)) and not isinstance(v, float)
               for v in (left, right))
    if op in (operator.floordiv, operator.mod) and ints:
        if np.any(np.asarray(right) == 0):
            left = np.asarray(left, dtype=np.float64)
            right = np.asarray(right, dtype=np.float64)
    if op is operator.pow and ints and np.any(np.asarray(right) < 0):
        raise _Unsupported("integers to negative integer powers")
    with np.errstate(all="ignore"):
        return op(left, right)


_BIN = {ast.Add: operator.add, ast.Sub: operator.sub,
        ast.Mult: operator.mul, ast.Div: operator.truediv,
        ast.FloorDiv: operator.floordiv, ast.Mod: operator.mod,
        ast.Pow: operator.pow}
_BITS = {ast.BitAnd: operator.and_, ast.BitOr: operator.or_}
# the reference's math functions (pandas' MATHOPS), on numeric columns
_FUNCS = {name: getattr(np, name) for name in (
    "sin", "cos", "tan", "exp", "log", "expm1", "log1p", "sqrt", "sinh",
    "cosh", "tanh", "arcsin", "arccos", "arctan", "arccosh", "arcsinh",
    "arctanh", "abs", "log10", "floor", "ceil", "arctan2")}


def _is_term(node) -> bool:
    return isinstance(node, (ast.Name, ast.Constant, ast.List, ast.Tuple))


class _Eval:
    def __init__(self, env):
        self.env = env

    def __call__(self, node):
        if isinstance(node, ast.Expression):
            return self(node.body)
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (bool, int, float, str)):
                return node.value
            raise _Unsupported(f"constant {node.value!r}")
        if isinstance(node, ast.Name):
            if node.id not in self.env:
                raise _Unsupported(f"unknown name {node.id!r}")
            return self.env[node.id]
        if isinstance(node, (ast.List, ast.Tuple)):
            vals = [self(e) for e in node.elts]
            if any(_is_arr(v) for v in vals):
                raise _Unsupported("column inside a list")
            return vals
        if isinstance(node, ast.UnaryOp):
            v = self(node.operand)
            if isinstance(node.op, (ast.Not, ast.Invert)):
                if isinstance(v, (bool, _BoolInt)):
                    return _BoolInt(~int(v))
                if not _is_arr(v) or v.dtype.kind not in "biu":
                    raise _Unsupported("invert of a non-boolean")
                return ~v
            if _kind(v) in ("s", "str", "l"):
                raise _Unsupported("sign of a string")
            return -v if isinstance(node.op, ast.USub) else +v
        if isinstance(node, ast.BoolOp):
            op = operator.and_ if isinstance(node.op, ast.And) \
                else operator.or_
            vals = [self(v) for v in node.values]
            res = vals[0]
            for v in vals[1:]:
                res = _logical(op, res, v)
            return res
        if isinstance(node, ast.Compare):
            left, lnode = self(node.left), node.left
            parts = []
            for op, comp in zip(node.ops, node.comparators):
                right = self(comp)
                parts.append(_compare(op, left, right,
                                      _is_term(lnode) and _is_term(comp)))
                left, lnode = right, comp
            res = parts[0]
            for p in parts[1:]:
                res = _logical(operator.and_, res, p)
            return res
        if isinstance(node, ast.Call):
            name = node.func.id if isinstance(node.func, ast.Name) else None
            if name in self.env or name not in _FUNCS or node.keywords:
                raise _Unsupported("call")
            args = [self(a) for a in node.args]
            if any(_kind(a) in ("s", "str", "l") for a in args):
                raise _Unsupported("math on strings")
            with np.errstate(all="ignore"):
                return _FUNCS[name](*args)
        if isinstance(node, ast.BinOp):
            left, right = self(node.left), self(node.right)
            if type(node.op) in _BITS:
                return _logical(_BITS[type(node.op)], left, right)
            if type(node.op) in _BIN:
                return _arith(_BIN[type(node.op)], left, right)
        raise _Unsupported(type(node).__name__)


class DataPurifier:
    def __init__(self, filter_expression: Optional[str]):
        self.expr = (filter_expression or "").strip()
        self._tree = None
        self._names: set = set()
        if self.expr:
            try:
                self._tree = ast.parse(_preparse(self.expr).strip(),
                                       mode="eval")
            except (SyntaxError, tokenize.TokenError, ValueError):
                return
            self._names = {n.id for n in ast.walk(self._tree)
                           if isinstance(n, ast.Name)}

    def mask(self, chunk) -> np.ndarray:
        """Boolean keep-mask for the chunk (a ``RawChunk``); an expression
        that fails keeps all rows, as the reference's does."""
        n = len(chunk)
        keep_all = np.ones(n, dtype=bool)
        if not self.expr or self._tree is None:
            return keep_all
        # only the columns the expression names are parsed
        env = {name: _column(np.asarray(chunk.data[name], dtype=object))
               for name in self._names if name in chunk.data}
        try:
            res = _Eval(env)(self._tree)
            arr = np.asarray(res, dtype=bool)
        except (_Unsupported, TypeError, ValueError, ArithmeticError) as e:
            log.debug("filter %r keeps all rows: %s", self.expr, e)
            return keep_all
        return arr if arr.shape == (n,) else keep_all


def sample_mask(n: int, rate: float, seed: int, neg_only: bool = False,
                targets: Optional[np.ndarray] = None) -> np.ndarray:
    """Bernoulli sampling mask; with ``neg_only`` positives are always kept
    (reference stats/norm ``sampleNegOnly`` semantics)."""
    if rate >= 1.0:
        return np.ones(n, dtype=bool)
    rng = np.random.default_rng(seed)
    keep = rng.random(n) < rate
    if neg_only and targets is not None:
        keep |= targets == 1.0
    return keep
