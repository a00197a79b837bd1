"""Aggregation expression engine: compile + evaluate APPLY/FILTER expressions.

Reference: src/expr/ (1,690 LoC) — ``Expression::Compile`` (expr.h:66) builds
an AST over dynamically-typed ``Value``s (nil / numeric double / string,
value.h:25) with C-like precedence, @field refs, $param refs, and the
function library documented in docs/topics/search-expressions.md
(numeric, string, timestamp, exists).

The port's own copy of valkey_search_tpu/query/expr.py, with its imports
pointing into valkey_search_tpu_torch.
"""

from __future__ import annotations

import calendar
import math
import time as _time
from typing import Callable, Dict, List, Optional, Union

Value = Union[None, float, str]  # Nil / Numeric / String


class EvalError(ValueError):
    """Runtime type error during APPLY/FILTER evaluation — aborts the whole
    query (Redisearch behavior, captured by the expr conformance oracle:
    arithmetic/ordering on non-numeric or missing operands is an error,
    not a silent nil)."""


class ExprError(ValueError):
    pass


def to_number(v: Value) -> Optional[float]:
    if v is None:
        return None
    if isinstance(v, float):
        return v
    if isinstance(v, int):
        return float(v)
    s = str(v).strip()
    low = s.lower()
    if low in ("inf", "+inf", "infinity", "+infinity"):
        return math.inf
    if low in ("-inf", "-infinity"):
        return -math.inf
    try:
        return float(s)
    except ValueError:
        return None


def to_string(v: Value) -> Optional[str]:
    if v is None:
        return None
    if isinstance(v, float):
        if math.isfinite(v) and abs(v) < 1e15 and v == int(v):
            return str(int(v))
        return repr(v)
    return str(v)


def truthy(v: Value) -> bool:
    """Logical ops: 0 iff convertible to numeric 0 ("" counts as 0),
    else 1 (spec; expr oracle: (0)||("") == 0, !("") == 1)."""
    n = _arith_num(v)
    return not (n is not None and n == 0.0)


def _truthy_strict(v: Value) -> bool:
    """&&/|| operand: nil errors (expr oracle: (0)||(@missing) errors)."""
    if v is None:
        raise EvalError("logical operator requires an operand")
    return truthy(v)


class Node:
    def eval(self, record: Dict[str, Value], params: Dict[str, Value]) -> Value:
        raise NotImplementedError


class Const(Node):
    def __init__(self, v: Value):
        self.v = v

    def eval(self, record, params):
        return self.v


class StrictRecord(dict):
    """APPLY/FILTER evaluation context: referencing a property that is not
    loaded nor produced by the pipeline is an error (Redisearch:
    "Property ... not loaded nor in pipeline"; expr oracle: even
    exists(@missing) errors). SORTBY stays lenient (missing keys sort
    as nil)."""

    def get(self, k, default=None):
        if k not in self:
            raise EvalError(f"property {k!r} not loaded nor in pipeline")
        return self[k]


class FieldRef(Node):
    def __init__(self, name: str):
        self.name = name

    def eval(self, record, params):
        return record.get(self.name)


class ParamRef(Node):
    def __init__(self, name: str):
        self.name = name

    def eval(self, record, params):
        v = params.get(self.name)
        if isinstance(v, (bytes, bytearray)):
            return v.decode(errors="surrogateescape")
        return v if v is None or isinstance(v, (float, str)) else str(v)


class Unary(Node):
    def __init__(self, op: str, child: Node):
        self.op = op
        self.child = child

    def eval(self, record, params):
        v = self.child.eval(record, params)
        if self.op == "!":
            return 0.0 if _truthy_strict(v) else 1.0
        if self.op == "-":
            n = to_number(v)
            return None if n is None else -n
        raise ExprError(f"bad unary {self.op}")


class Binary(Node):
    def __init__(self, op: str, left: Node, right: Node):
        self.op = op
        self.left = left
        self.right = right

    def eval(self, record, params):
        op = self.op
        if op in ("&&", "||"):
            # NO short-circuit: both operands evaluate and must be non-nil
            # (expr oracle: (-1)||(@missing) errors)
            lt = _truthy_strict(self.left.eval(record, params))
            rt = _truthy_strict(self.right.eval(record, params))
            if op == "&&":
                return 1.0 if (lt and rt) else 0.0
            return 1.0 if (lt or rt) else 0.0
        lv = self.left.eval(record, params)
        rv = self.right.eval(record, params)
        if op in ("+", "-", "*", "/", "%", "^"):
            ln, rn = _arith_num(lv), _arith_num(rv)
            if ln is None or rn is None:
                raise EvalError(f"{op!r} requires numeric operands")
            try:
                if op == "+":
                    return ln + rn
                if op == "-":
                    return ln - rn
                if op == "*":
                    return ln * rn
                if op == "/":
                    # reference FuncDiv (value.cc:350): x/0 == nan, not nil
                    return ln / rn if rn != 0 else math.nan
                if op == "%":
                    return math.fmod(ln, rn) if rn != 0 else math.nan
                if op == "^":
                    # C std::pow semantics (reference FuncPower, value.cc:365);
                    # infinite exponents follow IEEE rules (python ** handles
                    # them), only finite fractional exponents of negative
                    # bases are domain errors
                    if (
                        ln < 0
                        and math.isfinite(ln)
                        and math.isfinite(rn)
                        and not float(rn).is_integer()
                    ):
                        return math.nan
                    try:
                        return float(ln ** rn)
                    except ZeroDivisionError:
                        return math.inf
                    except OverflowError:
                        neg = ln < 0 and float(rn).is_integer() and int(rn) % 2
                        return -math.inf if neg else math.inf
            except (OverflowError, ValueError):
                return None
        # relational: conversion rules from search-expressions.md
        # IEEE unordered comparisons (reference FuncLt.. use C++ double
        # operators): any relation with nan is false, except != which is true
        # Comparison type model (derived from the expr oracle):
        #  - nil operand → error ((0)==(@missing) errors)
        #  - both convert numerically ("" counts as 0) → numeric compare,
        #    IEEE rules for nan (all false except !=)
        #  - else both strings → lexical compare (("")<("a") == 1)
        #  - else mixed → ordering errors ((0)<("a")); equality is false
        if lv is None or rv is None:
            raise EvalError(f"{op!r} requires two operands")
        ln, rn = _arith_num(lv), _arith_num(rv)
        if ln is not None and rn is not None:
            if math.isnan(ln) or math.isnan(rn):
                return 1.0 if op == "!=" else 0.0
            cmp = (ln > rn) - (ln < rn)
        elif isinstance(lv, str) and isinstance(rv, str):
            a_s, b_s = lv, rv
            cmp = (a_s > b_s) - (a_s < b_s)
        else:
            if op in ("<", "<=", ">", ">="):
                raise EvalError(f"{op!r} requires operands of the same type")
            return 1.0 if op == "!=" else 0.0
        res = {
            "<": cmp < 0, "<=": cmp <= 0, "==": cmp == 0,
            "!=": cmp != 0, ">": cmp > 0, ">=": cmp >= 0,
        }[op]
        return 1.0 if res else 0.0


def _compare(a: Value, b: Value) -> Optional[int]:
    """Numeric-first ordering (reference Value comparison operators:
    values that both convert to doubles compare numerically — '-0.5' < '-1'
    is FALSE — falling back to string ordering otherwise)."""
    if a is None and b is None:
        return 0
    if a is None or b is None:
        return None  # unordered
    an, bn = to_number(a), to_number(b)
    if an is not None and bn is not None:
        return (an > bn) - (an < bn)
    a_s, b_s = to_string(a), to_string(b)
    return (a_s > b_s) - (a_s < b_s)


class Call(Node):
    def __init__(self, name: str, args: List[Node]):
        self.name = name
        self.args = args
        if name == "concat":
            from valkey_search_tpu_torch.runtime import config as _cfg

            if str(_cfg.get("search.emulate-release")):
                # Redisearch has no concat(); the conformance oracle
                # expects an unknown-function error under emulation
                raise ExprError("Function concat is unknown")
        fn = _FUNCTIONS.get(name)
        if fn is None:
            raise ExprError(f"unknown function {name!r}")
        lo, hi, self.fn = fn
        if not lo <= len(args) <= hi:
            raise ExprError(f"{name}() takes {lo}..{hi} args, got {len(args)}")

    def eval(self, record, params):
        return self.fn([a.eval(record, params) for a in self.args])


def _arith_num(v) -> Optional[float]:
    """Arithmetic operand conversion: empty string counts as 0
    (oracle: (0)+("") == 0); unconvertible values stay None → error."""
    n = to_number(v)
    if n is None and isinstance(v, str) and v.strip() == "":
        return 0.0
    return n


def _num1(f: Callable[[float], float]):
    """C math semantics (the reference calls libm directly): domain errors
    yield nan (log(-1) == nan), range errors yield inf (exp(1e9) == inf);
    unparsable strings yield nan (oracle numeric_unary_nan_on_unparsable);
    missing operands error."""

    def g(args):
        if args[0] is None:
            raise EvalError("numeric function requires an operand")
        n = _arith_num(args[0])
        if n is None:
            return math.nan
        try:
            return float(f(n))
        except ValueError:
            return math.nan
        except OverflowError:
            return math.inf

    return g


def _tm(field: str, adjustment: int = 0):
    """Component extraction (reference TIME_FUNCTION, value.cc:650-672):
    NaN/inf/negative timestamps → nil."""

    def g(args):
        n = _arith_num(args[0])
        if n is None or math.isnan(n) or math.isinf(n) or n < 0:
            return None
        try:
            t = _time.gmtime(int(n))  # (time_t) cast truncates toward zero
        except (OverflowError, OSError, ValueError):
            return None
        v = getattr(t, field)
        if field == "tm_mon":
            v -= 1  # C tm_mon is 0-11
        elif field == "tm_yday":
            v -= 1  # C tm_yday is 0-based; python's is 1-based
        elif field == "tm_wday":
            v = (v + 1) % 7  # python Monday=0 → C Sunday=0
        elif field == "tm_year":
            v -= 1900  # python gives the full year; C gives years-since-1900
        return float(v + adjustment)

    return g


def _round_period(period: float):
    """day/hour/minute truncate the timestamp to the period start
    (reference RoundToPeriod, value.cc:800-831 — pure arithmetic floor)."""

    def g(args):
        n = _arith_num(args[0])
        if n is None or math.isnan(n) or math.isinf(n) or n < 0:
            return None
        return math.floor(n / period) * period

    return g


def _fn_month(args):
    """Truncate to the first second of the month (value.cc FuncMonth:766,
    post-1.2.1 semantics: tm_mday=1)."""
    n = _arith_num(args[0])
    if n is None or math.isnan(n) or math.isinf(n) or n < 0:
        return None
    try:
        t = _time.gmtime(n)
    except (OverflowError, OSError, ValueError):
        return None
    return float(calendar.timegm((t.tm_year, t.tm_mon, 1, 0, 0, 0, 0, 0, 0)))


def _fn_strlen(args):
    v = args[0]
    if not isinstance(v, str):
        raise EvalError("strlen requires a string operand")
    return float(len(_b(v)))


def _case_fn(v, f):
    if v is None:
        raise EvalError("upper/lower require an operand")
    if not isinstance(v, str):
        return None  # non-string -> nil (upper_non_string_to_nil flag)
    return f(v)


def _concat(args):
    parts = [to_string(x) for x in args]
    if any(p is None for p in parts):
        raise EvalError("concat requires string operands")
    return "".join(parts)


def _fn_timefmt(args):
    if args[0] is None:
        raise EvalError("timefmt requires an operand")
    if len(args) > 1 and not isinstance(args[1], str):
        raise EvalError("timefmt format must be a string")
    fmt = args[1] if len(args) > 1 else "%FT%TZ"
    n = _arith_num(args[0])
    if n is None:
        return None  # unparsable timestamp string -> nil
    if fmt == "":
        return None  # timefmt_empty_format_to_nil compat flag
    if math.isnan(n) or math.isinf(n):
        return None
    try:
        return _time.strftime(fmt, _time.gmtime(int(n)))  # time_t trunc
    except (OverflowError, OSError, ValueError):
        return None


def _fn_parsetime(args):
    if not isinstance(args[0], str):
        raise EvalError("parsetime requires a string timestamp")
    s = args[0]
    if len(args) > 1 and not isinstance(args[1], str):
        raise EvalError("parsetime format must be a string")
    fmt = args[1] if len(args) > 1 else "%FT%TZ"
    if fmt == "":
        # C strptime with an empty format consumes nothing and succeeds,
        # leaving a zeroed tm (mday 0 → 1899-12-31)
        return -2209075200.0
    try:
        ts = float(calendar.timegm(_time.strptime(s, fmt)))
    except ValueError:
        return None  # parsetime_format_mismatch_to_nil compat flag
    if not any(d in fmt for d in ("%d", "%e", "%j", "%D", "%F", "%x", "%c", "%s")):
        ts -= 86400.0  # C strptime leaves tm_mday 0 → previous day
    return ts


def _b(s: str) -> bytes:
    # string functions operate on BYTES (reference uses string_view over the
    # raw value); surrogateescape round-trips non-UTF-8 payloads
    return s.encode("utf-8", "surrogateescape")


def _unb(b: bytes) -> str:
    return b.decode("utf-8", "surrogateescape")


def _fn_substr(args):
    """Reference FuncSubstr (value.cc:534): byte-offset substring; negative
    offset counts from the end; negative length trims from the end
    (remaining + length); out of range → empty string."""
    if not isinstance(args[0], str):
        raise EvalError("Invalid type for substr. Expected string")
    s = args[0]
    off = to_number(args[1])
    length = to_number(args[2])
    if off is None or length is None:
        raise EvalError("substr requires (string, number, number)")
    bs = _b(s)
    off = int(off)
    length = int(length)
    if off < 0:
        off += len(bs)
    if off > len(bs) or off < 0 or length == 0:
        return ""
    if length >= 0:
        return _unb(bs[off : off + length])
    remaining = len(bs) - off + length
    return "" if remaining < 0 else _unb(bs[off : off + remaining])


def _c_log(f):
    # C libm: log(0) == -inf (range error), log(<0) == nan (domain error)
    def g(n):
        if n == 0:
            return -math.inf
        if n < 0:
            return math.nan
        return f(n)

    return g


_FUNCTIONS: Dict[str, tuple] = {
    "log": (1, 1, _num1(_c_log(math.log))),
    "log2": (1, 1, _num1(_c_log(math.log2))),
    "exp": (1, 1, _num1(math.exp)),
    "abs": (1, 1, _num1(abs)),
    "ceil": (1, 1, _num1(lambda n: n if math.isinf(n) else float(math.ceil(n)))),
    "floor": (1, 1, _num1(lambda n: n if math.isinf(n) else float(math.floor(n)))),
    "sqrt": (1, 1, _num1(math.sqrt)),
    "upper": (1, 1, lambda a: _case_fn(a[0], str.upper)),
    "lower": (1, 1, lambda a: _case_fn(a[0], str.lower)),
    "startswith": (2, 2, lambda a: _strfn2(a, lambda x, y: 1.0 if _b(x).startswith(_b(y)) else 0.0)),
    "contains": (2, 2, lambda a: _strfn2(a, lambda x, y: float(_b(x).count(_b(y))) if y else float(len(_b(x)) + 1))),
    "strlen": (1, 1, lambda a: _fn_strlen(a)),
    "substr": (3, 3, _fn_substr),
    "concat": (1, 50, lambda a: _concat(a)),
    "dayofweek": (1, 1, _tm("tm_wday")),
    "dayofmonth": (1, 1, _tm("tm_mday")),
    "dayofyear": (1, 1, _tm("tm_yday")),
    "monthofyear": (1, 1, _tm("tm_mon")),
    "year": (1, 1, _tm("tm_year", adjustment=1900)),
    # day/hour/minute TRUNCATE the timestamp to the period start —
    # they do not extract components (value.cc:817-831)
    "minute": (1, 1, _round_period(60.0)),
    "hour": (1, 1, _round_period(3600.0)),
    "day": (1, 1, _round_period(86400.0)),
    "month": (1, 1, _fn_month),
    "timefmt": (1, 2, _fn_timefmt),
    "parsetime": (2, 2, _fn_parsetime),
    "exists": (1, 1, lambda a: 0.0 if a[0] is None else 1.0),
}


def _strfn2(args, f):
    if not isinstance(args[0], str) or not isinstance(args[1], str):
        raise EvalError("string function requires string operands")
    return f(args[0], args[1])


# ---------------------------------------------------------------------------
# parser (C-like precedence: || < && < relational < additive < multiplicative
# < unary < primary — search-expressions.md BNF)
# ---------------------------------------------------------------------------


class _Lexer:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.tok: Optional[str] = None
        self.val: Value = None
        self.advance()

    def advance(self):
        t = self.text
        n = len(t)
        while self.pos < n and t[self.pos] in " \t\r\n":
            self.pos += 1
        if self.pos >= n:
            self.tok = None
            return
        c = t[self.pos]
        two = t[self.pos : self.pos + 2]
        if two in ("&&", "||", "<=", ">=", "==", "!="):
            self.tok = two
            self.pos += 2
            return
        if c in "+-*/%^!<>(),":
            self.tok = c
            self.pos += 1
            return
        if c in "'\"":
            quote = c
            self.pos += 1
            out = []
            while self.pos < n and t[self.pos] != quote:
                if t[self.pos] == "\\" and self.pos + 1 < n:
                    self.pos += 1
                out.append(t[self.pos])
                self.pos += 1
            if self.pos >= n:
                raise ExprError("unterminated string constant")
            self.pos += 1
            self.tok = "str"
            self.val = "".join(out)
            return
        if c.isdigit() or (c == "." and self.pos + 1 < n and t[self.pos + 1].isdigit()):
            start = self.pos
            while self.pos < n and (t[self.pos].isdigit() or t[self.pos] in ".eE"):
                if t[self.pos] in "eE" and self.pos + 1 < n and t[self.pos + 1] in "+-":
                    self.pos += 1
                self.pos += 1
            self.tok = "num"
            lit = t[start : self.pos]
            try:
                self.val = float(lit)
            except ValueError:
                # '3e', '1..2' — must surface as an expression syntax
                # error, not a bare ValueError bypassing the typed reply
                raise ExprError(f"bad numeric literal {lit!r}")
            return
        if c in "@$":
            self.pos += 1
            start = self.pos
            while self.pos < n and (t[self.pos].isalnum() or t[self.pos] in "_."):
                self.pos += 1
            if start == self.pos:
                raise ExprError(f"expected identifier after {c!r}")
            self.tok = "field" if c == "@" else "param"
            self.val = t[start : self.pos]
            return
        if c.isalpha() or c == "_":
            start = self.pos
            while self.pos < n and (t[self.pos].isalnum() or t[self.pos] == "_"):
                self.pos += 1
            word = t[start : self.pos]
            low = word.lower()
            if low in ("inf", "infinity"):
                self.tok = "num"
                self.val = math.inf
                return
            self.tok = "ident"
            self.val = word
            return
        raise ExprError(f"bad character {c!r} in expression")


def compile_expr(text: str) -> Node:
    lx = _Lexer(text)
    node = _parse_or(lx)
    if lx.tok is not None:
        raise ExprError(f"trailing tokens in expression: {text!r}")
    return node


def _parse_or(lx):
    node = _parse_and(lx)
    while lx.tok == "||":
        lx.advance()
        node = Binary("||", node, _parse_and(lx))
    return node


def _parse_and(lx):
    node = _parse_rel(lx)
    while lx.tok == "&&":
        lx.advance()
        node = Binary("&&", node, _parse_rel(lx))
    return node


def _parse_rel(lx):
    node = _parse_add(lx)
    while lx.tok in ("<", "<=", "==", "!=", ">", ">="):
        op = lx.tok
        lx.advance()
        node = Binary(op, node, _parse_add(lx))
    return node


def _parse_add(lx):
    node = _parse_mul(lx)
    while lx.tok in ("+", "-"):
        op = lx.tok
        lx.advance()
        node = Binary(op, node, _parse_mul(lx))
    return node


def _parse_mul(lx):
    node = _parse_unary(lx)
    while lx.tok in ("*", "/", "%", "^"):
        op = lx.tok
        lx.advance()
        node = Binary(op, node, _parse_unary(lx))
    return node


def _parse_unary(lx):
    if lx.tok in ("!", "-", "+"):
        op = lx.tok
        lx.advance()
        child = _parse_unary(lx)
        if op == "+":
            return child
        return Unary(op, child)
    return _parse_primary(lx)


def _parse_primary(lx):
    tok = lx.tok
    if tok == "num":
        node = Const(float(lx.val))
        lx.advance()
        return node
    if tok == "str":
        node = Const(str(lx.val))
        lx.advance()
        return node
    if tok == "field":
        node = FieldRef(str(lx.val))
        lx.advance()
        return node
    if tok == "param":
        node = ParamRef(str(lx.val))
        lx.advance()
        return node
    if tok == "(":
        lx.advance()
        node = _parse_or(lx)
        if lx.tok != ")":
            raise ExprError("expected ')'")
        lx.advance()
        return node
    if tok == "ident":
        name = str(lx.val).lower()
        lx.advance()
        if lx.tok != "(":
            raise ExprError(f"unexpected identifier {name!r}")
        lx.advance()
        args: List[Node] = []
        if lx.tok != ")":
            args.append(_parse_or(lx))
            while lx.tok == ",":
                lx.advance()
                args.append(_parse_or(lx))
        if lx.tok != ")":
            raise ExprError("expected ')' after function args")
        lx.advance()
        return Call(name, args)
    raise ExprError(f"unexpected token {tok!r}")


class Expression:
    """Compiled expression (reference Expression::Compile, expr.h:66)."""

    def __init__(self, text: str):
        self.text = text
        self.root = compile_expr(text)

    def eval(self, record: Dict[str, Value], params: Optional[Dict] = None) -> Value:
        return self.root.eval(record, params or {})

    def identifiers(self) -> List[str]:
        """Document properties referenced by this expression. The aggregate
        pipeline implicitly resolves these from record contents (reference
        registers every parsed @field in record_indexes_by_alias_,
        ft_aggregate_parser.cc:265-270, and CreateRecordsFromNeighbors
        populates exactly the registered fields, ft_aggregate.cc:272+)."""
        out: List[str] = []

        def walk(node):
            if isinstance(node, FieldRef):
                out.append(node.name)
            for attr in ("child", "left", "right"):
                c = getattr(node, attr, None)
                if isinstance(c, Node):
                    walk(c)
            for c in getattr(node, "args", ()) or ():
                if isinstance(c, Node):
                    walk(c)

        walk(self.root)
        return out
