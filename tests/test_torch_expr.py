"""The expression engine of the port against the JAX package's.

``query/expr.py`` is host code on Python floats in both packages. Every
expression below (the cases of ``test_expr.py``, one or more per function of
the table, and the operators) is compiled and evaluated by both: equal
values (bit for bit, NaN equal to NaN) or an error of the same type with the
same message. A hypothesis run does the same over random expression trees.
The query filter expressions of ``test_filter_expressions.py`` go through
both engines' FT.SEARCH and must give equal replies.
"""

import math

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from valkey_search_tpu.query import expr as JE
from valkey_search_tpu_torch.query import expr as TE
from valkey_search_tpu_torch.runtime.device import set_device
from torch_port_both import Both


def _outcome(mod, text, record, params):
    try:
        v = mod.Expression(text).eval(dict(record), dict(params))
    except (mod.ExprError, mod.EvalError) as exc:
        return ("error", type(exc).__name__, str(exc))
    if isinstance(v, float) and math.isnan(v):
        return ("ok", "nan")
    return ("ok", type(v).__name__, v)


def _same(text, record=None, params=None):
    got = _outcome(TE, text, record or {}, params or {})
    want = _outcome(JE, text, record or {}, params or {})
    assert got == want, text
    return got


TS = "1609556645"  # 2021-01-02T03:04:05Z
RECORD = {"a": 2.0, "b": 3.0, "s": "41", "w": "xyz", "name": "Hello World",
          "neg": -7.5, "ts": float(TS), "z": 0.0, "e": ""}
PARAMS = {"p": "21", "q": "abc"}

CASES = [
    # arithmetic, precedence, nil and string coercion
    "1 + 2 * 3", "(1 + 2) * 3", "2 ^ 3 * 2", "7 % 4", "-3 + 5", "1 / 0",
    "1 % 0", "@a + @b", "@missing", "@missing + 1", "$p * 2", "$nosuch",
    "@s + 1", "@w + 1", "@a - @b * @neg", "@a / @b", "2 ^ 0.5", "-@a",
    "--@a", "1e3 + 1", ".5 * 4", "@a ^ @b ^ 2", "10 % 3 % 2", "5 - 3 - 1",
    # relational and logical
    "2 < 3", "3 <= 3", "4 > 5", "5 >= 5", "1 != 2", "'abc' == 'abc'",
    "'10' == 10", "'abc' < 'abd'", "@x == @y", "@x < 5", "@s == 41",
    "@w == 'xyz'", "1 && 2", "0 || 0", "1 || 0", "0 && 1", "!0", "!1",
    "!'hello'", "!''", "@a && @missing", "@z || @a", "!(@a < @b)",
    "@a < @b && @b < 4 || 0",
    # numeric functions
    "sqrt(16)", "sqrt(-1)", "abs(-3)", "abs(@neg)", "floor(2.7)",
    "floor(-2.5)", "ceil(2.1)", "ceil(-2.1)", "ceil(inf)", "floor(-inf)",
    "log(exp(1))", "log(0)", "log(-1)", "log2(8)", "log2(0)", "exp(0)",
    "exp(1000)", "sqrt('abc')", "abs('x')", "sqrt(@missing)",
    # string functions
    "upper('abc')", "lower('AbC')", "upper(5)", "lower(@missing)",
    "strlen('hello')", "strlen(@name)", "strlen(12)", "strlen(@missing)",
    "startswith('hello', 'he')", "startswith('hello', 'lo')",
    "startswith(@name, 'Hello')", "contains('banana', 'an')",
    "contains('banana', '')", "contains('banana', 'x')",
    "substr('hello', 1, 3)", "substr('hello', 1, -1)",
    "substr('hello', -3, 2)", "substr('hello', 10, 2)",
    "substr('hello', 0, 100)", "substr(@name, 6, 5)",
    "concat('a', 'b', 'c')", "concat(@name, '!', 1)", "concat(@missing)",
    "concat('x')", "upper(concat(@q, $q))",
    # exists and the time functions
    "exists(@a)", "exists(@missing)", f"year({TS})", f"month({TS})",
    f"day({TS})", f"hour({TS})", f"minute({TS})", f"dayofmonth({TS})",
    f"dayofyear({TS})", f"monthofyear({TS})", f"dayofweek({TS})",
    "day(-1)", "year(-1)", "month(-5)", "hour(@ts)", "year('x')",
    f"timefmt({TS}, '%Y-%m-%d')", f"timefmt({TS})", "timefmt(@ts, '%H:%M')",
    "timefmt('x')", "parsetime('2021-01-02', '%Y-%m-%d')",
    "parsetime('nonsense', '%Y-%m-%d')", "parsetime(@missing, '%Y')",
    # constants and errors
    "inf", "-inf", "+inf", "1 +", "foo(", "nosuchfn(1)", "(1", "@",
    "'unterminated", "sqrt()", "sqrt(1, 2)", "substr('a')", "1 2", ")",
    "concat()", "a b", "1 ++ 2", "@a @b", "'a' + 1", "1 + 'a'", "$",
]


@pytest.mark.parametrize("text", CASES)
def test_expression_matches_the_reference(text):
    _same(text, RECORD, PARAMS)


def test_every_function_of_the_table_is_covered():
    assert sorted(TE._FUNCTIONS) == sorted(JE._FUNCTIONS)
    for name in JE._FUNCTIONS:
        assert any(f"{name}(" in c for c in CASES), name


def test_values_of_the_reference_tests():
    # the literal expectations of test_expr.py hold for the port as well
    assert _same("1 + 2 * 3") == ("ok", "float", 7.0)
    assert _same("contains('banana', 'an')") == ("ok", "float", 2.0)
    assert _same("substr('hello', 1, -1)") == ("ok", "str", "ell")
    assert _same(f"month({TS})") == ("ok", "float", 1609459200.0)
    assert _same("1 / 0") == ("ok", "nan")
    assert _same("@missing") == ("ok", "NoneType", None)
    assert _same("@missing + 1")[:2] == ("error", "EvalError")
    assert _same("1 +")[:2] == ("error", "ExprError")


def test_helpers_match_the_reference():
    for v in (None, 1.0, 2.5, -0.0, 1e21, 1e-7, math.inf, -math.inf,
              math.nan, "12", " 3 ", "x", "", "1e5", "0x10", "inf", "nan"):
        for fn in ("to_number", "to_string", "truthy"):
            got, want = getattr(TE, fn)(v), getattr(JE, fn)(v)
            if isinstance(want, float) and math.isnan(want):
                assert math.isnan(got), (fn, v)
            else:
                assert got == want, (fn, v)
    assert TE.compile_expr("1 + @a").eval({"a": 1.0}, {}) == \
        JE.compile_expr("1 + @a").eval({"a": 1.0}, {}) == 2.0


# -- random expression trees -------------------------------------------------

_atoms = st.one_of(
    st.sampled_from(["@a", "@b", "@s", "@w", "@missing", "@neg", "@z", "$p",
                     "$q", "'abc'", "'10'", "''", "inf", "0", "1", "2.5",
                     "-3", TS, "'2021-01-02'", "'%Y'"]),
    st.integers(-5, 5).map(str),
    st.floats(-100, 100, allow_nan=False).map(lambda f: f"{f:.3f}"),
)
_BIN = ["+", "-", "*", "/", "%", "^", "<", "<=", ">", ">=", "==", "!=",
        "&&", "||"]
_F1 = ["log", "log2", "exp", "abs", "ceil", "floor", "sqrt", "upper",
       "lower", "strlen", "dayofweek", "dayofmonth", "dayofyear",
       "monthofyear", "year", "minute", "hour", "day", "month", "timefmt",
       "exists", "concat"]
_F2 = ["startswith", "contains", "parsetime", "timefmt", "concat"]


def _extend(children):
    return st.one_of(
        st.tuples(children, st.sampled_from(_BIN), children).map(
            lambda t: f"({t[0]} {t[1]} {t[2]})"),
        st.tuples(st.sampled_from(["-", "!"]), children).map(
            lambda t: f"{t[0]}{t[1]}"),
        st.tuples(st.sampled_from(_F1), children).map(
            lambda t: f"{t[0]}({t[1]})"),
        st.tuples(st.sampled_from(_F2), children, children).map(
            lambda t: f"{t[0]}({t[1]}, {t[2]})"),
        st.tuples(children, children, children).map(
            lambda t: f"substr({t[0]}, {t[1]}, {t[2]})"),
    )


@settings(max_examples=400, deadline=None, derandomize=True)
@given(st.recursive(_atoms, _extend, max_leaves=8))
def test_random_expressions_match_the_reference(text):
    _same(text, RECORD, PARAMS)


# -- query filter expressions through both engines ------------------------------

COUNTRIES = ["USA", "GBR", "CAN", "FRA", "DEU"]

FILTERS = [
    "@country:{USA|GBR|CAN}", "@country:{FRA}",
    "@country:{USA|GBR|CAN|FRA|DEU}", "-@country:{USA}",
    "(-@country:{USA} @n:[5 15])",
    "@country:{USA} | @country:{GBR} @n:[0 4]",
    "(@country:{USA} | @country:{GBR}) @n:[0 4]",
    "@n:[5 10]", "@n:[(5 10]", "@n:[5 (10]", "@n:[(5 (10]", "@n:[5 +inf]",
    "@n:[(5 +inf]", "@n:[-inf 5]", "@n:[-inf (5]", "@n:[7 7]",
    "(-@country:{USA} -@country:{GBR} @n:[0 9])",
    "((@country:{USA}|@country:{GBR})|(@country:{CAN}|@country:{FRA}))",
    "(-@country:{USA} (@n:[-inf (5] | @n:[15 +inf]))",
    r"@country:{we\}ird}", "@country:{us*}", "@country:{", "@n:[5",
    "@nosuch:{x}", "@n:{x}", "@country:[1 2]",
]


@pytest.fixture(scope="module")
def engines():
    set_device("cpu")
    both = Both()
    both.same("FT.CREATE", "idx", "ON", "HASH", "PREFIX", "1", "d:", "SCHEMA",
              "country", "TAG", "n", "NUMERIC", "v", "VECTOR", "FLAT", "6",
              "TYPE", "FLOAT32", "DIM", "3", "DISTANCE_METRIC", "L2")
    for i in range(20):
        both.same("HSET", f"d:{i}", "country", COUNTRIES[i % 5], "n", str(i),
                  "v", np.float32([i, 0, 0]).tobytes())
    both.same("HSET", "d:esc", "country", "we}ird", "n", "99", "v",
              np.float32([9, 9, 9]).tobytes())
    return both


@pytest.mark.parametrize("query", FILTERS)
def test_filter_expression_matches_the_reference(engines, query):
    engines.same("FT.SEARCH", "idx", query, "NOCONTENT", "LIMIT", "0", "100")
    q = np.float32([1.25, 0, 0]).tobytes()  # no two rows at one distance
    engines.close("FT.SEARCH", "idx", f"({query})=>[KNN 3 @v $q]", "PARAMS",
                  "2", "q", q, "RETURN", "1", "__v_score")


def test_tag_separator_and_large_union_match_the_reference(engines):
    engines.same("FT.CREATE", "sep", "ON", "HASH", "PREFIX", "1", "p:",
                 "SCHEMA", "tags", "TAG", "SEPARATOR", ",")
    for i, tags in enumerate(["red,large", "blue,small", "red,small",
                              "green,large"]):
        engines.same("HSET", f"p:{i}", "tags", tags)
    assert engines.same("FT.SEARCH", "sep", "@tags:{red|blue}",
                        "NOCONTENT")[0] == 3
    assert engines.same("FT.SEARCH", "sep", "@tags:{large|small}",
                        "NOCONTENT")[0] == 4
    engines.same("FT.CREATE", "big", "ON", "HASH", "PREFIX", "1", "b:",
                 "SCHEMA", "t", "TAG")
    for i in range(64):
        engines.same("HSET", f"b:{i}", "t", f"tag{i}")
    union = "|".join(f"tag{i}" for i in range(1000))
    assert engines.same("FT.SEARCH", "big", "@t:{%s}" % union, "NOCONTENT",
                        "LIMIT", "0", "100")[0] == 64
