"""Lua 5.1 interpreter for EVAL/EVALSHA scripting.

The reference module rides valkey-server's complete Lua VM
(valkey-search's integration/test_multi_lua.py drives FT.* commands and
ingest-then-query scripts through EVAL; valkey itself embeds Lua 5.1).
This standalone engine therefore carries its own interpreter: a lexer,
a recursive-descent parser, and a tree-walking evaluator implementing
the Lua 5.1 language subset that redis scripting exposes —

  values       nil, boolean, number (C double), string (byte string),
               table (unified array+hash), function (closures)
  statements   local / multiple assignment, if/elseif/else, while,
               repeat..until, numeric and generic for, break, return,
               do..end, function definitions (incl. methods)
  expressions  full operator set (.. # and or not == ~= <= etc. with
               Lua coercion rules), table constructors, method calls,
               varargs-free closures with upvalues
  stdlib       base (type/tonumber/tostring/pairs/ipairs/next/select/
               error/assert/pcall/unpack/raw*), string (incl. the Lua
               pattern engine: find/match/gmatch/gsub/format/...),
               table, math, bit, cjson
  redis API    redis.call/pcall (wired to the engine by the caller),
               status_reply/error_reply/sha1hex/log, KEYS/ARGV

Sandboxing follows redis: no os/io/debug/load/require, deterministic
math.random (seeded per script run), and a step budget so a hostile
`while true do end` terminates with an error instead of wedging the
server. Deliberately out of scope (documented in docs/PARITY.md):
metatables, coroutines, goto, struct/cmsgpack. Strings are Python
`bytes` throughout — binary-safe exactly like Lua's.

The port's own copy of valkey_search_tpu/server/lua.py, with its imports
pointing into valkey_search_tpu_torch.
"""

from __future__ import annotations

import hashlib
import json
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "LuaError", "LuaTable", "LuaRuntime", "compile_script",
    "lua_to_resp", "resp_to_lua",
]


class LuaError(Exception):
    """A Lua error value in flight (error(), runtime faults, budget)."""

    def __init__(self, value):
        self.value = value  # Lua value; usually a bytes message
        msg = value
        if isinstance(value, LuaTable):  # error tables carry .err
            msg = value.data.get(b"err", b"table error")
        super().__init__(_tostr(msg))


class _Break(Exception):
    pass


class _Return(Exception):
    def __init__(self, values):
        self.values = values  # List of Lua values


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_KEYWORDS = {
    "and", "break", "do", "else", "elseif", "end", "false", "for",
    "function", "if", "in", "local", "nil", "not", "or", "repeat",
    "return", "then", "true", "until", "while",
}

_SYMBOLS = [
    "...", "..", "==", "~=", "<=", ">=", "+", "-", "*", "/", "%", "^",
    "#", "<", ">", "=", "(", ")", "{", "}", "[", "]", ";", ":", ",", ".",
]

_ESCAPES = {
    b"n": b"\n", b"t": b"\t", b"r": b"\r", b"a": b"\a", b"b": b"\b",
    b"f": b"\f", b"v": b"\v", b"\\": b"\\", b'"': b'"', b"'": b"'",
    b"\n": b"\n",
}


class _Tok:
    __slots__ = ("kind", "val", "line")

    def __init__(self, kind, val, line):
        self.kind = kind  # name|number|string|sym|kw|eof
        self.val = val
        self.line = line

    def __repr__(self):  # pragma: no cover - debug aid
        return f"<{self.kind} {self.val!r} @{self.line}>"


def _lex(src: str) -> List[_Tok]:
    b = src.encode("utf-8", "surrogateescape")
    toks: List[_Tok] = []
    i, n, line = 0, len(b), 1

    def err(msg):
        raise LuaError(f"lua parse error: {msg} near line {line}".encode())

    def long_bracket(j):
        # at b[j] == '[': returns (level, body_start) or None
        k = j + 1
        while k < n and b[k:k + 1] == b"=":
            k += 1
        if k < n and b[k:k + 1] == b"[":
            return k - j - 1, k + 1
        return None

    def read_long(level, j):
        nonlocal line
        close = b"]" + b"=" * level + b"]"
        end = b.find(close, j)
        if end < 0:
            err("unterminated long string/comment")
        body = b[j:end]
        line += body.count(b"\n")
        if body.startswith(b"\n"):  # Lua drops a leading newline
            body = body[1:]
        return body, end + len(close)

    while i < n:
        c = b[i:i + 1]
        if c in b" \t\r":
            i += 1
            continue
        if c == b"\n":
            line += 1
            i += 1
            continue
        if b[i:i + 2] == b"--":
            lb = long_bracket(i + 2) if b[i + 2:i + 3] == b"[" else None
            if lb is not None:
                _, i = read_long(lb[0], lb[1])
            else:
                j = b.find(b"\n", i)
                i = n if j < 0 else j
            continue
        if c == b"[":
            lb = long_bracket(i)
            if lb is not None:
                body, i = read_long(lb[0], lb[1])
                toks.append(_Tok("string", body, line))
                continue
        if c in b"'\"":
            q = c
            j = i + 1
            out = bytearray()
            while True:
                if j >= n:
                    err("unterminated string")
                ch = b[j:j + 1]
                if ch == q:
                    break
                if ch == b"\n":
                    err("unterminated string")
                if ch == b"\\":
                    nxt = b[j + 1:j + 2]
                    if nxt in _ESCAPES:
                        out += _ESCAPES[nxt]
                        if nxt == b"\n":
                            line += 1
                        j += 2
                    elif nxt.isdigit():
                        k = j + 1
                        num = 0
                        cnt = 0
                        while k < n and cnt < 3 and b[k:k + 1].isdigit():
                            num = num * 10 + int(b[k:k + 1])
                            k += 1
                            cnt += 1
                        if num > 255:
                            err("decimal escape too large")
                        out.append(num)
                        j = k
                    elif nxt == b"x":  # 5.2 extension, accepted leniently
                        out.append(int(b[j + 2:j + 4], 16))
                        j += 4
                    else:
                        err(f"invalid escape \\{nxt.decode('latin1')}")
                else:
                    out += ch
                    j += 1
            toks.append(_Tok("string", bytes(out), line))
            i = j + 1
            continue
        if c.isdigit() or (c == b"." and b[i + 1:i + 2].isdigit()):
            j = i
            if b[i:i + 2].lower() == b"0x":
                j = i + 2
                while j < n and (b[j:j + 1].isdigit()
                                 or b[j:j + 1].lower() in b"abcdef"):
                    j += 1
                val = float(int(b[i:j], 16))
            else:
                while j < n and b[j:j + 1].isdigit():
                    j += 1
                if b[j:j + 1] == b".":
                    j += 1
                    while j < n and b[j:j + 1].isdigit():
                        j += 1
                if b[j:j + 1].lower() == b"e":
                    j += 1
                    if b[j:j + 1] in b"+-":
                        j += 1
                    if not b[j:j + 1].isdigit():
                        err("malformed number")
                    while j < n and b[j:j + 1].isdigit():
                        j += 1
                try:
                    val = float(b[i:j])
                except ValueError:
                    err("malformed number")
            toks.append(_Tok("number", val, line))
            i = j
            continue
        if c.isalpha() or c == b"_":
            j = i
            while j < n and (b[j:j + 1].isalnum() or b[j:j + 1] == b"_"):
                j += 1
            word = b[i:j].decode()
            toks.append(_Tok("kw" if word in _KEYWORDS else "name",
                             word, line))
            i = j
            continue
        for sym in _SYMBOLS:
            if b[i:i + len(sym)].decode("latin1") == sym:
                toks.append(_Tok("sym", sym, line))
                i += len(sym)
                break
        else:
            err(f"unexpected character {c.decode('latin1')!r}")
    toks.append(_Tok("eof", None, line))
    return toks


# ---------------------------------------------------------------------------
# Parser -> AST (tuples: (op, ...); expressions and statements share space)
# ---------------------------------------------------------------------------

_BINPRI = {  # (left, right) binding powers; right<left => right-assoc
    "or": (1, 1), "and": (2, 2),
    "<": (3, 3), ">": (3, 3), "<=": (3, 3), ">=": (3, 3),
    "~=": (3, 3), "==": (3, 3),
    "..": (9, 8),  # right associative
    "+": (10, 10), "-": (10, 10),
    "*": (11, 11), "/": (11, 11), "%": (11, 11),
    "^": (14, 13),  # right associative
}
_UNARY_PRI = 12


class _Parser:
    # nesting ceiling (LUAI_MAXCCALLS analog): without it ~400 nested
    # parens escape as a Python RecursionError instead of a parse error.
    # 120, not lua's 200: each level costs ~6 Python frames and the guard
    # must trip inside CPython's default 1000-frame recursion limit.
    MAX_DEPTH = 120

    def __init__(self, toks: List[_Tok]):
        self.toks = toks
        self.i = 0
        self.depth = 0

    def _enter(self):
        self.depth += 1
        if self.depth > self.MAX_DEPTH:
            raise LuaError(b"lua parse error: chunk has too many syntax levels")

    # -- helpers ------------------------------------------------------------
    def peek(self) -> _Tok:
        return self.toks[self.i]

    def next(self) -> _Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def err(self, msg):
        t = self.peek()
        raise LuaError(
            f"lua parse error: {msg} near "
            f"{t.val if t.kind != 'eof' else '<eof>'} (line {t.line})"
            .encode())

    def check(self, kind, val=None) -> bool:
        t = self.peek()
        return t.kind == kind and (val is None or t.val == val)

    def accept(self, kind, val=None) -> Optional[_Tok]:
        if self.check(kind, val):
            return self.next()
        return None

    def expect(self, kind, val=None) -> _Tok:
        if not self.check(kind, val):
            self.err(f"expected {val or kind}")
        return self.next()

    # -- grammar ------------------------------------------------------------
    def parse_chunk(self):
        body = self.parse_block()
        if not self.check("eof"):
            self.err("unexpected token")
        return body

    def parse_block(self):
        stmts = []
        while True:
            if self.accept("sym", ";"):
                continue
            t = self.peek()
            if t.kind == "kw" and t.val in (
                    "end", "else", "elseif", "until") or t.kind == "eof":
                return stmts
            if t.kind == "kw" and t.val == "return":
                self.next()
                exprs = []
                t2 = self.peek()
                if not (t2.kind == "eof" or t2.kind == "kw" and t2.val in
                        ("end", "else", "elseif", "until")) \
                        and not self.check("sym", ";"):
                    exprs = self.parse_exprlist()
                self.accept("sym", ";")
                stmts.append(("return", exprs))
                return stmts
            if t.kind == "kw" and t.val == "break":
                self.next()
                self.accept("sym", ";")
                stmts.append(("break",))
                # 5.1: break must end the block
                return stmts
            stmts.append(self.parse_statement())

    def parse_statement(self):
        t = self.peek()
        if t.kind == "kw":
            if t.val == "do":
                self.next()
                body = self.parse_block()
                self.expect("kw", "end")
                return ("do", body)
            if t.val == "while":
                self.next()
                cond = self.parse_expr()
                self.expect("kw", "do")
                body = self.parse_block()
                self.expect("kw", "end")
                return ("while", cond, body)
            if t.val == "repeat":
                self.next()
                body = self.parse_block()
                self.expect("kw", "until")
                cond = self.parse_expr()
                return ("repeat", body, cond)
            if t.val == "if":
                self.next()
                arms = []
                cond = self.parse_expr()
                self.expect("kw", "then")
                arms.append((cond, self.parse_block()))
                els = []
                while True:
                    if self.accept("kw", "elseif"):
                        c2 = self.parse_expr()
                        self.expect("kw", "then")
                        arms.append((c2, self.parse_block()))
                        continue
                    if self.accept("kw", "else"):
                        els = self.parse_block()
                    self.expect("kw", "end")
                    break
                return ("if", arms, els)
            if t.val == "for":
                self.next()
                name = self.expect("name").val
                if self.accept("sym", "="):
                    start = self.parse_expr()
                    self.expect("sym", ",")
                    stop = self.parse_expr()
                    step = None
                    if self.accept("sym", ","):
                        step = self.parse_expr()
                    self.expect("kw", "do")
                    body = self.parse_block()
                    self.expect("kw", "end")
                    return ("fornum", name, start, stop, step, body)
                names = [name]
                while self.accept("sym", ","):
                    names.append(self.expect("name").val)
                self.expect("kw", "in")
                exprs = self.parse_exprlist()
                self.expect("kw", "do")
                body = self.parse_block()
                self.expect("kw", "end")
                return ("forin", names, exprs, body)
            if t.val == "function":
                self.next()
                # funcname: Name {'.' Name} [':' Name]
                target = ("name", self.expect("name").val)
                is_method = False
                while True:
                    if self.accept("sym", "."):
                        target = ("index", target,
                                  ("const", _b(self.expect("name").val)))
                        continue
                    if self.accept("sym", ":"):
                        target = ("index", target,
                                  ("const", _b(self.expect("name").val)))
                        is_method = True
                    break
                fn = self.parse_funcbody(is_method)
                return ("assign", [target], [fn])
            if t.val == "local":
                self.next()
                if self.accept("kw", "function"):
                    name = self.expect("name").val
                    fn = self.parse_funcbody(False)
                    return ("localfunc", name, fn)
                names = [self.expect("name").val]
                while self.accept("sym", ","):
                    names.append(self.expect("name").val)
                exprs = []
                if self.accept("sym", "="):
                    exprs = self.parse_exprlist()
                return ("local", names, exprs)
        # expression statement: assignment or call
        e = self.parse_suffixed()
        if self.check("sym", "=") or self.check("sym", ","):
            targets = [e]
            while self.accept("sym", ","):
                targets.append(self.parse_suffixed())
            self.expect("sym", "=")
            exprs = self.parse_exprlist()
            for tgt in targets:
                if tgt[0] not in ("name", "index"):
                    self.err("cannot assign to this expression")
            return ("assign", targets, exprs)
        if e[0] not in ("call", "method"):
            self.err("syntax error (expected statement)")
        return ("exprstat", e)

    def parse_exprlist(self):
        out = [self.parse_expr()]
        while self.accept("sym", ","):
            out.append(self.parse_expr())
        return out

    def parse_funcbody(self, is_method):
        self.expect("sym", "(")
        params = ["self"] if is_method else []
        if not self.check("sym", ")"):
            while True:
                if self.accept("sym", "..."):
                    params.append("...")
                    break
                params.append(self.expect("name").val)
                if not self.accept("sym", ","):
                    break
        self.expect("sym", ")")
        body = self.parse_block()
        self.expect("kw", "end")
        return ("function", params, body)

    def parse_expr(self, limit=0):
        self._enter()
        try:
            return self._parse_expr_inner(limit)
        finally:
            self.depth -= 1

    def _parse_expr_inner(self, limit=0):
        t = self.peek()
        if t.kind == "kw" and t.val == "not":
            self.next()
            e = ("unop", "not", self.parse_expr(_UNARY_PRI))
        elif t.kind == "sym" and t.val == "-":
            self.next()
            e = ("unop", "-", self.parse_expr(_UNARY_PRI))
        elif t.kind == "sym" and t.val == "#":
            self.next()
            e = ("unop", "#", self.parse_expr(_UNARY_PRI))
        else:
            e = self.parse_simple()
        while True:
            t = self.peek()
            op = t.val if (t.kind == "sym" or
                           (t.kind == "kw" and t.val in ("and", "or"))) \
                else None
            pri = _BINPRI.get(op)
            if pri is None or pri[0] <= limit:
                return e
            self.next()
            rhs = self.parse_expr(pri[1])
            e = ("binop", op, e, rhs)

    def parse_simple(self):
        t = self.peek()
        if t.kind == "number":
            self.next()
            return ("const", t.val)
        if t.kind == "string":
            self.next()
            return ("const", t.val)
        if t.kind == "kw":
            if t.val == "nil":
                self.next()
                return ("const", None)
            if t.val == "true":
                self.next()
                return ("const", True)
            if t.val == "false":
                self.next()
                return ("const", False)
            if t.val == "function":
                self.next()
                return self.parse_funcbody(False)
        if t.kind == "sym" and t.val == "{":
            return self.parse_table()
        if t.kind == "sym" and t.val == "...":
            self.next()
            return ("vararg",)
        return self.parse_suffixed()

    def parse_primary(self):
        t = self.peek()
        if t.kind == "name":
            self.next()
            return ("name", t.val)
        if self.accept("sym", "("):
            e = self.parse_expr()
            self.expect("sym", ")")
            return ("paren", e)
        self.err("unexpected symbol")

    def parse_suffixed(self):
        e = self.parse_primary()
        while True:
            t = self.peek()
            if t.kind == "sym" and t.val == ".":
                self.next()
                name = self.expect("name").val
                e = ("index", e, ("const", _b(name)))
            elif t.kind == "sym" and t.val == "[":
                self.next()
                k = self.parse_expr()
                self.expect("sym", "]")
                e = ("index", e, k)
            elif t.kind == "sym" and t.val == ":":
                self.next()
                name = self.expect("name").val
                args = self.parse_args()
                e = ("method", e, _b(name), args)
            elif (t.kind == "sym" and t.val in ("(", "{")) or \
                    t.kind == "string":
                args = self.parse_args()
                e = ("call", e, args)
            else:
                return e

    def parse_args(self):
        t = self.peek()
        if t.kind == "string":
            self.next()
            return [("const", t.val)]
        if t.kind == "sym" and t.val == "{":
            return [self.parse_table()]
        self.expect("sym", "(")
        args = []
        if not self.check("sym", ")"):
            args = self.parse_exprlist()
        self.expect("sym", ")")
        return args

    def parse_table(self):
        self.expect("sym", "{")
        items = []  # ("item", expr) | ("pair", kexpr, vexpr)
        while not self.check("sym", "}"):
            t = self.peek()
            if t.kind == "sym" and t.val == "[":
                self.next()
                k = self.parse_expr()
                self.expect("sym", "]")
                self.expect("sym", "=")
                items.append(("pair", k, self.parse_expr()))
            elif t.kind == "name" and \
                    self.toks[self.i + 1].kind == "sym" and \
                    self.toks[self.i + 1].val == "=":
                self.next()
                self.next()
                items.append(("pair", ("const", _b(t.val)),
                              self.parse_expr()))
            else:
                items.append(("item", self.parse_expr()))
            if not (self.accept("sym", ",") or self.accept("sym", ";")):
                break
        self.expect("sym", "}")
        return ("table", items)


# ---------------------------------------------------------------------------
# Values
# ---------------------------------------------------------------------------

def _b(s: str) -> bytes:
    return s.encode("utf-8", "surrogateescape")


def _numkey(k):
    """Normalize 1.0 and 1 to the same table key (Lua number keys)."""
    if isinstance(k, float) and k.is_integer():
        return int(k)
    return k


class LuaTable:
    __slots__ = ("data",)

    def __init__(self):
        self.data: Dict[Any, Any] = {}

    def get(self, k):
        if k is None:
            return None
        return self.data.get(_numkey(k))

    def set(self, k, v):
        if k is None:
            raise LuaError(b"table index is nil")
        if isinstance(k, float) and math.isnan(k):
            raise LuaError(b"table index is NaN")
        k = _numkey(k)
        if v is None:
            self.data.pop(k, None)
        else:
            self.data[k] = v

    def length(self) -> int:
        n = 0
        while (n + 1) in self.data:
            n += 1
        return n

    def arr(self) -> List[Any]:
        out = []
        i = 1
        while i in self.data:
            out.append(self.data[i])
            i += 1
        return out

    @staticmethod
    def from_list(vals) -> "LuaTable":
        t = LuaTable()
        for i, v in enumerate(vals):
            if v is not None:
                t.data[i + 1] = v
        return t


class _LuaFunction:
    __slots__ = ("params", "body", "env", "name")

    def __init__(self, params, body, env, name="?"):
        self.params = params
        self.body = body
        self.env = env
        self.name = name


def _truthy(v) -> bool:
    return v is not None and v is not False


def _type_name(v) -> str:
    if v is None:
        return "nil"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, bytes):
        return "string"
    if isinstance(v, LuaTable):
        return "table"
    if isinstance(v, _CJsonNull):
        return "userdata"
    return "function"


def _fmt_num(x: float) -> bytes:
    if isinstance(x, int) or (isinstance(x, float) and x.is_integer()
                              and abs(x) < 1e16):
        return b"%d" % int(x)
    if math.isinf(x):
        return b"-inf" if x < 0 else b"inf"
    if math.isnan(x):
        return b"nan"
    return ("%.14g" % x).encode()


def _tostr(v) -> str:
    if isinstance(v, bytes):
        return v.decode("utf-8", "surrogateescape")
    return str(v)


def _lua_tostring(v) -> bytes:
    if v is None:
        return b"nil"
    if isinstance(v, bool):
        return b"true" if v else b"false"
    if isinstance(v, (int, float)):
        return _fmt_num(v)
    if isinstance(v, bytes):
        return v
    if isinstance(v, LuaTable):
        return ("table: 0x%012x" % (id(v) & 0xFFFFFFFFFFFF)).encode()
    return ("function: 0x%012x" % (id(v) & 0xFFFFFFFFFFFF)).encode()


def _lua_tonumber(v, base=None):
    if base is not None:
        if not isinstance(v, bytes):
            return None
        try:
            return float(int(v.strip(), int(base)))
        except ValueError:
            return None
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, bytes):
        s = v.strip()
        try:
            if s[:2].lower() == b"0x" or s[:3].lower() in (b"-0x", b"+0x"):
                return float(int(s, 16))
            return float(s)
        except ValueError:
            return None
    return None


def _arith_num(v, op):
    n = _lua_tonumber(v)
    if n is None:
        raise LuaError(
            f"attempt to perform arithmetic ({op}) on a "
            f"{_type_name(v)} value".encode())
    return n


# ---------------------------------------------------------------------------
# Lua pattern matching (string.find/match/gmatch/gsub)
# ---------------------------------------------------------------------------

class _PatMatcher:
    """The classic lstrlib.c matcher: %-classes, sets, captures, anchors,
    quantifiers * + - ?, %b balanced match, %f frontier, %1-%9 backrefs."""

    SPECIALS = b"^$*+?.([%-"

    def __init__(self, s: bytes, p: bytes):
        self.s = s
        self.p = p
        self.caps: List[Tuple[int, int]] = []  # (start, len) len=-1 open,
        #                                        len=-2 position capture
        self.depth = 0

    def class_match(self, c: int, cl: int) -> bool:
        ch = chr(cl).lower()
        if ch == "a":
            res = chr(c).isalpha() and c < 128
        elif ch == "c":
            res = c < 32 or c == 127
        elif ch == "d":
            res = 48 <= c <= 57
        elif ch == "l":
            res = 97 <= c <= 122
        elif ch == "p":
            res = 33 <= c <= 47 or 58 <= c <= 64 or 91 <= c <= 96 \
                or 123 <= c <= 126
        elif ch == "s":
            res = c in (32, 9, 10, 11, 12, 13)
        elif ch == "u":
            res = 65 <= c <= 90
        elif ch == "w":
            res = (48 <= c <= 57) or (65 <= c <= 90) or (97 <= c <= 122)
        elif ch == "x":
            res = (48 <= c <= 57) or (65 <= c <= 70) or (97 <= c <= 102)
        elif ch == "z":
            res = c == 0
        else:
            return chr(cl) == chr(c)
        if chr(cl).isupper():
            return not res
        return res

    def class_end(self, pp: int) -> int:
        p = self.p
        c = p[pp:pp + 1]
        pp += 1
        if c == b"%":
            if pp >= len(p):
                raise LuaError(b"malformed pattern (ends with '%')")
            return pp + 1
        if c == b"[":
            if p[pp:pp + 1] == b"^":
                pp += 1
            while True:
                if pp >= len(p):
                    raise LuaError(b"malformed pattern (missing ']')")
                cc = p[pp:pp + 1]
                pp += 1
                if cc == b"%":
                    pp += 1
                elif cc == b"]":
                    return pp
        return pp

    def single_match(self, sp: int, pp: int, ep: int) -> bool:
        if sp >= len(self.s):
            return False
        c = self.s[sp]
        pc = self.p[pp:pp + 1]
        if pc == b".":
            return True
        if pc == b"%":
            return self.class_match(c, self.p[pp + 1])
        if pc == b"[":
            return self.set_match(c, pp, ep - 1)
        return self.p[pp] == c

    def set_match(self, c: int, pp: int, ec: int) -> bool:
        neg = False
        pp += 1
        if self.p[pp:pp + 1] == b"^":
            neg = True
            pp += 1
        while pp < ec:
            if self.p[pp:pp + 1] == b"%":
                pp += 1
                if self.class_match(c, self.p[pp]):
                    return not neg
                pp += 1
            elif self.p[pp + 1:pp + 2] == b"-" and pp + 2 < ec:
                if self.p[pp] <= c <= self.p[pp + 2]:
                    return not neg
                pp += 3
            else:
                if self.p[pp] == c:
                    return not neg
                pp += 1
        return neg

    def match(self, sp: int, pp: int) -> int:
        self.depth += 1
        if self.depth > 220:
            raise LuaError(b"pattern too complex")
        try:
            while True:
                if pp >= len(self.p):
                    return sp
                pc = self.p[pp:pp + 1]
                if pc == b"(":
                    if self.p[pp + 1:pp + 2] == b")":  # position capture
                        self.caps.append((sp, -2))
                        r = self.match(sp, pp + 2)
                        if r < 0:
                            self.caps.pop()
                        return r
                    self.caps.append((sp, -1))
                    r = self.match(sp, pp + 1)
                    if r < 0:
                        self.caps.pop()
                    return r
                if pc == b")":
                    for idx in range(len(self.caps) - 1, -1, -1):
                        if self.caps[idx][1] == -1:
                            st = self.caps[idx][0]
                            self.caps[idx] = (st, sp - st)
                            r = self.match(sp, pp + 1)
                            if r < 0:
                                self.caps[idx] = (st, -1)
                            return r
                    raise LuaError(b"invalid pattern capture")
                if pc == b"$" and pp + 1 == len(self.p):
                    return sp if sp == len(self.s) else -1
                if pc == b"%":
                    nxt = self.p[pp + 1:pp + 2]
                    if nxt == b"b":
                        if sp >= len(self.s) or \
                                self.s[sp] != self.p[pp + 2]:
                            return -1
                        o, cch = self.p[pp + 2], self.p[pp + 3]
                        bal = 1
                        j = sp + 1
                        while j < len(self.s):
                            if self.s[j] == cch:
                                bal -= 1
                                if bal == 0:
                                    return self.match(j + 1, pp + 4)
                            elif self.s[j] == o:
                                bal += 1
                            j += 1
                        return -1
                    if nxt == b"f":
                        pp += 2
                        if self.p[pp:pp + 1] != b"[":
                            raise LuaError(
                                b"missing '[' after %f in pattern")
                        ep = self.class_end(pp)
                        prev = self.s[sp - 1] if sp > 0 else 0
                        cur = self.s[sp] if sp < len(self.s) else 0
                        if (not self.set_match(prev, pp, ep - 1)
                                and self.set_match(cur, pp, ep - 1)):
                            pp = ep
                            continue
                        return -1
                    if nxt.isdigit():  # backreference
                        idx = int(nxt) - 1
                        if idx >= len(self.caps) or self.caps[idx][1] < 0:
                            raise LuaError(b"invalid capture index")
                        st, ln = self.caps[idx]
                        cap = self.s[st:st + ln]
                        if self.s[sp:sp + ln] == cap:
                            sp += ln
                            pp += 2
                            continue
                        return -1
                ep = self.class_end(pp)
                quant = self.p[ep:ep + 1]
                if quant == b"?":
                    if self.single_match(sp, pp, ep):
                        r = self.match(sp + 1, ep + 1)
                        if r >= 0:
                            return r
                    pp = ep + 1
                    continue
                if quant == b"+":
                    if not self.single_match(sp, pp, ep):
                        return -1
                    sp += 1
                    return self.max_expand(sp, pp, ep)
                if quant == b"*":
                    return self.max_expand(sp, pp, ep)
                if quant == b"-":
                    return self.min_expand(sp, pp, ep)
                if not self.single_match(sp, pp, ep):
                    return -1
                sp += 1
                pp = ep
        finally:
            self.depth -= 1

    def max_expand(self, sp, pp, ep):
        i = 0
        while self.single_match(sp + i, pp, ep):
            i += 1
        while i >= 0:
            r = self.match(sp + i, ep + 1)
            if r >= 0:
                return r
            i -= 1
        return -1

    def min_expand(self, sp, pp, ep):
        while True:
            r = self.match(sp, ep + 1)
            if r >= 0:
                return r
            if self.single_match(sp, pp, ep):
                sp += 1
            else:
                return -1

    def captures(self, sp, ep, whole_if_none=True):
        if not self.caps:
            return [self.s[sp:ep]] if whole_if_none else []
        out = []
        for st, ln in self.caps:
            if ln == -2:
                out.append(float(st + 1))
            else:
                out.append(self.s[st:st + ln])
        return out


def _pat_find(s: bytes, p: bytes, init: int, want_find: bool, plain: bool):
    """Core of string.find/match. init is 0-based. Returns
    (start, end, caps) with 0-based [start, end) or None."""
    if plain and want_find:
        idx = s.find(p, init)
        if idx < 0:
            return None
        return idx, idx + len(p), []
    anchor = p.startswith(b"^")
    pp = 1 if anchor else 0
    sp = init
    while True:
        m = _PatMatcher(s, p)
        r = m.match(sp, pp)
        if r >= 0:
            return sp, r, m.captures(sp, r, whole_if_none=not want_find)
        sp += 1
        if anchor or sp > len(s):
            return None


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------

class _Env:
    __slots__ = ("vars", "parent")

    def __init__(self, parent=None):
        self.vars: Dict[str, Any] = {}
        self.parent = parent

    def lookup(self, name) -> Optional["_Env"]:
        e = self
        while e is not None:
            if name in e.vars:
                return e
            e = e.parent
        return None


class LuaRuntime:
    """One script execution context: globals, step budget, host hooks."""

    def __init__(self,
                 redis_call: Callable[[List[bytes]], Any],
                 keys: Optional[List[bytes]] = None,
                 argv: Optional[List[bytes]] = None,
                 step_limit: int = 8_000_000,
                 resp_to_lua_fn: Optional[Callable[[Any], Any]] = None,
                 random_seed: int = 0):
        self.redis_call = redis_call
        self.steps = 0
        self.call_depth = 0
        self.step_limit = step_limit
        self.resp_to_lua = resp_to_lua_fn or resp_to_lua
        self.globals = _Env()
        self._rng_state = (random_seed * 2654435761 + 1) & 0xFFFFFFFF
        self._install_stdlib()
        g = self.globals.vars
        g["KEYS"] = LuaTable.from_list(list(keys or []))
        g["ARGV"] = LuaTable.from_list(list(argv or []))

    # -- execution ------------------------------------------------------------
    def run(self, ast) -> List[Any]:
        """Execute a parsed chunk; returns the chunk's return values."""
        try:
            self.exec_block(ast, _Env(self.globals))
        except _Return as r:
            return r.values
        return []

    def tick(self):
        self.steps += 1
        if self.steps > self.step_limit:
            raise LuaError(b"script exceeded the instruction budget "
                           b"(infinite loop?)")

    def exec_block(self, stmts, env: _Env):
        for st in stmts:
            self.exec_stmt(st, env)

    def exec_stmt(self, st, env: _Env):
        self.tick()
        op = st[0]
        if op == "exprstat":
            self.eval_multi(st[1], env)
        elif op == "local":
            _, names, exprs = st
            vals = self.eval_list(exprs, env, len(names))
            for nm, v in zip(names, vals):
                env.vars[nm] = v
        elif op == "assign":
            _, targets, exprs = st
            vals = self.eval_list(exprs, env, len(targets))
            for tgt, v in zip(targets, vals):
                self.assign(tgt, v, env)
        elif op == "if":
            _, arms, els = st
            for cond, body in arms:
                if _truthy(self.eval(cond, env)):
                    self.exec_block(body, _Env(env))
                    return
            self.exec_block(els, _Env(env))
        elif op == "while":
            _, cond, body = st
            try:
                while _truthy(self.eval(cond, env)):
                    self.tick()
                    self.exec_block(body, _Env(env))
            except _Break:
                pass
        elif op == "repeat":
            _, body, cond = st
            try:
                while True:
                    self.tick()
                    scope = _Env(env)
                    self.exec_block(body, scope)
                    if _truthy(self.eval(cond, scope)):
                        break
            except _Break:
                pass
        elif op == "fornum":
            _, name, e1, e2, e3, body = st
            start = _arith_num(self.eval(e1, env), "for")
            stop = _arith_num(self.eval(e2, env), "for")
            step = _arith_num(self.eval(e3, env), "for") \
                if e3 is not None else 1.0
            if step == 0:
                raise LuaError(b"'for' step is zero")
            i = start
            try:
                while (step > 0 and i <= stop) or (step < 0 and i >= stop):
                    self.tick()
                    scope = _Env(env)
                    scope.vars[name] = i
                    self.exec_block(body, scope)
                    i += step
            except _Break:
                pass
        elif op == "forin":
            _, names, exprs, body = st
            ctl = self.eval_list(exprs, env, 3)
            f, s, var = ctl[0], ctl[1], ctl[2]
            try:
                while True:
                    self.tick()
                    rets = self.call_value(f, [s, var])
                    if not rets or rets[0] is None:
                        break
                    var = rets[0]
                    scope = _Env(env)
                    for idx, nm in enumerate(names):
                        scope.vars[nm] = rets[idx] if idx < len(rets) \
                            else None
                    self.exec_block(body, scope)
            except _Break:
                pass
        elif op == "do":
            self.exec_block(st[1], _Env(env))
        elif op == "localfunc":
            _, name, fnexpr = st
            env.vars[name] = None
            fn = _LuaFunction(fnexpr[1], fnexpr[2], env, name)
            env.vars[name] = fn
        elif op == "return":
            raise _Return(self.eval_list(st[1], env, -1))
        elif op == "break":
            raise _Break()
        else:  # pragma: no cover
            raise LuaError(f"internal: unknown statement {op}".encode())

    def assign(self, tgt, v, env: _Env):
        if tgt[0] == "name":
            e = env.lookup(tgt[1])
            (e or self.globals).vars[tgt[1]] = v
            return
        _, obj_e, key_e = tgt
        obj = self.eval(obj_e, env)
        if not isinstance(obj, LuaTable):
            raise LuaError(
                f"attempt to index a {_type_name(obj)} value".encode())
        obj.set(self.eval(key_e, env), v)

    # -- expression evaluation --------------------------------------------
    def eval_list(self, exprs, env, want: int) -> List[Any]:
        """Evaluate an expression list with Lua multi-value semantics:
        every expr truncates to one value except the last, which expands.
        want=-1 keeps everything; else pad/truncate to `want`."""
        vals: List[Any] = []
        for i, e in enumerate(exprs):
            if i == len(exprs) - 1:
                vals.extend(self.eval_multi(e, env))
            else:
                vals.append(self.eval(e, env))
        if want >= 0:
            while len(vals) < want:
                vals.append(None)
            del vals[want:]
        return vals

    def eval_multi(self, e, env) -> List[Any]:
        if e[0] in ("call", "method"):
            return self.eval_call(e, env)
        return [self.eval(e, env)]

    def eval(self, e, env) -> Any:
        self.tick()
        op = e[0]
        if op == "const":
            return e[1]
        if op == "name":
            scope = env.lookup(e[1])
            if scope is not None:
                return scope.vars[e[1]]
            return self.globals.vars.get(e[1])
        if op == "paren":
            return self.eval(e[1], env)
        if op == "index":
            obj = self.eval(e[1], env)
            key = self.eval(e[2], env)
            if isinstance(obj, LuaTable):
                return obj.get(key)
            if isinstance(obj, bytes):
                strlib = self.globals.vars.get("string")
                return strlib.get(key) if isinstance(strlib, LuaTable) \
                    else None
            raise LuaError(
                f"attempt to index a {_type_name(obj)} value"
                f" ({_name_of(e[1])})".encode())
        if op in ("call", "method"):
            rets = self.eval_call(e, env)
            return rets[0] if rets else None
        if op == "function":
            return _LuaFunction(e[1], e[2], env)
        if op == "table":
            t = LuaTable()
            n = 1
            items = e[1]
            for i, it in enumerate(items):
                if it[0] == "pair":
                    t.set(self.eval(it[1], env), self.eval(it[2], env))
                elif i == len(items) - 1:
                    for v in self.eval_multi(it[1], env):
                        if v is not None:
                            t.data[n] = v
                        n += 1
                else:
                    v = self.eval(it[1], env)
                    if v is not None:
                        t.data[n] = v
                    n += 1
            return t
        if op == "binop":
            return self.eval_binop(e, env)
        if op == "unop":
            _, uop, sub = e
            v = self.eval(sub, env)
            if uop == "not":
                return not _truthy(v)
            if uop == "-":
                return -_arith_num(v, "unm")
            if isinstance(v, bytes):  # '#'
                return float(len(v))
            if isinstance(v, LuaTable):
                return float(v.length())
            raise LuaError(
                f"attempt to get length of a {_type_name(v)} value"
                .encode())
        if op == "vararg":
            raise LuaError(b"'...' is not available in redis scripts")
        raise LuaError(f"internal: unknown expression {op}".encode())

    def eval_binop(self, e, env):
        _, op, le, re_ = e
        if op == "and":
            lv = self.eval(le, env)
            return self.eval(re_, env) if _truthy(lv) else lv
        if op == "or":
            lv = self.eval(le, env)
            return lv if _truthy(lv) else self.eval(re_, env)
        lv = self.eval(le, env)
        rv = self.eval(re_, env)
        if op == "==":
            return _lua_eq(lv, rv)
        if op == "~=":
            return not _lua_eq(lv, rv)
        if op == "..":
            return _concat(lv) + _concat(rv)
        if op in ("<", "<=", ">", ">="):
            if isinstance(lv, (int, float)) and not isinstance(lv, bool) \
                    and isinstance(rv, (int, float)) \
                    and not isinstance(rv, bool):
                pass
            elif isinstance(lv, bytes) and isinstance(rv, bytes):
                pass
            else:
                raise LuaError(
                    f"attempt to compare {_type_name(lv)} with "
                    f"{_type_name(rv)}".encode())
            if op == "<":
                return lv < rv
            if op == "<=":
                return lv <= rv
            if op == ">":
                return lv > rv
            return lv >= rv
        ln = _arith_num(lv, op)
        rn = _arith_num(rv, op)
        if op == "+":
            return ln + rn
        if op == "-":
            return ln - rn
        if op == "*":
            return ln * rn
        if op == "/":
            if rn == 0:
                return math.inf if ln > 0 else (-math.inf if ln < 0
                                                else math.nan)
            return ln / rn
        if op == "%":
            if rn == 0:
                return math.nan
            return ln - math.floor(ln / rn) * rn
        if op == "^":
            try:
                r = math.pow(ln, rn)
            except (OverflowError, ValueError):
                r = math.inf if ln > 0 else math.nan
            return r
        raise LuaError(f"internal: unknown binop {op}".encode())

    # -- calls ---------------------------------------------------------------
    def eval_call(self, e, env) -> List[Any]:
        if e[0] == "method":
            obj = self.eval(e[1], env)
            if isinstance(obj, LuaTable):
                fn = obj.get(e[2])
            elif isinstance(obj, bytes):
                strlib = self.globals.vars.get("string")
                fn = strlib.get(e[2]) if isinstance(strlib, LuaTable) \
                    else None
            else:
                raise LuaError(
                    f"attempt to index a {_type_name(obj)} value".encode())
            args = [obj] + self.eval_list(e[3], env, -1)
        else:
            fn = self.eval(e[1], env)
            args = self.eval_list(e[2], env, -1)
            if fn is None:
                raise LuaError(
                    f"attempt to call a nil value ({_name_of(e[1])})"
                    .encode())
        return self.call_value(fn, args)

    def call_value(self, fn, args: List[Any]) -> List[Any]:
        self.tick()
        if isinstance(fn, _LuaFunction):
            self.call_depth += 1
            if self.call_depth > 100:
                # Lua's LUAI_MAXCCALLS analog. One Lua frame costs ~8
                # Python frames in this tree-walker, so 100 stays well
                # inside Python's 1000-frame limit: a runaway recursion
                # raises a catchable script error, never a Python
                # RecursionError
                self.call_depth -= 1
                raise LuaError(b"stack overflow (too deep recursion)")
            scope = _Env(fn.env)
            for i, p in enumerate(fn.params):
                if p == "...":
                    break
                scope.vars[p] = args[i] if i < len(args) else None
            try:
                self.exec_block(fn.body, scope)
            except _Return as r:
                return r.values
            finally:
                self.call_depth -= 1
            return []
        if callable(fn):
            r = fn(self, args)
            if isinstance(r, list):
                return r
            return [] if r is _NO_RESULT else [r]
        raise LuaError(
            f"attempt to call a {_type_name(fn)} value".encode())

    # -- stdlib installation ---------------------------------------------
    def _install_stdlib(self):
        g = self.globals.vars
        for name, fn in _BASE_LIB.items():
            g[name] = fn
        for libname, entries in (
                ("string", _STRING_LIB), ("table", _TABLE_LIB),
                ("math", _MATH_LIB), ("bit", _BIT_LIB),
                ("cjson", _CJSON_LIB)):
            t = LuaTable()
            for k, v in entries.items():
                t.data[_b(k)] = v
            g[libname] = t
        g["math"].data[_b("huge")] = math.inf
        g["math"].data[_b("pi")] = math.pi
        redis_t = LuaTable()
        for k, v in _REDIS_LIB.items():
            redis_t.data[_b(k)] = v
        for lvl, num in (("LOG_DEBUG", 0), ("LOG_VERBOSE", 1),
                         ("LOG_NOTICE", 2), ("LOG_WARNING", 3)):
            redis_t.data[_b(lvl)] = float(num)
        g["redis"] = redis_t
        g["server"] = redis_t  # valkey alias

    def _next_random(self) -> float:
        self._rng_state = (1103515245 * self._rng_state + 12345) \
            & 0x7FFFFFFF
        return self._rng_state / 0x80000000


def _name_of(e) -> str:
    if e[0] == "name":
        return f"global '{e[1]}'"
    if e[0] == "index" and e[2][0] == "const" \
            and isinstance(e[2][1], bytes):
        return f"field '{_tostr(e[2][1])}'"
    return "expression"


def _lua_eq(a, b) -> bool:
    ta, tb = _type_name(a), _type_name(b)
    if ta != tb:
        return False
    if ta == "nil":
        return True
    if ta == "number":
        return float(a) == float(b)
    if ta == "boolean":
        return a is b
    if ta == "string":
        return a == b
    return a is b  # tables/functions compare by identity


def _concat(v) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return _fmt_num(v)
    raise LuaError(
        f"attempt to concatenate a {_type_name(v)} value".encode())


_NO_RESULT = object()


# ---------------------------------------------------------------------------
# Base library
# ---------------------------------------------------------------------------

def _arg(args, i, default=None):
    return args[i] if i < len(args) else default


def _check_table(v, fname) -> LuaTable:
    if not isinstance(v, LuaTable):
        raise LuaError(
            f"bad argument #1 to '{fname}' (table expected, got "
            f"{_type_name(v)})".encode())
    return v


def _check_str(v, fname, idx=1) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return _fmt_num(v)
    raise LuaError(
        f"bad argument #{idx} to '{fname}' (string expected, got "
        f"{_type_name(v)})".encode())


def _check_num(v, fname, idx=1) -> float:
    n = _lua_tonumber(v)
    if n is None:
        raise LuaError(
            f"bad argument #{idx} to '{fname}' (number expected, got "
            f"{_type_name(v)})".encode())
    return n


def _lib_type(rt, args):
    return _b(_type_name(_arg(args, 0)))


def _lib_tonumber(rt, args):
    return _lua_tonumber(_arg(args, 0), _arg(args, 1))


def _lib_tostring(rt, args):
    return _lua_tostring(_arg(args, 0))


def _lib_error(rt, args):
    v = _arg(args, 0)
    # error(string) at level>0 would prefix position info; scripts rarely
    # rely on it, the message itself is what propagates to the client
    raise LuaError(v if v is not None else b"nil")


def _lib_assert(rt, args):
    if not _truthy(_arg(args, 0)):
        msg = _arg(args, 1, b"assertion failed!")
        raise LuaError(msg)
    return list(args)


def _lib_pcall(rt, args):
    if not args:
        raise LuaError(b"bad argument #1 to 'pcall' (value expected)")
    try:
        rets = rt.call_value(args[0], list(args[1:]))
        return [True] + rets
    except LuaError as exc:
        return [False, exc.value]
    except (_Break, _Return):
        raise
    except ZeroDivisionError:
        return [False, b"attempt to perform 'n/0'"]


def _lib_unpack(rt, args):
    t = _check_table(_arg(args, 0), "unpack")
    i = int(_check_num(_arg(args, 1, 1.0), "unpack", 2))
    j = int(_check_num(_arg(args, 2, float(t.length())), "unpack", 3))
    return [t.get(k) for k in range(i, j + 1)]


def _lib_next(rt, args):
    t = _check_table(_arg(args, 0), "next")
    keys = list(t.data.keys())
    k = _arg(args, 1)
    if k is None:
        if not keys:
            return None
        k0 = keys[0]
        return [float(k0) if isinstance(k0, int) else k0, t.data[k0]]
    k = _numkey(k)
    try:
        idx = keys.index(k)
    except ValueError:
        raise LuaError(b"invalid key to 'next'")
    if idx + 1 >= len(keys):
        return None
    k1 = keys[idx + 1]
    return [float(k1) if isinstance(k1, int) else k1, t.data[k1]]


def _lib_pairs(rt, args):
    t = _check_table(_arg(args, 0), "pairs")
    return [_lib_next, t, None]


def _lib_ipairs(rt, args):
    t = _check_table(_arg(args, 0), "ipairs")

    def it(rt2, a):
        tt, i = a[0], int(a[1]) + 1
        v = tt.get(i)
        if v is None:
            return None
        return [float(i), v]

    return [it, t, 0.0]


def _lib_select(rt, args):
    n = _arg(args, 0)
    if n == b"#":
        return float(len(args) - 1)
    i = int(_check_num(n, "select"))
    if i < 0:
        i = len(args) - 1 + i + 1
    return list(args[i:])


def _lib_rawget(rt, args):
    return _check_table(_arg(args, 0), "rawget").get(_arg(args, 1))


def _lib_rawset(rt, args):
    t = _check_table(_arg(args, 0), "rawset")
    t.set(_arg(args, 1), _arg(args, 2))
    return t


def _lib_rawequal(rt, args):
    return _lua_eq(_arg(args, 0), _arg(args, 1))


_BASE_LIB = {
    "type": _lib_type, "tonumber": _lib_tonumber,
    "tostring": _lib_tostring, "error": _lib_error,
    "assert": _lib_assert, "pcall": _lib_pcall, "unpack": _lib_unpack,
    "next": _lib_next, "pairs": _lib_pairs, "ipairs": _lib_ipairs,
    "select": _lib_select, "rawget": _lib_rawget, "rawset": _lib_rawset,
    "rawequal": _lib_rawequal,
}


# ---------------------------------------------------------------------------
# string library
# ---------------------------------------------------------------------------

def _str_range(s: bytes, i: float, j: float) -> Tuple[int, int]:
    """Lua 1-based, negative-from-end [i, j] -> Python [a, b)."""
    ln = len(s)
    i = int(i)
    j = int(j)
    if i < 0:
        i = max(ln + i + 1, 1)
    elif i == 0:
        i = 1
    if j < 0:
        j = ln + j + 1
    elif j > ln:
        j = ln
    return i - 1, j


def _slib_len(rt, args):
    return float(len(_check_str(_arg(args, 0), "len")))


def _slib_sub(rt, args):
    s = _check_str(_arg(args, 0), "sub")
    j = _check_num(args[2], "sub", 3) \
        if len(args) > 2 and args[2] is not None else -1.0
    a, b2 = _str_range(s, _check_num(_arg(args, 1, 1.0), "sub", 2), j)
    if a >= b2:
        return b""
    return s[a:b2]


def _slib_upper(rt, args):
    return _check_str(_arg(args, 0), "upper").upper()


def _slib_lower(rt, args):
    return _check_str(_arg(args, 0), "lower").lower()


def _slib_rep(rt, args):
    s = _check_str(_arg(args, 0), "rep")
    n = int(_check_num(_arg(args, 1), "rep", 2))
    if n > 0 and len(s) * n > 64 * 2**20:
        raise LuaError(b"resulting string too large")
    return s * max(n, 0)


def _slib_reverse(rt, args):
    return _check_str(_arg(args, 0), "reverse")[::-1]


def _slib_byte(rt, args):
    s = _check_str(_arg(args, 0), "byte")
    i = _check_num(_arg(args, 1, 1.0), "byte", 2)
    j = _arg(args, 2)
    a, b2 = _str_range(s, i, _check_num(j, "byte", 3) if j is not None
                       else i)
    return [float(c) for c in s[a:b2]]


def _slib_char(rt, args):
    try:
        return bytes(int(_check_num(a, "char", i + 1))
                     for i, a in enumerate(args))
    except ValueError:
        raise LuaError(b"bad argument to 'char' (value out of range)")


def _slib_format(rt, args):
    fmt = _check_str(_arg(args, 0), "format")
    out = bytearray()
    ai = 1
    i = 0
    while i < len(fmt):
        c = fmt[i:i + 1]
        if c != b"%":
            out += c
            i += 1
            continue
        j = i + 1
        while j < len(fmt) and fmt[j:j + 1] in b"-+ #0123456789.":
            j += 1
        spec = fmt[i:j + 1].decode("latin1")
        conv = fmt[j:j + 1]
        i = j + 1
        if conv == b"%":
            out += b"%"
            continue
        a = _arg(args, ai)
        ai += 1
        if conv in b"di":
            out += ((spec[:-1] + "d")
                    % int(_check_num(a, "format", ai))).encode()
        elif conv == b"u":
            out += ((spec[:-1] + "d")
                    % (int(_check_num(a, "format", ai))
                       & 0xFFFFFFFFFFFFFFFF)).encode()
        elif conv in b"fgGeE":
            out += (spec % _check_num(a, "format", ai)).encode()
        elif conv in b"xX":
            out += (spec % (int(_check_num(a, "format", ai))
                            & 0xFFFFFFFFFFFFFFFF)).encode()
        elif conv == b"c":
            out.append(int(_check_num(a, "format", ai)) & 0xFF)
        elif conv == b"s":
            sv = _lua_tostring(a)
            out += (spec % sv.decode("utf-8", "surrogateescape")) \
                .encode("utf-8", "surrogateescape")
        elif conv == b"q":
            out += b'"'
            for ch in _check_str(a, "format", ai):
                if ch in b'"\\\n':
                    out += b"\\" + bytes([ch])
                elif ch == 0:
                    out += b"\\0"
                else:
                    out.append(ch)
            out += b'"'
        else:
            raise LuaError(
                f"invalid option '%{conv.decode('latin1')}' to 'format'"
                .encode())
        # %s with width was handled on str; others on numbers
    return bytes(out)


def _find_init(s: bytes, init) -> int:
    i = int(init)
    if i < 0:
        i = max(len(s) + i + 1, 1)
    elif i == 0:
        i = 1
    return i - 1


def _slib_find(rt, args):
    s = _check_str(_arg(args, 0), "find")
    p = _check_str(_arg(args, 1), "find", 2)
    init = _find_init(s, _check_num(_arg(args, 2, 1.0), "find", 3))
    if init > len(s):
        return None
    plain = _truthy(_arg(args, 3))
    r = _pat_find(s, p, init, want_find=True, plain=plain)
    if r is None:
        return None
    st, en, caps = r
    return [float(st + 1), float(en)] + caps


def _slib_match(rt, args):
    s = _check_str(_arg(args, 0), "match")
    p = _check_str(_arg(args, 1), "match", 2)
    init = _find_init(s, _check_num(_arg(args, 2, 1.0), "match", 3))
    if init > len(s):
        return None
    r = _pat_find(s, p, init, want_find=False, plain=False)
    if r is None:
        return None
    return r[2]


def _slib_gmatch(rt, args):
    s = _check_str(_arg(args, 0), "gmatch")
    p = _check_str(_arg(args, 1), "gmatch", 2)
    state = {"pos": 0}

    def it(rt2, a):
        while state["pos"] <= len(s):
            m = _PatMatcher(s, p)
            pp = 1 if p.startswith(b"^") else 0
            r = m.match(state["pos"], pp)
            if r >= 0:
                caps = m.captures(state["pos"], r)
                state["pos"] = r + 1 if r == state["pos"] else r
                return caps
            state["pos"] += 1
            if p.startswith(b"^"):
                break
        return None

    return it


def _slib_gsub(rt, args):
    s = _check_str(_arg(args, 0), "gsub")
    p = _check_str(_arg(args, 1), "gsub", 2)
    repl = _arg(args, 2)
    max_n = _arg(args, 3)
    max_n = int(_check_num(max_n, "gsub", 4)) if max_n is not None \
        else -1
    anchor = p.startswith(b"^")
    pp = 1 if anchor else 0
    out = bytearray()
    pos = 0
    count = 0
    while pos <= len(s) and (max_n < 0 or count < max_n):
        m = _PatMatcher(s, p)
        r = m.match(pos, pp)
        if r >= 0:
            count += 1
            whole = s[pos:r]
            caps = m.captures(pos, r)
            if isinstance(repl, bytes) or isinstance(
                    repl, (int, float)) and not isinstance(repl, bool):
                rb = _check_str(repl, "gsub", 3)
                k = 0
                while k < len(rb):
                    ch = rb[k:k + 1]
                    if ch == b"%":
                        nxt = rb[k + 1:k + 2]
                        if nxt == b"0":
                            out += whole
                        elif nxt.isdigit():
                            ci = int(nxt) - 1
                            if ci < len(caps):
                                v = caps[ci]
                                out += v if isinstance(v, bytes) \
                                    else _fmt_num(v)
                            else:
                                raise LuaError(
                                    b"invalid capture index in gsub")
                        elif nxt == b"%":
                            out += b"%"
                        else:
                            raise LuaError(
                                b"invalid use of '%' in replacement "
                                b"string")
                        k += 2
                    else:
                        out += ch
                        k += 1
            elif isinstance(repl, LuaTable):
                v = repl.get(caps[0])
                out += whole if (v is None or v is False) \
                    else _check_str(v, "gsub", 3)
            elif repl is not None and (callable(repl) or
                                       isinstance(repl, _LuaFunction)):
                rets = rt.call_value(repl, caps)
                v = rets[0] if rets else None
                out += whole if (v is None or v is False) \
                    else _check_str(v, "gsub", 3)
            else:
                raise LuaError(
                    b"bad argument #3 to 'gsub' "
                    b"(string/function/table expected)")
            if r == pos:  # empty match: copy one char, advance
                if pos < len(s):
                    out.append(s[pos])
                pos += 1
            else:
                pos = r
        else:
            if pos < len(s):
                out.append(s[pos])
            pos += 1
            if anchor:
                break
        if anchor:
            break
    out += s[pos:]
    return [bytes(out), float(count)]


_STRING_LIB = {
    "len": _slib_len, "sub": _slib_sub, "upper": _slib_upper,
    "lower": _slib_lower, "rep": _slib_rep, "reverse": _slib_reverse,
    "byte": _slib_byte, "char": _slib_char, "format": _slib_format,
    "find": _slib_find, "match": _slib_match, "gmatch": _slib_gmatch,
    "gsub": _slib_gsub,
}


# ---------------------------------------------------------------------------
# table library
# ---------------------------------------------------------------------------

def _tlib_insert(rt, args):
    t = _check_table(_arg(args, 0), "insert")
    n = t.length()
    if len(args) >= 3:
        pos = int(_check_num(args[1], "insert", 2))
        for k in range(n, pos - 1, -1):
            t.data[k + 1] = t.data.pop(k, None)
            if t.data[k + 1] is None:
                del t.data[k + 1]
        t.set(pos, args[2])
    else:
        t.set(n + 1, _arg(args, 1))
    return _NO_RESULT


def _tlib_remove(rt, args):
    t = _check_table(_arg(args, 0), "remove")
    n = t.length()
    pos = int(_check_num(_arg(args, 1, float(n)), "remove", 2)) \
        if len(args) > 1 else n
    if n == 0:
        return None
    v = t.get(pos)
    for k in range(pos, n):
        nxt = t.data.get(k + 1)
        if nxt is None:
            t.data.pop(k, None)
        else:
            t.data[k] = nxt
    t.data.pop(n, None)
    return v


def _tlib_concat(rt, args):
    t = _check_table(_arg(args, 0), "concat")
    sep = _check_str(_arg(args, 1, b""), "concat", 2)
    i = int(_check_num(_arg(args, 2, 1.0), "concat", 3))
    j = int(_check_num(_arg(args, 3, float(t.length())), "concat", 4))
    parts = []
    for k in range(i, j + 1):
        v = t.get(k)
        if v is None or isinstance(v, (bool, LuaTable)) or callable(v) \
                or isinstance(v, _LuaFunction):
            raise LuaError(
                f"invalid value (at index {k}) in table for 'concat'"
                .encode())
        parts.append(v if isinstance(v, bytes) else _fmt_num(v))
    return sep.join(parts)


def _tlib_sort(rt, args):
    t = _check_table(_arg(args, 0), "sort")
    comp = _arg(args, 1)
    vals = t.arr()

    if comp is not None:
        import functools

        def cmpf(a, b):
            r = rt.call_value(comp, [a, b])
            if r and _truthy(r[0]):
                return -1
            r2 = rt.call_value(comp, [b, a])
            if r2 and _truthy(r2[0]):
                return 1
            return 0

        vals.sort(key=functools.cmp_to_key(cmpf))
    else:
        try:
            vals.sort()
        except TypeError:
            raise LuaError(b"attempt to compare incompatible values "
                           b"in 'sort'")
    for i, v in enumerate(vals):
        t.data[i + 1] = v
    return _NO_RESULT


def _tlib_getn(rt, args):
    return float(_check_table(_arg(args, 0), "getn").length())


_TABLE_LIB = {
    "insert": _tlib_insert, "remove": _tlib_remove,
    "concat": _tlib_concat, "sort": _tlib_sort, "getn": _tlib_getn,
}


# ---------------------------------------------------------------------------
# math / bit libraries
# ---------------------------------------------------------------------------

def _m1(f, name):
    def fn(rt, args):
        return float(f(_check_num(_arg(args, 0), name)))
    return fn


def _mlib_max(rt, args):
    if not args:
        raise LuaError(b"bad argument #1 to 'max' (number expected)")
    return max(_check_num(a, "max", i + 1) for i, a in enumerate(args))


def _mlib_min(rt, args):
    if not args:
        raise LuaError(b"bad argument #1 to 'min' (number expected)")
    return min(_check_num(a, "min", i + 1) for i, a in enumerate(args))


def _mlib_random(rt, args):
    r = rt._next_random()
    if not args:
        return r
    m = int(_check_num(args[0], "random"))
    if len(args) == 1:
        if m < 1:
            raise LuaError(b"bad argument #1 to 'random' "
                           b"(interval is empty)")
        return float(1 + int(r * m))
    n = int(_check_num(args[1], "random", 2))
    if m > n:
        raise LuaError(b"bad argument #2 to 'random' "
                       b"(interval is empty)")
    return float(m + int(r * (n - m + 1)))


def _mlib_randomseed(rt, args):
    rt._rng_state = int(_check_num(_arg(args, 0, 0.0), "randomseed")) \
        & 0xFFFFFFFF
    return _NO_RESULT


def _mlib_fmod(rt, args):
    a = _check_num(_arg(args, 0), "fmod")
    b2 = _check_num(_arg(args, 1), "fmod", 2)
    if b2 == 0:
        return math.nan
    return math.fmod(a, b2)


def _mlib_modf(rt, args):
    x = _check_num(_arg(args, 0), "modf")
    frac, whole = math.modf(x)
    return [whole, frac]


def _mlib_pow(rt, args):
    return math.pow(_check_num(_arg(args, 0), "pow"),
                    _check_num(_arg(args, 1), "pow", 2))


_MATH_LIB = {
    "floor": _m1(math.floor, "floor"), "ceil": _m1(math.ceil, "ceil"),
    "abs": _m1(abs, "abs"), "sqrt": _m1(math.sqrt, "sqrt"),
    "exp": _m1(math.exp, "exp"), "log": _m1(math.log, "log"),
    "log10": _m1(math.log10, "log10"),
    "sin": _m1(math.sin, "sin"), "cos": _m1(math.cos, "cos"),
    "tan": _m1(math.tan, "tan"),
    "max": _mlib_max, "min": _mlib_min, "random": _mlib_random,
    "randomseed": _mlib_randomseed, "fmod": _mlib_fmod,
    "modf": _mlib_modf, "pow": _mlib_pow,
}


def _bit_fold(f, name, init=None):
    def fn(rt, args):
        if not args:
            raise LuaError(
                f"bad argument #1 to '{name}' (number expected)".encode())
        acc = int(_check_num(args[0], name)) & 0xFFFFFFFF
        for i, a in enumerate(args[1:]):
            acc = f(acc, int(_check_num(a, name, i + 2)) & 0xFFFFFFFF)
        acc &= 0xFFFFFFFF
        return float(acc - 0x100000000 if acc >= 0x80000000 else acc)
    return fn


def _bit_shift(f, name):
    def fn(rt, args):
        x = int(_check_num(_arg(args, 0), name)) & 0xFFFFFFFF
        n = int(_check_num(_arg(args, 1), name, 2)) & 31
        acc = f(x, n) & 0xFFFFFFFF
        return float(acc - 0x100000000 if acc >= 0x80000000 else acc)
    return fn


def _bit_bnot(rt, args):
    acc = (~int(_check_num(_arg(args, 0), "bnot"))) & 0xFFFFFFFF
    return float(acc - 0x100000000 if acc >= 0x80000000 else acc)


def _bit_tobit(rt, args):
    acc = int(_check_num(_arg(args, 0), "tobit")) & 0xFFFFFFFF
    return float(acc - 0x100000000 if acc >= 0x80000000 else acc)


def _bit_tohex(rt, args):
    x = int(_check_num(_arg(args, 0), "tohex")) & 0xFFFFFFFF
    return b"%08x" % x


_BIT_LIB = {
    "band": _bit_fold(lambda a, b2: a & b2, "band"),
    "bor": _bit_fold(lambda a, b2: a | b2, "bor"),
    "bxor": _bit_fold(lambda a, b2: a ^ b2, "bxor"),
    "bnot": _bit_bnot,
    "lshift": _bit_shift(lambda x, n: x << n, "lshift"),
    "rshift": _bit_shift(lambda x, n: x >> n, "rshift"),
    "arshift": _bit_shift(
        lambda x, n: (x - 0x100000000 if x >= 0x80000000 else x) >> n,
        "arshift"),
    "tobit": _bit_tobit, "tohex": _bit_tohex,
}


# ---------------------------------------------------------------------------
# cjson
# ---------------------------------------------------------------------------

class _CJsonNull:
    """cjson.null — the lightuserdata sentinel Lua cjson decodes JSON
    null to (a plain nil would punch holes in decoded arrays)."""

    __slots__ = ()

    def __repr__(self):  # pragma: no cover - debug aid
        return "cjson.null"


CJSON_NULL = _CJsonNull()


def _json_to_lua(v):
    if v is None:
        return CJSON_NULL
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        return v.encode("utf-8", "surrogateescape")
    if isinstance(v, list):
        return LuaTable.from_list([_json_to_lua(x) for x in v])
    t = LuaTable()
    for k, vv in v.items():
        t.data[k.encode("utf-8", "surrogateescape")] = _json_to_lua(vv)
    return t


def _lua_to_json(v, depth=0):
    if depth > 64:
        raise LuaError(b"cjson: table nested too deep")
    if v is None or v is CJSON_NULL:
        return None
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return int(v) if float(v).is_integer() and abs(v) < 1e15 else v
    if isinstance(v, bytes):
        return v.decode("utf-8", "surrogateescape")
    if isinstance(v, LuaTable):
        if not v.data:
            return {}  # cjson encodes the empty table as an object
        n = v.length()
        if n == len(v.data):  # pure array part
            return [_lua_to_json(v.data[i + 1], depth + 1)
                    for i in range(n)]
        out = {}
        for k, vv in v.data.items():
            if isinstance(k, bytes):
                ks = k.decode("utf-8", "surrogateescape")
            elif isinstance(k, (int, float)):
                ks = _fmt_num(k).decode()
            else:
                raise LuaError(b"cjson: unsupported table key type")
            out[ks] = _lua_to_json(vv, depth + 1)
        return out
    raise LuaError(
        f"cjson: cannot serialise a {_type_name(v)} value".encode())


def _cjson_encode(rt, args):
    try:
        return json.dumps(
            _lua_to_json(_arg(args, 0)), separators=(",", ":"),
            ensure_ascii=True).encode()
    except (ValueError, TypeError) as exc:
        raise LuaError(f"cjson encode failed: {exc}".encode())


def _cjson_decode(rt, args):
    s = _check_str(_arg(args, 0), "decode")
    try:
        return _json_to_lua(
            json.loads(s.decode("utf-8", "surrogateescape")))
    except ValueError as exc:
        raise LuaError(f"cjson decode failed: {exc}".encode())


_CJSON_LIB = {"encode": _cjson_encode, "decode": _cjson_decode,
              "null": CJSON_NULL}


# ---------------------------------------------------------------------------
# redis API + reply conversion
# ---------------------------------------------------------------------------

class RedisCallError(Exception):
    """Raised by the host's redis_call hook to signal a command error;
    carries the message exactly as the client would see it."""

    def __init__(self, message: str):
        self.message = message
        super().__init__(message)


def _redis_call_impl(rt: LuaRuntime, args, protected: bool):
    argv: List[bytes] = []
    for i, a in enumerate(args):
        if isinstance(a, bytes):
            argv.append(a)
        elif isinstance(a, (int, float)) and not isinstance(a, bool):
            argv.append(_fmt_num(a))
        else:
            err = LuaTable()
            err.data[b"err"] = (b"Lua redis lib command arguments must be "
                                b"strings or integers")
            if protected:
                return err
            raise LuaError(err)
    if not argv:
        raise LuaError(b"Please specify at least one argument for this "
                       b"redis lib call")
    try:
        reply = rt.redis_call(argv)
    except RedisCallError as exc:
        err = LuaTable()
        err.data[b"err"] = _b(exc.message)
        if protected:
            return err
        raise LuaError(err)
    return rt.resp_to_lua(reply)


def _rlib_call(rt, args):
    return _redis_call_impl(rt, args, protected=False)


def _rlib_pcall(rt, args):
    return _redis_call_impl(rt, args, protected=True)


def _rlib_status_reply(rt, args):
    t = LuaTable()
    t.data[b"ok"] = _check_str(_arg(args, 0, b"OK"), "status_reply")
    return t


def _rlib_error_reply(rt, args):
    t = LuaTable()
    t.data[b"err"] = _check_str(_arg(args, 0, b"error"), "error_reply")
    return t


def _rlib_sha1hex(rt, args):
    return hashlib.sha1(
        _check_str(_arg(args, 0, b""), "sha1hex")).hexdigest().encode()


def _rlib_log(rt, args):
    return _NO_RESULT  # sandboxed no-op (reference logs to valkey's log)


def _rlib_breakpoint(rt, args):
    return False


def _rlib_replicate_commands(rt, args):
    return True  # effect-replication is this engine's only mode


_REDIS_LIB = {
    "call": _rlib_call, "pcall": _rlib_pcall,
    "status_reply": _rlib_status_reply, "error_reply": _rlib_error_reply,
    "sha1hex": _rlib_sha1hex, "log": _rlib_log,
    "breakpoint": _rlib_breakpoint, "debug": _rlib_log,
    "replicate_commands": _rlib_replicate_commands,
    "setresp": _rlib_log,
}


def resp_to_lua(reply, status_class=None):
    """RESP reply -> Lua value (redis conversion table, RESP2 rules):
    integer->number, bulk->string, nil->false, array->table,
    status->{ok=...}. Host errors never reach here (redis_call raises)."""
    if reply is None:
        return False
    if isinstance(reply, bool):
        return reply
    if isinstance(reply, int):
        return float(reply)
    if isinstance(reply, float):
        # RESP2 has no double type: redis converts via bulk string
        return _fmt_num(reply)
    if isinstance(reply, bytes):
        return reply
    if status_class is not None and isinstance(reply, status_class):
        t = LuaTable()
        t.data[b"ok"] = _b(str(reply))
        return t
    if isinstance(reply, str):
        # plain str encodes as a bulk string on this engine's wire
        # (server/resp.py _encode_into); only the status_class marker
        # (SimpleString) is a status line
        return _b(reply)
    if isinstance(reply, (list, tuple)):
        return LuaTable.from_list(
            [resp_to_lua(x, status_class) for x in reply])
    if isinstance(reply, dict):  # RESP3 map -> flattened array (RESP2 view)
        flat = []
        for k, v in reply.items():
            flat.append(resp_to_lua(k, status_class))
            flat.append(resp_to_lua(v, status_class))
        return LuaTable.from_list(flat)
    return _lua_tostring(reply)


def lua_to_resp(v, status_factory=None, error_factory=None):
    """Lua value -> RESP reply (redis conversion table): false->nil,
    true->1, number->trunc int, string->bulk, {ok=}->status,
    {err=}->error (via error_factory), table->array until first nil."""
    if v is None or v is False or v is CJSON_NULL:
        return None
    if v is True:
        return 1
    if isinstance(v, (int, float)):
        # redis applies a C (long long) cast; non-finite / out-of-range
        # doubles must not leak OverflowError (ADVICE r4: `return 1/0`)
        if isinstance(v, float):
            if math.isnan(v):
                return 0
            if math.isinf(v) or not (-(2.0**63) <= v < 2.0**63):
                return (2**63 - 1) if v > 0 else -(2**63)
        return int(v)
    if isinstance(v, bytes):
        return v
    if isinstance(v, LuaTable):
        ok = v.data.get(b"ok")
        if ok is not None:
            s = _tostr(ok if isinstance(ok, bytes) else _lua_tostring(ok))
            return status_factory(s) if status_factory else s
        err = v.data.get(b"err")
        if err is not None and error_factory is not None:
            return error_factory(_tostr(
                err if isinstance(err, bytes) else _lua_tostring(err)))
        out = []
        i = 1
        while True:
            x = v.data.get(i)
            if x is None:
                break
            out.append(lua_to_resp(x, status_factory, error_factory))
            i += 1
        return out
    if isinstance(v, _LuaFunction) or callable(v):
        return None
    return _lua_tostring(v)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def compile_script(src: str):
    """Parse a script to an AST; raises LuaError on syntax errors.
    Used by SCRIPT LOAD for early rejection and cached by sha."""
    return _Parser(_lex(src)).parse_chunk()
