"""Clean-room mini-JavaScript engine (ES5-ish subset) on lark + closure
compilation.

Purpose: execute the UNMODIFIED reference GTM player
(/root/reference/decoders/htmljs/gtm.player.js, lzma.js, lzma.shim.js)
inside the test environment, which has no node/browser, so repo-encoded
GTM streams can be conformance-checked against the real JS decoder
semantics. This is NOT a port of any
reference code: it is a generic interpreter for the language subset those
files use (prototypes, `new`/`this`, closures, typed arrays, switch,
try/catch, do-while, 32-bit bitwise ops).

Architecture: lark LALR grammar -> parse tree -> compile() turns each node
into a Python closure taking an Env; function scopes are resolved
statically (params + hoisted `var`/function declarations become frame
slots, free identifiers walk materialized parent frames, everything else
is a global). Control flow uses Python exceptions (BreakExc / ReturnExc /
JSThrow).

JS semantics implemented with care:
  - numbers are Python floats; bitwise ops go through ToInt32/ToUint32
  - `+` does string concatenation when either side is a string
  - loose `==` covers the number/string/null/undefined cases
  - `%` is fmod (dividend sign), Math.round is half-toward-+Infinity
  - Uint8Array wraps mod 256 on store, Uint8ClampedArray clamps
"""
from __future__ import annotations

import math

from lark import Lark, Token, Tree

# ---------------------------------------------------------------------------
# Values
# ---------------------------------------------------------------------------


class JSUndefined:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return 'undefined'

    def __bool__(self):
        return False


undefined = JSUndefined()


class JSObject:
    __slots__ = ('props', 'proto')

    def __init__(self, proto=None):
        self.props = {}
        self.proto = proto

    def get(self, name):
        o = self
        while o is not None:
            if name in o.props:
                return o.props[name]
            o = o.proto
        return undefined

    def set(self, name, value):
        self.props[name] = value


class JSArray(JSObject):
    __slots__ = ('items',)

    def __init__(self, items=None):
        super().__init__()
        self.items = items if items is not None else []


class JSFunction(JSObject):
    __slots__ = ('name', 'nparams', 'call_impl')

    def __init__(self, name, nparams, call_impl):
        super().__init__()
        self.name = name
        self.nparams = nparams
        self.call_impl = call_impl  # (this, args) -> value

    def get(self, name):
        if name == 'prototype' and 'prototype' not in self.props:
            self.props['prototype'] = JSObject()
        return super().get(name)


class NativeFunction(JSFunction):
    __slots__ = ('construct_impl',)

    def __init__(self, name, fn, construct=None):
        super().__init__(name, 0, None)
        self.call_impl = lambda this, args: fn(this, args)
        self.construct_impl = construct


class JSException(Exception):
    """A JS `throw` in flight; .value is the thrown JS value."""

    def __init__(self, value):
        super().__init__(js_to_string(value) if not isinstance(value, JSObject)
                         else str(value.get('message')))
        self.value = value


class BreakExc(Exception):
    pass


class ContinueExc(Exception):
    pass


class ReturnExc(Exception):
    __slots__ = ('value',)

    def __init__(self, value):
        self.value = value


# Typed arrays / buffers ----------------------------------------------------


class ArrayBuffer:
    __slots__ = ('data',)

    def __init__(self, data):
        self.data = bytearray(data) if not isinstance(data, bytearray) else data


class TypedArray:
    """Uint8Array / Uint8ClampedArray over a bytearray."""
    __slots__ = ('data', 'clamped')

    def __init__(self, data, clamped=False):
        self.data = data  # bytearray
        self.clamped = clamped

    @classmethod
    def alloc(cls, n, clamped=False):
        return cls(bytearray(int(n)), clamped)

    def __len__(self):
        return len(self.data)

    def getidx(self, i):
        i = int(i)
        if 0 <= i < len(self.data):
            return float(self.data[i])
        return undefined

    def setidx(self, i, v):
        i = int(i)
        if not (0 <= i < len(self.data)):
            return  # JS typed arrays ignore OOB stores
        n = js_tonumber(v)
        if self.clamped:
            self.data[i] = min(255, max(0, int(js_round(n))))
        else:
            self.data[i] = to_int32(n) & 0xFF


# ---------------------------------------------------------------------------
# Coercions
# ---------------------------------------------------------------------------


def js_truthy(v):
    if v is undefined or v is None:
        return False
    if isinstance(v, bool):
        return v
    if isinstance(v, float):
        return not (v == 0.0 or math.isnan(v))
    if isinstance(v, str):
        return len(v) > 0
    return True  # objects/functions/arrays


def js_tonumber(v):
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, float):
        return v
    if v is undefined:
        return math.nan
    if v is None:
        return 0.0
    if isinstance(v, str):
        s = v.strip()
        if s == '':
            return 0.0
        try:
            if s.startswith(('0x', '0X')):
                return float(int(s, 16))
            return float(s)
        except ValueError:
            return math.nan
    return math.nan  # objects (no valueOf support needed)


def to_int32(x):
    if isinstance(x, bool):
        return int(x)
    if isinstance(x, float):
        if math.isnan(x) or math.isinf(x):
            return 0
        x = int(x)
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


def to_uint32(x):
    if isinstance(x, bool):
        return int(x)
    if isinstance(x, float):
        if math.isnan(x) or math.isinf(x):
            return 0
        x = int(x)
    return x & 0xFFFFFFFF


def js_round(x):
    # JS Math.round: half goes toward +Infinity
    return math.floor(x + 0.5)


def js_num_to_string(n):
    if math.isnan(n):
        return 'NaN'
    if math.isinf(n):
        return 'Infinity' if n > 0 else '-Infinity'
    if n == int(n) and abs(n) < 1e21:
        return str(int(n))
    return repr(n)


def js_to_string(v):
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return 'true' if v else 'false'
    if isinstance(v, float):
        return js_num_to_string(v)
    if v is undefined:
        return 'undefined'
    if v is None:
        return 'null'
    if isinstance(v, JSArray):
        return ','.join(js_to_string(x) for x in v.items)
    if isinstance(v, JSFunction):
        return f'function {v.name}() {{...}}'
    if isinstance(v, JSObject):
        msg = v.props.get('message')
        if msg is not None:
            return f'Error: {js_to_string(msg)}'
        return '[object Object]'
    if isinstance(v, TypedArray):
        return ','.join(str(b) for b in v.data)
    return str(v)


def js_add(a, b):
    if isinstance(a, str) or isinstance(b, str):
        return js_to_string(a) + js_to_string(b)
    return js_tonumber(a) + js_tonumber(b)


def js_loose_eq(a, b):
    if (a is undefined or a is None) and (b is undefined or b is None):
        return True
    if a is undefined or a is None or b is undefined or b is None:
        return False
    an = isinstance(a, (float, bool))
    bn = isinstance(b, (float, bool))
    if an and bn:
        return js_tonumber(a) == js_tonumber(b)
    if isinstance(a, str) and isinstance(b, str):
        return a == b
    if an and isinstance(b, str):
        return js_tonumber(a) == js_tonumber(b)
    if isinstance(a, str) and bn:
        return js_tonumber(a) == js_tonumber(b)
    return a is b


def js_strict_eq(a, b):
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if isinstance(a, float) and isinstance(b, float):
        return a == b
    if isinstance(a, str) and isinstance(b, str):
        return a == b
    if isinstance(a, bool) and isinstance(b, bool):
        return a == b
    return a is b


def js_lt(a, b):
    if isinstance(a, str) and isinstance(b, str):
        return a < b
    x, y = js_tonumber(a), js_tonumber(b)
    if math.isnan(x) or math.isnan(y):
        return False
    return x < y


# ---------------------------------------------------------------------------
# Grammar
# ---------------------------------------------------------------------------

GRAMMAR = r"""
?start: program
program: stmt*

?stmt: var_stmt
     | func_decl
     | if_stmt
     | for_stmt
     | while_stmt
     | dowhile_stmt
     | switch_stmt
     | break_stmt
     | continue_stmt
     | return_stmt
     | throw_stmt
     | try_stmt
     | block
     | empty_stmt
     | expr_stmt

var_stmt: VARKIND declarator ("," declarator)* ";"
VARKIND.2: "var" | "let" | "const"
declarator: NAME (ASSIGN_OP assign_expr)?

func_decl: "function" NAME "(" params ")" fbody
params: (NAME ("," NAME)*)?
fbody: "{" stmt* "}"

if_stmt: "if" "(" expr ")" stmt ("else" stmt)?
for_stmt: "for" "(" for_init? ";" for_cond ";" for_upd ")" stmt
for_init: VARKIND declarator ("," declarator)* -> for_var
        | expr                                 -> for_expr
for_cond: expr?
for_upd: expr?
while_stmt: "while" "(" expr ")" stmt
dowhile_stmt: "do" stmt "while" "(" expr ")" ";"?
switch_stmt: "switch" "(" expr ")" "{" case_clause* "}"
case_clause: "case" expr ":" stmt*   -> case_c
           | "default" ":" stmt*     -> default_c
break_stmt: "break" ";"
continue_stmt: "continue" ";"
return_stmt: "return" expr? ";"
throw_stmt: "throw" expr ";"
try_stmt: "try" block "catch" "(" NAME ")" block
// statement-level blocks must be non-empty: `{}` at statement start would
// collide with the empty object literal (JS resolves this by forbidding
// expression statements that start with "{"; none of the target files use
// an empty statement block)
block: "{" stmt+ "}"
empty_stmt: ";"
expr_stmt: expr ";"

?expr: assign_expr ("," assign_expr)*

?assign_expr: cond_expr
            | lhs_target ASSIGN_OP assign_expr -> assign

ASSIGN_OP.4: "+=" | "-=" | "*=" | "/=" | "%=" | "<<=" | ">>>=" | ">>="
           | "&=" | "|=" | "^=" | "="

?lhs_target: postfix_chain

?cond_expr: or_expr
          | or_expr "?" assign_expr ":" assign_expr -> ternary

?or_expr: and_expr | or_expr "||" and_expr -> logical_or
?and_expr: bitor_expr | and_expr "&&" bitor_expr -> logical_and
?bitor_expr: bitxor_expr | bitor_expr "|" bitxor_expr -> bit_or
?bitxor_expr: bitand_expr | bitxor_expr "^" bitand_expr -> bit_xor
?bitand_expr: eq_expr | bitand_expr "&" eq_expr -> bit_and
?eq_expr: rel_expr
        | eq_expr EQ_OP rel_expr -> equality
EQ_OP.5: "===" | "!==" | "==" | "!="
?rel_expr: shift_expr
         | rel_expr REL_OP shift_expr -> relational
         | rel_expr "instanceof" shift_expr -> instanceof
REL_OP.2: "<=" | ">=" | "<" | ">"
?shift_expr: add_expr
           | shift_expr SHIFT_OP add_expr -> shift
SHIFT_OP.3: ">>>" | "<<" | ">>"
?add_expr: mul_expr
         | add_expr ADD_OP mul_expr -> additive
ADD_OP: "+" | "-"
?mul_expr: unary_expr
         | mul_expr MUL_OP unary_expr -> multiplicative
MUL_OP: "*" | "/" | "%"

?unary_expr: postfix_expr
           | "!" unary_expr  -> not_op
           | "~" unary_expr  -> bitnot_op
           | "-" unary_expr  -> neg_op
           | "+" unary_expr  -> plus_op
           | "typeof" unary_expr -> typeof_op
           | PF_OP unary_expr -> prefix_incdec

?postfix_expr: postfix_chain
             | postfix_chain PF_OP -> postfix
PF_OP.4: "++" | "--"

?postfix_chain: primary
              | postfix_chain "." NAME        -> member_dot
              | postfix_chain "[" expr "]"    -> member_idx
              | postfix_chain "(" arglist ")" -> call
              | "new" postfix_chain           -> new_expr

arglist: (assign_expr ("," assign_expr)*)?

?primary: NUMBER           -> number
        | STRING           -> string
        | "true"           -> true_lit
        | "false"          -> false_lit
        | "null"           -> null_lit
        | "this"           -> this_expr
        | NAME             -> ident
        | array_lit
        | object_lit
        | func_expr
        | "(" expr ")"

array_lit: "[" (assign_expr ("," assign_expr)* ","?)? "]"
object_lit: "{" (prop ("," prop)* ","?)? "}"
prop: prop_key ":" assign_expr
?prop_key: NAME | STRING | NUMBER
// anonymous only: named function expressions are renamed away by the
// _preprocess pass (they'd collide with func_decl under LALR)
func_expr: "function" "(" params ")" fbody

NUMBER: /0[xX][0-9a-fA-F]+|(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?/
STRING: /'([^'\\\n]|\\.)*'|"([^"\\\n]|\\.)*"/
NAME: /[A-Za-z_$][A-Za-z0-9_$]*/

LINE_COMMENT: /\/\/[^\n]*/
BLOCK_COMMENT: /\/\*([^*]|\*(?!\/))*\*\//
%ignore LINE_COMMENT
%ignore BLOCK_COMMENT
%ignore /\s+/
"""

_parser = None


def get_parser():
    global _parser
    if _parser is None:
        _parser = Lark(GRAMMAR, parser='lalr', propagate_positions=True)
    return _parser


def parse_with_asi(source, max_fixups=200):
    """Parse; on failure, emulate automatic-semicolon-insertion by adding a
    ';' at the error point when the error token starts a new line (the only
    ASI form the target files rely on), and retry."""
    from lark.exceptions import UnexpectedInput
    lines = source.split('\n')
    for _ in range(max_fixups):
        src = '\n'.join(lines)
        try:
            return get_parser().parse(src)
        except UnexpectedInput as e:
            line, col = e.line, e.column
            if line is None or line <= 1:
                raise
            # insert ';' at end of the previous code line (skip blank and
            # comment-only lines)
            def is_code(s):
                t = s.strip()
                return t and not t.startswith(('//', '/*', '*'))
            prev = line - 2
            while prev >= 0 and not is_code(lines[prev]):
                prev -= 1
            if prev < 0 or lines[prev].rstrip().endswith(';'):
                raise
            lines[prev] = lines[prev].rstrip() + ';'
    raise SyntaxError('too many ASI fixups')


# ---------------------------------------------------------------------------
# Scopes / environments
# ---------------------------------------------------------------------------


class Env:
    __slots__ = ('slots', 'parent', 'this_val')

    def __init__(self, nslots, parent, this_val):
        self.slots = [undefined] * nslots
        self.parent = parent
        self.this_val = this_val


class Scope:
    """Compile-time function scope: maps names -> slots."""

    def __init__(self, parent=None):
        self.parent = parent
        self.names = {}

    def declare(self, name):
        if name not in self.names:
            self.names[name] = len(self.names)
        return self.names[name]

    def resolve(self, name):
        depth = 0
        s = self
        while s is not None:
            if name in s.names:
                return depth, s.names[name]
            s = s.parent
            depth += 1
        return None  # global


# ---------------------------------------------------------------------------
# Hoisting: collect var/function declarations of a function body
# ---------------------------------------------------------------------------


def _collect_hoisted(node, names, funcs, top=False):
    """Walk statements (not descending into nested functions), collecting
    `var` names and function declarations."""
    if isinstance(node, Token):
        return
    d = node.data
    if d == 'func_decl':
        names.append(str(node.children[0]))
        funcs.append(node)
        return
    if d == 'var_stmt' or d == 'for_var':
        for decl in node.children:
            if isinstance(decl, Tree) and decl.data == 'declarator':
                names.append(str(decl.children[0]))
        # fall through: declarator initializers contain no declarations
        return
    if d == 'func_expr':
        return  # new scope
    for c in node.children:
        if isinstance(c, Tree):
            _collect_hoisted(c, names, funcs)


# ---------------------------------------------------------------------------
# Compiler
# ---------------------------------------------------------------------------


class Interpreter:
    def __init__(self):
        self.globals = {}
        self._install_builtins()

    # -- public ------------------------------------------------------------

    def run(self, source):
        tree = parse_with_asi(_preprocess(source))
        prog = self.compile_program(tree)
        prog()

    def get_global(self, name):
        return self.globals.get(name, undefined)

    def set_global(self, name, value):
        self.globals[name] = value

    def call(self, fn, args, this=undefined):
        """Call a JS function value from Python."""
        return fn.call_impl(this, list(args))

    def construct(self, fn, args):
        """`new fn(...args)` from Python."""
        if isinstance(fn, NativeFunction) and fn.construct_impl is not None:
            return fn.construct_impl(list(args))
        proto = fn.get('prototype')
        obj = JSObject(proto if isinstance(proto, JSObject) else None)
        r = fn.call_impl(obj, list(args))
        return r if isinstance(r, JSObject) else obj

    def native(self, name, fn):
        """Wrap python fn(this, args) as a JS function."""
        return NativeFunction(name, fn)

    # -- program / function compilation -------------------------------------

    def compile_program(self, tree):
        scope = None  # program level: everything is global
        names, funcs = [], []
        for st in tree.children:
            _collect_hoisted(st, names, funcs)
        for n in names:
            self.globals.setdefault(n, undefined)
        stmts = [self.c_stmt(s, scope) for s in tree.children]
        fdecls = [(str(f.children[0]), self.compile_function(f, scope))
                  for f in funcs]

        def prog():
            for fname, fmk in fdecls:
                self.globals[fname] = fmk(None)
            for s in stmts:
                s(None)
        return prog

    def compile_function(self, node, scope):
        """node: func_decl or func_expr. Returns maker(env) -> JSFunction."""
        if node.data == 'func_decl':
            name = str(node.children[0])
            params_t, body = node.children[1], node.children[2]
        else:
            name = ''
            params_t, body = node.children[0], node.children[1]
        params = [str(t) for t in params_t.children]

        fscope = Scope(scope)
        for p in params:
            fscope.declare(p)
        hnames, hfuncs = [], []
        for st in body.children:
            _collect_hoisted(st, hnames, hfuncs)
        for n in hnames:
            fscope.declare(n)
        nslots_box = [0]
        stmts = [self.c_stmt(s, fscope) for s in body.children]
        fdecls = [(fscope.names[str(f.children[0])],
                   self.compile_function(f, fscope)) for f in hfuncs]
        nslots_box[0] = len(fscope.names)
        nparams = len(params)

        def maker(defenv):
            def call_impl(this, args):
                env = Env(nslots_box[0], defenv, this)
                na = min(len(args), nparams)
                env.slots[:na] = args[:na]
                for slot, fmk in fdecls:
                    env.slots[slot] = fmk(env)
                try:
                    for s in stmts:
                        s(env)
                except ReturnExc as r:
                    return r.value
                return undefined
            return JSFunction(name, nparams, call_impl)
        return maker

    # -- statements ----------------------------------------------------------

    def c_stmt(self, node, scope):
        d = node.data
        m = getattr(self, 's_' + d, None)
        if m is None:
            raise NotImplementedError(f'stmt {d}')
        return m(node, scope)

    def s_func_decl(self, node, scope):
        return lambda env: None  # hoisted

    def s_empty_stmt(self, node, scope):
        return lambda env: None

    def s_expr_stmt(self, node, scope):
        e = self.c_expr(node.children[0], scope)
        return lambda env: e(env)

    def s_var_stmt(self, node, scope):
        parts = []
        for decl in node.children[1:]:
            name = str(decl.children[0])
            init = (self.c_expr(decl.children[-1], scope)
                    if len(decl.children) > 1 else None)
            parts.append((self._store(name, scope), init))

        def run(env):
            for store, init in parts:
                if init is not None:
                    store(env, init(env))
        return run

    def s_block(self, node, scope):
        stmts = [self.c_stmt(s, scope) for s in node.children]

        def run(env):
            for s in stmts:
                s(env)
        return run

    def s_if_stmt(self, node, scope):
        cond = self.c_expr(node.children[0], scope)
        then = self.c_stmt(node.children[1], scope)
        els = (self.c_stmt(node.children[2], scope)
               if len(node.children) > 2 else None)

        def run(env):
            if js_truthy(cond(env)):
                then(env)
            elif els is not None:
                els(env)
        return run

    def s_for_stmt(self, node, scope):
        kids = list(node.children)
        body = kids.pop()
        init = None
        if isinstance(kids[0], Tree) and \
                kids[0].data in ('for_var', 'for_expr'):
            init = kids[0]
            kids = kids[1:]
        cond_w, upd_w = kids
        cond = cond_w.children[0] if cond_w.children else None
        update = upd_w.children[0] if upd_w.children else None

        if init is not None:
            if init.data == 'for_var':
                fake = Tree('var_stmt', init.children)
                init_c = self.s_var_stmt(fake, scope)
            else:
                e = self.c_expr(init.children[0], scope)
                init_c = lambda env: e(env)
        else:
            init_c = lambda env: None
        cond_c = self.c_expr(cond, scope) if cond is not None else None
        upd_c = self.c_expr(update, scope) if update is not None else None
        body_c = self.c_stmt(body, scope)

        def run(env):
            init_c(env)
            while cond_c is None or js_truthy(cond_c(env)):
                try:
                    body_c(env)
                except BreakExc:
                    break
                except ContinueExc:
                    pass
                if upd_c is not None:
                    upd_c(env)
        return run

    def s_while_stmt(self, node, scope):
        cond = self.c_expr(node.children[0], scope)
        body = self.c_stmt(node.children[1], scope)

        def run(env):
            while js_truthy(cond(env)):
                try:
                    body(env)
                except BreakExc:
                    break
                except ContinueExc:
                    pass
        return run

    def s_dowhile_stmt(self, node, scope):
        body = self.c_stmt(node.children[0], scope)
        cond = self.c_expr(node.children[1], scope)

        def run(env):
            while True:
                try:
                    body(env)
                except BreakExc:
                    break
                except ContinueExc:
                    pass
                if not js_truthy(cond(env)):
                    break
        return run

    def s_switch_stmt(self, node, scope):
        disc = self.c_expr(node.children[0], scope)
        cases = []   # (test_or_None, [stmts])
        for cl in node.children[1:]:
            if cl.data == 'case_c':
                test = self.c_expr(cl.children[0], scope)
                stmts = [self.c_stmt(s, scope) for s in cl.children[1:]]
            else:
                test = None
                stmts = [self.c_stmt(s, scope) for s in cl.children]
            cases.append((test, stmts))

        def run(env):
            v = disc(env)
            start = None
            for i, (test, _) in enumerate(cases):
                if test is not None and js_strict_eq(v, test(env)):
                    start = i
                    break
            if start is None:
                for i, (test, _) in enumerate(cases):
                    if test is None:
                        start = i
                        break
            if start is None:
                return
            try:
                for _, stmts in cases[start:]:
                    for s in stmts:
                        s(env)
            except BreakExc:
                pass
        return run

    def s_break_stmt(self, node, scope):
        def run(env):
            raise BreakExc()
        return run

    def s_continue_stmt(self, node, scope):
        def run(env):
            raise ContinueExc()
        return run

    def s_return_stmt(self, node, scope):
        val = (self.c_expr(node.children[0], scope)
               if node.children else None)

        def run(env):
            raise ReturnExc(val(env) if val is not None else undefined)
        return run

    def s_throw_stmt(self, node, scope):
        val = self.c_expr(node.children[0], scope)

        def run(env):
            raise JSException(val(env))
        return run

    def s_try_stmt(self, node, scope):
        body = self.s_block(node.children[0], scope)
        # catch param lives in the enclosing function scope (ES5 quirk is a
        # dedicated scope; a slot in the function scope is adequate here)
        pname = str(node.children[1])
        if scope is not None:
            scope.declare(pname)
            store = self._store(pname, scope)
        else:
            store = self._store(pname, None)
        handler = self.s_block(node.children[2], scope)

        def run(env):
            try:
                body(env)
            except JSException as ex:
                store(env, ex.value)
                handler(env)
        return run

    # -- identifier load/store ----------------------------------------------

    def _load(self, name, scope):
        res = scope.resolve(name) if scope is not None else None
        if res is None:
            g = self.globals

            def load(env):
                try:
                    return g[name]
                except KeyError:
                    raise JSException(self._mkerror(
                        f'{name} is not defined'))
            return load
        depth, slot = res
        if depth == 0:
            return lambda env: env.slots[slot]

        def load(env):
            e = env
            for _ in range(depth):
                e = e.parent
            return e.slots[slot]
        return load

    def _store(self, name, scope):
        res = scope.resolve(name) if scope is not None else None
        if res is None:
            g = self.globals

            def store(env, v):
                g[name] = v
            return store
        depth, slot = res
        if depth == 0:
            def store0(env, v):
                env.slots[slot] = v
            return store0

        def store(env, v):
            e = env
            for _ in range(depth):
                e = e.parent
            e.slots[slot] = v
        return store

    # -- expressions ---------------------------------------------------------

    def c_expr(self, node, scope):
        if isinstance(node, Token):
            raise NotImplementedError(f'token expr {node.type}')
        d = node.data
        if d == 'expr':  # comma operator
            parts = [self.c_expr(c, scope) for c in node.children]

            def run(env):
                v = undefined
                for p in parts:
                    v = p(env)
                return v
            return run
        m = getattr(self, 'e_' + d, None)
        if m is None:
            raise NotImplementedError(f'expr {d}')
        return m(node, scope)

    def e_number(self, node, scope):
        t = str(node.children[0])
        if t.startswith(('0x', '0X')):
            v = float(int(t, 16))
        else:
            v = float(t)
        return lambda env: v

    def e_string(self, node, scope):
        raw = str(node.children[0])[1:-1]
        v = _unescape(raw)
        return lambda env: v

    def e_true_lit(self, node, scope):
        return lambda env: True

    def e_false_lit(self, node, scope):
        return lambda env: False

    def e_null_lit(self, node, scope):
        return lambda env: None

    def e_this_expr(self, node, scope):
        def run(env):
            e = env
            while e is not None:
                return e.this_val
            return undefined
        return run

    def e_ident(self, node, scope):
        name = str(node.children[0])
        if name == 'undefined':
            return lambda env: undefined
        return self._load(name, scope)

    def e_array_lit(self, node, scope):
        parts = [self.c_expr(c, scope) for c in node.children]
        return lambda env: JSArray([p(env) for p in parts])

    def e_object_lit(self, node, scope):
        props = []
        for p in node.children:
            key = p.children[0]
            k = str(key)
            if k and k[0] in '\'"':
                k = _unescape(k[1:-1])
            props.append((k, self.c_expr(p.children[1], scope)))

        def run(env):
            o = JSObject()
            for k, v in props:
                o.props[k] = v(env)
            return o
        return run

    def e_func_expr(self, node, scope):
        maker = self.compile_function(node, scope)
        return lambda env: maker(env)

    def e_member_dot(self, node, scope):
        obj = self.c_expr(node.children[0], scope)
        name = str(node.children[1])
        getprop = self.get_property
        return lambda env: getprop(obj(env), name)

    def e_member_idx(self, node, scope):
        obj = self.c_expr(node.children[0], scope)
        idx = self.c_expr(node.children[1], scope)
        getidx = self.get_index
        return lambda env: getidx(obj(env), idx(env))

    def e_call(self, node, scope):
        callee = node.children[0]
        args = [self.c_expr(a, scope) for a in node.children[1].children]
        if isinstance(callee, Tree) and callee.data == 'member_dot':
            objc = self.c_expr(callee.children[0], scope)
            name = str(callee.children[1])
            getprop = self.get_property

            def run_method(env):
                o = objc(env)
                f = getprop(o, name)
                if not isinstance(f, JSFunction):
                    raise JSException(self._mkerror(
                        f'{name} is not a function'))
                return f.call_impl(o, [a(env) for a in args])
            return run_method
        if isinstance(callee, Tree) and callee.data == 'member_idx':
            objc = self.c_expr(callee.children[0], scope)
            idxc = self.c_expr(callee.children[1], scope)
            getidx = self.get_index

            def run_method_idx(env):
                o = objc(env)
                f = getidx(o, idxc(env))
                return f.call_impl(o, [a(env) for a in args])
            return run_method_idx
        fc = self.c_expr(callee, scope)

        def run(env):
            f = fc(env)
            if not isinstance(f, JSFunction):
                raise JSException(self._mkerror('value is not a function'))
            return f.call_impl(undefined, [a(env) for a in args])
        return run

    def e_new_expr(self, node, scope):
        chain = node.children[0]
        # locate the first call trailer in the chain: new A.B(args).rest...
        # our subset always has `new ctor(args)` with ctor a dot-chain.
        if isinstance(chain, Tree) and chain.data == 'call':
            callee = chain.children[0]
            # ensure the constructor expression has no nested call: patterns
            # like `new A().b()` would mis-associate and must be rejected
            n = callee
            while isinstance(n, Tree) and n.data in ('member_dot',
                                                     'member_idx'):
                n = n.children[0]
            if isinstance(n, Tree) and n.data in ('call', 'new_expr'):
                raise NotImplementedError('new with chained call')
            ctor_c = self.c_expr(callee, scope)
            args = [self.c_expr(a, scope)
                    for a in chain.children[1].children]
        else:
            ctor_c = self.c_expr(chain, scope)
            args = []

        def run(env):
            f = ctor_c(env)
            argv = [a(env) for a in args]
            if isinstance(f, NativeFunction) and f.construct_impl is not None:
                return f.construct_impl(argv)
            proto = f.get('prototype')
            obj = JSObject(proto if isinstance(proto, JSObject) else None)
            r = f.call_impl(obj, argv)
            return r if isinstance(r, JSObject) else obj
        return run

    def e_assign(self, node, scope):
        target, op_t, value = node.children
        op = str(op_t)
        val = self.c_expr(value, scope)
        if op != '=':
            binop = _compound_op(op[:-1])
        else:
            binop = None

        if isinstance(target, Tree) and target.data == 'ident':
            name = str(target.children[0])
            store = self._store(name, scope)
            if binop is None:
                def run(env):
                    v = val(env)
                    store(env, v)
                    return v
                return run
            load = self._load(name, scope)

            def run_c(env):
                v = binop(load(env), val(env))
                store(env, v)
                return v
            return run_c

        if isinstance(target, Tree) and target.data == 'member_dot':
            objc = self.c_expr(target.children[0], scope)
            name = str(target.children[1])
            setprop, getprop = self.set_property, self.get_property
            if binop is None:
                def run_m(env):
                    o = objc(env)
                    v = val(env)
                    setprop(o, name, v)
                    return v
                return run_m

            def run_mc(env):
                o = objc(env)
                v = binop(getprop(o, name), val(env))
                setprop(o, name, v)
                return v
            return run_mc

        if isinstance(target, Tree) and target.data == 'member_idx':
            objc = self.c_expr(target.children[0], scope)
            idxc = self.c_expr(target.children[1], scope)
            setidx, getidx = self.set_index, self.get_index
            if binop is None:
                def run_i(env):
                    o = objc(env)
                    i = idxc(env)
                    v = val(env)
                    setidx(o, i, v)
                    return v
                return run_i

            def run_ic(env):
                o = objc(env)
                i = idxc(env)
                v = binop(getidx(o, i), val(env))
                setidx(o, i, v)
                return v
            return run_ic
        raise NotImplementedError('assignment target')

    def e_ternary(self, node, scope):
        c = self.c_expr(node.children[0], scope)
        a = self.c_expr(node.children[1], scope)
        b = self.c_expr(node.children[2], scope)
        return lambda env: a(env) if js_truthy(c(env)) else b(env)

    def e_logical_or(self, node, scope):
        a = self.c_expr(node.children[0], scope)
        b = self.c_expr(node.children[1], scope)

        def run(env):
            v = a(env)
            return v if js_truthy(v) else b(env)
        return run

    def e_logical_and(self, node, scope):
        a = self.c_expr(node.children[0], scope)
        b = self.c_expr(node.children[1], scope)

        def run(env):
            v = a(env)
            return b(env) if js_truthy(v) else v
        return run

    def e_bit_or(self, node, scope):
        a = self.c_expr(node.children[0], scope)
        b = self.c_expr(node.children[1], scope)
        return lambda env: float(to_int32(js_tonumber(a(env)))
                                 | to_int32(js_tonumber(b(env))))

    def e_bit_xor(self, node, scope):
        a = self.c_expr(node.children[0], scope)
        b = self.c_expr(node.children[1], scope)
        return lambda env: float(to_int32(js_tonumber(a(env)))
                                 ^ to_int32(js_tonumber(b(env))))

    def e_bit_and(self, node, scope):
        a = self.c_expr(node.children[0], scope)
        b = self.c_expr(node.children[1], scope)
        return lambda env: float(to_int32(js_tonumber(a(env)))
                                 & to_int32(js_tonumber(b(env))))

    def e_equality(self, node, scope):
        a = self.c_expr(node.children[0], scope)
        op = str(node.children[1])
        b = self.c_expr(node.children[2], scope)
        if op == '==':
            return lambda env: js_loose_eq(a(env), b(env))
        if op == '!=':
            return lambda env: not js_loose_eq(a(env), b(env))
        if op == '===':
            return lambda env: js_strict_eq(a(env), b(env))
        return lambda env: not js_strict_eq(a(env), b(env))

    def e_relational(self, node, scope):
        a = self.c_expr(node.children[0], scope)
        op = str(node.children[1])
        b = self.c_expr(node.children[2], scope)
        if op == '<':
            return lambda env: js_lt(a(env), b(env))
        if op == '>':
            return lambda env: js_lt(b(env), a(env))
        if op == '<=':
            return lambda env: (not js_lt(b(env), a(env))
                                and not _nan_cmp(a(env), b(env)))
        return lambda env: (not js_lt(a(env), b(env))
                            and not _nan_cmp(a(env), b(env)))

    def e_instanceof(self, node, scope):
        a = self.c_expr(node.children[0], scope)
        b = self.c_expr(node.children[1], scope)

        def run(env):
            o, f = a(env), b(env)
            if not isinstance(o, JSObject) or not isinstance(f, JSFunction):
                return False
            proto = f.get('prototype')
            p = o.proto
            while p is not None:
                if p is proto:
                    return True
                p = p.proto
            return False
        return run

    def e_shift(self, node, scope):
        a = self.c_expr(node.children[0], scope)
        op = str(node.children[1])
        b = self.c_expr(node.children[2], scope)
        if op == '<<':
            return lambda env: float(to_int32(
                to_int32(js_tonumber(a(env)))
                << (to_uint32(js_tonumber(b(env))) & 31)))
        if op == '>>':
            return lambda env: float(
                to_int32(js_tonumber(a(env)))
                >> (to_uint32(js_tonumber(b(env))) & 31))
        return lambda env: float(
            to_uint32(js_tonumber(a(env)))
            >> (to_uint32(js_tonumber(b(env))) & 31))

    def e_additive(self, node, scope):
        a = self.c_expr(node.children[0], scope)
        op = str(node.children[1])
        b = self.c_expr(node.children[2], scope)
        if op == '+':
            return lambda env: js_add(a(env), b(env))
        return lambda env: js_tonumber(a(env)) - js_tonumber(b(env))

    def e_multiplicative(self, node, scope):
        a = self.c_expr(node.children[0], scope)
        op = str(node.children[1])
        b = self.c_expr(node.children[2], scope)
        if op == '*':
            return lambda env: js_tonumber(a(env)) * js_tonumber(b(env))
        if op == '/':
            def run(env):
                x, y = js_tonumber(a(env)), js_tonumber(b(env))
                if y == 0:
                    if x == 0 or math.isnan(x):
                        return math.nan
                    return math.inf if (x > 0) == (not _is_neg_zero(y)) \
                        else -math.inf
                return x / y
            return run

        def run_mod(env):
            x, y = js_tonumber(a(env)), js_tonumber(b(env))
            if y == 0 or math.isnan(x) or math.isnan(y) or math.isinf(x):
                return math.nan
            return math.fmod(x, y)
        return run_mod

    def e_not_op(self, node, scope):
        a = self.c_expr(node.children[0], scope)
        return lambda env: not js_truthy(a(env))

    def e_bitnot_op(self, node, scope):
        a = self.c_expr(node.children[0], scope)
        return lambda env: float(~to_int32(js_tonumber(a(env))))

    def e_neg_op(self, node, scope):
        a = self.c_expr(node.children[0], scope)
        return lambda env: -js_tonumber(a(env))

    def e_plus_op(self, node, scope):
        a = self.c_expr(node.children[0], scope)
        return lambda env: js_tonumber(a(env))

    def e_typeof_op(self, node, scope):
        a = self.c_expr(node.children[0], scope)

        def run(env):
            v = a(env)
            if v is undefined:
                return 'undefined'
            if isinstance(v, bool):
                return 'boolean'
            if isinstance(v, float):
                return 'number'
            if isinstance(v, str):
                return 'string'
            if isinstance(v, JSFunction):
                return 'function'
            return 'object'
        return run

    def _incdec(self, node, scope, delta, pre):
        target = node.children[0]
        if isinstance(target, Tree) and target.data == 'ident':
            name = str(target.children[0])
            load, store = self._load(name, scope), self._store(name, scope)

            def run(env):
                old = js_tonumber(load(env))
                new = old + delta
                store(env, new)
                return new if pre else old
            return run
        if isinstance(target, Tree) and target.data == 'member_dot':
            objc = self.c_expr(target.children[0], scope)
            nm = str(target.children[1])
            gp, sp = self.get_property, self.set_property

            def run_m(env):
                o = objc(env)
                old = js_tonumber(gp(o, nm))
                new = old + delta
                sp(o, nm, new)
                return new if pre else old
            return run_m
        if isinstance(target, Tree) and target.data == 'member_idx':
            objc = self.c_expr(target.children[0], scope)
            idxc = self.c_expr(target.children[1], scope)
            gi, si = self.get_index, self.set_index

            def run_i(env):
                o = objc(env)
                i = idxc(env)
                old = js_tonumber(gi(o, i))
                new = old + delta
                si(o, i, new)
                return new if pre else old
            return run_i
        raise NotImplementedError('inc/dec target')

    def e_prefix_incdec(self, node, scope):
        op = str(node.children[0])
        fake = Tree('x', [node.children[1]])
        return self._incdec(fake, scope, 1.0 if op == '++' else -1.0, True)

    def e_postfix(self, node, scope):
        op = str(node.children[1])
        return self._incdec(node, scope, 1.0 if op == '++' else -1.0, False)

    # -- property / index dispatch ------------------------------------------

    def get_property(self, o, name):
        if isinstance(o, JSArray):
            if name == 'length':
                return float(len(o.items))
            m = _ARRAY_METHODS.get(name)
            if m is not None:
                return m
            return o.get(name)
        if isinstance(o, TypedArray):
            if name == 'length' or name == 'byteLength':
                return float(len(o.data))
            return _TYPED_METHODS[name]
        if isinstance(o, ArrayBuffer):
            if name == 'byteLength':
                return float(len(o.data))
            raise JSException(self._mkerror(f'ArrayBuffer.{name}'))
        if isinstance(o, str):
            if name == 'length':
                return float(len(o))
            raise JSException(self._mkerror(f'string.{name} unsupported'))
        if isinstance(o, JSObject):
            return o.get(name)
        if o is undefined or o is None:
            raise JSException(self._mkerror(
                f"cannot read property '{name}' of {js_to_string(o)}"))
        raise JSException(self._mkerror(
            f'property {name} on {type(o).__name__}'))

    def set_property(self, o, name, v):
        if isinstance(o, JSArray) and name == 'length':
            n = int(js_tonumber(v))
            if n < len(o.items):
                del o.items[n:]
            else:
                o.items.extend([undefined] * (n - len(o.items)))
            return
        if isinstance(o, JSObject):
            o.set(name, v)
            return
        raise JSException(self._mkerror(
            f'cannot set {name} on {type(o).__name__}'))

    def get_index(self, o, i):
        if isinstance(o, TypedArray):
            return o.getidx(js_tonumber(i))
        if isinstance(o, JSArray):
            if isinstance(i, str):
                return self.get_property(o, i)
            ii = int(js_tonumber(i))
            if 0 <= ii < len(o.items):
                return o.items[ii]
            return undefined
        if isinstance(o, str):
            if isinstance(i, str):
                return self.get_property(o, i)
            ii = int(js_tonumber(i))
            return o[ii] if 0 <= ii < len(o) else undefined
        if isinstance(o, JSObject):
            return self.get_property(o, js_to_string(i))
        raise JSException(self._mkerror(f'index on {type(o).__name__}'))

    def set_index(self, o, i, v):
        if isinstance(o, TypedArray):
            o.setidx(js_tonumber(i), v)
            return
        if isinstance(o, JSArray):
            ii = int(js_tonumber(i))
            if ii >= len(o.items):
                o.items.extend([undefined] * (ii + 1 - len(o.items)))
            o.items[ii] = v
            return
        if isinstance(o, JSObject):
            self.set_property(o, js_to_string(i), v)
            return
        raise JSException(self._mkerror(f'index set on {type(o).__name__}'))

    # -- builtins ------------------------------------------------------------

    def _mkerror(self, msg):
        o = JSObject()
        o.props['message'] = msg
        o.props['stack'] = msg
        return o

    def _install_builtins(self):
        g = self.globals

        def error_call(this, args):
            return self._mkerror(js_to_string(args[0]) if args else '')
        err = NativeFunction('Error', error_call,
                             construct=lambda argv: error_call(None, argv))
        g['Error'] = err

        math_obj = JSObject()
        math_obj.props.update({
            'min': self.native('min', lambda t, a: float(min(
                js_tonumber(x) for x in a))),
            'max': self.native('max', lambda t, a: float(max(
                js_tonumber(x) for x in a))),
            'round': self.native('round', lambda t, a: float(js_round(
                js_tonumber(a[0])))),
            'trunc': self.native('trunc', lambda t, a: float(math.trunc(
                js_tonumber(a[0])))),
            'floor': self.native('floor', lambda t, a: float(math.floor(
                js_tonumber(a[0])))),
            'ceil': self.native('ceil', lambda t, a: float(math.ceil(
                js_tonumber(a[0])))),
            'abs': self.native('abs', lambda t, a: abs(js_tonumber(a[0]))),
            'imul': self.native('imul', lambda t, a: float(to_int32(
                to_int32(js_tonumber(a[0])) * to_int32(js_tonumber(a[1]))))),
            'pow': self.native('pow', lambda t, a: float(
                js_tonumber(a[0]) ** js_tonumber(a[1]))),
            'sqrt': self.native('sqrt', lambda t, a: math.sqrt(
                js_tonumber(a[0]))),
        })
        math_obj.props.update({
        })
        g['Math'] = math_obj
        g['Infinity'] = math.inf
        g['NaN'] = math.nan

        def array_construct(argv):
            if len(argv) == 1 and isinstance(argv[0], float):
                return JSArray([undefined] * int(argv[0]))
            return JSArray(list(argv))
        g['Array'] = NativeFunction(
            'Array', lambda t, a: array_construct(a),
            construct=array_construct)

        def u8_construct(argv, clamped=False):
            if not argv:
                return TypedArray(bytearray(), clamped)
            a0 = argv[0]
            if isinstance(a0, float):
                return TypedArray.alloc(a0, clamped)
            if isinstance(a0, ArrayBuffer):
                return TypedArray(a0.data, clamped)  # view, shared storage
            if isinstance(a0, TypedArray):
                return TypedArray(bytearray(a0.data), clamped)
            if isinstance(a0, JSArray):
                b = bytearray(len(a0.items))
                for i, v in enumerate(a0.items):
                    b[i] = to_int32(js_tonumber(v)) & 0xFF
                return TypedArray(b, clamped)
            raise JSException(self._mkerror('bad Uint8Array arg'))
        g['Uint8Array'] = NativeFunction(
            'Uint8Array', lambda t, a: u8_construct(a),
            construct=u8_construct)
        g['Uint8ClampedArray'] = NativeFunction(
            'Uint8ClampedArray', lambda t, a: u8_construct(a, True),
            construct=lambda argv: u8_construct(argv, True))
        g['ArrayBuffer'] = NativeFunction(
            'ArrayBuffer', lambda t, a: ArrayBuffer(bytearray(
                int(js_tonumber(a[0])) if a else 0)),
            construct=lambda argv: ArrayBuffer(bytearray(
                int(js_tonumber(argv[0])) if argv else 0)))

        string_obj = NativeFunction('String',
                                    lambda t, a: js_to_string(
                                        a[0]) if a else '')
        string_obj.props['fromCharCode'] = self.native(
            'fromCharCode',
            lambda t, a: ''.join(chr(to_uint32(js_tonumber(x)) & 0xFFFF)
                                 for x in a))
        g['String'] = string_obj

        g['parseInt'] = self.native(
            'parseInt', lambda t, a: float(int(js_to_string(a[0]),
                                               int(js_tonumber(a[1]))
                                               if len(a) > 1 else 10)))


def _preprocess(source):
    """Strip the name from named function *expressions* (`= function f(`),
    which the LALR grammar cannot distinguish from declarations. The name
    only matters for self-reference, which none of the target files use."""
    import re
    return re.sub(r'(=\s*)function\s+[A-Za-z_$][A-Za-z0-9_$]*\s*\(',
                  r'\1function (', source)


def _nan_cmp(a, b):
    x, y = js_tonumber(a), js_tonumber(b)
    if isinstance(a, str) and isinstance(b, str):
        return False
    return math.isnan(x) or math.isnan(y)


def _is_neg_zero(y):
    return y == 0 and math.copysign(1.0, y) < 0


def _compound_op(op):
    if op == '+':
        return js_add
    if op == '-':
        return lambda a, b: js_tonumber(a) - js_tonumber(b)
    if op == '*':
        return lambda a, b: js_tonumber(a) * js_tonumber(b)
    if op == '/':
        return lambda a, b: js_tonumber(a) / js_tonumber(b)
    if op == '%':
        return lambda a, b: math.fmod(js_tonumber(a), js_tonumber(b))
    if op == '<<':
        return lambda a, b: float(to_int32(
            to_int32(js_tonumber(a)) << (to_uint32(js_tonumber(b)) & 31)))
    if op == '>>':
        return lambda a, b: float(
            to_int32(js_tonumber(a)) >> (to_uint32(js_tonumber(b)) & 31))
    if op == '>>>':
        return lambda a, b: float(
            to_uint32(js_tonumber(a)) >> (to_uint32(js_tonumber(b)) & 31))
    if op == '&':
        return lambda a, b: float(to_int32(js_tonumber(a))
                                  & to_int32(js_tonumber(b)))
    if op == '|':
        return lambda a, b: float(to_int32(js_tonumber(a))
                                  | to_int32(js_tonumber(b)))
    if op == '^':
        return lambda a, b: float(to_int32(js_tonumber(a))
                                  ^ to_int32(js_tonumber(b)))
    raise NotImplementedError(op)


def _unescape(s):
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == '\\' and i + 1 < len(s):
            n = s[i + 1]
            mapped = {'n': '\n', 't': '\t', 'r': '\r', 'b': '\b',
                      'f': '\f', 'v': '\v', '0': '\0',
                      "'": "'", '"': '"', '\\': '\\', '/': '/'}
            if n == 'x' and i + 3 < len(s):
                out.append(chr(int(s[i + 2:i + 4], 16)))
                i += 4
                continue
            if n == 'u' and i + 5 < len(s):
                out.append(chr(int(s[i + 2:i + 6], 16)))
                i += 6
                continue
            out.append(mapped.get(n, n))
            i += 2
        else:
            out.append(c)
            i += 1
    return ''.join(out)


# ---------------------------------------------------------------------------
# Array / typed-array method tables (created once, bound via `this`)
# ---------------------------------------------------------------------------


def _arr_push(this, args):
    this.items.extend(args)
    return float(len(this.items))


def _arr_slice(this, args):
    n = len(this.items)
    a = int(js_tonumber(args[0])) if args else 0
    b = int(js_tonumber(args[1])) if len(args) > 1 else n
    if a < 0:
        a += n
    if b < 0:
        b += n
    return JSArray(this.items[a:b])


def _arr_concat(this, args):
    out = list(this.items)
    for a in args:
        if isinstance(a, JSArray):
            out.extend(a.items)
        else:
            out.append(a)
    return JSArray(out)


def _arr_indexof(this, args):
    target = args[0] if args else undefined
    for i, v in enumerate(this.items):
        if js_strict_eq(v, target):
            return float(i)
    return -1.0


def _arr_join(this, args):
    sep = js_to_string(args[0]) if args else ','
    return sep.join(js_to_string(v) for v in this.items)


_ARRAY_METHODS = {
    'push': NativeFunction('push', _arr_push),
    'slice': NativeFunction('slice', _arr_slice),
    'concat': NativeFunction('concat', _arr_concat),
    'indexOf': NativeFunction('indexOf', _arr_indexof),
    'join': NativeFunction('join', _arr_join),
}


def _ta_set(this, args):
    src = args[0]
    off = int(js_tonumber(args[1])) if len(args) > 1 else 0
    if isinstance(src, TypedArray):
        this.data[off:off + len(src.data)] = src.data
    elif isinstance(src, JSArray):
        for i, v in enumerate(src.items):
            this.setidx(off + i, v)
    else:
        raise JSException(Interpreter._mkerror(None, 'bad set() src'))
    return undefined


def _ta_slice(this, args):
    n = len(this.data)
    a = int(js_tonumber(args[0])) if args else 0
    b = int(js_tonumber(args[1])) if len(args) > 1 else n
    if a < 0:
        a += n
    if b < 0:
        b += n
    return TypedArray(bytearray(this.data[a:b]), this.clamped)


def _ta_subarray(this, args):
    n = len(this.data)
    a = int(js_tonumber(args[0])) if args else 0
    b = int(js_tonumber(args[1])) if len(args) > 1 else n
    view = memoryview(this.data)[a:b]
    # bytearray slices copy; emulate view via a fresh TypedArray over the
    # same bytearray region is not possible with bytearray -- acceptable as
    # the reference files never call subarray.
    return TypedArray(bytearray(view), this.clamped)


_TYPED_METHODS = {
    'set': NativeFunction('set', _ta_set),
    'slice': NativeFunction('slice', _ta_slice),
    'subarray': NativeFunction('subarray', _ta_subarray),
}
