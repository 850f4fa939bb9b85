"""Coefficient programs: a coordinate callable traced once into a small
postfix program per component, which the stage kernels evaluate per node
(K1″, K3″, K6″) and which :func:`Program.evaluate` evaluates on tensors.

The JAX package needs none of this: Pallas traces a callable ``f(xs, t)``
straight into its kernel (``lsm_tpu.ops.weno_v2._coords_block`` and the
``"analytic"`` branch of ``_make_kernel``). A torch callable cannot be traced
into CUDA that way, so :func:`trace` calls it once on symbolic coordinates
``xs = (x0, x1, x2)`` and a symbolic time ``t`` (:class:`Sym`, with
arithmetic operators and a ``__torch_function__`` hook) and records what it
does.

**The rule.** A callable becomes a program when every component it returns is
built only from the coordinates, ``t`` and Python or numpy numbers with
``+ - * / **``, unary ``-`` and ``abs``, and the torch functions of
:data:`TORCH_FUNCTIONS`: ``sin``, ``cos``, ``tan``, ``exp``, ``log``,
``sqrt``, ``rsqrt``, ``tanh``, ``minimum``, ``maximum``, ``clamp``, ``where``
over comparisons (``< <= > >= == !=``), ``sign``, ``ones_like``,
``zeros_like`` and ``full_like``; a component may be a bare number.
Anything else (Python control flow on a coordinate, ``math.*`` or
``float()`` of one, a captured tensor, a numpy function, indexing, an
unknown torch function, a comparison returned as a component) leaves the
callable on the stream route: :func:`trace` returns the reason as a string
and the steppers evaluate the callable into streamed tensors per stage, as
before. The callable must compute one function whatever its arguments'
type: a branch on their type (``isinstance``) is invisible to the tracer,
which takes the branch a :class:`Sym` takes (JAX's tracers share this).

**The format.** Each component is a tuple of ``(op, arg)`` in postfix
order: ``("x", d)``, ``("t", None)`` and ``("const", value)`` push, the
other ops pop their operands and push the result (:data:`OPCODES`). A
component is at most :data:`MAX_OPS` ops long and needs at most
:data:`STACK` stack slots. ``Program.depends_on_t`` is exact: whether ``t``
reaches a component (counterpart of
``lsm_tpu.ops.weno_v2_bwd._coef_depends_on_t``); ``*_like`` constants do
not depend on their argument.

**Rounding.** :meth:`Program.evaluate` replays the recorded operations with
the torch operators the callable used, constants as the Python numbers it
passed, so it computes what the callable computes on the same tensors, bit
for bit; ``t`` enters as a 0-d tensor of the field's dtype, as JAX's kernel
takes it. The kernels round each constant to the field's dtype and do every
operation on its own, without contraction (``csrc/coef_program.cuh``):
``+ - * /`` and ``sqrt`` agree with torch to the bit, the transcendental
functions to an ulp or two.
"""

from __future__ import annotations

import math
import numbers
import operator
from typing import Optional, Tuple, Union

import torch

__all__ = ["Sym", "Program", "trace", "TORCH_FUNCTIONS", "OPCODES", "MAX_OPS", "MAX_CONSTS",
           "MAX_TABLES", "STACK"]

#: opcodes of csrc/lsm_kernels.h (LSM_OP_*): the low byte of an encoded op;
#: the high byte is the axis of ``x`` or the constant's index
OPCODES = {name: i for i, name in enumerate((
    "x", "t", "const", "neg", "abs", "sin", "cos", "tan", "exp", "log", "sqrt", "rsqrt",
    "tanh", "sign", "add", "sub", "mul", "div", "pow", "powc", "minimum", "maximum",
    "lt", "le", "gt", "ge", "eq", "ne", "where", "tab"))}
MAX_OPS = 160  # the kernels' op table (LSM_PROG_MAX_OPS), shared by a stage's terms
MAX_CONSTS = 40  # their constant table (LSM_PROG_MAX_CONSTS)
MAX_TABLES = 32  # their per-axis tables (LSM_PROG_MAX_TABS)
STACK = 12  # the interpreter's stack (LSM_PROG_STACK)

_UNARY = ("neg", "abs", "sin", "cos", "tan", "exp", "log", "sqrt", "rsqrt", "tanh", "sign")
_OPERATOR = {"add": operator.add, "sub": operator.sub, "mul": operator.mul,
             "div": operator.truediv, "pow": operator.pow, "lt": operator.lt,
             "le": operator.le, "gt": operator.gt, "ge": operator.ge, "eq": operator.eq,
             "ne": operator.ne}


class Untraceable(Exception):
    """A callable did something no program can record; the message says what."""


def _is_number(v) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, bool)


class Sym:
    """A traced value: an expression node ``(op, arg, *children)``. ``bool``
    marks a comparison, which only ``where`` takes."""

    __slots__ = ("node", "bool")
    __array_ufunc__ = None  # numpy hands its operators back to Sym

    def __init__(self, node, is_bool=False):
        self.node = node
        self.bool = is_bool

    # -- arithmetic -------------------------------------------------------------------

    def _bin(self, op, other, reverse=False):
        b = _as_node(other)
        if b is NotImplemented:
            return NotImplemented
        if self.bool or (isinstance(other, Sym) and other.bool):
            raise Untraceable("arithmetic on a comparison (only where takes one)")
        a = self.node
        if reverse:
            a, b = b, a
        return Sym((op, None, a, b))

    def __add__(self, o):
        return self._bin("add", o)

    def __radd__(self, o):
        return self._bin("add", o, True)

    def __sub__(self, o):
        return self._bin("sub", o)

    def __rsub__(self, o):
        return self._bin("sub", o, True)

    def __mul__(self, o):
        return self._bin("mul", o)

    def __rmul__(self, o):
        return self._bin("mul", o, True)

    def __truediv__(self, o):
        return self._bin("div", o)

    def __rtruediv__(self, o):
        return self._bin("div", o, True)

    def __pow__(self, o):
        return self._bin("pow", o)

    def __rpow__(self, o):
        return self._bin("pow", o, True)

    def __neg__(self):
        return _unary("neg", self)

    def __pos__(self):
        return self

    def __abs__(self):
        return _unary("abs", self)

    # -- comparisons --------------------------------------------------------------------

    def _cmp(self, op, other):
        b = _as_node(other)
        if b is NotImplemented:
            return NotImplemented
        if self.bool or (isinstance(other, Sym) and other.bool):
            raise Untraceable("a comparison of comparisons")
        return Sym((op, None, self.node, b), is_bool=True)

    def __lt__(self, o):
        return self._cmp("lt", o)

    def __le__(self, o):
        return self._cmp("le", o)

    def __gt__(self, o):
        return self._cmp("gt", o)

    def __ge__(self, o):
        return self._cmp("ge", o)

    def __eq__(self, o):
        return self._cmp("eq", o)

    def __ne__(self, o):
        return self._cmp("ne", o)

    __hash__ = object.__hash__

    # -- what a program cannot record ---------------------------------------------------

    def __bool__(self):
        raise Untraceable("Python control flow on a traced coordinate or t")

    def __float__(self):
        raise Untraceable("math.* or float() of a traced coordinate or t")

    __int__ = __index__ = __complex__ = __float__

    def __getitem__(self, key):
        raise Untraceable("indexing a traced value")

    def __iter__(self):
        raise Untraceable("iterating over a traced value")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for a in (*args, *kwargs.values()):
            if isinstance(a, torch.Tensor):
                raise Untraceable("a captured tensor")
        rule = TORCH_FUNCTIONS.get(func)
        if rule is None:
            name = getattr(func, "__name__", repr(func))
            raise Untraceable(f"torch.{name} is not among the program's functions")
        return rule(*args, **kwargs)


def _as_node(v):
    if isinstance(v, Sym):
        return v.node
    if _is_number(v):
        return ("const", float(v))
    if isinstance(v, torch.Tensor):
        raise Untraceable("a captured tensor")
    return NotImplemented


def _operand(v):
    node = _as_node(v)
    if node is NotImplemented:
        raise Untraceable(f"an operand of type {type(v).__name__}")
    return node


def _unary(op, a):
    if isinstance(a, Sym) and a.bool:
        raise Untraceable(f"{op} of a comparison")
    return Sym((op, None, _operand(a)))


def _binary(op, a, b):
    for v in (a, b):
        if isinstance(v, Sym) and v.bool:
            raise Untraceable(f"{op} of a comparison")
    return Sym((op, None, _operand(a), _operand(b)))


def _like(value):
    def rule(x, *args, **kwargs):
        v = value if value is not None else (args[0] if args else kwargs.get("fill_value"))
        if not _is_number(v):
            raise Untraceable("full_like with a fill value that is not a number")
        # a tensor constant: evaluated as a 0-d tensor of the field's dtype
        return Sym(("tconst", float(v)))
    return rule


def _where(cond, a, b):
    if not (isinstance(cond, Sym) and cond.bool):
        raise Untraceable("where needs a comparison of traced values as its condition")
    for v in (a, b):
        if isinstance(v, Sym) and v.bool:
            raise Untraceable("where of a comparison")
    return Sym(("where", None, cond.node, _operand(a), _operand(b)))


def _clamp(x, min=None, max=None):
    out = x
    if min is not None:
        out = _binary("maximum", out, min)
    if max is not None:
        out = _binary("minimum", out, max)
    if out is x:
        raise Untraceable("clamp without bounds")
    return out


#: the torch functions a program records, and how
TORCH_FUNCTIONS = {
    **{getattr(torch, name): (lambda op: lambda a: _unary(op, a))(name)
       for name in ("sin", "cos", "tan", "exp", "log", "sqrt", "rsqrt", "tanh", "sign", "abs",
                    "neg")},
    torch.minimum: lambda a, b: _binary("minimum", a, b),
    torch.maximum: lambda a, b: _binary("maximum", a, b),
    torch.clamp: _clamp,
    torch.where: _where,
    torch.ones_like: _like(1.0),
    torch.zeros_like: _like(0.0),
    torch.full_like: _like(None),
}


def _leaf(node) -> bool:
    return node[0] in ("x", "t", "const", "tconst")


def _is_zero(node) -> bool:
    return node[0] in ("const", "tconst") and node[1] == 0.0


def _finite(node) -> bool:
    """Whether ``node`` is finite wherever the coordinates and ``t`` are:
    built from them and finite constants by ``+``, ``-`` and negation."""
    if node[0] in ("x", "t"):
        return True
    if node[0] in ("const", "tconst"):
        return math.isfinite(node[1])
    return node[0] in ("add", "sub", "neg") and all(_finite(c) for c in node[2:])


def _simplify(node):
    """``node`` with the zero idioms folded: ``0 * e`` (``e`` finite, see
    :func:`_finite`) becomes 0, ``e + 0``, ``0 + e`` and ``e - 0`` become
    ``e``. Values are unchanged but for the sign of a zero."""
    if _leaf(node):
        return node
    kids = tuple(_simplify(c) for c in node[2:])
    op = node[0]
    if op == "mul" and ((_is_zero(kids[0]) and _finite(kids[1]))
                        or (_is_zero(kids[1]) and _finite(kids[0]))):
        return ("const", 0.0)
    if op == "add" and _is_zero(kids[1]):
        return kids[0]
    if op == "add" and _is_zero(kids[0]):
        return kids[1]
    if op == "sub" and _is_zero(kids[1]):
        return kids[0]
    return (op, node[1], *kids)


def _axes(node, memo):
    """The coordinate axes ``node`` reads, memoised by identity."""
    key = id(node)
    if key not in memo:
        if node[0] == "x":
            memo[key] = frozenset((node[1],))
        else:
            memo[key] = frozenset().union(*(_axes(c, memo) for c in node[2:]))
    return memo[key]


def _compile(node, out, tables, memo):
    """Append ``node``'s postfix ops to ``out``; returns the stack depth it
    needs. With a ``tables`` dict, a subtree that reads at most one
    coordinate axis (and is not a leaf) becomes one ``("tab", slot)``: its
    values are a table along that axis, which the kernels fill once per
    launch by running the subtree's own program (``tables=None``) along the
    axis, as JAX's kernel evaluates such a subtree on its sparse coordinate
    arrays."""
    op = node[0]
    if _leaf(node):
        out.append((op, node[1]))
        return 1
    ax = _axes(node, memo)
    if tables is not None and len(ax) <= 1:
        slot = tables.setdefault(node, len(tables))
        out.append(("tab", slot))
        return 1
    kids = node[2:]
    depth = 0
    for k, child in enumerate(kids):
        depth = max(depth, k + _compile(child, out, tables, memo))
    if op == "pow" and kids[1][0] == "const":  # a constant exponent: torch's special cases
        out.pop()
        out.append(("powc", kids[1][1]))
    else:
        out.append((op, None))
    return depth


_LEAVES = ("x", "t", "const", "tconst", "tab")
_BINARY = ("add", "sub", "mul", "div", "pow", "minimum", "maximum", "lt", "le", "gt", "ge",
           "eq", "ne")


def _accumulate(ops):
    """Postfix ``(op, arg)`` -> the kernels' accumulator form ``(op, arg,
    mode)``: a leaf loads the accumulator (``"load"``, the stack being
    empty) or pushes it first (``"push"``); a binary op takes its left
    operand from the stack (``"stack"``), or, when its right operand is the
    leaf just pushed, that leaf as an immediate (``"imm"``, ``arg`` the
    leaf's ``(op, arg)``)."""
    out, depth = [], 0
    for op, arg in ops:
        if op in _LEAVES:
            out.append((op, arg, "push" if depth else "load"))
            depth += 1
        elif op in _BINARY:
            prev = out[-1]
            if prev[0] in _LEAVES and prev[2] == "push":
                out[-1] = (op, prev[:2], "imm")
            else:
                out.append((op, None, "stack"))
            depth -= 1
        elif op == "where":
            out.append((op, None, None))
            depth -= 2
        else:
            out.append((op, arg, None))
    return tuple(out)


def _n_consts(comps) -> int:
    """The constant-table entries accumulator programs take."""
    return sum(1 for c in comps for op, arg, mode in c
               if op in ("const", "tconst", "powc")
               or (mode == "imm" and arg[0] in ("const", "tconst")))


def _n_arith(comp) -> int:
    """The arithmetic operations of an accumulator program: every op but a
    leaf's load (a binary op with an immediate operand counts as one)."""
    return sum(1 for op, _, _ in comp if op not in _LEAVES)


def _uses_t(node) -> bool:
    return node[0] == "t" or any(_uses_t(c) for c in node[2:])


def _eval(node, xs, t, memo):
    """``node`` on the coordinate tensors ``xs`` and the 0-d tensor ``t``,
    with the torch operators the callable used (constants as Python numbers,
    so that each operation rounds as in the callable)."""
    key = id(node)
    if key in memo:
        return memo[key]
    op, arg = node[0], node[1]
    like = xs[0]

    def tensor(v):
        return v if isinstance(v, torch.Tensor) else torch.full(
            (), v, dtype=like.dtype, device=like.device)

    if op == "x":
        out = xs[arg]
    elif op == "t":
        out = t
    elif op == "const":
        out = arg
    elif op == "tconst":
        out = tensor(arg)
    else:
        kids = [_eval(c, xs, t, memo) for c in node[2:]]
        if op == "neg":
            out = -kids[0]
        elif op == "abs":
            out = abs(kids[0])
        elif op in _UNARY:
            out = getattr(torch, op)(tensor(kids[0]))
        elif op == "where":
            out = torch.where(tensor(kids[0]), tensor(kids[1]), tensor(kids[2]))
        elif op in ("minimum", "maximum"):
            out = getattr(torch, op)(tensor(kids[0]), tensor(kids[1]))
        else:
            out = _OPERATOR[op](kids[0], kids[1])
    memo[key] = out
    return out


class Program:
    """A traced coordinate callable: the component expressions ``roots``
    (zero idioms folded), their ``components`` in the kernels' accumulator
    form (:func:`_accumulate`), the subtrees they read from per-axis
    ``tables`` (``(node, axis)``, axis -1 for one value) and the programs
    that fill them (``table_components``), ``depends_on_t``, and the
    callable ``fn`` it came from (tracing a new callable builds a new
    program). ``axes`` holds the coordinate axes each component reads (bit
    ``d`` for axis ``d``), ``n_arith`` counts the arithmetic operations per
    node, ``table_arith`` those per entry of each table."""

    __slots__ = ("fn", "roots", "components", "tables", "table_components", "depends_on_t",
                 "axes", "n_ops", "n_consts", "n_table_ops", "n_table_consts", "n_arith",
                 "table_arith")

    def __init__(self, fn, roots, depends_on_t):
        self.fn = fn
        self.roots = tuple(roots)
        tables, memo, comps = {}, {}, []
        for root in self.roots:
            comps.append(self._program(root, tables, memo))
        self.components = tuple(comps)
        self.tables = tuple((node, next(iter(_axes(node, memo)), -1)) for node in tables)
        self.table_components = tuple(self._program(node, None, memo) for node in tables)
        self.depends_on_t = bool(depends_on_t)
        self.axes = tuple(sum(1 << d for d in _axes(root, memo)) for root in self.roots)
        self.n_ops = sum(len(c) for c in self.components)
        self.n_consts = _n_consts(self.components)
        self.n_table_ops = sum(len(c) for c in self.table_components)
        self.n_table_consts = _n_consts(self.table_components)
        self.n_arith = sum(_n_arith(c) for c in self.components)
        self.table_arith = tuple(_n_arith(c) for c in self.table_components)

    @staticmethod
    def _program(node, tables, memo):
        ops = []
        depth = _compile(node, ops, tables, memo)
        if depth > STACK:
            raise Untraceable(f"a component needs {depth} stack slots; the kernels have "
                              f"{STACK}")
        return _accumulate(ops)

    def __repr__(self):
        return (f"Program({len(self.components)} components, {self.n_ops} ops, "
                f"{len(self.tables)} tables, depends_on_t={self.depends_on_t})")

    def evaluate(self, xs, t) -> Tuple[Union[torch.Tensor, float], ...]:
        """Each component at the coordinate tensors ``xs`` and the time
        ``t`` (a 0-d tensor of the coordinates' dtype: differentiable in
        ``t``), as the callable computes it: a tensor broadcastable to the
        grid, or a Python number for a constant component."""
        memo = {}
        return tuple(_eval(root, xs, t, memo) for root in self.roots)

    def table_values(self, xs, t) -> Tuple[torch.Tensor, ...]:
        """Each table at the sparse coordinates ``xs`` (one per axis,
        broadcastable) and time ``t``: a 1-D tensor of the coordinates'
        dtype, as long as its axis (one value for axis -1), the values the
        kernels read at a node's index along that axis. The plain version
        of the table fill (``csrc/coef_tables.cu``)."""
        memo, out = {}, []
        like = xs[0]
        for node, axis in self.tables:
            v = torch.as_tensor(_eval(node, xs, t, memo), device=like.device).to(like.dtype)
            n = 1 if axis < 0 else xs[axis].numel()
            view = [1] * len(xs)
            if axis >= 0:
                view[axis] = n
            out.append(torch.broadcast_to(v, view).reshape(n))
        return tuple(out)


def trace(fn, ndim: int = 3, ncomp: Optional[int] = None) -> Union[Program, str]:
    """Trace the callable ``fn(xs, t)`` on ``ndim`` symbolic coordinates into
    a :class:`Program` of ``ncomp`` components (``None``: as many as it
    returns; a single value is one component), or return the reason it
    stays on the stream route."""
    xs = tuple(Sym(("x", d)) for d in range(ndim))
    try:
        out = fn(xs, Sym(("t", None)))
        comps = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        if ncomp is not None and len(comps) != ncomp:
            return f"it returns {len(comps)} components, {ncomp} expected"
        nodes = []
        for c in comps:
            if isinstance(c, Sym):
                if c.bool:
                    return "a component is a comparison"
                nodes.append(c.node)
            elif _is_number(c):
                nodes.append(("const", float(c)))
            else:
                return f"a component is a {type(c).__name__}, not a traced value or a number"
        prog = Program(fn, (_simplify(n) for n in nodes), any(_uses_t(n) for n in nodes))
    except Untraceable as e:
        return str(e)
    except Exception as e:  # noqa: BLE001 - any failure of the callable on Sym is a reason
        return f"tracing raised {type(e).__name__}: {e}"
    if (max(prog.n_ops, prog.n_table_ops) > MAX_OPS
            or max(prog.n_consts, prog.n_table_consts) > MAX_CONSTS
            or len(prog.tables) > MAX_TABLES):
        return (f"the program has {prog.n_ops} ops, {prog.n_consts} constants and "
                f"{len(prog.tables)} tables (their programs {prog.n_table_ops} ops and "
                f"{prog.n_table_consts} constants); the kernels' table holds {MAX_OPS}, "
                f"{MAX_CONSTS} and {MAX_TABLES}")
    return prog
