"""The coefficient-program tracer (``lsm_tpu_torch.ops.coef_program``) on the
CPU: every supported operation traces into a program whose evaluation
equals the callable's, in float64 to the bit; what no program can record
takes the stream route with its reason; ``depends_on_t`` agrees with JAX's
``_coef_depends_on_t``; and the program table the kernels read decodes, op
by op, to the same values (a Python replay of ``csrc/coef_program.cuh``'s
interpreter over the encoded ops).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu_torch as T
from lsm_tpu.ops.weno_v2_bwd import _coef_depends_on_t
from lsm_tpu_torch.integrators import fused as tfused
from lsm_tpu_torch.ops import coef_program as cp
from lsm_tpu_torch.ops import weno_v2 as tv2


SHAPE, LO, H = (5, 6, 7), (-0.3, 0.1, 0.2), (0.15, 0.11, 0.13)


def _xs():
    return tv2.node_coords(SHAPE, H, LO, torch.float64)


T0 = torch.tensor(0.37, dtype=torch.float64)

# one callable per supported operation (and the repo's idioms), each on
# coordinates where it is defined
OPS = {
    "add_sub": lambda xs, t: xs[0] + 0.5 - xs[1] - (1.5 - xs[2]),
    "mul_div": lambda xs, t: 3.0 * xs[0] * xs[1] / (2.0 + xs[2]) / 7.0,
    "rdiv": lambda xs, t: 1.0 / (xs[0] + 2.0),
    "neg_abs": lambda xs, t: -xs[0] + abs(xs[1] - 0.15),
    "pow2": lambda xs, t: xs[0] ** 2,
    "pow3": lambda xs, t: xs[1] ** 3,
    "pow_half": lambda xs, t: (xs[2] + 1.0) ** 0.5,
    "pow_m_half": lambda xs, t: (xs[2] + 1.0) ** -0.5,
    "pow_m1": lambda xs, t: (xs[2] + 1.0) ** -1,
    "pow_m2": lambda xs, t: (xs[2] + 1.0) ** -2,
    "pow_general": lambda xs, t: (xs[2] + 1.0) ** 1.7,
    "rpow": lambda xs, t: 2.0 ** xs[0],
    "pow_traced": lambda xs, t: (xs[2] + 1.0) ** (xs[1] + 0.5),
    "sin_cos_tan": lambda xs, t: torch.sin(xs[0]) + torch.cos(xs[1]) * torch.tan(xs[2]),
    "exp_log": lambda xs, t: torch.exp(xs[0]) - torch.log(xs[2] + 2.0),
    "sqrt_rsqrt": lambda xs, t: torch.sqrt(xs[2] + 1.0) * torch.rsqrt(xs[1] + 3.0),
    "tanh_sign": lambda xs, t: torch.tanh(xs[0]) + torch.sign(xs[1] - 0.21),
    "min_max": lambda xs, t: torch.minimum(xs[0], xs[1]) + torch.maximum(xs[1], 0.3 - xs[2]),
    "clamp": lambda xs, t: (torch.clamp(xs[0], min=0.0) + torch.clamp(xs[1], max=0.4)
                            + torch.clamp(xs[2], 0.3, 0.5)),
    "where_lt_gt": lambda xs, t: torch.where(xs[0] < 0.2, xs[1], 0.0) + torch.where(
        xs[2] > 0.4, 1.0, xs[0]),
    "where_le_ge": lambda xs, t: torch.where(xs[0] <= 0.15, xs[1], xs[2]) + torch.where(
        0.5 >= xs[2], xs[0], -1.0),
    "where_eq_ne": lambda xs, t: torch.where(xs[2] == 0.2, 2.0, xs[1]) + torch.where(
        xs[0] != xs[1], xs[0], 0.0),
    "likes": lambda xs, t: (torch.ones_like(xs[0] + xs[1]) + torch.zeros_like(xs[2])
                            + torch.full_like(xs[0], 0.25) * xs[1]),
    "zero_idiom": lambda xs, t: 0.5 - xs[1] + 0.0 * (xs[0] + xs[1] + xs[2]),
    "numpy_const": lambda xs, t: np.float64(2.5) * xs[0] + np.pi,
    "time": lambda xs, t: xs[0] * torch.cos(math.pi * t / 3.0) + 0.5 * t,
    "number": lambda xs, t: 0.75,
}


def _as(v, like):
    return torch.broadcast_to(torch.as_tensor(v, dtype=like.dtype), like.shape)


@pytest.mark.parametrize("name", sorted(OPS))
def test_each_operation_traces_and_evaluates_like_the_callable(name):
    fn = OPS[name]
    prog = cp.trace(fn, 3, 1)
    assert isinstance(prog, cp.Program), prog
    xs = _xs()
    like = xs[0] + xs[1] + xs[2]
    want = _as(fn(xs, T0), like)
    (got,) = prog.evaluate(xs, T0)
    torch.testing.assert_close(_as(got, like), want, rtol=0, atol=0)
    assert prog.depends_on_t == (name == "time")
    # the kernels' table decodes to the same values at every node
    np.testing.assert_allclose(_replay(prog, xs, float(T0)), want.numpy(), rtol=1e-15,
                               atol=1e-15)


def _replay(prog, xs, t):
    """A numpy replay of csrc/coef_program.cuh's accumulator interpreter over
    the encoded table ``stage_table`` builds: opcode, mode and operand from
    each 16-bit op, constants and per-axis tables from the table."""
    spec = tv2.TermSpec("normal", "program", prog)
    st_tab = tv2.stage_table(((spec, ()),), H, (0.0, 1.0, 1.0), tv2.Where(LO, None, t), SHAPE,
                             xs[0])
    tab, buf = st_tab.prog, st_tab.tables.numpy()
    full = np.broadcast_shapes(*(x.shape for x in xs))
    X = [np.broadcast_to(x.numpy(), full) for x in xs]
    out = _run(tab, tab.start[0][0], tab.len[0][0], X, np.indices(full), buf)
    return np.broadcast_to(out, full)


@pytest.mark.parametrize("name", sorted(OPS))
def test_table_programs_fill_the_plain_tables(name):
    """The table programs ``table_fill`` encodes for csrc/coef_tables.cu
    (one per subexpression that reads at most one axis), replayed at every
    index of their axis, give the plain tables (``Program.table_values``)."""
    prog = cp.trace(OPS[name], 3, 1)
    where = tv2.Where(LO, None, float(T0))
    fill = tv2.table_fill([prog], SHAPE, H, where)
    want = tv2.program_tables_plain([prog], SHAPE, H, where, _xs()[0], False).numpy()
    assert fill.n == len(prog.tables) and fill.total == sum(
        1 if axis < 0 else SHAPE[axis] for _, axis in prog.tables)
    for s in range(fill.n):
        i = np.arange(fill.count[s])
        X = [LO[d] + i * H[d] for d in range(3)]  # node i of each axis: pick(a, i, i, i)
        got = _run(fill.prog, fill.start[s], fill.nops[s], X, (i, i, i), None)
        off = fill.prog.tab_off[s]
        np.testing.assert_allclose(np.broadcast_to(got, i.shape),
                                   want[off:off + fill.count[s]], rtol=1e-15, atol=1e-15)


def _run(tab, start, n, X, idx, buf):
    """Replay ``n`` encoded ops of ``tab`` (a ``ProgramTable``) from
    ``start`` at the coordinates ``X`` (index ``idx`` per axis), the per-axis
    tables read from ``buf``."""
    names = {v: k for k, v in cp.OPCODES.items()}

    def leaf(op, arg):
        if op == "tab":
            a = tab.tab_axis[arg]
            return buf[tab.tab_off[arg] + (0 if a < 0 else idx[a])]
        return {"x": lambda: X[arg], "t": lambda: np.float64(tab.t),
                "const": lambda: np.float64(tab.konst[arg])}[op]()

    binary = {"add": np.add, "sub": np.subtract, "mul": np.multiply, "div": np.divide,
              "pow": np.power, "minimum": np.minimum, "maximum": np.maximum, "lt": np.less,
              "le": np.less_equal, "gt": np.greater, "ge": np.greater_equal, "eq": np.equal,
              "ne": np.not_equal}
    acc, st = None, []
    with np.errstate(all="ignore"):
        for k in range(start, start + n):
            code = tab.op[k]
            op, mode, arg = names[code & 31], (code >> 5) & 3, code >> 8
            if op in ("x", "t", "const", "tab"):
                if mode:
                    st.append(acc)
                acc = leaf(op, arg)
            elif op == "powc":
                acc = acc ** tab.konst[arg]
            elif op in ("neg", "abs", "sin", "cos", "tan", "exp", "log", "sqrt", "tanh",
                        "sign"):
                acc = ({"neg": np.negative, "abs": np.abs}.get(op) or getattr(np, op))(acc)
            elif op == "rsqrt":
                acc = 1.0 / np.sqrt(acc)
            elif op == "where":
                a, c = st.pop(), st.pop()
                acc = np.where(c != 0, a, acc)
            else:
                if mode == 0:
                    a, b = st.pop(), acc
                else:
                    b = leaf({1: "tab", 2: "const"}.get(mode) or ("x" if arg < 3 else "t"), arg)
                    a = acc
                acc = binary[op](a, b).astype(np.float64)
    assert not st
    return acc


STREAM_ROUTE = {
    "captured tensor": (lambda xs, t: torch.tensor(2.0, dtype=torch.float64) * xs[0],
                        "a captured tensor"),
    "math.sin": (lambda xs, t: math.sin(xs[0]), "math.* or float()"),
    "python if": (lambda xs, t: xs[0] if xs[0] > 0.5 else xs[1], "Python control flow"),
    "unknown torch function": (lambda xs, t: torch.erf(xs[0]), "torch.erf is not among"),
    "numpy function": (lambda xs, t: np.sin(xs[0]), "does not support ufuncs"),
    "indexing": (lambda xs, t: xs[0][0], "indexing a traced value"),
    "comparison component": (lambda xs, t: xs[0] > 0.5, "a component is a comparison"),
    "arithmetic on a comparison": (lambda xs, t: (xs[0] > 0.5) * 2.0, "arithmetic on a comp"),
}


@pytest.mark.parametrize("name", sorted(STREAM_ROUTE))
def test_untraceable_callables_take_the_stream_route_with_their_reason(name):
    fn, why = STREAM_ROUTE[name]
    reason = cp.trace(fn, 3, 1)
    assert isinstance(reason, str) and why in reason
    # the stepper keeps such a callable on the stream route and says why
    grid = T.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (6, 6, 6))
    phi = T.sample(lambda x, y, z: x - 0.5, grid, T.Periodic(), dtype=torch.float64,
                   device="cpu")
    stepper = tfused.FusedStepper((T.NormalMotionTerm(fn),), phi, T.RK3())
    (route, got_reason), = stepper.routes
    assert route == "stream" and got_reason == reason


def test_component_count_stack_and_table_limits():
    rot = lambda xs, t: (0.5 - xs[1], xs[0] - 0.5, 0.0 * xs[2])
    assert "returns 3 components, 1 expected" in cp.trace(rot, 3, 1)
    assert isinstance(cp.trace(rot, 3, 3), cp.Program)
    # right-nested differences need one stack slot per level
    def deep(xs, t):
        out = xs[0]
        for k in range(cp.STACK + 1):
            out = xs[k % 3] - out
        return out

    assert "stack slots" in cp.trace(deep, 3, 1)
    long = lambda xs, t: sum((xs[0] * xs[1] * float(k) for k in range(cp.MAX_OPS)), 0.0)
    assert "table holds" in cp.trace(long, 3, 1)


# -- depends_on_t against JAX ----------------------------------------------------------

def _pair(body):
    """The same callable for jnp and torch: ``body(pkg, xs, t)``."""
    return (lambda xs, t: body(jnp, xs, t)), (lambda xs, t: body(torch, xs, t))


DEPENDS = {
    "none": lambda m, xs, t: m.sin(xs[0]) * xs[1],
    "linear": lambda m, xs, t: xs[0] + 0.5 * t,
    "inside a function": lambda m, xs, t: m.cos(m.pi * t / 2.0) * xs[1],
    "ones_like of t": lambda m, xs, t: m.ones_like(t) * xs[2],
    "zero times t": lambda m, xs, t: 0.0 * t + xs[0],
    "where on t": lambda m, xs, t: m.where(t > 0.5, xs[0], xs[1]),
}


@pytest.mark.parametrize("name", sorted(DEPENDS))
def test_depends_on_t_agrees_with_jax(name):
    jfn, tfn = _pair(DEPENDS[name])
    prog = cp.trace(tfn, 3, 1)
    assert isinstance(prog, cp.Program)
    assert prog.depends_on_t == _coef_depends_on_t(jfn, jnp.float64)


def test_plain_program_values_carry_the_time_gradient():
    """``program_values`` keeps ``t``'s graph: the plain K3″ differentiates it."""
    spec = tv2.TermSpec("normal", "program",
                        cp.trace(lambda xs, t: torch.sin(2.0 * t) * xs[0], 3, 1))
    t = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    like = torch.zeros((), dtype=torch.float64)
    (v,) = tv2.program_values(spec, (4, 5, 6), (0.1, 0.2, 0.3), (0.0, 1.0, 2.0), t, like,
                              origin=(1.0, 0.0, -2.0))
    (dt,) = torch.autograd.grad(v.sum(), t)
    x = 0.0 + (1.0 + torch.arange(4, dtype=torch.float64)) * 0.1
    want = float((2.0 * math.cos(0.6) * x).sum()) * 5 * 6
    assert abs(float(dt) - want) <= 1e-12 * abs(want)


def test_programs_beyond_the_kernels_tables_take_the_stream_route():
    """A stage's programs share the kernels' tables: a term whose program
    would overflow them is streamed, with that reason, and the list still
    steps."""
    grid = T.Grid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (6, 6, 6))
    phi = T.sample(lambda x, y, z: x - 0.5, grid, T.Periodic(), dtype=torch.float64,
                   device="cpu")
    speed = lambda xs, t: 0.01 * (torch.sin(xs[0]) + torch.cos(xs[1]) * torch.exp(xs[2]))
    assert len(cp.trace(speed, 3, 1).tables) == 3
    terms = tuple(T.NormalMotionTerm(speed) for _ in range(tv2.MAX_TERMS))
    stepper = tfused.FusedStepper(terms, phi, T.ForwardEuler())
    routes = [r for r, _ in stepper.routes]
    fit = cp.MAX_TABLES // 3
    assert routes == ["program"] * fit + ["stream"] * (tv2.MAX_TERMS - fit)
    assert "fill the kernels' tables" in stepper.routes[-1][1]
    P = stepper.pack(phi.values)
    assert bool(torch.isfinite(stepper.step(P, 0.0, 1e-3)).all())
