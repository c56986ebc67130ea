"""Minimal PyTensor-protocol shim so the PyTensor wrapper runs without pytensor.

The reference integration layer (sunode's ``wrappers/as_pytensor.py``)
targets PyTensor's Op protocol: typed ``Variable``s, ``Apply`` nodes, ``Op``
subclasses with ``itypes``/``otypes``/``perform``/``grad``, a ``function``
compiler and reverse-mode ``grad``.  This module implements just enough of
that protocol — faithfully, including the graph structure and the gradient
engine — that ``sunode_torch.wrappers.as_pytensor`` executes end-to-end in
environments without pytensor.  When a ``pytensor`` is already importable
(the real package, or another copy of this shim), ``install()`` is a no-op
and that one wins.

A copy of ``sunode_tpu/_compat/pt_shim.py`` (numpy only): the port cannot
import that module, as importing it runs the JAX package's ``__init__``.

This is a test/compatibility harness, NOT a PyTensor replacement (hence
its home in ``sunode_torch._compat``, outside the product surface): only
the ops the wrapper and PyMC-style logp/dlogp graphs need are provided
(elementwise arithmetic, pow, sum, reshape, basic subtensor, concatenate),
with gradients computed against runtime shapes (no static shape inference).

Usage:
    from sunode_torch._compat.pt_shim import install
    install()          # registers 'pytensor', 'pytensor.tensor', ... if absent
    import pytensor.tensor as pt   # now works either way
"""

from __future__ import annotations

import sys
import types
from typing import Any, Optional

import numpy as np

__all__ = ["install", "is_shim_active"]


# ---------------------------------------------------------------------------
# Types, variables, graph structure
# ---------------------------------------------------------------------------
class TensorType:
    def __init__(self, dtype: str, ndim: int):
        self.dtype = np.dtype(dtype).name
        self.ndim = int(ndim)

    def __call__(self, name: Optional[str] = None) -> "TensorVariable":
        return TensorVariable(self, name=name)

    def __eq__(self, other):
        return (
            isinstance(other, TensorType)
            and other.dtype == self.dtype
            and other.ndim == self.ndim
        )

    def __hash__(self):
        return hash((self.dtype, self.ndim))

    def __repr__(self):
        return f"TensorType({self.dtype}, ndim={self.ndim})"

    def filter(self, value):
        arr = np.asarray(value, dtype=self.dtype)
        if arr.ndim != self.ndim:
            raise TypeError(f"expected ndim {self.ndim}, got {arr.ndim}")
        return arr


class Variable:
    def __init__(self, type: TensorType, name: Optional[str] = None):
        self.type = type
        self.name = name
        self.owner: Optional[Apply] = None
        self.index: Optional[int] = None
        self.tag = types.SimpleNamespace()

    def __repr__(self):
        return self.name or f"<{type(self).__name__} {self.type!r}>"


class Apply:
    def __init__(self, op: "Op", inputs: list, outputs: list):
        self.op = op
        self.inputs = inputs
        self.outputs = outputs
        for i, out in enumerate(outputs):
            out.owner = self
            out.index = i


class DisconnectedGrad:
    """Placeholder cotangent for an output not on any path to the cost.
    Custom Ops pattern-match on its string form (as the reference does:
    ``assert str(g_grad) == '<DisconnectedType>'``, as_pytensor.py:251)."""

    def __str__(self):
        return "<DisconnectedType>"

    __repr__ = __str__


class NullTypeGradError(TypeError):
    """Requested gradient is undefined (pytensor.gradient.NullTypeGradError
    analog): raised instead of silently returning zeros."""


class NullGrad:
    """Result of ``grad_not_implemented``: using it in a requested gradient
    is an error; it is silently dropped otherwise."""

    def __init__(self, op=None, pos=None, var=None):
        self.op, self.pos, self.var = op, pos, var

    def __str__(self):
        return "<NullType>"

    __repr__ = __str__


def _is_missing(g) -> bool:
    return g is None or isinstance(g, (DisconnectedGrad, NullGrad))


class Op:
    itypes: Optional[list] = None
    otypes: Optional[list] = None

    def make_node(self, *inputs) -> Apply:
        inputs = [as_tensor_variable(i) for i in inputs]
        if self.itypes is not None:
            if len(inputs) != len(self.itypes):
                raise TypeError(
                    f"{type(self).__name__}: expected {len(self.itypes)} "
                    f"inputs, got {len(inputs)}"
                )
            for i, (inp, it) in enumerate(zip(inputs, self.itypes)):
                if inp.type != it:
                    raise TypeError(
                        f"{type(self).__name__} input {i}: expected {it!r}, "
                        f"got {inp.type!r}"
                    )
        if self.otypes is None:
            raise NotImplementedError("Op must define otypes or make_node")
        return Apply(self, inputs, [t() for t in self.otypes])

    def __call__(self, *inputs):
        node = self.make_node(*inputs)
        if len(node.outputs) == 1:
            return node.outputs[0]
        return node.outputs

    def perform(self, node, inputs, output_storage):
        raise NotImplementedError

    def grad(self, inputs, output_grads):
        raise NotImplementedError(f"{type(self).__name__} has no grad")


def _f64(ndim: int) -> TensorType:
    return TensorType("float64", ndim)


def as_tensor_variable(x, dtype=None, **kwargs) -> Variable:
    if isinstance(x, Variable):
        return x
    return Constant(x)


# ---------------------------------------------------------------------------
# Built-in ops (runtime-shape gradients: no static shape inference needed)
# ---------------------------------------------------------------------------
class _UnbroadcastLike(Op):
    """Sum ``g`` down to the runtime shape of ``ref`` (reverse of numpy
    broadcasting).  Used by every elementwise gradient."""

    def make_node(self, g, ref):
        g, ref = as_tensor_variable(g), as_tensor_variable(ref)
        return Apply(self, [g, ref], [_f64(ref.type.ndim)()])

    def perform(self, node, inputs, output_storage):
        g, ref = inputs
        extra = g.ndim - ref.ndim
        if extra > 0:
            g = g.sum(axis=tuple(range(extra)))
        axes = tuple(
            i for i in range(ref.ndim) if ref.shape[i] == 1 and g.shape[i] != 1
        )
        if axes:
            g = g.sum(axis=axes, keepdims=True)
        output_storage[0][0] = np.asarray(g, dtype="float64")

    def grad(self, inputs, output_grads):
        (g,) = output_grads[:1]
        return [g, NullGrad()]


def _unbroadcast(g, ref):
    if g.type.ndim == ref.type.ndim == 0:
        return g
    return _UnbroadcastLike()(g, ref)


class Elemwise(Op):
    _impl = {
        "add": (np.add, 2),
        "sub": (np.subtract, 2),
        "mul": (np.multiply, 2),
        "div": (np.true_divide, 2),
        "pow": (np.power, 2),
        "neg": (np.negative, 1),
        "exp": (np.exp, 1),
        "log": (np.log, 1),
        "sqrt": (np.sqrt, 1),
    }

    def __init__(self, scalar_op: str):
        if scalar_op not in self._impl:
            raise ValueError(scalar_op)
        self.scalar_op = scalar_op

    def make_node(self, *inputs):
        inputs = [as_tensor_variable(i) for i in inputs]
        fn, arity = self._impl[self.scalar_op]
        if len(inputs) != arity:
            raise TypeError(f"{self.scalar_op}: expected {arity} inputs")
        ndim = max(i.type.ndim for i in inputs)
        return Apply(self, list(inputs), [_f64(ndim)()])

    def perform(self, node, inputs, output_storage):
        fn, _ = self._impl[self.scalar_op]
        output_storage[0][0] = np.asarray(fn(*inputs), dtype="float64")

    def grad(self, inputs, output_grads):
        (g,) = output_grads
        if _is_missing(g):
            return [g for _ in inputs]
        op = self.scalar_op
        if op == "add":
            x, y = inputs
            return [_unbroadcast(g, x), _unbroadcast(g, y)]
        if op == "sub":
            x, y = inputs
            return [_unbroadcast(g, x), _unbroadcast(Elemwise("neg")(g), y)]
        if op == "mul":
            x, y = inputs
            return [
                _unbroadcast(Elemwise("mul")(g, y), x),
                _unbroadcast(Elemwise("mul")(g, x), y),
            ]
        if op == "div":
            x, y = inputs
            gx = Elemwise("div")(g, y)
            gy = Elemwise("neg")(Elemwise("mul")(gx, Elemwise("div")(x, y)))
            return [_unbroadcast(gx, x), _unbroadcast(gy, y)]
        if op == "pow":
            x, y = inputs
            # d/dx x^y = y x^(y-1); exponent gradient not needed (constants)
            gx = Elemwise("mul")(
                g, Elemwise("mul")(y, Elemwise("pow")(x, Elemwise("sub")(y, Constant(1.0))))
            )
            return [_unbroadcast(gx, x), NullGrad()]
        if op == "neg":
            return [Elemwise("neg")(g)]
        if op == "exp":
            (x,) = inputs
            return [Elemwise("mul")(g, Elemwise("exp")(x))]
        if op == "log":
            (x,) = inputs
            return [Elemwise("div")(g, x)]
        if op == "sqrt":
            (x,) = inputs
            half = Constant(0.5)
            return [Elemwise("div")(Elemwise("mul")(half, g), Elemwise("sqrt")(x))]
        raise NotImplementedError(op)


class Sum(Op):
    def __init__(self, axis=None):
        if axis is not None and not isinstance(axis, (tuple, list)):
            axis = (int(axis),)
        self.axis = tuple(axis) if axis is not None else None

    def make_node(self, x):
        x = as_tensor_variable(x)
        if self.axis is None:
            ndim = 0
        else:
            ax = tuple(a % x.type.ndim for a in self.axis)
            ndim = x.type.ndim - len(set(ax))
        return Apply(self, [x], [_f64(ndim)()])

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        axis = None
        if self.axis is not None:
            axis = tuple(a % x.ndim for a in self.axis)
        output_storage[0][0] = np.asarray(np.sum(x, axis=axis), dtype="float64")

    def grad(self, inputs, output_grads):
        (x,) = inputs
        (g,) = output_grads
        if _is_missing(g):
            return [g]
        return [_SumGrad(self.axis)(g, x)]


class _SumGrad(Op):
    def __init__(self, axis):
        self.axis = axis

    def make_node(self, g, x):
        g, x = as_tensor_variable(g), as_tensor_variable(x)
        return Apply(self, [g, x], [_f64(x.type.ndim)()])

    def perform(self, node, inputs, output_storage):
        g, x = inputs
        if self.axis is None:
            out = np.broadcast_to(g, x.shape)
        else:
            axes = sorted(a % x.ndim for a in self.axis)
            for a in axes:
                g = np.expand_dims(g, a)
            out = np.broadcast_to(g, x.shape)
        output_storage[0][0] = np.ascontiguousarray(out, dtype="float64")

    def grad(self, inputs, output_grads):
        (g,) = output_grads
        return [Sum(self.axis)(g), NullGrad()]


class Reshape(Op):
    def __init__(self, shape):
        self.shape = tuple(int(s) for s in shape)

    def make_node(self, x):
        x = as_tensor_variable(x)
        return Apply(self, [x], [_f64(len(self.shape))()])

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        output_storage[0][0] = np.reshape(x, self.shape).astype("float64")

    def grad(self, inputs, output_grads):
        (x,) = inputs
        (g,) = output_grads
        if _is_missing(g):
            return [g]
        return [_ReshapeLike()(g, x)]


class _ReshapeLike(Op):
    def make_node(self, g, x):
        g, x = as_tensor_variable(g), as_tensor_variable(x)
        return Apply(self, [g, x], [_f64(x.type.ndim)()])

    def perform(self, node, inputs, output_storage):
        g, x = inputs
        output_storage[0][0] = np.reshape(g, x.shape).astype("float64")

    def grad(self, inputs, output_grads):
        (g,) = output_grads
        return [g if _is_missing(g) else Reshape(())(g), NullGrad()]


class Subtensor(Op):
    """Basic indexing with a static index tuple (slices, ints, None)."""

    def __init__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        self.idx = idx

    def _out_ndim(self, x_ndim):
        ndim = x_ndim
        consumed = 0
        for it in self.idx:
            if it is None:
                ndim += 1
            elif isinstance(it, int):
                ndim -= 1
                consumed += 1
            elif isinstance(it, slice):
                consumed += 1
            else:
                raise TypeError(f"unsupported index {it!r}")
        if consumed > x_ndim:
            raise IndexError("too many indices")
        return ndim

    def make_node(self, x):
        x = as_tensor_variable(x)
        return Apply(self, [x], [_f64(self._out_ndim(x.type.ndim))()])

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        output_storage[0][0] = np.asarray(x[self.idx], dtype="float64")

    def grad(self, inputs, output_grads):
        (x,) = inputs
        (g,) = output_grads
        if _is_missing(g):
            return [g]
        return [_SubtensorGrad(self.idx)(g, x)]


class _SubtensorGrad(Op):
    def __init__(self, idx):
        self.idx = idx

    def make_node(self, g, x):
        g, x = as_tensor_variable(g), as_tensor_variable(x)
        return Apply(self, [g, x], [_f64(x.type.ndim)()])

    def perform(self, node, inputs, output_storage):
        g, x = inputs
        z = np.zeros(x.shape, dtype="float64")
        z[self.idx] = g
        output_storage[0][0] = z

    def grad(self, inputs, output_grads):
        (g,) = output_grads
        return [g if _is_missing(g) else Subtensor(self.idx)(g), NullGrad()]


class Join(Op):
    """Concatenate along an axis."""

    def __init__(self, axis=0):
        self.axis = int(axis)

    def make_node(self, *xs):
        xs = [as_tensor_variable(x) for x in xs]
        ndim = xs[0].type.ndim
        return Apply(self, list(xs), [_f64(ndim)()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.concatenate(inputs, axis=self.axis).astype(
            "float64"
        )

    def grad(self, inputs, output_grads):
        (g,) = output_grads
        if _is_missing(g):
            return [g for _ in inputs]
        return [_JoinGrad(i, self.axis)(g, *inputs) for i in range(len(inputs))]


class _JoinGrad(Op):
    def __init__(self, index, axis):
        self.index = int(index)
        self.axis = int(axis)

    def make_node(self, g, *xs):
        g = as_tensor_variable(g)
        xs = [as_tensor_variable(x) for x in xs]
        return Apply(self, [g] + xs, [_f64(xs[self.index].type.ndim)()])

    def perform(self, node, inputs, output_storage):
        g, xs = inputs[0], inputs[1:]
        start = sum(x.shape[self.axis] for x in xs[: self.index])
        size = xs[self.index].shape[self.axis]
        sl = [slice(None)] * g.ndim
        sl[self.axis] = slice(start, start + size)
        output_storage[0][0] = np.asarray(g[tuple(sl)], dtype="float64")


class ZerosLike(Op):
    def make_node(self, x):
        x = as_tensor_variable(x)
        return Apply(self, [x], [_f64(x.type.ndim)()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.zeros_like(inputs[0], dtype="float64")

    def grad(self, inputs, output_grads):
        return [NullGrad()]


# ---------------------------------------------------------------------------
# Variable operators
# ---------------------------------------------------------------------------
class TensorVariable(Variable):
    def __add__(self, other):
        return Elemwise("add")(self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return Elemwise("sub")(self, other)

    def __rsub__(self, other):
        return Elemwise("sub")(as_tensor_variable(other), self)

    def __mul__(self, other):
        return Elemwise("mul")(self, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return Elemwise("div")(self, other)

    def __rtruediv__(self, other):
        return Elemwise("div")(as_tensor_variable(other), self)

    def __pow__(self, other):
        return Elemwise("pow")(self, other)

    def __neg__(self):
        return Elemwise("neg")(self)

    def __getitem__(self, idx):
        return Subtensor(idx)(self)

    def sum(self, axis=None):
        return Sum(axis)(self)

    def reshape(self, shape):
        return Reshape(shape)(self)


# Constant is a TensorVariable so constants participate in arithmetic
class Constant(TensorVariable):
    def __init__(self, data, name=None):
        data = np.asarray(data, dtype="float64")
        TensorVariable.__init__(self, _f64(data.ndim), name=name)
        self.data = data

    def __repr__(self):
        return f"Constant({self.data!r})"


# ---------------------------------------------------------------------------
# Evaluation and reverse-mode gradient
# ---------------------------------------------------------------------------
def _toposort(outputs):
    """Apply nodes reachable from ``outputs``, dependencies first."""
    order, seen = [], set()
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 100_000))

    def visit(node):
        if node is None or node in seen:
            return
        seen.add(node)
        for inp in node.inputs:
            visit(inp.owner)
        order.append(node)

    try:
        for v in outputs:
            visit(v.owner)
    finally:
        sys.setrecursionlimit(limit)
    return order


def function(inputs, outputs, **kwargs):
    single = not isinstance(outputs, (list, tuple))
    out_list = [outputs] if single else list(outputs)
    for i in inputs:
        if not isinstance(i, Variable):
            raise TypeError("function inputs must be Variables")
    nodes = _toposort(out_list)

    def fn(*values):
        if len(values) != len(inputs):
            raise TypeError(f"expected {len(inputs)} arguments")
        env = {var: var.type.filter(val) for var, val in zip(inputs, values)}

        def lookup(var):
            if var in env:
                return env[var]
            if isinstance(var, Constant):
                return var.data
            raise ValueError(f"unbound variable {var!r} (missing input?)")

        for node in nodes:
            if all(o in env for o in node.outputs):
                continue
            ins = [lookup(i) for i in node.inputs]
            storage = [[None] for _ in node.outputs]
            node.op.perform(node, ins, storage)
            for o, s in zip(node.outputs, storage):
                env[o] = s[0]
        results = [lookup(o) for o in out_list]
        return results[0] if single else results

    return fn


def grad(cost, wrt, **kwargs):
    single = not isinstance(wrt, (list, tuple))
    wrt_list = [wrt] if single else list(wrt)
    if cost.type.ndim != 0:
        raise TypeError("cost must be a scalar")
    nodes = _toposort([cost])
    gmap = {cost: Constant(np.asarray(1.0))}
    for node in reversed(nodes):
        ograds = [gmap.get(o, DisconnectedGrad()) for o in node.outputs]
        if all(isinstance(g, DisconnectedGrad) for g in ograds):
            continue
        igrads = node.op.grad(node.inputs, ograds)
        if len(igrads) != len(node.inputs):
            raise ValueError(
                f"{type(node.op).__name__}.grad returned {len(igrads)} "
                f"gradients for {len(node.inputs)} inputs"
            )
        for inp, gi in zip(node.inputs, igrads):
            if _is_missing(gi):
                # remember NullGrad (grad_not_implemented): pytensor's null
                # contaminates — a variable reached by any null path raises
                # NullTypeGradError when requested, never silent zeros
                if isinstance(gi, NullGrad):
                    gmap[inp] = gi
                continue
            prev = gmap.get(inp)
            if isinstance(prev, NullGrad):
                continue  # null dominates
            gmap[inp] = gi if prev is None else Elemwise("add")(prev, gi)
    outs = []
    for w in wrt_list:
        g = gmap.get(w)
        if isinstance(g, NullGrad):
            raise NullTypeGradError(
                f"grad of the requested variable is undefined "
                f"(grad_not_implemented): {g!r}"
            )
        outs.append(ZerosLike()(w) if g is None else g)
    return outs[0] if single else outs


def grad_not_implemented(op, x_pos, x, comment=""):
    return NullGrad(op, x_pos, x)


# ---------------------------------------------------------------------------
# pt namespace helpers
# ---------------------------------------------------------------------------
def _sum_fn(x, axis=None):
    return Sum(axis)(x)


def concatenate(xs, axis=0):
    xs = list(xs)
    if len(xs) == 1:
        return as_tensor_variable(xs[0])
    return Join(axis)(*xs)


def zeros_like(x):
    return ZerosLike()(x)


def constant(x, name=None):
    return Constant(x, name=name)


def is_shim_active() -> bool:
    mod = sys.modules.get("pytensor")
    return mod is not None and getattr(mod, "__sunode_torch_shim__", False)


def install(force: bool = False) -> bool:
    """Register the shim as ``pytensor`` in sys.modules if (and only if) the
    real package is unavailable.  Returns True when the shim is active."""
    if not force:
        if "pytensor" in sys.modules and not is_shim_active():
            return False
        try:
            import importlib.util

            if importlib.util.find_spec("pytensor") is not None and not is_shim_active():
                return False
        except (ImportError, ValueError):
            pass
    if is_shim_active():
        return True

    pytensor = types.ModuleType("pytensor")
    pytensor.__sunode_torch_shim__ = True
    tensor = types.ModuleType("pytensor.tensor")
    graph = types.ModuleType("pytensor.graph")
    graph_basic = types.ModuleType("pytensor.graph.basic")
    graph_op = types.ModuleType("pytensor.graph.op")
    gradient = types.ModuleType("pytensor.gradient")

    tensor.TensorType = TensorType
    tensor.TensorVariable = TensorVariable
    tensor.dscalar = _f64(0)
    tensor.dvector = _f64(1)
    tensor.dmatrix = _f64(2)
    tensor.dtensor3 = _f64(3)
    tensor.as_tensor_variable = as_tensor_variable
    tensor.constant = constant
    tensor.sum = _sum_fn
    tensor.concatenate = concatenate
    tensor.zeros_like = zeros_like
    tensor.exp = Elemwise("exp").__call__
    tensor.log = Elemwise("log").__call__
    tensor.sqrt = Elemwise("sqrt").__call__
    tensor.grad = grad

    graph_basic.Variable = Variable
    graph_basic.Constant = Constant
    graph_basic.Apply = Apply
    graph_op.Op = Op
    gradient.grad_not_implemented = grad_not_implemented
    gradient.grad = grad

    pytensor.tensor = tensor
    pytensor.graph = graph
    pytensor.gradient = gradient
    pytensor.function = function
    pytensor.grad = grad
    graph.basic = graph_basic
    graph.op = graph_op

    sys.modules["pytensor"] = pytensor
    sys.modules["pytensor.tensor"] = tensor
    sys.modules["pytensor.graph"] = graph
    sys.modules["pytensor.graph.basic"] = graph_basic
    sys.modules["pytensor.graph.op"] = graph_op
    sys.modules["pytensor.gradient"] = gradient
    return True
