"""JAX columnar expression compiler — the device compute path.

Compiles a ValueExpressionNode tree into a traced jax.numpy program
over device column arrays. This is the device replacement for the
reference's per-row stack VM (reference: sql/runtime/vm.cc:107-157):
one XLA fusion evaluates the expression for the whole column.

Coverage: numeric arithmetic/comparison/logic, if(), conversions,
date_trunc with constant window, literals, column refs, and the
null-tag semantics of SURVEY.md App. A (calls clear tags, refs
propagate). Strings participate as dictionary ids (equality and
ordering are rank-preserving after dictionary unification, done on the
host before tracing). Expressions outside this subset make the plan
ineligible for the device path and run on the host engine instead.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from eventql_tpu.core.types import SType
from eventql_tpu.plan.exprs import (
    CallExpressionNode,
    ColumnReferenceNode,
    IfExpressionNode,
    IsNullExpressionNode,
    LiteralExpressionNode,
    ValueExpressionNode,
)

U = SType.UINT64
I = SType.INT64
F = SType.FLOAT64
B = SType.BOOL
S = SType.STRING
T = SType.TIMESTAMP64

_JNP_DTYPE = {
    U: jnp.uint64,
    I: jnp.int64,
    F: jnp.float64,
    B: jnp.bool_,
    T: jnp.uint64,
    S: jnp.int32,
}


class DeviceCol:
    """A traced column: (data, valid) pair of jnp arrays."""

    __slots__ = ("stype", "data", "valid")

    def __init__(self, stype, data, valid):
        self.stype = stype
        self.data = data
        self.valid = valid


def _widen(col: DeviceCol) -> DeviceCol:
    """Restore a physically-narrowed column (device_exec._narrow_np
    stores 64-bit columns whose values fit 32 bits as 32-bit arrays) to
    its logical dtype. Runs inside the traced program: XLA fuses the
    convert into the consumer, so HBM still streams the narrow bytes."""
    want = _JNP_DTYPE.get(col.stype)
    if want is None:
        return col
    if col.data.dtype != jnp.dtype(want):
        return DeviceCol(col.stype, col.data.astype(want), col.valid)
    return col


def _const(value, stype, n):
    dt = _JNP_DTYPE[stype]
    if stype == S:
        raise UnsupportedExpression("string literal on device")
    data = jnp.full((n,), value.payload() if hasattr(value, "payload") else value, dtype=dt)
    valid = jnp.full((n,), not getattr(value, "is_null", False), dtype=jnp.bool_)
    return DeviceCol(stype, data, valid)


class UnsupportedExpression(Exception):
    """Raised at compile time when an expression has no device kernel;
    the plan then falls back to the host engine."""


def _all_valid(n):
    return jnp.ones((n,), dtype=jnp.bool_)


_NUMERIC_BINOPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "lt": lambda a, b: a < b,
    "lte": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "gte": lambda a, b: a >= b,
    "eq": lambda a, b: a == b,
    "neq": lambda a, b: a != b,
}


def compile_expr(
    expr: ValueExpressionNode,
    columns: List[DeviceCol],
    n: int,
):
    """Recursively trace the expression over device columns."""
    if isinstance(expr, LiteralExpressionNode):
        if expr.value.stype == S:
            raise UnsupportedExpression("string literal")
        return _const(expr.value, expr.value.stype, n)

    if isinstance(expr, ColumnReferenceNode):
        if expr.column_index is None:
            raise UnsupportedExpression("unresolved column ref")
        return _widen(columns[expr.column_index])

    if isinstance(expr, IsNullExpressionNode):
        arg = compile_expr(expr.arg, columns, n)
        return DeviceCol(B, ~arg.valid, _all_valid(n))

    if isinstance(expr, IfExpressionNode):
        c = compile_expr(expr.cond, columns, n)
        tv = compile_expr(expr.true_branch, columns, n)
        fv = compile_expr(expr.false_branch, columns, n)
        if tv.stype == S or fv.stype == S:
            raise UnsupportedExpression("string if-branches")
        return DeviceCol(
            tv.stype,
            jnp.where(c.data, tv.data, fv.data),
            jnp.where(c.data, tv.valid, fv.valid),
        )

    if isinstance(expr, CallExpressionNode):
        return _compile_call(expr, columns, n)

    raise UnsupportedExpression(type(expr).__name__)


def _compile_call(expr: CallExpressionNode, columns, n):
    fn = expr.sfunction
    name = fn.name
    rtype = fn.return_type

    args = [compile_expr(a, columns, n) for a in expr.args]

    # string args: only id-based equality is device-safe
    for a, want in zip(args, fn.arg_types):
        if a.stype == S and name not in ("eq", "neq", "cmp", "lt", "lte", "gt", "gte"):
            raise UnsupportedExpression(f"string arg to {name}")

    if name in _NUMERIC_BINOPS:
        a, b = args
        out = _NUMERIC_BINOPS[name](a.data, b.data)
        return DeviceCol(rtype, out.astype(_JNP_DTYPE[rtype]), _all_valid(n))

    if name == "div":
        a, b = args
        return DeviceCol(F, a.data / b.data, _all_valid(n))

    if name == "mod":
        a, b = args
        if rtype == F:
            out = jnp.where(b.data != 0, jnp.fmod(a.data, b.data), jnp.nan)
        else:
            bb = jnp.where(b.data == 0, 1, b.data)
            out = (
                jnp.fmod(a.data, bb)
                if rtype == I
                else jnp.mod(a.data, bb)
            )
        return DeviceCol(rtype, out.astype(_JNP_DTYPE[rtype]), _all_valid(n))

    if name == "pow":
        a, b = args
        out = jnp.power(a.data.astype(jnp.float64), b.data.astype(jnp.float64))
        return DeviceCol(rtype, out.astype(_JNP_DTYPE[rtype]), _all_valid(n))

    if name == "logical_and":
        a, b = args
        return DeviceCol(B, a.data & b.data, _all_valid(n))
    if name == "logical_or":
        a, b = args
        return DeviceCol(B, a.data | b.data, _all_valid(n))
    if name == "neg":
        (a,) = args
        if a.stype == B:
            return DeviceCol(B, ~a.data, _all_valid(n))
        return DeviceCol(rtype, (-a.data.astype(_JNP_DTYPE[rtype])), _all_valid(n))

    if name == "cmp":
        a, b = args
        out = jnp.where(a.data < b.data, -1, jnp.where(a.data > b.data, 1, 0))
        return DeviceCol(I, out.astype(jnp.int64), _all_valid(n))

    if name in ("to_int64", "to_uint64", "to_float64", "to_timestamp64",
                "to_int", "to_float", "to_timestamp", "truncate"):
        (a,) = args
        if a.stype == S:
            raise UnsupportedExpression("string cast on device")
        if name == "truncate" and a.stype == F:
            out = jnp.trunc(a.data)
        else:
            out = a.data
        return DeviceCol(rtype, out.astype(_JNP_DTYPE[rtype]), _all_valid(n))

    if name == "to_nil":
        return DeviceCol(
            SType.NIL, jnp.zeros((n,), jnp.uint8), jnp.zeros((n,), jnp.bool_)
        )

    if name == "from_timestamp":
        (a,) = args
        if a.stype == F:
            out = (a.data * 1e6).astype(jnp.uint64)
        else:
            out = (a.data.astype(jnp.uint64)) * jnp.uint64(1000000)
        return DeviceCol(T, out, _all_valid(n))

    if name == "date_trunc":
        window, ts = expr.args[0], args[1]
        if not isinstance(window, LiteralExpressionNode):
            raise UnsupportedExpression("non-constant date_trunc window")
        from eventql_tpu.exec.vector_eval import _parse_time_window

        t = _parse_time_window(window.value.payload())
        out = (ts.data // jnp.uint64(t)) * jnp.uint64(t)
        return DeviceCol(T, out, _all_valid(n))

    raise UnsupportedExpression(name)


_DEVICE_FNS = set(_NUMERIC_BINOPS) | {
    "div", "mod", "pow", "logical_and", "logical_or", "neg", "cmp",
    "to_int64", "to_uint64", "to_float64", "to_timestamp64", "to_int",
    "to_float", "to_timestamp", "truncate", "to_nil", "from_timestamp",
    "date_trunc",
}


def expr_is_device_compatible(expr: ValueExpressionNode) -> bool:
    """Static check: can this expression run fully on device?"""
    if isinstance(expr, LiteralExpressionNode):
        return expr.value.stype != S
    if isinstance(expr, ColumnReferenceNode):
        return expr.column_index is not None
    if isinstance(expr, IsNullExpressionNode):
        return expr_is_device_compatible(expr.arg)
    if isinstance(expr, IfExpressionNode):
        return expr.rtype != S and all(
            expr_is_device_compatible(a) for a in expr.arguments()
        )
    if isinstance(expr, CallExpressionNode):
        name = expr.sfunction.name
        if name not in _DEVICE_FNS:
            return False
        if name == "date_trunc" and not isinstance(
            expr.args[0], LiteralExpressionNode
        ):
            return False
        if name == "mod" and expr.return_type() != SType.FLOAT64:
            # integer modulo raises "modulo by zero" per evaluated row
            # (reference: sql/expressions/math.cc:178-206) — the device
            # can't raise data-dependently, so route to host unless the
            # divisor is a provably nonzero literal. Float mod is fmod
            # and permits zero (math.cc:208-212).
            div = expr.args[1] if len(expr.args) > 1 else None
            if not (
                isinstance(div, LiteralExpressionNode)
                and not div.value.is_null
                and div.value.payload() not in (0, 0.0)
            ):
                return False
        # string args only flow through comparison ops (id-preserving)
        for a in expr.args:
            if a.return_type() == S and name not in (
                "eq", "neq", "cmp", "lt", "lte", "gt", "gte",
            ):
                return False
        return all(expr_is_device_compatible(a) for a in expr.args)
    return False
