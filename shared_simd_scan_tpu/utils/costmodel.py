"""Structural op counting from traced jaxprs.

The analog of the reference's callgrind cost extraction
(scripts/callgrind_tools.py:1-40, SURVEY.md §2.3 S4): every tier body is a
statically scheduled sequence of elementwise ops on whole word rows, so
instead of profiling instruction counts after the fact we COUNT them in
the jaxpr — reproducibly, from the same code that runs, with no fitted
constants.

``count_vector_ops`` traces a callable and tallies the ALU primitives
whose outputs are (…, 128)-lane arrays, both in plain-XLA tiers and
inside Pallas (Triton) programs.  Every such op processes one word per
block, so ops per value is the count divided by the 32 values per block.

Caveats (documented, not hidden):
- ``cond`` branches are counted at the MAXIMUM across branches — an upper
  bound.
- reductions over (…, 128) inputs (the per-key counts) are counted as ONE
  elementwise-equivalent each (the reduction reads its input once).
- scalar ops are excluded.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Callable

import jax

# Elementwise ALU primitives counted as one op per word.
ALU_PRIMS = frozenset({
    "add", "sub", "mul", "neg",
    "and", "or", "xor", "not",
    "shift_left", "shift_right_logical", "shift_right_arithmetic",
    "eq", "ne", "lt", "le", "gt", "ge",
    "select_n", "population_count", "clz", "min", "max",
})

_CALL_PRIMS = {"pjit", "jit", "closed_call", "custom_jvp_call",
               "custom_vjp_call", "remat", "checkpoint"}

# Reductions: one elementwise-equivalent each (see module
# docstring).
REDUCE_PRIMS = frozenset({
    "reduce_sum", "reduce_max", "reduce_min", "reduce_and", "reduce_or",
    "reduce_prod",
})


def _sub_jaxprs(params: dict) -> list:
    out = []
    for v in params.values():
        if hasattr(v, "jaxpr") and hasattr(v.jaxpr, "eqns"):  # ClosedJaxpr
            out.append(v.jaxpr)
        elif hasattr(v, "eqns"):  # raw Jaxpr
            out.append(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                if hasattr(x, "jaxpr") and hasattr(x.jaxpr, "eqns"):
                    out.append(x.jaxpr)
                elif hasattr(x, "eqns"):
                    out.append(x)
    return out


def _count_alu(jaxpr, counts: Counter) -> None:
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "cond":
            branch_counts = []
            for br in eqn.params["branches"]:
                c = Counter()
                _count_alu(br.jaxpr if hasattr(br, "jaxpr") else br, c)
                branch_counts.append(c)
            if branch_counts:
                # upper bound: the widest branch
                widest = max(branch_counts, key=lambda c: sum(c.values()))
                counts.update(widest)
            continue
        if name in _CALL_PRIMS or name.endswith("_call"):
            for sub in _sub_jaxprs(eqn.params):
                _count_alu(sub, counts)
            continue
        if name == "while" or name == "scan":
            # dynamic loops: count one iteration (callers multiply)
            for sub in _sub_jaxprs(eqn.params):
                _count_alu(sub, counts)
            continue
        if name in REDUCE_PRIMS:
            aval_in = eqn.invars[0].aval
            shp = getattr(aval_in, "shape", ())
            if len(shp) >= 2 and shp[-1] == 128:
                counts[name] += 1
            continue
        if name not in ALU_PRIMS:
            continue
        aval = eqn.outvars[0].aval
        shape = getattr(aval, "shape", ())
        if len(shape) >= 2 and shape[-1] == 128:
            counts[name] += 1


def _find_pallas(jaxpr, out: list) -> None:
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            out.append(eqn)
        for sub in _sub_jaxprs(eqn.params):
            _find_pallas(sub, out)


def count_vector_ops(fn: Callable, *args: Any) -> dict:
    """Trace ``fn(*args)`` and count its word-row ALU ops.

    Returns {"per_block": float, "per_value": float, "by_primitive":
    {name: count}, "n_kernels": int}; n_kernels is the number of Pallas
    programs among them.  per_value assumes the library's
    32-values-per-block layout.
    """
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    calls: list = []
    _find_pallas(jaxpr, calls)
    counts: Counter = Counter()
    _count_alu(jaxpr, counts)
    per_block = float(sum(counts.values()))
    return {
        "per_block": per_block,
        "per_value": per_block / 32.0,
        "by_primitive": dict(counts.most_common()),
        "n_kernels": len(calls),
    }
