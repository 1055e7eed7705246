"""Predicate-tree query layer: compose column predicates, evaluate fused.

Capability extension over the reference (whose API surface is one kernel
call per predicate set: src/simd_scan.hpp:46-120): a small algebra of
predicates over same-table packed columns —

    Eq(col, key)        column == key
    Range(col, lo, hi)  lo <= column < hi        (half-open)
    In(col, keys)       column IN keys
    And(*terms) / Or(*terms) / Not(term)

— and ``evaluate(expr)`` which PLANS the tree onto the kernel tiers
instead of evaluating leaf-by-leaf:

- every Range/Eq conjunct of an And is merged per column (intersected
  bounds) and the whole group runs as ONE fused multi-column pass
  (ops.conj), reading each column once and writing one bitvector;
- In leaves dispatch through the member-scan tiers (interval / window
  popmask / compare / bit-sliced by static cost);
- residual boolean structure (Or / Not / mixed subtrees) composes the
  resulting bitvectors word-wise (bitvector.logical_*) — n/32 words per
  node, noise next to the column passes.

Predicate constants must be concrete (Python/numpy numbers), which is
what enables the static tier dispatch; columns are DeviceColumns of the
same n.  Returns (canonical bitvector words uint32[ceil(n/32)], count
uint32) with the library-wide tail invariant (bits at i >= n are zero).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from shared_simd_scan_tpu import bitvector
from shared_simd_scan_tpu.layout import DeviceColumn
from shared_simd_scan_tpu.ops import conj as conj_ops
from shared_simd_scan_tpu.ops import member as member_ops
from shared_simd_scan_tpu.ops import scan as scan_ops


@dataclasses.dataclass(frozen=True)
class Range:
    """lo <= col < hi (half-open, unsigned)."""

    col: DeviceColumn
    lo: int
    hi: int


def Eq(col: DeviceColumn, key: int) -> Range:
    """col == key: the degenerate range [key, key+1)."""
    return Range(col, int(key), int(key) + 1)


@dataclasses.dataclass(frozen=True)
class In:
    """col IN keys (concrete key set)."""

    col: DeviceColumn
    keys: tuple

    def __init__(self, col: DeviceColumn, keys: Sequence[int]):
        object.__setattr__(self, "col", col)
        object.__setattr__(
            self, "keys", tuple(int(k) for k in np.asarray(keys).ravel())
        )


@dataclasses.dataclass(frozen=True)
class And:
    terms: tuple

    def __init__(self, *terms):
        object.__setattr__(self, "terms", tuple(terms))


@dataclasses.dataclass(frozen=True)
class Or:
    terms: tuple

    def __init__(self, *terms):
        object.__setattr__(self, "terms", tuple(terms))


@dataclasses.dataclass(frozen=True)
class Not:
    term: object


def _columns(expr) -> list[DeviceColumn]:
    if isinstance(expr, (Range, In)):
        return [expr.col]
    if isinstance(expr, (And, Or)):
        return [c for t in expr.terms for c in _columns(t)]
    if isinstance(expr, Not):
        return _columns(expr.term)
    raise TypeError(f"not a query expression: {expr!r}")


def _group_or_terms(terms):
    """Plan an Or's children: per column, (multi-value spans) and (merged
    member keys from In terms + single-value Eq spans); plus the residual
    non-leaf terms.  Statically empty disjuncts are dropped."""
    spans_by_col: dict[int, tuple[DeviceColumn, list]] = {}
    keys_by_col: dict[int, tuple[DeviceColumn, list]] = {}
    others = []
    for t in terms:
        if isinstance(t, Range) and t.hi == t.lo + 1:
            keys_by_col.setdefault(id(t.col), (t.col, []))[1].append(t.lo)
        elif isinstance(t, Range) and t.lo < t.hi:
            spans_by_col.setdefault(id(t.col), (t.col, []))[1].append(
                (t.lo, t.hi)
            )
        elif isinstance(t, Range):
            pass  # statically empty disjunct
        elif isinstance(t, In):
            if t.keys:
                keys_by_col.setdefault(id(t.col), (t.col, []))[1].extend(
                    t.keys
                )
        else:
            others.append(t)
    # dedupe merged keys, preserve order for determinism
    for cid, (col, keys) in list(keys_by_col.items()):
        seen, uniq = set(), []
        for k in keys:
            if k not in seen:
                seen.add(k)
                uniq.append(k)
        keys_by_col[cid] = (col, uniq)
    return spans_by_col, keys_by_col, others


def _group_and_terms(terms):
    """Plan an And's children: per-column intersected range bounds
    (chunked into conj-kernel groups of MAX_COLUMNS) plus the residual
    terms.  Returns (groups, others, empty) — empty=True when some
    column's intersection is statically empty."""
    bounds: dict[int, tuple[DeviceColumn, int, int]] = {}
    others = []
    for t in terms:
        if isinstance(t, Range):
            key = id(t.col)
            if key in bounds:
                col, lo, hi = bounds[key]
                bounds[key] = (col, max(lo, t.lo), min(hi, t.hi))
            else:
                bounds[key] = (t.col, t.lo, t.hi)
        else:
            others.append(t)
    groups = list(bounds.values())
    empty = any(hi <= lo for _, lo, hi in groups)
    chunks = [
        groups[at:at + conj_ops.MAX_COLUMNS]
        for at in range(0, len(groups), conj_ops.MAX_COLUMNS)
    ]
    return chunks, others, empty


def _eval(expr, n: int, zonemaps=None) -> jax.Array:
    """-> canonical bitvector words for the subtree.

    ``zonemaps`` maps ``id(col)`` -> zonemap.ZoneMap: Range/Eq work on a
    mapped column scans only the pruned block span (zonemap.py).  Range
    conjuncts of an And merge per column first; a merged single-column
    group still prunes, multi-column fused groups run the conj kernel
    (cross-column span intersection is future work)."""
    if isinstance(expr, Range):
        zm = (zonemaps or {}).get(id(expr.col))
        if zm is not None:
            from shared_simd_scan_tpu import zonemap as zonemap_mod

            bits, _ = zonemap_mod.pruned_range_scan(
                expr.col, zm, int(expr.lo), int(expr.hi), full_bits=True,
            )
            return bits
        return _eval(And(expr), n)
    if isinstance(expr, In):
        if not expr.keys:
            return jnp.zeros((n + 31) // 32, jnp.uint32)
        bits, _ = member_ops.member_scan_device(
            expr.col, np.asarray(expr.keys, np.uint32)
        )
        return bits
    if isinstance(expr, Not):
        return bitvector.logical_not(_eval(expr.term, n, zonemaps), n)
    if isinstance(expr, Or):
        if not expr.terms:
            return jnp.zeros((n + 31) // 32, jnp.uint32)
        # Disjuncts group per column: single-value ranges (Eq) and In
        # keys merge into ONE member scan (the union IS the member
        # semantics); multi-value ranges share ONE k-range pass per
        # column (ops.scan.range_scan_tiles, <= 32 unrolled per call)
        spans_by_col, keys_by_col, others = _group_or_terms(expr.terms)
        rows = [_eval(t, n, zonemaps) for t in others]
        from shared_simd_scan_tpu.ops.scan import (
            bits_to_canonical,
            range_scan_tiles,
        )

        for col, keys in keys_by_col.values():
            rows.append(_eval(In(col, keys), n, zonemaps))
        for col, spans in spans_by_col.values():
            if len(spans) == 1:
                # single range: the conj kernel writes the one fused row
                rows.append(_eval(Range(col, *spans[0]), n, zonemaps))
                continue
            for at in range(0, len(spans), 32):
                g = spans[at:at + 32]
                kbits, _ = range_scan_tiles(
                    col.tiles,
                    jnp.asarray([lo for lo, _ in g], jnp.uint32),
                    jnp.asarray([hi for _, hi in g], jnp.uint32),
                    col.width, n,
                )
                rows.append(
                    bitvector.logical_or(
                        *[bits_to_canonical(kbits[j], n) for j in range(len(g))]
                    )
                )
        if not rows:
            return jnp.zeros((n + 31) // 32, jnp.uint32)
        return bitvector.logical_or(*rows)
    if isinstance(expr, And):
        if not expr.terms:
            return bitvector.logical_not(
                jnp.zeros((n + 31) // 32, jnp.uint32), n
            )
        # merge every Range conjunct per column: intersected bounds, one
        # fused multi-column pass for the whole group
        chunks, others, empty = _group_and_terms(expr.terms)
        if empty:
            # statically empty intersection on some column
            return jnp.zeros((n + 31) // 32, jnp.uint32)
        rows = []
        if zonemaps:
            pruned = []
            for g in chunks:
                keep = []
                for col, lo, hi in g:
                    if id(col) in zonemaps:
                        pruned.append(
                            _eval(Range(col, lo, hi), n, zonemaps)
                        )
                    else:
                        keep.append((col, lo, hi))
                if keep:
                    bits, _ = conj_ops.conj_range_scan_device(
                        [c for c, _, _ in keep],
                        np.asarray([lo for _, lo, _ in keep], np.uint32),
                        np.asarray([hi for _, _, hi in keep], np.uint32),
                    )
                    pruned.append(bits)
            rows.extend(pruned)
            rows.extend(_eval(t, n, zonemaps) for t in others)
            return bitvector.logical_and(*rows) if rows else _eval(And(), n)
        for g in chunks:
            bits, _ = conj_ops.conj_range_scan_device(
                [c for c, _, _ in g],
                np.asarray([lo for _, lo, _ in g], np.uint32),
                np.asarray([hi for _, _, hi in g], np.uint32),
            )
            rows.append(bits)
        rows.extend(_eval(t, n, zonemaps) for t in others)
        return bitvector.logical_and(*rows)
    raise TypeError(f"not a query expression: {expr!r}")


def evaluate(
    expr, zonemaps: dict | None = None
) -> tuple[jax.Array, jax.Array]:
    """Evaluate a predicate tree -> (canonical bitvector words, count).

    ``zonemaps``: optional ``{id(col): zonemap.ZoneMap}`` — Range/Eq
    leaves on mapped columns scan only the pruned block span (sorted /
    clustered columns answer point predicates in O(1) zones; see
    zonemap.py).  Build with ``{id(col): build_zonemap(col)}``."""
    cols = _columns(expr)
    if not cols:
        raise ValueError("query references no columns")
    n = cols[0].n
    for c in cols:
        if c.n != n:
            raise ValueError(f"query columns must share n, got {c.n} != {n}")
    bits = _eval(expr, n, zonemaps)
    return bits, bitvector.popcount(bits)


# ---------------------------------------------------------------------------
# Sharded (multi-chip) evaluation
# ---------------------------------------------------------------------------
#
# Same planning, over columns sharded along the block axis
# (parallel.dist.shard_column): leaves run the sharded kernel wrappers and
# return device-layout (B1, 128) bitvector tiles that STAY sharded; the
# boolean composition is plain word-wise jnp on those sharded arrays, which
# XLA executes shard-locally with no collective at all — only the final
# popcount reduces over the mesh.  NOT must re-zero the padding blocks
# (zero in every kernel output by the tail invariant, but a complement
# would set them), hence the validity tile mask.


def _valid_tile_mask(b1: int, n: int) -> jax.Array:
    full, rem = n // 32, n % 32
    blk = (
        jnp.arange(b1, dtype=jnp.int32)[:, None] * 128
        + jnp.arange(128, dtype=jnp.int32)[None, :]
    )
    return jnp.where(
        blk < full,
        jnp.uint32(0xFFFFFFFF),
        jnp.where(
            blk == full,
            jnp.uint32((1 << rem) - 1 if rem else 0),
            jnp.uint32(0),
        ),
    )


def _eval_sharded(expr, n: int, b1: int, mesh) -> jax.Array:
    from shared_simd_scan_tpu.parallel import dist

    if isinstance(expr, Range):
        return _eval_sharded(And(expr), n, b1, mesh)
    if isinstance(expr, In):
        if not expr.keys:
            return jnp.zeros((b1, 128), jnp.uint32)
        bits, _ = dist.sharded_member_scan(
            expr.col, np.asarray(expr.keys, np.uint32), mesh,
        )
        return bits
    if isinstance(expr, Not):
        inner = _eval_sharded(expr.term, n, b1, mesh)
        return ~inner & _valid_tile_mask(b1, n)
    if isinstance(expr, Or):
        if not expr.terms:
            return jnp.zeros((b1, 128), jnp.uint32)
        spans_by_col, keys_by_col, others = _group_or_terms(expr.terms)
        rows = [_eval_sharded(t, n, b1, mesh) for t in others]
        for col, keys in keys_by_col.values():
            rows.append(_eval_sharded(In(col, keys), n, b1, mesh))
        for col, spans in spans_by_col.values():
            if len(spans) == 1:
                rows.append(
                    _eval_sharded(And(Range(col, *spans[0])), n, b1, mesh)
                )
                continue
            for at in range(0, len(spans), 32):
                g = spans[at:at + 32]
                kbits, _ = dist.sharded_range_scan(
                    col,
                    np.asarray([lo for lo, _ in g], np.uint32),
                    np.asarray([hi for _, hi in g], np.uint32),
                    mesh,
                )
                merged = kbits[0]
                for j in range(1, len(g)):
                    merged = merged | kbits[j]
                rows.append(merged)
        if not rows:
            return jnp.zeros((b1, 128), jnp.uint32)
        out = rows[0]
        for r in rows[1:]:
            out = out | r
        return out
    if isinstance(expr, And):
        if not expr.terms:
            return _valid_tile_mask(b1, n)
        chunks, others, empty = _group_and_terms(expr.terms)
        if empty:
            return jnp.zeros((b1, 128), jnp.uint32)
        rows = []
        for g in chunks:
            bits, _ = dist.sharded_conj_range_scan(
                [c for c, _, _ in g],
                np.asarray([lo for _, lo, _ in g], np.uint32),
                np.asarray([hi for _, _, hi in g], np.uint32),
                mesh,
            )
            rows.append(bits)
        rows.extend(
            _eval_sharded(t, n, b1, mesh) for t in others
        )
        out = rows[0]
        for r in rows[1:]:
            out = out & r
        return out
    raise TypeError(f"not a query expression: {expr!r}")


def evaluate_sharded(
    expr, mesh
) -> tuple[jax.Array, jax.Array]:
    """Evaluate a predicate tree over block-axis-sharded columns ->
    (device-layout bits uint32[B1, 128], still sharded along the block
    axis, total count uint32).  Columns must be sharded identically
    (same ``dist.shard_column(·, mesh)``); use
    ``ops.scan.bits_to_canonical(bits, n)`` to gather canonical words."""
    cols = _columns(expr)
    if not cols:
        raise ValueError("query references no columns")
    n = cols[0].n
    b1 = cols[0].tiles.shape[1]
    for c in cols:
        if c.n != n:
            raise ValueError(f"query columns must share n, got {c.n} != {n}")
        if c.tiles.shape[1] != b1:
            raise ValueError("query columns must be sharded identically")
    bits = _eval_sharded(expr, n, b1, mesh)
    return bits, bitvector.popcount(bits)


def _member_tier_name(keys: tuple, width: int) -> str:
    """The tier member_scan_tiles will dispatch — straight from the
    dispatcher's own cost rule (ops.member.member_dispatch_tier)."""
    arr = np.asarray(keys, np.uint32)
    tier = member_ops.member_dispatch_tier(arr, width)
    if tier == "interval":
        return "member:interval(range-compare)"
    if tier == "window":
        bases, _ = member_ops.member_window_plan(arr)
        return f"member:window-popmask({len(bases)} windows)"
    if tier == "domain":
        return f"member:domain-bitmap({max(1, (1 << width) // 32)} words)"
    if tier == "ortree":
        ops = scan_ops._static_dag_ops(width, arr.tolist(), member=True)
        return f"member:or-tree({ops} DAG ops)"
    return f"member:{'bit-sliced' if tier == 'bitsliced' else 'compare'}"


def explain(expr, indent: str = "") -> str:
    """Human-readable evaluation plan: which kernel tier each leaf/group
    dispatches to and where bitvector composition happens.  Purely
    static — nothing executes."""
    if isinstance(expr, Range):
        return explain(And(expr), indent)
    if isinstance(expr, In):
        if not expr.keys:
            return f"{indent}constant: empty IN -> zeros"
        return (f"{indent}{_member_tier_name(expr.keys, expr.col.width)} "
                f"k={len(expr.keys)} [one pass, one bitvector]")
    if isinstance(expr, Not):
        return (f"{indent}NOT (word-wise complement, tail re-masked)\n"
                + explain(expr.term, indent + "  "))
    if isinstance(expr, (And, Or)):
        op = "AND" if isinstance(expr, And) else "OR"
        lines = [f"{indent}{op} (word-wise combine)"]
        if isinstance(expr, And):
            chunks, others, empty = _group_and_terms(expr.terms)
            if empty:
                return (f"{indent}constant: statically empty range "
                        "intersection -> zeros")
            for g in chunks:
                spans = ", ".join(f"[{lo},{hi})" for _, lo, hi in g)
                lines.append(
                    f"{indent}  conj:fused-range m={len(g)} {spans} "
                    "[one pass over all columns, one bitvector]"
                )
            lines.extend(explain(t, indent + "  ") for t in others)
        else:
            spans_by_col, keys_by_col, others = _group_or_terms(expr.terms)
            for col, keys in keys_by_col.values():
                lines.append(
                    f"{indent}  {_member_tier_name(tuple(keys), col.width)} "
                    f"k={len(keys)} [merged In/Eq disjuncts, one pass]"
                )
            for col, spans in spans_by_col.values():
                if len(spans) == 1:
                    lines.append(
                        f"{indent}  conj:fused-range m=1 "
                        f"[{spans[0][0]},{spans[0][1]}) [one pass]"
                    )
                else:
                    lines.append(
                        f"{indent}  range-scan k={len(spans)} ranges on one "
                        "column [one pass, rows OR'd]"
                    )
            lines.extend(explain(t, indent + "  ") for t in others)
        return "\n".join(lines)
    raise TypeError(f"not a query expression: {expr!r}")


__all__ = [
    "Eq", "Range", "In", "And", "Or", "Not", "evaluate", "evaluate_sharded",
    "explain",
]
