"""Post-search metadata filtering.

Capability parity with the reference engine (leann-core/src/leann/
metadata_filter.py:20-240): 13 operators, AND semantics across fields,
top-level-then-metadata field lookup, numeric coercion with string fallback.

Filter specs look like::

    {"chapter": {"<=": 3}, "author": {"==": "Austen"}}
    {"tags": {"contains": "physics"}, "published": {"is_true": True}}

Each field maps to ``{operator: operand}``; a result passes only if every
field condition holds (AND). Multiple operators under one field are also
AND-ed.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Sequence

logger = logging.getLogger(__name__)

SUPPORTED_OPERATORS = frozenset(
    {
        "==",
        "!=",
        "<",
        "<=",
        ">",
        ">=",
        "in",
        "not_in",
        "contains",
        "starts_with",
        "ends_with",
        "is_true",
        "is_false",
    }
)


def _coerce_pair(value: Any, operand: Any):
    """Try to compare numerically; fall back to string comparison.

    Mirrors the reference's coercion behavior (metadata_filter.py:209-240):
    "3" < 10 compares as numbers; otherwise both sides are stringified for
    ordering operators.
    """
    try:
        return float(value), float(operand)
    except (TypeError, ValueError):
        return str(value), str(operand)


class MetadataFilterEngine:
    def matches(self, item: Dict[str, Any], filters: "Dict[str, Dict[str, Any]] | None") -> bool:
        if not filters:
            return True
        metadata = item.get("metadata") or {}
        for field, conditions in filters.items():
            if not isinstance(conditions, dict):
                # shorthand {"field": value} == equality
                conditions = {"==": conditions}
            # top-level first, then metadata (reference metadata_filter.py:109-114)
            if field in item:
                value = item[field]
            elif field in metadata:
                value = metadata[field]
            else:
                return False
            for op, operand in conditions.items():
                if not self._apply_op(value, op, operand):
                    return False
        return True

    def _apply_op(self, value: Any, op: str, operand: Any) -> bool:
        if op not in SUPPORTED_OPERATORS:
            raise ValueError(f"Unsupported filter operator {op!r}; supported: {sorted(SUPPORTED_OPERATORS)}")
        try:
            if op == "==":
                a, b = _coerce_pair(value, operand)
                return a == b
            if op == "!=":
                a, b = _coerce_pair(value, operand)
                return a != b
            if op in ("<", "<=", ">", ">="):
                a, b = _coerce_pair(value, operand)
                if op == "<":
                    return a < b
                if op == "<=":
                    return a <= b
                if op == ">":
                    return a > b
                return a >= b
            if op == "in":
                return value in operand
            if op == "not_in":
                return value not in operand
            if op == "contains":
                if isinstance(value, (list, tuple, set, dict)):
                    return operand in value
                return str(operand) in str(value)
            if op == "starts_with":
                return str(value).startswith(str(operand))
            if op == "ends_with":
                return str(value).endswith(str(operand))
            if op == "is_true":
                return bool(value) is True
            if op == "is_false":
                return bool(value) is False
        except TypeError:
            return False
        return False

    def apply_filters(
        self,
        results: Sequence[Dict[str, Any]],
        filters: "Dict[str, Dict[str, Any]] | None",
    ) -> List[Dict[str, Any]]:
        if not filters:
            return list(results)
        return [r for r in results if self.matches(r, filters)]
