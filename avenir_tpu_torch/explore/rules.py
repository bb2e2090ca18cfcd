"""Rule definition and rule evaluation: the port of
``avenir_tpu/explore/rules.py`` (host code, copied), what the
``ruleEvaluator`` and ``sequencePositionalCluster`` jobs need.

Parity targets:
  * RuleExpression — ``condition > consequent`` split on the FIRST '>';
    the condition is a conjunction in the grammar the JAX package
    re-specified for chombo's AttributeFilter (chombo is not vendored):

        condition   := conjunct (SEP conjunct)*
        conjunct    := <ordinal> <op> <operand>
        op          := eq | ne | gt | ge | lt | le | in | notin
        operand     := number | string | value:value:... (for in/notin)
        SEP         := ' and ' by default (rue.cond.delim overrides)

  * RuleEvaluator — per rule: rows matching the condition are counted by
    class value; confidence = the matched consequent's fraction
    (confAccuracy) or 1 + the binary entropy of the matched class
    distribution in bits (confEntropy); support = matched / total;
    output ``ruleName,confidence,support`` to 3 decimals.

Each conjunct is a vectorized numpy comparison over a string column.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

CONSEQUENT_SEP = ">"
DEFAULT_CONJUNCT_SEP = " and "

_OPS = ("eq", "ne", "gt", "ge", "lt", "le", "in", "notin")


@dataclass
class Conjunct:
    ordinal: int
    op: str
    operand: str

    def _operand_values(self) -> List[str]:
        return self.operand.split(":")

    def evaluate_column(self, col: np.ndarray) -> np.ndarray:
        """Vectorized predicate over a raw string column."""
        if self.op in ("eq", "ne"):
            m = col == self.operand
            return m if self.op == "eq" else ~m
        if self.op in ("in", "notin"):
            m = np.isin(col, self._operand_values())
            return m if self.op == "in" else ~m
        # numeric comparison
        vals = col.astype(np.float64)
        ref = float(self.operand)
        return {"gt": vals > ref, "ge": vals >= ref,
                "lt": vals < ref, "le": vals <= ref}[self.op]

    def evaluate(self, row: Sequence[str]) -> bool:
        return bool(self.evaluate_column(
            np.asarray([row[self.ordinal]], dtype=object))[0])


@dataclass
class RuleExpression:
    """``condition > consequent`` (util/RuleExpression.java:49-55)."""
    conjuncts: List[Conjunct]
    consequent: str

    @classmethod
    def create(cls, rule: str, conjunct_sep: str = DEFAULT_CONJUNCT_SEP
               ) -> "RuleExpression":
        cond, _, consequent = rule.partition(CONSEQUENT_SEP)
        conjuncts = []
        for part in cond.split(conjunct_sep):
            part = part.strip()
            if not part:
                continue
            tokens = part.split(None, 2)
            if len(tokens) != 3 or tokens[1] not in _OPS:
                raise ValueError(f"bad conjunct {part!r}; expected "
                                 f"'<ordinal> <op> <operand>' with op in "
                                 f"{_OPS}")
            conjuncts.append(Conjunct(int(tokens[0]), tokens[1], tokens[2]))
        if not conjuncts:
            raise ValueError(f"rule {rule!r} has no condition")
        return cls(conjuncts, consequent.strip())

    def match_mask(self, columns: Sequence[np.ndarray]) -> np.ndarray:
        mask = None
        for c in self.conjuncts:
            m = c.evaluate_column(columns[c.ordinal])
            mask = m if mask is None else (mask & m)
        return mask

    def evaluate(self, row: Sequence[str]) -> bool:
        return all(c.evaluate(row) for c in self.conjuncts)


def _confidence(class_counts: Dict[str, int], consequent: str,
                strategy: str, class_values: Sequence[str]) -> float:
    total = sum(class_counts.values())
    if total == 0:
        return 0.0
    p_this = class_counts.get(consequent, 0) / total
    if strategy == "confAccuracy":
        return p_this
    if strategy == "confEntropy":
        # 1 + sum p ln p / ln 2 over the two classes (RuleEvaluator.java
        # :254-259); x*log(x) -> 0 as x -> 0
        idx = list(class_values).index(consequent)
        other = class_values[idx ^ 1]
        p_other = class_counts.get(other, 0) / total
        acc = 0.0
        for p in (p_this, p_other):
            if p > 0:
                acc += p * math.log(p)
        return acc / math.log(2.0) + 1.0
    raise ValueError(f"invalid confidence strategy {strategy!r}")


def evaluate_rules(rules: Dict[str, RuleExpression],
                   columns: Sequence[np.ndarray], class_ordinal: int,
                   data_size: int, conf_strategy: str,
                   class_values: Sequence[str]
                   ) -> List[Tuple[str, float, float]]:
    """(ruleName, confidence, support) per rule, in rule-name order (the
    shuffle's key order).  ``columns`` are raw string columns; ``data_size``
    is the reference's rue.data.size denominator for support."""
    cls_col = columns[class_ordinal]
    out = []
    for name in sorted(rules):
        rule = rules[name]
        mask = rule.match_mask(columns)
        matched = cls_col[mask]
        vals, counts = (np.unique(matched, return_counts=True)
                        if matched.size else (np.array([]), np.array([])))
        class_counts = {str(v): int(c) for v, c in zip(vals, counts)}
        conf = _confidence(class_counts, rule.consequent, conf_strategy,
                           class_values)
        support = sum(class_counts.values()) / data_size
        out.append((name, conf, support))
    return out
