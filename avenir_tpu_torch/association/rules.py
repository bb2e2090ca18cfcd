"""Association rule mining from frequent itemsets: the port of
``avenir_tpu/association/rules.py`` (host code, copied).

Parity target: AssociationRuleMiner.  Input lines are frequent itemsets
with their support as the last field.  For every itemset of size > 1, each
non-empty proper sub-list of size <= ``max_antecedent_size`` is an
antecedent and the set difference the consequent; confidence =
support(itemset) / support(antecedent), emitted when strictly above the
threshold as ``ante_items -> cons_items``.  The antecedent's support is a
dict lookup; a rule whose antecedent is not itself a frequent itemset of
the input is skipped (the JAX package's correct join, where the reference
would reuse a stale support).
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, List, Optional, Sequence, Tuple


def generate_sublists(items: Sequence[str], max_size: int
                      ) -> List[Tuple[str, ...]]:
    """All non-empty proper sub-lists up to ``max_size`` elements, preserving
    input order (chombo Utility.generateSublists as used at :133)."""
    n = len(items)
    out: List[Tuple[str, ...]] = []
    for size in range(1, min(max_size, n - 1) + 1):
        out.extend(combinations(items, size))
    return out


def parse_frequent_lines(lines: Sequence[str], delim: str = ",",
                         has_count: bool = False,
                         itemset_length: Optional[int] = None
                         ) -> List[Tuple[Tuple[str, ...], float]]:
    """``items...,support`` lines (mapper :113-118: all fields except the
    last are items).  ``has_count`` additionally strips the count column the
    count-mode Apriori output carries before the support; ``itemset_length``
    caps the item fields instead (for trans-id-mode Apriori output whose
    middle columns are transaction ids)."""
    out = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        tokens = line.split(delim)
        if itemset_length is not None:
            items = tuple(tokens[:itemset_length])
        else:
            items = tuple(tokens[:-2] if has_count else tokens[:-1])
        support = float(tokens[-1])
        out.append((items, support))
    return out


def mine_rules(frequent: Sequence[Tuple[Tuple[str, ...], float]],
               confidence_threshold: float, max_antecedent_size: int = 3,
               delim: str = ",", with_confidence: bool = False
               ) -> List[str]:
    """Rule lines ``ante -> cons`` (reducer :191).  ``with_confidence``
    appends the confidence (extension; default matches reference output)."""
    support: Dict[Tuple[str, ...], float] = {}
    for items, sup in frequent:
        support[tuple(sorted(items))] = sup

    rules: List[str] = []
    for items, total_support in frequent:
        if len(items) <= 1:
            continue
        for ante in generate_sublists(list(items), max_antecedent_size):
            ante_support = support.get(tuple(sorted(ante)))
            if ante_support is None or ante_support <= 0.0:
                continue
            confidence = total_support / ante_support
            if confidence > confidence_threshold:
                ante_set = set(ante)
                cons = [it for it in items if it not in ante_set]
                line = f"{delim.join(ante)} -> {delim.join(cons)}"
                if with_confidence:
                    line += f"{delim}{confidence:.3f}"
                rules.append(line)
    return rules
