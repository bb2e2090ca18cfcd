"""Association rules: frequent itemset mining (``itemsets``) and rule
mining (``rules``), the port of ``avenir_tpu/association``."""

from .itemsets import (ItemSet, TransactionMatrix, apriori_level,
                       format_itemset_lines, frequent_itemsets,
                       mark_infrequent, parse_itemset_lines,
                       read_transactions)
from .rules import generate_sublists, mine_rules

__all__ = [
    "ItemSet", "TransactionMatrix", "apriori_level", "format_itemset_lines",
    "frequent_itemsets", "mark_infrequent", "parse_itemset_lines",
    "read_transactions", "generate_sublists", "mine_rules",
]
