"""Frequent itemset mining, level-wise Apriori: the port of
``avenir_tpu/association/itemsets.py``.

Reference behavior (association/FrequentItemsApriori.java):
  * level 1: count each item's transactions
  * level k: extend each frequent (k-1)-itemset with every co-occurring item
    of a transaction that contains it, dedup by sorted item tuple, count
    distinct supporting transactions
  * emit only itemsets with support strictly above ``fia.support.threshold``;
    support printed with 3 decimals
  * itemset file format ``item...,transId...,support`` (ids optional)

Transactions are a uint8 membership matrix ``M (n_trans, n_items)`` over the
item vocabulary, uploaded a chunk of rows at a time.  The support count of
a k-item candidate set ``C`` is ``sum_t prod_j M[t, C_j]``, computed for all
candidates at once in one of two forms chosen by the device of the
membership tensor, with no knob: on a CUDA device one float32 matmul
against the multi-hot candidate matrix and a test ``== k``
(:func:`support_matmul`; TF32 is off, ``runtime``), on the CPU k column
gathers multiplied together (:func:`support_gather`).  Both are exact small
integers, so they agree count for count.  Candidate generation stays on the
host, as the reference keeps it in the mapper.

As in the JAX package, the support is always the exact distinct-transaction
count (the reference's transaction-id mode; its count mode double-counts a
transaction reaching a k-itemset through several (k-1)-subsets).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..runtime import DeviceLike, resolve_device
from ..utils.tracing import LayerProfile, fetch, layer, note_h2d

# (rows x candidates) cells of one chunk's hit matrix
SUPPORT_CHUNK_CELLS = 1 << 26


def support_matmul(M: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """(n_cand,) int64 support of the index sets ``C (n_cand, k)`` over the
    0/1 rows of ``M (rows, V)``: ``prod_j M[t, c_j] == (sum_j M[t, c_j] ==
    k)`` for sets, so one float32 matmul against the multi-hot candidate
    matrix (scatter-built) and an equality test.  Every value is a small
    integer: exact."""
    k = C.shape[1]
    K = torch.zeros((C.shape[0], M.shape[1]), dtype=torch.float32,
                    device=M.device)
    K.scatter_add_(1, C.long(), torch.ones(C.shape, dtype=torch.float32,
                                           device=M.device))
    hits = M.float() @ K.T                                   # (rows, n_cand)
    return (hits == float(k)).sum(dim=0)


def support_gather(M: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Same counts by k column gathers and a running product (the CPU
    form: the dense matmul does V/k x more arithmetic)."""
    Mf = M.float()
    acc = torch.ones((M.shape[0], C.shape[0]), dtype=torch.float32,
                     device=M.device)
    for j in range(C.shape[1]):
        acc = acc * Mf[:, C[:, j].long()]
    return acc.sum(dim=0, dtype=torch.float64).to(torch.int64)


def support(M: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """The form for the tensors' device: the matmul on CUDA, the gathers
    on the CPU."""
    return support_matmul(M, C) if M.device.type == "cuda" \
        else support_gather(M, C)


@dataclass
class ItemSet:
    """One frequent itemset (ItemSetList.java)."""
    items: Tuple[str, ...]
    trans_ids: List[str] = dc_field(default_factory=list)
    support: float = 0.0
    count: int = 0


def parse_itemset_lines(lines: Sequence[str], itemset_length: int,
                        contains_trans_ids: bool, delim: str = ","
                        ) -> List[ItemSet]:
    """The per-level itemset file: the first ``itemset_length`` tokens are
    items; with ``contains_trans_ids`` the tokens up to the last are
    transaction ids; the last token is the support."""
    out: List[ItemSet] = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        tokens = line.split(delim)
        items = tuple(tokens[:itemset_length])
        trans: List[str] = []
        if contains_trans_ids:
            trans = list(tokens[itemset_length:-1])
        try:
            support_v = float(tokens[-1])
        except ValueError:
            support_v = 0.0
        out.append(ItemSet(items, trans, support_v))
    return out


def format_itemset_lines(itemsets: Sequence[ItemSet], emit_trans_id: bool,
                         trans_id_output: bool, delim: str = ","
                         ) -> List[str]:
    """The reducer's layout: trans-id mode with ids
    ``items...,transIds...,support``; without ids ``items...,support``;
    count mode ``items...,count,support`` (support to 3 decimals)."""
    lines = []
    for s in itemsets:
        parts = list(s.items)
        if emit_trans_id:
            if trans_id_output:
                parts.extend(s.trans_ids)
        else:
            parts.append(str(s.count))
        parts.append(f"{s.support:.3f}")
        lines.append(delim.join(parts))
    return lines


def read_transactions(rows: Sequence[Sequence[str]], trans_id_ord: int = 0,
                      skip_field_count: int = 1,
                      infreq_item_marker: Optional[str] = None
                      ) -> List[Tuple[str, List[str]]]:
    """Tokenized rows -> (trans_id, items): the id at ``trans_id_ord``, the
    items from ``skip_field_count`` on, marked-infrequent tokens dropped."""
    if infreq_item_marker is None:
        return [(row[trans_id_ord], row[skip_field_count:]) for row in rows]
    return [(row[trans_id_ord], [t for t in row[skip_field_count:]
                                 if t != infreq_item_marker]) for row in rows]


class TransactionMatrix:
    """uint8 membership matrix over the item vocabulary (host), the
    transactions' device form a chunk at a time.

    ``items`` pins an explicit (e.g. globally merged) vocabulary; items in
    the transactions but not in ``items`` are ignored, items in ``items``
    but absent locally get an all-zero column (a joined run builds every
    process's matrix over the same merged vocabulary)."""

    def __init__(self, transactions: Sequence[Tuple[str, List[str]]],
                 items: Optional[Sequence[str]] = None):
        self.trans_ids = [t for t, _ in transactions]
        # first-appearance order, as the JAX package's dict
        src = items if items is not None else \
            (it for _, row in transactions for it in row)
        self.vocab: Dict[str, int] = {
            it: i for i, it in enumerate(dict.fromkeys(src))}
        self.items = list(self.vocab)
        n, m = len(transactions), max(len(self.vocab), 1)
        lens = np.fromiter((len(r) for _, r in transactions), dtype=np.int64,
                           count=n)
        g = self.vocab.get
        cols = np.fromiter((g(it, -1) for _, r in transactions for it in r),
                           dtype=np.int64, count=int(lens.sum()))
        rows = np.repeat(np.arange(n), lens)
        keep = cols >= 0
        mat = np.zeros((n, m), dtype=np.uint8)
        mat[rows[keep], cols[keep]] = 1
        self.matrix = mat

    def support_counts(self, cand_idx: np.ndarray, device: DeviceLike = None,
                       profile: Optional[LayerProfile] = None) -> np.ndarray:
        """Exact (n_cand,) int64 support counts of the vocab index sets
        ``cand_idx (n_cand, k)``: the uint8 rows uploaded a chunk at a time
        (at most SUPPORT_CHUNK_CELLS hit cells), counted by :func:`support`
        for the device, summed in int64 on it and read back once."""
        if cand_idx.size == 0:
            return np.zeros((0,), dtype=np.int64)
        dev = resolve_device(device)
        with layer(profile, "h2d"):
            C = torch.from_numpy(np.ascontiguousarray(cand_idx)).to(dev)
        total = torch.zeros((cand_idx.shape[0],), dtype=torch.int64,
                            device=dev)
        chunk = max(1024, SUPPORT_CHUNK_CELLS // cand_idx.shape[0])
        for lo in range(0, self.matrix.shape[0], chunk):
            part = self.matrix[lo:lo + chunk]
            with layer(profile, "h2d"):
                M = torch.from_numpy(part)
                if dev.type != "cpu":
                    note_h2d(part.nbytes)
                    M = M.to(dev)
            with layer(profile, "device"):
                total += support(M, C)
        with layer(profile, "readback"):
            return fetch(total)

    def supporting_trans(self, item_idx: Sequence[int]) -> List[str]:
        mask = self.matrix[:, list(item_idx)].all(axis=1)
        return [self.trans_ids[i] for i in np.flatnonzero(mask).tolist()]


def _level1_candidates(tm: TransactionMatrix) -> np.ndarray:
    return np.arange(len(tm.items), dtype=np.int32)[:, None]


def _extend_candidates(tm: TransactionMatrix, prior: Sequence[ItemSet]
                       ) -> List[Tuple[str, ...]]:
    """Candidate k-itemsets: each frequent (k-1)-itemset joined with every
    item co-occurring in some supporting transaction, dedup'd by sorted
    tuple.  Items absent from the vocabulary (e.g. pruned by the
    infrequent marker) cannot extend anything."""
    cands = set()
    vocab = tm.vocab
    for s in prior:
        if any(it not in vocab for it in s.items):
            continue
        base_idx = [vocab[it] for it in s.items]
        sub = tm.matrix[:, base_idx].all(axis=1)          # trans ⊇ itemset
        co = tm.matrix[sub].any(axis=0)                   # co-occurring items
        base = set(s.items)
        for j in np.nonzero(co)[0]:
            it = tm.items[j]
            if it not in base:
                cands.add(tuple(sorted(base | {it})))
    return sorted(cands)


def apriori_level(transactions: Sequence[Tuple[str, List[str]]],
                  itemset_length: int, total_trans_count: int,
                  support_threshold: float,
                  prior: Optional[Sequence[ItemSet]] = None,
                  emit_trans_id: bool = True,
                  collect_trans_ids: Optional[bool] = None,
                  device: DeviceLike = None,
                  profile: Optional[LayerProfile] = None) -> List[ItemSet]:
    """One reference pass: the frequent itemsets of exactly
    ``itemset_length`` items given the previous level (``prior``; chained
    in process when None), support strictly above the threshold.
    ``collect_trans_ids`` (default ``emit_trans_id``) materializes the
    supporting transaction ids.

    In a joined run ``transactions`` is this process's part and the result
    is the global level: the item vocabulary and the candidate sets are
    unioned across processes (``allgather_object``), every process counts
    the same ordered candidates, and the counts are summed; every process
    returns the same level."""
    from ..parallel import distributed as D
    dist = D.is_multiprocess()
    if collect_trans_ids is None:
        collect_trans_ids = emit_trans_id
    with layer(profile, "encode"):
        if dist:
            local_items = sorted({it for _, row in transactions
                                  for it in row})
            global_items: List[str] = sorted(
                set().union(*D.allgather_object(local_items)))
            tm = TransactionMatrix(transactions, items=global_items)
        else:
            tm = TransactionMatrix(transactions)
    if itemset_length == 1:
        cand_idx = _level1_candidates(tm)
        cand_items: List[Tuple[str, ...]] = [(it,) for it in tm.items]
    else:
        if prior is None:
            prior = apriori_level(transactions, itemset_length - 1,
                                  total_trans_count, support_threshold,
                                  None, emit_trans_id,
                                  collect_trans_ids=False, device=device)
        with layer(profile, "candidates"):
            cand_items = _extend_candidates(tm, prior)
            if dist:
                cand_items = sorted(
                    set().union(*D.allgather_object(cand_items)))
            cand_idx = np.array(
                [[tm.vocab[it] for it in items] for items in cand_items],
                dtype=np.int32).reshape(len(cand_items), itemset_length)
    counts = tm.support_counts(cand_idx, device, profile)
    if dist:
        counts = D.all_reduce_host_array(counts)
    keep = [(items, int(cnt)) for items, cnt in zip(cand_items, counts)
            if float(cnt) / total_trans_count > support_threshold]
    trans_lists: List[List[str]] = [[] for _ in keep]
    if collect_trans_ids:
        with layer(profile, "trans_ids"):
            trans_lists = [tm.supporting_trans([tm.vocab[i] for i in items])
                           for items, _ in keep]
            if dist:
                per_proc = D.allgather_object(trans_lists)
                trans_lists = [[tid for shard in per_proc for tid in shard[i]]
                               for i in range(len(keep))]
    out = [ItemSet(items, trans, float(cnt) / total_trans_count, cnt)
           for (items, cnt), trans in zip(keep, trans_lists)]
    out.sort(key=lambda s: s.items)
    return out


def frequent_itemsets(transactions: Sequence[Tuple[str, List[str]]],
                      support_threshold: float, max_length: int,
                      total_trans_count: Optional[int] = None,
                      emit_trans_id: bool = True, device: DeviceLike = None
                      ) -> Dict[int, List[ItemSet]]:
    """Levels 1..max_length in one call (the reference re-runs the job a
    level).  In a joined run the default total is the global count."""
    if total_trans_count is not None:
        total = total_trans_count
    else:
        total = len(transactions)
        from ..parallel import distributed as D
        if D.is_multiprocess():
            total = int(D.all_reduce_host_array(
                np.array([total], dtype=np.int64))[0])
    levels: Dict[int, List[ItemSet]] = {}
    prior: Optional[List[ItemSet]] = None
    for k in range(1, max_length + 1):
        level = apriori_level(transactions, k, total, support_threshold,
                              prior, emit_trans_id, device=device)
        if not level:
            break
        levels[k] = level
        prior = level
    return levels


def mark_infrequent(rows: Sequence[Sequence[str]],
                    frequent_items: Iterable[str], marker: str = "*",
                    skip_field_count: int = 1) -> List[List[str]]:
    """Map-only masking: every item field not in the frequent level-1 set
    becomes ``marker``."""
    freq = set(frequent_items)
    out = []
    for row in rows:
        row = list(row)
        for i in range(skip_field_count, len(row)):
            if row[i] not in freq:
                row[i] = marker
        out.append(row)
    return out
