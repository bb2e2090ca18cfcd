"""Plain exact KNN over e-learning records, for the benchmark's check.

avenir's distance between two records of numeric features (chombo's
``InterRecordDistance``, euclidean): each feature's difference divided by
the field's range ``max - min``, the root of the mean of their squares,
times ``sts.distance.scale``, floored to an integer.  A test row's
neighbours are the ``k`` train rows of least distance, ties to the lower
train index; its class is the most frequent class among them (no kernel
function, no weighting), ties to the first class in sorted order.

The distances are computed in ``dtype``: float64 here, bfloat16 for the
control.  Torch on any device, in blocks of test rows.  It imports nothing
of the program.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


# what every number of a broken list reads: farther than any list can lie,
# and finite, so the result line stays plain JSON
FAR = 1e9


def distances(test: torch.Tensor, train: torch.Tensor, ranges: Sequence[float],
              scale: int, dtype=torch.float64) -> torch.Tensor:
    """(nt, nr) floored scaled distances (int64) of raw feature rows."""
    r = torch.as_tensor(ranges, dtype=dtype, device=test.device)
    t = test.to(dtype) / r
    x = train.to(dtype) / r
    sq = torch.zeros((t.shape[0], x.shape[0]), dtype=dtype,
                     device=test.device)
    for f in range(t.shape[1]):
        d = t[:, f, None] - x[None, :, f]
        sq = sq + d * d
    mean = sq / t.shape[1]
    return torch.floor(torch.sqrt(mean) * scale).to(torch.int64)


def nearest(test: torch.Tensor, train: torch.Tensor, ranges, scale: int,
            k: int, block: int = 512, dtype=torch.float64
            ) -> Tuple[np.ndarray, np.ndarray]:
    """(distances, indices) (nt, k) of each test row's nearest train rows,
    nearest first, ties to the lower index."""
    nr = train.shape[0]
    ds, ix = [], []
    idx = torch.arange(nr, device=test.device)
    for s in range(0, test.shape[0], block):
        d = distances(test[s:s + block], train, ranges, scale, dtype)
        key = d * nr + idx[None, :]
        top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
        ds.append((top // nr).cpu().numpy())
        ix.append((top % nr).cpu().numpy())
    return np.concatenate(ds), np.concatenate(ix)


def vote(neighbor_classes: np.ndarray, n_classes: int) -> np.ndarray:
    """(nt,) the most frequent class code among each row's neighbours."""
    counts = np.zeros((neighbor_classes.shape[0], n_classes), np.int64)
    for j in range(neighbor_classes.shape[1]):
        counts[np.arange(len(counts)), neighbor_classes[:, j]] += 1
    return np.argmax(counts, axis=1)


def judge(test: torch.Tensor, train: torch.Tensor, train_cls: np.ndarray,
          ranges, scale: int, k: int, got_d: np.ndarray, got_i: np.ndarray,
          got_cls: np.ndarray, n_classes: int, block: int = 512) -> dict:
    """How far one batch's lists and classes lie from the exact answer,
    with ``k`` the configuration's count of neighbours:

    * ``dist_gap``: the widest gap between a listed distance and the exact
      distance of the listed train row;
    * ``rank_gap``: the widest amount by which a row's farthest listed
      neighbour lies beyond its exact k-th nearest distance;
    * ``beyond_kth_pct``: the share (%) of listed neighbours whose exact
      distance lies beyond their row's exact k-th nearest distance: a
      count that a scan over part of the train rows raises everywhere,
      where the two widest gaps above read single rows;
    * ``class_mismatch``: rows whose class is not the vote of the listed
      neighbours' classes.

    A list other than (batch rows, ``k``), with a row out of range or a
    repeated row, reads :data:`FAR` on every number."""
    nt, nr = test.shape[0], train.shape[0]
    k = min(k, nr)
    bad = dict.fromkeys(("dist_gap", "rank_gap", "beyond_kth_pct",
                         "class_mismatch"), FAR)
    if got_d.shape != (nt, k) or got_i.shape != (nt, k) \
            or len(got_cls) != nt:
        return bad
    if (got_i < 0).any() or (got_i >= nr).any() or (
            np.sort(got_i, axis=1)[:, 1:] == np.sort(got_i, axis=1)[:, :-1]
    ).any():
        return bad
    dist_gap = rank_gap = beyond = 0
    for s in range(0, nt, block):
        d = distances(test[s:s + block], train, ranges, scale)
        gi = torch.as_tensor(got_i[s:s + block], device=d.device).long()
        exact_listed = d.gather(1, gi).cpu().numpy()
        kth = torch.kthvalue(d, k, dim=1).values.cpu().numpy()
        dist_gap = max(dist_gap, int(np.abs(exact_listed
                                            - got_d[s:s + block]).max()))
        over = exact_listed - kth[:, None]
        rank_gap = max(rank_gap, int(over.max()))
        beyond += int((over > 0).sum())
    want = vote(train_cls[got_i], n_classes)
    return {"dist_gap": float(dist_gap), "rank_gap": float(rank_gap),
            "beyond_kth_pct": 100.0 * beyond / (nt * k),
            "class_mismatch": float((want != got_cls).sum())}
