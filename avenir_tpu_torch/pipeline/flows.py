"""Fused flows on the chunk pipeline: port of ``avenir_tpu/pipeline/flows.py``.

:class:`PredictDriftFlow` is ``predictDriftScore``'s fused window: one
chunk runs the whole ensemble vote (kernel B2, ``kernels/vote.py``
``ensemble_vote``) and the drift window's bin counts (kernel B4,
``kernels/histogram.py`` ``bin_counts``), with the predicted classes
spliced into the monitor's class row on the device.  The unfused pair
pays a predictor encode, a host label decode and re-encode, and the
absorb's own upload a window.  Outputs a window: the vote vector
(decoded to labels on the host for the prediction part file) and the
(R, B) window counts, which the caller's
:class:`~avenir_tpu_torch.monitor.accumulator.StreamDriftMonitor` scores
through ``close_counts``, the unfused job's scoring, decay and policy
path, so the files are the same bytes either way.

The JAX flow calls the plain bodies (``forest._ensemble_vote_body``,
``ops.histogram.feature_bin_counts``), which XLA fuses into one program;
B2 and B4 are the Hopper counterparts of exactly those functions.  So on
the card the stages launch the two kernels, and on the CPU they take the
plain versions (``ensemble_vote_torch``, ``bin_counts_torch``); a kernel
that fails to build or launch raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels.dispatch import note_backend, resolve_backend
from ..kernels.histogram import bin_counts
from ..kernels.vote import ensemble_vote
from ..utils.tracing import fetch
from .cache import schema_fingerprint
from .compiler import ChunkPipeline, Stage


def _vote_stage(model, min_odds: float) -> Stage:
    """The ensemble vote as a pipeline stage over the ensemble's resident
    :class:`~avenir_tpu_torch.kernels.vote.VoteModel` (its shape tags the
    stage's key, as the JAX stage's constant arguments do)."""
    def kernel(carry, consts, inputs, upstream):
        note_backend("ensemble.vote", resolve_backend(inputs["vals"].device))
        return carry, {"votes": ensemble_vote(inputs["vals"], inputs["codes"],
                                              model, min_odds)}

    return Stage(name="predict", kernel=kernel,
                 version="1:" + "x".join(str(d) for d in model.shape),
                 returns=("votes",))


def _absorb_stage(lut: np.ndarray, class_col: np.ndarray,
                  b_max: int) -> Stage:
    """The monitor stage: splice the upstream votes into the class row of
    the host-encoded monitor codes (vote index -> class-row bin through
    the LUT, the device twin of ``Baseline.class_codes_for_labels``),
    then count every row's bins under the window's mask."""
    def kernel(carry, consts, inputs, upstream):
        vote_lut = consts["vote_lut"]
        votes = upstream["predict.votes"]
        cls_bin = vote_lut[votes.clamp(0, vote_lut.shape[0] - 1).long()]
        codes = torch.where(consts["class_col"][None, :], cls_bin[:, None],
                            inputs["mon_codes"]).contiguous()
        note_backend("monitor.absorb", resolve_backend(codes.device))
        return carry, {"counts": bin_counts(codes, b_max, inputs["mask"])}

    return Stage(name="monitor", kernel=kernel, version=f"1:b{b_max}",
                 consts={"vote_lut": lut, "class_col": class_col},
                 returns=("counts",))


class PredictDriftFlow:
    """Fused (ensemble predict + drift-window absorb) over window-sized
    chunks.

    Eligibility is the batch vote's device gate
    (``EnsembleModel.device_inputs``): the ensemble must stack on one
    device (no degenerate member, float32-exact bounds, integer vote
    weights) and each window's values must round-trip float32.
    ``run_window`` returns None for a window that fails the gate (and for
    an empty or over-long one): the caller takes the unfused pair for that
    window, the reference's own per-window route, with the same bytes.

    Every window pads (masked zero rows) to ``window_rows``, so the whole
    stream, tail window included, runs one chunk key."""

    def __init__(self, ensemble, baseline, schema, window_rows: int,
                 cache=None):
        from ..parallel.mesh import DeviceMesh, MeshContext
        self.ens = ensemble
        self.baseline = baseline
        self.window_rows = int(window_rows)
        self.eligible = ensemble._stacked is not None \
            and ensemble._sharded is None
        self.pl: Optional[ChunkPipeline] = None
        if not self.eligible:
            return
        # vote index -> class-row bin through the shared label encoding;
        # the trailing entry is the min-odds veto (None on the wire),
        # which the shared mapping sends to the unknown bin
        lut = baseline.class_codes_for_labels(list(ensemble.classes)
                                              + [None])
        class_col = np.zeros((len(baseline.specs),), dtype=bool)
        class_col[baseline.class_row] = True
        self.pl = ChunkPipeline(
            [_vote_stage(ensemble._stacked, ensemble.min_odds_ratio),
             _absorb_stage(lut, class_col, int(baseline.n_bins_max))],
            ctx=MeshContext(DeviceMesh([ensemble.device])),
            schema_fp=schema_fingerprint(schema), cache=cache,
            name="predict-drift")

    def run_window(self, table
                   ) -> Optional[Tuple[List[Optional[str]], np.ndarray]]:
        """One fused window: (decoded labels, float64 (R, B) window
        counts), or None when this window is not device-eligible.  The
        counts are exact integers, the unfused accumulator's."""
        if self.pl is None or table.n_rows == 0 \
                or table.n_rows > self.window_rows:
            return None
        from ..monitor.baseline import (encode_monitor_codes,
                                        resolve_spec_bounds)
        m0 = self.ens.models[0].matrix
        vals, codes = m0.feature_arrays(table)
        if not m0._f32_safe(vals):
            return None
        n = table.n_rows
        pad = self.window_rows - n
        resolve_spec_bounds(self.baseline.specs, table)
        mon = encode_monitor_codes(table, self.baseline.specs)
        mask = np.zeros((self.window_rows,), dtype=bool)
        mask[:n] = True
        host = {"vals": _pad_rows(vals.astype(np.float32), pad),
                "codes": _pad_rows(codes, pad),
                "mon_codes": _pad_rows(mon, pad), "mask": mask}
        with self.pl.staged(host) as inputs:
            outs = self.pl.run_chunk(inputs)
        votes = fetch(outs["predict.votes"][:n])
        counts = fetch(outs["monitor.counts"]).astype(np.float64)
        return list(self.ens._lut[votes]), counts

    def export(self, counters) -> None:
        if self.pl is not None:
            self.pl.export(counters)

    def run_stats(self) -> Dict[str, int]:
        return self.pl.run_stats() if self.pl is not None else {}


def _pad_rows(a: np.ndarray, pad: int) -> np.ndarray:
    """Zero-pad along axis 0 (masked downstream)."""
    if pad <= 0:
        return a
    return np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
