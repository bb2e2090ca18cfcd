"""Step-indexed checkpoint/resume for iterative jobs (the port's copy of
``avenir_tpu/core/checkpoint.py``; the streamed forest ingest is its user).

The reference's checkpointing is structural: every iteration writes a
durable artifact and a job resumes from the last one.  This manager gives
the iterative drivers one uniform version of that contract: numbered step
directories holding an npz of array state plus a JSON sidecar for
metadata, atomic via write-then-rename, with retention and latest-step
discovery.

Crash safety: ``save`` is atomic (tmp dir + rename), and discovery is
corruption-tolerant — a step dir whose ``state.npz`` or ``meta.json`` is
missing or unreadable (torn write, disk fault) is never selected as
latest; ``latest_step``/``restore`` fall back to the newest INTACT step
with a warning, so a fault at checkpoint time costs at most one step of
progress, never the whole resume.  The on-disk layout is the JAX
package's, so a checkpoint either package wrote resumes in the other.
"""

from __future__ import annotations

import json
import os
import shutil
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .faults import fault_point


class CheckpointManager:
    def __init__(self, base_dir: str, keep: int = 3):
        """keep: retain at most this many newest steps (0 = keep all)."""
        self.base_dir = base_dir
        self.keep = keep
        os.makedirs(base_dir, exist_ok=True)

    # ---- paths ----
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.base_dir, f"step_{step:08d}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.base_dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _read_step(self, step: int
                   ) -> Tuple[int, Dict[str, np.ndarray], Dict[str, Any]]:
        """Fully read one step (arrays decompressed — a corrupt member
        fails here, not later mid-restore)."""
        d = self._step_dir(step)
        with np.load(os.path.join(d, "state.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(d, "meta.json")) as fh:
            meta = json.load(fh)
        return step, arrays, meta

    def is_intact(self, step: int) -> bool:
        """True when the step's state.npz AND meta.json open and parse — a
        header-level probe (npz zip directory + JSON), NOT a full array
        decompress, so the common latest_step-then-restore(step) pattern
        reads the state once, not twice.  Torn writes corrupt the zip
        directory (it trails the file) and fail here; the pathological
        valid-directory/corrupt-member case still raises at restore."""
        d = self._step_dir(step)
        try:
            with np.load(os.path.join(d, "state.npz")) as z:
                z.files
            with open(os.path.join(d, "meta.json")) as fh:
                json.load(fh)
            return True
        except Exception:
            return False

    def latest_step(self) -> Optional[int]:
        """Newest INTACT step — a torn or corrupt newest dir is skipped
        with a warning instead of being handed to restore."""
        for s in reversed(self.steps()):
            if self.is_intact(s):
                return s
            warnings.warn(
                f"checkpoint step {s} in {self.base_dir!r} is missing or "
                f"unreadable (torn write?); falling back to an older step",
                RuntimeWarning)
        return None

    # ---- save/restore ----
    def save(self, step: int, arrays: Dict[str, np.ndarray],
             meta: Optional[Dict[str, Any]] = None) -> str:
        """Atomically write arrays (+ JSON-serializable meta) as ``step``."""
        fault_point("checkpoint_save", step)
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "state.npz"),
                 **{k: np.asarray(v) for k, v in arrays.items()})
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump(meta or {}, fh)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._retain()
        return final

    def restore(self, step: Optional[int] = None
                ) -> Tuple[int, Dict[str, np.ndarray], Dict[str, Any]]:
        """(step, arrays, meta) for ``step`` or the newest intact step;
        raises FileNotFoundError when nothing (intact) is saved."""
        if step is not None:
            return self._read_step(step)
        candidates = self.steps()
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {self.base_dir!r}")
        last_exc: Optional[Exception] = None
        for s in reversed(candidates):
            try:
                return self._read_step(s)
            except Exception as exc:
                warnings.warn(
                    f"checkpoint step {s} in {self.base_dir!r} failed to "
                    f"restore ({type(exc).__name__}: {exc}); trying the "
                    f"previous step", RuntimeWarning)
                last_exc = exc
        raise FileNotFoundError(
            f"no intact checkpoints in {self.base_dir!r} "
            f"({len(candidates)} corrupt)") from last_exc

    def _retain(self) -> None:
        if self.keep <= 0:
            return
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
