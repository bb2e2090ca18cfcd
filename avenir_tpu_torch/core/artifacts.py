"""Durable artifacts: every model/iteration state is a file, as in the reference.

The reference's checkpoint/resume story is structural (SURVEY.md §5): each
iteration writes a durable HDFS artifact (decision-path JSON per tree level,
LR coefficient history, k-means centroid files, bandit model state) and any job
can resume from its last artifact.  This module keeps that contract on a local
or shared filesystem:

  * text outputs are written Hadoop-style as ``<dir>/part-r-00000`` so driver
    scripts that expect that layout keep working
    (cf. resource/cust_churn_bayesian_prediction.txt:60 model path)
  * JSON artifacts (registry ``meta.json``) are written by ``write_json``
    with the JAX package's formatting (``json.dump``, indent 2), so the
    bytes match
  * an ``ArtifactStore`` wraps a base directory with namespaced read/write
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Iterable, List, Optional

from .faults import with_retry


def write_text_output(dir_path: str, lines: Iterable[str],
                      part: Optional[int] = None, role: str = "r",
                      local_shard: Optional[bool] = None) -> str:
    """Write lines as ``<dir>/part-{role}-{part:05d}`` (Hadoop output layout:
    role "m" for the map-only predictor jobs, "r" for reducer artifacts).

    ``local_shard=True`` marks per-record output over this process's own
    input (prediction lines): in a joined multi-process run the part
    number defaults to the process index, so each process writes its own
    part file, the one-part-a-task layout.  Unset, map outputs (role "m")
    are local and reducer artifacts (role "r": global results every
    process computes alike) keep part 0."""
    if part is None:
        if local_shard is None:
            local_shard = role == "m"
        part = 0
        if local_shard:
            from ..parallel.distributed import process_index
            part = process_index()
    os.makedirs(dir_path, exist_ok=True)
    path = os.path.join(dir_path, f"part-{role}-{part:05d}")
    # materialize once so a retried write re-emits identical content even
    # when the caller passed a one-shot generator
    lines = list(lines)

    def write():
        with open(path, "w") as fh:
            for line in lines:
                fh.write(line)
                fh.write("\n")
    with_retry(write, what=f"artifact write {path}")
    return path


def read_text_input(path: str) -> List[str]:
    """Read lines from a file, or from every ``part-*`` file of a directory
    (Hadoop input semantics: a job input path may be a dir of part files)."""
    paths: List[str]
    if os.path.isdir(path):
        paths = sorted(glob.glob(os.path.join(path, "part-*")))
        if not paths:
            paths = sorted(p for p in glob.glob(os.path.join(path, "*"))
                           if os.path.isfile(p) and not os.path.basename(p).startswith(("_", ".")))
    else:
        paths = [path]
    lines: List[str] = []
    for p in paths:
        with open(p, "r") as fh:
            for line in fh.read().splitlines():
                if line:
                    lines.append(line)
    return lines


def write_json(path: str, obj: Any) -> str:
    """``json.dump(obj, indent=2)`` to ``path`` (parents created), retried
    on transient faults."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)

    def write():
        with open(path, "w") as fh:
            json.dump(obj, fh, indent=2)
    with_retry(write, what=f"artifact write {path}")
    return path


def read_json(path: str) -> Any:
    with open(path, "r") as fh:
        return json.load(fh)


class ArtifactStore:
    """Namespaced artifact directory: the replacement for the HDFS paths wired
    through the reference's shell scripts (resource/detr.sh:35-41 rotation)."""

    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        os.makedirs(base_dir, exist_ok=True)

    def path(self, *parts: str) -> str:
        return os.path.join(self.base_dir, *parts)

    def write_lines(self, name: str, lines: Iterable[str]) -> str:
        return write_text_output(self.path(name), lines)

    def read_lines(self, name: str) -> List[str]:
        return read_text_input(self.path(name))

    def write_json(self, name: str, obj: Any) -> str:
        return write_json(self.path(name), obj)

    def read_json(self, name: str) -> Any:
        return read_json(self.path(name))

    def exists(self, name: str) -> bool:
        return os.path.exists(self.path(name))

    def rotate(self, src: str, dst: str) -> None:
        """Move an output artifact into the input slot for the next iteration
        (detr.sh 'mvDecFiles': decPathOut -> decPathIn)."""
        os.replace(self.path(src), self.path(dst))
