"""Where the level histogram's mma form spends its time on the card.

Builds copies of ``csrc/histogram.cu`` with one part of the mma kernel cut
out, times each on the card alone (calls queued behind a spin kernel) at
the rafo level, its root and the bench level, and prints one JSON line.
A cut-out kernel gives wrong counts: only its time is used.  Run from the
root of a checkout on a machine with a GPU and ``nvcc``::

    python3 -m avenir_tpu_torch.kernels.b1_knockouts

The cuts (each a text substitution that must apply, so the tool fails
loudly when the kernel's source changes):

- ``full``: the kernel as built for the port;
- ``no_mma``: no k-step loop (no fragment loads, no mma);
- ``loads_only`` / ``mma_only``: the fragment loads without the mma, the
  mma on unloaded registers;
- ``no_scatter``: the operands stay zero (no A or Bm scatter);
- ``base``: neither scatter nor k-step loop (staging, zeroing, barriers,
  partial sums);
- ``no_zero`` / ``no_stage``: no operand zeroing / no row staging.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from . import build, histogram

_KSTEP = "for (int ks = 0; ks < ksteps; ++ks) {"
_SCATTER_A = "for (int j = threadIdx.x; j < rows * T; j += kMmaThreads) {"
_SCATTER_B = "for (int j = threadIdx.x; j < rows * S; j += kMmaThreads) {"
_MMA = "          if (m_ok[u] && n_ok[v]) {\n            mma_u8("
_LOAD_A = "        if (m_ok[u]) {\n          ldmatrix_x4("
_LOAD_B = "        if (n_ok[2 * v2]) {\n          ldmatrix_x4("


def _never(loop: str) -> tuple:
    return loop, loop.replace("< ksteps", "< 0").replace(
        "< rows * T", "< 0").replace("< rows * S", "< 0")


CUTS = {
    "full": [],
    "no_mma": [_never(_KSTEP)],
    "loads_only": [(_MMA, _MMA.replace("n_ok[v])", "n_ok[v] && ks < 0)"))],
    "mma_only": [(_LOAD_A, _LOAD_A.replace("m_ok[u])", "m_ok[u] && ks < 0)")),
                 (_LOAD_B, _LOAD_B.replace("v2])", "v2] && ks < 0)"))],
    "no_scatter": [_never(_SCATTER_A), _never(_SCATTER_B)],
    "base": [_never(_KSTEP), _never(_SCATTER_A), _never(_SCATTER_B)],
    "no_zero": [("    zero_ops(ops[p ^ 1]);", "")],
    "no_stage": [("    if (tile < tiles) {\n      const long long r0",
                  "    if (false) {\n      const long long r0")],
}

SHAPES = {"rafo": ((9, 8, 19, 2, 2), 1_000_000),
          "rafo_root": ((9, 1, 19, 2, 2), 1_000_000),
          "bench": ((16, 8, 19, 2, 2), 8_000_000)}


def _build() -> dict:
    """One library a cut, built together; returns cut -> its entry."""
    src = (build.CSRC_DIR / "histogram.cu").read_text()
    out_dir = build.BUILD_DIR / "b1_knockouts"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.nvcc_path()
    procs = {}
    for name, subs in CUTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"cut {name!r} no longer applies to "
                                   f"csrc/histogram.cu: {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"cut {name!r} does not build:\n{log}")
        fn = ctypes.CDLL(str(so)).avenir_forest_level_counts_mma
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, ll, i, i, i, i, i, i, i, i, i, ll, p, i,
                       p, p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def _device_ms(fn, reps: int = 20) -> float:
    """Median ms of one call on the card alone (as chip_smoke.py times)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        torch.cuda._sleep(40_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("b1_knockouts: needs a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    entries = _build()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = sms * histogram.MMA_BLOCKS_PER_SM
    rng = np.random.default_rng(7)
    result = {"device": torch.cuda.get_device_name(0)}
    for label, (shape, n) in SHAPES.items():
        T, N, S, B, C = shape
        plan = histogram.mma_plan(*shape)
        nid, br, cls, w = (torch.from_numpy(a).to(dev) for a in (
            rng.integers(0, N, (n, T), dtype=np.int32),
            rng.integers(0, B, (n, S), dtype=np.int32),
            rng.integers(0, C, (n,), dtype=np.int32),
            rng.integers(0, 3, (n, T)).astype(np.uint8)))
        partial = torch.empty((blocks, T * N * S * B * C), dtype=torch.int32,
                              device=dev)
        out = torch.empty((T, N, S, B, C), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call(fn):
            err = fn(nid.data_ptr(), br.data_ptr(), cls.data_ptr(),
                     w.data_ptr(), n, T, N, S, B, C, plan.slab_tiles,
                     plan.slabs, plan.wn, plan.shape, plan.smem_bytes,
                     partial.data_ptr(), blocks, out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        call(entries["full"])
        if not torch.equal(out, histogram.forest_level_counts_torch(
                nid, br, cls, w, N, B, C)):
            raise RuntimeError(f"the full kernel is not exact at {shape}")
        result[label] = {name: _device_ms(lambda fn=fn: call(fn))
                         for name, fn in entries.items()}
        result[label]["shape"] = shape
        result[label]["rows"] = n
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
