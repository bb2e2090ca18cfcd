#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``avenir_tpu_torch``) on one
NVIDIA GPU.  Run from the root of a checkout:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``avenir_tpu``; the JAX
package's outputs it is held against are committed fixtures.  Phases, in
order — any failure exits non-zero before the result line:

  1. device   require torch.cuda.is_available(); print the card's name and
              power limit (nvidia-smi)
  2. build    build every CUDA kernel from csrc/ (one nvcc per source, all
              started together) into build/avenir_tpu_torch/
  3. kernel   the ensemble-vote kernel against its plain PyTorch version on
              the card: random stacked forests (NaNs, negative and
              out-of-range codes, negative integer weights, ties, min_odds
              1.0 and 1.5) at the published forest's shape (T=9, P=17, F=4,
              C=4, K=3) and a wide one whose predicates do not fit in shared
              memory (T=64, P=257, F=16, C=16, K=8), each at n = 1, 7, 513
              and 1,000,000 rows; the int32 votes must be EXACTLY equal
  4. golden   the port's modelPredictor CLI over the golden rf forest
              (tests/golden/fixtures/rf) must reproduce its pred.csv byte for
              byte
  5. rafo9    the port's modelPredictor over the 9-tree fixture
              (tests/torch_fixtures/rafo9) and its predictionService
              (in-process) over a copy of the fixture's registry must
              reproduce pred.csv and served.csv byte for byte.  Phases 4-5
              are the main path: launch counts are zeroed before them and
              read after; the vote kernel must have launched and the ledger
              must show ensemble.vote.cuda and never the torch or host vote
  6. times    median CUDA-event times of the kernel and its plain version on
              the rafo9 forest over its requests tiled to 1,000,000 rows (the
              reported numbers), then on random inputs at the published and
              the wide shape; and the bound: the larger of the bytes moved
              over 3.35 TB/s and the predicate tests the kernel's scan runs
              on this data over 33.5 T tests/s (one per float32 lane per
              clock).  No single PyTorch call computes the vote, so
              library_ms is null

The line before the last is one JSON object with the kernel numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
RES = os.path.join(ROOT, "resource")
RF_GOLDEN = os.path.join(ROOT, "tests", "golden", "fixtures", "rf")
RAFO9 = os.path.join(ROOT, "tests", "torch_fixtures", "rafo9")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
# H100 SXM float32 outside the tensor cores is 67 TFLOP/s counting a fused
# multiply-add as two operations; a compare is one instruction, issued at
# most at the FMA instruction rate
TESTS_PER_S = 67e12 / 2
RAFO_SHAPE = (9, 17, 4, 4, 3)    # T, P, F, C, K
WIDE_SHAPE = (64, 257, 16, 16, 8)
ROW_COUNTS = (1, 7, 513, 1_000_000)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name):
    print(f"== {name}", flush=True)


def random_forest_inputs(rng, shape, n):
    """A random stacked forest in EnsembleModel.stacked_host's layout plus
    n request rows.  Each tree has some real paths, the always-match
    sentinel and never-match pad paths; about 1.5 features a path are
    restricted so that real paths do match."""
    T, P, F, C, K = shape
    p_restrict = min(1.0, 1.5 / F)
    lo = rng.integers(-6, 6, (T, P, F)).astype(np.float32)
    hi = lo + rng.integers(0, 8, (T, P, F)).astype(np.float32)
    lo[rng.random((T, P, F)) < 0.1] = -np.inf
    hi[rng.random((T, P, F)) < 0.1] = np.inf
    num_r = rng.random((T, P, F)) < p_restrict
    cat_m = rng.random((T, P, F, C)) < 0.6
    cat_r = rng.random((T, P, F)) < p_restrict
    cls_oh = np.zeros((T, P, K), np.float32)
    cls_oh[np.arange(T)[:, None], np.arange(P)[None, :],
           rng.integers(0, K, (T, P))] = 1.0
    for t in range(T):
        real = int(rng.integers(1, P))          # sentinel at index `real`
        lo[t, real], hi[t, real] = -np.inf, np.inf
        num_r[t, real] = cat_r[t, real] = False
        lo[t, real + 1:], hi[t, real + 1:] = np.inf, -np.inf
        num_r[t, real + 1:], cat_r[t, real + 1:] = True, False
        cls_oh[t, real + 1:] = 0.0
    wvec = rng.integers(-3, 6, T).astype(np.float32)
    vals = rng.integers(-8, 14, (n, F)).astype(np.float32)
    vals[rng.random((n, F)) < 0.05] = np.nan
    codes = rng.integers(-2, C + 3, (n, F)).astype(np.int32)
    return (lo, hi, num_r, cat_m, cat_r, cls_oh, wvec), vals, codes


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed runs
    (after one warm-up run)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def predicate_tests(v, c, model):
    """Predicate tests the kernel's scan runs on these rows (csrc/vote.cu):
    in each tree every path up to the first that matches (all P when none
    does); in each such path every slot up to the first that fails; in
    each such slot 2 compares where the numeric flag is set, and 1 test
    where the categorical flag is set and the numeric test passed."""
    import torch
    lo, hi, num_r, cat_m, cat_r = model.stacked()[:5]
    T, P, F, C, _ = model.shape
    by_code = cat_m.permute(2, 3, 0, 1)                  # (F, C, T, P)
    feat = torch.arange(F, device=v.device)
    paths = torch.arange(P, device=v.device)
    num_tests = 2 * num_r.to(torch.int32)
    step = max(1, (1 << 26) // (T * P * F))
    total = 0
    for s in range(0, v.shape[0], step):
        x = v[s:s + step, None, None, :]
        cc = c[s:s + step]
        num_pass = ((x > lo) & (x <= hi)) | ~num_r      # (n, T, P, F)
        mask = by_code[feat[None, :], cc.clamp(0, C - 1).long()]
        cat_pass = (mask.permute(0, 2, 3, 1)
                    & (cc >= 0)[:, None, None, :]) | ~cat_r
        fail = ~(num_pass & cat_pass)
        first_fail = torch.where(fail.any(3), fail.to(torch.uint8).argmax(3),
                                 F)                      # F: path matched
        ran = feat <= first_fail[..., None]
        tests = ((num_tests + (cat_r & num_pass)) * ran).sum(3)  # (n, T, P)
        matched = first_fail == F
        first = torch.where(matched.any(2),
                            matched.to(torch.uint8).argmax(2), P - 1)
        total += int((tests * (paths <= first[..., None])).sum().item())
    return total


def time_vote(model, vals, codes, plain):
    """Kernel (and, with ``plain``, plain-version) median ms on host arrays
    uploaded to the card, in turns kernel, plain, kernel; and the bound:
    each input read once and the output written once at the HBM rate, or
    the predicate tests this data makes the scan run at the test rate —
    the larger of the two."""
    import torch
    from avenir_tpu_torch.kernels import vote
    dev = model.device
    v = torch.from_numpy(np.ascontiguousarray(vals, np.float32)).to(dev)
    c = torch.from_numpy(np.ascontiguousarray(codes, np.int32)).to(dev)
    n, F = v.shape
    res = {"ms": cuda_ms(lambda: vote.ensemble_vote(v, c, model, 1.5), 50)}
    if plain:
        res["plain_ms"] = cuda_ms(lambda: vote.ensemble_vote_torch(
            v, c, *model.stacked(), 1.5), 10)
        res["ms_again"] = cuda_ms(
            lambda: vote.ensemble_vote(v, c, model, 1.5), 50)
    kernel_form = (model.lo, model.hi, model.flags, model.catw, model.cls,
                   model.wvec)
    nbytes = v.nbytes + c.nbytes + n * 4 + sum(t.nbytes for t in kernel_form)
    tests = predicate_tests(v, c, model)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    tests_ms = tests / TESTS_PER_S * 1e3
    res.update(bound_ms=max(bytes_ms, tests_ms), bytes=nbytes,
               bytes_ms=bytes_ms, tests=tests, tests_ms=tests_ms,
               bound_by="bytes" if bytes_ms >= tests_ms else "operations")
    return res


def serving_layers(path_lists, fs, requests, dev, reps=30):
    """Where one served batch's time goes, per bucket size: host encode
    (prepare_rows), feature build + H2D + kernel launch up to a synchronize
    (dispatch_prepared), label readback (readback_dispatched) on the host
    clock, and the kernel alone on CUDA events."""
    import torch
    from avenir_tpu_torch.kernels import vote
    from avenir_tpu_torch.models.tree import FeatureCache
    from avenir_tpu_torch.serving.predictor import ForestPredictor
    pred = ForestPredictor(path_lists, fs, device=dev).warm()
    with open(requests) as fh:
        lines = fh.read().splitlines()
    out = {}
    for b in pred.buckets:
        rows = [line.split(",") for line in lines[:b]]
        enc, disp, back = [], [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            prepared = pred.prepare_rows(rows)
            t1 = time.perf_counter()
            staged = pred.dispatch_prepared(prepared)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            pred.readback_dispatched(staged)
            t3 = time.perf_counter()
            enc.append(t1 - t0)
            disp.append(t2 - t1)
            back.append(t3 - t2)
        table = prepared[0][0]
        d_vals, d_codes = pred.ensemble.device_inputs(table, FeatureCache())
        kernel = cuda_ms(lambda: vote.ensemble_vote(
            d_vals, d_codes, pred.ensemble._stacked, 1.0), reps)
        out[b] = {k: round(float(np.median(v)) * 1e3, 4) for k, v in
                  (("encode", enc), ("dispatch", disp), ("readback", back))}
        out[b]["kernel"] = round(kernel, 4)
    return out


def run_cli(args):
    from avenir_tpu_torch.cli import run as cli_run
    rc = cli_run.main(args)
    if rc != 0:
        fail(f"cli run {args[0]} returned {rc}")


def same_bytes(got, want, what):
    with open(got, "rb") as a, open(want, "rb") as b:
        if a.read() != b.read():
            fail(f"{what}: {got} differs from {want}")
    print(f"{what}: byte-identical to {os.path.relpath(want, ROOT)}",
          flush=True)


def main():
    import torch
    phase("1 device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    try:
        from avenir_tpu_torch.kernels import build, vote
        from avenir_tpu_torch.utils.tracing import transfer_ledger
    except ImportError as exc:
        fail(f"cannot import the port ({exc}); run from a checkout's root")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else f"nvidia-smi unavailable (rc {smi.returncode})"
    print(card, flush=True)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    phase("2 build")
    secs = build.build_all()
    for name, s in secs.items():
        print(f"built {build.SOURCES[name]} in {s:.1f} s", flush=True)
        log = build.build_log.get(name, (0, ""))[1].strip()
        if log:
            print(log, flush=True)

    phase("3 kernel vs plain version")
    rng = np.random.default_rng(20261016)
    max_err = 0
    for shape in (RAFO_SHAPE, WIDE_SHAPE):
        for n in ROW_COUNTS:
            stacked, vals, codes = random_forest_inputs(rng, shape, n)
            model = vote.prepare_vote_model(*stacked, dev)
            d_vals = torch.from_numpy(vals).to(dev)
            d_codes = torch.from_numpy(codes).to(dev)
            for min_odds in (1.0, 1.5):
                got = vote.ensemble_vote(d_vals, d_codes, model, min_odds)
                want = vote.ensemble_vote_torch(d_vals, d_codes,
                                                *model.stacked(), min_odds)
                torch.cuda.synchronize()
                if got.shape != (n,) or got.dtype != torch.int32:
                    fail(f"kernel output {tuple(got.shape)} {got.dtype}")
                err = int((got.long() - want.long()).abs().max().item()) \
                    if n else 0
                max_err = max(max_err, err)
                if err:
                    bad = int((got != want).sum().item())
                    fail(f"kernel != plain version at shape {shape}, n={n}, "
                         f"min_odds={min_odds}: {bad} rows differ")
            print(f"shape T,P,F,C,K={shape} n={n}: exact "
                  f"(smem={model.smem_bytes() <= vote.SMEM_LIMIT}, "
                  f"vetoes={int((got == shape[4]).sum().item())})",
                  flush=True)

    # ---- the main path: counts zeroed just before, read just after ----
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    props = os.path.join(RES, "rafo.properties")
    schema = os.path.join(RES, "call_hangup.json")
    vote.launches = 0
    with transfer_ledger() as ledger:
        phase("4 golden rf fixture")
        sys.path.insert(0, RES)
        from gen.call_hangup_gen import generate
        train = os.path.join(WORK, "rf_train.csv")
        with open(train, "w") as fh:
            fh.write("\n".join(generate(400, 13)))
        run_cli(["org.avenir.model.ModelPredictor", f"-Dconf.path={props}",
                 f"-Dmop.model.dir.path={RF_GOLDEN}",
                 f"-Dmop.feature.schema.file.path={schema}",
                 train, os.path.join(WORK, "rf_pred")])
        same_bytes(os.path.join(WORK, "rf_pred", "part-m-00000"),
                   os.path.join(RF_GOLDEN, "pred.csv"), "golden rf")

        phase("5 rafo9 fixture")
        requests = os.path.join(RAFO9, "requests.csv")
        run_cli(["org.avenir.model.ModelPredictor", f"-Dconf.path={props}",
                 f"-Dmop.model.dir.path={RAFO9}",
                 f"-Dmop.feature.schema.file.path={schema}",
                 requests, os.path.join(WORK, "rafo9_pred")])
        same_bytes(os.path.join(WORK, "rafo9_pred", "part-m-00000"),
                   os.path.join(RAFO9, "pred.csv"), "rafo9 modelPredictor")
        registry = os.path.join(WORK, "registry")
        shutil.copytree(os.path.join(RAFO9, "registry"), registry)
        served = os.path.join(WORK, "rafo9_served")
        t0 = time.perf_counter()
        run_cli(["org.avenir.serving.PredictionService",
                 f"-Dconf.path={props}", f"-Dps.model.registry.dir={registry}",
                 "-Dps.model.name=rafo9", "-Dps.transport=inprocess",
                 requests, served])
        serve_s = time.perf_counter() - t0
        same_bytes(os.path.join(served, "part-m-00000"),
                   os.path.join(RAFO9, "served.csv"), "rafo9 predictionService")
    launches = vote.launches
    backends = ledger.backend_snapshot()
    print(f"main path: ensemble_vote launches={launches}; "
          f"KernelBackends={backends}", flush=True)
    with open(served + ".counters.json") as fh:
        sc = json.load(fh)
    print(f"predictionService: {sc['Serving']['Requests']} requests in "
          f"{sc['Serving']['Batches']} batches, "
          f"{sc['Dispatches']['ensemble.vote']} vote launches "
          f"(incl. one warm-up batch per bucket), wall {serve_s:.2f} s, "
          f"serve.request p50/p99 {sc['Serving']['serve.request.p50Us']}/"
          f"{sc['Serving']['serve.request.p99Us']} us", flush=True)
    if launches <= 0:
        fail("the main path never launched the ensemble-vote kernel")
    if not backends.get("ensemble.vote.cuda"):
        fail("ledger shows no ensemble.vote.cuda")
    wrong = [k for k in backends if k.endswith((".torch", ".host"))]
    if wrong:
        fail(f"ledger shows non-kernel vote forms on the main path: {wrong}")

    phase("6 times")
    # the published forest (rafo9) over its fixture requests tiled to 1M rows
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.core.table import load_csv
    from avenir_tpu_torch.models.forest import EnsembleModel
    from avenir_tpu_torch.models.tree import DecisionTreeModel
    from avenir_tpu_torch.weights import load_model_dir
    fs = FeatureSchema.load(schema)
    ens = EnsembleModel([DecisionTreeModel(pl, fs, device=dev)
                         for pl in load_model_dir(RAFO9)], device=dev)
    vals, codes = ens.models[0].matrix.feature_arrays(load_csv(requests, fs))
    n = 1_000_000
    reps = -(-n // len(vals))
    rafo9 = time_vote(ens._stacked, np.tile(vals, (reps, 1))[:n],
                      np.tile(codes, (reps, 1))[:n], plain=True)
    print(f"rafo9 forest {ens._stacked.shape} (T,P,F,C,K), n={n}: {rafo9}",
          flush=True)
    stacked, vals_r, codes_r = random_forest_inputs(rng, RAFO_SHAPE, n)
    rnd = time_vote(vote.prepare_vote_model(*stacked, dev), vals_r, codes_r,
                    plain=True)
    print(f"random inputs at shape {RAFO_SHAPE}, n={n}: {rnd}", flush=True)
    stacked, vals_w, codes_w = random_forest_inputs(rng, WIDE_SHAPE, n)
    wide = time_vote(vote.prepare_vote_model(*stacked, dev), vals_w, codes_w,
                     plain=False)
    print(f"random inputs at wide shape {WIDE_SHAPE}, n={n} (predicates "
          f"from global memory): {wide}", flush=True)
    print("no single PyTorch call computes the vote: library_ms is null",
          flush=True)
    for b, layers in serving_layers(load_model_dir(RAFO9), fs, requests,
                                    dev).items():
        print(f"served batch of {b} rows (rafo9), median ms per layer: "
              f"{layers}", flush=True)

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "ensemble_vote", "route": "cuda",
        "source": "avenir_tpu_torch/csrc/vote.cu",
        "replaces": "avenir_tpu/ops/pallas/vote.py:119",
        "launches": launches, "max_abs_err": max_err,
        "ms": rafo9["ms"], "plain_ms": rafo9["plain_ms"],
        "bound_ms": rafo9["bound_ms"], "bound_by": rafo9["bound_by"],
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
