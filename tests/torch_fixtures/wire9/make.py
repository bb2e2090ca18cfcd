"""Make the wire9 fixture with the JAX package, on the CPU: the rafo9 forest
served over the RESP wire, with a delta reload mid-stream, and the bytes of
a durable broker's journal.

  registry/rafo9/v_000001/   the rafo9q fixture's version 1 (the 9-tree
                             rafo9 forest with its baseline and int8
                             quantized sidecars), copied
  registry/rafo9/v_000002/   ModelRegistry.publish_delta of v1 with trees
                             CHANGED replaced by those of a forest trained
                             on call_hangup_gen(5000, 23) with its class
                             labels swapped: the full artifact and its
                             delta.json / delta.npz sidecars
  registry/rafo9/serving.json  ModelRegistry.pin_version(rafo9, 1) (its
                             ``pinned_unix`` is the write time)
  requests.txt               raw wire messages in three segments, each
                             ended by a ``stop`` line: predict lines over
                             ../rafo9/requests.csv records (some with a
                             ``t=`` trace field, sampled and not, some with
                             a ``d=`` deadline field, long past or far
                             ahead), predictq lines (those records binned
                             on v1's int8 grid; one with a trace field),
                             and malformed lines; the second segment is
                             ``reload`` alone
  replies.txt                the reference's replies, in the order they
                             reach the prediction queue, of
                             :func:`wire_flow` with the float model
                             (predictq answers ``error``): v1 (pinned) for
                             the first segment, the pin cleared, then the
                             reload patches v2's delta onto the resident
                             forest for the third
  replies_q.txt              the same with ps.quantized: the int8 vote
                             serves predictq on v1; the reload loads v2 in
                             full (no sidecar: float, predictq ``error``)
  records.csv                300 records of ../rafo9/requests.csv and two
                             malformed ones
  job_replies.csv            predictionService -Dps.transport=resp
                             -Dps.request.ttl.ms=600000 over records.csv
                             from a copy of the registry (pinned: v1)
  counters.json              the flows' Serving and Broker counters and the
                             job's Serving counts
  journal/                   a RespServer(durable="commit") journal after
                             JOURNAL_SCRIPT and a kill: the last rotation
                             checkpoint and the segments after it

:func:`wire_flow` and :func:`run_journal_script` take the package's modules
as arguments, so the port's tests run the same flows over
``avenir_tpu_torch``.  The port (``avenir_tpu_torch``) is held against
these files on the CPU by ``tests/test_torch_wire_serving.py`` and
``tests/test_torch_qjournal.py``.  Regenerate from the repo root (the
tests rerun it into a temporary directory and compare):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/wire9/make.py
"""

import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", "..", ".."))
RES = os.path.join(ROOT, "resource")
RAFO9 = os.path.join(HERE, "..", "rafo9")
RAFO9Q_V1 = os.path.join(HERE, "..", "rafo9q", "registry", "rafo9",
                         "v_000001")

MODEL_NAME = "rafo9"
CHANGED = (1, 3, 5, 7)
MAX_BATCH = 64
# a deadline long past, and one far ahead (epoch microseconds)
PAST_US = 1
FUTURE_US = 99_999_999_999_999_999
TRACE_US = 1_700_000_000_000_000
MALFORMED = (
    "predict,900,K0000900,billing",               # short record
    "predict,901,K0000901,billing,abc,1,0,T",     # non-numeric field
    "bogus,902,x",                                # unknown verb
    "predict",                                    # no id, no record
    "predict,905",                                # no record
    "predictq,903,3,1,2,3,4,5,6",                 # width echo mismatch
    "predictq,904,4,+1,0,0,0,0,0,0,0",            # non-canonical token
)
MALFORMED_RECORDS = ("K0009990,billing,12", "K0009991,billing,x,1,0,T")
JOURNAL_SEGMENT_BYTES = 256
COUNTER_KEYS = {"Serving": ("BadRequests", "Batches", "DeltaSwaps",
                            "DeltaSwapTorn", "HotSwaps", "IsolatedBatches",
                            "Requests", "TracedRequests"),
                "Broker": ("LateShed",)}


def _write(path, text):
    with open(path, "w") as fh:
        fh.write(text)


def request_lines(records, qlines):
    """The three segments of requests.txt (``records``: token rows of
    ../rafo9/requests.csv; ``qlines``: their predictq lines)."""
    seg1, seg3 = [], []
    for i in range(150):
        rec = ",".join(records[i])
        if i % 25 == 5:
            seg1.append(f"predict,{i},t={TRACE_US + i}:{i % 2},{rec}")
        elif i in (70, 71):
            seg1.append(f"predict,{i},d={PAST_US},{rec}")
        elif i in (72, 73):
            seg1.append(f"predict,{i},t={TRACE_US}:1,d={FUTURE_US},{rec}")
        else:
            seg1.append(f"predict,{i},{rec}")
        if i % 10 == 3:
            seg1.append(qlines[i])
    seg1[40:40] = MALFORMED
    tq = qlines[11].split(",")
    seg1.append(",".join(tq[:2] + [f"t={TRACE_US}:1"] + tq[2:]))
    for i in range(150, 300):
        seg3.append(f"predict,{i},{','.join(records[i])}")
        if i % 15 == 0:
            seg3.append(qlines[i])
    return seg1 + ["stop", "reload", "stop"] + seg3 + ["stop"]


def segments(lines):
    seg = []
    for line in lines:
        seg.append(line)
        if line == "stop":
            yield seg
            seg = []


def wire_flow(respq, service, registry, lines, *, quantized=False,
              wire_native="off", lease_s=0.0, server_kw=None):
    """Serve ``lines`` (requests.txt) over ``respq.RespServer`` through one
    ``service.RespPredictionLoop``, one segment at a time: the registry is
    pinned to v1 at the start, the pin is cleared after the first segment.
    Returns (replies in prediction-queue order, the service's counters of
    COUNTER_KEYS, the service)."""
    registry.pin_version(MODEL_NAME, 1)
    svc = service.PredictionService(
        registry=registry, model_name=MODEL_NAME,
        policy=service.BatchPolicy(max_batch=MAX_BATCH),
        quantized=quantized, wire_native=wire_native)
    server = respq.RespServer(**(server_kw or {})).start()
    replies = []
    try:
        feeder = respq.RespClient(port=server.port)
        loop = service.RespPredictionLoop(svc, {
            "redis.server.port": server.port,
            "redis.lease.timeout.s": lease_s})
        for k, seg in enumerate(segments(lines)):
            if k == 1:
                registry.clear_pin(MODEL_NAME)
            feeder.lpush_many("requestQueue", seg)
            loop.stopped = False
            loop.run(max_idle_s=30.0)
            while True:
                v = feeder.rpop("predictionQueue")
                if v is None:
                    break
                replies.append(v)
        loop.close()
        feeder.close()
    finally:
        server.stop()
    c = svc.counters.as_dict()
    counters = {g: {k: c.get(g, {}).get(k, 0) for k in keys}
                for g, keys in COUNTER_KEYS.items()}
    return replies, counters, svc


# the durable broker's command script: (verb, args) through a RespClient
JOURNAL_SCRIPT = (
    ("lpush_many", ("requestQueue", [f"predict,{i},x,{i}"
                                     for i in range(12)])),
    ("rpop_many", ("requestQueue", 3)),
    ("lease_many", ("requestQueue", 4, 60.0)),
    ("ackpush", ("predictionQueue", "requestQueue",
                 ["3,T", "4,F", "5,T"])),
    ("ackpush", ("predictionQueue", "requestQueue", ["4,F"])),
    ("lpush", ("other", "reload")),
    ("rpop", ("predictionQueue",)),
    ("delete", ("other",)),
    ("lpush_many", ("requestQueue", ["predict,20,y", "stop"])),
    ("lease_many", ("requestQueue", 2, 60.0)),
)


def run_journal_script(respq, journal_dir):
    """JOURNAL_SCRIPT against ``respq.RespServer(durable="commit")`` on
    ``journal_dir`` (256-byte segments: rotation checkpoints on the way),
    then ``kill`` — the journal is left as a crash leaves it; returns each
    call's result."""
    server = respq.RespServer(durable="commit", journal_dir=journal_dir,
                              journal_segment_bytes=JOURNAL_SEGMENT_BYTES
                              ).start()
    out = []
    try:
        cli = respq.RespClient(port=server.port)
        for verb, args in JOURNAL_SCRIPT:
            out.append(getattr(cli, verb)(*args))
        cli.close()
    finally:
        server.kill()
    return out


def make(out_dir: str = HERE) -> None:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    if RES not in sys.path:
        sys.path.insert(0, RES)
    from gen.call_hangup_gen import generate
    from avenir_tpu.cli import run as cli_run
    from avenir_tpu.core.schema import FeatureSchema
    from avenir_tpu.core.table import encode_rows
    from avenir_tpu.io import native_wire, respq
    from avenir_tpu.models.tree import (DecisionPathList, DecisionTreeModel,
                                        FeatureCache)
    from avenir_tpu.serving import service
    from avenir_tpu.serving.quantized import load_quantized, \
        wire_encode_rows
    from avenir_tpu.serving.registry import ModelRegistry
    # the Python plane is the oracle; the mode is process-wide, so the
    # caller's comes back after
    prev_mode = native_wire.get_mode()
    native_wire.set_mode("off")
    try:
        props = os.path.join(RES, "rafo.properties")
        schema_path = os.path.join(RES, "call_hangup.json")
        fs = FeatureSchema.load(schema_path)
        os.makedirs(out_dir, exist_ok=True)
        reg_dir = os.path.join(out_dir, "registry")
        shutil.rmtree(reg_dir, ignore_errors=True)
        shutil.copytree(RAFO9Q_V1, os.path.join(reg_dir, MODEL_NAME,
                                                "v_000001"))
        registry = ModelRegistry(reg_dir)
        v1 = registry.load(MODEL_NAME, 1)
        with tempfile.TemporaryDirectory() as work:
            train = os.path.join(work, "train.csv")
            with open(train, "w") as fh:
                # the class labels swapped: the replacement trees vote against
                # the ones they replace, so v2 answers some rows differently
                fh.write("\n".join(r[:-1] + {"T": "F", "F": "T"}[r[-1]]
                                   for r in generate(5000, 23)) + "\n")
            model = os.path.join(work, "model")
            assert cli_run.main([
                "org.avenir.tree.RandomForestBuilder", f"-Dconf.path={props}",
                f"-Ddtb.feature.schema.file.path={schema_path}",
                train, model]) == 0
            trees = list(v1.model)
            for i in CHANGED:
                with open(os.path.join(model, f"tree_{i}.json")) as fh:
                    trees[i] = DecisionPathList.from_json(fh.read())
            assert registry.publish_delta(MODEL_NAME, trees, parent_version=1,
                                          schema=v1.schema) == 2
            assert registry.delta_info(MODEL_NAME, 2)["changed"] == \
                list(CHANGED)
            registry.pin_version(MODEL_NAME, 1)

            with open(os.path.join(RAFO9, "requests.csv")) as fh:
                records = [line.rstrip("\n").split(",") for line in fh][:300]
            qf = load_quantized(registry, MODEL_NAME, 1)
            matrix = DecisionTreeModel(v1.model[0], fs).matrix
            vals, codes = FeatureCache().host(matrix, encode_rows(records, fs))
            qv, qc = qf.quantize_rows(vals, codes)
            qlines = wire_encode_rows(range(1000, 1300), qv, qc)
            lines = request_lines(records, qlines)
            _write(os.path.join(out_dir, "requests.txt"),
                   "\n".join(lines) + "\n")
            counters = {}
            for name, quantized in (("replies", False), ("replies_q", True)):
                flow_reg = os.path.join(work, f"reg_{name}")
                shutil.copytree(reg_dir, flow_reg)
                replies, c, _ = wire_flow(respq, service,
                                          ModelRegistry(flow_reg), lines,
                                          quantized=quantized)
                _write(os.path.join(out_dir, f"{name}.txt"),
                       "\n".join(replies) + "\n")
                counters[name] = c

            recs = [",".join(r) for r in records] + list(MALFORMED_RECORDS)
            _write(os.path.join(out_dir, "records.csv"),
                   "\n".join(recs) + "\n")
            job_reg = os.path.join(work, "reg_job")
            shutil.copytree(reg_dir, job_reg)
            out = os.path.join(work, "job")
            assert cli_run.main([
                "org.avenir.serving.PredictionService", f"-Dconf.path={props}",
                f"-Dps.model.registry.dir={job_reg}",
                f"-Dps.model.name={MODEL_NAME}", "-Dps.transport=resp",
                "-Dps.request.ttl.ms=600000",
                os.path.join(out_dir, "records.csv"), out]) == 0
            shutil.copyfile(os.path.join(out, "part-m-00000"),
                            os.path.join(out_dir, "job_replies.csv"))
            with open(out + ".counters.json") as fh:
                job = json.load(fh)["Serving"]
            counters["job"] = {k: job.get(k, 0) for k in
                               ("BadRequests", "ModelVersion", "Requests")}
            with open(os.path.join(out_dir, "counters.json"), "w") as fh:
                json.dump(counters, fh, indent=2, sort_keys=True)
                fh.write("\n")

        jdir = os.path.join(out_dir, "journal")
        shutil.rmtree(jdir, ignore_errors=True)
        run_journal_script(respq, jdir)
    finally:
        native_wire.set_mode(prev_mode)


if __name__ == "__main__":
    import jax
    if os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    make(sys.argv[1] if len(sys.argv) > 1 else HERE)
