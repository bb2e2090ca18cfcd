"""Two ``python -m avenir_tpu_torch.serving.fleet_host`` OS processes on
the CPU (``AVENIR_TPU_PLATFORM=cpu``, which the port maps through
``runtime.platform_device``) against two broker shards: the ``served``
counts of their JSON stats lines add up to the requests, every request is
answered once with the fixture's class, and an addressed
``reload,<host>`` for each host converges both onto v2.
"""

import json
import os
import shutil
import subprocess
import sys
import time

from avenir_tpu_torch.io.respq import RespServer, ShardedRespClient
from avenir_tpu_torch.serving import ModelRegistry

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
FLEET9 = os.path.join(TESTS, "torch_fixtures", "fleet9")
WIRE9 = os.path.join(TESTS, "torch_fixtures", "wire9")


def _collect(cli, n, timeout_s=60.0):
    got = {}
    deadline = time.monotonic() + timeout_s
    while len(got) < n and time.monotonic() < deadline:
        vs = cli.rpop_many("predictionQueue", 256)
        if not vs:
            time.sleep(0.005)
            continue
        for v in vs:
            rid, label = v.split(",", 1)
            got.setdefault(rid, []).append(label)
    return got


def test_two_fleet_hosts_two_shards(tmp_path):
    reg = tmp_path / "reg"
    shutil.copytree(os.path.join(FLEET9, "registry"), reg)
    with open(os.path.join(WIRE9, "records.csv")) as fh:
        recs = fh.read().splitlines()[:300]
    v1 = dict(line.split(",", 1) for line in
              open(os.path.join(FLEET9, "a.csv")).read().splitlines())
    v2 = dict(line.split(",", 1) for line in
              open(os.path.join(FLEET9, "d.csv")).read().splitlines())
    servers = [RespServer().start() for _ in range(2)]
    eps = ",".join(f"127.0.0.1:{s.port}" for s in servers)
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["AVENIR_TPU_PLATFORM"] = "cpu"
    procs, ready = [], []
    feeder = None
    try:
        for h in ("h0", "h1"):
            ready.append(tmp_path / f"ready_{h}")
            procs.append(subprocess.Popen(
                [sys.executable, "-W", "ignore", "-m",
                 "avenir_tpu_torch.serving.fleet_host",
                 "--registry", str(reg), "--model", "rafo9",
                 "--endpoints", eps, "--workers", "1", "--host-label", h,
                 "--buckets", "8,64", "--max-batch", "16",
                 "--max-idle-s", "60", "--ready-file", str(ready[-1])],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        deadline = time.monotonic() + 120
        while not all(r.exists() for r in ready) and \
                time.monotonic() < deadline:
            assert all(p.poll() is None for p in procs)
            time.sleep(0.05)
        assert all(r.exists() for r in ready)
        feeder = ShardedRespClient(eps.split(","))
        feeder.lpush_many("requestQueue", [f"predict,{i},{r}"
                                           for i, r in enumerate(recs)])
        first = _collect(feeder, 300)
        assert first == {str(i): [v1[str(i)]] for i in range(300)}
        ModelRegistry(str(reg)).clear_pin("rafo9")
        for h in ("h0", "h1"):
            feeder.lpush("requestQueue", f"reload,{h}")
        time.sleep(0.5)
        feeder.lpush_many("requestQueue", [f"predict,{300 + i},{r}"
                                           for i, r in enumerate(recs)])
        second = _collect(feeder, 300)
        assert sorted(second, key=int) == [str(300 + i) for i in range(300)]
        assert all(len(v) == 1 for v in second.values())
        feeder.lpush_many("requestQueue", ["stop", "stop"])
        stats = []
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err[-2000:]
            stats.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
        if feeder is not None:
            feeder.close()
        for s in servers:
            s.stop()
    assert sorted(s["host"] for s in stats) == ["h0", "h1"]
    assert sum(s["served"] for s in stats) == 600
    assert all(set(s["model_versions"].values()) == {2} for s in stats)
    assert all(s["counters"]["Serving"]["Workers"] == 1 for s in stats)
    # after both hosts converged, every answer is v2's
    late = [k for k in second if second[k][0] != v2[str(int(k) - 300)]]
    assert all(second[k][0] == v1[str(int(k) - 300)] for k in late)
