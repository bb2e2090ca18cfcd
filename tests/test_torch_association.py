"""Association mining in the port (``avenir_tpu_torch/association``,
``cli/association_jobs.py``) against the JAX package, on the CPU.

The port's CLI reproduces the golden apriori flow and the seq9 fixture's
Apriori levels 1-3 and infrequent-item marker byte for byte.  Support
counts are exact integers in both of the port's forms, the matmul (the
CUDA form) and the column gathers (the CPU form), and equal the JAX
package's counts of its MXU and gather kernels; a level, chained levels
and the mined rules equal the JAX package's.  A joined run of two gloo
ranks over two halves of the transactions writes the level of one process
over all of them.
"""

import importlib.util
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from avenir_tpu.association import itemsets as JIT
from avenir_tpu.association import rules as JRU
from avenir_tpu_torch.association import itemsets as IT
from avenir_tpu_torch.association import rules as RU
from avenir_tpu_torch.cli import run as port_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "resource")
SEQ9 = os.path.join(ROOT, "tests", "torch_fixtures", "seq9")
GOLDEN = os.path.join(ROOT, "tests", "golden", "fixtures")
CPU = "-Dplatform=cpu"
ASSOCIATION_JOBS = {"frequentItemsApriori", "infrequentItemMarker",
                    "associationRuleMiner"}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKE = _load("seq9_make_assoc", os.path.join(SEQ9, "make.py"))
FLOWS = _load("golden_flows_assoc", os.path.join(ROOT, "tests", "golden",
                                                  "flows.py"))


class _PortCLI:
    @staticmethod
    def main(argv):
        return port_run.main(list(argv) + [CPU])


def test_golden_apriori_flow_byte_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(FLOWS, "cli_run", _PortCLI)
    outs = FLOWS.apriori_flow(str(tmp_path))
    for rel, text in outs.items():
        with open(os.path.join(GOLDEN, rel)) as fh:
            assert text == fh.read(), rel


@pytest.mark.parametrize("case", [c for c, (job, _, _) in MAKE.CASES.items()
                                  if job in ASSOCIATION_JOBS])
def test_seq9_case_byte_equal(tmp_path, case):
    text, counters = MAKE.run_case(port_run.main, SEQ9, str(tmp_path), case,
                                   (CPU,))
    with open(os.path.join(SEQ9, case, "out.csv")) as fh:
        assert text == fh.read()
    with open(os.path.join(SEQ9, case, "counters.json")) as fh:
        assert counters == json.load(fh)


def _membership(seed, n, V, p=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((n, V)) < p).astype(np.uint8)


def _candidates(seed, V, k, m):
    rng = np.random.default_rng(seed)
    return np.stack([np.sort(rng.choice(V, k, replace=False))
                     for _ in range(m)]).astype(np.int32)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_support_counts_equal_in_both_forms_and_to_jax(k):
    M = _membership(k, 3000, 17)
    C = _candidates(10 + k, 17, k, 60)
    Mt, Ct = torch.from_numpy(M), torch.from_numpy(C)
    matmul = IT.support_matmul(Mt, Ct)
    gather = IT.support_gather(Mt, Ct)
    assert matmul.dtype == gather.dtype == torch.int64
    want = M[:, C].all(axis=2).sum(axis=0)
    np.testing.assert_array_equal(matmul.numpy(), want)
    np.testing.assert_array_equal(gather.numpy(), want)
    for kern in (JIT._support_kernel_mxu, JIT._support_kernel_gather):
        np.testing.assert_array_equal(
            np.asarray(kern(jnp.asarray(M), jnp.asarray(C))), want)
    # the CPU tensors take the gather form
    np.testing.assert_array_equal(IT.support(Mt, Ct).numpy(), want)


def test_support_counts_across_chunks(monkeypatch):
    tx = [(f"t{i}", list(np.random.default_rng(i).choice(
        list("abcdefgh"), 3, replace=False))) for i in range(2000)]
    tm = IT.TransactionMatrix(tx)
    jtm = JIT.TransactionMatrix(tx)
    assert tm.items == jtm.items
    np.testing.assert_array_equal(tm.matrix, jtm.matrix)
    C = _candidates(3, len(tm.items), 2, 20)
    want = jtm.support_counts(C)
    np.testing.assert_array_equal(tm.support_counts(C, device="cpu"), want)
    monkeypatch.setattr(IT, "SUPPORT_CHUNK_CELLS", 20 * 100)   # 100 rows
    np.testing.assert_array_equal(tm.support_counts(C, device="cpu"), want)
    assert tm.supporting_trans([0, 1]) == jtm.supporting_trans([0, 1])


def _transactions(n, seed):
    gen = _load("buy_gen", os.path.join(RES, "gen", "buy_xaction_gen.py"))
    rows = [ln.split(",") for ln in gen.generate(n, seed)]
    return JIT.read_transactions(rows), IT.read_transactions(rows)


@pytest.mark.parametrize("emit_trans_id", [True, False])
def test_frequent_itemsets_and_rules_equal(emit_trans_id):
    jtx, ptx = _transactions(400, 31)
    assert jtx == ptx
    jl = JIT.frequent_itemsets(jtx, 0.03, 4, emit_trans_id=emit_trans_id)
    pl = IT.frequent_itemsets(ptx, 0.03, 4, emit_trans_id=emit_trans_id,
                              device="cpu")
    assert sorted(pl) == sorted(jl) and len(pl) >= 3
    for k in jl:
        assert [(s.items, s.trans_ids, s.support, s.count) for s in pl[k]] \
            == [(s.items, s.trans_ids, s.support, s.count) for s in jl[k]]
        assert IT.format_itemset_lines(pl[k], emit_trans_id, True) == \
            JIT.format_itemset_lines(jl[k], emit_trans_id, True)
    freq = [(s.items, s.support) for k in sorted(jl) for s in jl[k]]
    for conf, ante in ((0.3, 1), (0.5, 2), (0.2, 3)):
        assert RU.mine_rules(freq, conf, ante, with_confidence=True) == \
            JRU.mine_rules(freq, conf, ante, with_confidence=True)
    rows = [[t] + items for t, items in ptx[:50]]
    assert IT.mark_infrequent(rows, ["milk", "beer"], "*") == \
        JIT.mark_infrequent(rows, ["milk", "beer"], "*")


def test_joined_apriori_equals_one_process(tmp_path):
    """Two gloo ranks of the port's CLI, each given half the transactions
    (dist=sharded), write the level that one process writes over all of
    them; the transactions counter sums over the ranks."""
    gen = _load("buy_gen2", os.path.join(RES, "gen", "buy_xaction_gen.py"))
    lines = gen.generate(300, 41)
    whole = tmp_path / "all.csv"
    whole.write_text("\n".join(lines) + "\n")
    for i, part in enumerate((lines[:170], lines[170:])):
        (tmp_path / f"part{i}.csv").write_text("\n".join(part) + "\n")
    keys = [f"-Dconf.path={os.path.join(RES, 'apriori.properties')}",
            "-Dfia.total.tans.count=300", "-Dfia.support.threshold=0.05",
            CPU]
    level1 = tmp_path / "one1"
    assert port_run.main(["frequentItemsApriori", *keys,
                          "-Dfia.item.set.length=1", str(whole),
                          str(level1)]) == 0
    assert port_run.main(["frequentItemsApriori", *keys,
                          "-Dfia.item.set.length=2",
                          f"-Dfia.item.set.file.path={level1}/part-r-00000",
                          str(whole), str(tmp_path / "one2")]) == 0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for i in range(2):
        env = dict(os.environ, RANK=str(i), WORLD_SIZE="2",
                   LOCAL_RANK=str(i), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), AVENIR_TPU_ALLREDUCE_TIMEOUT_S="60",
                   PYTHONPATH=ROOT, OMP_NUM_THREADS="1")   # light on the host
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "avenir_tpu_torch.cli.run",
             "frequentItemsApriori", *keys, "-Dfia.item.set.length=2",
             f"-Dfia.item.set.file.path={level1}/part-r-00000",
             str(tmp_path / f"part{i}.csv"), str(tmp_path / f"rank{i}")],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]
    want = (tmp_path / "one2" / "part-r-00000").read_text()
    for i in range(2):
        assert (tmp_path / f"rank{i}" / "part-r-00000").read_text() == want
    assert "transactions=300" in outs[0][0]
