"""Make the seq9 fixture with the JAX package, on the CPU, in one process
with one JAX device: the sequence, association and text jobs on what the
golden fixtures do not pin.

``data/`` holds every case's input, drawn here from numpy seeds and the
repo's generators (``resource/gen``).  Each case (``CASES``) is one job
over one input with a few keys; it writes ``<case>/out.csv`` (the job's
part file) and ``<case>/counters.json`` (its counter groups, without the
run's ``Profiling``, ``Transfers`` and ``Collectives``).  A case that
reads a model reads the file another case wrote into the fixture, so each
case stands alone:

  pst                probabilisticSuffixTreeGenerator, depth 2
  gsp, gsp_nosup     candidateGenerationWithSelfJoin with and without a
                     support column (repeated joins deduplicate)
  positional         sequencePositionalCluster, plain, two strategies that
                     must all pass, a cond.expression
  positional_w       the weighted strategies
  seqgen_num         sequenceGenerator, numeric sequence keys
  seqgen_lex         the same with lexicographic (and mixed) keys
  rates              stateTransitionRate over supplier_events_gen
  dwell, dwell_end   contTimeStateTransitionStats stateDwellTime without
                     and with an end state
  count, count_end   StateTransitionCount without and with an end state
  event_dow          eventTimeDistribution at dayOfWeek
  event_hod          hourOfDay with hour.granularity 3
  hmm                hiddenMarkovModelBuilder over loyalty_seq_gen
  viterbi_unknown    viterbiStatePredictor with unknown symbols
  viterbi_ties       a hand-written model whose predecessors tie
  markov             markovStateTransitionModel (the classify cases' model)
  classify_33/40/64  markovModelClassifier over batches padded to 33, 40
                     and 64 (row sums of 32, 39 and 63 pairs), each with
                     sequences of length 1
  apriori_1, _2, _3  frequentItemsApriori levels 1 (ids out), 2 (from
                     level 1) and 3 (from level 2, ids out)
  infrequent         infrequentItemMarker over level 1
  wordcount          wordCounter
  temporal, temporal_ms   temporalFilter over seconds and milliseconds
  rules, rules_entropy    ruleEvaluator, confAccuracy and confEntropy

The JAX package inside pytest has 8 CPU devices; this maker runs with one
(``XLA_FLAGS`` set before JAX is imported).  The port is held against
these files byte for byte on the CPU by ``tests/test_torch_sequence.py``,
``test_torch_association.py`` and ``test_torch_text_jobs.py``, and on the
GPU by ``chip_smoke.py``.  Regenerate from the repo root:

    JAX_PLATFORMS=cpu python tests/torch_fixtures/seq9/make.py
"""

import json
import os
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", "..", ".."))
RES = os.path.join(ROOT, "resource")
# counter groups a run adds around the job (wall times, the ledger)
RUN_GROUPS = ("Collectives", "Profiling", "Transfers")
EVENTS = "login,browse,cart,buy,support,transfer"
LOYAL = ("-Dhmmb.model.states=loyal,drifting,lost",
         "-Dhmmb.model.observations=SH,SM,SL,LH,LM,LL",
         "-Dhmmb.skip.field.count=1", "-Dvsp.skip.field.count=1")
CTMC = ("-Dkey.field.len=1", "-Dstate.values=F,P,L")
FIA = ("-Dfia.tans.id.ord=0", "-Dfia.skip.field.count=1",
       "-Dfia.support.threshold=0.2", "-Dfia.total.tans.count=120")
POSITIONAL = ("-Dquant.field.ordinal=2", "-Dseq.num..field.ordinal=0",
              "-Dwindow.time.span=1000", "-Dprocessing.time.step=100",
              "-Dmin.event.time.interval=50", "-Dscore.threshold=0.5")
RULES = ("-Drue.rule.names=r1,r2,r3", "-Drue.rule.r1=1 gt 40 > yes",
         "-Drue.rule.r2=1 le 40 and 2 in A:B > no",
         "-Drue.rule.r3=2 eq C and 1 ge 30 > yes",
         "-Drue.class.attr.ord=3", "-Drue.data.size=90",
         "-Drue.class.values=yes,no")
# case -> (job, input under data/ or a fixture file, -D keys); "{fix}" in a
# key is this fixture's directory
CASES = {
    "pst": ("probabilisticSuffixTreeGenerator", "events.csv",
            ("-Dpstg.skip.field.count=2", "-Dpstg.max.depth=2")),
    "gsp": ("candidateGenerationWithSelfJoin", "gsp.csv",
            ("-Dcgs.support.in.input=true",)),
    "gsp_nosup": ("candidateGenerationWithSelfJoin", "gsp_nosup.csv", ()),
    "positional": ("sequencePositionalCluster", "positional.csv",
                   POSITIONAL + ("-Dpreferred.strategies=count,maxInterval",
                                 "-Dany.cond=false", "-Dmin.occurence=3",
                                 "-Dmax.interval.max=400",
                                 "-Dcond.expression=2 gt 5.0")),
    "positional_w": ("sequencePositionalCluster", "positional.csv",
                     POSITIONAL + ("-Dwejghter.strategy=true",
                                   "-Dweighted.strategies=count=0.5,"
                                   "rangeLength=0.3,maxInterval=0.2")),
    "seqgen_num": ("sequenceGenerator", "seqgen_num.csv",
                   ("-Did.field.ordinals=0", "-Dval.field.ordinals=2,3",
                    "-Dseq.field=1")),
    "seqgen_lex": ("sequenceGenerator", "seqgen_lex.csv",
                   ("-Did.field.ordinals=0,1", "-Dval.field.ordinals=3",
                    "-Dseq.field=2")),
    "rates": ("stateTransitionRate", "supplier.csv",
              ("-Dkey.field.ordinals=0", "-Dtime.field.ordinal=1",
               "-Dstate.field.ordinal=2", "-Dstate.values=F,P,L",
               "-Drate.time.unit=week", "-Dinput.time.unit=ms",
               "-Dtrans.rate.output.precision=9")),
    "dwell": ("contTimeStateTransitionStats", "ctmc_init.csv",
              CTMC + ("-Dstate.trans.file.path={fix}/rates/out.csv",
                      "-Dtime.horizon=6", "-Dstate.trans.stat=stateDwellTime",
                      "-Dtarget.states=L")),
    "dwell_end": ("contTimeStateTransitionStats", "ctmc_init_end.csv",
                  CTMC + ("-Dstate.trans.file.path={fix}/rates/out.csv",
                          "-Dtime.horizon=12",
                          "-Dstate.trans.stat=stateDwellTime",
                          "-Dtarget.states=P")),
    "count": ("contTimeStateTransitionStats", "ctmc_init.csv",
              CTMC + ("-Dstate.trans.file.path={fix}/rates/out.csv",
                      "-Dtime.horizon=9",
                      "-Dstate.trans.stat=StateTransitionCount",
                      "-Dtarget.states=F,L")),
    "count_end": ("contTimeStateTransitionStats", "ctmc_init_end.csv",
                  CTMC + ("-Dstate.trans.file.path={fix}/rates/out.csv",
                          "-Dtime.horizon=20",
                          "-Dstate.trans.stat=StateTransitionCount",
                          "-Dtarget.states=P,F")),
    "event_dow": ("eventTimeDistribution", "visits.csv",
                  ("-Did.field.ordinals=0", "-Dtime.field.ordinal=1",
                   "-Dtime.resolution=dayOfWeek")),
    "event_hod": ("eventTimeDistribution", "visits.csv",
                  ("-Did.field.ordinals=0", "-Dtime.field.ordinal=1",
                   "-Dtime.resolution=hourOfDay", "-Dhour.granularity=3")),
    "hmm": ("hiddenMarkovModelBuilder", "tagged.csv", LOYAL),
    "viterbi_unknown": ("viterbiStatePredictor", "plain_unknown.csv",
                        LOYAL + ("-Dvsp.hmm.model.path={fix}/hmm/out.csv",)),
    "viterbi_ties": ("viterbiStatePredictor", "plain_ties.csv",
                     LOYAL + ("-Dvsp.hmm.model.path={fix}/data/"
                              "tied_hmm.csv",)),
    "markov": ("markovStateTransitionModel", "events.csv",
               ("-Dmst.skip.field.count=1", "-Dmst.class.label.field.ord=1",
                f"-Dmst.model.states={EVENTS}")),
    "classify_33": ("markovModelClassifier", "long_33.csv",
                    ("-Dmmc.mm.model.path={fix}/markov/out.csv",
                     "-Dmmc.class.labels=F,N", "-Dmmc.validation.mode=true",
                     "-Dmmc.class.label.field.ord=1")),
    "classify_40": ("markovModelClassifier", "long_40.csv",
                    ("-Dmmc.mm.model.path={fix}/markov/out.csv",
                     "-Dmmc.class.labels=F,N", "-Dmmc.validation.mode=true",
                     "-Dmmc.class.label.field.ord=1")),
    "classify_64": ("markovModelClassifier", "long_64.csv",
                    ("-Dmmc.mm.model.path={fix}/markov/out.csv",
                     "-Dmmc.class.labels=N,F",
                     "-Dmmc.log.odds.threshold=-0.5")),
    "apriori_1": ("frequentItemsApriori", "xactions.csv",
                  FIA + ("-Dfia.item.set.length=1",
                         "-Dfia.trans.id.output=true")),
    "apriori_2": ("frequentItemsApriori", "xactions.csv",
                  FIA + ("-Dfia.item.set.length=2",
                         "-Dfia.trans.id.output=false",
                         "-Dfia.support.threshold=0.04",
                         "-Dfia.item.set.file.path={fix}/apriori_1/out.csv")),
    "apriori_3": ("frequentItemsApriori", "xactions.csv",
                  FIA + ("-Dfia.item.set.length=3",
                         "-Dfia.trans.id.output=true",
                         "-Dfia.support.threshold=0.04",
                         "-Dfia.item.set.file.path={fix}/apriori_2/out.csv")),
    "infrequent": ("infrequentItemMarker", "xactions.csv",
                   ("-Diim.item.set.file.path={fix}/apriori_1/out.csv",
                    "-Diim.item.set.length=1",
                    "-Diim.contains.trans.id=true")),
    "wordcount": ("wordCounter", "text.csv", ("-Dtext.field.ordinal=1",)),
    "temporal": ("temporalFilter", "stamped.csv",
                 ("-Dtef.time.stamp.field.ordinal=1",
                  "-Dtef.time.range=1700000300:1700000900",
                  "-Dtef.time.zone.shift.hours=0")),
    "temporal_ms": ("temporalFilter", "stamped_ms.csv",
                    ("-Dtef.time.stamp.field.ordinal=1",
                     "-Dtef.time.range=1700003900:1700004500",
                     "-Dtef.time.stamp.in.mili=true",
                     "-Dtef.time.zone.shift.hours=1")),
    "rules": ("ruleEvaluator", "patients.csv",
              RULES + ("-Drue.conf.strategy=confAccuracy",)),
    "rules_entropy": ("ruleEvaluator", "patients.csv",
                      RULES + ("-Drue.conf.strategy=confEntropy",)),
}
WORDS = ("the", "quick", "brown", "fox", "jumps", "over", "a", "lazy",
         "dog", "don't", "example.com", "3.14", "foo_bar", "and", "is",
         "Data", "DATA", "o'neill's", "1,000", "_x_")


def _gen(name, *args):
    if RES not in sys.path:
        sys.path.insert(0, RES)
    import importlib
    return importlib.import_module(f"gen.{name}").generate(*args)


def _long_sequences(rng, n, max_len):
    """Random event sequences of lengths 1..max_len (at least one of each
    end), a class label each, one unknown state in a few."""
    states = EVENTS.split(",")
    lens = rng.integers(1, max_len + 1, n)
    lens[0], lens[1] = 1, max_len
    rows = []
    for i, ln in enumerate(lens):
        seq = [states[j] for j in rng.integers(0, len(states), ln)]
        if i % 7 == 3 and ln > 2:
            seq[1] = "refund"
        rows.append(",".join([f"L{i:04d}", "F" if i % 3 == 0 else "N"]
                             + seq))
    return rows


def make_data(out_dir: str) -> None:
    """Write every case's input under ``<out_dir>/data``."""
    data = os.path.join(out_dir, "data")
    shutil.rmtree(data, ignore_errors=True)
    os.makedirs(data)

    def _write(name, lines):
        with open(os.path.join(data, name), "w") as fh:
            fh.write("".join(ln + "\n" for ln in lines))
    rng = np.random.default_rng(9)
    _write("events.csv", _gen("event_seq_gen", 80, 91))
    items = [f"i{j}" for j in range(6)]
    gsp = [f"{a},{b},{rng.random():.3f}" for a in items for b in items
           if rng.random() < 0.35]
    _write("gsp.csv", gsp + gsp[:3])
    _write("gsp_nosup.csv", [",".join(rng.choice(items, 3)) for _ in range(12)])
    t = np.cumsum(rng.integers(20, 260, 200)) + 1_000_000
    _write("positional.csv",
           [f"{ts},s{i % 4},{rng.uniform(0, 10):.2f}"
            for i, ts in enumerate(t.tolist())])
    ents = ["e2", "e10", "e1"]
    _write("seqgen_num.csv",
           [f"{ents[i % 3]},{int(rng.integers(0, 50)) * (1 if i % 4 else -1)},"
            f"v{i},{rng.integers(0, 9)}" for i in range(30)])
    keys = ["t03a", "t3", "t10", "t01", "10", "2.5", "t2b"]
    _write("seqgen_lex.csv",
           [f"{ents[i % 3]},{'xy'[i % 2]},{keys[int(rng.integers(0, 7))]},"
            f"w{i}" for i in range(28)])
    _write("supplier.csv", _gen("supplier_events_gen", 6, 60, 92))
    _write("ctmc_init.csv", [f"S{i:03d},{'FPL'[i % 3]}" for i in range(6)])
    _write("ctmc_init_end.csv",
           [f"S{i:03d},{'FPL'[i % 3]},{'LFP'[i % 3]}" for i in range(6)])
    _write("visits.csv", _gen("visit_events_gen", 12, 80, 93))
    _write("tagged.csv", _gen("loyalty_seq_gen", 150, 94, "tagged"))
    plain = [ln.split(",") for ln in _gen("loyalty_seq_gen", 40, 95, "plain")]
    for i, row in enumerate(plain):
        if i % 5 == 1:
            row[1 + i % (len(row) - 1)] = "ZZ"
        if i % 9 == 4:
            row[1:] = ["XX"] * (len(row) - 1)
    _write("plain_unknown.csv", [",".join(r) for r in plain] + ["U99999,SH"])
    _write("tied_hmm.csv", [
        "loyal,drifting,lost", "SH,SM,SL,LH,LM,LL",
        "500,250,250", "250,500,250", "250,250,500",
        "200,200,200,200,100,100", "200,200,200,200,100,100",
        "100,100,200,200,200,200", "333,333,334"])
    obs = "SH,SM,SL,LH,LM,LL".split(",")
    _write("plain_ties.csv",
           [",".join([f"T{i:03d}"] + [obs[j] for j in rng.integers(
               0, 6, int(rng.integers(1, 12)))]) for i in range(30)])
    for L, n in ((33, 40), (40, 60), (64, 50)):
        _write(f"long_{L}.csv", _long_sequences(rng, n, L))
    _write("xactions.csv", _gen("buy_xaction_gen", 120, 96))
    _write("text.csv", [
        f"d{i}|" + " ".join(rng.choice(WORDS, int(rng.integers(3, 12))))
        for i in range(40)])
    base = 1_700_000_000
    _write("stamped.csv", [f"r{i},{base + 37 * i},{i % 5}"
                           for i in range(40)])
    _write("stamped_ms.csv", [f"r{i},{(base + 37 * i) * 1000 + 500},{i % 5}"
                              for i in range(40)])
    _write("patients.csv", [
        f"p{i},{int(rng.integers(18, 80))},{'ABC'[int(rng.integers(0, 3))]},"
        f"{'yes' if rng.random() < 0.4 else 'no'}" for i in range(90)])


def case_args(case, fix, work):
    """(job, argv) of one case: its input, output dir ``work/case``."""
    job, inp, keys = CASES[case]
    delim = ("-Dfield.delim.regex=\\|",) if case == "wordcount" else ()
    src = os.path.join(fix, "data", inp)
    return job, [job, *delim, *(k.replace("{fix}", fix) for k in keys), src,
                 os.path.join(work, case)]


def run_case(main, fix, work, case, extra=()):
    """Run ``case`` through a CLI ``main`` (either package's); returns
    (out.csv text, counters dict without the run's groups)."""
    _, argv = case_args(case, fix, work)
    if main(argv + list(extra)) != 0:
        raise RuntimeError(f"case {case} failed")
    out = os.path.join(work, case)
    text = "".join(open(os.path.join(out, p)).read()
                   for p in sorted(os.listdir(out)) if p.startswith("part-"))
    with open(out + ".counters.json") as fh:
        counters = {g: v for g, v in json.load(fh).items()
                    if g not in RUN_GROUPS}
    return text, counters


def make(out_dir: str = HERE) -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    assert jax.device_count() == 1, jax.devices()
    from avenir_tpu.cli import run
    make_data(out_dir)
    with tempfile.TemporaryDirectory() as work:
        for case in CASES:
            text, counters = run_case(run.main, out_dir, work, case)
            d = os.path.join(out_dir, case)
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d)
            with open(os.path.join(d, "out.csv"), "w") as fh:
                fh.write(text)
            with open(os.path.join(d, "counters.json"), "w") as fh:
                json.dump(counters, fh, indent=2, sort_keys=True)
                fh.write("\n")


if __name__ == "__main__":
    make()
