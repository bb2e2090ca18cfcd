"""Job registry: the ``hadoop jar avenir.jar <ClassName> -Dconf.path=... in
out`` entry points, ported job by job from ``avenir_tpu/cli/jobs.py``.

Every reference job class name (and a short camelCase alias) maps to a
Python job function ``job(config, in_path, out_path) -> Counters``.  A job
name that is not ported yet raises :class:`JobNotPorted`, and so does a
ported job given a key of a tier that is not; nothing here dispatches to
the JAX package.  Ported: ``modelPredictor`` (here), ``predictionService``
(``serving_jobs.py``), ``decisionTreeBuilder`` and ``randomForestBuilder``
(here: monolithic and streamed training on one process or several,
bad-record skip/quarantine, checkpoints and ``--resume``, the registry publish and
its baseline and int8 sidecars), ``sameTypeSimilarity``,
``nearestNeighbor``, ``groupedRecordSimilarity``, ``featureCondProbJoiner``
and ``knnPipeline`` (``knn_jobs.py``), ``bayesianDistribution`` and
``bayesianPredictor`` (``bayes_jobs.py``), ``driftMonitor`` and
``predictDriftScore`` (``monitor_jobs.py``), ``retrainController``
(``control_jobs.py``), ``logisticRegression`` and
``logisticRegressionPredictor`` (``regress_jobs.py``), ``neuralNetwork``
and ``neuralNetworkPredictor`` (``nn_jobs.py``), ``simulatedAnnealing``
and ``geneticAlgorithm`` (``optimize_jobs.py``), ``multiArmBandit``,
``greedyRandomBandit``, ``softMaxBandit``, ``auerDeterministic`` and
``randomFirstGreedyBandit`` (``reinforce_jobs.py``), ``onlineLearner``
(``online_jobs.py``), the eleven sequence jobs (``sequence_jobs.py``:
the Markov model and classifier, the HMM builder and Viterbi, the PST, GSP
candidates, positional clusters, CTMC rates and statistics, event-time
histograms, ``sequenceGenerator``), ``frequentItemsApriori``,
``infrequentItemMarker`` and ``associationRuleMiner``
(``association_jobs.py``), ``wordCounter``, ``ruleEvaluator`` and
``temporalFilter`` (``text_jobs.py``).

Every job carries its multi-process mode (``register(dist=)``, the JAX
package's classes), which ``cli.run`` enforces in a joined
``torch.distributed`` run:

* ``sharded`` — the job reads its own shard and makes global results with
  explicit collectives (both tree builders: the streamed
  ``randomForestBuilder`` row-range sharded over one shared file, the
  others over per-process files; ``bayesianDistribution``;
  ``logisticRegression``, one gradient all-reduce an iteration;
  ``frequentItemsApriori``, the vocabulary and candidates unioned and the
  counts summed);
* ``map`` — a per-record transform of the local input; each process writes
  its own part file (``modelPredictor``, ``bayesianPredictor``,
  ``logisticRegressionPredictor``, ``neuralNetworkPredictor``,
  ``markovModelClassifier``, ``viterbiStatePredictor``,
  ``infrequentItemMarker``, ``temporalFilter``);
* ``partition`` — a global input view, the work split by process
  (``knnPipeline``: the test axis by ``work_slice``, or the train axis
  with ``nen.train.shard=true``; ``simulatedAnnealing`` its chains and
  ``geneticAlgorithm`` its islands, merged by ``allgather_object``);
* ``gather`` — host-side global computation over every process's input
  files (``sameTypeSimilarity``, ``nearestNeighbor``,
  ``groupedRecordSimilarity``, ``featureCondProbJoiner``,
  ``neuralNetwork``, the bandit jobs, the other sequence jobs,
  ``associationRuleMiner``, ``wordCounter`` and ``ruleEvaluator``), read
  from ``cli.run``'s spool;
* ``refuse`` — no multi-process form (``predictionService``,
  ``driftMonitor``, ``predictDriftScore``, ``retrainController``).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

from ..core import artifacts
from ..core.config import Config
from ..core.metrics import Counters
from ..core.schema import FeatureSchema
from ..core.table import BadRecordPolicy, _make_splitter, load_csv

JOBS: Dict[str, Callable] = {}
# the multi-process mode of each job function (module docstring)
JOB_DIST: Dict[Callable, str] = {}
DIST_MODES = ("sharded", "gather", "map", "partition", "refuse")


class JobNotPorted(KeyError):
    """The job exists in the reference but not (yet) in the port."""


def register(*names: str, dist: str):
    if dist not in DIST_MODES:
        raise ValueError(f"register(dist={dist!r}): must be one of "
                         f"{DIST_MODES}")

    def deco(fn):
        for n in names:
            JOBS[n] = fn
        JOB_DIST[fn] = dist
        return fn
    return deco


def dist_mode(fn: Callable) -> str:
    """The job's multi-process mode; a function registered without one is
    ``refuse``, so nothing emits shard-local results in silence."""
    return JOB_DIST.get(fn, "refuse")


def shards_by_row_range(fn: Callable, cfg: Config) -> bool:
    """True when this job, under this config, splits one shared input by
    row range itself (the streamed ``randomForestBuilder`` with
    ``dtb.streaming.shard`` not ``off``): every process then legitimately
    gets the same input path, and ``cli.run``'s identical-input refusal
    for sharded jobs stands down."""
    return (fn is random_forest_builder
            and cfg.get_boolean("dtb.streaming.ingest", False)
            and cfg.get("dtb.streaming.shard", "auto") != "off")


def resolve(name: str) -> Callable:
    if name in JOBS:
        return JOBS[name]
    # allow bare class name for fully-qualified registrations
    for k, v in JOBS.items():
        if k.split(".")[-1] == name:
            return v
    raise JobNotPorted(
        f"job {name!r} is not ported to avenir_tpu_torch yet; ported jobs: "
        f"{sorted(JOBS)}")


def _schema_path(cfg: Config, key: str) -> FeatureSchema:
    return FeatureSchema.load(cfg.must_get(key))


def _splitter(delim_regex: str):
    """Line splitter honoring field.delim.regex semantics."""
    return _make_splitter(delim_regex)


@register("org.avenir.model.ModelPredictor", "modelPredictor", dist="map")
def model_predictor_job(cfg: Config, in_path: str, out_path: str) -> Counters:
    """Generic map-only predictor (model/ModelPredictor.java:46-82): loads N
    decision-path model files (mop.model.dir.path + mop.model.file.names,
    default the forest builder's tree_<i>.json files) and predicts via single
    model or weighted ensemble vote (mop.ensemble.memeber.weights —
    reference key name, typo included)."""
    from ..models.forest import model_predictor
    from ..weights import load_tree_files, tree_files
    counters = Counters()
    schema = _schema_path(cfg, "mop.feature.schema.file.path")
    table = load_csv(in_path, schema, cfg.field_delim_regex, keep_raw=True)
    model_dir = cfg.get("mop.model.dir.path", "")
    names = cfg.get_list("mop.model.file.names")
    if not names:
        if not model_dir:
            cfg.must_get_list("mop.model.file.names")  # raise with key name
        if not os.path.isdir(model_dir):
            raise FileNotFoundError(f"model dir {model_dir!r} not found")
        names = tree_files(model_dir)
        if not names:
            raise FileNotFoundError(
                f"no tree_<i>.json models in {model_dir!r}; set "
                "mop.model.file.names explicitly for other layouts")
    path_lists = load_tree_files(
        [os.path.join(model_dir, nm) if model_dir else nm for nm in names])
    output_mode = cfg.get("mop.output.mode", "withRecord")
    # per-mode mandatory ordinals (ModelPredictor.java:165-172); error
    # counting also requires the class ordinal (:116)
    error_counting = cfg.get_boolean("mop.error.counting.enabled", False)
    class_ord = None
    if output_mode == "withActualClassAttr" or error_counting:
        class_ord = cfg.must_get_int(
            "mop.rec.class.attr.ordinal",
            "missing class attribute ordinal") if \
            "mop.rec.class.attr.ordinal" in cfg else \
            cfg.must_get_int("mop.class.attr.ord",
                             "missing class attribute ordinal")
    id_ord = cfg.get_int("mop.rec.id.ordinal", 0) \
        if output_mode != "withKId" else \
        cfg.must_get_int("mop.rec.id.ordinal", "missing id ordinal")
    lines = model_predictor(
        table, schema, path_lists,
        output_mode=output_mode,
        id_ordinal=id_ord,
        class_attr_ordinal=class_ord,
        error_counting=error_counting,
        weights=cfg.get_float_list("mop.ensemble.memeber.weights"),
        min_odds_ratio=cfg.get_float("mop.min.odds.ratio", 1.0),
        out_delim=cfg.field_delim_out, counters=counters)
    artifacts.write_text_output(out_path, lines, role="m")
    return counters


# --------------------------------------------------------------------------
# org.avenir.tree
# --------------------------------------------------------------------------

def _bad_records_policy(cfg: Config, counters: Counters,
                        out_path: Optional[str] = None
                        ) -> Optional[BadRecordPolicy]:
    """The job-level ``badrecords.policy`` knob (fail|skip|quarantine),
    Hadoop's skip-bad-records.  Quarantined raw lines land in
    ``badrecords.quarantine.path`` (default ``<out>/_quarantine``);
    skip/quarantine tallies surface in the ``BadRecords`` counter group."""
    pol = cfg.get("badrecords.policy", "fail")
    if pol == "fail":
        return None
    qpath = cfg.get("badrecords.quarantine.path")
    if pol == "quarantine" and not qpath:
        if not out_path:
            raise ValueError("badrecords.policy=quarantine needs "
                             "badrecords.quarantine.path (no output dir "
                             "to default under)")
        qpath = os.path.join(out_path, "_quarantine")
    return BadRecordPolicy(pol, qpath, counters)


def _cache_policy(cfg: Config, counters: Counters,
                  prefix: str = "dtb.streaming.cache"):
    """The job-level columnar-cache knob (``<prefix>.policy`` =
    off|use|build|require, ``<prefix>.dir`` overriding the default
    ``<csv>.avtc`` sidecar location).  Tallies surface in the job's counter
    dump as the ``ColumnarCache`` group."""
    pol = cfg.get(f"{prefix}.policy", "off")
    if pol == "off":
        return None
    from ..io.colcache import CachePolicy
    return CachePolicy(policy=pol, cache_dir=cfg.get(f"{prefix}.dir"),
                       counters=counters)


def _refuse_multi_shard(job: str) -> None:
    """Raise :class:`JobNotPorted` on the shard lane
    (``AVENIR_TPU_SHARD=i/P`` with P > 1) for a training path with no form
    there: the per-level builder, the monolithic or
    ``dtb.streaming.shard=off`` forest and the Naive Bayes train over
    per-process files.  The lane's
    processes share no global arrays (the JAX package trains each of them
    alone on its own file); a joined run trains these paths with
    :func:`_joined_reducer`.  A multi-shard launch must never train
    single-host in silence."""
    from ..parallel.distributed import shard_spec
    env = os.environ.get("AVENIR_TPU_SHARD")
    if env and shard_spec().active:
        raise JobNotPorted(
            f"{job} on the shard lane (AVENIR_TPU_SHARD={env}): only the "
            f"streamed, row-range sharded randomForestBuilder "
            f"(dtb.streaming.ingest=true) runs on the lane in "
            f"avenir_tpu_torch; run this path in a joined torch.distributed "
            f"run, or single-process; refusing to silently train "
            f"single-host")


def _joined_reducer(name: str):
    """In a joined run (after :func:`_refuse_multi_shard`), the
    ``parallel.collectives.AllReducer`` over its processes that makes a
    build over per-process inputs train the model of one process over
    their concatenation; ``None`` in a single process."""
    from ..parallel.distributed import shard_spec
    spec = shard_spec()
    if not spec.active:
        return None
    from ..parallel.collectives import AllReducer
    return AllReducer(spec=spec, name=name)


def _tree_params(cfg: Config):
    """Map the dtb.* keys (resource/detr.properties, rafo.properties) onto
    TreeParams."""
    from ..models.tree import TreeParams
    # defaults match the reference job's (DecisionTreeBuilder.java:169,179,
    # 434,442,448): giniIndex / notUsedYet / best / minInfoGain / withReplace
    return TreeParams(
        split_algorithm=cfg.get("dtb.split.algorithm", "giniIndex"),
        attr_select_strategy=cfg.get("dtb.split.attribute.selection.strategy",
                                     "notUsedYet"),
        random_split_set_size=cfg.get_int("dtb.random.split.set.size", 3),
        split_select_strategy=cfg.get("dtb.split.select.strategy", "best"),
        top_split_count=cfg.get_int("dtb.top.split.count", 3),
        stopping_strategy=cfg.get("dtb.path.stopping.strategy", "minInfoGain"),
        max_depth=cfg.get_int("dtb.max.depth.limit", 3),
        min_info_gain=cfg.get_float("dtb.min.info.gain.limit", -1.0),
        min_population=cfg.get_int("dtb.min.population.limit", -1),
        sub_sampling=cfg.get("dtb.sub.sampling.strategy", "withReplace"),
        sub_sampling_rate=cfg.get_float("dtb.sub.sampling.rate", 100.0),
        seed=cfg.get_int("dtb.random.seed"),
    )


@register("org.avenir.tree.DecisionTreeBuilder", "decisionTreeBuilder",
          dist="sharded")
def decision_tree_builder(cfg: Config, in_path: str, out_path: str) -> Counters:
    """One level of tree growth per invocation — the reference job contract
    (tree/DecisionTreeBuilder.java, driven by resource/detr.sh's rotation of
    dtb.decision.file.path.out -> .in between runs).  Records are routed by
    re-evaluating the decision paths, so the output dir just carries the
    input records forward for script compatibility.

    In a joined run each process reads its own input, the level's counts
    are summed across the processes, and every process writes the
    decision paths of one process over the concatenated inputs to
    ``dtb.decision.file.path.out``; its records go to its own part file."""
    from ..models import tree as T
    _refuse_multi_shard("decisionTreeBuilder")
    counters = Counters()
    schema = _schema_path(cfg, "dtb.feature.schema.file.path")
    table = load_csv(in_path, schema, cfg.field_delim_regex, keep_raw=True,
                     bad_records=_bad_records_policy(cfg, counters, out_path))
    builder = T.TreeBuilder(table, _tree_params(cfg),
                            reducer=_joined_reducer("dt-level"))
    dec_in = cfg.get("dtb.decision.file.path.in")
    dpl = None
    if dec_in:
        with open(dec_in) as fh:
            dpl = T.DecisionPathList.from_json(fh.read())
    new_dpl = builder.build_one_level(table, dpl)
    with open(cfg.must_get("dtb.decision.file.path.out"), "w") as fh:
        fh.write(new_dpl.to_json())
    if out_path:
        # this process's own records: its own part file in a joined run
        artifacts.write_text_output(
            out_path, (cfg.field_delim_out.join(r) for r in table.raw_rows),
            local_shard=True)
    counters.increment("Decision tree", "Paths", len(new_dpl.decision_paths))
    return counters


@register("org.avenir.tree.RandomForestBuilder", "randomForestBuilder",
          dist="sharded")
def random_forest_builder(cfg: Config, in_path: str, out_path: str) -> Counters:
    """Full in-process random forest: the rafo.sh per-tree rerun loop
    (resource/rafo.sh:34-43) collapsed into one job.  Writes one
    decision-path JSON per tree into the output dir (tree_<i>.json) and,
    with ``dtb.model.registry.dir``, publishes the forest as the next
    version of ``dtb.model.name`` (default ``forest``) in that registry.

    ``dtb.streaming.ingest=true`` trains through the chunked CSV -> device
    pipeline (``dtb.streaming.block.rows`` rows a block, default 2^22):
    host memory holds a few parsed blocks instead of the whole encoded
    dataset.  A parse thread reads the CSV, a staging thread encodes each
    block and uploads it, the job's thread computes its branch codes on
    the device; the trees are those of the monolithic path.
    ``dtb.pipeline.fuse`` is accepted and both values run this per-stage
    form: the reference's fused per-chunk program and its
    ``ProgramCache`` counters are not ported, and its own tests pin the
    two forms to the same outputs.

    Fault tolerance: ``badrecords.policy`` (both paths) skips or
    quarantines malformed records; ``dtb.streaming.checkpoint.dir`` (+
    ``dtb.streaming.checkpoint.blocks``, default 16) persists ingest
    progress, and ``dtb.streaming.resume=true`` (CLI ``--resume``)
    restarts from the last intact step to the model of an uninterrupted
    run.

    Data-parallel over processes (``dtb.streaming.shard=auto|on|off``,
    default auto): in a run of several shards (``AVENIR_TPU_SHARD=i/P``
    with ``AVENIR_TPU_ALLREDUCE_DIR``, or a joined ``torch.distributed``
    run) every process reads the same CSV, parses only its row range
    (``iter_csv_chunks(shard=)``) and sums one stacked count array a tree
    level with its peers (``parallel.collectives.AllReducer``): every
    process trains the single-process forest.  ``on`` refuses a run of
    one shard.  In a joined run, the monolithic build and
    ``off`` train over per-process input files the same way: the row
    counts are exchanged once, the bootstrap is drawn over the global
    count, and every process trains the forest of one process over the
    files concatenated in process order (the JAX package draws each
    process's bootstrap over its own rows instead; ROADMAP §C).  The
    shard lane refuses them.  Each shard checkpoints under
    ``<dir>/shard-<i>-of-<P>``; the baseline's partial counts are summed
    before publishing; shard 0 of process 0 alone publishes, with the
    quantize budget held on its own rows, and sets ``Shard/Count`` in a
    row-range sharded build.

    ``dtb.streaming.cache.policy`` (off|use|build|require, + ``.dir``)
    slots the columnar cache sidecar under the streamed ingest
    (``io.colcache``): ``build`` writes ``<csv>.avtc`` during a cold full
    pass, and ``use``/``build``/``require`` serve an intact fresh one
    instead of parsing; the trees are the same either way.  A sharded pass
    and every process but 0 never build.

    Two sidecars ride the published version (both need the registry):
    ``dtb.baseline.publish=true`` profiles the training data into the
    drift monitor's baseline (``dtb.baseline.bins``, default 32; a
    streamed ingest tees the same pass, a resumed one profiles the rows
    it re-reads), and ``dtb.model.quantize=true`` attaches the int8
    serving sidecar after holding the quantized vote to
    ``dtb.model.quantize.budget`` (default 0.01 prediction-mismatch
    fraction against the float ensemble) on the training table, or on a
    head sample of ``dtb.model.quantize.sample.rows`` (default 65536)
    rows when streamed; an over-budget quantization refuses to publish.
    ``predictionService`` selects that sidecar with ``ps.quantized``."""
    from ..models.forest import (ForestParams, build_forest,
                                 build_forest_from_stream)
    from ..parallel.distributed import process_index, shard_spec
    counters = Counters()
    schema = _schema_path(cfg, "dtb.feature.schema.file.path")
    params = ForestParams(tree=_tree_params(cfg),
                          num_trees=cfg.get_int("dtb.num.trees", 5),
                          seed=cfg.get_int("dtb.random.seed", 0))
    policy = _bad_records_policy(cfg, counters, out_path)
    reg_dir = cfg.get("dtb.model.registry.dir")
    baseline_builder = None
    if cfg.get_boolean("dtb.baseline.publish", False):
        if not reg_dir:
            raise ValueError("dtb.baseline.publish needs "
                             "dtb.model.registry.dir (baselines ride "
                             "registry versions as sidecars)")
        from ..monitor.baseline import BaselineBuilder
        baseline_builder = BaselineBuilder(
            schema, n_bins=cfg.get_int("dtb.baseline.bins", 32))
    quantize = cfg.get_boolean("dtb.model.quantize", False)
    if quantize and not reg_dir:
        raise ValueError("dtb.model.quantize needs dtb.model.registry.dir "
                         "(the int8 sidecar rides the registry version)")
    streamed = cfg.get_boolean("dtb.streaming.ingest", False)
    if cfg.get_boolean("dtb.streaming.resume", False) and not streamed:
        # a --resume that silently retrains from row 0 through the
        # monolithic path is the failure mode the flag exists to prevent
        raise ValueError("dtb.streaming.resume needs "
                         "dtb.streaming.ingest=true (checkpoints only "
                         "exist for the streaming build)")
    shard_knob = cfg.get("dtb.streaming.shard", "auto")
    if shard_knob not in ("auto", "on", "off"):
        raise ValueError(f"dtb.streaming.shard must be auto|on|off, "
                         f"got {shard_knob!r}")
    if shard_knob == "on" and not streamed:
        raise ValueError("dtb.streaming.shard=on needs "
                         "dtb.streaming.ingest=true (only the streaming "
                         "build can row-range shard)")
    spec = shard_spec()
    sharded = streamed and shard_knob != "off" and spec.active
    reducer = None
    if not sharded:
        _refuse_multi_shard("randomForestBuilder"
                            + (" with dtb.streaming.shard=off"
                               if streamed else ""))
        reducer = _joined_reducer("rf-joined")
    if streamed:
        from ..core.checkpoint import CheckpointManager
        from ..core.table import iter_csv_chunks, prefetch_chunks
        if shard_knob == "on" and not sharded:
            raise ValueError(
                "dtb.streaming.shard=on needs a multi-shard run "
                "(torch.distributed, or AVENIR_TPU_SHARD=i/P with "
                "AVENIR_TPU_ALLREDUCE_DIR); refusing to silently train "
                "single-host")
        cfg.get_boolean("dtb.pipeline.fuse", True)   # accepted, see above
        if sharded:
            from ..parallel.collectives import AllReducer
            reducer = AllReducer(spec=spec, name="rf-stream")
            # set by shard 0 alone: a joined run's counter all-reduce sums
            if spec.index == 0:
                counters.set("Shard", "Count", spec.count)
        ckpt_dir = cfg.get("dtb.streaming.checkpoint.dir")
        if ckpt_dir and reducer is not None:
            # per-shard step dirs: shards saving into one dir would race
            # on the same step names
            ckpt_dir = os.path.join(
                ckpt_dir, f"shard-{spec.index}-of-{spec.count}")
        mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
        every = cfg.get_int("dtb.streaming.checkpoint.blocks", 16) \
            if mgr is not None else 0
        resume_state = None
        start_row = 0
        if cfg.get_boolean("dtb.streaming.resume", False):
            if mgr is None:
                raise ValueError("dtb.streaming.resume needs "
                                 "dtb.streaming.checkpoint.dir")
            try:
                step, arrays, meta = mgr.restore()
            except FileNotFoundError:
                if mgr.steps():
                    # steps exist but none restore: re-ingesting from row
                    # 0 as a cold start is what the flag must prevent
                    raise RuntimeError(
                        f"dtb.streaming.resume: checkpoint dir "
                        f"{ckpt_dir!r} holds {len(mgr.steps())} step(s) "
                        f"but none restore intact; refusing to silently "
                        f"restart from row 0 — clear the dir to force a "
                        f"cold start")
                # nothing saved yet: cold start
            else:
                resume_state = (arrays, meta)
                start_row = int(meta.get("source_rows_done") or 0)
                counters.set("Checkpoint", "ResumedFromStep", step)
                counters.set("Checkpoint", "ResumedSourceRows", start_row)
        # consumer_wait_key=None: this parse layer feeds from_stream's
        # staging thread, whose own stats time the wait on it
        blocks = prefetch_chunks(iter_csv_chunks(
            in_path, schema, cfg.field_delim_regex,
            chunk_rows=cfg.get_int("dtb.streaming.block.rows", 1 << 22),
            bad_records=policy, start_row=start_row,
            cache=_cache_policy(cfg, counters),
            shard=(spec.index, spec.count) if sharded else None),
            consumer_wait_key=None)
        models = build_forest_from_stream(
            blocks, schema, params, checkpoint=mgr, checkpoint_every=every,
            resume_state=resume_state, baseline=baseline_builder,
            reducer=reducer)
    else:
        table = load_csv(in_path, schema, cfg.field_delim_regex,
                         bad_records=policy)
        if baseline_builder is not None:
            baseline_builder.update(table)
        models = build_forest(table, params, reducer=reducer)
    os.makedirs(out_path, exist_ok=True)
    for i, dpl in enumerate(models):
        with open(os.path.join(out_path, f"tree_{i}.json"), "w") as fh:
            fh.write(dpl.to_json())
    # every process trains the same forest; the registry has one writer
    publish = process_index() == 0 and (reducer is None
                                        or reducer.spec.index == 0)
    baseline = None
    if reg_dir and baseline_builder is not None:
        # a collective: every shard sums its partial counts first, then
        # only the publisher writes
        from ..monitor.baseline import allreduce_partials
        baseline = allreduce_partials(baseline_builder,
                                      reducer=reducer).finalize()
    if reg_dir and publish:
        from ..serving.registry import ModelRegistry
        registry = ModelRegistry(reg_dir)
        model_name = cfg.get("dtb.model.name", "forest")
        version = registry.publish(model_name, models, schema=schema)
        counters.set("Random forest", "RegistryVersion", version)
        if baseline is not None:
            from ..monitor.baseline import publish_baseline
            publish_baseline(registry, model_name, version, baseline)
            counters.set("Random forest", "BaselineRows", baseline.n_rows)
        if quantize:
            from ..serving.quantized import publish_quantized
            sample = table if not streamed else _head_sample(
                cfg, in_path, schema)
            info = publish_quantized(
                registry, model_name, version, models, schema, sample,
                budget=cfg.get_float("dtb.model.quantize.budget", 0.01))
            counters.set("Random forest", "QuantizedSampleRows",
                         int(info["n_sample"]))
            counters.set("Random forest", "QuantizedMismatchPerMillion",
                         int(round(info["mismatch"] * 1e6)))
    counters.increment("Random forest", "Trees", len(models))
    return counters


def _head_sample(cfg: Config, in_path: str, schema: FeatureSchema):
    """The streamed quantize publish's budget sample: the first
    ``dtb.model.quantize.sample.rows`` well-formed rows, re-read with
    malformed records skipped (the encoded dataset is gone by then)."""
    from ..core.table import iter_csv_chunks
    gen = iter_csv_chunks(
        in_path, schema, cfg.field_delim_regex,
        chunk_rows=cfg.get_int("dtb.model.quantize.sample.rows", 65536),
        bad_records=BadRecordPolicy("skip"))
    try:
        return next(gen)
    except StopIteration:
        raise ValueError(
            "dtb.model.quantize: the input yielded no sample rows to "
            "enforce the accuracy budget on (empty/fully-filtered "
            "file)") from None
    finally:
        gen.close()   # release the file handle now
