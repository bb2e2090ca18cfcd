"""Neural-net pack jobs: port of ``avenir_tpu/cli/nn_jobs.py``, the
reference's single-node NN trainer
(python/supv/basic_nn.py, invoked as ``basic_nn.py <num_hidden_units>
<data_set_size> <noise> <iteration_count> <learning_rate> <training_mode>``)
rebuilt as schema-driven CSV-in/CSV-out jobs with a saved model artifact.

Config keys (nn.* namespace, mirroring the script's arguments):
nn.hidden.units, nn.iteration.count, nn.learning.rate, nn.reg.lambda,
nn.training.mode (batch|incr|minibatch), nn.batch.size,
nn.validation.interval, nn.model.file.path, nn.validation.data.file.path,
nn.random.seed, and the chunked checkpoint run's nn.checkpoint.dir.path
and nn.checkpoint.interval.  Training and prediction run on the process
device (``-Dplatform``); the model file is the JAX package's format.
"""

from __future__ import annotations

import numpy as np

from ..core.config import Config
from ..core.metrics import Counters, ConfusionMatrix
from ..core import artifacts
from ..core.table import load_csv
from .jobs import _schema_path, register


def _xy(table):
    """Feature matrix + class codes, with unknown-label rows (code -1, e.g.
    typos outside the schema cardinality) dropped rather than silently
    trained as the last class (negative indexing wraps)."""
    X = table.feature_matrix(dtype=np.float32)
    y = np.asarray(table.class_codes()).astype(np.int32)
    known = y >= 0
    return X[known], y[known]


@register("org.avenir.supv.NeuralNetworkTrainer", "neuralNetwork",
          dist="gather")
def neural_network_trainer(cfg: Config, in_path: str, out_path: str) -> Counters:
    from ..nn import mlp
    counters = Counters()
    schema = _schema_path(cfg, "feature.schema.file.path")
    table = load_csv(in_path, schema, cfg.field_delim_regex)
    X, y = _xy(table)
    if len(y) == 0:
        raise ValueError("no trainable rows: every class label is unknown")
    n_classes = len(schema.class_attr_field.cardinality or []) or int(y.max()) + 1
    if n_classes < 2:
        raise ValueError(f"need >= 2 classes, got {n_classes}")
    mcfg = mlp.MLPConfig(
        hidden_dim=cfg.get_int("nn.hidden.units", 3),
        n_classes=n_classes,
        learning_rate=cfg.get_float("nn.learning.rate", 0.01),
        reg_lambda=cfg.get_float("nn.reg.lambda", 0.01),
        mode=cfg.get("nn.training.mode", "batch"),
        iterations=cfg.get_int("nn.iteration.count", 1000),
        batch_size=cfg.get_int("nn.batch.size", 64),
        seed=cfg.get_int("nn.random.seed", 0),
        validation_interval=cfg.get_int("nn.validation.interval", 50),
    )
    val_path = cfg.get("nn.validation.data.file.path")
    Xv = yv = None
    if val_path:
        vt = load_csv(val_path, schema, cfg.field_delim_regex)
        Xv, yv = _xy(vt)
        if len(yv) == 0:
            raise ValueError(
                f"validation file {val_path!r} has no known class labels")

    ckpt_dir = cfg.get("nn.checkpoint.dir.path")
    ckpt_interval = cfg.get_int("nn.checkpoint.interval", 0)
    if ckpt_dir and ckpt_interval > 0:
        # chunked training with durable per-chunk state: resume from the
        # latest checkpoint (the reference's iterate-via-durable-artifact
        # contract, SURVEY.md §5 checkpoint/resume)
        from ..core.checkpoint import CheckpointManager
        mgr = CheckpointManager(ckpt_dir)
        arch = {"hidden_dim": mcfg.hidden_dim, "n_classes": mcfg.n_classes,
                "n_features": int(X.shape[1]), "mode": mcfg.mode}
        done, params0 = 0, None
        latest = mgr.latest_step()
        if latest is not None:
            done, arrays, meta = mgr.restore(latest)
            saved_arch = meta.get("arch")
            if saved_arch is not None and saved_arch != arch:
                raise ValueError(
                    f"checkpoint in {ckpt_dir!r} was trained with "
                    f"{saved_arch}, current config is {arch}; use a fresh "
                    "checkpoint dir")
            params0 = dict(arrays)
        if done > mcfg.iterations:
            raise ValueError(
                f"checkpoint in {ckpt_dir!r} has {done} completed iterations "
                f"but nn.iteration.count is {mcfg.iterations}; use a fresh "
                "checkpoint dir to train a shorter run")
        if done >= mcfg.iterations and params0 is None:
            raise ValueError("nn.checkpoint.dir.path has no state yet "
                             "but nn.iteration.count is 0")
        params = params0  # already-complete resume: nothing left to train
        losses = np.zeros((0,))
        import dataclasses
        # align chunks to the validation grid so the recorded loss history
        # matches an unchunked run of the same config
        interval = max(mcfg.validation_interval, 1)
        ckpt_interval = max((ckpt_interval // interval) * interval, interval)
        while done < mcfg.iterations:
            chunk = min(ckpt_interval, mcfg.iterations - done)
            # fold progress into the seed: each chunk must continue the
            # PRNG stream, not replay the first chunk's shuffles
            ccfg = dataclasses.replace(mcfg, iterations=chunk,
                                       seed=mcfg.seed + done)
            params, chunk_losses = mlp.train(X, y, ccfg, X_val=Xv, y_val=yv,
                                             params0=params0)
            if chunk < interval and len(losses) and mcfg.mode == "batch":
                # batch mode records interval-end losses, so an unchunked run
                # never records the tail; incr/minibatch record epoch-start
                # samples ([::interval] from 0), so their tail entry matches
                chunk_losses = chunk_losses[:0]
            done += chunk
            params0 = {k: v.cpu().numpy() for k, v in params.items()}
            mgr.save(done, params0, {"iterations": done, "arch": arch})
            losses = np.concatenate([losses, chunk_losses])
        params = mlp.to_device(params)
    else:
        params, losses = mlp.train(X, y, mcfg, X_val=Xv, y_val=yv)
    od = cfg.field_delim_out
    lines = mlp.to_lines(params, od)
    artifacts.write_text_output(out_path, lines)
    model_path = cfg.get("nn.model.file.path")
    if model_path:
        with open(model_path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    import torch
    dev = params["W1"].device
    acc = float((mlp.predict(params, torch.from_numpy(X).to(dev))
                 .cpu().numpy() == y).mean())
    counters.set("NeuralNetwork", "trainAccuracyPct", int(round(acc * 100)))
    if len(losses):
        counters.set("NeuralNetwork", "finalLossE6",
                     int(round(float(losses[-1]) * 1e6)))
    counters.set("NeuralNetwork", "lossEvaluations", len(losses))
    return counters


@register("org.avenir.supv.NeuralNetworkPredictor", "neuralNetworkPredictor",
          dist="map")
def neural_network_predictor(cfg: Config, in_path: str, out_path: str) -> Counters:
    from ..nn import mlp
    counters = Counters()
    schema = _schema_path(cfg, "feature.schema.file.path")
    od = cfg.field_delim_out
    params = mlp.from_lines(
        artifacts.read_text_input(cfg.must_get("nn.model.file.path")), od)
    table = load_csv(in_path, schema, cfg.field_delim_regex, keep_raw=True)
    import torch
    X = torch.from_numpy(table.feature_matrix(dtype=np.float32)).to(
        params["W1"].device)
    pred = mlp.predict(params, X).cpu().numpy()
    probs = mlp.predict_proba(params, X).cpu().numpy()
    class_field = schema.class_attr_field
    values = class_field.cardinality or [str(i) for i in
                                         range(probs.shape[1])]
    lines = []
    for i, raw in enumerate(table.raw_rows):
        p = int(round(float(probs[i, pred[i]]) * 100))
        lines.append(od.join(raw + [values[pred[i]], str(p)]))
    artifacts.write_text_output(out_path, lines, role="m")
    if class_field.ordinal in table.columns:
        actual = np.asarray(table.class_codes())
        known = actual >= 0
        correct = int((pred[known] == actual[known]).sum())
        total = int(known.sum())
        counters.set("Validation", "Correct", correct)
        counters.set("Validation", "Incorrect", total - correct)
        if len(values) == 2:
            # export() owns the Accuracy/Precision/Recall counters
            cm = ConfusionMatrix(values[0], values[1])
            cm.report_batch(pred[known] == 1, actual[known] == 1,
                            actual[known] == 0)
            cm.export(counters)
        elif total:
            counters.set("Validation", "Accuracy",
                         int(100 * correct / total))
    return counters
