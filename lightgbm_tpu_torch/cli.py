"""The port's command line: ``python -m lightgbm_tpu_torch``.

A copy of the training half of ``lightgbm_tpu/cli.py`` (LightGBM's
``application.cpp``): ``key=value`` arguments and an optional
``config=<file>`` of ``key = value`` lines (``#`` starts a comment;
pairs on the command line win), dispatching the tasks ``train`` (with
``valid``, ``input_model``, ``snapshot_freq`` and
``is_provide_training_metric``), ``predict``, ``convert_model``,
``refit`` and ``save_binary``. Every task runs on the GPU unless
``device_type=cpu`` is given.

Usage:
    python -m lightgbm_tpu_torch config=train.conf [key=value ...]
    python -m lightgbm_tpu_torch task=train data=train.csv objective=binary
    python -m lightgbm_tpu_torch task=predict data=test.csv \
        input_model=LightGBM_model.txt

Subcommands: ``stats <file.jsonl | dir> [--fleet]`` (the telemetry
summary), ``trace <dir> [--out FILE]`` (Chrome trace JSON and critical
paths from the span events) and ``checkpoints <dir>`` (the snapshots and
whether a run can resume from them); they read the JAX package's files
too. ``serve <model | dir> [--device-type cuda|cpu] ...`` is the
JSON-lines inference daemon (``serve/daemon.py``; ``python -m
lightgbm_tpu_torch serve`` reaches it without importing torch until a
model loads). ``launch <nprocs> [--health-port P] -- <cmd...>`` is the
supervisor (``resilience/elastic.py``: a fleet of serve replicas, or a
supervised world of training ranks) and ``pipeline --workdir DIR
[--device-type cuda|cpu] ...`` the train -> publish -> serve loop
(``pipeline.py``); ``python -m lightgbm_tpu_torch launch`` and
``pipeline`` parse without importing torch. ``lint [--ir] [--strict]
...`` is the port's static analyzer (``analysis/cli.py``; ``python -m
lightgbm_tpu_torch lint`` imports no torch but under ``--ir``).

    python -m lightgbm_tpu_torch stats telemetry.jsonl
    python -m lightgbm_tpu_torch checkpoints ckpt/
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset, LightGBMError, _load_text_file
from .config import Config, resolve_params
from .engine import train as train_fn
from .log import log_info, log_warning

__all__ = ["main", "parse_args", "load_config_file"]

def load_config_file(path: str) -> Dict[str, str]:
    """The ``key = value`` pairs of a config file."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                log_warning(f"Unknown config line ignored: {line!r}")
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def parse_args(argv: List[str]) -> Dict[str, str]:
    """The parameters of a command line: the config file's pairs, then
    the command line's over them."""
    cli: Dict[str, str] = {}
    for a in argv:
        if "=" not in a:
            raise LightGBMError(f"Unknown argument (expected key=value): {a}")
        k, v = a.split("=", 1)
        cli[k.strip()] = v.strip()
    resolved = resolve_params(cli)
    conf_path = resolved.pop("config", None)
    params: Dict[str, str] = {}
    if conf_path:
        params.update(resolve_params(load_config_file(conf_path)))
    params.update(resolved)
    return params


def _load_dataset(params: Dict[str, Any], path: str,
                  reference: Optional[Dataset] = None) -> Dataset:
    return Dataset(path, params=params, reference=reference).construct()


def _model(cfg: Config) -> Booster:
    """The ``input_model`` on the task's device."""
    return Booster(model_file=cfg.input_model,
                   params={"device_type": cfg.device_type})


def _task_train(cfg: Config, params: Dict[str, Any]) -> None:
    if not cfg.data:
        raise LightGBMError("No training data: pass data=<file>")
    train_set = _load_dataset(params, cfg.data)
    valid_sets = [_load_dataset(params, v, reference=train_set)
                  for v in cfg.valid]
    valid_names = [f"valid_{i + 1}" for i in range(len(valid_sets))]

    callbacks: List[Any] = []
    if cfg.verbosity >= 1 and (valid_sets or cfg.is_provide_training_metric):
        callbacks.append(callback_mod.log_evaluation(
            period=max(1, cfg.metric_freq)))
    if cfg.snapshot_freq > 0:
        # the model every snapshot_freq iterations (GBDT::Train)
        out = cfg.output_model

        def _snapshot(env) -> None:
            it = env.iteration + 1
            if it % cfg.snapshot_freq == 0:
                env.model.save_model(f"{out}.snapshot_iter_{it}")

        _snapshot.order = 100
        callbacks.append(_snapshot)
    if cfg.is_provide_training_metric:
        valid_sets = [train_set] + valid_sets
        valid_names = ["training"] + valid_names

    booster = train_fn(
        params, train_set,
        num_boost_round=cfg.num_iterations,
        valid_sets=valid_sets, valid_names=valid_names,
        init_model=cfg.input_model or None,
        callbacks=callbacks)
    booster.save_model(cfg.output_model)
    log_info(f"Finished training; model saved to {cfg.output_model}")


def _task_predict(cfg: Config, params: Dict[str, Any]) -> None:
    if not cfg.input_model:
        raise LightGBMError("task=predict needs input_model=<model file>")
    if not cfg.data:
        raise LightGBMError("No data to predict: pass data=<file>")
    booster = _model(cfg)
    X, _, _, _ = _load_text_file(cfg.data, cfg)
    num_iteration = (cfg.num_iteration_predict
                     if cfg.num_iteration_predict > 0 else None)
    pred = booster.predict(
        X,
        start_iteration=cfg.start_iteration_predict,
        num_iteration=num_iteration,
        raw_score=cfg.predict_raw_score,
        pred_leaf=cfg.predict_leaf_index,
        pred_contrib=cfg.predict_contrib)
    pred = np.asarray(pred)
    if pred.ndim == 1:
        pred = pred[:, None]
    fmt = "%d" if cfg.predict_leaf_index else "%.18g"
    np.savetxt(cfg.output_result, pred, fmt=fmt, delimiter="\t")
    log_info(f"Finished prediction; results saved to {cfg.output_result}")


def _task_convert_model(cfg: Config, params: Dict[str, Any]) -> None:
    if not cfg.input_model:
        raise LightGBMError("task=convert_model needs input_model=<file>")
    if cfg.convert_model_language not in ("", "cpp"):
        raise LightGBMError(
            f"Unsupported convert_model_language: "
            f"{cfg.convert_model_language}")
    from .convert import model_to_if_else
    code = model_to_if_else(_model(cfg))
    with open(cfg.convert_model, "w") as f:
        f.write(code)
    log_info(f"Converted model saved to {cfg.convert_model}")


def _task_refit(cfg: Config, params: Dict[str, Any]) -> None:
    if not cfg.input_model:
        raise LightGBMError("task=refit needs input_model=<model file>")
    if not cfg.data:
        raise LightGBMError("No refit data: pass data=<file>")
    X, y, w, _ = _load_text_file(cfg.data, cfg)
    refitted = _model(cfg).refit(X, y, decay_rate=cfg.refit_decay_rate,
                                 weight=w)
    refitted.save_model(cfg.output_model)
    log_info(f"Finished refit; model saved to {cfg.output_model}")


def _task_save_binary(cfg: Config, params: Dict[str, Any]) -> None:
    if not cfg.data:
        raise LightGBMError("No data: pass data=<file>")
    out = cfg.data + ".bin"
    _load_dataset(params, cfg.data).save_binary(out)
    log_info(f"Binned dataset saved to {out}")


_STATS_HELP = """\
usage: python -m lightgbm_tpu_torch stats <file.jsonl | dir> [--fleet]

Fold a telemetry event stream (lightgbm_tpu_torch.telemetry(path)
callback / LIGHTGBM_TPU_TELEMETRY=<path>; either package's) into the
sorted per-phase summary table: wall time, recompiles, peak device
memory, fault events, final evals, the JAX package's serve and xla cost
rows when the file carries them, and a per-phase
total/count/mean/percent/skew breakdown.

A DIRECTORY summarizes every *.jsonl file inside (recursively, .rankN
suffixes included) with per-file provenance headers — the fleet's
telemetry/ directory is the expected shape. --fleet appends the
merged cross-process view: trainer iteration/compile totals, summed
serve traffic with worst-case p99, shed and restart totals.

exit codes:
  0  summary printed
  1  unreadable/malformed input, or no known events in it
"""

_CHECKPOINTS_HELP = """\
usage: python -m lightgbm_tpu_torch checkpoints <dir>

List every snapshot the checkpoint callback (of either package) wrote
into a directory, with validation status — the operator view for "can
this run resume, and from which iteration?".

exit codes:
  0  at least one valid (resumable) snapshot listed
  1  not a directory, no snapshots, or no valid snapshot
"""


def _summary_has_events(summary: Dict[str, Any]) -> bool:
    return bool(summary["iterations"] or summary.get("serve")
                or summary.get("publishes")
                or summary.get("compiles")
                or summary.get("fleet_events"))


def _task_stats(argv: List[str]) -> int:
    """``stats <file.jsonl | dir> [--fleet]``: fold one
    telemetry event stream — or a directory of them, one per fleet
    process — into the sorted summary tables; ``--fleet`` appends the
    merged cross-process view."""
    if argv and argv[0] in ("-h", "--help"):
        print(_STATS_HELP)
        return 0
    fleet = "--fleet" in argv
    argv = [a for a in argv if a != "--fleet"]
    if not argv:
        print("usage: python -m lightgbm_tpu_torch stats "
              "<file.jsonl | dir> [--fleet]", file=sys.stderr)
        return 1
    from .obs import render_stats_table, summarize_events
    path = argv[0]
    if os.path.isdir(path):
        from .obs import (merge_fleet_summaries, render_fleet_table,
                          summarize_directory)
        try:
            entries = summarize_directory(path)
        except OSError as e:
            print(f"[LightGBM-TPU] [Fatal] cannot read {path}: {e}",
                  file=sys.stderr)
            return 1
        except (ValueError, TypeError, AttributeError, KeyError) as e:
            print(f"[LightGBM-TPU] [Fatal] malformed telemetry under "
                  f"{path}: {e}", file=sys.stderr)
            return 1
        useful = [(rel, s) for rel, s in entries
                  if _summary_has_events(s)]
        if not useful:
            print(f"no telemetry events in any *.jsonl under {path}",
                  file=sys.stderr)
            return 1
        blocks = []
        for rel, summary in useful:
            blocks.append(f"== {rel} ==\n"
                          + render_stats_table(summary))
        if fleet:
            blocks.append(render_fleet_table(
                merge_fleet_summaries(useful)))
        print("\n\n".join(blocks))
        return 0
    try:
        summary = summarize_events(path)
    except OSError as e:
        print(f"[LightGBM-TPU] [Fatal] cannot read {path}: {e}",
              file=sys.stderr)
        return 1
    except (ValueError, TypeError, AttributeError, KeyError) as e:
        # malformed JSON line or structurally-wrong event object
        print(f"[LightGBM-TPU] [Fatal] malformed telemetry in {path}: "
              f"{e}", file=sys.stderr)
        return 1
    if not _summary_has_events(summary):
        print(f"no iteration, serve or publish events in {path}",
              file=sys.stderr)
        return 1
    print(render_stats_table(summary))
    if fleet:
        # --fleet on a single stream: the one-entry merged view (so
        # the flag is never silently ignored in scripts)
        from .obs import merge_fleet_summaries, render_fleet_table
        print()
        print(render_fleet_table(merge_fleet_summaries(
            [(os.path.basename(path), summary)])))
    return 0


def _task_checkpoints(argv: List[str]) -> int:
    """``checkpoints <dir>``: list every snapshot the
    resilience checkpoint callback wrote into a directory, with
    validation status — the operator view for "can this run resume,
    and from which iteration?"."""
    if argv and argv[0] in ("-h", "--help"):
        print(_CHECKPOINTS_HELP)
        return 0
    if not argv:
        print("usage: python -m lightgbm_tpu_torch checkpoints <dir>",
              file=sys.stderr)
        return 1
    directory = argv[0]
    if not os.path.isdir(directory):
        print(f"[LightGBM-TPU] [Fatal] not a directory: {directory}",
              file=sys.stderr)
        return 1
    from .resilience.checkpoint import list_snapshots
    rows = list_snapshots(directory)
    if not rows:
        print(f"no checkpoint snapshots in {directory}", file=sys.stderr)
        return 1
    import datetime as _dt
    print(f"{'iteration':>9s}  {'status':8s} {'trees':>6s} "
          f"{'size':>10s}  {'written':19s}  file")
    resumable = None
    for row in rows:
        when = _dt.datetime.fromtimestamp(
            row["mtime"]).strftime("%Y-%m-%d %H:%M:%S")
        if row["status"] == "ok":
            trees = str(row["num_trees"])
            resumable = row
        else:
            trees = "-"
        print(f"{row['iteration']:9d}  {row['status']:8s} {trees:>6s} "
              f"{row['bytes']:10d}  {when}  "
              f"{os.path.basename(row['path'])}")
        if row["status"] != "ok":
            print(f"           ^ {row['error']}")
    if resumable is not None:
        print(f"\nresume target: iteration {resumable['iteration']} "
              f"({os.path.basename(resumable['path'])})")
    else:
        print("\nno valid snapshot: this directory cannot be resumed "
              "from", file=sys.stderr)
        return 1
    return 0


_TASKS = {
    "train": _task_train,
    "refit": _task_refit,
    "refit_tree": _task_refit,
    "predict": _task_predict,
    "prediction": _task_predict,
    "test": _task_predict,
    "convert_model": _task_convert_model,
    "save_binary": _task_save_binary,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv in (["-h"], ["--help"]):
        print(__doc__)
        return 0
    if argv[0] == "stats":
        return _task_stats(argv[1:])
    if argv[0] == "checkpoints":
        return _task_checkpoints(argv[1:])
    if argv[0] == "trace":
        from .obs.trace import main as trace_main
        return trace_main(argv[1:])
    if argv[0] == "serve":
        from .serve.daemon import main as serve_main
        return serve_main(argv[1:])
    if argv[0] == "launch":
        from .resilience.elastic import main as launch_main
        return launch_main(argv[1:])
    if argv[0] == "pipeline":
        from .pipeline import main as pipeline_main
        return pipeline_main(argv[1:])
    if argv[0] == "lint":
        from .analysis.cli import main as lint_main
        return lint_main(argv[1:])
    try:
        params = parse_args(argv)
        cfg = Config.from_params(params)
        if cfg.num_machines > 1:
            # Network::Init (application.cpp): join the world of the
            # machine list before any device work
            from .parallel.distributed import init_distributed
            init_distributed(machines=cfg.machines or None,
                             machine_list_file=cfg.machine_list_file
                             or None, device_type=cfg.device_type)
        task = _TASKS.get(cfg.task)
        if task is None:
            raise LightGBMError(f"Unknown task: {cfg.task}")
        task(cfg, params)
    except (LightGBMError, ValueError, OSError) as e:
        print(f"[LightGBM-TPU] [Fatal] {e}", file=sys.stderr)
        return 1
    return 0
