"""shifu-tpu-torch CLI — the port's counterpart of ``shifu_tpu.cli``.

The port carries every model-set command of the reference but ``lint``
(ROADMAP Queue 1 item 13, which raises ``NotImplementedError``): the
offline path ``new → init → stats → norm → varselect → train →
posttrain → eval`` of a GBT/RF/DT/NN/LR model set, serving, the
continual ``refresh`` loop (a drift, quality or schedule trigger, a warm
retrain on the new data window, the holdout AUC gate, the promotion into
``serving/serving.json``, probation and rollback: its appended GBT trees
build their histograms with the ``hist`` kernel, and the restored
forest's replay and the gate's scores walk ``tree_traverse`` on the
card), and the commands around it — ``export``, ``encode``, ``combo``,
``convert``,
``analysis`` (``-fi``, and ``--telemetry`` / ``--timeline`` /
``--utilization`` / ``--aggregate`` over the trace files), ``monitor``,
``test`` and the version commands ``save``, ``switch``, ``history``,
``show``, ``delete`` and ``cp``.  Every subcommand takes ``--telemetry``
(spans, counters, drift and kernel costs to
``<modelset>/telemetry/trace.jsonl``) and ``--profile [DIR]`` (a
``torch.profiler`` Chrome trace a step).  ``-Dkey=value``
properties go to the Environment tier as in the reference; ``--device``
picks where a step that computes runs (default ``cuda``; ``cpu`` runs the
plain PyTorch versions).  ``new``, ``init``, ``norm``, ``export``,
``convert``, ``analysis``, ``test`` and the version commands run on the
host, and so do eval's ``-new``, ``-delete``, ``-list`` and ``-norm``;
eval's, posttrain's, encode's and combo's scoring walks the forests with
the ``tree_traverse`` kernel on the card (encode: its node-index walk,
one launch a chunk), and varselect's SE/ST, GENETIC and ``-recursive``
train or run nets there.

    python -m shifu_tpu_torch.cli --dir <base> new <name> [-t <alg>] [-m <text>]
    python -m shifu_tpu_torch.cli --dir <modelset> init [-model]
    python -m shifu_tpu_torch.cli --dir <modelset> stats [-correlation] [-psi] [-rebin [-vars A,B] [-ivr R] [-bic N]] [--device cpu]
    python -m shifu_tpu_torch.cli --dir <modelset> norm [-shuffle]
    python -m shifu_tpu_torch.cli --dir <modelset> varselect [-list|-reset|-recover|-autofilter|-recoverauto|-recursive N] [--device cpu]
    python -m shifu_tpu_torch.cli --dir <modelset> train [-dry] [-resume] [--device cpu]
    python -m shifu_tpu_torch.cli --dir <modelset> posttrain [--device cpu]
    python -m shifu_tpu_torch.cli --dir <modelset> eval -new <evalset>
    python -m shifu_tpu_torch.cli --dir <modelset> eval [-run [<evalset>]] [--device cpu]
    python -m shifu_tpu_torch.cli --dir <modelset> eval -score [<evalset>] [-nosort]
    python -m shifu_tpu_torch.cli --dir <modelset> export [pmml|baggingpmml|bagging|columnstats|woemapping|corr|spec] [-c]
    python -m shifu_tpu_torch.cli --dir <modelset> encode [-evalset <evalset>] [-ref <dir>] [--device cpu]
    python -m shifu_tpu_torch.cli --dir <modelset> combo new -alg LR:GBT
    python -m shifu_tpu_torch.cli --dir <modelset> combo init|run|eval [-resume] [--device cpu]
    python -m shifu_tpu_torch.cli --dir <modelset> convert [-tozipb|-tob]
    python -m shifu_tpu_torch.cli --dir <modelset> analysis -fi <model file>
    python -m shifu_tpu_torch.cli --dir <modelset> analysis --telemetry [--utilization | --timeline OUT.json] [--aggregate DIR...]
    python -m shifu_tpu_torch.cli --dir <modelset> monitor [--once [--json]] [--interval S] [--aggregate DIR...]
    python -m shifu_tpu_torch.cli --dir <modelset> test [-filter [<evalset>]]
    python -m shifu_tpu_torch.cli --dir <modelset> save [<name>] | switch <name> | history | show | delete <name> | cp <dir>
    python -m shifu_tpu_torch.cli --dir <modelset> serve [--port N] [--replicas N]
    python -m shifu_tpu_torch.cli --dir <modelset> serve --selfcheck 4 --device cpu
    python -m shifu_tpu_torch.cli --dir <modelset> refresh [--daemon] [--poll S] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

from .config import environment


def _split_props(argv: List[str]) -> List[str]:
    """Pull ``-Dk=v`` pairs out of argv into Environment, return the rest."""
    rest = []
    for a in argv:
        if a.startswith("-D") and "=" in a:
            k, _, v = a[2:].partition("=")
            environment.set_property(k, v)
        else:
            rest.append(a)
    return rest


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="shifu-tpu-torch",
        description="PyTorch/CUDA port of shifu-tpu (new, init, stats, "
        "norm, varselect, GBT/RF/DT/NN/LR train, posttrain, eval, export, "
        "encode, combo, convert, analysis, monitor, test, version "
        "commands, serve, refresh)")
    p.add_argument("--dir", default=".", help="model-set directory (default: cwd)")
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("new", help="create a new model-set scaffold")
    sp.add_argument("name")
    sp.add_argument("--alg", "-t", default="NN", dest="alg",
                    help="NN|LR|GBT|RF|DT|WDL|SVM (reference `new -t`)")
    sp.add_argument("-m", dest="description", default=None,
                    help="model-set description (reference `new -m`)")

    sp = sub.add_parser("init",
                        help="build the initial ColumnConfig.json from the "
                        "header, typing columns from a sample")
    sp.add_argument("-model", dest="init_model", action="store_true",
                    help="fill the algorithm's default train#params into "
                    "ModelConfig.json (reference `init -model`)")

    sp = sub.add_parser("stats", help="per-column stats + binning (fine "
                        "histograms on the device; +psi/correlation/rebin)")
    sp.add_argument("-correlation", "-c", dest="correlation",
                    action="store_true",
                    help="pairwise-complete Pearson matrix of every "
                    "candidate column -> correlation.csv")
    sp.add_argument("-psi", dest="psi", action="store_true",
                    help="PSI over the units of stats.psiColumnName")
    sp.add_argument("-rebin", dest="rebin", action="store_true",
                    help="merge adjacent bins by IV (reference -rebin)")
    sp.add_argument("-vars", dest="rebin_vars", metavar="A,B",
                    help="rebin only these columns (reference -vars)")
    sp.add_argument("-ivr", dest="rebin_ivr", type=float, default=None,
                    help="rebin IV keep ratio (reference -ivr)")
    sp.add_argument("-bic", dest="rebin_bic", type=int, default=None,
                    help="rebin minimum bin instance count (reference -bic)")
    _device_arg(sp)

    sp = sub.add_parser("norm", aliases=["normalize", "transform"],
                        help="normalize the training data into the norm "
                        "and clean (wire) planes, on the host")
    sp.add_argument("-shuffle", dest="shuffle", action="store_true")

    sp = sub.add_parser("varselect", aliases=["varsel"],
                        help="variable selection (KS/IV/MIX/PARETO/FI from "
                        "the stats; SE/ST sensitivity of the trained net "
                        "and the GENETIC wrapper search on the device)")
    sp.add_argument("-list", dest="list", action="store_true")
    sp.add_argument("-reset", dest="reset", action="store_true")
    sp.add_argument("-recover", dest="recover", action="store_true")
    sp.add_argument("-recursive", dest="recursive", type=int, default=1,
                    metavar="N", help="SE/ST wrapper rounds: each round "
                    "re-norms + retrains on the current selection, then "
                    "re-scores sensitivity")
    sp.add_argument("-autofilter", dest="autofilter", action="store_true",
                    help="apply only the missing-rate/KS/IV/correlation "
                    "auto filter to the current selection")
    sp.add_argument("-recoverauto", dest="recoverauto", action="store_true",
                    help="restore variables removed by the last -autofilter")
    _device_arg(sp)

    sp = sub.add_parser("posttrain", help="bin-average scores and feature "
                        "importance (scoring on the device)")
    _device_arg(sp)

    sp = sub.add_parser("eval", help="evaluate the models on eval sets "
                        "(scoring on the device)")
    sp.add_argument("-run", dest="run_eval", metavar="EVALSET", nargs="?",
                    const="")
    sp.add_argument("-score", dest="score", metavar="EVALSET", nargs="?",
                    const="")
    sp.add_argument("-nosort", dest="nosort", action="store_true",
                    help="-score: keep the input row order (default sorts "
                    "the score file by the selected score)")
    sp.add_argument("-perf", dest="perf", metavar="EVALSET", nargs="?",
                    const="")
    sp.add_argument("-confmat", dest="confmat", metavar="EVALSET",
                    nargs="?", const="")
    sp.add_argument("-norm", dest="norm_eval", metavar="EVALSET", nargs="?",
                    const="")
    sp.add_argument("-new", dest="new_eval", metavar="EVALSET")
    sp.add_argument("-delete", dest="delete_eval", metavar="EVALSET")
    sp.add_argument("-list", dest="list", action="store_true")
    _device_arg(sp)

    sp = sub.add_parser("serve", help="online scoring server: the trained "
                        "ensemble pinned on the device behind a padded-"
                        "bucket micro-batcher, one captured CUDA graph a "
                        "rung (knobs: -Dshifu.serve.buckets, "
                        "-Dshifu.serve.maxDelayMs, "
                        "-Dshifu.serve.traceSampleRate per-request "
                        "tracing, -Dshifu.serve.sloP99Ms / "
                        "-Dshifu.serve.sloAvailability SLO objectives, "
                        "-Dshifu.serve.maxQueueRows / "
                        "-Dshifu.serve.requestDeadlineMs overload "
                        "control, -Dshifu.scorelog.sampleRate the "
                        "quality plane; GET /slo, GET /quality, POST "
                        "/outcome, POST /swap; --replicas N a fleet)")
    sp.add_argument("--port", dest="serve_port", type=int, default=8188,
                    help="HTTP port for POST /score + GET /healthz "
                    "(default 8188; 0 binds an ephemeral port)")
    sp.add_argument("--max-delay-ms", dest="serve_max_delay_ms",
                    type=float, default=None, metavar="MS",
                    help="deadline flush bound (overrides "
                    "-Dshifu.serve.maxDelayMs; default 2)")
    sp.add_argument("--selfcheck", dest="serve_selfcheck", type=int,
                    nargs="?", const=8, default=0, metavar="N",
                    help="score N synthetic rows in-process and exit")
    sp.add_argument("--replicas", dest="serve_replicas", type=int,
                    default=1, metavar="N",
                    help="fleet mode: spawn N serve workers (each its own "
                    "process on --device) behind a health-/SLO-aware "
                    "routing front on --port — POST /swap coordinates a "
                    "fleet-wide hot-swap with no mixed-model window "
                    "(knobs: -Dshifu.serve.fleetPollMs health-poll "
                    "cadence, -Dshifu.serve.fleetStaleS stale-replica "
                    "cutoff, -Dshifu.serve.canaryFrac canary commit "
                    "slice, -Dshifu.serve.retryBudgetFrac, "
                    "-Dshifu.serve.hedgeMs, "
                    "-Dshifu.serve.breakerFailures)")
    # internal fleet-worker flags (run_fleet passes them when spawning)
    sp.add_argument("--replica", dest="serve_replica", default=None,
                    help=argparse.SUPPRESS)
    sp.add_argument("--announce", dest="serve_announce", default=None,
                    help=argparse.SUPPRESS)
    _device_arg(sp)

    sp = sub.add_parser("refresh", help="continual refresh: drift-gated "
                        "warm retrain -> AUC-gated hot-swap promotion -> "
                        "SLO-observed probation with automatic rollback "
                        "(knobs: -Dshifu.refresh.psiThreshold, "
                        "-Dshifu.refresh.intervalS, "
                        "-Dshifu.refresh.cooldownS, "
                        "-Dshifu.refresh.minAucDelta, "
                        "-Dshifu.refresh.probationS, "
                        "-Dshifu.refresh.units, "
                        "-Dshifu.refresh.canaryRows; one cycle attempt by "
                        "default)")
    sp.add_argument("--daemon", dest="refresh_daemon", action="store_true",
                    help="stay resident: poll the drift artifact and the "
                    "schedule until interrupted")
    sp.add_argument("--poll", dest="refresh_poll", type=float,
                    default=2.0, metavar="S",
                    help="seconds between controller ticks (default 2)")
    _device_arg(sp)

    sp = sub.add_parser("lint", help="the reference's AST convention "
                        "checker; not yet ported (ROADMAP Queue 1 item "
                        "13): raises NotImplementedError, whatever its "
                        "arguments")

    sp = sub.add_parser("export", help="export the models and stats "
                        "(pmml|baggingpmml|bagging|columnstats|woemapping|"
                        "woe|corr|spec), on the host")
    sp.add_argument("type_pos", nargs="?", default=None, metavar="TYPE",
                    help="same as -t (`export pmml`)")
    sp.add_argument("-t", "--type", default="pmml")
    sp.add_argument("-c", dest="concise", action="store_true",
                    help="concise PMML: trim per-bin stats extensions "
                    "(reference `export -c`)")

    sp = sub.add_parser("encode", help="encode a dataset by the tree-leaf "
                        "index of every tree (the forest walks on the "
                        "device)")
    sp.add_argument("-evalset", dest="evalset", default=None)
    sp.add_argument("-ref", dest="ref_model", default=None, metavar="DIR",
                    help="encode with the tree model of another model-set "
                    "dir (reference ENCODE_REF_MODEL)")
    _device_arg(sp)

    sp = sub.add_parser("combo", help="multi-algorithm ensemble (members "
                        "train and score on the device)")
    sp.add_argument("action", choices=["new", "init", "run", "eval"])
    sp.add_argument("-resume", dest="resume", action="store_true",
                    help="skip members already trained")
    sp.add_argument("-alg", dest="algs", default=None,
                    help="colon-separated list, e.g. NN:GBT:LR")
    _device_arg(sp)

    sp = sub.add_parser("convert", help="convert model files npz <-> "
                        "JSON, on the host")
    sp.add_argument("-tozipb", dest="tozipb", action="store_true")
    sp.add_argument("-tob", "-totreeb", dest="tob", action="store_true",
                    help="(reference TO_TREEB)")

    sp = sub.add_parser("analysis", help="model spec analysis (-fi MODEL: "
                        "tree feature importance; --telemetry: render the "
                        "last run's span/metric trace; --telemetry "
                        "--timeline OUT: a Chrome/Perfetto trace_event "
                        "timeline; --telemetry --utilization: the kernel "
                        "cost / roofline report), on the host")
    sp.add_argument("-fi", dest="fi_model", metavar="MODELPATH")
    sp.add_argument("-telemetry", "--telemetry", dest="telemetry_report",
                    action="store_true",
                    help="render <modelset>/telemetry/trace.jsonl as a "
                    "per-step span tree with self-time and rows/sec")
    sp.add_argument("-timeline", "--timeline", dest="timeline_out",
                    metavar="OUT.json", default=None,
                    help="with --telemetry: convert the trace to Chrome "
                    "trace_event JSON")
    sp.add_argument("-utilization", "--utilization", dest="utilization",
                    action="store_true",
                    help="with --telemetry: join the hand kernels' cost "
                    "records against span wall times — achieved bytes/s "
                    "and operations/s against the card's peak (override: "
                    "SHIFU_TPU_PEAK_FLOPS / SHIFU_TPU_PEAK_BW)")
    sp.add_argument("-aggregate", "--aggregate", dest="analysis_aggregate",
                    nargs="+", metavar="DIR", default=None,
                    help="with --telemetry [--timeline]: merge the "
                    "telemetry dirs of N processes (replaces --dir)")

    sp = sub.add_parser("monitor", help="live health monitor: tail "
                        "<modelset>/telemetry/health/ heartbeats")
    sp.add_argument("--interval", dest="monitor_interval", type=float,
                    default=2.0, metavar="S",
                    help="seconds between frames (default 2)")
    sp.add_argument("--once", dest="monitor_once", action="store_true",
                    help="render one frame and exit")
    sp.add_argument("--json", dest="monitor_json", action="store_true",
                    help="with --once: one JSON document; exit 0 healthy, "
                    "3 when any process is stalled or stale")
    sp.add_argument("--aggregate", dest="monitor_aggregate", nargs="+",
                    metavar="DIR", default=None,
                    help="merge the health planes of N process telemetry "
                    "dirs (replaces --dir)")

    sp = sub.add_parser("test", help="pipeline smoke test on a data "
                        "sample, on the host")
    sp.add_argument("-filter", dest="filter_target", nargs="?", const="",
                    default=None, metavar="EVALSET",
                    help="no value = training set, '*' = all sets, a name "
                    "= that eval set")

    sp = sub.add_parser("save", help="snapshot model-set version")
    sp.add_argument("name", nargs="?", default=None)
    sp = sub.add_parser("switch", help="restore a saved model-set version")
    sp.add_argument("name")
    sub.add_parser("history", help="list saved model-set versions")
    sub.add_parser("show", help="print the current model-set version")
    sp = sub.add_parser("delete", help="delete a saved model-set version")
    sp.add_argument("name")
    sp = sub.add_parser("cp", help="clone this model set's configs into a "
                        "new scaffold dir")
    sp.add_argument("dest")

    tp = sub.add_parser("train", help="train the model set from the "
                        "norm step's planes (resident GBT, RF and DT from "
                        "the clean plane, NN and LR from the norm plane)")
    tp.add_argument("-dry", dest="dry", action="store_true",
                    help="validate the config and log the plan; train "
                    "nothing")
    tp.add_argument("-resume", dest="resume", action="store_true",
                    help="continue from the trainer checkpoint")
    tp.add_argument("-shuffle", dest="shuffle", action="store_true",
                    help="NN/LR: permute the rows (fixed seed) before "
                    "training")
    _device_arg(tp)

    # telemetry/profiling on every step: --telemetry records the span /
    # metric trace for this run (same as SHIFU_TPU_TELEMETRY=1);
    # --profile [DIR] writes a torch.profiler Chrome trace a step (same as
    # -Dshifu.profile=DIR)
    seen = set()                        # aliases share one parser object
    for name, spx in sub.choices.items():
        if id(spx) in seen:
            continue
        seen.add(id(spx))
        spx.add_argument("--profile", dest="profile_dir", nargs="?",
                         const="profile", default=None, metavar="DIR",
                         help="write a torch.profiler trace under DIR "
                         "(default ./profile)")
        if name != "analysis":          # analysis --telemetry = the report
            spx.add_argument("--telemetry", dest="telemetry",
                             action="store_true",
                             help="record span/metric telemetry to "
                             "<modelset>/telemetry/trace.jsonl")
    return p


def _device_arg(sp) -> None:
    sp.add_argument("--device", dest="device", choices=("cuda", "cpu"),
                    default="cuda",
                    help="where the port runs (default cuda; raises when "
                    "CUDA is absent)")


def main(argv: Optional[List[str]] = None) -> int:
    argv = _split_props(list(argv if argv is not None else sys.argv[1:]))
    parser = build_parser()
    args, rest = parser.parse_known_args(argv)
    if rest and args.command != "lint":
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    logging.basicConfig(level=logging.DEBUG if args.verbose
                        else logging.WARNING)
    if getattr(args, "telemetry", False):
        from . import obs
        obs.set_enabled(True)
    if getattr(args, "profile_dir", None):
        environment.set_property("shifu.profile", args.profile_dir)
    if args.command == "new":
        from .pipeline.create import create_new_model
        create_new_model(args.name, base_dir=args.dir, algorithm=args.alg,
                         description=args.description)
        return 0
    if args.command == "init":
        from .pipeline.create import InitProcessor, check_algorithm_param
        if args.init_model:
            return check_algorithm_param(args.dir)
        return InitProcessor(args.dir).run()
    if args.command == "stats":
        from .pipeline.stats import StatsProcessor
        params = {k: getattr(args, k) for k in (
            "correlation", "psi", "rebin", "rebin_vars", "rebin_ivr",
            "rebin_bic")}
        return StatsProcessor(args.dir, params=params,
                              device=args.device).run()
    if args.command in ("norm", "normalize", "transform"):
        from .pipeline.norm import NormalizeProcessor
        return NormalizeProcessor(args.dir,
                                  params={"shuffle": args.shuffle}).run()
    if args.command in ("varselect", "varsel"):
        from .pipeline.varselect import VarSelectProcessor
        params = {k: getattr(args, k) for k in (
            "list", "reset", "recover", "recursive", "autofilter",
            "recoverauto")}
        return VarSelectProcessor(args.dir, params=params,
                                  device=args.device).run()
    if args.command == "posttrain":
        from .pipeline.posttrain import PostTrainProcessor
        return PostTrainProcessor(args.dir, device=args.device).run()
    if args.command == "eval":
        from .pipeline.evaluate import EvalProcessor
        params = {k: getattr(args, k) for k in (
            "run_eval", "score", "nosort", "perf", "confmat", "norm_eval",
            "new_eval", "delete_eval", "list")}
        return EvalProcessor(args.dir, params=params,
                             device=args.device).run()
    if args.command == "serve":
        if args.serve_replicas > 1:
            from .serve.router import run_fleet
            return run_fleet(args.dir, replicas=args.serve_replicas,
                             port=args.serve_port,
                             max_delay_ms=args.serve_max_delay_ms,
                             device=args.device)
        from .serve.server import run_serve
        return run_serve(args.dir, port=args.serve_port,
                         selfcheck=args.serve_selfcheck,
                         max_delay_ms=args.serve_max_delay_ms,
                         replica=args.serve_replica,
                         announce=args.serve_announce,
                         device=args.device)
    if args.command == "train":
        from .pipeline.train import TrainProcessor
        return TrainProcessor(args.dir, params={"resume": args.resume,
                                                "shuffle": args.shuffle,
                                                "dry": args.dry},
                              device=args.device).run()
    if args.command == "refresh":
        from .pipeline.refresh import RefreshProcessor
        return RefreshProcessor(args.dir, params={
            "daemon": args.refresh_daemon, "poll": args.refresh_poll},
            device=args.device).run()
    if args.command == "lint":
        raise NotImplementedError(
            "lint is not yet ported to shifu_tpu_torch (ROADMAP Queue 1 "
            "item 13: its rules are written for JAX idioms and need "
            "retargeting) — run `python -m shifu_tpu.cli lint`")
    return _aux_command(args)


def _aux_command(args) -> int:
    """The commands around the offline path: export, encode, combo,
    convert, analysis, test and the version commands."""
    cmd = args.command
    if cmd == "export":
        from .pipeline.export import ExportProcessor
        if args.type_pos:
            args.type = args.type_pos
        return ExportProcessor(args.dir, params={
            "type": args.type, "concise": args.concise}).run()
    if cmd == "encode":
        from .pipeline.encode import EncodeProcessor
        return EncodeProcessor(args.dir, params={
            "evalset": args.evalset, "ref_model": args.ref_model},
            device=args.device).run()
    if cmd == "combo":
        from .pipeline.combo import run_combo
        return run_combo(args.dir, args.action, args.algs,
                         resume=args.resume, device=args.device)
    if cmd == "convert":
        from .pipeline.convert import run_convert
        return run_convert(args.dir, {"tozipb": args.tozipb,
                                      "tob": args.tob})
    if cmd == "analysis":
        if args.telemetry_report or args.utilization:
            return _render_telemetry(args)
        from .pipeline.analysis import analyze_model_fi
        return analyze_model_fi(args.fi_model)
    if cmd == "monitor":
        from .obs.monitor import run_monitor
        return run_monitor(args.dir, interval_s=args.monitor_interval,
                           once=args.monitor_once,
                           json_mode=args.monitor_json,
                           aggregate_dirs=args.monitor_aggregate)
    if cmd == "test":
        from .pipeline.smoke import SmokeTestProcessor
        return SmokeTestProcessor(args.dir, params={
            "filter_target": args.filter_target}).run()
    from .pipeline import manage
    if cmd == "save":
        return manage.save_version(args.dir, args.name)
    if cmd == "switch":
        return manage.switch_version(args.dir, args.name)
    if cmd == "history":
        return manage.show_history(args.dir)
    if cmd == "show":
        return manage.show_current(args.dir)
    if cmd == "delete":
        return manage.delete_version(args.dir, args.name)
    if cmd == "cp":
        return manage.copy_model_set(args.dir, args.dest)
    raise ValueError(f"unknown command {cmd!r}")


def _render_telemetry(args) -> int:
    """``analysis --telemetry [--utilization | --timeline OUT]
    [--aggregate DIR...]``: the reference's renders of the trace files."""
    agg = args.analysis_aggregate
    if args.utilization:
        from .obs.utilization import render_utilization
        print(render_utilization(args.dir))
        return 0
    if args.timeline_out:
        from .obs.report import NO_TELEMETRY_HINT
        from .obs.timeline import export_merged_timeline, export_timeline
        skipped: list = []
        if agg:
            out = export_merged_timeline(agg, args.timeline_out,
                                         skipped=skipped)
        else:
            out = export_timeline(args.dir, args.timeline_out,
                                  skipped=skipped)
        if out is None:
            print(NO_TELEMETRY_HINT)
        else:
            print(f"timeline -> {out}  (load in chrome://tracing or "
                  "https://ui.perfetto.dev)")
            if skipped:
                print(f"warning: {len(skipped)} torn trace line(s) "
                      "skipped (crashed run mid-write?)")
        return 0
    if agg:
        from .obs.report import render_telemetry_merged
        print(render_telemetry_merged(agg))
        return 0
    from .obs.report import render_telemetry
    print(render_telemetry(args.dir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
