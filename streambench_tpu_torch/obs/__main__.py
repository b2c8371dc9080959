"""Telemetry reporting CLI of the PyTorch port.

    python -m streambench_tpu_torch.obs report RUN/metrics.jsonl
    python -m streambench_tpu_torch.obs diff  A/metrics.jsonl B/metrics.jsonl
    python -m streambench_tpu_torch.obs attribution RUN/metrics.jsonl [B/metrics.jsonl]
    python -m streambench_tpu_torch.obs trace RUN/trace_1234.json
    python -m streambench_tpu_torch.obs trace writer=A/trace_1.json \
        replica=B/trace_2.json --merge --out merged_trace.json
    python -m streambench_tpu_torch.obs fleet writer=A/metrics.jsonl \
        replica=B/metrics.jsonl [--out fleet.jsonl]
    python -m streambench_tpu_torch.obs regress BASELINE.json CANDIDATE.json

``report`` renders one run's time series as a summary (throughput,
live-latency percentiles, backlog/watermark/RSS maxima, fault counters,
stage totals, annotations); ``diff`` lines two runs up with absolute and
relative deltas; ``attribution`` renders the per-window latency
attribution (obs.lifecycle: ingest/encode/fold/flush/sink segment
percentiles and shares), diffing A/B when a second path is given;
``trace`` validates a Chrome trace-event file (obs.spans) and prints a
per-span-name summary; ``regress`` compares two bench artifacts or
metrics journals under per-metric tolerances and exits non-zero on a
regression (the CI gate — ``--advisory`` reports without gating).
``--json`` emits the summary dict(s) instead, for harness consumption.
Rotated journals (``metrics.jsonl.1``) are stitched in automatically.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

try:
    import streambench_tpu_torch  # noqa: F401
except ModuleNotFoundError:
    # executed by file path (python .../streambench_tpu_torch/obs/
    # __main__.py) from a cwd where the package isn't importable: python
    # put obs/ on sys.path, not the repo root — self-locate it.
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))

from streambench_tpu_torch.obs.report import (
    load_records,
    render_attribution,
    render_attribution_diff,
    render_diff,
    render_report,
    render_serve,
    render_serve_diff,
    summarize,
    summarize_attribution,
    summarize_serve,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="streambench-obs")
    sub = p.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report", help="summarize one metrics.jsonl")
    rep.add_argument("path")
    rep.add_argument("--json", action="store_true",
                     help="emit the summary dict instead of text")
    dif = sub.add_parser("diff", help="diff two metrics.jsonl runs (B vs A)")
    dif.add_argument("path_a")
    dif.add_argument("path_b")
    dif.add_argument("--json", action="store_true",
                     help="emit both summary dicts instead of text")
    att = sub.add_parser(
        "attribution",
        help="per-window latency attribution (segment table; give a "
             "second path to diff B vs A)")
    att.add_argument("path")
    att.add_argument("path_b", nargs="?", default=None)
    att.add_argument("--json", action="store_true",
                     help="emit the attribution dict(s) instead of text")
    srv = sub.add_parser(
        "serve",
        help="reach serving-layer attribution (query segment table, "
             "contention ratio, slow-query log; give a second path to "
             "diff B vs A)")
    srv.add_argument("path")
    srv.add_argument("path_b", nargs="?", default=None)
    srv.add_argument("--json", action="store_true",
                     help="emit the serving dict(s) instead of text")
    trc = sub.add_parser(
        "trace", help="validate + summarize a Chrome trace-event file "
                      "(obs.spans trace_<run>.json); several paths + "
                      "--merge stitch one perfetto-loadable fleet "
                      "trace with a process_name lane per file")
    trc.add_argument("paths", nargs="+", metavar="path",
                     help="trace file(s); with --merge each may be "
                          "role=path to name its process lane")
    trc.add_argument("--merge", action="store_true",
                     help="stitch all inputs into one trace (clocks "
                          "aligned on each file's wall0_ms epoch)")
    trc.add_argument("--out", default=None,
                     help="where --merge writes the stitched trace "
                          "(default: merged_trace.json)")
    trc.add_argument("--json", action="store_true",
                     help="emit the summary dict instead of text")
    flt = sub.add_parser(
        "fleet", help="merge every role's metrics.jsonl into one "
                      "fleet.jsonl and render the per-role table "
                      "(ingest rate, qps, cache hits, staleness, "
                      "freshness hops, restarts)")
    flt.add_argument("paths", nargs="+", metavar="path",
                     help="role=metrics.jsonl specs, bare journal "
                          "paths (role inferred), or ONE fleet "
                          "directory to scan")
    flt.add_argument("--out", default=None,
                     help="write the merged attributed journal here "
                          "(default: no file, table only)")
    flt.add_argument("--json", action="store_true",
                     help="emit the summary dict instead of text")
    flt.add_argument("--watch", action="store_true",
                     help="re-render periodically (re-scanning a "
                          "directory spec, so replicas the autoscaler "
                          "spawns appear as they journal)")
    flt.add_argument("--interval-s", type=float, default=2.0,
                     help="--watch re-render period (default 2 s)")
    flt.add_argument("--iterations", type=int, default=0,
                     help="with --watch: stop after N renders "
                          "(0 = until interrupted; CI/tests bound it)")
    reg = sub.add_parser(
        "regress",
        help="compare candidate B against baseline A under per-metric "
             "tolerances; exit 1 on regression (CI gate)")
    reg.add_argument("path_a", help="baseline artifact or metrics.jsonl")
    reg.add_argument("path_b", help="candidate artifact or metrics.jsonl")
    reg.add_argument("--tol", action="append", default=[],
                     metavar="METRIC=FRAC",
                     help="override one metric's relative tolerance "
                          "(e.g. --tol catchup_events_per_s=0.3)")
    reg.add_argument("--advisory", action="store_true",
                     help="report regressions but always exit 0")
    reg.add_argument("--strict-missing", action="store_true",
                     help="count metrics missing from B as regressions")
    reg.add_argument("--json", action="store_true",
                     help="emit the comparison dict instead of text")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.cmd == "regress":
            from streambench_tpu_torch.obs.regress import run_cli

            return run_cli(args.path_a, args.path_b, tol_args=args.tol,
                           as_json=args.json, advisory=args.advisory,
                           strict_missing=args.strict_missing)
        if args.cmd == "trace":
            from streambench_tpu_torch.obs.spans import (
                render_trace_summary,
                summarize_trace,
                validate_chrome_trace,
            )

            if args.merge or len(args.paths) > 1:
                from streambench_tpu_torch.obs.fleet import (
                    merge_traces,
                    parse_role_spec,
                    trace_process_names,
                )

                if not args.merge:
                    print("error: several trace paths need --merge",
                          file=sys.stderr)
                    return 2
                inputs = [parse_role_spec(p) for p in args.paths]
                try:
                    doc = merge_traces(inputs)
                except (OSError, json.JSONDecodeError) as e:
                    print(f"error: {e}", file=sys.stderr)
                    return 2
                problems = validate_chrome_trace(doc)
                if problems:
                    print("error: merged trace failed validation:",
                          file=sys.stderr)
                    for pr in problems:
                        print(f"  {pr}", file=sys.stderr)
                    return 2
                out_path = args.out or "merged_trace.json"
                with open(out_path, "w", encoding="utf-8") as f:
                    json.dump(doc, f)
                s = summarize_trace(doc, path=out_path)
                s["processes"] = {str(pid): name for pid, name in
                                  sorted(trace_process_names(doc).items())}
                print(json.dumps(s) if args.json
                      else render_trace_summary(s)
                      + "\n  processes: "
                      + ", ".join(f"{pid}={name}" for pid, name in
                                  s["processes"].items()))
                return 0
            path = args.paths[0]
            with open(path, "r", encoding="utf-8") as f:
                try:
                    doc = json.load(f)
                except json.JSONDecodeError as e:
                    print(f"error: {path}: not JSON: {e}",
                          file=sys.stderr)
                    return 2
            problems = validate_chrome_trace(doc)
            if problems:
                print(f"error: {path}: not a loadable Chrome "
                      "trace:", file=sys.stderr)
                for pr in problems:
                    print(f"  {pr}", file=sys.stderr)
                return 2
            s = summarize_trace(doc, path=path)
            print(json.dumps(s) if args.json
                  else render_trace_summary(s))
            return 0
        if args.cmd == "fleet":
            from streambench_tpu_torch.obs.fleet import (
                FleetCollector,
                discover_roles,
                parse_role_spec,
                render_fleet,
                summarize_fleet,
            )

            import time as _time

            is_dir = (len(args.paths) == 1
                      and os.path.isdir(args.paths[0]))
            n = 0
            while True:
                # a directory spec re-scans each iteration: replicas
                # spawned mid-watch appear as soon as they journal
                if is_dir:
                    roles = discover_roles(args.paths[0])
                    if not roles and not args.watch:
                        print(f"error: no metrics.jsonl under "
                              f"{args.paths[0]}", file=sys.stderr)
                        return 2
                else:
                    roles = [parse_role_spec(p) for p in args.paths]
                coll = FleetCollector(roles, out_path=args.out)
                records = coll.collect()
                s = summarize_fleet(records,
                                    path=args.out or args.paths[0])
                s["sources"] = coll.sources
                print(json.dumps(s) if args.json else render_fleet(s),
                      flush=True)
                n += 1
                if not args.watch or (args.iterations
                                      and n >= args.iterations):
                    return 0
                try:
                    _time.sleep(args.interval_s)
                except KeyboardInterrupt:
                    return 0
        if args.cmd == "serve":
            a = summarize_serve(load_records(args.path),
                                path=args.path)
            if args.path_b:
                b = summarize_serve(load_records(args.path_b),
                                    path=args.path_b)
                print(json.dumps({"a": a, "b": b}) if args.json
                      else render_serve_diff(a, b))
            else:
                print(json.dumps(a) if args.json else render_serve(a))
            return 0
        if args.cmd == "report":
            s = summarize(load_records(args.path), path=args.path)
            print(json.dumps(s) if args.json else render_report(s))
        elif args.cmd == "attribution":
            a = summarize_attribution(load_records(args.path),
                                      path=args.path)
            if args.path_b:
                b = summarize_attribution(load_records(args.path_b),
                                          path=args.path_b)
                print(json.dumps({"a": a, "b": b}) if args.json
                      else render_attribution_diff(a, b))
            else:
                print(json.dumps(a) if args.json
                      else render_attribution(a))
        else:
            a = summarize(load_records(args.path_a), path=args.path_a)
            b = summarize(load_records(args.path_b), path=args.path_b)
            print(json.dumps({"a": a, "b": b}) if args.json
                  else render_diff(a, b))
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
