"""Telemetry reporting CLI of the PyTorch port.

    python -m streambench_tpu_torch.obs report RUN/metrics.jsonl
    python -m streambench_tpu_torch.obs diff  A/metrics.jsonl B/metrics.jsonl
    python -m streambench_tpu_torch.obs attribution RUN/metrics.jsonl [B/metrics.jsonl]
    python -m streambench_tpu_torch.obs trace RUN/trace_1234.json
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

The JAX package's ``serve`` (reach serving attribution), ``fleet`` and
``trace --merge`` need surfaces the port does not have yet: they exit 2
with "not ported".
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
    summarize,
    summarize_attribution,
)

#: subcommands of the JAX package's CLI whose surfaces are not ported
NOT_PORTED = ("serve", "fleet")


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
    trc = sub.add_parser(
        "trace", help="validate + summarize a Chrome trace-event file "
                      "(obs.spans trace_<run>.json)")
    trc.add_argument("paths", nargs="+", metavar="path",
                     help="trace file (stitching several is not ported)")
    trc.add_argument("--merge", action="store_true",
                     help=argparse.SUPPRESS)
    trc.add_argument("--out", default=None, help=argparse.SUPPRESS)
    trc.add_argument("--json", action="store_true",
                     help="emit the summary dict instead of text")
    for name in NOT_PORTED:
        np_ = sub.add_parser(name, help=argparse.SUPPRESS)
        np_.add_argument("rest", nargs="*")
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
                print("error: stitching several traces (trace --merge) "
                      "is not ported to the PyTorch package yet",
                      file=sys.stderr)
                return 2
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
        if args.cmd in NOT_PORTED:
            print(f"error: obs {args.cmd} is not ported to the PyTorch "
                  "package yet", file=sys.stderr)
            return 2
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
