"""The measured method table: the four counting arms of ``apply_count``.

The port of the tumbling part of ``streambench_tpu/ops/methodbench.py``.
It times ``windowcount.apply_count`` per method at one geometry (C
campaigns, W ring slots, B rows) on a synthetic batch, after checking
that every arm it times gives the same counts, and caches the table.
The arms are ``scatter`` (``index_add_``, the plain version), ``kernel``
(K1), and the reference's ``onehot`` and ``matmul`` as torch ops.  An
arm whose operand would not fit (``onehot``'s ``[B, C*W]`` mask and
``matmul``'s ``[B, C]`` one-hots at config #5's C = 1e6 run to tens of
GB) is skipped and recorded as skipped.

The table reports; it does not switch the engine, whose method on the
card stays K1 (``engine.pipeline.default_method``).  The same cache file
carries the device-decode A/B winner under ``<device type>/devdecode``
(``ops.devdecode.auto_enabled``).

The cache is one JSON file of the port's own
(``$STREAMBENCH_TORCH_METHOD_CACHE``, default
``~/.cache/streambench_tpu_torch/method_bench.json``), keyed by the torch
device type and the campaign count's power-of-two bucket
(``cuda/C128``), so the two packages never read each other's winners.

    python -m streambench_tpu_torch.ops.methodbench [--device cuda|cpu]
        [--campaigns C] [--window-slots W] [--batch B] [--smoke]
        [--no-record]

On the card every arm is timed with CUDA events; on the CPU (only when
asked for, as the tests do) with the host clock.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

METHODS = ("scatter", "kernel", "onehot", "matmul")
# Operand bytes an arm may allocate per call before the table skips it.
MAX_OPERAND_BYTES = 2 << 30
_DEFAULT_CACHE = os.path.join(
    os.path.expanduser("~"), ".cache", "streambench_tpu_torch",
    "method_bench.json")

# in-process memo: (path, mtime) -> parsed cache
_memo: tuple[str, float, dict] | None = None


def cache_path() -> str:
    return os.environ.get("STREAMBENCH_TORCH_METHOD_CACHE", _DEFAULT_CACHE)


def _load_cache() -> dict:
    global _memo
    path = cache_path()
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return {}
    if _memo is not None and _memo[0] == path and _memo[1] == mtime:
        return _memo[2]
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        if not isinstance(data, dict):
            data = {}
    except (OSError, ValueError):
        data = {}
    _memo = (path, mtime, data)
    return data


def record(key: str, value: dict) -> None:
    """Merge one measurement under ``key`` (atomic rewrite)."""
    global _memo
    path = cache_path()
    data = dict(_load_cache())
    data[key] = value
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    _memo = None


def cached_value(key: str) -> dict | None:
    v = _load_cache().get(key)
    return v if isinstance(v, dict) else None


def bucket(num_campaigns: int) -> int:
    """Pow2 bucket a geometry's campaign axis (the arms' trade-off moves
    with C: the one-hot operands scale with it)."""
    return 1 << max((max(int(num_campaigns), 1) - 1).bit_length(), 0)


def method_key(device_type: str, num_campaigns: int) -> str:
    return f"{device_type}/C{bucket(num_campaigns)}"


def cached_winner(device_type: str, num_campaigns: int | None) -> str | None:
    """The measured winner for this device type + campaign bucket, or
    None when nothing comparable was measured.  Only an exact bucket hit
    is trusted: a winner measured at C = 128 says nothing about C =
    1e6."""
    if num_campaigns is None:
        return None
    entry = cached_value(method_key(device_type, int(num_campaigns)))
    if entry is None:
        return None
    winner = entry.get("winner")
    return winner if winner in METHODS else None


def operand_bytes(method: str, B: int, C: int, W: int) -> int:
    """Bytes of the temporaries one ``apply_count`` call of ``method``
    allocates beyond its inputs and the ``[C, W]`` plane."""
    if method == "onehot":
        return B * C * W * (1 + 4) + C * W * 8   # bool mask, float32 copy
    if method == "matmul":
        return 4 * B * (C + W) + B * (C + W) + 4 * C * W
    if method == "scatter":
        return 4 * (C * W + 1) + 8 * B         # the pad-cell plane, flat
    return 0                                   # K1 allocates nothing


# ----------------------------------------------------------------------
def measure_methods(num_campaigns: int = 100, window_slots: int = 16,
                    batch_size: int = 8192, iters: int = 20,
                    device: str = "cuda",
                    time_budget_s: float = 5.0, seed: int = 0,
                    max_operand_bytes: int = MAX_OPERAND_BYTES) -> dict:
    """Time ``apply_count`` per method at one geometry.

    A synthetic batch of ``B`` rows: uniform campaigns and slots, every
    row counted (the worst case for all arms alike).  Each arm first
    counts the batch once into a zero plane, and every arm must give the
    scatter arm's counts (an arm that differs is recorded with an error
    and takes no part in the ranking).  Then a warm call, and ``iters``
    timed calls into a scratch plane: between CUDA events on the card,
    by the host clock on the CPU; an arm whose warm call already
    exceeds ``time_budget_s / len(METHODS)`` is timed once.  Returns the
    table: per method ``ms_per_call`` and ``ns_per_event`` (or
    ``skipped`` / ``error``), the winner, the geometry."""
    import torch

    from streambench_tpu_torch.ops import windowcount as wc
    from streambench_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    C, W, B = int(num_campaigns), int(window_slots), int(batch_size)
    campaign = torch.from_numpy(
        rng.integers(0, C, B).astype(np.int32)).to(dev)
    slot = torch.from_numpy(rng.integers(0, W, B).astype(np.int32)).to(dev)
    mask = torch.ones(B, dtype=torch.bool, device=dev)
    cuda = dev.type == "cuda"
    out: dict = {
        "device_type": dev.type,
        "device": (torch.cuda.get_device_name(dev) if cuda else "cpu"),
        "num_campaigns": C, "window_slots": W, "batch_size": B,
        "iters": int(iters), "methods": {},
    }
    per_budget = time_budget_s / len(METHODS)
    want = None

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    for method in METHODS:
        need = operand_bytes(method, B, C, W)
        if need > max_operand_bytes:
            out["methods"][method] = {
                "skipped": f"operands of {need} bytes exceed the "
                           f"{max_operand_bytes}-byte limit",
                "operand_bytes": need}
            continue
        try:
            got = wc.apply_count(
                torch.zeros((C, W), dtype=torch.int32, device=dev),
                campaign, slot, mask, method)
            if want is None:
                want = wc.apply_count(
                    torch.zeros((C, W), dtype=torch.int32, device=dev),
                    campaign, slot, mask, "scatter")
            if not torch.equal(got, want):
                out["methods"][method] = {
                    "error": "counts differ from the scatter arm's"}
                continue
            scratch = torch.zeros((C, W), dtype=torch.int32, device=dev)
            sync()
            t0 = time.perf_counter()
            wc.apply_count(scratch, campaign, slot, mask, method)
            sync()
            warm_s = time.perf_counter() - t0
            n = (1 if warm_s > per_budget
                 else max(1, min(iters, int(per_budget / max(warm_s,
                                                             1e-7)))))
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n):
                    wc.apply_count(scratch, campaign, slot, mask, method)
                end.record()
                end.synchronize()
                per_call_ms = start.elapsed_time(end) / n
            else:
                t0 = time.perf_counter()
                for _ in range(n):
                    wc.apply_count(scratch, campaign, slot, mask, method)
                per_call_ms = (time.perf_counter() - t0) * 1e3 / n
            out["methods"][method] = {
                "ms_per_call": per_call_ms,
                "ns_per_event": per_call_ms * 1e6 / B,
                "timed_iters": n, "operand_bytes": need,
            }
        except Exception as e:  # a broken arm must not kill the table
            out["methods"][method] = {"error": repr(e)}
    ranked = sorted(
        (m for m, v in out["methods"].items() if "ns_per_event" in v),
        key=lambda m: out["methods"][m]["ns_per_event"])
    out["winner"] = ranked[0] if ranked else None
    return out


def measure_and_record(num_campaigns: int = 100, window_slots: int = 16,
                       batch_size: int = 8192, **kw) -> dict:
    """Measure + persist under the device-type/C-bucket key;
    re-measuring overwrites."""
    res = measure_methods(num_campaigns=num_campaigns,
                          window_slots=window_slots,
                          batch_size=batch_size, **kw)
    if res.get("winner"):
        record(method_key(res["device_type"], num_campaigns), res)
    return res


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="time the window-count methods of apply_count")
    ap.add_argument("--campaigns", type=int, default=100)
    ap.add_argument("--window-slots", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes, 2 iters (exercises the measured "
                         "path end to end)")
    ap.add_argument("--no-record", action="store_true",
                    help="print the table without touching the cache")
    args = ap.parse_args(argv)
    if args.smoke:
        args.campaigns, args.window_slots = 8, 4
        args.batch, args.iters = 128, 2
    fn = measure_methods if args.no_record else measure_and_record
    res = {"count": fn(num_campaigns=args.campaigns,
                       window_slots=args.window_slots,
                       batch_size=args.batch, iters=args.iters,
                       device=args.device)}
    print(json.dumps(res, indent=1, sort_keys=True))
    return 0 if all(v.get("winner") for v in res.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
