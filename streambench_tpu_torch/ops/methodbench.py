"""The measured method table: the counting arms of the window folds and
the count-min sketch.

The port of the tumbling, sliding and count-min parts of
``streambench_tpu/ops/methodbench.py``.
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

The sliding family (``measure_sliding``) times one whole sliding fold
step per arm: ``scatter`` and ``matmul``, the unsliced fold (S ring
claims) with that membership landing, and ``sliced``, one claim and one
count into the ``[C*S, W]`` bucket plane with the engine's method (K1 on
the card).  It runs at the ring the sliding engine sizes for C
(``sliding.ring_slots``: 2048 slots at C = 100), and ``--window-slots``
sizes only the count family.  Its winner, under
``<device type>/sliding/S<S>``, is what ``jax.sliding.sliced: auto``
reads (``engine.sketches._sliced_auto``), and only at the ``[C, W]`` it
was measured at.

The count-min family (``measure_cms``) times one sketch update of a
Zipf-keyed batch per arm: ``flat`` (K3's update on the card), ``rowloop``
(D scatters, one a row, over K3's columns; bit-identical to ``flat``),
``twostage`` (the fat update and the small-stage refresh, two K3
launches) and ``salsa`` (K3's columns, then decode, scatter, settle and
re-encode as torch ops).  Every arm first folds the batch into a fresh
sketch and must give ``flat``'s counts (SALSA: the state
``salsa.oracle_encode_np`` derives from them).  Its winner, under
``<device type>/cms/W<Wd>``, is what ``jax.cms.mode: auto`` reads
(``engine.sketches._cms_auto``).

The cache is one JSON file of the port's own
(``$STREAMBENCH_TORCH_METHOD_CACHE``, default
``~/.cache/streambench_tpu_torch/method_bench.json``), keyed by the torch
device type and the campaign count's power-of-two bucket
(``cuda/C128``), so the two packages never read each other's winners.

    python -m streambench_tpu_torch.ops.methodbench [--device cuda|cpu]
        [--campaigns C] [--window-slots W] [--batch B] [--smoke]
        [--no-record] [--family count|sliding|cms|all]

On the card every arm is timed with CUDA events; on the CPU (only when
asked for, as the tests do) with the host clock.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

METHODS = ("scatter", "kernel", "onehot", "matmul")
SLIDING_METHODS = ("scatter", "matmul", "sliced")
CMS_METHODS = ("flat", "rowloop", "twostage", "salsa")
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


# ----------------------------------------------------------------------
# Sliding family: one whole sliding fold step per arm.

def sliding_key(device_type: str, memberships: int) -> str:
    return f"{device_type}/sliding/S{int(memberships)}"


def sliding_winner(device_type: str, memberships: int,
                   num_campaigns: int | None = None,
                   window_slots: int | None = None) -> str | None:
    """The measured sliding-family winner for this device type and S, or
    None when nothing was measured, or when the entry was measured at
    another ``[C, W]`` than the one given (``jax.sliding.sliced: auto``
    then takes the sliced fold wherever its plane fits)."""
    entry = cached_value(sliding_key(device_type, memberships))
    if entry is None:
        return None
    for key, want in (("num_campaigns", num_campaigns),
                      ("window_slots", window_slots)):
        if want is not None and entry.get(key, want) != want:
            return None
    winner = entry.get("winner")
    return winner if winner in SLIDING_METHODS else None


def _sliding_windows(state, sliced: bool, size_ms: int,
                     slide_ms: int) -> dict:
    """``(campaign, window id) -> count`` of a fold's drained windows."""
    from streambench_tpu_torch.ops import sliding
    from streambench_tpu_torch.ops import windowcount as wc

    if sliced:
        win, wid, _ = sliding.flush_sliced(state, size_ms=size_ms,
                                           slide_ms=slide_ms)
    else:
        win, wid, _ = wc.flush_deltas(
            state, divisor_ms=slide_ms,
            lateness_ms=sliding.effective_lateness(size_ms, slide_ms,
                                                   60_000))
    win, wid = win.cpu().numpy(), wid.cpu().numpy()
    ci, si = np.nonzero(win)
    return {(int(c), int(wid[s])): int(win[c, s]) for c, s in zip(ci, si)
            if wid[s] >= 0}


def measure_sliding(num_campaigns: int = 100,
                    window_slots: int | None = None,
                    batch_size: int = 8192, size_ms: int = 10_000,
                    slide_ms: int = 1_000, iters: int = 20,
                    methods: tuple = SLIDING_METHODS,
                    device: str = "cuda", time_budget_s: float = 5.0,
                    seed: int = 0) -> dict:
    """Time one sliding fold step per arm at one geometry; the ring is
    the engine's (``sliding.ring_slots``) unless ``window_slots`` is
    given.

    A synthetic batch of ``B`` views, uniform campaigns, event times on
    ``W - S`` slides in order.  Every arm first folds it into a fresh
    state, and its drained windows must equal the first arm's (an arm
    that differs is recorded with an error and takes no part in the
    ranking); then a warm step and up to ``iters`` timed steps, between
    CUDA events on the card, by the host clock on the CPU."""
    import torch

    from streambench_tpu_torch.engine.pipeline import default_method
    from streambench_tpu_torch.ops import sliding
    from streambench_tpu_torch.ops import windowcount as wc
    from streambench_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    C, B = int(num_campaigns), int(batch_size)
    W = int(window_slots or sliding.ring_slots(C, size_ms, slide_ms))
    S = int(size_ms) // int(slide_ms)
    join_table = torch.from_numpy(np.concatenate(
        [np.arange(C, dtype=np.int32), np.array([-1], np.int32)])).to(dev)
    cols = [torch.from_numpy(c).to(dev) for c in (
        rng.integers(0, C, B).astype(np.int32),
        np.zeros(B, np.int32),
        np.sort(rng.integers(0, max(W - S, 1), B).astype(np.int32)
                * np.int32(slide_ms)),
        np.ones(B, bool))]
    bucket_method = default_method(dev)
    cuda = dev.type == "cuda"
    out: dict = {
        "device_type": dev.type,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "num_campaigns": C, "window_slots": W, "batch_size": B,
        "size_ms": int(size_ms), "slide_ms": int(slide_ms),
        "memberships": S, "sliced_count_method": bucket_method,
        "iters": int(iters), "methods": {},
    }
    per_budget = time_budget_s / max(len(methods), 1)
    want = None

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    for method in methods:
        sliced = method == "sliced"

        def run(st, method=method, sliced=sliced):
            if sliced:
                return sliding.step_sliced(
                    st, join_table, *cols, size_ms=size_ms,
                    slide_ms=slide_ms, method=bucket_method)
            return sliding.step(st, join_table, *cols, size_ms=size_ms,
                                slide_ms=slide_ms, method=method)

        def fresh(sliced=sliced):
            return (sliding.init_sliced(C, W, S, device=dev) if sliced
                    else wc.init_state(C, W, dev))

        try:
            got = _sliding_windows(run(fresh()), sliced, size_ms, slide_ms)
            if want is None:
                want = got
            if got != want:
                out["methods"][method] = {
                    "error": f"windows differ from the {methods[0]} arm's"}
                continue
            st = fresh()
            sync()
            t0 = time.perf_counter()
            st = run(st)
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
                    st = run(st)
                end.record()
                end.synchronize()
                per_call_ms = start.elapsed_time(end) / n
            else:
                t0 = time.perf_counter()
                for _ in range(n):
                    st = run(st)
                per_call_ms = (time.perf_counter() - t0) * 1e3 / n
            out["methods"][method] = {
                "ms_per_step": per_call_ms,
                "ns_per_event": per_call_ms * 1e6 / B,
                "timed_iters": n,
            }
        except Exception as e:  # a broken arm must not kill the table
            out["methods"][method] = {"error": repr(e)}
    ranked = sorted(
        (m for m, v in out["methods"].items() if "ns_per_event" in v),
        key=lambda m: out["methods"][m]["ns_per_event"])
    out["winner"] = ranked[0] if ranked else None
    return out


def measure_and_record_sliding(num_campaigns: int = 100,
                               window_slots: int | None = None,
                               batch_size: int = 8192,
                               size_ms: int = 10_000,
                               slide_ms: int = 1_000, **kw) -> dict:
    """Measure + persist under ``<device type>/sliding/S<S>``, the key
    ``jax.sliding.sliced: auto`` reads; re-measuring overwrites."""
    res = measure_sliding(num_campaigns=num_campaigns,
                          window_slots=window_slots,
                          batch_size=batch_size, size_ms=size_ms,
                          slide_ms=slide_ms, **kw)
    if res.get("winner"):
        record(sliding_key(res["device_type"], res["memberships"]), res)
    return res


# ----------------------------------------------------------------------
# Count-min family: one sketch update per arm.

def cms_key(device_type: str, width: int) -> str:
    return f"{device_type}/cms/W{int(width)}"


def cms_winner(device_type: str, width: int) -> str | None:
    """The measured cms-family winner for this device type and width, or
    None when nothing was measured (``jax.cms.mode: auto`` then resolves
    fixed)."""
    entry = cached_value(cms_key(device_type, width))
    if entry is None:
        return None
    winner = entry.get("winner")
    return winner if winner in CMS_METHODS else None


def _cms_arm(method: str, depth: int, width: int, dev):
    """(fresh state, update function) of one arm."""
    from streambench_tpu_torch.ops import cms, salsa

    if method == "salsa":
        return salsa.init_state(depth, width, device=dev), salsa.update
    if method == "twostage":
        return cms.init_two_stage(depth, width, device=dev), cms.update2
    fn = cms.update_rowloop if method == "rowloop" else cms.update
    return cms.init_state(depth, width, device=dev), fn


def _cms_counts(method: str, state) -> "np.ndarray":
    """An arm's counter plane after one fold, comparable across arms:
    the fat table of the two-stage sketch, the encoded SALSA plane."""
    from streambench_tpu_torch.ops import cms

    if method == "salsa":
        return np.concatenate([state.table.cpu().numpy().reshape(-1),
                               state.m1.cpu().numpy().reshape(-1),
                               state.m2.cpu().numpy().reshape(-1)])
    table = (state.fat.table if isinstance(state, cms.CMS2State)
             else state.table)
    return table.cpu().numpy()


def cms_batch(rng, B: int) -> tuple:
    """numpy (keys, weights) of one sketch batch: Zipf(1.1) keys capped
    at 2^28, int32 weights 1-7 (the heavy-hitter shape the session engine
    feeds the sketch)."""
    keys = np.minimum(rng.zipf(1.1, B), 2**28).astype(np.int32)
    return keys, rng.integers(1, 8, B).astype(np.int32)


def measure_cms(width: int = 2048, depth: int = 4, batch_size: int = 8192,
                iters: int = 20, methods: tuple = CMS_METHODS,
                device: str = "cuda", time_budget_s: float = 5.0,
                seed: int = 0) -> dict:
    """Time one sketch update per arm at one geometry.

    Zipf(1.1) keys (capped at 2^28) with weights 1-7, every row counted:
    the heavy-hitter shape the session engine feeds the sketch.  Every
    arm first folds the batch into a fresh sketch and must agree with
    ``flat`` (an arm that differs is recorded with an error and takes no
    part in the ranking); then a warm update and up to ``iters`` timed
    updates, between CUDA events on the card, by the host clock on the
    CPU."""
    import torch

    from streambench_tpu_torch.ops import salsa
    from streambench_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    B = int(batch_size)
    keys, weights = cms_batch(rng, B)
    cols = [torch.from_numpy(c).to(dev)
            for c in (keys, weights, np.ones(B, bool))]
    cuda = dev.type == "cuda"
    out: dict = {
        "device_type": dev.type,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "depth": int(depth), "width": int(width), "batch_size": B,
        "iters": int(iters), "methods": {},
    }
    per_budget = time_budget_s / max(len(methods), 1)
    flat_counts = None

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    for method in methods:
        try:
            state, fn = _cms_arm(method, depth, width, dev)
            got = _cms_counts(method, fn(state, *cols))
            if flat_counts is None:
                st, f = _cms_arm("flat", depth, width, dev)
                flat_counts = _cms_counts("flat", f(st, *cols))
            want = (np.concatenate([a.reshape(-1) for a in
                                    salsa.oracle_encode_np(
                                        flat_counts.astype(np.int64))])
                    if method == "salsa" else flat_counts)
            if not np.array_equal(got, want):
                out["methods"][method] = {
                    "error": "counts differ from the flat arm's"}
                continue
            st, _ = _cms_arm(method, depth, width, dev)
            sync()
            t0 = time.perf_counter()
            st = fn(st, *cols)
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
                    st = fn(st, *cols)
                end.record()
                end.synchronize()
                per_call_ms = start.elapsed_time(end) / n
            else:
                t0 = time.perf_counter()
                for _ in range(n):
                    st = fn(st, *cols)
                per_call_ms = (time.perf_counter() - t0) * 1e3 / n
            out["methods"][method] = {
                "ms_per_step": per_call_ms,
                "ns_per_event": per_call_ms * 1e6 / B,
                "timed_iters": n,
            }
        except Exception as e:  # a broken arm must not kill the table
            out["methods"][method] = {"error": repr(e)}
    ranked = sorted(
        (m for m, v in out["methods"].items() if "ns_per_event" in v),
        key=lambda m: out["methods"][m]["ns_per_event"])
    out["winner"] = ranked[0] if ranked else None
    return out


def measure_and_record_cms(width: int = 2048, depth: int = 4,
                           batch_size: int = 8192, **kw) -> dict:
    """Measure + persist under ``<device type>/cms/W<Wd>``, the key
    ``jax.cms.mode: auto`` reads; re-measuring overwrites."""
    res = measure_cms(width=width, depth=depth, batch_size=batch_size, **kw)
    if res.get("winner"):
        record(cms_key(res["device_type"], width), res)
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
    ap.add_argument("--family", default="all",
                    choices=("count", "sliding", "cms", "all"),
                    help="which fold family to measure")
    args = ap.parse_args(argv)
    if args.smoke:
        args.campaigns, args.window_slots = 8, 4
        args.batch, args.iters = 128, 2
    res = {}
    if args.family in ("count", "all"):
        fn = measure_methods if args.no_record else measure_and_record
        res["count"] = fn(num_campaigns=args.campaigns,
                          window_slots=args.window_slots,
                          batch_size=args.batch, iters=args.iters,
                          device=args.device)
    if args.family in ("sliding", "all"):
        # at the ring the engine sizes for these campaigns, the geometry
        # jax.sliding.sliced: auto reads the winner for
        fn = (measure_sliding if args.no_record
              else measure_and_record_sliding)
        res["sliding"] = fn(num_campaigns=args.campaigns,
                            batch_size=args.batch, iters=args.iters,
                            device=args.device)
    if args.family in ("cms", "all"):
        # the session engine's plane (D = 4, Wd = 2048); the smoke's is
        # narrow
        fn = measure_cms if args.no_record else measure_and_record_cms
        res["cms"] = fn(width=256 if args.smoke else 2048,
                        batch_size=args.batch, iters=args.iters,
                        device=args.device)
    print(json.dumps(res, indent=1, sort_keys=True))
    return 0 if all(v.get("winner") for v in res.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
