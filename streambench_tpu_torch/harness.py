"""Benchmark harness of the PyTorch port — the ``stream-bench.sh`` peer.

The port's adaptation of the JAX package's ``stream_bench.py``: the same
operation grammar (a list of operation names, each dispatched by
``run()``), with the port's own modules as child processes — the RESP
server (``io.fakeredis``), the fake Kafka broker (``io.fakekafka``), the
generator (``datagen``) and the engine (``engine``).  The composite
``TORCH_TEST`` mirrors ``FLINK_TEST`` (``stream-bench.sh:301-315``):
services up -> engine up -> paced load -> sleep ``TEST_TIME`` -> stop load
(collect ``-g`` stats into ``seen.txt``/``updated.txt``) -> stop engine ->
stop services.

Knobs are environment variables (``stream-bench.sh:9-40``): ``TOPIC``,
``PARTITIONS``, ``LOAD`` (events/s), ``TEST_TIME`` (s), ``REDIS_HOST``,
``REDIS_PORT``, ``WORKDIR``, ``CONF_FILE``, ``CHECKPOINT_DIR``,
``STOP_STATS_GRACE`` (s), ``KAFKA_FAKE=1`` (the fake broker as its own
process, ``START_KAFKA``/``STOP_KAFKA``; ``KAFKA_BROKERS`` names its
address, default ``127.0.0.1:9092``), ``INGEST_PIPELINE`` (off/on/auto),
``DECODE_DEVICE`` (off/on/auto: device decode, ``jax.decode.device``),
``ENCODE_WORKERS``, ``SCAN_BATCHES``, ``WINDOW_SLOTS``, ``EXACTLY_ONCE``,
``BROKER_DIR`` (the file journal; default ``WORKDIR/broker``), and
``DEVICE`` (``cuda`` by default, passed to the engine as ``--device``;
``cpu`` only when asked for), ``ENGINE`` (``exact`` by default, ``hll``,
``sliding`` or ``session``; passed to the engine as ``--engine``).
``VERIFY=1``
makes ``TORCH_TEST`` hold every window in Redis against the generator's
oracle over the journal the load wrote (``VERIFY``, before the services
stop) and record the result in ``WORKDIR/verify.json``; the oracle counts
exact views per tumbling window, so SETUP refuses it with any ``ENGINE``
but ``exact``.

Observability knobs, under the JAX harness's names and all default-off:
``METRICS_INTERVAL_MS`` (``WORKDIR/metrics.jsonl``), ``OBS_LIFECYCLE``
(per-window latency attribution, ``python -m streambench_tpu_torch.obs
attribution``), ``FLIGHTREC`` (``WORKDIR/flight_<reason>.jsonl``),
``OBS_SPANS`` (``WORKDIR/trace_<pid>.json``), ``OBS_OCCUPANCY``,
``SLO_P99_MS``, ``SLO_RATE_EVPS``, ``OBS_XFER``, ``OBS_DEVMEM`` and
``OBS_CAPTURE`` (a ``torch.profiler`` one-shot into
``WORKDIR/xprof_<ms>_oneshot/``).  ``OBS_SHARD``, ``OBS_QUERY`` and
``OBS_FLEET`` need surfaces not ported yet and are refused.

Services are subprocesses with ``<pid> <starttime>`` pidfiles
(``utils.pidfile``), so STOP never signals a recycled pid.  An engine that
dies during startup fails ``START_TORCH_PROCESSING``; nothing falls back
to another device.

    python -m streambench_tpu_torch.harness SETUP START_REDIS ...
    python -m streambench_tpu_torch.harness TORCH_TEST | STOP_ALL
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import time

from streambench_tpu_torch.utils.pidfile import proc_starttime, read_pidfile

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flag(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0", "false", "no")


# --- env knobs (names per stream-bench.sh:9-40) ---
TOPIC = os.environ.get("TOPIC", "ad-events")
PARTITIONS = int(os.environ.get("PARTITIONS", "1"))
LOAD = int(os.environ.get("LOAD", "1000"))               # events/sec
TEST_TIME = float(os.environ.get("TEST_TIME", "240"))    # seconds
REDIS_HOST = os.environ.get("REDIS_HOST", "127.0.0.1")
REDIS_PORT = int(os.environ.get("REDIS_PORT", "6379"))
WORKDIR = os.path.abspath(os.environ.get("WORKDIR", "./bench-run"))
CONF_FILE = os.environ.get("CONF_FILE",
                           os.path.join(WORKDIR, "localConf.yaml"))
BROKER_DIR = os.environ.get("BROKER_DIR", "") or os.path.join(WORKDIR,
                                                               "broker")
STOP_STATS_GRACE_S = float(os.environ.get("STOP_STATS_GRACE", "2.5"))
CHECKPOINT_DIR = os.environ.get("CHECKPOINT_DIR", "")
# the torch device the engine folds on: the card unless asked otherwise
DEVICE = os.environ.get("DEVICE", "cuda")
# the aggregation engine: exact | hll | sliding | session (BASELINE
# configs #1-#4)
ENGINE = os.environ.get("ENGINE", "exact")
# Fake Kafka as a standalone TCP broker process (START_KAFKA/STOP_KAFKA):
# the generator produces and the engine consumes over a real socket.
# KAFKA_BROKERS picks the address (default 127.0.0.1:9092); naming one
# without KAFKA_FAKE routes both through a real cluster, which needs
# confluent-kafka (no silent fallback).
KAFKA_BROKERS = os.environ.get("KAFKA_BROKERS", "")
KAFKA_FAKE = _flag("KAFKA_FAKE")
KAFKA_HOST, KAFKA_PORT = "127.0.0.1", 9092
if KAFKA_BROKERS:
    _h, _, _p = KAFKA_BROKERS.split(",")[0].strip().partition(":")
    KAFKA_HOST = _h or KAFKA_HOST
    if _p:
        KAFKA_PORT = int(_p)
KAFKA_BOOTSTRAP = (KAFKA_BROKERS or
                   (f"{KAFKA_HOST}:{KAFKA_PORT}" if KAFKA_FAKE else ""))
# engine tuning forwarded into localConf (jax.* keys)
SCAN_BATCHES = int(os.environ.get("SCAN_BATCHES", "8"))
WINDOW_SLOTS = int(os.environ.get("WINDOW_SLOTS", "16"))
ENCODE_WORKERS = int(os.environ.get("ENCODE_WORKERS", "1"))
INGEST_PIPELINE = os.environ.get("INGEST_PIPELINE", "off")
# device decode (ops/devdecode.py): off | on | auto; "on" ships raw
# journal blocks to the device, where the decode kernel turns them into
# columns.  Default off: the host encoders run.
DECODE_DEVICE = os.environ.get("DECODE_DEVICE", "off")
EXACTLY_ONCE = _flag("EXACTLY_ONCE")
VERIFY = _flag("VERIFY")
# observability (obs/), forwarded into localConf (jax.metrics.*,
# jax.obs.*, jax.slo.* keys)
METRICS_INTERVAL_MS = int(os.environ.get("METRICS_INTERVAL_MS", "0"))
OBS_LIFECYCLE = _flag("OBS_LIFECYCLE")
FLIGHTREC = _flag("FLIGHTREC")
OBS_SPANS = _flag("OBS_SPANS")
OBS_OCCUPANCY = _flag("OBS_OCCUPANCY")
SLO_P99_MS = int(os.environ.get("SLO_P99_MS", "0"))
SLO_RATE_EVPS = int(os.environ.get("SLO_RATE_EVPS", "0"))
OBS_XFER = _flag("OBS_XFER")
OBS_DEVMEM = _flag("OBS_DEVMEM")
OBS_CAPTURE = _flag("OBS_CAPTURE")
#: knobs of the JAX harness whose surfaces the port does not have yet
NOT_PORTED_KNOBS = ("OBS_SHARD", "OBS_QUERY", "OBS_FLEET")

PID_DIR = os.path.join(WORKDIR, "pids")
LOG_DIR = os.path.join(WORKDIR, "logs")
VERIFY_FILE = os.path.join(WORKDIR, "verify.json")


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------------
# process lifecycle (pidfile versions of start_if_needed /
# stop_if_needed, stream-bench.sh:47-81)
# ----------------------------------------------------------------------

def _pidfile(name: str) -> str:
    return os.path.join(PID_DIR, f"{name}.pid")


def _alive(pid: int) -> bool:
    # reap our own exited child (else it stays a zombie that looks alive)
    try:
        os.waitpid(pid, os.WNOHANG)
    except ChildProcessError:
        pass
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, PermissionError):
        return False
    try:  # a zombie of some other parent is not "running"
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, IndexError):
        return False


def running_pid(name: str) -> int | None:
    """The live process a service's pidfile names; a recorded start time
    that no longer matches (a recycled pid) reads as not running."""
    rec = read_pidfile(_pidfile(name))
    if rec is None:
        return None
    pid, started = rec
    if not _alive(pid):
        return None
    if started is not None and proc_starttime(pid) != started:
        return None
    return pid


def start_if_needed(name: str, argv: list[str]) -> int:
    pid = running_pid(name)
    if pid is not None:
        log(f"{name} is already running (pid {pid})...")
        return pid
    os.makedirs(PID_DIR, exist_ok=True)
    os.makedirs(LOG_DIR, exist_ok=True)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    with open(os.path.join(LOG_DIR, f"{name}.log"), "ab") as logf:
        proc = subprocess.Popen(argv, cwd=REPO_ROOT, stdout=logf,
                                stderr=logf, env=env,
                                start_new_session=True)
    started = proc_starttime(proc.pid)
    with open(_pidfile(name), "w") as f:
        f.write(f"{proc.pid} {started}" if started else str(proc.pid))
    log(f"started {name} (pid {proc.pid})")
    return proc.pid


def stop_if_needed(name: str, timeout_s: float = 60.0) -> None:
    pid = running_pid(name)
    if pid is None:
        log(f"No running instances of {name}")
        return
    os.kill(pid, signal.SIGTERM)
    deadline = time.monotonic() + timeout_s
    while _alive(pid) and time.monotonic() < deadline:
        time.sleep(0.05)
    if _alive(pid):
        log(f"{name} (pid {pid}) did not exit; killing")
        os.kill(pid, signal.SIGKILL)
    try:
        os.remove(_pidfile(name))
    except FileNotFoundError:
        pass
    log(f"stopped {name}")


def _run_tool(argv: list[str], name: str) -> int:
    """Run a foreground step (seeding, stats), teeing output to its log."""
    os.makedirs(LOG_DIR, exist_ok=True)
    proc = subprocess.run(argv, cwd=REPO_ROOT, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    with open(os.path.join(LOG_DIR, f"{name}.log"), "ab") as logf:
        logf.write(proc.stdout)
    sys.stdout.write(proc.stdout.decode("utf-8", "replace"))
    return proc.returncode


def _py(mod: str, *args: str) -> list[str]:
    return [sys.executable, "-m", mod, *args]


def _datagen(*args: str) -> list[str]:
    return _py("streambench_tpu_torch.datagen", *args,
               "--configPath", CONF_FILE, "--workdir", WORKDIR,
               "--brokerDir", BROKER_DIR)


# ----------------------------------------------------------------------
# operations (the run() case arms, stream-bench.sh:117-398)
# ----------------------------------------------------------------------

def op_setup() -> None:
    """Write localConf.yaml from the env knobs (stream-bench.sh:123-138)
    and build the native host library (the only thing to compile before
    the engine's own warmup)."""
    from streambench_tpu_torch import native
    from streambench_tpu_torch.config import write_local_conf

    refused = [k for k in NOT_PORTED_KNOBS if _flag(k)]
    if refused:
        raise SystemExit("not ported to the PyTorch harness yet: "
                         + ", ".join(refused))
    if VERIFY and ENGINE != "exact":
        # gen.dostats counts exact views per tumbling window: it has no
        # answer for distinct-user estimates, sliding windows or sessions
        raise SystemExit(f"VERIFY holds exact tumbling counts against the "
                         f"journal; it does not apply to ENGINE={ENGINE}")
    os.makedirs(WORKDIR, exist_ok=True)
    # Start from a fresh journal — except on a checkpoint-resume run (the
    # snapshot's offsets index THIS journal) or in a directory the user
    # named (never delete their journal).
    if (not CHECKPOINT_DIR and not os.environ.get("BROKER_DIR")
            and not any(running_pid(n) is not None
                        for n in ("load", "engine"))):
        shutil.rmtree(BROKER_DIR, ignore_errors=True)
    write_local_conf(CONF_FILE, {
        "kafka.bootstrap": KAFKA_BOOTSTRAP,
        "kafka.fake": KAFKA_FAKE,
        "kafka.brokers": ["localhost"],
        "zookeeper.servers": ["localhost"],
        "kafka.port": 9092,
        "zookeeper.port": 2181,
        "redis.host": REDIS_HOST,
        "redis.port": REDIS_PORT,
        "kafka.topic": TOPIC,
        "kafka.partitions": PARTITIONS,
        "process.hosts": 1,
        "process.cores": 4,
        "jax.scan.batches": SCAN_BATCHES,
        "jax.window.slots": WINDOW_SLOTS,
        "jax.encode.workers": ENCODE_WORKERS,
        "jax.ingest.pipeline": INGEST_PIPELINE,
        "jax.decode.device": DECODE_DEVICE,
        "jax.sink.exactly_once": EXACTLY_ONCE,
        "jax.metrics.interval.ms": METRICS_INTERVAL_MS,
        "jax.obs.lifecycle": OBS_LIFECYCLE,
        "jax.obs.flightrec.enabled": FLIGHTREC,
        "jax.obs.spans": OBS_SPANS,
        "jax.obs.occupancy": OBS_OCCUPANCY,
        "jax.slo.p99.ms": SLO_P99_MS,
        "jax.slo.rate.evps": SLO_RATE_EVPS,
        "jax.obs.xfer": OBS_XFER,
        "jax.obs.devmem": OBS_DEVMEM,
        "jax.obs.capture.enabled": OBS_CAPTURE,
        # the env knob means "prove capture works": one bounded window
        # of the stream, so every such run leaves an xprof dir
        "jax.obs.capture.oneshot": OBS_CAPTURE,
    })
    log(f"wrote {CONF_FILE}")
    native.build()
    log("native encoder ready")


def _redis_client(timeout_s: float = 1.0):
    from streambench_tpu_torch.io.resp import RespClient

    return RespClient(REDIS_HOST, REDIS_PORT, timeout_s=timeout_s)


def _redis_alive(timeout_s: float = 1.0) -> bool:
    """Health-check PING against REDIS_HOST:REDIS_PORT (no spawn)."""
    try:
        with _redis_client(timeout_s) as c:
            return c.ping() == "PONG"
    except OSError:
        return False


def _external_marker(name: str) -> str:
    return os.path.join(PID_DIR, f"{name}.external")


def _adopt(name: str, where: str) -> None:
    os.makedirs(PID_DIR, exist_ok=True)
    with open(_external_marker(name), "w") as f:
        f.write(f"{where}\n")
    log(f"{name} already serving at {where} (external; adopted, will "
        "not be stopped)")


def _stop_or_leave(name: str) -> None:
    """STOP for a service that may have been adopted: a server this
    harness never started is left running."""
    marker = _external_marker(name)
    if os.path.exists(marker):
        try:
            with open(marker) as f:
                where = f.read().strip()
        finally:
            os.remove(marker)
        log(f"external {name} at {where} left running "
            "(not started by this harness)")
        return
    stop_if_needed(name)


def _await(alive, name: str, timeout_s: float = 15.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not alive():
        pid = running_pid(name)
        if pid is None and not os.path.exists(_external_marker(name)):
            raise SystemExit(f"{name} died during startup; see "
                             f"{os.path.join(LOG_DIR, name + '.log')}")
        if time.monotonic() > deadline:
            raise SystemExit(f"{name} did not come up")
        time.sleep(0.1)


def op_start_redis() -> None:
    # a server already answering at REDIS_HOST:REDIS_PORT is adopted via
    # PING instead of spawning a second one
    if running_pid("redis") is None and _redis_alive():
        _adopt("redis", f"{REDIS_HOST}:{REDIS_PORT}")
    else:
        try:
            os.remove(_external_marker("redis"))
        except FileNotFoundError:
            pass
        start_if_needed("redis", _py("streambench_tpu_torch.io.fakeredis",
                                     "--host", REDIS_HOST,
                                     "--port", str(REDIS_PORT)))
    _await(_redis_alive, "redis")
    # seed campaigns, like `lein run -n` right after redis start
    # (stream-bench.sh:182-186); a checkpoint-resume run keeps its ids
    seed_args = ["-n", "--reuse-ids"] if CHECKPOINT_DIR else ["-n"]
    rc = _run_tool(_datagen(*seed_args), "seed")
    if rc != 0:
        raise SystemExit(f"redis seeding failed (rc={rc})")


def op_stop_redis() -> None:
    _stop_or_leave("redis")


#: KAFKA_FAULT_* env -> io.fakekafka CLI fault flags (seeded broker
#: faults from the chaos package's FaultPlan)
_KAFKA_FAULT_FLAGS = (
    ("KAFKA_FAULT_SEED", "--fault-seed"),
    ("KAFKA_FAULT_PRODUCE_RATE", "--fault-produce-rate"),
    ("KAFKA_FAULT_CONSUME_RATE", "--fault-consume-rate"),
    ("KAFKA_FAULT_CONN_DROP_RATE", "--fault-conn-drop-rate"),
    ("KAFKA_FAULT_DR_FAIL_RATE", "--fault-dr-fail-rate"),
    ("KAFKA_FAULT_OPS", "--fault-ops"),
    ("KAFKA_FAULT_DOWN", "--fault-down"),
)


def _kafka_alive(timeout_s: float = 1.0) -> bool:
    from streambench_tpu_torch.io.fakekafka import ping

    return ping(KAFKA_HOST, KAFKA_PORT, timeout_s=timeout_s)


def op_start_kafka() -> None:
    # same adopt-or-spawn contract as START_REDIS
    if running_pid("kafka") is None and _kafka_alive():
        _adopt("kafka", f"{KAFKA_HOST}:{KAFKA_PORT}")
    else:
        try:
            os.remove(_external_marker("kafka"))
        except FileNotFoundError:
            pass
        args = ["--host", KAFKA_HOST, "--port", str(KAFKA_PORT)]
        for env_name, flag in _KAFKA_FAULT_FLAGS:
            v = os.environ.get(env_name, "")
            if v:
                args += [flag, v]
        start_if_needed("kafka", _py("streambench_tpu_torch.io.fakekafka",
                                     *args))
    _await(_kafka_alive, "kafka")


def op_stop_kafka() -> None:
    _stop_or_leave("kafka")


def op_start_load() -> None:
    start_if_needed("load", _datagen("-r", "-t", str(LOAD)))


def op_stop_load() -> None:
    """Kill the generator, then collect stats -> seen.txt/updated.txt
    (stream-bench.sh:231-236)."""
    had_load = running_pid("load") is not None
    stop_if_needed("load")
    if had_load:
        # let the engine's 1 Hz flusher drain the tail windows first
        time.sleep(STOP_STATS_GRACE_S)
    rc = _run_tool(_datagen("-g"), "stats")
    if rc != 0:
        log(f"stats collection failed (rc={rc})")


# Byte offset where the CURRENT engine instance's log begins (engine.log
# appends across runs); evidence checks read nothing before it.
_ENGINE_LOG_START = 0


def op_start_torch_processing() -> None:
    global _ENGINE_LOG_START
    args = ["--confPath", CONF_FILE, "--workdir", WORKDIR,
            "--brokerDir", BROKER_DIR, "--device", DEVICE]
    if ENGINE != "exact":
        args += ["--engine", ENGINE]
    if CHECKPOINT_DIR:
        args += ["--checkpointDir", CHECKPOINT_DIR]
    if running_pid("engine") is not None:
        log("engine is already running...")
        return
    logpath = os.path.join(LOG_DIR, "engine.log")
    log_start = os.path.getsize(logpath) if os.path.exists(logpath) else 0
    _ENGINE_LOG_START = log_start
    pid = start_if_needed("engine", _py("streambench_tpu_torch.engine",
                                        *args))
    # wait for the ready marker, printed after warmup has built the
    # kernels, so a following START_LOAD measures the stream, not a
    # compiler; only this instance's log bytes count
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        try:
            with open(logpath) as f:
                f.seek(log_start)
                if "engine up:" in f.read():
                    return
        except FileNotFoundError:
            pass
        if not _alive(pid):
            raise SystemExit(f"engine died during startup; see {logpath}")
        time.sleep(0.2)
    raise SystemExit("engine did not become ready within 300s")


def op_stop_torch_processing() -> None:
    stop_if_needed("engine")


def op_verify() -> None:
    """Hold every window in Redis against the generator's oracle
    (``gen.dostats``, ``core.clj:101-128``) replayed over the journal the
    load wrote; record the verdict in ``verify.json`` and fail on any
    difference.  Runs while Redis and the broker still serve."""
    from streambench_tpu_torch.config import find_and_read_config_file
    from streambench_tpu_torch.datagen import gen
    from streambench_tpu_torch.io.kafka import make_broker
    from streambench_tpu_torch.io.redis_schema import read_seen_counts

    cfg = find_and_read_config_file(CONF_FILE)
    divisor = cfg.jax_time_divisor_ms
    broker = make_broker(cfg.kafka_bootstrap_servers, BROKER_DIR,
                         fake=cfg.kafka_fake)
    journal = {"events": 0}

    def events():
        for line in broker.read_all(cfg.kafka_topic):
            journal["events"] += 1
            yield line

    t0 = time.perf_counter()
    want = gen.dostats(WORKDIR, divisor, events=events())
    with _redis_client(timeout_s=30.0) as r:
        got = read_seen_counts(r)
    differ = missing = extra = correct = 0
    for campaign in set(want) | set(got):
        w = {b * divisor: n for b, n in want.get(campaign, {}).items()}
        g = got.get(campaign, {})
        for ts in set(w) | set(g):
            if ts not in g:
                missing += 1
            elif ts not in w:
                extra += 1
            elif g[ts] != w[ts]:
                differ += 1
            else:
                correct += 1
    out = {"journal_events": journal["events"], "windows_correct": correct,
           "windows_differ": differ, "windows_missing": missing,
           "windows_extra": extra,
           "verify_s": time.perf_counter() - t0}
    with open(VERIFY_FILE, "w") as f:
        json.dump(out, f)
    log(f"VERIFY: {json.dumps(out)}")
    if differ or missing or extra or not correct:
        raise SystemExit(f"VERIFY: windows do not match the journal: {out}")


def op_torch_test() -> None:
    """Composite run, same sequence as FLINK_TEST (stream-bench.sh:301-315)."""
    op_setup()
    # a composite test must never adopt an engine left over from a
    # previous (possibly crashed or hung) run via its pidfile
    if running_pid("engine") is not None:
        log("stopping stale engine from a previous run")
        stop_if_needed("engine")
    # ... and only THIS run's stats may count as evidence
    for name in ("seen.txt", "updated.txt", "verify.json"):
        try:
            os.unlink(os.path.join(WORKDIR, name))
        except OSError:
            pass
    op_start_redis()
    if KAFKA_FAKE:
        # broker process up BEFORE the engine and the generator: both
        # connect to it over TCP (the conf carries kafka.fake + bootstrap)
        op_start_kafka()
    op_start_torch_processing()
    op_start_load()
    log(f"sleeping {TEST_TIME:.0f}s")
    time.sleep(TEST_TIME)
    op_stop_load()
    op_stop_torch_processing()
    try:
        if VERIFY:
            op_verify()
    finally:
        if KAFKA_FAKE:
            op_stop_kafka()
        op_stop_redis()
    # a composite test that produced load but measured NOTHING is a
    # failure (a stale or hung engine), not a quiet success.  The session
    # engine writes no window rows: its evidence is the final stats line
    # of this run's engine, as in the reference harness
    if ENGINE == "session":
        evidence, what = _engine_stats_line(), "events"
        ok = evidence != "" and '"events": 0' not in evidence
    else:
        what = "window rows"
        try:
            with open(os.path.join(WORKDIR, "seen.txt")) as f:
                n_windows = sum(1 for _ in f)
        except OSError:
            n_windows = 0
        ok = n_windows > 0
        evidence = f"{n_windows} rows"
    if not ok:
        raise SystemExit(
            f"TORCH_TEST measured no {what} — the engine processed "
            "nothing (stale/hung engine process? check logs/engine.log)")
    log(f"TORCH_TEST evidence: {evidence}")


def _engine_stats_line() -> str:
    """The last stats line (the JSON with ``"events"``) this run's engine
    wrote to ``logs/engine.log``, or ""."""
    line = ""
    try:
        with open(os.path.join(LOG_DIR, "engine.log")) as f:
            f.seek(_ENGINE_LOG_START)        # only THIS run's lines
            for ln in f:
                if '"events"' in ln:
                    line = ln.strip()
    except OSError:
        pass
    return line


def op_stop_all() -> None:
    for name in ("load", "engine", "kafka", "redis"):
        stop_if_needed(name)


OPS: dict[str, object] = {
    "SETUP": op_setup,
    "START_REDIS": op_start_redis,
    "STOP_REDIS": op_stop_redis,
    "START_KAFKA": op_start_kafka,
    "STOP_KAFKA": op_stop_kafka,
    "START_LOAD": op_start_load,
    "STOP_LOAD": op_stop_load,
    "START_TORCH_PROCESSING": op_start_torch_processing,
    "STOP_TORCH_PROCESSING": op_stop_torch_processing,
    "VERIFY": op_verify,
    "TORCH_TEST": op_torch_test,
    "STOP_ALL": op_stop_all,
}


def run(op: str) -> None:
    """Dispatch one operation (the run() case statement,
    stream-bench.sh:117-398)."""
    fn = OPS.get(op)
    if fn is None:
        log(f"UNKNOWN OPERATION '{op}'")
        log(f"Supported operations: {'|'.join(OPS)}")
        raise SystemExit(1)
    fn()  # type: ignore[operator]


def main(argv: list[str]) -> int:
    if not argv:
        log("Usage: python -m streambench_tpu_torch.harness OPERATION [...]")
        log(f"Supported operations: {'|'.join(OPS)}")
        return 1
    for op in argv:
        run(op)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
