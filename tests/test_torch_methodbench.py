"""The port's method table (``streambench_tpu_torch.ops.methodbench``)
against the JAX package's, on the CPU: the same keys and buckets, its own
cache file, every arm checked for equal counts, the skip of an arm whose
operands would not fit, and ``--smoke`` end to end."""

import json
import os
import subprocess
import sys

import pytest
import torch

from streambench_tpu.ops import methodbench as jmb
from streambench_tpu_torch.engine import AdAnalyticsEngine
from streambench_tpu_torch.config import default_config
from streambench_tpu_torch.ops import methodbench as mb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


@pytest.fixture()
def cache(tmp_path, monkeypatch):
    path = tmp_path / "method_bench.json"
    monkeypatch.setenv("STREAMBENCH_TORCH_METHOD_CACHE", str(path))
    # the JAX package's cache lives elsewhere and is never touched
    monkeypatch.setenv("STREAMBENCH_METHOD_CACHE",
                       str(tmp_path / "jax_method_bench.json"))
    return path


@pytest.mark.parametrize("c", [0, 1, 2, 3, 5, 8, 100, 128, 129, 8192,
                               1_000_000])
def test_buckets_and_keys_match_jax(c):
    assert mb.bucket(c) == jmb.bucket(c)
    assert mb.method_key("cuda", c) == jmb.method_key("cuda", c)


def test_cache_path_is_the_ports_own(cache, monkeypatch):
    assert mb.cache_path() == str(cache)
    assert mb.cache_path() != jmb.cache_path()
    monkeypatch.delenv("STREAMBENCH_TORCH_METHOD_CACHE")
    monkeypatch.delenv("STREAMBENCH_METHOD_CACHE")
    assert "streambench_tpu_torch" in mb.cache_path()
    assert mb.cache_path() != jmb.cache_path()


def test_measure_methods_on_cpu_checks_and_times_every_arm(cache):
    res = mb.measure_methods(num_campaigns=8, window_slots=4,
                             batch_size=64, iters=2, device="cpu")
    assert res["device_type"] == "cpu"
    assert set(res["methods"]) == set(mb.METHODS)
    for m, v in res["methods"].items():
        assert v["ns_per_event"] > 0 and v["timed_iters"] >= 1, m
    assert res["winner"] in mb.METHODS
    assert not cache.exists()             # measuring alone records nothing


def test_an_arm_whose_operands_do_not_fit_is_skipped(cache):
    """At config #5's C = 1e6 the one-hot arms' operands run to tens of
    GB; the table records the skip instead of allocating them."""
    assert mb.operand_bytes("onehot", 8192, 1_000_000, 64) > 1e12
    assert mb.operand_bytes("matmul", 8192, 1_000_000, 64) > 3e10
    assert mb.operand_bytes("kernel", 8192, 1_000_000, 64) == 0
    res = mb.measure_methods(num_campaigns=8, window_slots=4,
                             batch_size=64, iters=1, device="cpu",
                             max_operand_bytes=4_000)
    assert "skipped" in res["methods"]["onehot"]
    assert res["methods"]["onehot"]["operand_bytes"] > 4_000
    assert "ns_per_event" in res["methods"]["kernel"]
    assert res["winner"] in ("scatter", "kernel", "matmul")


def test_an_arm_that_disagrees_takes_no_part(cache, monkeypatch):
    from streambench_tpu_torch.ops import windowcount as wc

    apply_count = wc.apply_count

    def off_by_one(counts, campaign, slot, mask, method):
        out = apply_count(counts, campaign, slot, mask, method)
        return out.add_(1) if method == "onehot" else out

    monkeypatch.setattr(wc, "apply_count", off_by_one)
    res = mb.measure_methods(num_campaigns=8, window_slots=4,
                             batch_size=64, iters=1, device="cpu")
    assert "differ" in res["methods"]["onehot"]["error"]
    assert res["winner"] != "onehot"


def test_measure_and_record_roundtrip(cache):
    res = mb.measure_and_record(num_campaigns=8, window_slots=4,
                                batch_size=64, iters=1, device="cpu")
    data = json.loads(cache.read_text())
    key = mb.method_key("cpu", 8)
    assert key == "cpu/C8" and data[key]["winner"] == res["winner"]
    assert mb.cached_winner("cpu", 8) == res["winner"]
    # another campaign bucket, device type or a corrupt entry: no winner
    assert mb.cached_winner("cpu", 8192) is None
    assert mb.cached_winner("cuda", 8) is None
    assert mb.cached_winner("cpu", None) is None
    mb.record(key, {"winner": "pallas"})
    assert mb.cached_winner("cpu", 8) is None
    # the devdecode A/B shares the file
    mb.record("cpu/devdecode", {"winner": "host"})
    assert mb.cached_value("cpu/devdecode") == {"winner": "host"}
    assert mb.cached_value(key) == {"winner": "pallas"}
    assert not os.path.exists(os.environ["STREAMBENCH_METHOD_CACHE"])


def test_cache_tolerates_garbage_file(cache):
    cache.write_text("not json{")
    assert mb.cached_value("cpu/C8") is None
    mb.record("cpu/C8", {"winner": "scatter"})
    assert mb.cached_winner("cpu", 8) == "scatter"


def test_the_table_never_switches_the_engine(cache):
    """A recorded winner does not change the engine's method: on the CPU
    it stays the plain version, as on the card it stays K1."""
    mb.record(mb.method_key("cpu", 100), {"winner": "matmul"})
    eng = AdAnalyticsEngine(default_config(), {"ad": "camp"}, device="cpu")
    assert eng.method == "scatter"


def test_cli_smoke_on_cpu_records_the_winner(cache):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "streambench_tpu_torch.ops.methodbench",
         "--smoke", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout)["count"]
    assert res["device_type"] == "cpu" and res["batch_size"] == 128
    assert set(res["methods"]) == set(mb.METHODS)
    data = json.loads(cache.read_text())
    assert data["cpu/C8"]["winner"] == res["winner"]
