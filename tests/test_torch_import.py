"""Import hygiene of the PyTorch port (``streambench_tpu_torch``).

Importing every module of the port must not load JAX, must not start a
CUDA context and must not build anything (the native host library and
the CUDA kernel are compiled at first use).  Statically, no module of the
port and not ``chip_smoke.py`` may import JAX or the JAX package: the
check compares the FIRST dotted component of each imported name exactly,
because ``"streambench_tpu_torch".startswith("streambench_tpu")``.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "streambench_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "streambench_tpu"}
OBS_MODULES = ("__main__", "capture", "devmem", "flightrec", "httpd",
               "lifecycle", "occupancy", "registry", "regress", "report",
               "sampler", "slo", "spans", "xfer")
CHAOS_MODULES = ("inject", "plan", "supervisor", "verify")

CHILD = r"""
import json, pkgutil, subprocess, sys

def no_builds(*a, **kw):
    raise AssertionError(f"a process was started at import: {a!r}")

subprocess.Popen.__init__ = no_builds     # any compiler run fails loudly

import streambench_tpu_torch

names = sorted(m.name for m in pkgutil.walk_packages(
    streambench_tpu_torch.__path__, "streambench_tpu_torch."))
for name in names:
    __import__(name)

import torch
from streambench_tpu_torch import native
from streambench_tpu_torch.ops import _build

print(json.dumps({
    "modules": names,
    "jax": sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "streambench_tpu")),
    "cuda_initialized": torch.cuda.is_initialized(),
    "built": [native._lib is not None, native._tried,
              _build.count_cells_lib.lib is not None,
              _build.decode_rows_lib.lib is not None,
              _build.cms_rows_lib.lib is not None],
}))
"""


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_importing_every_module_loads_no_jax_no_cuda_and_builds_nothing():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", CHILD], capture_output=True,
                          text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = {"streambench_tpu_torch.engine.pipeline",
                "streambench_tpu_torch.engine.__main__",
                "streambench_tpu_torch.ops.count",
                "streambench_tpu_torch.ops.windowcount",
                "streambench_tpu_torch.ops.decode",
                "streambench_tpu_torch.ops.devdecode",
                "streambench_tpu_torch.ops.methodbench",
                "streambench_tpu_torch.native",
                "streambench_tpu_torch.datagen.gen",
                "streambench_tpu_torch.engine.sketches",
                "streambench_tpu_torch.ops.hll",
                "streambench_tpu_torch.ops.sliding",
                "streambench_tpu_torch.ops.tdigest",
                "streambench_tpu_torch.ops.session",
                "streambench_tpu_torch.ops.cms",
                "streambench_tpu_torch.ops.cmsrows",
                "streambench_tpu_torch.ops.salsa"} | {
                    f"streambench_tpu_torch.obs.{m}" for m in OBS_MODULES} | {
                    f"streambench_tpu_torch.chaos.{m}" for m in CHAOS_MODULES}
    assert expected <= set(got["modules"])
    assert got["jax"] == []
    assert got["cuda_initialized"] is False
    assert got["built"] == [False, False, False, False, False]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_module_imports_jax_or_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_first_component_rule_tells_the_packages_apart():
    """The reason the scan splits on dots: a prefix test would flag the
    port itself (and miss nothing more)."""
    assert "streambench_tpu_torch".startswith("streambench_tpu")
    assert "streambench_tpu_torch.ops".split(".")[0] not in FORBIDDEN
    assert "streambench_tpu.ops".split(".")[0] in FORBIDDEN


OBS_CHILD = r"""
import json, sys
import streambench_tpu_torch.obs
for m in sys.argv[1:]:
    __import__("streambench_tpu_torch.obs." + m)
print(json.dumps({
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib",
                                            "streambench_tpu", "torch")),
}))
"""


def test_obs_package_imports_no_jax_and_not_even_torch():
    """The obs layer builds nothing and touches no device at import: its
    device modules import torch inside the calls that need it, so the
    report CLI starts without torch and cannot initialise CUDA."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", OBS_CHILD,
                           *[m for m in OBS_MODULES if m != "__main__"]],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "loaded": []}


CHAOS_CHILD = r"""
import json, subprocess, sys

def no_builds(*a, **kw):
    raise AssertionError(f"a process was started at import: {a!r}")

subprocess.Popen.__init__ = no_builds

import streambench_tpu_torch.chaos
for m in sys.argv[1:]:
    __import__("streambench_tpu_torch.chaos." + m)
import torch
from streambench_tpu_torch.chaos import FaultPlan
FaultPlan.generate(1, sink_rate=0.5, sink_ops=10, crashes=2)
print(json.dumps({
    "jax": sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "streambench_tpu")),
    "cuda_initialized": torch.cuda.is_initialized(),
}))
"""


def test_chaos_package_imports_no_jax_and_initialises_no_cuda():
    """The chaos layer is host code: importing it (and rolling a plan)
    loads nothing of JAX or the JAX package, starts no process and
    touches no CUDA context."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", CHAOS_CHILD,
                           *CHAOS_MODULES], capture_output=True, text=True,
                          timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "jax": [], "cuda_initialized": False}
