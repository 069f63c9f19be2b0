"""Nothing the harness imports is JAX or the JAX package, compared on
whole top-level names (``kantts_tpu_torch`` starts with ``kantts_tpu``
and is not it)."""

import json
import os
import subprocess
import sys
import types

from h100bench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from h100bench import harness, readings, devtrace, flops, traffic_gen, weights
from h100bench.paths import vocode
spec = harness.load_json({root!r} + "/BENCHMARK.json")
for m in spec["per_layer"]:
    harness.reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_harness_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT)],
                         capture_output=True, text=True, timeout=300, check=True)
    tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert "kantts_tpu_torch" in tops and "h100bench" in tops
    assert not set(tops) & set(harness.FORBIDDEN), tops


def test_forbidden_names_are_whole(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "kantts_tpu_torch_like", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "kantts_tpu.models", types.ModuleType("x"))
    assert "kantts_tpu" in harness.forbidden_modules()
