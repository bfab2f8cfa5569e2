"""Smoke tests for the benchmark entry (``bench.py``) and ``chip_smoke.py``.

The bench pipeline -- corpus generation, training, controller build,
closed-loop runner, gates, JSON schema -- runs here at a tiny batch so a
refactor cannot silently break the metric between chip runs.  It runs in
a SUBPROCESS in bench.py's real environment (f32, no forced x64): the
conftest's x64 flag would promote the QP to float64 and its stricter ok
thresholds.  The scripts themselves must refuse to measure on the CPU.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_ENABLE_X64", None)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    return env


def _python(code, env=None, timeout=900):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, cwd=REPO,
                          env=env or _env())


def test_bench_cli_tiny_batch():
    res = _python("import bench, json; print(json.dumps(bench.measure("
                  "batch=8, steps=12, reps=1)))")
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    out = json.loads(lines[0])
    assert out["metric"] == "kmpc_bilinear_closed_loop_steps_per_s_per_chip"
    assert out["unit"] == "mpc_steps/s"
    assert out["value"] > 0 and out["vs_baseline"] > 0
    d = out["detail"]
    assert d["alive_fraction"] == 1.0
    assert d["batch"] == 8 and d["steps"] == 12 and d["qp_iters"] == 4
    assert d["platform"] == "cpu" and d["device_count"] >= 1
    assert 0 < d["err_mean"] <= d["err_worst"]


def test_scripts_refuse_the_cpu():
    """``bench.py`` and ``chip_smoke.py`` exit non-zero on a machine
    without a GPU, and print no result."""
    for script in ("bench.py", "chip_smoke.py"):
        res = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, timeout=300, cwd=REPO, env=_env())
        assert res.returncode != 0, script
        assert "{" not in res.stdout, (script, res.stdout)
        assert "no GPU" in res.stderr, (script, res.stderr[-500:])


def test_compile_cache_location(tmp_path):
    """The compile cache follows JAX_COMPILATION_CACHE_DIR when set and is
    the fixed <repo>/.jax_cache otherwise."""
    code = ("import bench, jax; bench.setup_compile_cache(); "
            "print(jax.config.jax_compilation_cache_dir)")
    res = _python(code)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == os.path.join(REPO, ".jax_cache")
    env = _env()
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    res = _python(code, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == str(tmp_path)
