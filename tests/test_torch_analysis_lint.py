"""``paddle_tpu_torch.analysis.lint`` against the JAX package's linter:
every snippet of the reference's lint cases (``tests/test_analysis.py``)
fires the same rules in both packages, the torch syncs are flagged where
the port's rules say, and the port lints clean."""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import subprocess
import sys
from pathlib import Path

import pytest

from paddle_tpu.analysis import lint as jlint
from paddle_tpu_torch.analysis import lint as tlint

REPO = Path(__file__).resolve().parents[1]

TIME = "import time\n\ndef tick():\n    return time.monotonic()\n"
NP = "import numpy as np\n\n"
FLAGS_IMPORT = "from paddle_tpu.platform.flags import FLAGS\n"

# (snippet, the path it is linted as, the rule codes it must fire): the
# reference's cases (tests/test_analysis.py:627-741), linted by both
CASES = {
    "wall_clock_serving": (TIME, "serving/x.py", ["wall-clock"]),
    "wall_clock_master": (TIME, "master/x.py", ["wall-clock"]),
    "wall_clock_out_of_scope": (TIME, "reader/x.py", []),
    "wall_clock_injected_default": (
        "import time\n\ndef f(time_fn=time.monotonic):\n"
        "    return time_fn()\n", "serving/x.py", []),
    "wall_clock_module_alias": (
        "import time as t\n\ndef tick():\n    return t.monotonic()\n",
        "serving/x.py", ["wall-clock"]),
    "wall_clock_function_alias": (
        "from time import monotonic\n\ndef tick():\n"
        "    return monotonic()\n", "serving/x.py", ["wall-clock"]),
    "allow_same_line": (
        "import time\n\ndef tick():\n"
        "    return time.monotonic()  # lint: allow(wall-clock)\n",
        "serving/x.py", []),
    "allow_line_above": (
        "import time\n\ndef tick():\n    # lint: allow(wall-clock)\n"
        "    return time.monotonic()\n", "serving/x.py", []),
    "allow_other_rule": (
        "import time\n\ndef tick():\n"
        "    return time.monotonic()  # lint: allow(host-sync)\n",
        "serving/x.py", ["wall-clock"]),
    "unseeded_random": (NP + "def f():\n    return np.random.randn(3)\n",
                        "utils.py", ["unseeded-random"]),
    "seeded_random": (NP + "def f(seed):\n"
                      "    return np.random.RandomState(seed).randn(3)\n",
                      "utils.py", []),
    "host_sync_loop": (NP + "def step(rows):\n    for r in rows:\n"
                       "        v = np.asarray(r)\n        w = r.item()\n",
                       "serving/x.py", ["host-sync", "host-sync"]),
    "host_sync_outside_loop": (NP + "def step(r):\n"
                               "    return np.asarray(r)\n",
                               "serving/x.py", []),
    "host_sync_out_of_scope": (NP + "def step(rows):\n    for r in rows:\n"
                               "        v = np.asarray(r)\n",
                               "reader/x.py", []),
    "host_sync_float_of_jax": (
        "import jax.numpy as jnp\n\ndef step(rows):\n    out = []\n"
        "    for r in rows:\n        out.append(float(jnp.mean(r)))\n"
        "    return out\n", "serving/x.py", ["host-sync"]),
    "mutable_default": ("def f(x, acc=[]):\n    acc.append(x)\n"
                        "    return acc\n", "utils.py", ["mutable-default"]),
    "immutable_default": ("def f(x, acc=None):\n"
                          "    return (acc or []) + [x]\n", "utils.py", []),
    "import_time_flags": (FLAGS_IMPORT + "PERIOD = FLAGS.log_period\n",
                          "x.py", ["import-time-flags"]),
    "import_time_flags_default": (
        FLAGS_IMPORT + "def f(period=FLAGS.log_period):\n"
        "    return period\n", "x.py", ["import-time-flags"]),
    "flags_registry_and_call_time": (
        FLAGS_IMPORT + "FLAGS.define('x', 1, 'help')\n"
        "def f():\n    return FLAGS.log_period\n", "x.py", []),
    "flags_in_nested_defs": (
        FLAGS_IMPORT + "try:\n    def f():\n        return FLAGS.log_period\n"
        "except ImportError:\n    pass\nif True:\n    def g():\n"
        "        return FLAGS.seed\n", "x.py", []),
    "flags_in_module_if": (FLAGS_IMPORT + "if True:\n"
                           "    PERIOD = FLAGS.log_period\n",
                           "x.py", ["import-time-flags"]),
}

# the torch syncs the port's host-sync rule learned (the JAX package's
# linter does not know them)
TORCH_CASES = {
    "item_tolist_cpu_in_loop": (
        "def step(rows):\n    for r in rows:\n        a = r.item()\n"
        "        b = r.tolist()\n        c = r.cpu()\n",
        "serving/x.py", ["host-sync"] * 3),
    "tolist_outside_loop": ("def step(r):\n    return r.tolist()\n",
                            "serving/x.py", []),
    "float_of_torch_in_while": (
        "import torch\n\ndef step(xs):\n    i = 0\n    while i < 3:\n"
        "        v = int(torch.argmax(xs[i]))\n        i += 1\n",
        "obs/x.py", ["host-sync"]),
    "float_of_host_value": ("def step(xs):\n    for x in xs:\n"
                            "        v = float(x)\n", "serving/x.py", []),
    "cuda_synchronize_anywhere": (
        "import torch\n\ndef wait():\n    torch.cuda.synchronize()\n",
        "platform/x.py", ["host-sync"]),
    "stream_and_event_synchronize": (
        "import torch\n\ndef wait(ev):\n"
        "    torch.cuda.current_stream().synchronize()\n"
        "    ev.synchronize()\n", "resilience/x.py", ["host-sync"] * 2),
    "synchronize_out_of_scope": (
        "import torch\n\ndef wait():\n    torch.cuda.synchronize()\n",
        "tools/x.py", []),
    "synchronize_allowed": (
        "import torch\n\ndef wait():\n"
        "    torch.cuda.synchronize()  # lint: allow(host-sync)\n",
        "serving/x.py", []),
}


def _codes(findings):
    return sorted(d.code for d in findings)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_cases_fire_the_same_rules(case, tmp_path):
    """Each snippet linted as a file under ``<pkg>/<path>`` of each
    package: the same rule codes (and count) in both."""
    src, rel, want = CASES[case]
    jpath = f"paddle_tpu/{rel}"
    tpath = f"paddle_tpu_torch/{rel}"
    assert _codes(jlint.lint_source(src, jpath)) == sorted(want)
    assert _codes(tlint.lint_source(src, tpath)) == sorted(want)


@pytest.mark.parametrize("case", sorted(TORCH_CASES))
def test_torch_syncs_are_flagged(case):
    src, rel, want = TORCH_CASES[case]
    assert _codes(tlint.lint_source(src, f"paddle_tpu_torch/{rel}")) \
        == sorted(want)


def test_scopes_rules_from_resolved_path(tmp_path, monkeypatch):
    """Dir-scoped rules fire when a file is linted by bare filename from
    inside its directory: scoping resolves the path, as in the JAX
    package."""
    d = tmp_path / "serving"
    d.mkdir()
    (d / "x.py").write_text(TIME)
    monkeypatch.chdir(d)
    assert _codes(tlint.lint_file("x.py")) == ["wall-clock"]
    assert _codes(jlint.lint_file("x.py")) == ["wall-clock"]


def test_rules_are_the_reference_rules():
    assert sorted(tlint.RULES) == sorted(jlint.RULES)


def test_port_lints_clean():
    """The acceptance bar: the port lints clean (real findings fixed,
    justified ones allow-listed inline)."""
    findings = tlint.run_lint()
    assert findings == [], [d.message for d in findings]


def test_lint_cli_exit_codes(tmp_path):
    """``python -m paddle_tpu_torch.analysis lint``: 0 on the tree, 1 and
    the LINT-FAIL tag on a finding, 2 on an unknown rule."""
    bad = tmp_path / "serving"
    bad.mkdir()
    (bad / "x.py").write_text(TIME)

    def run(*argv):
        return subprocess.run([sys.executable, "-m",
                               "paddle_tpu_torch.analysis", *argv],
                              cwd=REPO, capture_output=True, text=True,
                              timeout=300,
                              env={"PATH": "/usr/bin:/bin",
                                   "PYTHONPATH": str(REPO)})

    ok = run("lint")
    assert ok.returncode == 0 and "lint ok: 0 findings" in ok.stdout, \
        ok.stdout + ok.stderr
    found = run("lint", str(bad / "x.py"))
    assert found.returncode == 1 and "LINT-FAIL: 1 finding" in found.stdout
    assert run("lint", "--rule", "bogus").returncode == 2
