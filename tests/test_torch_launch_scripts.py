"""The port's launch scripts (``semseg_torch/tool/train.sh``, ``test.sh``),
the counterparts of ``tool/train.sh`` and ``tool/test.sh``, on the CPU.

Each runs in a scratch working directory that holds a config and the
package linked in, with a stub ``python3`` first on ``PATH`` that records
its argv, working directory and ``PYTHONPATH`` and prints one line: the
scripts' snapshot, commands, logs and exit statuses are checked without
training anything. A fresh interpreter then shows that the snapshot's
package (and its kernel build directory) is the one imported.
"""

import filecmp
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "semseg_torch"
STAMP = r"\d{8}_\d{6}"

# The stub records one line a call and fails with status 3 where the
# working directory holds a file named after the module.
_STUB = """#!/bin/sh
printf '%s|%s|%s\\n' "$PWD" "$PYTHONPATH" "$*" >> "{record}"
echo "stub $4 done"
if [ -f "fail-$3" ]; then exit 3; fi
"""


def _sources():
    """The package files a snapshot holds, relative to the package."""
    keep = {".py", ".cu", ".sh"}
    return sorted(p.relative_to(PKG).as_posix() for p in PKG.rglob("*")
                  if p.is_file() and p.suffix in keep
                  and not {"__pycache__", "build"} & set(p.relative_to(PKG).parts))


@pytest.fixture
def workdir(tmp_path):
    """A working directory with ``config/smoke/smoke_tiny.yaml`` and the
    package linked in, and a stub ``python3``; returns ``(dir, env,
    record)``."""
    (tmp_path / "config" / "smoke").mkdir(parents=True)
    (tmp_path / "config" / "smoke" / "smoke_tiny.yaml").write_text("DATA:\n  classes: 6\n")
    (tmp_path / "semseg_torch").symlink_to(PKG)
    stub_dir = tmp_path / "stub"
    stub_dir.mkdir()
    record = tmp_path / "calls.txt"
    stub = stub_dir / "python3"
    stub.write_text(_STUB.format(record=record))
    stub.chmod(0o755)
    env = dict(os.environ, PATH=f"{stub_dir}{os.pathsep}{os.environ['PATH']}")
    env.pop("PYTHONPATH", None)
    return tmp_path, env, record


def _run(script, workdir, *args):
    cwd, env, record = workdir
    proc = subprocess.run(["sh", f"semseg_torch/tool/{script}", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    calls = ([ln.split("|") for ln in record.read_text().splitlines()]
             if record.exists() else [])
    return proc, calls


def _assert_snapshot(exp):
    """The package's sources, byte for byte, the native loader's source
    and the config; nothing cached or built."""
    got = sorted(p.relative_to(exp / "semseg_torch").as_posix()
                 for p in (exp / "semseg_torch").rglob("*") if p.is_file())
    assert got == _sources()
    assert {"convergence.py", "csrc/psa.cu", "tool/train.sh", "tool/test.sh",
            "tool/_snapshot.sh"} <= set(got)
    _, mismatch, errors = filecmp.cmpfiles(PKG, exp / "semseg_torch", got, shallow=False)
    assert mismatch == errors == []
    assert filecmp.cmp(REPO / "csrc" / "hostpipe.cpp", exp / "csrc" / "hostpipe.cpp",
                       shallow=False)
    assert (exp / "smoke_tiny.yaml").read_text() == "DATA:\n  classes: 6\n"


def test_train_sh_snapshots_then_trains_and_tests(workdir):
    """Train, then test, each as ``python3 -P -m`` from the snapshot
    (``PYTHONPATH`` the experiment directory) with the config of the
    working directory, each teed to its timestamped log; the scripts'
    status is the test run's."""
    proc, calls = _run("train.sh", workdir, "smoke", "tiny")
    assert proc.returncode == 0, proc.stderr
    cwd, exp = str(workdir[0]), workdir[0] / "exp" / "smoke" / "tiny"
    assert calls == [
        [cwd, "exp/smoke/tiny", "-P -m semseg_torch.train --config=config/smoke/smoke_tiny.yaml"],
        [cwd, "exp/smoke/tiny", "-P -m semseg_torch.test --config=config/smoke/smoke_tiny.yaml"],
    ]
    _assert_snapshot(exp)
    (train_log,) = (exp / "model").iterdir()
    (test_log,) = (exp / "result").iterdir()
    assert re.fullmatch(f"train-({STAMP}).log", train_log.name)
    assert test_log.name == train_log.name.replace("train-", "test-")
    assert train_log.read_text() == "stub --config=config/smoke/smoke_tiny.yaml done\n"
    assert test_log.read_text() == train_log.read_text()
    assert proc.stdout == train_log.read_text() + test_log.read_text()


def test_test_sh_snapshots_and_tests_only(workdir):
    """``test.sh`` snapshots the same tree and runs the test driver alone,
    teed to ``result/test-<timestamp>.log``; a failing test run is its
    status."""
    (workdir[0] / "fail-semseg_torch.test").touch()
    proc, calls = _run("test.sh", workdir, "smoke", "tiny")
    assert proc.returncode == 3
    exp = workdir[0] / "exp" / "smoke" / "tiny"
    assert calls == [[str(workdir[0]), "exp/smoke/tiny",
                      "-P -m semseg_torch.test --config=config/smoke/smoke_tiny.yaml"]]
    _assert_snapshot(exp)
    assert not (exp / "model").exists()
    (log,) = (exp / "result").iterdir()
    assert re.fullmatch(f"test-{STAMP}.log", log.name)


def test_train_sh_stops_when_training_fails(workdir):
    """A failed training run ends ``train.sh`` with its status; the test
    driver does not run. A second launch replaces the snapshot."""
    (workdir[0] / "fail-semseg_torch.train").touch()
    stale = workdir[0] / "exp" / "smoke" / "tiny" / "semseg_torch" / "stale.py"
    stale.parent.mkdir(parents=True)
    stale.write_text("")
    proc, calls = _run("train.sh", workdir, "smoke", "tiny")
    assert proc.returncode == 3
    assert [c[2].split()[2] for c in calls] == ["semseg_torch.train"]
    assert not stale.exists()
    assert not list((workdir[0] / "exp" / "smoke" / "tiny" / "result").iterdir())


@pytest.mark.parametrize("script", ["train.sh", "test.sh"])
def test_usage_without_two_arguments(workdir, script):
    proc, calls = _run(script, workdir, "smoke")
    assert proc.returncode == 2 and "usage" in proc.stderr and calls == []
    assert not (workdir[0] / "exp").exists()


def test_snapshot_package_is_the_one_imported(workdir):
    """In a fresh interpreter started as the scripts start it (``-P``,
    ``PYTHONPATH`` the experiment directory, from a working directory whose
    ``semseg_torch`` is the repository's), ``semseg_torch`` and
    ``ops._build.BUILD_DIR`` resolve inside the snapshot, so its kernels
    build under ``exp/<dataset>/<exp_name>/build/``. Without ``-P`` the
    working directory's package would win."""
    _run("test.sh", workdir, "smoke", "tiny")
    cwd, env, _ = workdir
    exp = (cwd / "exp" / "smoke" / "tiny").resolve()
    env = dict(env, PYTHONPATH="exp/smoke/tiny")
    code = ("import semseg_torch, semseg_torch.ops._build as b; "
            "print(semseg_torch.__file__); print(b.BUILD_DIR)")
    out = subprocess.run([sys.executable, "-P", "-c", code], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=60, check=True).stdout
    pkg_file, build_dir = out.splitlines()
    assert Path(pkg_file).resolve() == exp / "semseg_torch" / "__init__.py"
    assert Path(build_dir) == exp / "build" / "semseg_torch_kernels"
    unsafe = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                            capture_output=True, text=True, timeout=60, check=True).stdout
    assert Path(unsafe.splitlines()[0]).resolve() == PKG / "__init__.py"
