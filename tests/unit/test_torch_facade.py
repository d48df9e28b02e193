"""The port's package facade, console script and launcher against the
JAX package's, on the CPU.

`tetraear_tpu_torch` re-exports the configs and loads the reference's
eleven facade classes on first use, from the port's twin modules;
importing it builds and launches nothing.  The console script
`tetraear-tpu-torch` and the root launcher `run_tetraear_torch.sh` run
the port's command line, on its --device default."""

import importlib
import inspect
import os
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

import tetraear_tpu

import tetraear_tpu_torch

REPO = Path(__file__).resolve().parents[2]
FIXTURE = REPO / "tests" / "conformance" / "fixtures" / "clean.cf32"
DEVICE_CLASSES = ("SignalProcessor", "TetraDecoder", "TetraSignalDetector",
                  "FrequencyScanner")


def test_all_equals_the_jax_packages():
    assert tetraear_tpu_torch.__all__ == tetraear_tpu.__all__
    assert len(tetraear_tpu_torch.__all__) == 13
    assert tetraear_tpu_torch._LAZY == {
        name: module.replace("tetraear_tpu.", "tetraear_tpu_torch.", 1)
        for name, module in tetraear_tpu._LAZY.items()}


@pytest.mark.parametrize("name", tetraear_tpu.__all__ + ["DEFAULT_CONFIG"])
def test_each_name_is_the_ports_twin(name):
    """Each export is the object of the port's module at the JAX one's
    path, never the JAX package's."""
    got = getattr(tetraear_tpu_torch, name)
    jax_module = tetraear_tpu._LAZY.get(name, "tetraear_tpu.config")
    twin = importlib.import_module(
        jax_module.replace("tetraear_tpu.", "tetraear_tpu_torch.", 1))
    assert got is getattr(twin, name)
    assert got is not getattr(tetraear_tpu, name)
    cls = type(got) if name == "DEFAULT_CONFIG" else got
    assert cls.__module__ == twin.__name__


@pytest.mark.parametrize("name", DEVICE_CLASSES)
def test_device_is_keyword_only_and_required(name):
    """The device rule: a class that puts tensors on a device takes it
    as a keyword-only argument without a default."""
    param = inspect.signature(getattr(tetraear_tpu_torch, name)).parameters[
        "device"]
    assert param.kind is inspect.Parameter.KEYWORD_ONLY
    assert param.default is inspect.Parameter.empty


def test_unknown_name_raises_naming_the_port():
    with pytest.raises(AttributeError,
                       match="module 'tetraear_tpu_torch' has no attribute "
                             "'NoSuchClass'"):
        tetraear_tpu_torch.NoSuchClass


def test_import_builds_and_loads_nothing():
    """In a fresh interpreter, with jax and the JAX package refused:
    importing the package loads no kernel module, no C++ extension
    build module and not torch; the first use of a class loads its module."""
    code = """
import sys
REFUSED = ("jax", "jaxlib", "tetraear_tpu")
class RefuseReference:
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in REFUSED:
            raise ModuleNotFoundError(name + " is refused", name=name)
        return None
sys.meta_path.insert(0, RefuseReference())
import tetraear_tpu_torch
loaded = sorted(m for m in sys.modules
                if m.startswith(("tetraear_tpu_torch.ops",
                                 "torch.utils.cpp_extension", "jax"))
                or m == "torch")
assert not loaded, loaded
assert "tetraear_tpu_torch.crypto.tea" not in sys.modules
tetraear_tpu_torch.TEADecryptor
assert "tetraear_tpu_torch.crypto.tea" in sys.modules
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and proc.stdout == "ok\n", proc.stderr[-2000:]


def test_console_scripts():
    """pyproject.toml names both command lines, each one importable."""
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())[
        "project"]["scripts"]
    assert scripts == {"tetraear-tpu": "tetraear_tpu.ui.cli:main",
                       "tetraear-tpu-torch": "tetraear_tpu_torch.ui.cli:main"}
    module, _, attr = scripts["tetraear-tpu-torch"].partition(":")
    assert callable(getattr(importlib.import_module(module), attr))


def _launcher(tmp_path, *argv):
    env = {**os.environ, "TETRAEAR_TPU_LOG_DIR": str(tmp_path),
           "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run(["sh", str(REPO / "run_tetraear_torch.sh"),
                           *argv], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=50)


def test_launcher_runs_the_ports_tui_on_its_device_default(tmp_path):
    """run_tetraear_torch.sh passes its arguments to the port's `tui`:
    on its cuda default without a card it exits naming --device cpu;
    with --device cpu it replays a capture headless and shows its
    frames."""
    argv = ["--iq-file", str(FIXTURE), "--no-afc", "--max-chunks", "1"]
    proc = _launcher(tmp_path, *argv)
    assert proc.returncode != 0
    assert "pass --device cpu" in proc.stderr
    proc = _launcher(tmp_path, *argv, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Frames: 1" in proc.stdout
    assert (REPO / "run_tetraear.sh").read_text().rstrip().endswith(
        "exec python -m tetraear_tpu tui \"$@\"")
