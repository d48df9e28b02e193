"""`models/downlink.simulate_multiframe` at the CLI's seeds makes the
capture of `downlink --simulate`: the IQ the JAX package's CLI writes,
byte for byte, for the CLI's layouts (TCH/S with coded speech where the
codec builds, TCH/4.8 at depth 4), and the port's CLI writes the same."""

import jax
import numpy as np
import pytest

from tetraear_tpu.ui import cli as jax_cli

from tetraear_tpu_torch.models import downlink as dl
from tetraear_tpu_torch.ui import cli

CASES = [
    (["--slots", "16"], dict(slots=16)),
    (["--slots", "40", "--traffic-channel", "TCH/4.8", "--traffic-depth",
      "4", "--snr-db", "10", "--message", "ZONE 123"],
     dict(slots=40, traffic_channel="TCH/4.8", traffic_depth=4, snr_db=10.0,
          message="ZONE 123")),
]


@pytest.fixture(autouse=True)
def _log_dir(tmp_path, monkeypatch):
    """Both CLIs log under TETRAEAR_TPU_LOG_DIR; the JAX package's CLI
    also turns on jax's persistent compilation cache under $HOME: both go
    to a temporary directory, and the cache is off again after each
    test."""
    from jax._src import compilation_cache
    monkeypatch.setenv("TETRAEAR_TPU_LOG_DIR", str(tmp_path / "logs"))
    monkeypatch.setenv("HOME", str(tmp_path))
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
    compilation_cache.reset_cache()


@pytest.mark.parametrize("argv,kw", CASES, ids=["tchs16", "tch48_depth4"])
def test_generator_equals_the_cli_capture(tmp_path, capsys, argv, kw):
    ref, mine = tmp_path / "jax.cf32", tmp_path / "port.cf32"
    assert jax_cli.main(["downlink", str(ref), "--simulate", *argv,
                         "-o", str(tmp_path / "jax.jsonl")]) == 0
    assert cli.main(["downlink", str(mine), "--simulate", *argv,
                     "--device", "cpu",
                     "-o", str(tmp_path / "port.jsonl")]) == 0
    capsys.readouterr()
    sim = dl.simulate_multiframe(voice=True, **kw)
    assert sim.iq.dtype == np.complex64
    assert sim.iq.tobytes() == ref.read_bytes() == mine.read_bytes()
    # the plan is the capture's: a TN2 block a frame and the TN4 signalling
    assert sorted(k for k in sim.payloads if k % 4 == 1) == list(
        range(1, kw["slots"], 4))
    assert any(k % 4 == 3 for k in sim.payloads)


def test_other_seeds_other_capture():
    a = dl.simulate_multiframe(8, seed=0).iq
    b = dl.simulate_multiframe(8, seed=1).iq
    c = dl.simulate_multiframe(8, seed=0, start_mn=2).iq
    assert len(a) == len(b) == len(c)
    assert not np.array_equal(a, b) and not np.array_equal(a, c)
