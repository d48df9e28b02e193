"""The port's `decode` command line on the CPU — single-carrier in each
profile and wideband — its refusals, and the rule that the port never
imports jax."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tetraear_tpu.io.replay import save_iq
from tetraear_tpu.ui import cli as jax_cli

from tetraear_tpu_torch.ui import cli

REPO = Path(__file__).resolve().parents[2]
PLANTED = (3, 8, 12)        # grid indices of carrier_grid(16)


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """A .cf32 with golden bursts on three carriers of carrier_grid(16)."""
    from tetraear_tpu_torch.utils.synth import planted_wideband
    x, want = planted_wideband(PLANTED)
    path = tmp_path_factory.mktemp("iq") / "planted.cf32"
    save_iq(path, x)
    return path, want


def _texts(jsonl):
    got = {}
    for line in Path(jsonl).read_text().splitlines():
        frame = json.loads(line)
        got.setdefault(frame["carrier"], set()).add(frame.get("sds_message"))
    return got


def test_decode_finds_planted_texts_like_jax_cli(planted, tmp_path, capsys):
    """`decode --carriers 16 --conv s2d` on the CPU finds each planted
    text on its grid index, and the same texts per carrier as the JAX
    package's own `decode --carriers 16 --conv s2d`."""
    iq, want = planted
    out = tmp_path / "port.jsonl"
    rc = cli.main(["decode", str(iq), "--carriers", "16", "--conv", "s2d",
                   "--device", "cpu", "-o", str(out)])
    log = capsys.readouterr().out
    assert rc == 0
    assert "[DEVICE] cpu" in log and "[DONE]" in log and "[CARRIERS]" in log
    got = _texts(out)
    for k, text in want.items():
        assert text in got.get(k, set()), (k, got)
    ref = tmp_path / "jax.jsonl"
    assert jax_cli.main(["decode", str(iq), "--carriers", "16", "--conv",
                         "s2d", "-o", str(ref)]) == 0
    assert got == _texts(ref)


def test_chunks_keep_decoding(planted, tmp_path):
    """Several chunks, the last one zero-padded: the planted texts still
    come back (the stream is split mid-burst, so fewer slots survive)."""
    iq, want = planted
    out = tmp_path / "chunks.jsonl"
    assert cli.main(["decode", str(iq), "--carriers", "16", "--conv",
                     "pallas", "--chunk-size", "70000", "-o", str(out)]) == 0
    got = _texts(out)
    assert any(want[k] in got.get(k, set()) for k in want)


def test_pfb_decode_finds_planted_texts_on_fftfreq_channels(tmp_path,
                                                             capsys):
    """`decode --carriers 16 --pfb --conv pallas_bf16` on the CPU decodes
    all 96 channels; each planted text comes back on its fftfreq channel
    index (the reference's test_pfb.py:TestPfbFrontend signal)."""
    from tetraear_tpu_torch.utils.synth import planted_pfb
    x, want = planted_pfb()
    iq = tmp_path / "pfb.cf32"
    save_iq(iq, x)
    out = tmp_path / "pfb.jsonl"
    rc = cli.main(["decode", str(iq), "--carriers", "16", "--pfb", "--conv",
                   "pallas_bf16", "--device", "cpu", "-o", str(out)])
    log = capsys.readouterr().out
    assert rc == 0
    assert "across 96 carriers" in log and "plain version on the CPU" in log
    got = _texts(out)
    for c, text in want.items():
        assert text in got.get(c, set()), (c, got)


@pytest.mark.parametrize("argv,msg", [
    (["--carriers", "16", "--pfb", "--conv", "s2d_of"], "16-carrier variant"),
    (["--carriers", "16", "--afc"], "not ported yet"),
])
def test_refuses_what_is_not_ported(planted, argv, msg):
    with pytest.raises(SystemExit, match=msg):
        cli.main(["decode", str(planted[0]), *argv])


@pytest.mark.parametrize("profile,chunk", [
    ("ref-compat", None), ("ref-exact", None), ("etsi", None),
    ("ref-exact", 65536)])
def test_single_carrier_decode_equals_jax_cli(tmp_path, capsys, profile,
                                              chunk):
    """`decode --profile P` without --carriers on the CPU: the planted
    text comes back, and the frames JSONL equals the JAX package's own
    `decode --profile P` on the same file, byte for byte (with a small
    --chunk-size: three chunks, the last zero-padded)."""
    from tetraear_tpu_torch.utils.synth import planted_single
    x, text = planted_single(profile)
    iq = tmp_path / f"{profile}.cf32"
    save_iq(iq, x)
    size = [] if chunk is None else ["--chunk-size", str(chunk)]
    out = tmp_path / "port.jsonl"
    rc = cli.main(["decode", str(iq), "--profile", profile, "--device",
                   "cpu", "-o", str(out), *size])
    log = capsys.readouterr().out
    assert rc == 0
    assert f"single carrier, profile {profile}" in log
    for tag in ("[DEVICE] cpu", "[READABLE]", "[DONE]", "[PERF]",
                "[STATS]"):
        assert tag in log, tag
    frames = [json.loads(line) for line in out.read_text().splitlines()]
    assert text in [f.get("sds_message") for f in frames]
    ref = tmp_path / "jax.jsonl"
    assert jax_cli.main(["decode", str(iq), "--profile", profile, "-o",
                         str(ref), *size]) == 0
    assert out.read_text() == ref.read_text()


def test_unknown_profile_is_refused(planted, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["decode", str(planted[0]), "--profile", "fast"])
    assert exc.value.code == 2
    assert "invalid choice: 'fast'" in capsys.readouterr().err
    assert cli.build_parser().parse_args(
        ["decode", "x.cf32"]).profile == "ref-compat"


def test_conv_choices_come_from_the_variant_table(planted, capsys):
    """The frontends' table holds every ported conv and the staged chains;
    the CLI offers "auto" and the reference CLI's --conv choices among
    them.  pallas_db, pallas_of<N> and the staged chains by name are
    reached through the frontends, as in the reference; "auto" resolves
    as the reference's does."""
    from tetraear_tpu_torch.models.multicarrier import CONV_VARIANTS
    assert set(CONV_VARIANTS) == {"staged", "gather", "fused", "s2d",
                                  "s2d_of", "pallas", "pallas_bf16",
                                  "pallas_db", "pallas_of<N>",
                                  "pallas_of<N>_bf16"}
    assert cli.CLI_CONVS == ("auto", "s2d", "s2d_of", "pallas",
                             "pallas_bf16")
    # the reference's choices, as its argparse lists them on a bad one
    with pytest.raises(SystemExit):
        jax_cli.main(["decode", str(planted[0]), "--conv", "?"])
    listed = capsys.readouterr().err.split("choose from")[1].split(")")[0]
    ref_choices = {c.strip(" '") for c in listed.split(",")}
    assert "s2d_mono" in ref_choices and "auto" in ref_choices
    assert set(cli.CLI_CONVS) == ref_choices & (set(CONV_VARIANTS)
                                                | {"auto"})
    for conv in ("pallas_db", "pallas_of4", "staged", "gather", "fused"):
        with pytest.raises(SystemExit):
            cli.main(["decode", str(planted[0]), "--carriers", "16",
                      "--conv", conv])
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert cli.resolve_conv("auto", cpu, False) == "staged"
    assert cli.resolve_conv("auto", cpu, True) == "gather"
    assert cli.resolve_conv("auto", cuda, False) == "s2d"
    assert cli.resolve_conv("auto", cuda, True) == "s2d"
    assert cli.resolve_conv("pallas", cpu, True) == "pallas"
    assert cli.build_parser().parse_args(
        ["decode", "x.cf32"]).conv == "pallas_bf16"


def test_auto_conv_on_cpu_decodes_through_the_staged_chain(tmp_path,
                                                           capsys):
    """`decode --carriers 3 --conv auto --device cpu` runs the staged
    chain (the reference CLI's choice on the CPU) and decodes each
    planted text on its carrier."""
    from tetraear_tpu_torch.utils.synth import planted_wideband
    x, want = planted_wideband((0, 1, 2), num_carriers=3)
    iq = tmp_path / "three.cf32"
    save_iq(iq, x)
    out = tmp_path / "three.jsonl"
    rc = cli.main(["decode", str(iq), "--carriers", "3", "--conv", "auto",
                   "--device", "cpu", "-o", str(out)])
    log = capsys.readouterr().out
    assert rc == 0
    assert "conv auto -> staged" in log and "across 3 carriers" in log
    got = _texts(out)
    for k, text in want.items():
        assert text in got.get(k, set()), (k, got)


def test_auto_conv_pfb_on_cpu_decodes_through_the_gather_form(tmp_path,
                                                              capsys):
    """`decode --pfb --conv auto --device cpu` runs the gather-form
    filterbank over all 96 channels; each planted text comes back on its
    fftfreq channel."""
    from tetraear_tpu_torch.utils.synth import planted_pfb
    x, want = planted_pfb()
    iq = tmp_path / "pfb.cf32"
    save_iq(iq, x)
    out = tmp_path / "pfb.jsonl"
    rc = cli.main(["decode", str(iq), "--carriers", "16", "--pfb", "--conv",
                   "auto", "--device", "cpu", "-o", str(out)])
    log = capsys.readouterr().out
    assert rc == 0
    assert "conv auto -> gather" in log and "across 96 carriers" in log
    got = _texts(out)
    for c, text in want.items():
        assert text in got.get(c, set()), (c, got)


def test_cuda_device_without_card_raises(planted):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["decode", str(planted[0]), "--carriers", "16",
                  "--device", "cuda"])


def test_single_carrier_cuda_device_without_card_raises(planted):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["decode", str(planted[0]), "--profile", "ref-exact",
                  "--device", "cuda"])


def _run(code):
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_jax_package_loads_after_the_port():
    """The port's jax-free stand-in for tetraear_tpu.ops.crc hands over to
    the real module when a JAX-package module asks for a device function."""
    _run("import sys\n"
         "from tetraear_tpu_torch.models.multicarrier import "
         "MulticarrierDecoder\n"
         "MulticarrierDecoder(1)\n"
         "from tetraear_tpu_torch.core.decoder import TetraDecoder\n"
         "from tetraear_tpu_torch.models.etsi_link import "
         "EtsiLinkReceiver\n"
         "TetraDecoder(), EtsiLinkReceiver(device='cpu')\n"
         "assert 'jax' not in sys.modules\n"
         "from tetraear_tpu.models.multicarrier import MulticarrierFrontend\n"
         "crc = sys.modules['tetraear_tpu.ops.crc']\n"
         "assert crc.soft_crc_check_batch.__module__ == crc.__name__\n"
         "assert hasattr(crc, 'soft_crc_dense')\n")


def test_port_never_imports_jax():
    """Importing the port, building the host decoder and a planted signal
    leave jax out of sys.modules; no source line imports it."""
    code = (
        "import sys\n"
        "import tetraear_tpu_torch, tetraear_tpu_torch.models.multicarrier\n"
        "import tetraear_tpu_torch.ui.cli, tetraear_tpu_torch.core.decoder\n"
        "import tetraear_tpu_torch.models.receiver\n"
        "import tetraear_tpu_torch.models.etsi_link\n"
        "from tetraear_tpu_torch.models.multicarrier import "
        "MulticarrierDecoder\n"
        "from tetraear_tpu_torch.utils.synth import planted_wideband\n"
        "MulticarrierDecoder(2)\n"
        "planted_wideband([3], num_frames=1)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib')]\n"
        "assert not bad, bad[:5]\n")
    _run(code)
    for src in (REPO / "tetraear_tpu_torch").rglob("*.py"):
        for line in src.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), (
                src, line)
