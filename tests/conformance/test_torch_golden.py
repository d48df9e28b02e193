"""The recorded golden captures through the port's ref-exact receiver
(`tetraear_tpu_torch.models.receiver.SignalProcessor`) and host decoder
(`tetraear_tpu_torch.core.decoder.TetraDecoder`): every golden key of
every frame bit-exact, as tests/conformance/test_golden_fixtures.py
demands of the JAX package, on the CPU and on the card."""

import json

import numpy as np
import pytest
import torch

from tetraear_tpu.config import ReceiverConfig
from tetraear_tpu.io.replay import load_iq

from test_golden_fixtures import CASES, FIXTURES, _load_golden, _sanitize
from tetraear_tpu_torch.core.decoder import TetraDecoder
from tetraear_tpu_torch.models.receiver import SignalProcessor


def _assert_golden(name, frames, golden):
    assert len(frames) == len(golden), \
        f"{name}: {len(frames)} frames vs {len(golden)} golden"
    for i, (mine, gold) in enumerate(zip(frames, golden)):
        mine = json.loads(json.dumps(_sanitize(mine), sort_keys=True))
        for k, v in gold.items():
            assert k in mine, f"{name}[{i}]: missing key {k}"
            assert mine[k] == v, \
                f"{name}[{i}].{k}: {mine[k]!r} != golden {v!r}"


def _decode_capture(name, device):
    meta, golden = _load_golden(name)
    iq = np.asarray(load_iq(FIXTURES / f"{name}.cf32"))
    assert len(iq) == meta["samples"]
    sp = SignalProcessor(config=ReceiverConfig(profile="ref-exact"),
                         device=device)
    symbols = sp.process(iq, freq_offset=meta["freq_offset_hz"])
    frames = TetraDecoder(auto_decrypt=meta["auto_decrypt"],
                          device=device).decode(symbols)
    return frames, golden


def _decode_long_mixed(device):
    """The chunked offline loop of test_long_mixed_golden_bit_exact: one
    stateful decoder, a fresh receiver per chunk."""
    meta, golden = _load_golden("long_mixed")
    iq = np.asarray(load_iq(FIXTURES / "long_mixed.sc16"))
    assert len(iq) == meta["samples"]
    chunk_n = meta["chunk_samples"]
    dec = TetraDecoder(auto_decrypt=meta["auto_decrypt"], device=device)
    frames = []
    n_chunks = 0
    for start in range(0, len(iq), chunk_n):
        chunk = iq[start:start + chunk_n]
        if len(chunk) < 1000:
            break
        sp = SignalProcessor(config=ReceiverConfig(profile="ref-exact"),
                             device=device)
        for fr in dec.decode(sp.process(chunk, freq_offset=0.0)):
            fr["chunk"] = n_chunks
            frames.append(fr)
        n_chunks += 1
    assert n_chunks == meta["chunks"]
    return frames, golden


@pytest.mark.parametrize("name", CASES)
def test_golden_fixture_bit_exact(name):
    frames, golden = _decode_capture(name, "cpu")
    _assert_golden(name, frames, golden)


def test_long_mixed_golden_bit_exact():
    frames, golden = _decode_long_mixed("cpu")
    _assert_golden("long_mixed", frames, golden)
    sds = [f.get("sds_message") for f in frames]
    assert "[TXT] FRAG SPANS CHUNKS OK OK OK" in sds
    assert "[TXT] SECRET CALL 42!!" in sds


@pytest.mark.cuda
def test_golden_on_card():
    """The three captures and the chunked long_mixed on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in CASES:
        _assert_golden(name, *_decode_capture(name, "cuda"))
    _assert_golden("long_mixed", *_decode_long_mixed("cuda"))
