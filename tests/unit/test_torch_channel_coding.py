"""The port's control-channel coding (`ops/scramble.py`, `ops/interleave.py`,
`ops/viterbi.py`, `ops/channel_coding.py`) and the etsi link
(`models/etsi_link.py`) against the JAX package, on the CPU, and on the
card.

Inputs are made with numpy from fixed seeds.  Every table, permutation,
sequence and host encoder must be `array_equal` to the reference's;
every decision — Viterbi bits (ties included), CRC verdicts, sync hits,
MAC bits — identical."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tetraear_tpu.models import etsi_link as jlink
from tetraear_tpu.ops import channel_coding as jcc
from tetraear_tpu.ops import interleave as jil
from tetraear_tpu.ops import scramble as jscr
from tetraear_tpu.ops import viterbi as jvit

from tetraear_tpu_torch.models import etsi_link as tlink
from tetraear_tpu_torch.ops import channel_coding as tcc
from tetraear_tpu_torch.ops import interleave as til
from tetraear_tpu_torch.ops import scramble as tscr
from tetraear_tpu_torch.ops import viterbi as tvit

CHANNELS = list(tcc.CHANNEL_GEOMETRY)
ECC = jscr.extended_colour_code(260, 98, 5)


def _llrs(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _noisy_coded(bits, seed, sigma=0.6):
    """Hard coded bits as +-1 soft values with AWGN of std sigma."""
    r = np.random.default_rng(seed)
    x = bits.astype(np.float32) * 2 - 1
    return (x + sigma * r.standard_normal(x.shape)).astype(np.float32)


def _mac_resource(payload: bytes, rng, address=0x0ABC):
    """A 268-bit SCH/F MAC-RESOURCE block (tests/unit/test_etsi_link.py's)."""
    def u(v, n):
        return [(v >> (n - 1 - i)) & 1 for i in range(n)]
    head = [0, 0, 0, 0, 0] + u(address, 24) + u(len(payload), 6)
    bits = head + list(np.unpackbits(np.frombuffer(payload, np.uint8)))
    bits += list(rng.integers(0, 2, 268 - len(bits)))
    return np.array(bits, np.uint8)


class TestTables:
    def test_trellis_puncturing_and_encoders(self):
        for got, want in zip(tvit._tables(), jvit._tables()):
            np.testing.assert_array_equal(got, want)
        for n in (64, 140, 288, 292):
            np.testing.assert_array_equal(tvit.puncture_indices(n),
                                          jvit.puncture_indices(n))
        for n_in, n_out in ((292, 432), (148, 432), (144, 216), (60, 180)):
            np.testing.assert_array_equal(
                tvit.puncture_indices_spec(n_in, n_out),
                jvit.puncture_indices_spec(n_in, n_out))
        r = np.random.default_rng(0)
        for n in (60, 124, 268):
            bits = r.integers(0, 2, n).astype(np.uint8)
            for term in (True, False):
                np.testing.assert_array_equal(tvit.conv_encode(bits, term),
                                              jvit.conv_encode(bits, term))
            np.testing.assert_array_equal(tvit.encode_rate_2_3(bits),
                                          jvit.encode_rate_2_3(bits))
        for n, n_out in ((288, 432), (144, 432)):
            bits = r.integers(0, 2, n).astype(np.uint8)
            np.testing.assert_array_equal(tvit.encode_punctured(bits, n_out),
                                          jvit.encode_punctured(bits, n_out))

    def test_permutations_and_scrambling_sequences(self):
        assert til.BLOCK_PARAMS == jil.BLOCK_PARAMS
        for k, a in til.BLOCK_PARAMS.values():
            np.testing.assert_array_equal(til._perm(k, a), jil._perm(k, a))
            np.testing.assert_array_equal(til._inv_perm(k, a),
                                          jil._inv_perm(k, a))
        assert (tscr.extended_colour_code(260, 98, 5)
                == jscr.extended_colour_code(260, 98, 5))
        for ecc in (0, 1, ECC, (1 << 30) - 1):
            np.testing.assert_array_equal(tscr.scrambling_sequence(ecc, 432),
                                          jscr.scrambling_sequence(ecc, 432))

    @pytest.mark.parametrize("channel", CHANNELS)
    def test_encode_channel(self, channel):
        assert tcc.CHANNEL_GEOMETRY == jcc.CHANNEL_GEOMETRY
        k1, _ = tcc.CHANNEL_GEOMETRY[channel]
        bits = np.random.default_rng(k1).integers(0, 2, k1).astype(np.uint8)
        for ecc in (0, ECC):
            np.testing.assert_array_equal(
                tcc.encode_channel(bits, channel, ecc),
                jcc.encode_channel(bits, channel, ecc))


class TestScrambleInterleave:
    @pytest.mark.parametrize("ecc", [0, ECC])
    def test_scramble(self, ecc):
        bits = np.random.default_rng(1).integers(0, 2, (3, 216)).astype(
            np.uint8)
        got = tscr.scramble(torch.as_tensor(bits), ecc)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jscr.scramble(jnp.asarray(bits), ecc)))
        np.testing.assert_array_equal(tscr.descramble(got, ecc).numpy(), bits)
        llrs = _llrs((3, 216), 2)
        np.testing.assert_array_equal(
            tscr.scramble_soft(torch.as_tensor(llrs), ecc).numpy(),
            np.asarray(jscr.scramble_soft(jnp.asarray(llrs), ecc)))

    @pytest.mark.parametrize("channel", CHANNELS)
    def test_interleave(self, channel):
        k, _ = til.BLOCK_PARAMS[channel]
        llrs = _llrs((2, k), k)
        for fn in ("interleave", "deinterleave"):
            np.testing.assert_array_equal(
                getattr(til, fn)(torch.as_tensor(llrs), channel).numpy(),
                np.asarray(getattr(jil, fn)(jnp.asarray(llrs), channel)))

    @pytest.mark.parametrize("depth", [1, 4, 8])
    def test_multiburst(self, depth):
        blocks = np.random.default_rng(depth).integers(0, 2, (5, 432)).astype(
            np.uint8)
        got = til.interleave_multiburst(torch.as_tensor(blocks), depth)
        want = jil.interleave_multiburst(blocks, depth)
        np.testing.assert_array_equal(got.numpy(), want)
        llrs = _llrs(want.shape, depth)
        np.testing.assert_array_equal(
            til.deinterleave_multiburst(torch.as_tensor(llrs), depth).numpy(),
            jil.deinterleave_multiburst(llrs, depth))


class TestViterbi:
    @pytest.mark.parametrize("terminated", [True, False])
    def test_noisy_batch(self, terminated):
        """Random message bits through the mother code and AWGN: the same
        decoded bits as the reference's scan, batched over (2, 3)."""
        n = 292
        r = np.random.default_rng(3)
        msgs = r.integers(0, 2, (6, n - 4)).astype(np.uint8)
        coded = np.stack([jvit.conv_encode(m) for m in msgs])
        llrs = _noisy_coded(coded, 4, sigma=1.1).reshape(2, 3, -1)
        got = tvit.viterbi_decode(torch.as_tensor(llrs), n, terminated)
        want = np.asarray(jvit.viterbi_decode(jnp.asarray(llrs), n,
                                              terminated))
        assert got.dtype == torch.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("case", ["zeros", "hard", "sparse"])
    def test_ties(self, case):
        """Soft values that make many path metrics equal: all zeros (every
        comparison a tie, the end state argmax over 16 equal metrics),
        hard +-1 values and a few erasures among them; the tie rules
        (predecessor 0, the first best end state) are the reference's."""
        n = 140
        r = np.random.default_rng(5)
        if case == "zeros":
            llrs = np.zeros((2, 4 * n), np.float32)
        else:
            llrs = (r.integers(0, 2, (4, 4 * n)) * 2 - 1).astype(np.float32)
            if case == "sparse":
                llrs[r.random(llrs.shape) < 0.5] = 0.0
        for terminated in (True, False):
            np.testing.assert_array_equal(
                tvit.viterbi_decode(torch.as_tensor(llrs), n,
                                    terminated).numpy(),
                np.asarray(jvit.viterbi_decode(jnp.asarray(llrs), n,
                                               terminated)))

    def test_depuncture_and_rate_2_3(self):
        n = 124 + 16 + 4
        r = np.random.default_rng(6)
        msgs = r.integers(0, 2, (4, n - 4)).astype(np.uint8)
        coded = np.stack([jvit.encode_rate_2_3(m) for m in msgs])
        llrs = _noisy_coded(coded, 7, sigma=0.5)
        np.testing.assert_array_equal(
            tvit.depuncture_llrs(torch.as_tensor(llrs), n).numpy(),
            np.asarray(jvit.depuncture_llrs(jnp.asarray(llrs), n)))
        got = tvit.decode_rate_2_3(torch.as_tensor(llrs), n).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jvit.decode_rate_2_3(jnp.asarray(llrs), n)))
        assert (got == msgs).mean() > 0.95

    @pytest.mark.parametrize("n_in", [292, 148])
    def test_decode_punctured(self, n_in):
        """The TCH/4.8 and TCH/2.4 puncturing schemes (432 air bits)."""
        r = np.random.default_rng(n_in)
        msgs = r.integers(0, 2, (3, n_in - 4)).astype(np.uint8)
        coded = np.stack([jvit.encode_punctured(m, 432) for m in msgs])
        llrs = _noisy_coded(coded, n_in + 1, sigma=0.9)
        np.testing.assert_array_equal(
            tvit.decode_punctured(torch.as_tensor(llrs), n_in).numpy(),
            np.asarray(jvit.decode_punctured(jnp.asarray(llrs), n_in)))


class TestChannelDecode:
    @pytest.mark.parametrize("channel", CHANNELS)
    def test_soft_and_hard(self, channel):
        """Batches of coded blocks, some decoded with the wrong scrambling
        code, some drowned in noise: the same MAC bits and CRC verdicts."""
        k1, air = tcc.CHANNEL_GEOMETRY[channel]
        r = np.random.default_rng(air)
        bits = r.integers(0, 2, (6, k1)).astype(np.uint8)
        coded = np.stack([jcc.encode_channel(b, channel, ECC) for b in bits])
        sigmas = np.array([0.3, 0.6, 0.9, 1.2, 2.0, 3.0], np.float32)
        llrs = (_noisy_coded(coded, air + 1, 1.0) - (coded * 2 - 1.0)) \
            * sigmas[:, None] + (coded * 2 - 1.0)
        llrs = llrs.astype(np.float32)
        verdicts = []
        for ecc in (ECC, 0):
            got = tcc.decode_channel_soft(torch.as_tensor(llrs), channel, ecc)
            want = jcc.decode_channel_soft(jnp.asarray(llrs), channel, ecc)
            assert got.bits.dtype == torch.uint8
            assert got.crc_ok.dtype == torch.bool
            np.testing.assert_array_equal(got.bits.numpy(),
                                          np.asarray(want.bits))
            np.testing.assert_array_equal(got.crc_ok.numpy(),
                                          np.asarray(want.crc_ok))
            verdicts.append(got.crc_ok.numpy())
        assert verdicts[0][:2].all() and not verdicts[1].any()
        np.testing.assert_array_equal(
            tcc.decode_channel_soft(torch.as_tensor(llrs[:2]), channel,
                                    ECC).bits.numpy(), bits[:2])
        hard = (llrs > 0).astype(np.uint8)
        got = tcc.decode_channel_hard(torch.as_tensor(hard), channel, ECC)
        want = jcc.decode_channel_hard(jnp.asarray(hard), channel, ECC)
        np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))
        np.testing.assert_array_equal(got.crc_ok.numpy(),
                                      np.asarray(want.crc_ok))


def _same_frames(got, want):
    assert [f.sync_symbol for f in got] == [f.sync_symbol for f in want]
    assert [f.crc_ok for f in got] == [f.crc_ok for f in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.mac_bits, w.mac_bits)
        assert (g.mac_pdu is None) == (w.mac_pdu is None)
        if g.mac_pdu is not None:
            assert g.mac_pdu.pdu_type == w.mac_pdu.pdu_type
            assert bytes(g.mac_pdu.data) == bytes(w.mac_pdu.data)


class TestEtsiLink:
    def test_burst_and_transmit_equal_the_reference(self, rng):
        macs = [_mac_resource(b"BURST %d" % i, rng) for i in range(2)]
        np.testing.assert_array_equal(
            tlink.build_burst_bits(macs[0], ecc30=ECC),
            jlink.build_burst_bits(macs[0], ecc30=ECC))
        for snr in (None, 12):
            np.testing.assert_array_equal(
                tlink.transmit(macs, snr_db=snr, seed=3),
                jlink.transmit(macs, snr_db=snr, seed=3))

    @pytest.mark.parametrize("snr_db,seed,min_ok", [(None, 5, 3), (12, 7, 3)])
    def test_round_trip(self, rng, snr_db, seed, min_ok):
        """Clean: every frame CRC-ok; 12 dB: at least 3 of 4.  The same
        hits, verdicts and MAC bits as the reference's receiver."""
        n = 3 if snr_db is None else 4
        macs = [_mac_resource(b"LINK %d" % i, np.random.default_rng(seed + i))
                for i in range(n)]
        iq = tlink.transmit(macs, snr_db=snr_db, seed=seed)
        got = tlink.EtsiLinkReceiver(device="cpu").receive(iq)
        _same_frames(got, jlink.EtsiLinkReceiver().receive(iq))
        good = [f for f in got if f.crc_ok]
        assert len(good) >= min_ok and (snr_db is not None or len(good) == n)
        for f in good:
            i = int(bytes(f.mac_pdu.data)[-1:].decode())
            np.testing.assert_array_equal(f.mac_bits, macs[i])

    def test_scrambling_and_offset(self, rng):
        macs = [_mac_resource(b"SCRAMBLED", rng)]
        iq = tlink.transmit(macs, ecc30=ECC, seed=9)
        assert sum(f.crc_ok for f in tlink.EtsiLinkReceiver(
            ecc30=ECC, device="cpu").receive(iq)) == 1
        assert sum(f.crc_ok for f in tlink.EtsiLinkReceiver(
            device="cpu").receive(iq)) == 0
        iq = tlink.transmit([_mac_resource(b"OFFSET", rng)], seed=11)
        t = np.arange(len(iq)) / 2.4e6
        iq = (iq * np.exp(2j * np.pi * 1500.0 * t)).astype(np.complex64)
        got = tlink.EtsiLinkReceiver(device="cpu").receive(iq, 1500.0)
        _same_frames(got, jlink.EtsiLinkReceiver().receive(iq, 1500.0))
        assert sum(f.crc_ok for f in got) == 1
        assert tlink.EtsiLinkReceiver(device="cpu").receive(
            np.zeros(1000, np.complex64)) == []


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_viterbi_and_channel_decode_on_card_match_cpu(cuda_device):
    """The Viterbi and the SCH/F decode on the card: the same bits and
    verdicts as the CPU's, every output on the card."""
    llrs = _llrs((8, 4 * 292), 12, scale=2.0)
    got = tvit.viterbi_decode(torch.as_tensor(llrs, device=cuda_device), 292)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(
        got.cpu().numpy(), tvit.viterbi_decode(torch.as_tensor(llrs), 292))
    coded = _llrs((8, 432), 13, scale=1.5)
    got = tcc.decode_channel_soft(torch.as_tensor(coded, device=cuda_device))
    want = tcc.decode_channel_soft(torch.as_tensor(coded))
    assert got.bits.device.type == got.crc_ok.device.type == "cuda"
    np.testing.assert_array_equal(got.bits.cpu().numpy(), want.bits.numpy())
    np.testing.assert_array_equal(got.crc_ok.cpu().numpy(),
                                  want.crc_ok.numpy())


@pytest.mark.cuda
def test_etsi_link_on_card(cuda_device):
    macs = [_mac_resource(b"CARD %d" % i, np.random.default_rng(i))
            for i in range(4)]
    iq = tlink.transmit(macs, snr_db=12, seed=7)
    got = tlink.EtsiLinkReceiver(device=cuda_device).receive(iq)
    _same_frames(got, tlink.EtsiLinkReceiver(device="cpu").receive(iq))
    assert sum(f.crc_ok for f in got) >= 3
