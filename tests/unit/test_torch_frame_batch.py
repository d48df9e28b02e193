"""The port's batched frame decode (`protocol/burst_batch.py`, the
batch-then-tail `decode_walks`) against the JAX package's per-frame one,
on the CPU: the same bits, scores and counts give equal frame lists and
equal parser state, through `MulticarrierDecoder.decode` (one batch over
every row of a chunk), `TetraDecoder.decode_frame` and `parse_mac_pdu`
(batches of one); and the batched soft-CRC verdicts equal the per-frame
host check."""

import dataclasses
from collections import namedtuple

import numpy as np
import pytest
import torch

from tetraear_tpu.core.decoder import TetraDecoder as JaxDecoder
from tetraear_tpu.models import multicarrier as jmc
from tetraear_tpu.protocol.parser import TetraProtocolParser as JaxParser

from tetraear_tpu_torch import constants as C
from tetraear_tpu_torch.core.decoder import TetraDecoder
from tetraear_tpu_torch.models import multicarrier as tmc
from tetraear_tpu_torch.ops import crc
from tetraear_tpu_torch.ops.sync import best_correlation
from tetraear_tpu_torch.protocol.parser import (
    TetraProtocolParser as TetraParser)
from tetraear_tpu_torch.utils import synth

Result = namedtuple("Result", "bits sync_corr count")
ROW_BITS = 4096
STATE = ("stats", "fragment_buffer", "fragment_metadata", "mcc", "mnc",
         "colour_code")


def _head(*fields) -> np.ndarray:
    """MAC header bits from (value, width) fields and payload bytes."""
    out = []
    for field in fields:
        if isinstance(field, bytes):
            out.append(np.unpackbits(np.frombuffer(field, np.uint8)))
        else:
            out.append(synth._uint_to_bits(*field))
    return np.concatenate(out).astype(np.uint8)


def _slot(head, seed: int, sync_burst: bool = False) -> np.ndarray:
    """A golden 510-bit slot (its CRC solved) carrying `head`; with
    `sync_burst` a downlink sync word at mid-burst, which makes the
    parser read it as a sync burst (all 510 bits its data)."""
    slot = synth._golden_slot_from_head(head, seed, True)
    if sync_burst:
        slot[255:277] = C.SYNC_DISCONTINUOUS_DOWNLINK
    return slot


def _slots(r, seed: int) -> list:
    """One of every kind of slot the frame decode branches on."""
    return [
        synth.make_mac_resource_frame_bits(b"PLANTED %d" % seed, seed=seed),
        synth.make_mac_resource_frame_bits(r.bytes(12),
                                           encrypted=True, seed=seed + 1),
        # a length past the data: no MAC PDU, the CRC passes
        _slot(_head((0, 2), (0, 2), (0, 1), (0x4242, 24), (63, 6)), seed + 2),
        # SYSINFO with an MCC out of range, then a valid one, then a
        # broadcast of another kind (the call metadata's network)
        _slot(_head((2, 2), (0, 2), (900, 10), (5, 14), (3, 6)), seed + 3),
        _slot(_head((2, 2), (0, 2), (262, 10), (1, 14), (7, 6)), seed + 4),
        _slot(_head((2, 2), (1, 2), (234, 10), (15, 14), (9, 6),
                    b"\x01\x02\x03"), seed + 5),
        # a fragmented message: MAC-RESOURCE, MAC-FRAG, MAC-END
        synth.make_mac_resource_frame_bits(b"FIRST PART", seed=seed + 6),
        _slot(_head((1, 2), (0, 2), (0, 1), b" MIDDLE"), seed + 7),
        synth.make_mac_end_frame_bits(b" END", seed=seed + 8),
        # sync bursts: a normal header read over 510 data bits
        _slot(_head((0, 2), (0, 2), (0, 1), (77, 24), (4, 6), b"SYNC"),
              seed + 9, sync_burst=True),
        _slot(_head((3, 2), (0, 2), (0, 1), (2, 6), b"EN"), seed + 10,
              sync_burst=True),
    ]


def _row(r, slots) -> np.ndarray:
    """Slots at a random even lead, noise between and after; some bits
    flipped so that some CRCs fail."""
    lead = 2 * int(r.integers(0, 40))
    bits = [r.integers(0, 2, lead)]
    for s in slots:
        s = s.copy()
        if r.random() < 0.25:
            s[r.integers(0, 230, 3)] ^= 1
        bits.append(s)
    row = np.concatenate(bits + [r.integers(0, 2, ROW_BITS)])
    return row[:ROW_BITS].astype(np.uint8)


def _chunks(seed: int, rows: int = 6, chunks: int = 3) -> list:
    """`chunks` chunks of `rows` rows: planted rows carrying every kind
    of slot (the fragmented message split across two chunks on row 0),
    noise rows (false syncs) and a short row."""
    r = np.random.default_rng(seed)
    kinds = _slots(r, seed)
    out = []
    for k in range(chunks):
        bits = np.zeros((rows, ROW_BITS), np.uint8)
        count = np.full(rows, ROW_BITS // 2 + 1)
        for c in range(rows):
            if c == 0:
                picks = kinds[6:7] if k == 0 else kinds[7:9] + kinds[:2]
            elif c < 3:
                picks = [kinds[i] for i in r.permutation(len(kinds))[:6]]
            else:
                picks = []
            bits[c] = _row(r, picks)
        count[rows - 1] = int(r.integers(100, 400))
        corr = best_correlation(torch.as_tensor(bits)).numpy()
        out.append(Result(bits, corr, count))
    return out


def _same_frames(mine: list, ref: list) -> None:
    assert len(mine) == len(ref)
    for f, g in zip(mine, ref):
        assert f.keys() == g.keys()
        for k in f:
            if isinstance(f[k], np.ndarray):
                np.testing.assert_array_equal(f[k], g[k], err_msg=k)
            else:
                assert f[k] == g[k], k


def _same_state(mine, ref) -> None:
    for name in STATE:
        assert getattr(mine, name) == getattr(ref, name), name


def _multicarrier(seed: int) -> int:
    chunks = _chunks(seed)
    rows = chunks[0].bits.shape[0]
    mine = tmc.MulticarrierDecoder(rows, device="cpu")
    ref = jmc.MulticarrierDecoder(rows)
    n = 0
    for res in chunks:
        got = mine.decode(Result(*map(torch.as_tensor, res)))
        want = ref.decode(res)
        assert len(got) == len(want) == rows
        for a, b in zip(got, want):
            _same_frames(a, b)
            n += len(a)
    for a, b in zip(mine.decoders, ref.decoders):
        _same_state(a.protocol_parser, b.protocol_parser)
    return n


def _single(seed: int) -> int:
    """decode_frame on single slots, one decoder each side, in turn: with
    and without symbols, at an odd offset (symbols a bit ahead of the
    frame bits), longer than a slot, too short, symbols too short."""
    r = np.random.default_rng(seed)
    slots = _slots(r, seed) + [r.integers(0, 2, 510).astype(np.uint8)
                               for _ in range(4)]
    mine = TetraDecoder(auto_decrypt=False, device="cpu")
    ref = JaxDecoder(auto_decrypt=False)
    n = 0
    for i, slot in enumerate(slots):
        stream = np.concatenate([r.integers(0, 2, 1).astype(np.uint8), slot,
                                 r.integers(0, 2, 9).astype(np.uint8)])
        symbols = (stream[0::2].astype(np.int64) << 1) | stream[1::2]
        calls = [((slot, 0), {}),
                 ((slot, 7), {"symbols": (slot[0::2].astype(np.int64) << 1)
                              | slot[1::2], "frame_number": i}),
                 ((stream[1:512], 0), {"symbols": symbols[:255],
                                       "frame_number": i + 2}),
                 ((stream, 0), {}),
                 ((slot[:509], 0), {}),
                 ((slot, 0), {"symbols": symbols[:100]})]
        for args, kw in calls:
            a, b = mine.decode_frame(*args, **kw), ref.decode_frame(*args, **kw)
            _same_frames([a] if a else [], [b] if b else [])
            n += bool(a)
    _same_state(mine.protocol_parser, ref.protocol_parser)
    return n


def _mac_pdu(seed: int) -> int:
    """parse_mac_pdu and the call metadata on bits of every length up to
    a SCH/F block, each PDU type and encryption mode, one parser each
    side in turn (a batch of one through mac_headers here)."""
    r = np.random.default_rng(seed)
    mine, ref = TetraParser(), JaxParser()
    n = 0
    for d in list(range(0, 72)) + [108, 216, 268, 510]:
        bits = r.integers(0, 2, d).astype(np.uint8)
        for kind in range(4 if d >= 2 else 1):
            if d >= 2:
                bits[:2] = kind >> 1, kind & 1
            if d >= 35 and r.random() < 0.5:
                bits[29:35] = synth._uint_to_bits(int(r.integers(0, 8)), 6)
            a, b = mine.parse_mac_pdu(bits), ref.parse_mac_pdu(bits)
            assert (a is None) == (b is None)
            if a is None:
                continue
            want = dataclasses.asdict(b)
            want["pdu_type"] = b.pdu_type.name
            got = dataclasses.asdict(a)
            got["pdu_type"] = a.pdu_type.name
            assert got == want
            ma, mb = mine.parse_call_metadata(a), ref.parse_call_metadata(b)
            assert (None if ma is None else dataclasses.asdict(ma)) == (
                None if mb is None else dataclasses.asdict(mb))
            n += 1
    _same_state(mine, ref)
    return n


@pytest.mark.parametrize("seed", range(20))
@pytest.mark.parametrize("entry", [_multicarrier, _single, _mac_pdu],
                         ids=["multicarrier", "decode_frame", "mac_pdu"])
def test_frames_and_state_equal_the_jax_package(entry, seed):
    assert entry(1000 + seed) > 0


def _crc_rows(d: int, seed: int) -> np.ndarray:
    """(F, d) rows: random, all zeros, all ones, and rows whose forward
    or reversed-payload CRC is valid, then 0 to 3 bits off."""
    r = np.random.default_rng(seed)
    rows = [r.integers(0, 2, d) for _ in range(40)]
    rows += [np.zeros(d, np.int64), np.ones(d, np.int64)]
    for k in range(80):
        payload = r.integers(0, 2, d - 16).astype(np.uint8)
        fcs = crc.crc16_bits_arr(payload[::-1] if k % 2 else payload)
        row = np.concatenate([payload, fcs])
        # 0-3 bits off in the CRC field, or one anywhere
        off = (d - 16 + r.choice(16, k % 4, replace=False) if k < 60
               else r.integers(0, d, 1))
        row[off] ^= 1
        rows.append(row)
    return np.stack(rows).astype(np.uint8)


def _oracle(row: np.ndarray) -> bool:
    """The soft check, bit-serially: not all 0 or 1, and at most the
    budget of bit errors on the forward or the reversed payload."""
    if row.all() or not row.any():
        return False
    payload, received = row[:-16], row[-16:]
    return any(int(np.sum(crc.crc16_bits_arr(p) != received))
               <= C.CRC_SOFT_ERROR_BUDGET for p in (payload, payload[::-1]))


@pytest.mark.parametrize("check", [crc.soft_crc_check_rows,
                                   crc.soft_crc_check_numpy_rows],
                         ids=["engine", "numpy"])
@pytest.mark.parametrize("d", [216, 510])
def test_batched_soft_crc_equals_the_host_check(check, d):
    rows = _crc_rows(d, d)
    got = check(rows)
    assert got.dtype == bool and got.shape == (len(rows),)
    want = [crc.soft_crc_check_host(row) for row in rows]
    assert got.tolist() == want == [_oracle(row) for row in rows]
    assert 0 < sum(want) < len(rows)
