"""The traffic generator makes the same ring from the same seed, and each
slot it plants parses back to its text."""

import numpy as np
import pytest

from cellsize import tiny_cell

from benchmark import golden, reference, traffic


def _ring(cell, seed):
    return cell.driver.make_ring(cell.config, cell.params, seed, "cpu")


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 3 * 2**40 + 5, -9])
def test_same_seed_same_ring(seed):
    cell = tiny_cell("wb16.dense", 3)
    a, b = _ring(cell, seed), _ring(cell, seed)
    assert a.busy == b.busy and a.slots == b.slots
    assert all(np.array_equal(x, y) for x, y in zip(a.chunks, b.chunks))


def test_other_seed_other_ring():
    cell = tiny_cell("fb96.quiet", 4)
    a, b = _ring(cell, 1), _ring(cell, 2)
    assert not np.array_equal(a.chunks[0], b.chunks[0])
    assert a.slots != b.slots


@pytest.mark.parametrize("name,busy", [("wb16.dense", 5), ("fb96.quiet", 4)])
def test_ring_shape(name, busy):
    cell = tiny_cell(name, busy)
    ring = _ring(cell, 3)
    assert len(ring.chunks) == cell.params["ring_chunks"]
    assert all(x.dtype == np.complex64 and x.shape == (ring.chunk,)
               for x in ring.chunks)
    assert len(ring.busy) == busy == len(ring.slots)
    assert len(set(ring.busy)) == busy
    n_rows = len(cell.driver.offsets(cell.config))
    assert all(0 <= r < n_rows for r in ring.busy)
    # a whole number of the mixers' periods (192 samples on the 12.5 kHz
    # grid, 96 on the 25 kHz one)
    assert (ring.chunk * len(ring.chunks)) % 192 == 0


def test_golden_slot_passes_its_crc():
    slot = golden.mac_resource_slot(b"UNIT 001 CH00", seed=5)
    data = np.concatenate([slot[0:108], slot[122:230]])
    assert np.array_equal(golden.crc16_bits_arr(data[:200]), data[200:])
    assert np.array_equal(slot[216:238], golden.TS1)
    bits = np.tile(slot, 3)[None]
    cand = reference.candidates(bits, reference.best_correlation(bits),
                                np.array([766]), 8, 0.8)
    at = dict(zip(cand["cand_pos"][0].tolist(), cand["crc_ok"][0]))
    assert all(at[216 + 510 * k] for k in range(3))


def test_planted_texts_fit_the_slot():
    rng = traffic.seed_rng(1)
    for row in range(96):
        text = traffic._text(rng, row)
        assert len(text.encode()) <= 18
        golden.mac_resource_slot(text.encode(), seed=row)
