"""The multicarrier sync walk (`ops/sync.sync_walk`): the plain version
`sync_walk_plain` on the CPU, the kernel (`ops/kernels/sync_walk.py`,
`csrc/sync_walk.cu`) on the card.

On the CPU: the plain version's positions are those of the threshold
cascade it replaces, `TetraDecoder.frontend_walk` on each row (its slot
filter taken out, so that every position shows; then with the filter,
through `slot_positions` and `MulticarrierDecoder.walks`), and those of
the single-carrier `TetraDecoder.walk` on (TS1, TS2) pairs whose larger
score is the row's:
in every regime of the rule (M >= 0.90, 0.75 < M < 0.90, M at 0.90, at
0.75 and a float32 step either side of each), hits 1, 249, 250 and 251
bits apart, a row where every window is a hit, rows longer than the
kernel's segment with hits at its edges, rows under and at 22
bits, rows of different lengths in one matrix, rows at the cells'
shapes, and the planted chunks of `utils/synth.py` through a frontend.
A CPU tensor never reaches the kernel.

On the card (marked `cuda`): the kernel's positions and counts equal
the plain version's on all those cases and on the benchmark's seeded
traffic at the cells' shapes (96 x 32,241, 16 x 32,241 and 96 x 4,009),
where `MulticarrierDecoder.decode` launches it once a chunk and its
frames equal the CPU's decode of the same frontend result; the wrapper
refuses what the kernel does not take.

Inputs are made with numpy from fixed seeds."""

import numpy as np
import pytest
import torch

from tetraear_tpu_torch import constants as C
from tetraear_tpu_torch.core.decoder import TetraDecoder
from tetraear_tpu_torch.models.multicarrier import (MulticarrierDecoder,
                                                    build_frontend,
                                                    slot_positions)
from tetraear_tpu_torch.ops import kernels, sync
from tetraear_tpu_torch.ops.channelizer import carrier_grid
from tetraear_tpu_torch.ops.kernels import sync_walk as ksw
from tetraear_tpu_torch.utils import synth

F32 = np.float32
UP, DOWN = np.float32(1.0), np.float32(0.0)
# the row maxima at the rule's edges: 0.90 and 0.75 as float32 (0.90 is
# 0.8999999762 there, below the double 0.90) and a float32 step either side
EDGES = {"0.90": F32(0.9), "0.90+": np.nextafter(F32(0.9), UP),
         "0.90-": np.nextafter(F32(0.9), DOWN), "0.75": F32(0.75),
         "0.75+": np.nextafter(F32(0.75), UP),
         "0.75-": np.nextafter(F32(0.75), DOWN)}
# clips of noise rows: M = 20/22 and up (walk at 0.90), 19, 18 and 17
# over 22 (the adaptive walk), 16/22 (no sync)
REGIMES = {"high": None, "19/22": 19, "18/22": 18, "17/22": 17,
           "16/22": 16}
CELL_SHAPES = ((96, 32241), (16, 32241), (96, 4009))


def _noise(rng, rows: int, width: int) -> np.ndarray:
    """Scores of random bits: the better of two patterns' matches over
    22, with every 997th window a true sync (22 of 22)."""
    k = np.maximum(rng.binomial(22, 0.5, (rows, width)),
                   rng.binomial(22, 0.5, (rows, width)))
    k[:, rng.integers(0, 997)::997] = 22
    return (k / 22).astype(F32)


def _count(width: int, rows: int) -> np.ndarray:
    """The symbol count that makes every window of a (rows, width) score
    matrix valid: 2 (count - 1) - 21 = width."""
    return np.full(rows, (width + 21) // 2 + 1, np.int32)


def _regime(name: str, seed: int, rows: int = 6, width: int = 3000):
    rng = np.random.default_rng(seed)
    s = _noise(rng, rows, width)
    if REGIMES[name] is not None:
        s = np.minimum(s, F32(REGIMES[name] / 22))
    return s, _count(width, rows)


def _edge(name: str, seed: int, rows: int = 4, width: int = 3000):
    """Row 0: noise clipped to the edge value e.  The other rows: 0.5,
    with windows 260 apart (so that each one's verdict shows) at e, a
    float32 step below it, 0.90 and 0.75 as float32 and a step either
    side of 0.75, and e - 0.02 (the adaptive threshold) and a step either
    side of it, each at most e, in a seeded order."""
    rng = np.random.default_rng(seed)
    e = EDGES[name]
    s = np.full((rows, width), F32(0.5))
    s[0] = np.minimum(_noise(rng, 1, width)[0], e)
    near = F32(np.float64(e) - C.SYNC_ADAPTIVE_TOLERANCE)
    vals = [v for v in (e, np.nextafter(e, DOWN), F32(0.9), F32(0.75),
                        np.nextafter(F32(0.75), UP),
                        np.nextafter(F32(0.75), DOWN), near,
                        np.nextafter(near, UP), np.nextafter(near, DOWN))
            if v <= e]
    for r in range(1, rows):
        s[r, 40 + 260 * np.arange(len(vals))] = rng.permutation(vals)
    return s, _count(width, rows)


def _spaced(gap: int, width: int = 4000):
    """Row 0: hits `gap` apart from window 30; row 1 the same at the
    adaptive level (0.80); row 2: every window a hit; row 3: every
    window at 0.80."""
    s = np.full((4, width), F32(0.5))
    s[0, 30::gap] = 1.0
    s[1, 30::gap] = 0.80
    s[2] = 1.0
    s[3] = 0.80
    return s, _count(width, 4)


def _segments(width: int = 70000):
    """Rows longer than the kernel's segment of 32,768 windows: hits 249
    apart from window 7, every window a hit, hits on both sides of each
    segment's edge, and noise."""
    s = np.full((4, width), F32(0.5))
    s[0, 7::249] = 0.95
    s[1] = 1.0
    s[2, [32500, 32750, 32767, 32768, 33018, 65535, 65536, 65786]] = 1.0
    s[3] = _noise(np.random.default_rng(9), 1, width)[0]
    return s, _count(width, 4)


def _lengths():
    """One matrix of rows of count 0, 1, 11, 12 and 13 (under and at 22
    bits, one and three windows), and rows of 977, 1,999 and all 2,001
    windows."""
    s = _noise(np.random.default_rng(7), 8, 2001)
    return s, np.array([0, 1, 11, 12, 13, 500, 1011, 1012], np.int32)


def _cases():
    """Every CPU case, (name, scores, counts)."""
    out = [(f"regime-{n}-{seed}", *_regime(n, seed))
           for n in REGIMES for seed in (1, 2)]
    out += [(f"edge-{n}", *_edge(n, i)) for i, n in enumerate(EDGES)]
    out += [(f"gap-{g}", *_spaced(g)) for g in (1, 249, 250, 251)]
    out.append(("segments", *_segments()))
    out.append(("lengths", *_lengths()))
    return out


CASES = _cases()


def _rows(s: np.ndarray, count: np.ndarray):
    """Each row as `MulticarrierDecoder.decode` hands it out: (bits,
    symbols, valid scores); the bits are zeros (the walk reads none)."""
    for r in range(len(count)):
        nsym = max(int(count[r]) - 1, 0)
        yield (np.zeros(2 * nsym, np.uint8), np.zeros(nsym, np.int64),
               s[r, :max(0, 2 * nsym - 21)])


def _plain(s, count):
    pos, n = sync.sync_walk_plain(torch.from_numpy(s), torch.from_numpy(count))
    assert pos.dtype == n.dtype == torch.int32
    assert pos.shape == (len(count), -(-s.shape[1] // C.SYNC_SKIP_BITS))
    return pos.numpy(), n.numpy()


@pytest.mark.parametrize("name,s,count", CASES, ids=[c[0] for c in CASES])
def test_plain_equals_the_cascade(name, s, count, monkeypatch):
    """Every position of the plain walk is the cascade's: frontend_walk
    with its slot filter taken out (a frame start 0 bits before the sync
    and symbols to spare), and -1 after the accepted ones."""
    pos, n = _plain(s, count)
    dec = TetraDecoder(device="cpu")
    monkeypatch.setattr(C, "SYNC_TO_FRAME_START_BITS", 0)
    for r, (bits, _, best) in enumerate(_rows(s, count)):
        spare = np.zeros(len(bits) // 2 + C.SYMBOLS_PER_SLOT, np.int64)
        want = dec.frontend_walk(bits, spare, best).positions
        np.testing.assert_array_equal(pos[r, :n[r]], want, err_msg=f"row {r}")
        assert (pos[r, n[r]:] == -1).all()
    if name.startswith(("regime-16/22", "edge-0.75-")):
        assert (n == 0).all(), n
    elif name != "lengths":
        assert (n > 0).all(), n


@pytest.mark.parametrize("name,s,count", CASES, ids=[c[0] for c in CASES])
def test_walks_equal_frontend_and_single_carrier_walks(name, s, count):
    """slot_positions and MulticarrierDecoder.walks on the plain walk:
    each row's slots are frontend_walk's, and the single-carrier walk's
    on a (TS1, TS2) pair whose larger score is the row's (in float64, as
    frontend_walk reads the scores; on scores of matches over 22 also in
    float32, as the single carrier's dense_sync gives them)."""
    pos, n = _plain(s, count)
    width = s.shape[1] + 21
    bits = np.zeros((len(count), width), np.uint8)
    walks = MulticarrierDecoder(len(count), device="cpu").walks(
        bits, count, slot_positions(count, pos, n))
    dec = TetraDecoder(device="cpu")
    rng = np.random.default_rng(len(name))
    over22 = name.startswith(("regime", "gap"))
    for r, (cbits, symbols, best) in enumerate(_rows(s, count)):
        want = dec.frontend_walk(cbits, symbols, best).positions
        got = walks[r].positions
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want, err_msg=f"row {r}")
        np.testing.assert_array_equal(walks[r].bits, cbits)
        np.testing.assert_array_equal(walks[r].symbols, symbols)
        if len(cbits) < C.SYNC_LEN_BITS:
            assert len(want) == 0
            continue
        # the pair: one pattern holds the score, the other at most it
        other = (best * rng.random(best.shape)).astype(F32)
        first = rng.random(best.shape) < 0.5
        ts1, ts2 = np.where(first, best, other), np.where(first, other, best)
        assert (np.maximum(ts1, ts2) == best).all()
        for dtype in (np.float64, F32) if over22 else (np.float64,):
            got1 = dec.walk(cbits, symbols, (ts1.astype(dtype),
                                             ts2.astype(dtype))).positions
            np.testing.assert_array_equal(got1, want,
                                          err_msg=f"row {r} {dtype}")


@pytest.mark.parametrize("rows,width", CELL_SHAPES)
def test_plain_at_the_cells_shapes(rows, width):
    """Noise rows at the benchmark cells' shapes, every window valid,
    and the same rows each cut to its own length."""
    rng = np.random.default_rng(width + rows)
    s = _noise(rng, rows, width)
    for count in (_count(width, rows),
                  rng.integers(0, (width + 21) // 2 + 2, rows).astype(
                      np.int32)):
        pos, n = _plain(s, count)
        dec = TetraDecoder(device="cpu")
        walks = MulticarrierDecoder(rows, device="cpu").walks(
            np.zeros((rows, width + 21), np.uint8), count,
            slot_positions(count, pos, n))
        for r, (bits, symbols, best) in enumerate(_rows(s, count)):
            np.testing.assert_array_equal(
                walks[r].positions,
                dec.frontend_walk(bits, symbols, best).positions)


PLANTED = {
    "16 carriers": lambda: (synth.planted_wideband((3, 8, 12))[0],
                            build_frontend("s2d", device="cpu",
                                           offsets_hz=carrier_grid(16))),
    "full band": lambda: (synth.planted_pfb()[0],
                          build_frontend("s2d", device="cpu", pfb=True))}


@pytest.mark.parametrize("kind", list(PLANTED))
def test_planted_chunks(kind):
    """The planted signals of utils/synth.py through a frontend on the
    CPU: the walk's slots are each row's frontend_walk slots, and the
    planted rows find some."""
    x, fe = PLANTED[kind]()
    res = fe(x)
    s, count = res.sync_corr.numpy(), res.count.numpy()
    pos, n = _plain(s, count)
    walks = MulticarrierDecoder(len(count), device="cpu").walks(
        res.bits.numpy(), count, slot_positions(count, pos, n))
    dec = TetraDecoder(device="cpu")
    for r in range(len(count)):
        nsym = max(int(count[r]) - 1, 0)
        bits = res.bits.numpy()[r, :2 * nsym]
        symbols = (bits[0::2].astype(np.int64) << 1) | bits[1::2]
        want = dec.frontend_walk(bits, symbols,
                                 s[r, :max(0, 2 * nsym - 21)]).positions
        np.testing.assert_array_equal(walks[r].positions, want)
    assert sum(len(w.positions) for w in walks) >= 3


def test_launches_lists_the_wrapper():
    assert "sync_walk" in kernels.launches()
    assert "sync_walk" in kernels.SOURCES
    ksw.LAUNCHES["sync_walk"] = 2
    assert kernels.launches()["sync_walk"] == 2
    kernels.reset_launches()
    assert kernels.launches()["sync_walk"] == 0


def test_cpu_tensor_takes_the_plain_version():
    """sync_walk on a CPU tensor is the plain version and launches
    nothing; the kernel's wrapper refuses a CPU tensor before any
    build."""
    _, s, count = CASES[0]
    kernels.reset_launches()
    pos, n = sync.sync_walk(torch.from_numpy(s), torch.from_numpy(count))
    want = _plain(s, count)
    np.testing.assert_array_equal(pos.numpy(), want[0])
    np.testing.assert_array_equal(n.numpy(), want[1])
    assert kernels.launches()["sync_walk"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        ksw.sync_walk(torch.from_numpy(s), torch.from_numpy(count))
    assert ksw._library.cache_info().currsize == 0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _kernel(s, count, device):
    before = ksw.LAUNCHES["sync_walk"]
    pos, n = sync.sync_walk(torch.as_tensor(s, device=device),
                            torch.as_tensor(count, device=device))
    torch.cuda.synchronize()
    assert ksw.LAUNCHES["sync_walk"] == before + 1
    assert pos.device.type == "cuda" and pos.dtype == n.dtype == torch.int32
    return pos.cpu().numpy(), n.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("name,s,count", CASES, ids=[c[0] for c in CASES])
def test_kernel_equals_plain(cuda_device, name, s, count):
    got, want = _kernel(s, count, cuda_device), _plain(s, count)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width", CELL_SHAPES)
def test_kernel_equals_plain_at_the_cells_shapes(cuda_device, rows, width):
    rng = np.random.default_rng(width - rows)
    s = _noise(rng, rows, width)
    for count in (_count(width, rows),
                  rng.integers(0, (width + 21) // 2 + 2, rows).astype(
                      np.int32)):
        got, want = _kernel(s, count, cuda_device), _plain(s, count)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("cell,shape", [("fb96.quiet", (96, 32241)),
                                        ("wb16.quiet", (16, 32241)),
                                        ("fb96.dense", (96, 4009))])
def test_cell_traffic_one_launch_a_chunk(cuda_device, cell, shape):
    """Two chunks of the benchmark cell's seeded traffic through its
    system on the card: the kernel's walk equals the plain version's on
    each frontend result, the decode launches it once a chunk, and its
    frames equal the CPU's decode of the same result."""
    from benchmark import harness
    c = harness.Cell(cell)
    c.params.update(ring_chunks=2)
    ring = c.driver.make_ring(c.config, c.params, 2**31 + 20, cuda_device)
    system = c.driver.System(c.config, cuda_device)
    rows = shape[0]
    plain_decoder = MulticarrierDecoder(rows, device="cpu")
    start = 0
    for x in ring.chunks:
        res = system.submit(x, start)
        start += len(x)
        assert tuple(res.sync_corr.shape) == shape
        s, count = res.sync_corr.cpu().numpy(), res.count.cpu().numpy()
        got, want = _kernel(s, count, cuda_device), _plain(s, count)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
        assert want[1].sum() > 0
        host = type(res)(*(t.cpu() for t in res))
        kernels.reset_launches()
        frames = system.complete(res)
        torch.cuda.synchronize()
        assert kernels.launches()["sync_walk"] == 1
        plain = plain_decoder.decode(host)
        assert _keys(frames) == _keys(plain)


def _keys(frames) -> list:
    return [[(f["sync_position"], f["type"], f.get("sds_message"))
             for f in row] for row in frames]


@pytest.mark.cuda
def test_wrapper_refuses(cuda_device):
    """The wrapper takes contiguous float32 scores and int32 counts of
    matching rows on one card, and launches nothing for no windows."""
    _, s, count = CASES[0]
    corr = torch.as_tensor(s, device=cuda_device)
    cnt = torch.as_tensor(count, device=cuda_device)
    for bad_corr, bad_cnt, match in (
            (corr.double(), cnt, "float32"),
            (corr[:, ::2], cnt, "contiguous"),
            (corr, cnt.long(), "int32"),
            (corr, cnt[:-1].contiguous(), r"\(R, W\)"),
            (corr.reshape(-1), cnt, r"\(R, W\)"),
            (corr, cnt.cpu(), "count on"),
            (corr.cpu(), cnt.cpu(), "CUDA")):
        with pytest.raises(ValueError, match=match):
            ksw.sync_walk(bad_corr, bad_cnt)
    before = ksw.LAUNCHES["sync_walk"]
    pos, n = ksw.sync_walk(corr[:, :0].contiguous(), cnt)
    assert pos.shape == (len(count), 0) and (n.cpu() == 0).all()
    assert ksw.LAUNCHES["sync_walk"] == before
