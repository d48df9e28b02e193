"""The Viterbi kernel (`ops/kernels/viterbi.py`, `csrc/viterbi.cu`) and
the routing of `ops/viterbi.viterbi_decode`.

On the CPU: the kernel's module imports and loads nothing without nvcc,
`kernels.launches()` lists its wrapper, the wrapper refuses a code past
its shared memory, and a CPU tensor goes through the plain version, never
the kernel, and decodes exactly as the JAX package does on tie-heavy hard
inputs and on every input the card's tests give the kernel.

On the card (marked `cuda`): the kernel equals the plain version and the
JAX package bit for bit at every trellis length the port decodes, both
ends, batches of 1 to 300, on soft, tie-heavy and large inputs; the
channel decode of every control channel equals the CPU's; the wrapper
refuses what the kernel does not take; a downlink chunk launches it once
a Viterbi call.

The card has no JAX, so the JAX package's bits for the kernel's inputs
are kept as SHA-256 digests in `fixtures/viterbi_jax.json`, with the
digests of the inputs themselves; a CPU test recomputes them from the
JAX package.  After a change to the inputs, rewrite the file with
`PYTHONPATH=. python tests/unit/test_torch_viterbi_kernel.py`.

Inputs are made with numpy from fixed seeds."""

import hashlib
import importlib
import json
import pathlib

import numpy as np
import pytest
import torch

from tetraear_tpu_torch.models import downlink as dl
from tetraear_tpu_torch.ops import channel_coding as cc
from tetraear_tpu_torch.ops import kernels
from tetraear_tpu_torch.ops import viterbi as vit
from tetraear_tpu_torch.ops.kernels import viterbi as kv

# the trellis lengths of the port's calls: BSCH 80, SCH/HD 144, TCH/2.4
# 148, SCH/F 288, TCH/4.8 292
STEPS = (80, 144, 148, 288, 292)
BATCHES = (1, 4, 61, 300)
KINDS = ("soft", "hard", "large")
FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "viterbi_jax.json"


def _llrs(kind: str, bsz: int, n: int, seed: int) -> np.ndarray:
    """(bsz, 4 n) float32: standard normal soft values; hard +-1 with
    the rate-2/3 punctured positions and a quarter of the rest zero, so
    that most comparisons tie; or normal values of scale 3e7, whose path
    metrics round at every step."""
    rng = np.random.default_rng(seed)
    if kind == "soft":
        return rng.standard_normal((bsz, 4 * n)).astype(np.float32)
    if kind == "large":
        return (rng.standard_normal((bsz, 4 * n)) * 3e7).astype(np.float32)
    x = np.zeros((bsz, 4 * n), np.float32)
    keep = vit.puncture_indices(n)
    x[:, keep] = rng.choice(np.float32([-1, 1]), (bsz, keep.size))
    x[rng.random(x.shape) < 0.25] = 0.0
    return x


def _kernel_inputs(n: int, kind: str) -> list:
    """The inputs the card's kernel test decodes at N = n, one a batch
    size of BATCHES."""
    return [_llrs(kind, bsz, n, seed=1000 * n + bsz) for bsz in BATCHES]


def _key(n: int, terminated: bool, kind: str, bsz: int) -> str:
    return f"{n}-{int(terminated)}-{kind}-{bsz}"


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _jax_bits(n: int, terminated: bool, kind: str) -> list:
    """The JAX package's bits for `_kernel_inputs(n, kind)`, decoded as
    one batch (the rows are independent) and split again."""
    import jax.numpy as jnp
    from tetraear_tpu.ops import viterbi as jvit
    xs = _kernel_inputs(n, kind)
    bits = np.asarray(jvit.viterbi_decode(jnp.asarray(np.concatenate(xs)),
                                          n, terminated))
    return np.split(bits, np.cumsum([x.shape[0] for x in xs])[:-1])


def _jax_digests() -> dict:
    return json.loads(FIXTURE.read_text())


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

def test_module_imports_without_nvcc(monkeypatch):
    """Importing the wrapper builds and loads nothing: it imports with no
    nvcc to be found, and refuses a CPU tensor before any build."""
    def no_nvcc():
        raise kernels.KernelBuildError("nvcc not found")
    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    mod = importlib.reload(kv)
    assert mod.LAUNCHES == {"viterbi": 0}
    assert mod._library.cache_info().currsize == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        mod.viterbi(torch.zeros((2, 4 * 80)), 80)
    assert mod._library.cache_info().currsize == 0


def test_launches_lists_the_wrapper():
    assert "viterbi" in kernels.launches()
    kv.LAUNCHES["viterbi"] = 3
    assert kernels.launches()["viterbi"] == 3
    kernels.reset_launches()
    assert kernels.launches()["viterbi"] == 0


def test_wrapper_refuses_codes_past_max_steps():
    """Eight code blocks' soft values and decisions fill the kernel's 48 KB
    of static shared memory at N = 341; past it the wrapper raises, before
    any build, where the plain version decodes on."""
    assert kv.MAX_STEPS == 341 >= max(STEPS)
    assert 8 * kv.MAX_STEPS * (4 * 4 + 2) <= 48 * 1024 < 8 * 342 * 18
    with pytest.raises(ValueError, match="341"):
        kv.viterbi(torch.zeros((1, 4 * 342)), 342)
    assert kv._library.cache_info().currsize == 0
    bits = vit.viterbi_decode(torch.as_tensor(_llrs("soft", 2, 342, 1)), 342)
    assert bits.shape == (2, 338)


@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("n", STEPS)
def test_cpu_tensor_takes_the_plain_version_and_equals_jax(n, terminated):
    """A CPU tensor never reaches the kernel (its launch count stays 0),
    and its bits equal the JAX package's on tie-heavy hard inputs."""
    import jax.numpy as jnp
    from tetraear_tpu.ops import viterbi as jvit
    kernels.reset_launches()
    llrs = _llrs("hard", 6, n, seed=n + terminated)
    got = vit.viterbi_decode(torch.as_tensor(llrs), n, terminated)
    assert kernels.launches()["viterbi"] == 0
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jvit.viterbi_decode(jnp.asarray(llrs), n,
                                                    terminated)))
    np.testing.assert_array_equal(
        got.numpy(),
        vit.viterbi_decode_plain(torch.as_tensor(llrs), n, terminated))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("n", STEPS)
def test_plain_equals_jax_on_the_kernel_inputs(n, terminated, kind):
    """Every input the card's kernel test decodes: the plain version's
    bits equal the JAX package's, and the fixture holds the digests of
    these inputs and of the JAX package's bits for them."""
    want = _jax_digests()
    for x, jax_bits in zip(_kernel_inputs(n, kind),
                           _jax_bits(n, terminated, kind)):
        key = _key(n, terminated, kind, x.shape[0])
        assert want[key] == {"llrs": _digest(x), "bits": _digest(jax_bits)}
        got = vit.viterbi_decode(torch.as_tensor(x), n, terminated)
        np.testing.assert_array_equal(got.numpy(), jax_bits, err_msg=key)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("n", STEPS)
def test_kernel_equals_plain(cuda_device, n, terminated, kind):
    """Every batch size: one launch, uint8 bits on the card equal to the
    plain version's on the CPU and to the JAX package's (by their digest,
    on inputs whose digest is the one the JAX package decoded), bit for
    bit."""
    jax = _jax_digests()
    for llrs in _kernel_inputs(n, kind):
        bsz = llrs.shape[0]
        key = _key(n, terminated, kind, bsz)
        assert _digest(llrs) == jax[key]["llrs"], (
            f"{key}: not the inputs the JAX package decoded (numpy's "
            "generator gave other values)")
        before = kv.LAUNCHES["viterbi"]
        got = vit.viterbi_decode(torch.as_tensor(llrs, device=cuda_device),
                                 n, terminated)
        torch.cuda.synchronize()
        assert kv.LAUNCHES["viterbi"] == before + 1
        assert got.device.type == "cuda" and got.dtype == torch.uint8
        want = vit.viterbi_decode_plain(torch.as_tensor(llrs), n, terminated)
        assert got.shape == want.shape == (bsz, n - 4 if terminated else n)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(),
                                      err_msg=key)
        assert _digest(got.cpu().numpy()) == jax[key]["bits"], key


@pytest.mark.cuda
@pytest.mark.parametrize("channel", list(cc.CHANNEL_GEOMETRY))
def test_decode_channel_soft_on_card_equals_cpu(cuda_device, channel):
    """Every control channel: noisy soft values and clean codewords,
    the same type-1 bits and CRC verdicts on the card as on the CPU."""
    k1, air = cc.CHANNEL_GEOMETRY[channel]
    rng = np.random.default_rng(air)
    ecc = 0 if channel == "BSCH" else 0x1234567
    coded = np.stack([cc.encode_channel(rng.integers(0, 2, k1), channel,
                                        ecc) for _ in range(12)])
    soft = coded.astype(np.float32) * 2 - 1
    noisy = soft + rng.standard_normal(soft.shape).astype(np.float32) * 0.9
    for x in (soft, noisy, rng.standard_normal((5, air)).astype(np.float32)):
        got = cc.decode_channel_soft(torch.as_tensor(x, device=cuda_device),
                                     channel, ecc)
        want = cc.decode_channel_soft(torch.as_tensor(x), channel, ecc)
        np.testing.assert_array_equal(got.bits.cpu().numpy(),
                                      want.bits.numpy())
        np.testing.assert_array_equal(got.crc_ok.cpu().numpy(),
                                      want.crc_ok.numpy())
    assert want.crc_ok.numpy().dtype == bool
    assert cc.decode_channel_soft(torch.as_tensor(soft, device=cuda_device),
                                  channel, ecc).crc_ok.all()


@pytest.mark.cuda
def test_layouts_and_types(cuda_device):
    """viterbi_decode takes any float type and layout, as documented: it
    makes the blocks contiguous float32 rows before the one launch; the
    wrapper itself refuses every other dtype, a non-contiguous tensor, a
    wrong shape, a short terminated code, a CPU tensor and a code past
    MAX_STEPS."""
    n = 144
    llrs = _llrs("soft", 10, n, seed=5)
    want = vit.viterbi_decode_plain(torch.as_tensor(llrs), n)
    card = torch.as_tensor(llrs, device=cuda_device)
    strided = torch.zeros((10, 2 * 4 * n), device=cuda_device)[:, ::2]
    strided.copy_(card)
    assert not strided.is_contiguous()
    for x in (card.double(), strided, card.reshape(2, 5, 4 * n)):
        before = kv.LAUNCHES["viterbi"]
        got = vit.viterbi_decode(x, n)
        assert kv.LAUNCHES["viterbi"] == before + 1
        assert got.shape == x.shape[:-1] + (n - 4,)
        np.testing.assert_array_equal(got.reshape(10, n - 4).cpu().numpy(),
                                      want.numpy())
    for bad, match in ((card.double(), "float32"), (strided, "contiguous"),
                       (card.reshape(-1), r"\(B, 4"),
                       (card[:, :-4].contiguous(), r"\(B, 4"),
                       (card.cpu(), "CUDA")):
        with pytest.raises(ValueError, match=match):
            kv.viterbi(bad, n)
    with pytest.raises(ValueError, match="terminated"):
        kv.viterbi(torch.zeros((1, 12), device=cuda_device), 3)
    with pytest.raises(ValueError, match="341"):
        vit.viterbi_decode(torch.zeros((1, 4 * 342), device=cuda_device),
                           342)
    empty = vit.viterbi_decode(torch.zeros((0, 4 * n), device=cuda_device), n)
    assert empty.shape == (0, n - 4)


@pytest.mark.cuda
def test_downlink_chunk_launches_once_a_viterbi_call(cuda_device,
                                                     monkeypatch):
    """One multiframe of the benchmark's downlink cell decoded on the
    card: the kernel launches exactly once for each Viterbi call, and the
    frames equal the CPU's decode of the same soft bits."""
    calls = []
    real = vit.viterbi_decode

    def counted(llrs, num_input_bits, terminated=True):
        calls.append(num_input_bits)
        return real(llrs, num_input_bits, terminated)
    monkeypatch.setattr(vit, "viterbi_decode", counted)
    iq = dl.simulate_multiframe(72, "GATE 017", -5.0, seed=3,
                                start_mn=5).iq
    rx = dl.DownlinkReceiver(device=cuda_device)
    res = rx.demodulate(iq)
    kernels.reset_launches()
    frames = rx.decode(res)
    torch.cuda.synchronize()
    assert kernels.launches()["viterbi"] == len(calls) >= 4
    assert set(calls) == {80, 144, 288}
    soft = res.soft_bits[:int(res.count) - 1].reshape(-1).cpu().numpy()
    plain = dl.DownlinkReceiver(device="cpu").receive_soft(soft)
    assert len(frames) == len(plain) > 60
    assert _lines(frames) == _lines(plain)


def _lines(frames) -> list:
    return [json.dumps([f.to_frame_dict(), f.crc_ok], default=str)
            for f in frames]


def _write_fixture() -> None:
    """Rewrite `FIXTURE` from the JAX package."""
    digests = {}
    for n in STEPS:
        for terminated in (True, False):
            for kind in KINDS:
                for x, bits in zip(_kernel_inputs(n, kind),
                                   _jax_bits(n, terminated, kind)):
                    digests[_key(n, terminated, kind, x.shape[0])] = {
                        "llrs": _digest(x), "bits": _digest(bits)}
    FIXTURE.parent.mkdir(exist_ok=True)
    FIXTURE.write_text(json.dumps(digests, indent=0, sort_keys=True) + "\n")
    print(f"{FIXTURE}: {len(digests)} digests")


if __name__ == "__main__":
    _write_fixture()
