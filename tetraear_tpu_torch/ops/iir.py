"""IIR filtering for the `ref-exact` profile (port of `tetraear_tpu.ops.iir`,
whose module imports jax): scipy's lfilter / sosfilt / filtfilt /
decimate semantics without a loop over samples.

A linear filter of state size m is s' = A s + B x, y = C s + D x.  Cut
the signal into chunks of T samples: inside a chunk the output is

    y = H x + G s0          H[t, k] = h[t - k] (the impulse response),
                            G[t] = C A^t

and the state at the chunk's end is P s0 + F x with P = A^T and
F[:, k] = A^(T-1-k) B.  H, G, F and P are built once per filter in
float64 and applied in f32 as batched matmuls; only the chunk-start
states are then linked, by a log-depth (Hillis-Steele) scan over the
chunks with the powers P^(2^i).  A cascade of second-order sections is
one such system of state size 2S (the sections' states stacked), so a
filtfilt pass is two matmuls and about log2(N/T) scan steps, not one
dependent step per sample and section.

The designers (`decimate_coeffs`, `butter_coeffs`, `_tf2sos_zi`) are
copies of the reference's scipy calls; tests/unit/test_torch_iir.py holds
them `array_equal` and every filter within a stated tolerance of the
reference's f32 scans.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

CHUNK = 128          # samples per chunk: T MACs per output sample
SCAN_LEVELS = 32     # powers P^(2^i) kept: inputs up to 2^32 chunks


class _System(NamedTuple):
    """A filter's chunk operators: H (T, T), G (T, m), F (m, T) and the
    scan's powers P^(2^i) (levels, m, m), P = A^T.  float64 numpy from
    `_system`; f32, transposed for row-vector products, on a device from
    `_device_system`."""
    H: object
    G: object
    F: object
    P: object


def _tf_state_space(b: np.ndarray, a: np.ndarray) -> tuple:
    """(A, B, C, D) of the direct-form-II-transposed filter b/a (the state
    is lfilter's z, so lfilter's zi is its initial state)."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    b, a = b / a[0], a / a[0]
    n = max(len(a), len(b))
    bp = np.zeros(n); bp[:len(b)] = b
    ap = np.zeros(n); ap[:len(a)] = a
    m = n - 1
    A = np.zeros((m, m))
    A[:, 0] = -ap[1:]
    A[np.arange(m - 1), np.arange(1, m)] = 1.0
    B = bp[1:] - ap[1:] * bp[0]
    C = np.zeros(m)
    if m:
        C[0] = 1.0
    return A, B, C, bp[0]


def _cascade(sections) -> tuple:
    """One (A, B, C, D) for systems in series, states stacked in order."""
    A, B, C, D = sections[0]
    for A2, B2, C2, D2 in sections[1:]:
        m1, m2 = len(B), len(B2)
        An = np.zeros((m1 + m2, m1 + m2))
        An[:m1, :m1] = A
        An[m1:, :m1] = np.outer(B2, C)
        An[m1:, m1:] = A2
        A, B = An, np.concatenate([B, B2 * D])
        C, D = np.concatenate([D2 * C, C2]), D2 * D
    return A, B, C, D


@functools.lru_cache(maxsize=None)
def _system(sections: tuple) -> _System:
    """The chunk operators of the sections ((b, a), ...) in series."""
    A, B, C, D = _cascade([_tf_state_space(np.asarray(b), np.asarray(a))
                           for b, a in sections])
    m, T = len(B), CHUNK
    powers = [np.eye(m)]
    for _ in range(T):
        powers.append(A @ powers[-1])
    h = np.empty(T)
    h[0] = D
    for j in range(1, T):
        h[j] = C @ powers[j - 1] @ B
    t = np.arange(T)
    lag = t[:, None] - t[None, :]
    H = np.where(lag >= 0, h[np.clip(lag, 0, None)], 0.0)
    G = np.stack([C @ powers[i] for i in range(T)]).reshape(T, m)
    F = np.stack([powers[T - 1 - k] @ B for k in range(T)],
                 axis=1).reshape(m, T)
    scan = [powers[T]]
    for _ in range(SCAN_LEVELS - 1):
        scan.append(scan[-1] @ scan[-1])
    return _System(H, G, F, np.stack(scan))


@functools.lru_cache(maxsize=None)
def _device_system(sections: tuple, device: torch.device) -> _System:
    """`_system` as f32 tensors on `device`, each transposed (x @ H^T is
    H applied to the rows x), made once per device."""
    s = _system(sections)
    return _System(*(torch.as_tensor(np.ascontiguousarray(op.swapaxes(-1, -2)),
                                     dtype=torch.float32, device=device)
                     for op in s))


def _tf_sections(b, a) -> tuple:
    return ((tuple(np.asarray(b, np.float64).tolist()),
             tuple(np.asarray(a, np.float64).tolist())),)


def _sos_sections(sos) -> tuple:
    return tuple((tuple(row[:3]), tuple(row[3:]))
                 for row in np.asarray(sos, np.float64).tolist())


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full f32: the card runs f32 matmuls in TF32 when allowed,
    which keeps only about three decimal digits."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _run(ops: _System, x: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """Filter real rows x (R, N) f32 from initial states s0 (R, m) with
    the device operators `ops`."""
    rows, n = x.shape
    T = ops.H.shape[0]
    if ops.P.shape[-1] == 0 or n == 0:
        return x * ops.H[0, 0]
    k = -(-n // T)
    xc = F.pad(x, (0, k * T - n)).reshape(rows, k, T)
    # state at each chunk's start: e_0 = s0, e_c = F x_(c-1); then
    # s_c = sum_(j <= c) P^(c-j) e_j, an inclusive scan of log2(k) steps
    u = _matmul_f32(xc[:, :-1], ops.F)                      # (R, k-1, m)
    s = torch.cat([s0[:, None, :].to(torch.float32), u], dim=1)
    level, d = 0, 1
    while d < k:
        s = torch.cat([s[:, :d], s[:, d:] + _matmul_f32(s[:, :-d],
                                                          ops.P[level])],
                      dim=1)
        level, d = level + 1, 2 * d
    y = _matmul_f32(xc, ops.H) + _matmul_f32(s, ops.G)
    return y.reshape(rows, k * T)[:, :n]


def _as_rows(x: torch.Tensor) -> tuple:
    """(..., N) real or complex -> (R, N) f32 rows (real and imaginary
    parts as separate rows) and the inverse."""
    shape = x.shape
    if x.is_complex():
        ri = torch.view_as_real(x.to(torch.complex64))        # (..., N, 2)
        rows = ri.movedim(-1, -2).reshape(-1, shape[-1])

        def back(y):
            y = y.reshape(shape[:-1] + (2, y.shape[-1])).movedim(-2, -1)
            return torch.view_as_complex(y.contiguous())
    else:
        rows = x.to(torch.float32).reshape(-1, shape[-1])

        def back(y):
            return y.reshape(shape[:-1] + (y.shape[-1],))
    return rows, back


def _state_rows(zi, x: torch.Tensor, m: int) -> torch.Tensor:
    """Initial states broadcast over the batch of x, as rows like
    _as_rows(x): (R, m) f32."""
    batch = x.shape[:-1]
    if zi is None:
        z = torch.zeros(batch + (m,), dtype=x.dtype, device=x.device)
    else:
        z = torch.as_tensor(zi, device=x.device).to(x.dtype)
        z = torch.broadcast_to(z, batch + (m,))
    if x.is_complex():
        return torch.view_as_real(z).movedim(-1, -2).reshape(-1, m)
    return z.reshape(-1, m)


# ---------------------------------------------------------------------------
# Transfer-function and second-order-section filters
# ---------------------------------------------------------------------------

def _filter(sections: tuple, x: torch.Tensor, zi) -> torch.Tensor:
    ops = _device_system(sections, x.device)
    rows, back = _as_rows(x)
    return back(_run(ops, rows, _state_rows(zi, x, ops.P.shape[-1])))


def lfilter(b, a, x: torch.Tensor, zi=None) -> torch.Tensor:
    """Direct-form-II-transposed IIR filter along the last axis, as
    scipy.signal.lfilter; zi (broadcast to (..., max(len(a), len(b)) - 1))
    is the initial state.  f32 for real x, complex64 for complex x."""
    return _filter(_tf_sections(b, a), x, zi)


def _biquad(sec, x: torch.Tensor, zi) -> torch.Tensor:
    """One DF2-transposed section [b0 b1 b2 1 a1 a2] over the last axis of
    x (B, N) from the states zi (B, 2)."""
    sec = np.asarray(sec, np.float64)
    return lfilter(sec[:3], sec[3:], x, zi)


def sosfilt(sos, x: torch.Tensor, zi=None) -> torch.Tensor:
    """Cascaded-biquad filter along the last axis (scipy.signal.sosfilt);
    zi: optional (S, 2) per-section initial states, broadcast over the
    batch."""
    if zi is not None:
        zi = torch.as_tensor(np.asarray(zi, np.float64).reshape(-1))
    return _filter(_sos_sections(sos), x, zi)


@functools.lru_cache(maxsize=None)
def _tf2sos_zi(b: tuple, a: tuple) -> tuple:
    from scipy.signal import sosfilt_zi, tf2sos
    sos = tf2sos(np.asarray(b), np.asarray(a))
    return sos, sosfilt_zi(sos)


@functools.lru_cache(maxsize=None)
def _filtfilt_plan(b: tuple, a: tuple, device: torch.device) -> tuple:
    """(tf2sos sections, their sosfilt_zi rows stacked as one (1, 2S) f32
    state on `device`)."""
    sos, zi = _tf2sos_zi(b, a)
    return _sos_sections(sos), torch.as_tensor(
        zi.reshape(1, -1), dtype=torch.float32, device=device)


def filtfilt(b, a, x: torch.Tensor) -> torch.Tensor:
    """Zero-phase forward-backward filter as scipy.signal.filtfilt's
    defaults (padtype 'odd', padlen = 3 max(len(a), len(b))), run as the
    tf2sos cascade with every section's sosfilt_zi row scaled by the
    first sample of each pass.  x: (..., N), N > padlen."""
    (tb, ta), = _tf_sections(b, a)
    padlen = 3 * max(len(ta), len(tb))
    n = x.shape[-1]
    if n <= padlen:
        raise ValueError(f"input length {n} must exceed padlen {padlen}")
    sections, zi = _filtfilt_plan(tb, ta, x.device)
    ops = _device_system(sections, x.device)
    # odd extension; x[..., padlen:0:-1] and x[..., -2:-padlen-2:-1]
    left = 2 * x[..., :1] - x[..., 1:padlen + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., -padlen - 1:-1].flip(-1)
    rows, back = _as_rows(torch.cat([left, x, right], dim=-1))
    y = _run(ops, rows, zi * rows[:, :1]).flip(-1)
    y = _run(ops, y, zi * y[:, :1]).flip(-1)
    return back(y)[..., padlen:padlen + n]


@functools.lru_cache(maxsize=None)
def decimate_coeffs(q: int) -> tuple:
    """cheby1(8, 0.05, 0.8/q): the IIR scipy.signal.decimate(zero_phase=
    True) applies through filtfilt."""
    from scipy.signal import cheby1
    b, a = cheby1(8, 0.05, 0.8 / q)
    return b, a


def decimate_exact(x: torch.Tensor, q: int) -> torch.Tensor:
    """scipy.signal.decimate(x, q): cheby1-8 filtfilt, then every q-th
    sample from index 0."""
    b, a = decimate_coeffs(q)
    return filtfilt(b, a, x)[..., ::q]


@functools.lru_cache(maxsize=None)
def butter_coeffs(order: int, cutoff_norm: float) -> tuple:
    from scipy.signal import butter
    return butter(order, cutoff_norm, btype="low")


def butter_filtfilt_exact(x: torch.Tensor, cutoff_norm: float,
                          order: int = 4) -> torch.Tensor:
    """butter(order, cutoff) + filtfilt, the cutoff clamped to [0.01,
    0.99] as the reference's channel filter."""
    cutoff_norm = min(0.99, max(0.01, cutoff_norm))
    b, a = butter_coeffs(order, cutoff_norm)
    return filtfilt(b, a, x)
