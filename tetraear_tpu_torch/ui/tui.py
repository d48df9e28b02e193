"""Interactive terminal UI: live spectrum + waterfall + frames/calls/
groups tables + SDS feed + voice playback, over the headless CaptureLoop.

This is the framework's interactive front-end (port of
`tetraear_tpu.ui.tui`) — the terminal counterpart of the reference's
ModernTetraGUI (tetraear/ui/modern.py:2518-5420: waterfall widget :649,
tables :3200-3403, checkboxes :2827-3199, audio-out :4137-4282). Same
information surfaces, same toggles, no Qt: rendering is `rich` (Live +
Layout), the waterfall is the same WaterfallBuffer/colorize pipeline the
PPM renderer uses (drawn with half-block glyphs, two history rows per
text row), and key presses flip the reference's checkbox equivalents at
runtime:

    a auto-decrypt   d denoiser   f follow-frequency (AFC retune)
    v hear-voice     r monitor-raw   q quit

All state lives in :class:`TuiState`, and `build_view` is a pure function
of it — the tests render frames headlessly through a recording console.
The CaptureLoop runs on the device it was given.

Where the port differs from the reference on purpose: the reference runs
the loop on a daemon thread and drops whatever it raises, so a device
fault would end the decode and leave the view running on.  Here the
worker keeps the loop's exception, the view stops, and `run` re-raises
it on the calling thread once the terminal is restored.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from tetraear_tpu_torch.ui.session import SessionAggregator
from tetraear_tpu_torch.ui.waterfall import (TetraStatusMachine,
                                             WaterfallBuffer, colorize,
                                             find_peak_near,
                                             follow_frequency_step)

KEY_HELP = ("[b]a[/]uto-decrypt  [b]d[/]enoiser  [b]f[/]ollow-freq  "
            "[b]v[/]oice  [b]r[/]aw-monitor  [b]+/-[/] zoom  [b]q[/]uit  "
            "click=tune ctrl-click=peak wheel=zoom")

# Spectrum-panel geometry shared by build_view and the mouse mapper
# (1-based terminal coordinates, as SGR mouse reports use).  Header is
# one row; the spectrum Panel is `size=11`: border, sparkline, 8
# waterfall lines, border.  Horizontal: border + padding -> content
# starts at column 3 and is `width - 4` cells wide.
SPECTRUM_ROW_FIRST = 3          # first content row (sparkline)
SPECTRUM_ROW_LAST = 11          # last waterfall line
SPECTRUM_COL_FIRST = 3


@dataclass
class TuiState:
    """Everything the view renders; mutated by CaptureLoop callbacks."""
    frequency_hz: float = 390.865e6
    status: str = "starting"
    status_color: str = "yellow"
    signal_power_db: Optional[float] = None
    auto_decrypt: bool = True
    denoise: bool = True
    follow_freq: bool = False
    hear_voice: bool = True
    monitor_raw: bool = False
    chunks: int = 0
    frames: int = 0
    voice_blocks: int = 0
    rate_msps: float = 0.0
    messages: List[str] = field(default_factory=list)
    rows: List[dict] = field(default_factory=list)   # recent frame rows
    waterfall: WaterfallBuffer = field(default_factory=WaterfallBuffer)
    session: SessionAggregator = field(default_factory=SessionAggregator)
    machine: TetraStatusMachine = field(default_factory=TetraStatusMachine)
    # spectrum viewport (reference zoom 1-10x + clamping,
    # modern.py:876-903); view_center_mhz=None follows the tuned freq
    zoom: float = 1.0
    view_center_mhz: Optional[float] = None

    def on_frame_row(self, row: dict, max_rows: int = 64) -> None:
        self.rows.append(row)
        if len(self.rows) > max_rows:
            del self.rows[: len(self.rows) - max_rows]
        text = row.get("text")
        if text:
            self.messages.append(text)
            if len(self.messages) > 32:
                del self.messages[:-32]


# ---------------------------------------------------------------------------
# pure rendering
# ---------------------------------------------------------------------------

def view_slice(state: TuiState, nbins: int) -> slice:
    """Bin range of the current zoom viewport, clamped inside the span
    (the reference's viewport clamping, modern.py:876-903)."""
    freqs = state.waterfall.current_freqs
    if state.zoom <= 1.0 or freqs is None or len(freqs) != nbins \
            or nbins < 4:
        return slice(0, nbins)
    span = nbins / state.zoom
    center_mhz = (state.view_center_mhz
                  if state.view_center_mhz is not None
                  else state.frequency_hz / 1e6)
    c = float(np.interp(center_mhz, freqs, np.arange(nbins)))
    lo = int(round(c - span / 2))
    lo = max(0, min(lo, nbins - int(span)))
    return slice(lo, lo + max(4, int(span)))


def freq_at_column(state: TuiState, col: int, width: int) -> Optional[float]:
    """Terminal column (1-based) -> frequency in MHz within the current
    viewport, or None outside the spectrum content area."""
    freqs = state.waterfall.current_freqs
    content_w = width - 4
    if freqs is None or len(freqs) == 0 or content_w <= 0:
        return None
    x = col - SPECTRUM_COL_FIRST
    if not 0 <= x < content_w:
        return None
    sl = view_slice(state, len(freqs))
    view = np.asarray(freqs, float)[sl]
    frac = (x + 0.5) / content_w
    return float(view[0] + frac * (view[-1] - view[0]))


def parse_sgr_mouse(seq: str):
    """Parse one xterm SGR mouse report "\\x1b[<b;x;yM" (press, 'm' =
    release) -> (button, col, row, pressed) or None."""
    if not (seq.startswith("\x1b[<") and seq[-1] in "Mm"):
        return None
    try:
        b, x, y = (int(v) for v in seq[3:-1].split(";"))
    except ValueError:
        return None
    return b, x, y, seq.endswith("M")


def _spectrum_sparkline(power_db: np.ndarray, width: int) -> str:
    """Downsample the latest spectrum row to a unicode column chart."""
    bars = " ▁▂▃▄▅▆▇█"
    if power_db is None or len(power_db) == 0 or width <= 0:
        return ""
    arr = np.asarray(power_db, float)
    if len(arr) >= width:
        vals = np.array([b.max() for b in np.array_split(arr, width)])
    else:
        # viewport narrower than the terminal (high zoom on a wide
        # terminal): repeat bins instead of producing empty chunks,
        # whose .max() would raise and crash the render loop
        vals = arr[(np.arange(width) * len(arr)) // width]
    t = np.clip((vals + 100.0) / 80.0, 0.0, 1.0)
    idx = (t * (len(bars) - 1)).astype(int)
    return "".join(bars[i] for i in idx)


def _waterfall_lines(buffer: WaterfallBuffer, width: int, rows: int,
                     crop: slice | None = None):
    """Render the newest 2*rows history lines as rich half-block markup,
    two spectral rows per text line (fg=upper px, bg=lower px)."""
    from rich.text import Text
    arr = buffer.as_array()
    if arr.size == 0 or width <= 0 or rows <= 0:
        return [Text("")]
    if crop is not None and (crop.stop or 0) <= arr.shape[1]:
        arr = arr[:, crop]
    arr = arr[-2 * rows:]
    if arr.shape[0] % 2:
        arr = np.concatenate([arr[:1], arr])
    # downsample bins to the text width (or repeat bins when the zoomed
    # viewport has fewer bins than terminal columns — empty array_split
    # chunks would raise on .max())
    if arr.shape[1] >= width:
        cols = np.array_split(np.arange(arr.shape[1]), width)
        ds = np.stack([arr[:, c].max(axis=1) for c in cols], axis=1)
    else:
        ds = arr[:, (np.arange(width) * arr.shape[1]) // width]
    rgb = colorize(ds)
    out = []
    for r in range(0, rgb.shape[0], 2):
        t = Text()
        for x in range(rgb.shape[1]):
            fr, fg_, fb = (int(v) for v in rgb[r, x])
            br, bg_, bb = (int(v) for v in rgb[r + 1, x])
            t.append("▀", style=f"rgb({fr},{fg_},{fb}) on "
                               f"rgb({br},{bg_},{bb})")
        out.append(t)
    return out


def build_view(state: TuiState, width: int = 100):
    """TuiState -> rich renderable (pure; testable headlessly)."""
    from rich.console import Group
    from rich.layout import Layout
    from rich.panel import Panel
    from rich.table import Table
    from rich.text import Text

    status, color = state.machine.status()
    header = Text.assemble(
        (f" {state.frequency_hz / 1e6:.4f} MHz ", "bold white"),
        (f" {status} ", f"bold {color}"),
        (f" sig={state.signal_power_db:.1f} dB "
         if state.signal_power_db is not None else " sig=--- ", "cyan"),
        (f" chunks={state.chunks} frames={state.frames} "
         f"voice={state.voice_blocks} {state.rate_msps:.2f} MS/s ", "dim"),
        (f" [{'A' if state.auto_decrypt else '-'}"
         f"{'D' if state.denoise else '-'}"
         f"{'F' if state.follow_freq else '-'}"
         f"{'V' if state.hear_voice else '-'}"
         f"{'R' if state.monitor_raw else '-'}] ", "magenta"),
        (f" {state.status} ",
         "red" if state.status.startswith("ERROR") else "dim"),
    )

    power = state.waterfall.current_power
    sl = view_slice(state, 0 if power is None else len(power))
    spark = _spectrum_sparkline(None if power is None else power[sl],
                                width - 4)
    wf_lines = _waterfall_lines(state.waterfall, width - 4, rows=8,
                                crop=sl)
    title = "spectrum / waterfall"
    if state.zoom > 1.0:
        title += f" (zoom {state.zoom:.0f}x)"
    spectrum_panel = Panel(Group(Text(spark, style="green"), *wf_lines),
                           title=title, padding=(0, 1))

    frames_t = Table(title="frames", expand=True, pad_edge=False)
    for col in ("#", "type", "crc", "enc", "text", "country"):
        frames_t.add_column(col, overflow="fold")
    for row in state.rows[-12:]:
        crc = row.get("crc")
        frames_t.add_row(
            str(row.get("number", "")), str(row.get("type_name", "")),
            "-" if crc is None else ("Y" if crc else "n"),
            ("dec" if row.get("decrypted")
             else "enc" if row.get("encrypted") else ""),
            (row.get("text") or "")[:40], row.get("country", ""))

    calls_t = Table(title="calls", expand=True, pad_edge=False)
    for col in ("talkgroup", "call", "type", "frames", "enc"):
        calls_t.add_column(col)
    for call in list(state.session.calls.values())[-8:]:
        calls_t.add_row(str(call.get("talkgroup")), str(call.get("call_id")),
                        str(call.get("type") or ""),
                        str(call.get("frames")),
                        "yes" if call.get("encrypted") else "")

    groups_t = Table(title="groups", expand=True, pad_edge=False)
    for col in ("talkgroup", "frames", "last type"):
        groups_t.add_column(col)
    for g in list(state.session.groups.values())[-8:]:
        groups_t.add_row(str(g.get("talkgroup")), str(g.get("frames")),
                         str(g.get("last_type") or ""))

    sds = Panel(Text("\n".join(state.messages[-6:]) or "(no messages)"),
                title="SDS", padding=(0, 1))
    footer = Text.from_markup(KEY_HELP, style="dim")

    layout = Layout()
    layout.split_column(
        Layout(header, name="header", size=1),
        Layout(spectrum_panel, name="spectrum", size=11),
        Layout(name="tables"),
        Layout(sds, name="sds", size=8),
        Layout(footer, name="footer", size=1),
    )
    layout["tables"].split_row(Layout(frames_t, ratio=2),
                               Layout(calls_t), Layout(groups_t))
    return layout


# ---------------------------------------------------------------------------
# interactive runner
# ---------------------------------------------------------------------------

class TerminalUI:
    """Wire a CaptureLoop to the live view + key toggles + audio out."""

    def __init__(self, loop, state: Optional[TuiState] = None,
                 audio_sink=None, refresh_hz: float = 8.0):
        self.loop = loop
        self.state = state or TuiState(frequency_hz=loop.frequency,
                                       auto_decrypt=loop.auto_decrypt,
                                       monitor_raw=loop.monitor_raw)
        self.audio = audio_sink
        self.refresh_hz = refresh_hz
        self._wire()

    def _wire(self) -> None:
        st, loop = self.state, self.loop

        def on_spectrum(freqs, power):
            st.waterfall.denoise = st.denoise
            st.waterfall.update_spectrum(np.asarray(freqs) / 1e6,
                                         np.asarray(power))
            st.chunks = loop.chunks_processed
            st.rate_msps = loop.meter.rates().get("samples_per_sec", 0.0) / 1e6
            if st.follow_freq and st.waterfall.current_freqs is not None:
                new = follow_frequency_step(
                    st.waterfall.current_freqs,
                    st.waterfall.current_power, loop.frequency / 1e6)
                if new is not None:
                    loop.set_frequency(new * 1e6)
                    st.frequency_hz = new * 1e6

        def on_frame(frame):
            st.machine.on_frame(frame)
            row = st.session.on_frame(frame)
            st.frames = loop.frames_decoded
            st.on_frame_row(row)

        def on_signal(freq, power):
            st.signal_power_db = power
            st.machine.on_signal(True)

        def on_voice(audio):
            st.voice_blocks += 1
            if st.hear_voice and self.audio is not None:
                self.audio.play(audio)

        loop.on_spectrum = on_spectrum
        loop.on_frame = on_frame
        loop.on_signal = on_signal
        loop.on_signal_lost = lambda: st.machine.on_signal(False)
        loop.on_voice_audio = on_voice
        loop.on_status = lambda msg: setattr(st, "status", msg)
        loop.on_error = lambda msg: setattr(st, "status", f"ERROR: {msg}")

    # -- key handling ------------------------------------------------------
    def handle_key(self, key: str) -> bool:
        """Apply one key toggle; returns False when the UI should quit."""
        st, loop = self.state, self.loop
        if key == "q":
            loop.stop(join=False)
            return False
        if key == "a":
            st.auto_decrypt = not st.auto_decrypt
            loop.auto_decrypt = st.auto_decrypt
            if loop.decoder is not None:
                loop.decoder.auto_decrypt = st.auto_decrypt
        elif key == "d":
            st.denoise = not st.denoise
        elif key == "f":
            st.follow_freq = not st.follow_freq
        elif key == "v":
            st.hear_voice = not st.hear_voice
        elif key == "r":
            st.monitor_raw = not st.monitor_raw
            loop.monitor_raw = st.monitor_raw
        elif key in "+=":
            self._zoom_step(2.0)
        elif key == "-":
            self._zoom_step(0.5)
        elif key == "0":
            st.zoom, st.view_center_mhz = 1.0, None
        return True

    def _zoom_step(self, factor: float,
                   center_mhz: Optional[float] = None) -> None:
        st = self.state
        st.zoom = float(np.clip(st.zoom * factor, 1.0, 10.0))
        if st.zoom <= 1.0:
            st.view_center_mhz = None
        elif center_mhz is not None:
            st.view_center_mhz = center_mhz

    def handle_mouse(self, button: int, col: int, row: int,
                     pressed: bool, width: int = 100) -> None:
        """Reference mouse affordances on the terminal spectrum
        (modern.py:727-903): click = tune, Ctrl-click = snap to the
        interpolated peak near the click, wheel = zoom about the cursor.
        SGR buttons: 0 left, 64/65 wheel up/down; +16 = Ctrl held."""
        st, loop = self.state, self.loop
        if not (SPECTRUM_ROW_FIRST <= row <= SPECTRUM_ROW_LAST):
            return
        freq = freq_at_column(st, col, width)
        if freq is None:
            return
        base = button & ~0x1C            # strip Ctrl/Alt/Shift modifiers
        if base in (64, 65):             # wheel: zoom about the cursor
            self._zoom_step(2.0 if base == 64 else 0.5, center_mhz=freq)
            return
        if pressed and (button & 3) == 0:       # left press
            if button & 16:              # Ctrl-click: peak snap
                fr = st.waterfall.current_freqs
                pw = st.waterfall.current_power
                if fr is not None and pw is not None:
                    peak = find_peak_near(fr, pw, freq)
                    if peak is not None:
                        freq = peak
            loop.set_frequency(freq * 1e6)
            st.frequency_hz = freq * 1e6

    def _key_thread(self, stop_event) -> None:
        import select
        import sys

        def pending(timeout: float) -> bool:
            r, _, _ = select.select([sys.stdin], [], [], timeout)
            return bool(r)

        while not stop_event.is_set():
            if not pending(0.2):
                continue
            ch = sys.stdin.read(1)
            if ch != "\x1b":
                if not self.handle_key(ch):
                    stop_event.set()
                continue
            # escape sequence: accumulate until the mouse terminator (or
            # a short quiet gap — plain ESC / arrow keys are dropped)
            seq = ch
            while len(seq) < 24 and pending(0.02):
                seq += sys.stdin.read(1)
                if seq[-1] in "Mm" and seq.startswith("\x1b[<"):
                    break
            ev = parse_sgr_mouse(seq)
            if ev is not None:
                try:
                    import shutil
                    width = shutil.get_terminal_size().columns
                except OSError:          # pragma: no cover
                    width = 100
                self.handle_mouse(*ev, width=width)

    # -- main loop ----------------------------------------------------------
    def run(self, max_chunks: Optional[int] = None,
            duration_s: Optional[float] = None) -> None:
        import sys

        from rich.console import Console
        from rich.live import Live

        console = Console()
        stop = threading.Event()
        # cbreak setup/restore happens on THIS thread: a daemon key
        # thread's finally never runs at interpreter exit, which would
        # leave the user's shell without echo when the replay drains or
        # --duration expires (only a 'q' keypress would restore it)
        old_termios = None
        mouse_on = False
        if sys.stdin.isatty():
            import termios
            import tty
            fd = sys.stdin.fileno()
            old_termios = termios.tcgetattr(fd)
            tty.setcbreak(fd)
            # xterm SGR mouse reporting: click-to-tune / Ctrl-click peak
            # snap / wheel zoom on the spectrum panel
            sys.stdout.write("\x1b[?1000h\x1b[?1006h")
            sys.stdout.flush()
            mouse_on = True
            threading.Thread(target=self._key_thread, args=(stop,),
                             daemon=True).start()
        failed: List[BaseException] = []

        def work() -> None:
            try:
                self.loop.run(max_chunks=max_chunks)
            except BaseException as e:      # handed to the calling thread
                failed.append(e)

        worker = threading.Thread(target=work, daemon=True)
        worker.start()
        t0 = time.time()
        try:
            # alternate screen when the mouse is live: it pins the view
            # at terminal row 1 so SPECTRUM_ROW_FIRST/LAST gating matches
            # absolute mouse rows (inline rendering in a scrolled
            # terminal would put the spectrum at arbitrary rows and
            # clicks over other panels could silently retune)
            with Live(build_view(self.state, console.width),
                      console=console, screen=mouse_on,
                      refresh_per_second=self.refresh_hz) as live:
                while not stop.is_set():
                    time.sleep(1.0 / self.refresh_hz)
                    live.update(build_view(self.state, console.width))
                    if not worker.is_alive():
                        break
                    if (duration_s is not None
                            and time.time() - t0 > duration_s):
                        break
        finally:
            stop.set()
            if mouse_on:
                sys.stdout.write("\x1b[?1006l\x1b[?1000l")
                sys.stdout.flush()
            if old_termios is not None:
                import termios
                termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN,
                                  old_termios)
            self.loop.stop(join=False)
            if self.audio is not None:
                kept = self.audio.close()
                if kept:
                    console.print(f"[dim]voice recording: {kept}[/]")
        if failed:
            raise failed[0]
