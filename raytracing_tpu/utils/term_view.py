"""Live terminal presentation of rendered frames.

The reference presents frames in a winit window with a pixels GPU blit
(/root/reference/src/main.rs:383-399, :497-500). An accelerator render
service is headless — its "window" is whatever terminal the operator is attached to
— so the live analog is ANSI truecolor half-block art: each character
cell shows two image rows (upper-half-block glyph: foreground = top
pixel, background = bottom pixel), giving a WxH/2-character live preview
over plain stdout/ssh with zero dependencies.

Used by `python -m raytracing_tpu.app animate --live`; also handy in
tmux while a long fit runs. Frames overdraw in place via cursor-home so
the loop looks like an animation, not a scrolling log.
"""

from __future__ import annotations

import sys

import numpy as np

_HALF = "▀"  # upper half block


def frame_to_ansi(img: np.ndarray, max_cols: int = 100) -> str:
    """Encode an [H, W, 3] float (0..1) or uint8 image as ANSI truecolor
    half-block text (one text row per two pixel rows), downsampling by
    integer strides to fit `max_cols` columns."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w = a.shape[:2]
    step = max(1, (w + max_cols - 1) // max_cols)
    a = a[::step, ::step]
    if a.shape[0] % 2:  # pair rows for top/bottom halves
        a = a[:-1]
    top, bot = a[0::2], a[1::2]
    out = []
    for tr, br in zip(top, bot):
        row = []
        for (r1, g1, b1), (r2, g2, b2) in zip(tr, br):
            row.append(f"\x1b[38;2;{r1};{g1};{b1}m"
                       f"\x1b[48;2;{r2};{g2};{b2}m{_HALF}")
        out.append("".join(row) + "\x1b[0m")
    return "\n".join(out)


class TermViewer:
    """In-place frame redraw: first show() clears the screen, subsequent
    ones re-home the cursor so frames replace each other (the terminal
    analog of the reference's per-frame framebuffer blit)."""

    def __init__(self, max_cols: int = 100, stream=None):
        self.max_cols = max_cols
        self.stream = stream or sys.stdout
        self._first = True

    def show(self, img: np.ndarray, status: str = "") -> None:
        body = frame_to_ansi(img, self.max_cols)
        prefix = "\x1b[2J\x1b[H" if self._first else "\x1b[H"
        self._first = False
        self.stream.write(prefix + body + "\n" + status + "\x1b[K\n")
        self.stream.flush()
