"""In-place per-iteration progress line for the training loop (a copy of
`ccdm_tpu/utils/progress.py`).

Parity: the reference attaches an ignite ``ProgressBar`` (tqdm) to the train
engine (``ddpm/trainer.py:410``) that redraws once per iteration. A naive
translation would be wrong on an accelerator: redrawing per step would either force a
device sync (to print the loss) or flood logs when steps take ~20 ms. This
implementation is async-friendly by construction:

- it never touches device values (the caller passes host-side counters only;
  loss is whatever was last *drained* from the metrics deque, possibly a few
  steps stale — the trainer's non-blocking dispatch pipeline stays intact);
- redraws are wall-clock rate-limited (default 4 Hz), so the cost is a few
  string formats per second regardless of step rate;
- it only draws on an interactive stderr (like tqdm's ``file.isatty()``
  gate) and only on the main process, so multihost runs and piped logs see
  nothing — the ``display_freq`` log lines remain the durable record.
"""

from __future__ import annotations

import sys
import time
from typing import Optional


class ProgressLine:
    """Rate-limited ``\\r``-style progress line on stderr.

    Enabled only when ``enable`` is true AND stderr is a tty. All ``update``
    calls are cheap no-ops otherwise, so the trainer can call it
    unconditionally per step.
    """

    def __init__(self, enable: bool = True, min_interval_s: float = 0.25,
                 stream=None):
        self._stream = stream if stream is not None else sys.stderr
        isatty = getattr(self._stream, "isatty", lambda: False)()
        self.enabled = bool(enable) and isatty
        self._min_interval = float(min_interval_s)
        self._last_draw = 0.0
        self._last_len = 0
        self._t0 = time.perf_counter()
        self._items0 = 0

    def update(self, *, epoch: int, step: int, steps_per_epoch: int,
               items_done: int, loss: Optional[float] = None,
               force: bool = False) -> None:
        """Redraw if the rate limit allows. ``items_done`` is a cumulative
        host-side item counter used for the smoothed rate; ``loss`` may be
        stale or None (drawn as ``--``)."""
        if not self.enabled:
            return
        now = time.perf_counter()
        if not force and (now - self._last_draw) < self._min_interval:
            return
        self._last_draw = now
        rate = (items_done - self._items0) / max(now - self._t0, 1e-9)
        pos = step % steps_per_epoch if steps_per_epoch else step
        pos = steps_per_epoch if (pos == 0 and step) else pos
        bar = ""
        if steps_per_epoch:
            frac = min(max(pos / steps_per_epoch, 0.0), 1.0)
            filled = int(frac * 20)
            bar = "|" + "#" * filled + "-" * (20 - filled) + "| "
        loss_s = f"{loss:.4g}" if loss is not None else "--"
        line = (f"epoch {epoch} {bar}{pos}/{steps_per_epoch or '?'} "
                f"[{rate:.1f} img/s, loss={loss_s}]")
        pad = " " * max(self._last_len - len(line), 0)
        self._stream.write("\r" + line + pad)
        self._stream.flush()
        self._last_len = len(line)

    def reset_rate_window(self, items_done: int) -> None:
        """Restart the smoothed-rate window (e.g. after validation pauses)."""
        self._t0 = time.perf_counter()
        self._items0 = int(items_done)

    def close(self) -> None:
        """Finish the line so subsequent log output starts on a fresh row."""
        if self.enabled and self._last_len:
            self._stream.write("\n")
            self._stream.flush()
            self._last_len = 0
