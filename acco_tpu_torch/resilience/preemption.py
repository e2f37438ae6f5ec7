"""Preemption-safe shutdown: turn SIGTERM into a resumable event.

A copy of ``acco_tpu/resilience/preemption.py`` for the port. A
preempted job (and Ctrl-C) gets SIGTERM/SIGINT with a grace window.
Without a handler the process dies wherever it happens to be — perhaps
mid-write, leaving an orphan ``step_*`` dir and losing everything since
the last periodic checkpoint. :class:`ShutdownHandler` converts the
signal into a *request*: the train loop polls ``should_stop()`` at each
round boundary, writes a final checkpoint, drains the prefetcher and the
in-flight save, and returns normally with ``summary["interrupted"] =
True`` — the run resumes bit-exactly from ``train.resume_from``.

A second signal escalates: the operator (or the platform's hard-kill
timer beating our drain) should not have to wait on a graceful path
that is itself stuck. Handlers are installed only on the main thread
(Python restricts ``signal.signal`` to it) and always restored, so a
trainer embedded in pytest or a larger host app never leaks its
handlers.

Several ranks: delivery is per-process and not simultaneous, so the
*decision* to stop must be collective — the trainer all-reduces the
flag at a round cadence (``Trainer._preempted``), the same pattern as
its collective checkpoint-due decision.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

_module_log = logging.getLogger(__name__)

DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class ShutdownHandler:
    """Latch SIGTERM/SIGINT into a poll-able shutdown request.

    Usage::

        handler = ShutdownHandler(log)
        handler.install()          # no-op (False) off the main thread
        try:
            while training:
                ...
                if handler.should_stop():
                    break          # checkpoint + drain + exit cleanly
        finally:
            handler.uninstall()

    ``request()`` sets the latch programmatically — the hook for
    cluster-manager preemption notices (and for deterministic fault
    injection: ``resilience.faults.ShutdownAfterRounds``).
    """

    def __init__(
        self,
        log: Optional[logging.Logger] = None,
        signals=DEFAULT_SIGNALS,
    ) -> None:
        self.log = log or _module_log
        self.signals = tuple(signals)
        self._requested = threading.Event()
        self._prev: dict = {}
        self._signals_seen = 0

    # -- lifecycle ----------------------------------------------------------

    def install(self) -> bool:
        """Install the handlers; returns False (and stays a pure
        ``request()``-driven latch) when not on the main thread.

        Resets the second-signal escalation counter: a signal absorbed
        by a PREVIOUS installation must not turn this run's first signal
        into a hard kill. The request latch itself is deliberately NOT
        cleared (a preemption notice delivered via ``request()`` before
        train() starts must survive); discard the handler instead of
        reusing it across runs — the trainer drops its auto-created one
        after each train()."""
        self._signals_seen = 0
        if self._prev:
            return True
        try:
            for sig in self.signals:
                self._prev[sig] = signal.signal(sig, self._on_signal)
        except ValueError:  # not the main thread
            for sig, prev in self._prev.items():
                signal.signal(sig, prev)
            self._prev.clear()
            self.log.warning(
                "signal handlers need the main thread; preemption-safe "
                "shutdown is request()-only here"
            )
            return False
        return True

    def uninstall(self) -> None:
        """Restore whatever handlers were installed before us."""
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # torn down off-main-thread/interp
                pass
        self._prev.clear()

    def __enter__(self) -> "ShutdownHandler":
        self.install()
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- the latch ----------------------------------------------------------

    def _on_signal(self, signum, frame) -> None:
        self._signals_seen += 1
        if self._signals_seen >= 2:
            # The graceful path is taking too long for whoever is
            # signaling: restore the previous handlers and let the
            # signal act on them (for SIGINT that is KeyboardInterrupt).
            self.uninstall()
            self.log.warning(
                "second %s: giving up the graceful shutdown",
                signal.Signals(signum).name,
            )
            signal.raise_signal(signum)
            return
        self._requested.set()
        self.log.warning(
            "%s received: checkpointing at the next round boundary, then "
            "exiting cleanly (signal again to force)",
            signal.Signals(signum).name,
        )

    def request(self) -> None:
        """Programmatic shutdown request (preemption notice APIs, tests)."""
        self._requested.set()

    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    def should_stop(self) -> bool:
        """Poll point for the round loop (subclass hook for fault
        injection — see ``resilience/faults.py``)."""
        return self._requested.is_set()
