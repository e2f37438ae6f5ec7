"""The kernel libraries built in the background at trainer construction,
and the report of what was built and captured.

Counterpart of ``acco_tpu/compile/warmup.py``. Without it every CUDA
library of the run is built by ``nvcc`` at its first launch, inside the
first round (about 20 s on a fresh checkout). :class:`CompileWarmup`
starts in ``Trainer.__init__``, before the data section, as JAX's does:
each library of ``compile.cache.libraries_for`` is built on a thread
pool; ``nvcc`` is a subprocess, so the builds run beside tokenization.
:meth:`CompileWarmup.join` comes right before the first round; the
trainer then captures its round programs (``compile/graphs.py``), whose
records (:class:`ProgramRecord`) join the report in the summary's
``compile_report``.

Failure policy, as in JAX: a background build's error is recorded in its
record and never raised here; the same build runs again at the
library's first use, where it raises. No path gives way to the plain
versions.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Optional

_log = logging.getLogger(__name__)


@dataclass
class LibraryRecord:
    """One library's background build: wall ms, whether ``build/`` held
    it already, and the error, if any."""

    name: str
    build_ms: Optional[float] = None
    cached: Optional[bool] = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclass
class ProgramRecord:
    """One captured program (a round of one parity and buffer phase, a
    DDP step, the eval step): its warm-up and capture ms, the device
    memory after its capture, and the error, if any."""

    name: str
    warmup_ms: Optional[float] = None
    capture_ms: Optional[float] = None
    error: Optional[str] = None
    memory_gib: Optional[tuple] = None  # (allocated, reserved) after the capture

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclass
class WarmupReport:
    """What the warmup built; ``wall_ms`` runs from the warmup's start to
    its join, ``join_ms`` is the join's wait. The trainer adds the
    programs' records (``compile_report``)."""

    libraries: dict = field(default_factory=dict)  # name -> LibraryRecord
    wall_ms: Optional[float] = None
    join_ms: Optional[float] = None

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.libraries.values())

    def log_lines(self) -> list:
        return [f"build[{name}]: " + (
                    f"{r.build_ms:.0f} ms{' (cached)' if r.cached else ''}" if r.ok
                    else f"FAILED ({r.error}); it builds again at first use")
                for name, r in sorted(self.libraries.items())]

    def as_dict(self) -> dict:
        """The builds' part of the summary's ``compile_report`` (JAX:
        ``compile_report``)."""
        return {"libraries": {n: dict(vars(r)) for n, r in self.libraries.items()},
                "wall_ms": self.wall_ms, "join_ms": self.join_ms}


def _build_one(name: str, build: Callable) -> LibraryRecord:
    from acco_tpu_torch.utils import cuda_build

    rec = LibraryRecord(name)
    t0 = time.perf_counter()
    try:
        build(name)
        rec.cached = bool(cuda_build.BUILD_INFO.get(name, {}).get("cached", False))
    except Exception as exc:  # noqa: BLE001 — recorded; the first use builds again and raises
        rec.error = f"{type(exc).__name__}: {exc}"
    rec.build_ms = (time.perf_counter() - t0) * 1e3
    return rec


class CompileWarmup:
    """Build ``libraries`` on a thread pool from construction on;
    :meth:`join` waits for them and returns the report. ``build`` is
    ``utils.cuda_build.build`` unless a test hands in its own."""

    def __init__(self, libraries, build: Optional[Callable] = None, max_workers: int = 4,
                 log=None) -> None:
        if build is None:
            from acco_tpu_torch.utils.cuda_build import build
        self._log = log or _log
        self._t0 = time.perf_counter()
        names = list(dict.fromkeys(libraries))
        self._pool = ThreadPoolExecutor(max_workers=max(1, min(max_workers, len(names) or 1)),
                                        thread_name_prefix="acco-build")
        self._futures = {n: self._pool.submit(_build_one, n, build) for n in names}
        self.report: Optional[WarmupReport] = None

    def join(self) -> WarmupReport:
        """Wait for every build; log one line per library; idempotent.
        Never raises for a failed build (see the module's doc)."""
        if self.report is not None:
            return self.report
        t0 = time.perf_counter()
        report = WarmupReport({n: f.result() for n, f in self._futures.items()})
        self._pool.shutdown(wait=True)
        report.join_ms = (time.perf_counter() - t0) * 1e3
        report.wall_ms = (time.perf_counter() - self._t0) * 1e3
        for line in report.log_lines():
            self._log.info("%s", line)
        failed = [n for n, r in report.libraries.items() if not r.ok]
        if failed:
            self._log.warning("background build failed for %s; each builds again at its first "
                              "use and raises there", failed)
        self.report = report
        return report
