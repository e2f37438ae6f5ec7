"""The static gates of the port.

Counterpart of ``acco_tpu/analysis/``. Nine gates prove, every PR, the
invariants the port's value rests on:

- :mod:`~acco_tpu_torch.analysis.rules`: every state leaf matches
  exactly one rule of its program's rule table (``sharding/tables.py``);
- :mod:`~acco_tpu_torch.analysis.dtypes`: bf16 working params, float32
  master and Adam state, int32 counters, over every state leaf (closed
  world);
- :mod:`~acco_tpu_torch.analysis.host_lint`: host syncs in loops,
  threads without a join path, unused imports;
- :mod:`~acco_tpu_torch.analysis.metrics_gate`: every literal telemetry
  name resolves against ``telemetry/``'s declarations;
- :mod:`~acco_tpu_torch.analysis.slow_markers`: the port's tests over
  the time threshold carry ``@pytest.mark.slow``;
- :mod:`~acco_tpu_torch.analysis.census`: a round's collectives against
  JAX's analytic comm model (read by
  :mod:`~acco_tpu_torch.analysis.trace`);
- :mod:`~acco_tpu_torch.analysis.donation`: the in-place check, the
  port's counterpart of honoured donation;
- :mod:`~acco_tpu_torch.analysis.overlap`: a profiled ACCO round's comm
  side runs under its compute;
- :mod:`~acco_tpu_torch.analysis.memory`: the meta-tensor memory sieve.

:mod:`~acco_tpu_torch.analysis.programs` builds the registry of
programs the program gates walk. ``python -m acco_tpu_torch.analysis
--ci`` is the one entry point (``tools/lint.py --ci``'s counterpart).
"""

from acco_tpu_torch.analysis.host_lint import Finding, lint_file, lint_paths  # noqa: F401
from acco_tpu_torch.analysis.rules import RuleCoverageReport, check_rule_coverage  # noqa: F401

__all__ = ["Finding", "lint_file", "lint_paths", "RuleCoverageReport", "check_rule_coverage"]
