"""Run logging: TensorBoard scalars, the results.csv ledger, progress lines.

A copy of ``acco_tpu/utils/logs.py`` (which imports no framework) for the
port, which imports nothing of the JAX package: the same TensorBoard
scalar names (``loss_t`` / ``loss_step`` / ``loss_samples``, the
``eval_loss_*`` family and the ``health/*`` scalars), the
append-with-schema-merge ``results.csv`` ledger with its ``provenance``
column, the per-N-grads progress line and the run-id scheme. TensorBoard
writing goes through ``torch.utils.tensorboard`` and degrades to
:class:`NoOpWriter` where the ``tensorboard`` package is missing (the
card's machine has none), so training never depends on it. The
``device`` column is the platform as the JAX package names it: ``gpu``
on a card, ``cpu`` on the CPU (:func:`platform_name`). The watchdog's
columns (:func:`health_columns`, ``rollbacks`` among them) and the
declared metrics' ``telemetry/*`` scalars
(:func:`log_telemetry_to_tensorboard`) are the port's additions.
"""

from __future__ import annotations

import csv
import datetime
import os
import random
import time
from typing import Any, Dict, Iterable, Optional


class NoOpWriter:
    """Stand-in for SummaryWriter when tensorboard is unavailable."""

    def add_scalars(self, *args: Any, **kwargs: Any) -> None:
        pass

    def add_scalar(self, *args: Any, **kwargs: Any) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def make_summary_writer(log_dir: str):
    """A ``SummaryWriter`` on ``log_dir``, or :class:`NoOpWriter` when
    TensorBoard cannot be imported (it creates no directory then).

    TensorBoard resolves its TensorFlow-like API once per process, and
    takes TensorFlow itself where it is installed (a ~10 s import) unless
    a ``tensorboard.compat.notf`` module exists: its own switch to the
    TensorFlow-free stub, which writes the same event files. Unless
    TensorFlow is already imported, the writer is made with that switch
    in ``sys.modules`` and the entry is taken out again before returning;
    TensorBoard keeps the stub for the rest of the process."""
    import sys
    import types

    switch = "tensorboard.compat.notf"
    planted = switch not in sys.modules and "tensorflow" not in sys.modules
    if planted:
        sys.modules[switch] = types.ModuleType(switch)
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir)
    except Exception:
        return NoOpWriter()
    finally:
        if planted:
            sys.modules.pop(switch, None)


def platform_name(device) -> str:
    """``gpu`` for a CUDA device, else the device type (``cpu``): the
    ``device`` column as JAX's ``jax.devices()[0].platform`` fills it."""
    kind = getattr(device, "type", str(device))
    return "gpu" if kind == "cuda" else kind


def create_id_run() -> str:
    """Timestamped run id with a random suffix to disambiguate simultaneous
    cluster launches (as ``acco_tpu.utils.logs.create_id_run``)."""
    now = datetime.datetime.now()
    stamp = "_".join(
        str(part)
        for part in [now.year, now.month, now.day, now.hour, now.minute, now.second]
    )
    return f"{stamp}_{random.randint(0, 100)}"


def create_dict_result(
    args: Dict[str, Any],
    world_size: int,
    n_nodes: int,
    device_name: str,
    total_time: float,
    id_run: str,
    loss: float,
) -> Dict[str, Any]:
    """Flatten a finished run into one results-ledger row."""
    result = dict(args)
    result["0_id_run"] = id_run
    result["Tot_time"] = "{} min {:.1f} s".format(int(total_time // 60), total_time % 60)
    result["N_workers"] = world_size
    result["n_nodes"] = n_nodes
    result["device"] = device_name
    result["Loss_final"] = float(loss)
    return result


def save_result(path_to_result_csv: str, dict_result: Dict[str, Any]) -> None:
    """Append a row to results.csv, merging schemas across runs so rows with
    different config keys coexist.

    Every row appended through this function is a live append, so it
    defaults ``provenance='measured'``: the flag that lets readers of the
    ledger filter out hand-restored rows, which carry
    ``provenance='restored'``."""
    dict_result = dict(dict_result)
    dict_result.setdefault("provenance", "measured")
    rows: list[Dict[str, Any]] = []
    fieldnames: set[str] = set()
    if os.path.exists(path_to_result_csv):
        with open(path_to_result_csv, "r", newline="") as f:
            for row in csv.DictReader(f):
                fieldnames.update(row.keys())
                rows.append(dict(row))
    fieldnames.update(dict_result.keys())
    rows.append({k: v for k, v in dict_result.items()})
    ordered = sorted(fieldnames)
    with open(path_to_result_csv, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=ordered)
        writer.writeheader()
        for row in rows:
            writer.writerow(row)


def save_grad_acc(
    id_run: str,
    path_logs: str,
    rank: int,
    list_grad_acc: Iterable[Any],
    list_grad_times: Iterable[Any] = (),
) -> None:
    """Dump per-rank grad-count / step-time traces for offline analysis."""
    folder = os.path.join(path_logs, "grad_counts")
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, f"{id_run}_{rank}.txt"), "w") as f:
        f.write(f"{rank} # grad acc : {list(list_grad_acc)}\n")
        f.write(f"{rank} time step (ms) : {list(list_grad_times)}\n")


def print_training_evolution(
    log,
    nb_grad_local: int,
    nb_com_local: int,
    delta_step_for_log: int,
    rank: int,
    t_beg: float,
    t_last_epoch: float,
    loss: float,
    epoch: int,
) -> tuple[int, float]:
    """Emit the per-`delta_step_for_log`-grads progress line."""
    if nb_grad_local // delta_step_for_log > epoch:
        epoch += 1
        delta_t = time.time() - t_beg
        log.info(
            " Worker {}. {}th group of {} steps in {:.2f} s. "
            "Total time: {} min {:.2f} s. # grad : {} . # com : {}. loss {}".format(
                rank,
                epoch,
                delta_step_for_log,
                time.time() - t_last_epoch,
                int(delta_t // 60),
                delta_t % 60,
                nb_grad_local,
                nb_com_local,
                float(loss),
            )
        )
        t_last_epoch = time.time()
    return epoch, t_last_epoch


def log_health_to_tensorboard(
    writer,
    nb_step: int,
    grad_norm: float,
    skipped_rounds: int,
    consec_skipped: int,
    rollbacks: int,
) -> None:
    """Training-health scalars (the watchdog's columns), alongside the
    loss family at the same logging cadence."""
    writer.add_scalar("health/grad_norm", float(grad_norm), nb_step)
    writer.add_scalar("health/skipped_rounds", int(skipped_rounds), nb_step)
    writer.add_scalar("health/consec_skipped", int(consec_skipped), nb_step)
    writer.add_scalar("health/rollbacks", int(rollbacks), nb_step)


def health_columns(monitor_summary: Dict[str, Any], skipped_rounds: int,
                   rollbacks: int) -> Dict[str, Any]:
    """The watchdog's ``results.csv`` columns, as JAX's trainer folds
    them into its row: the monitor's counters (spikes, drift episodes),
    the device's lifetime ``skipped_rounds`` and the run's ``rollbacks``."""
    row = dict(monitor_summary)
    row["skipped_rounds"] = int(skipped_rounds)
    row["rollbacks"] = int(rollbacks)
    return row


def log_telemetry_to_tensorboard(writer, nb_step: int, registry=None) -> None:
    """Every emitted metric of ``registry`` (the port's global one by
    default) as a ``telemetry/<name>`` scalar at ``nb_step``: one number
    each, histograms at their p50 (``MetricsRegistry.to_tensorboard``);
    nothing for a :class:`NoOpWriter`."""
    if isinstance(writer, NoOpWriter):
        return
    if registry is None:
        from acco_tpu_torch.telemetry.metrics import REGISTRY as registry
    registry.to_tensorboard(writer, nb_step)


def log_to_tensorboard(
    writer,
    nb_step: int,
    nb_samples: int,
    rank: int,
    loss: float,
    eval_loss: Optional[float],
    t0: float,
    delta_step_for_log: int,
    epoch: int,
) -> None:
    """Loss and eval loss against wall time, optimizer step and sample
    count, under the JAX package's scalar names."""
    if nb_samples // delta_step_for_log <= epoch:
        return
    if eval_loss is not None:
        eval_loss = float(eval_loss)
        writer.add_scalars("eval_loss_step", {str(rank): eval_loss}, nb_step)
        writer.add_scalars("eval_loss_t", {str(rank): eval_loss}, time.time() - t0)
        writer.add_scalars("eval_loss_samples", {str(rank): eval_loss}, nb_samples)
    loss_f = float(loss)
    writer.add_scalars("loss_t", {str(rank): loss_f}, time.time() - t0)
    writer.add_scalars("loss_step", {str(rank): loss_f}, nb_step)
    writer.add_scalars("loss_samples", {str(rank): loss_f}, nb_samples)
