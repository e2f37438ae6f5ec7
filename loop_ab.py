#!/usr/bin/env python3
"""The train loop of this tree against another tree's, in turns, on one
NVIDIA card.

    python3 loop_ab.py --other <dir of another checkout> [--pairs N]
        [--cells llama-125M,llama-125M-fusedce] [--cadences 1,10]

For each cell (a main path of ``chip_smoke.py``, at full width) and each
logging cadence, N pairs of runs of the entry point
(``python -m acco_tpu_torch``, one process a run, from the root of each
tree, so that each tree builds and loads its own kernels), the order of
the two trees alternating from pair to pair: 20 rounds, no save. Each
run gives the median round ms (at cadence 1 every round is read back: a
round's ms is its synced time, as ``PERF.md`` section 2 defines it) and
the mean round ms over rounds 11-20 (at cadence 10, the trainer's
default). Every run's round losses must equal the first run's of its
cell and cadence: the two trees must compute the same rounds. Prints a
line a run, a summary a cell and cadence (medians of the runs, the pairs
this tree wins), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 20


def run(tree: str, cell: str, cadence: int, run_dir: str) -> dict:
    """One run of the entry point in ``tree``; its summary."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    args = [a for a in cs.main_args(cell, cadence) if not a.startswith("hydra.run.dir=")]
    args = [a for a in args if not a.startswith("train.nb_steps_tot=")]
    out = subprocess.run(
        [sys.executable, "-m", "acco_tpu_torch", *args, f"train.nb_steps_tot={ROUNDS}",
         f"hydra.run.dir={run_dir}"],
        cwd=tree, capture_output=True, text=True, timeout=600,
    )
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: {cell} at cadence {cadence} failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("loop_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--other", required=True)
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--cells", default="llama-125M,llama-125M-fusedce")
    parser.add_argument("--cadences", default="1,10")
    args = parser.parse_args()
    trees = {"this": REPO, "other": os.path.abspath(args.other)}
    smi = cs.nvidia_smi_line()
    with tempfile.TemporaryDirectory() as tmp:
        for cell in args.cells.split(","):
            for cadence in map(int, args.cadences.split(",")):
                got = {"this": [], "other": []}
                reference = None
                for pair in range(args.pairs):
                    order = ("this", "other") if pair % 2 == 0 else ("other", "this")
                    for name in order:
                        summary = run(trees[name], cell, cadence,
                                      os.path.join(tmp, f"{cell}-{cadence}-{pair}-{name}"))
                        rows = summary["round_log"]
                        losses = [r["loss"] for r in rows]
                        if reference is None:
                            reference = losses
                        elif losses != reference:
                            raise AssertionError(f"{cell} at cadence {cadence}: the {name} "
                                                 "tree's losses differ from the first run's")
                        median = statistics.median(r["ms"] for r in rows)
                        mean = statistics.fmean(r["ms"] for r in rows[10:])
                        got[name].append((median, mean))
                        print(f"{cell} cadence {cadence} pair {pair} {name}: median round "
                              f"{median:.3f} ms, mean of rounds 11-{ROUNDS} {mean:.3f} ms",
                              flush=True)
                key = 0 if cadence == 1 else 1
                wins = sum(t[key] < o[key] for t, o in zip(got["this"], got["other"]))
                print(f"{cell} cadence {cadence}: "
                      f"{'median round' if key == 0 else 'mean of rounds 11-20'} this "
                      f"{statistics.median(t[key] for t in got['this']):.3f} ms, other "
                      f"{statistics.median(o[key] for o in got['other']):.3f} ms; this tree "
                      f"faster in {wins} of {args.pairs} pairs", flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
