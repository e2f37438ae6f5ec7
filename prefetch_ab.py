#!/usr/bin/env python3
"""The input pipeline's prefetch on against off, in turns, in one process
on one NVIDIA card.

    python3 prefetch_ab.py [--pairs N] [--cells llama-125M,llama-125M-fusedce]

For each cell (a main path of ``chip_smoke.py``, at full width), N pairs
of runs through the entry point's trainer, ``train.prefetch=true`` and
``false``, the order of the two alternating from pair to pair: 20 rounds
read back every 10 grads (``delta_step_for_log=10``, the trainer's
default). Each run gives its mean round ms over rounds 11-20 (the
end-to-end metric of ``PERF.md`` section 2) and the host's dispatch ms
of a round: the median over the rounds that close no logging window, the
time the loop took to enqueue a round without waiting on the card (a
closing round's time includes the read back). Every run's losses and
final parameters must equal the first run's: the prefetch changes no
bit. Prints a line a run, a summary a cell (medians, quartiles, the
pairs the prefetch wins), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import sys


def quartiles(xs: list) -> tuple:
    q = statistics.quantiles(xs, n=4)
    return q[0], statistics.median(xs), q[2]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("prefetch_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from acco_tpu_torch.utils.platform import default_allocator_settings

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--cells", default=",".join(cs.CADENCE_PATHS))
    args = parser.parse_args()
    default_allocator_settings()
    smi = cs.nvidia_smi_line()
    cs.build_all()
    closing = {cs.CADENCE - 1, cs.CADENCE_ROUNDS - 1}  # the rows that read back
    for cell in args.cells.split(","):
        runs = {"on": [], "off": []}
        reference = None
        for pair in range(args.pairs):
            order = ("on", "off") if pair % 2 == 0 else ("off", "on")
            for setting in order:
                mean, summary, flat = cs.cadence_ms(cell, f"train.prefetch={setting == 'on'}")
                rows = summary["round_log"]
                dispatch = statistics.median(r["ms"] for i, r in enumerate(rows)
                                             if i not in closing)
                got = ([summary["seed_loss"]] + [r["loss"] for r in rows], flat)
                if reference is None:
                    reference = got
                elif got[0] != reference[0] or not torch.equal(got[1], reference[1]):
                    raise AssertionError(f"{cell}: a run with the prefetch {setting} changed "
                                         "the losses or the parameters")
                runs[setting].append((mean, dispatch, summary["block_wait_ms"]))
                cs.log(f"{cell} pair {pair} prefetch {setting}: mean round ms {mean:.3f}, "
                       f"dispatch ms {dispatch:.3f}, median block wait "
                       f"{summary['block_wait_ms']:.3f} ms")
                del flat
        wins = sum(on[0] < off[0] for on, off in zip(runs["on"], runs["off"]))
        for setting in ("on", "off"):
            mean_q = quartiles([r[0] for r in runs[setting]])
            disp_q = quartiles([r[1] for r in runs[setting]])
            cs.log(f"{cell} prefetch {setting} on {smi}: mean round ms quartiles "
                   f"{['%.3f' % x for x in mean_q]}, dispatch ms quartiles "
                   f"{['%.3f' % x for x in disp_q]}")
        cs.log(f"{cell}: the prefetch's run faster in {wins} of {args.pairs} pairs; losses and "
               f"parameters bit-equal in every run")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
