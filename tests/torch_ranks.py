"""Run a script on several gloo ranks for the port's distributed tests.

Each rank is its own Python process (``python -c <script> <rank> <world
size> <store> <workdir>``) that imports torch and the port, never JAX. The
script initialises its process group through a ``file://`` store in the
test's temporary directory (no fixed port: the suite runs under
pytest-xdist), does its work, and writes its results into the work
directory. :func:`run_ranks` joins the processes under a timeout and
fails, with their output, if one hangs or exits non-zero.
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = """
import os, sys
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
RANK, WS, STORE, WORKDIR = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + STORE, rank=RANK, world_size=WS)
"""


def run_ranks(script: str, ws: int, workdir, timeout: float = 120.0) -> None:
    """Run ``script`` (after :data:`PRELUDE`) on ``ws`` ranks; raise with
    the ranks' output if any fails or the group does not finish within
    ``timeout`` seconds."""
    workdir = str(workdir)
    store = os.path.join(workdir, "store")
    code = PRELUDE.format(repo=REPO) + script + "\ndist.destroy_process_group()\n"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(ws), store, workdir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for r in range(ws)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the {ws} ranks did not finish within {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, out) for r, (p, out) in enumerate(zip(procs, outs)) if p.returncode]
    if failed:
        raise AssertionError("\n".join(
            f"rank {r} exited {rc}:\n{out[-3000:]}" for r, rc, out in failed))
