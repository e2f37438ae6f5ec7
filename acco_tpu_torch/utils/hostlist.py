"""SLURM hostlist expansion/compression, with no framework.

A copy of ``acco_tpu/utils/hostlist.py`` (which the port may not import):
a comma-separated list of parts, where each part may contain bracketed
numeric range lists (``n[9-11,14]`` -> ``n9 n10 n11 n14``) with zero-padding
preserved (``n[08-10]`` -> ``n08 n09 n10``). ``parallel/mesh.py`` takes the
first host of ``SLURM_JOB_NODELIST`` as the rendezvous address.
"""

from __future__ import annotations

import itertools
import re
from typing import Iterable, List


def _split_parts(hostlist: str) -> List[str]:
    """Split on commas that are not inside brackets."""
    parts, depth, cur = [], 0, []
    for ch in hostlist:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
            if depth < 0:
                raise ValueError(f"Unbalanced ']' in hostlist: {hostlist!r}")
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if depth != 0:
        raise ValueError(f"Unbalanced '[' in hostlist: {hostlist!r}")
    if cur or not parts:
        parts.append("".join(cur))
    return [p for p in (s.strip() for s in parts) if p]


def _expand_rangelist(rangelist: str) -> List[str]:
    """``"9-11,14,08-10"`` -> ``["9","10","11","14","08","09","10"]``."""
    out: List[str] = []
    for item in rangelist.split(","):
        item = item.strip()
        if not item:
            raise ValueError(f"Empty range item in {rangelist!r}")
        if "-" in item:
            lo_s, _, hi_s = item.partition("-")
            lo, hi = int(lo_s), int(hi_s)
            if hi < lo:
                raise ValueError(f"Descending range {item!r}")
            width = len(lo_s) if lo_s.startswith("0") else 0
            for v in range(lo, hi + 1):
                out.append(str(v).zfill(width) if width else str(v))
        else:
            out.append(item)
    return out


def _expand_part(part: str) -> List[str]:
    """Expand one comma-free part, which may hold several bracket groups."""
    segments: List[List[str]] = []
    pos = 0
    for match in re.finditer(r"\[([^\]]*)\]", part):
        literal = part[pos : match.start()]
        if literal:
            segments.append([literal])
        segments.append(_expand_rangelist(match.group(1)))
        pos = match.end()
    tail = part[pos:]
    if tail:
        segments.append([tail])
    if not segments:
        return [part]
    return ["".join(combo) for combo in itertools.product(*segments)]


def expand_hostlist(hostlist: str) -> List[str]:
    """Expand a SLURM hostlist expression into the ordered list of hosts."""
    hosts: List[str] = []
    for part in _split_parts(hostlist):
        hosts.extend(_expand_part(part))
    return hosts


def collect_hostlist(hosts: Iterable[str]) -> str:
    """Compress a list of hostnames into a SLURM hostlist expression.

    Groups hosts sharing a prefix whose suffix is numeric, preserving
    zero-padding width; inverse of :func:`expand_hostlist` up to ordering.
    """
    plain: List[str] = []
    grouped: dict[tuple[str, int], List[int]] = {}
    for host in hosts:
        m = re.match(r"^(.*?)(\d+)$", host)
        if not m:
            plain.append(host)
            continue
        prefix, digits = m.group(1), m.group(2)
        width = len(digits) if digits.startswith("0") else 0
        grouped.setdefault((prefix, width), []).append(int(digits))

    out: List[str] = []
    for (prefix, width), values in grouped.items():
        values = sorted(set(values))
        ranges: List[str] = []
        i = 0
        while i < len(values):
            j = i
            while j + 1 < len(values) and values[j + 1] == values[j] + 1:
                j += 1
            fmt = (lambda v: str(v).zfill(width)) if width else str
            ranges.append(
                fmt(values[i]) if i == j else f"{fmt(values[i])}-{fmt(values[j])}"
            )
            i = j + 1
        if len(ranges) == 1 and "-" not in ranges[0]:
            out.append(prefix + ranges[0])
        else:
            out.append(f"{prefix}[{','.join(ranges)}]")
    out.extend(plain)
    return ",".join(out)


def parse_slurm_tasks_per_node(expr: str) -> List[int]:
    """``"2(x3),1"`` -> ``[2, 2, 2, 1]`` (SLURM_TASKS_PER_NODE format)."""
    counts: List[int] = []
    for item in expr.split(","):
        m = re.match(r"^(\d+)(?:\(x(\d+)\))?$", item.strip())
        if not m:
            raise ValueError(f"Bad SLURM_TASKS_PER_NODE item: {item!r}")
        counts.extend([int(m.group(1))] * int(m.group(2) or 1))
    return counts
