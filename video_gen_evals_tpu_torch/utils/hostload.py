"""Host-contention guard for benchmark harnesses.

The port's own copy of ``video_gen_evals_tpu/utils/hostload.py`` (standard
library only, reads ``/proc``). Decode, bank assembly and kernel dispatch run
on the host, so the host's load is part of every number a harness measures,
and a card's machine shares its host's cores. This module makes that state
explicit:

- ``snapshot()`` records the 1-minute load average, the CPU count, and any
  OTHER runnable processes (state R in ``/proc/*/stat``, excluding this
  process tree) at call time.
- ``guard()`` takes a snapshot, prints a loud stderr warning when the host
  looks contended, and, when ``BENCH_REQUIRE_IDLE=1``, refuses to run (exit
  4) so a contended number cannot be recorded silently.

A harness embeds the snapshot in its output, so a number carries the
conditions it was measured under.
"""

from __future__ import annotations

import os
import sys
import typing as T

# A 1-minute load above this fraction of the core count at bench START means
# something else is (or was very recently) competing for the CPU. The bench
# process itself has not started spinning yet at snapshot time, but load1 has
# a ~1-minute memory, so fixture building / compile phases of the bench's own
# process can contribute; the threshold is therefore permissive (0.75/core)
# and the raw value is always recorded for later judgment.
CONTENTION_LOAD_FRAC = 0.75


def _my_process_group() -> set:
    """PIDs of this process and its ancestors (shell wrappers etc.)."""
    pids = set()
    pid = os.getpid()
    for _ in range(16):
        pids.add(pid)
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().split()
            pid = int(fields[3])  # ppid
        except (OSError, ValueError, IndexError):
            break
        if pid <= 1:
            break
    return pids


def _runnable_others() -> T.List[str]:
    """Names of OTHER processes currently in state R (running/runnable)."""
    mine = _my_process_group()
    out = []
    try:
        entries = os.listdir("/proc")
    except OSError:
        return out
    for e in entries:
        if not e.isdigit() or int(e) in mine:
            continue
        try:
            with open(f"/proc/{e}/stat") as f:
                fields = f.read().split()
            # comm can contain spaces but is parenthesized; state is the
            # field after the closing paren
            raw = " ".join(fields)
            close = raw.rindex(")")
            state = raw[close + 1 :].split()[0]
            if state == "R":
                out.append(raw[raw.index("(") + 1 : close])
        except (OSError, ValueError, IndexError):
            continue
    return out


def snapshot() -> dict:
    """One-shot host-load record: take it immediately before timing starts."""
    try:
        load1, load5, _ = os.getloadavg()
    except OSError:  # pragma: no cover - /proc-less platforms
        load1 = load5 = -1.0
    ncpu = os.cpu_count() or 1
    others = _runnable_others()
    contended = bool(others) or (
        load1 >= 0 and load1 > CONTENTION_LOAD_FRAC * ncpu
    )
    return {
        "load1": round(load1, 2),
        "load5": round(load5, 2),
        "ncpu": ncpu,
        "busy_others": others[:8],
        "contended": contended,
    }


def guard(harness: str = "bench") -> dict:
    """Snapshot + loud label; refuse under ``BENCH_REQUIRE_IDLE=1``.

    Returns the snapshot so the caller can embed it in its output JSON.
    """
    snap = snapshot()
    if snap["contended"]:
        msg = (
            f"{harness}: HOST CONTENDED at measurement time "
            f"(load1={snap['load1']} on {snap['ncpu']} core(s)"
            + (
                f"; runnable: {', '.join(snap['busy_others'])}"
                if snap["busy_others"]
                else ""
            )
            + ") — numbers from this run are NOT comparable to idle-host ones"
        )
        print(msg, file=sys.stderr)
        sys.stderr.flush()
        if os.environ.get("BENCH_REQUIRE_IDLE", "0").lower() in (
            "1",
            "true",
            "yes",
        ):
            print(
                f"{harness}: refusing to measure on a contended host "
                "(BENCH_REQUIRE_IDLE=1)",
                file=sys.stderr,
            )
            raise SystemExit(4)
    return snap
