"""Per-file worker seconds of a pytest run, and a replay of its xdist deal.

    python tools/tier1_replay.py RUN.xml [MORE.xml ...]

Each argument is the ``--junitxml`` report of a run of the tier-1 command
(``pytest -n 6 --dist loadfile``).  For each report this prints the run's
worker seconds summed over all files and over the port's files
(``tests/test_torch_*.py``), then a table of every test file: its test
count, worker seconds (junit's time: setup, call and teardown), and its
start and end in a replay of pytest-xdist 3.8's ``loadfile`` deal.

The replay deals files as xdist does: in descending order of test count,
ties in collection order (pytest collects ``tests/`` in name order), one
file to each of 6 workers, then a file more to a worker whose pending
tests fall to 2 or fewer (``LoadScopeScheduling._reschedule``); each
worker runs its tests one after another at their reported times.  Its
longest worker is the replayed wall time: the run's critical path,
without pytest's start-up and collection.
"""
from __future__ import annotations

import collections
import sys
import xml.etree.ElementTree as ET

WORKERS = 6
PENDING_LOW = 2


def load(path: str) -> list[tuple[str, float]]:
    """[(test file, seconds)] in report order."""
    out = []
    for case in ET.parse(path).getroot().iter("testcase"):
        parts = case.get("classname").split(".")
        out.append((f"{parts[0]}/{parts[1]}.py", float(case.get("time"))))
    return out


def replay(tests: list[tuple[str, float]], workers: int = WORKERS):
    """(wall seconds, {file: (start, end)}, files in deal order)."""
    times = collections.defaultdict(list)
    for f, t in tests:
        times[f].append(t)
    deal = sorted(sorted(times), key=lambda f: -len(times[f]))
    queue = list(deal)
    pending = [[] for _ in range(workers)]     # [file, remaining times]
    clock = [0.0] * workers
    span = {}

    def give(w: int) -> None:
        f = queue.pop(0)
        pending[w].append([f, list(times[f])])

    for w in range(workers):
        if queue:
            give(w)
    for w in range(workers):
        if queue and sum(len(p[1]) for p in pending[w]) <= PENDING_LOW:
            give(w)
    while any(pending):
        w = min((w for w in range(workers) if pending[w]),
                key=lambda w: clock[w])
        f, left = pending[w][0]
        span.setdefault(f, [clock[w], clock[w]])
        if left:
            clock[w] += left.pop(0)
        if not left:
            span[f][1] = clock[w]
            pending[w].pop(0)
        if queue and sum(len(p[1]) for p in pending[w]) <= PENDING_LOW:
            give(w)
    return max(clock), span, deal


def report(path: str) -> None:
    tests = load(path)
    worker_s = collections.Counter()
    count = collections.Counter()
    for f, t in tests:
        worker_s[f] += t
        count[f] += 1
    wall, span, deal = replay(tests)
    port = sum(t for f, t in worker_s.items() if "test_torch_" in f)
    print(f"{path}: worker s {sum(worker_s.values()):.1f}, port files "
          f"{port:.1f}; replayed wall {wall:.0f} s")
    print(f"{'':3s} {'file':44s} {'tests':>5s} {'worker_s':>9s} "
          f"{'start':>7s} {'end':>7s}")
    for i, f in enumerate(deal, 1):
        start, end = span.get(f, (0.0, 0.0))
        print(f"{i:3d} {f:44s} {count[f]:5d} {worker_s[f]:9.1f} "
              f"{start:7.0f} {end:7.0f}")


if __name__ == "__main__":
    for xml_path in sys.argv[1:]:
        report(xml_path)
