#!/usr/bin/env python3
"""Per-file worker time of a pytest-xdist run, from its JUnit XML and its
``-v`` log.

    python3 scripts/tier1_file_times.py RUN.xml RUN.log [--top N]

For each test file: its tests, the seconds its tests took (the JUnit
``time`` of each test case, setup and teardown included, summed), the
xdist worker that ran it (``--dist loadfile`` gives a file one worker) and
the position in the log of its last result line (the files that finish
last set the run's wall time).  Prints a Markdown table ordered by that
position, last finisher first, and the total worker time.
"""

from __future__ import annotations

import re
import sys
import xml.etree.ElementTree as ET
from collections import defaultdict

RESULT = re.compile(r"^\[(gw\d+)\] \[\s*\d+%\] \w+ (tests/[^:]+\.py)::")


def file_times(xml_path: str, log_path: str) -> tuple[list[dict], float]:
    seconds, tests = defaultdict(float), defaultdict(int)
    for case in ET.parse(xml_path).getroot().iter("testcase"):
        path = "tests/" + case.get("classname", "").split(".")[1] + ".py"
        seconds[path] += float(case.get("time", 0.0))
        tests[path] += 1
    worker, last = {}, {}
    with open(log_path, errors="replace") as f:
        for i, line in enumerate(f):
            m = RESULT.match(line)
            if m:
                worker[m.group(2)] = m.group(1)
                last[m.group(2)] = i
    rows = [dict(file=p, tests=tests[p], seconds=seconds[p], worker=worker.get(p, "?"),
                 last=last.get(p, -1)) for p in seconds]
    rows.sort(key=lambda r: -r["last"])
    return rows, sum(seconds.values())


def main(argv: list[str]) -> int:
    if len(argv) < 2:
        print(__doc__.strip().splitlines()[2], file=sys.stderr)
        return 2
    top = int(argv[argv.index("--top") + 1]) if "--top" in argv else None
    rows, total = file_times(argv[0], argv[1])
    print("| file (last finisher first) | tests | worker s | worker |")
    print("| --- | --- | --- | --- |")
    for r in rows[:top]:
        print(f"| `{r['file']}` | {r['tests']} | {r['seconds']:.1f} | {r['worker']} |")
    per_worker = defaultdict(float)
    for r in rows:
        per_worker[r["worker"]] += r["seconds"]
    print(f"\ntotal worker time {total:.1f} s over {len(rows)} files; by worker: "
          + ", ".join(f"{w} {s:.1f}" for w, s in sorted(per_worker.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
