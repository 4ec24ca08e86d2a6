#!/usr/bin/env python
"""Run phases of ``chip_smoke.py`` from two checkouts, interleaved, on
one card: the other tree, this one, this one, the other (each leg in a
process of its own, ``phase_device`` first), so that a change is
compared with its parent within one call and the host's drift cancels.

  python3 scripts/chip_ab.py OTHER_ROOT dist [more phases]

``OTHER_ROOT`` is a checkout holding its own ``chip_smoke.py`` (say,
``git archive <parent> | tar -x -C build/parent``, under a directory
that ``.gitignore`` lists).  Each leg prints ``=== <tree> <root>``, the
phases' own lines and its wall time; the script exits with the first
failing leg's code.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv) -> int:
    other, phases = Path(argv[0]).resolve(), argv[1:]
    calls = "; ".join(f"C.phase_{p}()" for p in ["device", *phases])
    code = ("import time, chip_smoke as C; t = time.perf_counter(); "
            f"{calls}; print('leg wall', round(time.perf_counter() - t, "
            "1), 's', flush=True)")
    for name, root in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)):
        print(f"=== {name} {root}", flush=True)
        rc = subprocess.run([sys.executable, "-c", code], cwd=root).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
