"""Shared-results aggregation: flock-protected CSV fan-in.

Equivalent of the reference's ``MCMC/scripts/append_results.py``:
reads a run's ``sampled_data.csv``, averages post-equilibration pressure /
density / aspect ratio (``append_results.py:6-70``), and appends one row to
a shared ``results.csv`` under an exclusive lock (``:73-77``).

The locked append itself is a native C++ routine
(``flowstate/native/aggregate.cpp``, compiled on first use into the
git-ignored ``flowstate/native/build/`` and bound via ctypes) so many sweep
processes/hosts can fan in with a single atomic ``write`` after
``flock(LOCK_EX)``; a pure-Python ``fcntl`` fallback covers environments
without a compiler.
"""

from __future__ import annotations

import csv
import ctypes
import os
import subprocess
from typing import Optional

_NATIVE_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "aggregate.cpp")
_NATIVE_LIB: Optional[ctypes.CDLL] = None
_NATIVE_TRIED = False

RESULTS_HEADER = "temperature,density,pressure,aspect_ratio"


def _load_native() -> Optional[ctypes.CDLL]:
    """Compile + load the C++ aggregator (cached); None if unavailable."""
    global _NATIVE_LIB, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE_LIB
    _NATIVE_TRIED = True
    build_dir = os.path.join(os.path.dirname(_NATIVE_SRC), "build")
    lib_path = os.path.join(build_dir, "_aggregate.so")
    try:
        os.makedirs(build_dir, exist_ok=True)
        if (not os.path.exists(lib_path)
                or os.path.getmtime(lib_path) < os.path.getmtime(_NATIVE_SRC)):
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", lib_path,
                 _NATIVE_SRC],
                check=True, capture_output=True)
        lib = ctypes.CDLL(lib_path)
        lib.append_row_locked.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                          ctypes.c_char_p]
        lib.append_row_locked.restype = ctypes.c_int
        _NATIVE_LIB = lib
    except Exception:
        _NATIVE_LIB = None
    return _NATIVE_LIB


def append_row_locked(path: str, row: str,
                      header: str = RESULTS_HEADER) -> None:
    """Append one CSV row under an exclusive lock (header on first write)."""
    lib = _load_native()
    if lib is not None:
        rc = lib.append_row_locked(path.encode(), header.encode(),
                                   row.encode())
        if rc != 0:
            raise OSError(-rc, os.strerror(-rc), path)
        return
    # fallback: python fcntl (reference append_results.py:73-77 behavior)
    import fcntl
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            if f.tell() == 0 and header:
                f.write(header + "\n")
            f.write(row + "\n")
            f.flush()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def append_results(results_csv: str, output_path: str, temperature: float,
                   equilibration_steps: int) -> dict:
    """Summarize one run and append to the shared results CSV.

    Reference ``append_results.py:6-106``: average post-equilibration
    pressure, density, and aspect ratio from ``sampled_data.csv``.
    """
    sampled = os.path.join(output_path, "sampled_data.csv")
    rows = []
    with open(sampled) as f:
        reader = csv.reader(f)
        next(reader)  # header
        rows = list(reader)
    # Reference CSVs count cycles across equilibration+production; our
    # single_run CSVs contain production-only rows whose cycle numbers
    # restart at sampling_frequency — if no row exceeds the threshold,
    # every row is already post-equilibration and all are kept.
    if rows and max(int(r[0]) for r in rows) > equilibration_steps:
        rows = [r for r in rows if int(r[0]) > equilibration_steps]
    pressures, densities, aspect_ratios = [], [], []
    for rowvals in rows:
        densities.append(float(rowvals[2]))
        pressures.append(float(rowvals[3]))
        aspect_ratios.append(float(rowvals[4]) / float(rowvals[5]))
    import numpy as np
    summary = {
        "temperature": temperature,
        "density": float(np.mean(densities)) if densities else float("nan"),
        "pressure": float(np.mean(pressures)) if pressures else float("nan"),
        "aspect_ratio": (float(np.mean(aspect_ratios))
                         if aspect_ratios else float("nan")),
    }
    row = (f"{summary['temperature']},{summary['density']},"
           f"{summary['pressure']},{summary['aspect_ratio']}")
    append_row_locked(results_csv, row)
    return summary
