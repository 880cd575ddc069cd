"""Native (C++) batched spectrum loader with transparent build + fallback.

``load_spectra(paths)`` parses CSV/Gamry files through the C++ loader
(built on first use with g++) and buckets them by frequency grid so each
bucket feeds fit_spectra_batch directly — the ragged-grid batching strategy
from SURVEY.md. Falls back to numpy parsing (CSV) or the io/ parsers
(Gamry .DTA, which need pandas) if no C++ toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import warnings

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "loader.cpp")
_LIB = os.path.join(_DIR, "_loader.so")
_MAX_ROWS = 100_000

_lib = None
_build_failed = False


def _ensure_built():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    if (not os.path.exists(_LIB)
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
        try:
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC,
                 "-o", _LIB],
                check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as exc:
            warnings.warn(f"native loader build failed ({exc}); falling back "
                          "to the Python parsers")
            _build_failed = True
            return None
    lib = ctypes.CDLL(_LIB)
    for fn in (lib.load_eis_csv, lib.load_eis_gamry):
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p,
                       ctypes.POINTER(ctypes.c_double),
                       ctypes.POINTER(ctypes.c_double),
                       ctypes.POINTER(ctypes.c_double),
                       ctypes.c_int64]
    _lib = lib
    return _lib


def available() -> bool:
    return _ensure_built() is not None


def _load_one_native(lib, path):
    freq = np.empty(_MAX_ROWS)
    zre = np.empty(_MAX_ROWS)
    zim = np.empty(_MAX_ROWS)
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    fn = lib.load_eis_gamry if _looks_gamry(path) else lib.load_eis_csv
    n = fn(path.encode(), ptr(freq), ptr(zre), ptr(zim), _MAX_ROWS)
    if n < 0:
        raise ValueError(f"native loader failed on {path} (code {n})")
    return freq[:n].copy(), zre[:n] + 1j * zim[:n]


def _looks_gamry(path) -> bool:
    with open(path, "rb") as f:
        return f.read(8).startswith(b"EXPLAIN")


def _load_one_fallback(path):
    if _looks_gamry(path):
        from ..io.file_load import get_fZ, read_eis
        return get_fZ(read_eis(path, warn=False))
    data = np.genfromtxt(path, delimiter=",", names=True, ndmin=1)
    return (np.asarray(data["Freq"], float),
            data["Zreal"] + 1j * data["Zimag"])


def load_eis_file(path):
    """(frequencies, complex Z) from a CSV or Gamry .DTA file."""
    lib = _ensure_built()
    if lib is None:
        return _load_one_fallback(path)
    return _load_one_native(lib, path)


def load_spectra(paths, rel_tol: float = 1e-8, skip_errors: bool = False,
                 failed=None):
    """Load many spectra and bucket them by (rounded) frequency grid.

    Returns a list of buckets: dicts with keys ``freq`` (N,), ``Z`` (B, N)
    and ``paths`` — each bucket ready for fit_spectra_batch.

    ``skip_errors``: skip files that fail to parse instead of raising (a
    directory sweep should not die on one corrupt export); each skipped
    (path, error-string) pair is appended to the ``failed`` list if given.
    """
    buckets = {}
    for path in paths:
        try:
            freq, Z = load_eis_file(path)
            if len(freq) == 0:
                raise ValueError("no data rows parsed")
        except Exception as e:              # noqa: BLE001 — report per file
            if not skip_errors:
                raise
            if failed is not None:
                failed.append((path, f"{type(e).__name__}: {e}"))
            continue
        key = (len(freq), tuple(np.round(np.log10(np.abs(freq) + 1e-300), 8)))
        b = buckets.setdefault(key, {"freq": freq, "Z": [], "paths": []})
        b["Z"].append(Z)
        b["paths"].append(path)
    out = []
    for b in buckets.values():
        out.append({"freq": b["freq"], "Z": np.stack(b["Z"]),
                    "paths": b["paths"]})
    out.sort(key=lambda d: -d["Z"].shape[0])
    return out
