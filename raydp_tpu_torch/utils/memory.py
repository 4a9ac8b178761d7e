"""Human-readable memory size parsing/formatting + host RSS sampling
(the port's copy of ``raydp_tpu/utils/memory.py``).

Capability parity with the reference's memory-string handling
(reference: python/raydp/utils.py:125-146 ``parse_memory_size``): accepts
"500M", "500MB", "1.5 GB", "2g", plain integers ("1024"), case-insensitive,
optional space between number and unit.

The RSS helpers feed the resource-accounting gauges of the query
profiling plane (``raydp_host_rss_bytes``): :func:`host_rss_bytes`
reads the current and peak resident set from ``/proc/self/status``
(``VmRSS`` / ``VmHWM``), falling back to ``resource.getrusage`` where
procfs is unavailable; :func:`reset_peak_rss` arms a fresh peak window
via ``/proc/self/clear_refs`` so per-section watermarks (bench configs)
don't inherit an earlier section's high-water mark.
"""
from __future__ import annotations

import re

_UNIT_BYTES = {
    "": 1,
    "K": 2**10,
    "M": 2**20,
    "G": 2**30,
    "T": 2**40,
    "P": 2**50,
}

_MEM_RE = re.compile(r"^\s*([0-9]*\.?[0-9]+)\s*([KMGTP]?)I?B?\s*$", re.IGNORECASE)


def parse_memory_size(size: "str | int | float") -> int:
    """Parse a human-readable memory size into bytes.

    >>> parse_memory_size("500MB")
    524288000
    >>> parse_memory_size("1.5 G")
    1610612736
    >>> parse_memory_size(1024)
    1024
    """
    if isinstance(size, (int, float)):
        return int(size)
    m = _MEM_RE.match(size)
    if not m:
        raise ValueError(f"cannot parse memory size: {size!r}")
    number, unit = m.group(1), m.group(2).upper()
    return int(float(number) * _UNIT_BYTES[unit])


def format_memory_size(num_bytes: int) -> str:
    """Format bytes as a short human-readable string ("1.5GB")."""
    if num_bytes < 0:
        raise ValueError("negative size")
    for unit in ("P", "T", "G", "M", "K"):
        scale = _UNIT_BYTES[unit]
        if num_bytes >= scale:
            value = num_bytes / scale
            text = f"{value:.1f}".rstrip("0").rstrip(".")
            return f"{text}{unit}B"
    return f"{num_bytes}B"


def host_rss_bytes() -> "tuple[int, int]":
    """Return ``(rss_bytes, peak_rss_bytes)`` for this process.

    Prefers ``/proc/self/status`` (``VmRSS``/``VmHWM``) so the peak is
    resettable via :func:`reset_peak_rss`; falls back to
    ``resource.getrusage`` (``ru_maxrss`` is the lifetime peak and
    stands in for both values) where procfs is missing."""
    try:
        rss = peak = 0
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = int(line.split()[1]) * 1024
                elif line.startswith("VmHWM:"):
                    peak = int(line.split()[1]) * 1024
        if rss or peak:
            return rss, max(rss, peak)
    except OSError:
        pass
    try:
        import resource

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        return peak, peak
    except Exception:
        return 0, 0


def reset_peak_rss() -> bool:
    """Reset the kernel's peak-RSS watermark (``VmHWM``) for this
    process so the next :func:`host_rss_bytes` peak covers a fresh
    window. Returns False where unsupported (non-Linux, no write
    permission) — callers then get the lifetime peak instead."""
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
        return True
    except OSError:
        return False
