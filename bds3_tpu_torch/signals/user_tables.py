"""User-supplied ICD parameter injection (B2a pilot-secondary (w, p) table).

The B2a pilot secondary codes are length-1021 truncated Weil sequences whose
per-PRN (phase w, truncation point p) parameters are published only in the
ICD-B2a-1.0 PDF.  The reference receiver never uses the pilot secondary (its
tracker ignores it), so it carries no source for the table, and this build
environment has no network egress — `icd_tables.B2A_PILOT_SECONDARY_WP` is a
deterministic placeholder (w = p = PRN).

This module lets a user drop in the real ICD values without touching code:

- call :func:`set_b2a_pilot_secondary_wp` with 63 ``(w, p)`` pairs, or
- set the environment variable ``BDS3_B2A_PILOT_SEC_WP`` to a file path.
  Accepted formats: JSON (``[[w, p], ...]`` — 63 pairs in PRN order) or
  plain text (one ``prn w p`` triple per line, ``#`` comments allowed).

When the placeholder is active, the first construction of a pilot secondary
code emits a :class:`PlaceholderTableWarning` so synthesized-loop results are
never silently mistaken for on-air capability.
"""
from __future__ import annotations

import json
import os
import warnings

_ENV_VAR = "BDS3_B2A_PILOT_SEC_WP"
_N_PRN = 63


class PlaceholderTableWarning(UserWarning):
    """A placeholder ICD parameter table (not broadcast values) is in use."""


_user_wp: tuple | None = None
_warned = False


def _parse_table_file(path: str) -> tuple:
    with open(path, "r", encoding="utf-8") as fh:
        text = fh.read()
    stripped = text.lstrip()
    if stripped.startswith("["):
        pairs = [(int(w), int(p)) for w, p in json.loads(text)]
    else:
        rows = {}
        for line in text.splitlines():
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            prn, w, p = (int(tok) for tok in line.split())
            rows[prn] = (w, p)
        pairs = [rows[prn] for prn in sorted(rows)]
        if sorted(rows) != list(range(1, len(rows) + 1)):
            raise ValueError(
                f"{path}: PRN column must cover 1..{len(rows)} contiguously"
            )
    if len(pairs) != _N_PRN:
        raise ValueError(
            f"{path}: expected {_N_PRN} (w, p) pairs, got {len(pairs)}"
        )
    return tuple(pairs)


def set_b2a_pilot_secondary_wp(table) -> None:
    """Install a user-supplied B2a pilot-secondary (w, p) table.

    ``table``: 63 ``(w, p)`` pairs in PRN order, or ``None`` to revert to
    the environment/placeholder resolution.  Clears the dependent code
    caches so subsequent generator calls see the new table.
    """
    global _user_wp
    if table is not None:
        table = tuple((int(w), int(p)) for w, p in table)
        if len(table) != _N_PRN:
            raise ValueError(f"expected {_N_PRN} pairs, got {len(table)}")
    _user_wp = table
    from bds3_tpu_torch.signals import b2a

    b2a.b2a_pilot_secondary.cache_clear()


def b2a_pilot_secondary_wp() -> tuple:
    """Resolve the active (w, p) table: user-set > env file > placeholder.

    Warns (once per process) with :class:`PlaceholderTableWarning` when the
    placeholder is returned.
    """
    global _warned
    if _user_wp is not None:
        return _user_wp
    path = os.environ.get(_ENV_VAR, "")
    if path:
        return _parse_table_file(path)
    from bds3_tpu_torch.signals import icd_tables as icd

    if not _warned:
        _warned = True
        warnings.warn(
            "B2a pilot-secondary (w, p) table is a PLACEHOLDER (w = p = PRN),"
            " not the ICD-B2a-1.0 broadcast values; pilot-secondary sync is"
            " only meaningful on signal synthesized by this framework."
            f"  Provide the real table via {_ENV_VAR}=<file> or"
            " signals.user_tables.set_b2a_pilot_secondary_wp().",
            PlaceholderTableWarning,
            stacklevel=3,
        )
    return icd.B2A_PILOT_SECONDARY_WP


def b2a_pilot_secondary_is_placeholder() -> bool:
    """True when the active table is the synthetic placeholder."""
    return _user_wp is None and not os.environ.get(_ENV_VAR, "")
