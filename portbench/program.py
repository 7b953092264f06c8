"""The program under test, as the harness builds it from a configuration
file: the port's preset with the file's settings, every one of which is
held to what the program then reports."""
from __future__ import annotations

# settings whose values are the program's enums: by value or by name
_BY_VALUE = {"signal": "Signal"}
_BY_NAME = {"track_mode": "TrackMode", "file_type": "FileType"}
PRESETS = ("b2a_settings", "b1c_settings")


def _plain(value):
    """A setting as the configuration file writes it."""
    if hasattr(value, "name") and hasattr(value, "value"):
        return value.value if isinstance(value.value, str) else value.name
    if isinstance(value, tuple):
        return list(value)
    return value


def settings(config: dict):
    """The program's Settings for a configuration: config["preset"] with
    config["settings"] as overrides; ValueError if a value the program
    holds differs from the file's."""
    from bds3_tpu_torch import config as pc

    if config["preset"] not in PRESETS:
        raise ValueError(f"unknown preset {config['preset']!r}: expected "
                         f"one of {PRESETS}")
    kw = {}
    for key, value in config["settings"].items():
        if key in _BY_VALUE:
            continue                       # the preset fixes the signal
        if key in _BY_NAME:
            value = getattr(pc, _BY_NAME[key])[value]
        elif isinstance(value, list):
            value = tuple(value)
        kw[key] = value
    s = getattr(pc, config["preset"])(**kw)
    for key, value in config["settings"].items():
        if _plain(getattr(s, key)) != value:
            raise ValueError(f"setting {key}: the program holds "
                             f"{getattr(s, key)!r}, the file {value!r}")
    return s
