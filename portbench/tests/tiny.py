"""Cells cut to a size the CPU tests can hold: the same files, with the
sample rate, recording, channel count and block length made small."""
from __future__ import annotations

import dataclasses
import json

from portbench import spec

TINY = {
    "b2a.track.resident": dict(sampling_freq=30e6, intermediate_freq=5e6,
                               ms_to_process=60, num_channels=2),
    "b1c.track.resident": dict(sampling_freq=30e6, intermediate_freq=7e6,
                               ms_to_process=500, num_channels=2),
}


def tiny_cell(name: str, epochs_per_block: int = 20, **settings) -> spec.Cell:
    c = spec.cell(name)
    cfg = json.loads(json.dumps(c.config))
    cfg["settings"].update(TINY[name], **settings)
    traffic = dict(c.traffic, epochs_per_block=epochs_per_block)
    return dataclasses.replace(c, config=cfg, traffic=traffic)
