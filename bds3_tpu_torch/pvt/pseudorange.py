"""TOW-anchored transmit times and raw pseudoranges at a common receive
epoch.

Role of `Common/calculatePseudoranges.m:63-110`: for each channel, find
the tracking epoch whose end-sample is the last not beyond the
measurement sample, propagate the code phase forward at the tracked code
frequency, and anchor the code-period count to the decoded frame start.

Deviation (defect fix): the reference pairs epoch e's *start* phase
(remCodePhase(index)) with epoch e's *end* sample
(absoluteSample(index)), which mis-anchors by one epoch; the resulting
bias jumps by one whole sample (c/fs meters of pseudorange!) whenever the
epoch-length sawtooth wraps.  The phase that actually corresponds to
absoluteSample[e] is the NEXT epoch's start phase rem[e+1], which we use
— removing 50-160 m fix glitches observed on synthesized truth whenever
samples-per-code is non-integer.
"""
from __future__ import annotations

import numpy as np

from bds3_tpu_torch.config import C_LIGHT, Settings


def transmit_times(
    track, channels: list[int], sub_frame_start: dict, tow: dict,
    curr_meas_sample: int, settings: Settings,
) -> dict:
    """Per-channel transmit time [s] at curr_meas_sample."""
    out = {}
    for ch in channels:
        abs_s = track.absolute_sample[ch]
        e = int(np.searchsorted(abs_s, curr_meas_sample, side="right")) - 1
        e = max(e, 0)
        e1 = min(e + 1, abs_s.shape[0] - 1)
        step = track.code_freq[ch, e1] / settings.sampling_freq
        # rem_code_phase[e+1] is the code phase AT sample abs_s[e]
        code_phase = track.outputs["rem_code_phase"][ch, e1] \
            + step * (curr_meas_sample - abs_s[e])
        out[ch] = (
            code_phase / settings.code_length + (e + 1) - sub_frame_start[ch]
        ) * settings.code_length / settings.code_freq_basis + tow[ch]
    return out


def pseudoranges(tt: dict, local_time: float) -> dict:
    return {ch: (local_time - t) * C_LIGHT for ch, t in tt.items()}
