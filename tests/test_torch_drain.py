"""The tracking driver's per-block drain (`track.driver.BlockDrain`) on the
CPU: `track(download=True)` against the whole-array assembly of the same
rows that it replaced (`track(download=False).outputs.realize()`, then
numpy's cumulative sum over every epoch and the float64 frequencies over
the whole arrays), bit for bit, for B2a data+pilot and B1C wideband with
an epoch count a multiple of the block, one that cuts the last block,
and a single block, drained between launches or after the last; each
name a C-contiguous (C, E) float32 array, no answer sharing memory with
another request's; and a streamed run cut short by its deadline against
the full run."""
import functools

import numpy as np
import pytest
import torch

from bds3_tpu_torch.config import TrackMode, b1c_settings, b2a_settings
from bds3_tpu_torch.io import SatParams, synthesize_if
from bds3_tpu_torch.track import driver
from bds3_tpu_torch.track.scan import output_names
from bds3_tpu_torch.track.state import ChannelInit

torch.set_num_threads(2)

SATS = {
    "b2a": [SatParams(prn=19, doppler_hz=777.0, code_phase_chips=123.0,
                      amplitude=0.9),
            SatParams(prn=20, doppler_hz=-1200.0, code_phase_chips=5000.0,
                      amplitude=0.7)],
    "b1c_wb": [SatParams(prn=7, doppler_hz=430.0, code_phase_chips=212.0,
                         amplitude=0.9),
               SatParams(prn=30, doppler_hz=-2100.0, code_phase_chips=8000.0,
                         amplitude=0.8)],
}
# (epochs a block, capture length in ms) at the CPU tests' rates
SHAPES = {"b2a": (4, 60.0), "b1c_wb": (2, 120.0)}
# epochs asked for, in blocks of W: whole blocks, the last block cut, one
CASES = {"whole": lambda w: 5 * w, "cut": lambda w: 3 * w + 1,
         "single": lambda w: w}


def _settings(signal_):
    if signal_ == "b2a":
        return b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6)
    return b1c_settings(sampling_freq=30e6, intermediate_freq=7.5e6,
                        track_mode=TrackMode.WIDEBAND)


@functools.lru_cache(maxsize=None)
def _capture(signal_):
    s = _settings(signal_)
    sig = synthesize_if(s, SATS[signal_], n_ms=SHAPES[signal_][1],
                        noise_std=1.0, seed=6)
    inits = []
    for sat in SATS[signal_]:
        rate = s.code_freq_basis * (1 + sat.doppler_hz / s.carr_freq_basis)
        chi0 = sat.code_phase_chips % s.code_length
        start = ((s.code_length - chi0) % s.code_length) / rate
        inits.append(ChannelInit(
            prn=sat.prn, acquired_freq=s.intermediate_freq + sat.doppler_hz,
            code_phase=int(round(start * s.sampling_freq)), peak_metric=2.0))
    return s, sig, inits


def _track(signal_, n_epochs, source=torch.from_numpy, **kw):
    s, sig, inits = _capture(signal_)
    return driver.track(source(sig), s, inits, n_epochs=n_epochs,
                        epochs_per_block=SHAPES[signal_][0], device="cpu",
                        **kw)


def _whole_array_assembly(signal_, lazy):
    """The driver's assembly before the per-block drain: the realized
    rows, then the epoch ends and frequencies over whole (C, E) arrays."""
    s, _, inits = _capture(signal_)
    cfg = driver.require_ported(s)
    outputs = lazy.outputs.realize()
    blks = outputs["blksize"].astype(np.int64)
    cursors0 = np.array([c.code_phase for c in inits], dtype=np.int64)
    base = np.array([c.acquired_freq for c in inits], dtype=np.float64)
    return (outputs, cursors0[:, None] + np.cumsum(blks, axis=1),
            base[:, None] + outputs["d_cyc"].astype(np.float64) * cfg.fs,
            s.code_freq_basis + outputs["d_step"].astype(np.float64) * cfg.fs)


def _assert_bits_equal(got, want, view, name):
    assert got.shape == want.shape, name
    np.testing.assert_array_equal(got.view(view), want.view(view),
                                  err_msg=name)


@pytest.mark.parametrize("lookahead", [2, driver.LOOKAHEAD])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("signal_", sorted(SATS))
def test_drained_answer_equals_whole_array_assembly(signal_, case, lookahead,
                                                    monkeypatch):
    """At the driver's lookahead every block here is drained after the
    last launch; at 2, most are drained between launches."""
    monkeypatch.setattr(driver, "LOOKAHEAD", lookahead)
    w = SHAPES[signal_][0]
    n_epochs = CASES[case](w)
    res = _track(signal_, n_epochs)
    lazy = _track(signal_, n_epochs, download=False)
    outputs, absolute, carr, code = _whole_array_assembly(signal_, lazy)
    assert res.n_epochs == lazy.n_epochs == n_epochs
    assert sorted(res.outputs) == sorted(outputs) \
        == output_names(driver.require_ported(_capture(signal_)[0]))
    C = len(_capture(signal_)[2])
    for name, want in outputs.items():
        got = res.outputs[name]
        assert got.dtype == np.float32 and got.shape == (C, n_epochs), name
        assert got.flags["C_CONTIGUOUS"], name
        _assert_bits_equal(got, want, np.uint32, name)
    assert all(res.prompt(name) is res.outputs[name] for name in outputs)
    assert res.absolute_sample.dtype == np.int64
    np.testing.assert_array_equal(res.absolute_sample, absolute)
    _assert_bits_equal(res.carr_freq, carr, np.uint64, "carr_freq")
    _assert_bits_equal(res.code_freq, code, np.uint64, "code_freq")


def test_two_answers_share_no_memory():
    """Each request's answer is its own: no array of one request shares
    memory with another's, nor with a name of its own request."""
    a, b = _track("b2a", 9), _track("b2a", 9)
    fields = ("absolute_sample", "carr_freq", "code_freq")
    arrays_a = list(a.outputs.values()) + [getattr(a, f) for f in fields]
    arrays_b = list(b.outputs.values()) + [getattr(b, f) for f in fields]
    assert not any(np.shares_memory(x, y) for x in arrays_a for y in arrays_b)
    assert not any(np.shares_memory(x, y) for i, x in enumerate(arrays_a)
                   for y in arrays_a[i + 1:])
    for name in a.outputs:
        _assert_bits_equal(a.outputs[name], b.outputs[name], np.uint32, name)


def test_deadline_cut_answer_is_the_full_runs_first_block():
    """A streamed run that its deadline stops after one block: its answer
    is the first block's epochs of the full run, each array contiguous."""
    w = SHAPES["b2a"][0]
    full = _track("b2a", 5 * w)
    cut = _track("b2a", 5 * w, source=np.asarray, deadline_s=0.0)
    assert cut.n_epochs == w
    for name in full.outputs:
        assert cut.outputs[name].flags["C_CONTIGUOUS"], name
        _assert_bits_equal(cut.outputs[name], full.outputs[name][:, :w],
                           np.uint32, name)
    for f in ("absolute_sample", "carr_freq", "code_freq"):
        got = getattr(cut, f)
        assert got.flags["C_CONTIGUOUS"], f
        np.testing.assert_array_equal(got, getattr(full, f)[:, :w],
                                      err_msg=f)
