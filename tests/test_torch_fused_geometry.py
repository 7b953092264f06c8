"""The host-side geometry of the CUDA tracking kernel (csrc/track_fused.cu),
on the CPU.

The kernel splits each channel's epoch over S blocks, picks S from the
card's occupancy, adds each sample signed by its chip into float64 sums,
and wraps its chip indices with one conditional add or subtract.  Each of
those rests on a property of the configuration or of the data that the
plain Python here states and checks at small sizes: the slices cover
every sample once, the choice gives every channel as many blocks as the
card holds at once, the chip tables hold only +-1, the raw chip indices
stay inside (-L*m, 2*L*m), and summing S slices in float64 rounds to the
plain version's float32 rows.
"""
import numpy as np
import pytest
import torch

from bds3_tpu_torch.config import TrackMode, b1c_settings, b2a_settings
from bds3_tpu_torch.io import SatParams, synthesize_if
from bds3_tpu_torch.track import driver, scan
from bds3_tpu_torch.track.fused import (
    DSTEP_REL,
    THREADS,
    RUN_SAMPLES,
    banks,
    chip_index_bound,
    choose_blocks,
    rank_runs,
    rank_slice,
    runs_fit,
    wraps_once,
)
from bds3_tpu_torch.track.state import SPLIT, ChannelInit, make_track_config

torch.set_num_threads(2)

SATS = [SatParams(prn=19, doppler_hz=777.0, code_phase_chips=123.0,
                  amplitude=0.9),
        SatParams(prn=20, doppler_hz=-1200.0, code_phase_chips=5000.0,
                  amplitude=0.7)]


def _inits(s, sats=SATS):
    out = []
    for sat in sats:
        rate = s.code_freq_basis * (1 + sat.doppler_hz / s.carr_freq_basis)
        start = ((s.code_length - sat.code_phase_chips % s.code_length)
                 % s.code_length) / rate
        out.append(ChannelInit(
            prn=sat.prn, acquired_freq=s.intermediate_freq + sat.doppler_hz,
            code_phase=int(round(start * s.sampling_freq)), peak_metric=2.0))
    return out


def _block(s, epochs=20):
    """One plain block from the synthesized start: (capture, setup,
    rows)."""
    sig = synthesize_if(s, SATS, n_ms=(epochs + 5) * s.int_time * 1e3,
                        noise_std=1.0, seed=6)
    cap = driver.as_capture(sig, "cpu")
    setup = driver.setup_tracking(cap, s, _inits(s), epochs, epochs)
    _, rows = scan.track_block_reference(setup.cfg, cap, setup.tables,
                                          setup.consts, setup.state)
    return cap, setup, rows


# --- the ranks' slices and their count ---------------------------------------

@pytest.mark.parametrize("blocks", (16, 13, 11, 8, 4, 2, 1))
def test_rank_slices_cover_each_sample_once(blocks):
    """For every epoch length n in 1..n_max (B2a at 10 Msps), the S ranks'
    slices are contiguous, in rank order, and cover [0, n) exactly once."""
    n_max = make_track_config(b2a_settings(sampling_freq=10e6,
                                           intermediate_freq=2.5e6)).n_max
    for n in range(1, n_max + 1):
        edge = 0
        for rank in range(blocks):
            lo, hi = rank_slice(n, blocks, rank)
            assert lo == edge and lo <= hi, (n, rank, lo, hi)
            edge = hi
        assert edge == n, (n, blocks)


@pytest.mark.parametrize("resident,channels,want", [
    (132, 10, 13),    # the B1C preset on an H100: 130 of 132 SMs
    (132, 12, 11),    # B2a's 12 channels, in every capture dtype
    (132, 5, 26),     # the 5-channel B1C receiver
    (132, 1, 132), (132, 7, 18), (132, 8, 16), (132, 15, 8), (132, 16, 8),
    (132, 40, 3), (132, 66, 2),
    # more than half as many channels as blocks: one block a channel,
    # launched without the cooperative attribute
    (132, 67, 1), (132, 132, 1), (132, 200, 1), (132, 500, 1),
    (114, 10, 11),    # a card with fewer SMs (an H100 PCIe's 114)
    (0, 3, 1),        # a card that holds none at once
], ids=["b1c_preset_10ch", "b2a_12ch", "b1c_5ch", "1ch", "7ch", "8ch",
        "15ch", "16ch", "40ch", "66ch", "67ch", "132ch", "200ch", "500ch",
        "fewer_sms", "none_resident"])
def test_choose_blocks(resident, channels, want):
    """Every channel takes floor(resident / C) blocks, at least one."""
    assert choose_blocks(resident, channels) == want
    assert want == 1 or channels * want <= resident


# --- the chip tables hold only +-1 -------------------------------------------

@pytest.mark.parametrize("make", [
    lambda: b2a_settings(),
    lambda: b1c_settings(track_mode=TrackMode.NARROWBAND),
    lambda: b1c_settings(),      # the preset: wideband, BOC(6,1) at m = 12
], ids=["b2a", "b1c_nb", "b1c_wb_preset"])
def test_every_chip_table_holds_only_plus_minus_one(make):
    """The kernel adds +-x for cv * x: every entry of every table the
    driver builds, the circular padding included, is +1 or -1, for every
    PRN 1-63."""
    s = make()
    cfg = make_track_config(s)
    inits = [ChannelInit(prn=p, acquired_freq=s.intermediate_freq,
                         code_phase=0, peak_metric=2.0) for p in range(1, 64)]
    data, p11, p61 = driver.channel_code_tables(cfg, inits)
    tables = [data, p11] + ([p61] if cfg.wideband else [])
    if cfg.wideband:
        assert p61.shape == (63, cfg.code_length * 12 + 2 * scan.CODE_PAD)
    for t in tables:
        assert t.dtype == np.int8
        assert np.isin(t, (-1, 1)).all()


# --- the raw chip index stays inside (-L*m, 2*L*m) ---------------------------

@pytest.mark.parametrize("make", [
    lambda: b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6),
    lambda: b1c_settings(sampling_freq=30e6, intermediate_freq=7.5e6),
], ids=["b2a_10msps", "b1c_wb_30msps"])
def test_raw_chip_index_of_a_plain_block_stays_in_range(make):
    """Over a 20-epoch plain block, every raw index ck_int + ceil(frac) - 1
    the kernel forms (scan.py's formula, from each epoch's starting state)
    lies in (-L*m, 2*L*m), inside chip_index_bound, and inside the range
    that the kernel's per-epoch check wraps_once certifies, which holds in
    every epoch."""
    cap, setup, rows = _block(make())
    cfg = setup.cfg
    out = scan.unpack_rows(cfg, rows)
    rem, d_step = out["rem_code_phase"], out["d_step"]      # (W, C)
    blk = out["blksize"].to(torch.int64)
    tables = {"": (setup.tables.ck_int, setup.tables.ck_frac),
              "61": (setup.tables.ck61_int, setup.tables.ck61_frac)}
    bounds = chip_index_bound(cfg)
    for (m, spacing, sm, sfx), (b_lo, b_hi, lm) in zip(banks(cfg),
                                                       bounds):
        assert -lm < b_lo and b_hi < 2 * lm
        ck_int, ck_frac = tables[sfx]
        for w in range(rem.shape[0]):
            for c in range(rem.shape[1]):
                n = min(int(blk[w, c]), cfg.n_max)
                j = torch.arange(n)
                k_idx, r_f = j // SPLIT, (j % SPLIT).to(torch.float32)
                dsm = d_step[w, c] * m
                base = [(rem[w, c] + off) * m
                        for off in (-spacing, 0.0, spacing)]
                assert wraps_once(base[0], base[2], dsm, n, sm, lm)
                for b in base:
                    frac = ((b + ck_frac[k_idx]) + r_f * sm) \
                        + j.to(torch.float32) * dsm
                    raw = ck_int[k_idx].to(torch.int64) \
                        + torch.ceil(frac).to(torch.int64) - 1
                    assert b_lo <= int(raw.min()) and int(raw.max()) <= b_hi
                    assert -lm < int(raw.min()) and int(raw.max()) < 2 * lm


@pytest.mark.parametrize("make", [
    lambda: b2a_settings(),                                   # 99.375 Msps
    lambda: b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6),
    lambda: b2a_settings(sampling_freq=20e6, intermediate_freq=5e6),
    lambda: b1c_settings(),                                   # the preset
    lambda: b1c_settings(track_mode=TrackMode.NARROWBAND),
    lambda: b1c_settings(sampling_freq=99.375e6 / 3,
                         intermediate_freq=99.375e6 / 12),
    lambda: b1c_settings(sampling_freq=6e6, intermediate_freq=1.5e6,
                         track_mode=TrackMode.NARROWBAND),
], ids=["b2a_99msps", "b2a_10msps", "b2a_20msps", "b1c_wb_preset",
        "b1c_nb_99msps", "b1c_wb_33msps", "b1c_nb_6msps"])
def test_derived_bound_keeps_the_raw_index_in_range(make):
    """At the loop state's normal range (|rem_code| <= 1 chip, |d_step| <=
    DSTEP_REL of the nominal step) and a full n_max epoch, the derived
    bound lies inside (-L*m, 2*L*m), and the kernel's check wraps_once
    holds at its corners, so the fast wrap is the path these configs
    take."""
    cfg = make_track_config(make())
    for (m, spacing, sm, _), (lo, hi, lm) in zip(banks(cfg),
                                                 chip_index_bound(cfg)):
        assert -lm < lo and hi < 2 * lm
        for rem in (-1.0, 1.0):
            for sgn in (-1.0, 1.0):
                dsm = sgn * DSTEP_REL * cfg.step_base * m
                assert wraps_once((rem - spacing) * m, (rem + spacing) * m,
                                  dsm, cfg.n_max, sm, lm)
    # far outside it the kernel takes the modulo instead
    m, spacing, sm, _ = banks(cfg)[0]
    lm = cfg.code_length * m
    assert not wraps_once(-cfg.code_length * m, (spacing - 1.0) * m, 0.0,
                          cfg.n_max, sm, lm)


@pytest.mark.parametrize("make", [
    lambda: b2a_settings(),                                   # 99.375 Msps
    lambda: b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6),
    lambda: b1c_settings(),                                   # the preset
    lambda: b1c_settings(track_mode=TrackMode.NARROWBAND),
    lambda: b1c_settings(sampling_freq=30e6, intermediate_freq=7.5e6),
    lambda: b1c_settings(sampling_freq=6e6, intermediate_freq=1.5e6,
                         track_mode=TrackMode.NARROWBAND),
], ids=["b2a_99msps", "b2a_10msps", "b1c_wb_preset", "b1c_nb_99msps",
        "b1c_wb_30msps", "b1c_nb_6msps"])
@pytest.mark.parametrize("dtype", list(RUN_SAMPLES))
def test_runs_fit_at_the_normal_range(make, dtype):
    """At the loop state's normal range (|rem_code| <= 1 chip, |d_step| <=
    DSTEP_REL of the nominal step) every bank's runs fit the shared-memory
    padding (runs_fit), so each run takes one wrap and these configs never
    fall back to the modulo; a run that moves by more does not fit."""
    cfg = make_track_config(make())
    run = RUN_SAMPLES[dtype]
    for m, spacing, sm, _ in banks(cfg):
        for rem in (-1.0, 1.0):
            for sgn in (-1.0, 1.0):
                dsm = sgn * DSTEP_REL * cfg.step_base * m
                assert runs_fit((rem - spacing) * m, (rem + spacing) * m,
                                dsm, sm, run)
        assert not runs_fit(-spacing * m, spacing * m, 64.0 / (run - 1),
                            sm, run)


# --- the ranks' float64 sums round to the plain version's rows --------------

def _blocks_sum(blocks, blk_log, run=None):
    """scan._sum_rounded as the kernel sums: each channel's first n =
    min(blksize, n_max) products cut into `blocks` contiguous slices
    (rank_slice), each slice summed in float64, the slices added in rank
    order from 0.0, the total rounded to float32 once.  With `run` None a
    slice is summed by numpy; else as the kernel's threads sum it
    (_slice_by_threads)."""
    def sum_rounded(x):
        n_ch = blk_log[-1].clamp(max=x.shape[1]).tolist()
        xs = x.numpy().astype(np.float64)
        out = np.empty(x.shape[0], np.float32)
        for c, n in enumerate(n_ch):
            total = 0.0
            for rank in range(blocks):
                lo, hi = rank_slice(n, blocks, rank)
                total += float(xs[c, lo:hi].sum()) if run is None \
                    else _slice_by_threads(xs[c], lo, hi, run)
            out[c] = np.float32(total)
        return torch.from_numpy(out)
    return sum_rounded


def _slice_by_threads(x, lo, hi, run):
    """One block's float64 sum of x[lo:hi] in the kernel's order
    (track_fused.cu sum_slice): thread t adds the samples of the slice's
    whole runs t, t + THREADS, ... (rank_runs) in order, then its ragged
    sample (head then tail, the i-th to thread THREADS-1-i); each warp's
    32 sums are added by shuffles down 16, 8, 4, 2, 1, and the warps'
    sums in warp order from 0.0."""
    ra, rb = rank_runs(lo, hi, run)
    head = min(ra * run, hi)
    tail = max(rb * run, head)
    rounds = -(-(rb - ra) // THREADS)
    runs = np.full(rounds * THREADS, -1, np.int64)
    runs[:rb - ra] = np.arange(ra, rb)
    j = runs.reshape(rounds, THREADS)[:, None, :] * run \
        + np.arange(run)[None, :, None]                 # (round, i, thread)
    j = j.reshape(rounds * run, THREADS)
    terms = np.where(j >= 0, x[np.maximum(j, 0)], 0.0)
    acc = np.zeros(THREADS)
    for row in terms:
        acc += row
    ragged = np.r_[lo:head, tail:hi]
    acc[THREADS - 1 - np.arange(len(ragged))] += x[ragged]
    warps = acc.reshape(THREADS // 32, 32).copy()
    for o in (16, 8, 4, 2, 1):
        warps[:, :32 - o] += warps[:, o:]
    total = 0.0
    for v in warps[:, 0]:
        total += v
    return total


@pytest.fixture(scope="module")
def b1c_wb_block():
    """The plain 20-epoch B1C wideband block at 30 Msps and its inputs."""
    s = b1c_settings(sampling_freq=30e6, intermediate_freq=7.5e6)
    return _block(s)


@pytest.mark.parametrize("run,blocks", [
    pytest.param(None, 2, id="2"), pytest.param(None, 8, id="8"),
    pytest.param(None, 16, id="16")] + [
    pytest.param(RUN_SAMPLES[dt], blocks,
                 id=f"runs{RUN_SAMPLES[dt]}-{blocks}")
    for dt in RUN_SAMPLES for blocks in (2, 8, 16)] + [
    # the blocks a channel the presets take on an H100: B1C's 10 channels
    # 13, B2a's 12 channels 11
    pytest.param(None, 13, id="13"), pytest.param(16, 13, id="runs16-13"),
    pytest.param(16, 11, id="runs16-11")])
def test_blocks_float64_sums_round_to_the_plain_rows(b1c_wb_block, run,
                                                      blocks, monkeypatch):
    """A numpy emulation of the kernel's sums (S slices, each in float64,
    combined in rank order, rounded once) in place of the plain version's
    float64 row sum, over the closed-loop 20-epoch B1C wideband block at
    30 Msps: every row value within one float32 ulp of the plain
    version's (both round a float64 sum of the same float32 terms once;
    only a sum that lies within ~1e-12 of a rounding boundary can differ).
    Each slice summed whole, and as the kernel's threads sum it in runs of
    16, 4 and 2 samples (the int8, float32 and complex64 instances)."""
    cap, setup, rows = b1c_wb_block
    blk_log = []
    plain_blksize = scan._blksize

    def logged_blksize(*a):
        delta, blk = plain_blksize(*a)
        blk_log.append(blk)
        return delta, blk

    monkeypatch.setattr(scan, "_blksize", logged_blksize)
    monkeypatch.setattr(scan, "_sum_rounded",
                        _blocks_sum(blocks, blk_log, run))
    _, got = scan.track_block_reference(setup.cfg, cap, setup.tables,
                                        setup.consts, setup.state)
    assert len(blk_log) == setup.cfg.epochs_per_block
    a = rows.numpy().view(np.int32).astype(np.int64)
    b = got.numpy().view(np.int32).astype(np.int64)
    same_sign = np.sign(rows.numpy()) == np.sign(got.numpy())
    ulps = np.where(same_sign, np.abs(a - b), np.where(a == b, 0, 2))
    assert int(ulps.max()) <= 1, int(ulps.max())
