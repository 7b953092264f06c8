"""Typed receiver configuration.

TPU-native redesign of the reference's flat MATLAB settings structs
(`BDS-3_B1C/initSettings.m`, `BDS-3_B2a/initSettings.m`): one frozen
dataclass shared by both signals, with per-signal presets.  Frozen +
hashable so a Settings instance can be a static argument to `jax.jit`.
"""
from __future__ import annotations

import dataclasses
import enum
import math

C_LIGHT = 299_792_458.0  # speed of light [m/s]


class FileType(enum.IntEnum):
    """IF sample file layout (reference initSettings.m fileType)."""

    REAL8 = 1  # 8-bit real samples S0,S1,...
    IQ8 = 2    # 8-bit interleaved I0,Q0,I1,Q1,...


class Signal(enum.Enum):
    B1C = "b1c"
    B2A = "b2a"


class TrackMode(enum.IntEnum):
    """Pilot tracking mode (reference B1C initSettings.m:76-78 pilotTRKflag)."""

    DATA_ONLY = 0
    NARROWBAND = 1   # data BOC(1,1) + pilot BOC(1,1)
    WIDEBAND = 2     # data BOC(1,1) + pilot QMBOC(6,1,4/33)


@dataclasses.dataclass(frozen=True)
class Settings:
    """Receiver settings for one signal.

    Field-for-field behavioral parity with the reference settings structs;
    fields that only made sense for MATLAB GUIs (plot flags, waitbars) live
    in observe/, not here.
    """

    signal: Signal

    # --- IF data file ----------------------------------------------------
    file_name: str = ""
    file_type: FileType = FileType.REAL8
    sampling_freq: float = 99.375e6           # fs [Hz]
    intermediate_freq: float = 14.58e6        # IF [Hz]
    skip_samples: int = 0                     # whole IF samples to skip

    # --- signal parameters ----------------------------------------------
    code_length: int = 10230                  # primary code chips
    code_freq_basis: float = 1.023e6          # chipping rate [Hz]
    carr_freq_basis: float = 1575.42e6        # RF carrier [Hz]
    front_end_bw: float = 27e6                # FEBW for WB DLL weighting [Hz]

    # --- run shape -------------------------------------------------------
    ms_to_process: int = 37_000
    num_channels: int = 10
    acq_satellite_list: tuple[int, ...] = tuple(range(1, 64))

    # --- acquisition -----------------------------------------------------
    acq_search_band: float = 5000.0           # single-sided [Hz]
    acq_coh_ms: int = 10                      # coherent integration [ms]
    acq_step: float = 50.0                    # Doppler bin step [Hz]
    acq_threshold: float = 7.5
    acq_noncoh_rounds: int = 1                # non-coherent sums (B2a fine=15)
    acq_fine_step: float = 25.0               # fine frequency grid [Hz]
    pilot_acq: bool = True                    # use pilot channel in acquisition
    resampling: bool = False                  # bandpass-decimate before acq
    resampling_threshold: float = 15e6        # apply only above this fs [Hz]

    # --- tracking --------------------------------------------------------
    track_mode: TrackMode = TrackMode.WIDEBAND
    dll_damping: float = 0.7
    dll_bw: float = 1.0                       # noise bandwidth [Hz]
    dll_spacing: float = 0.06                 # E-L half spacing [chips]
    pll_damping: float = 0.7
    pll_bw: float = 12.0                      # [Hz]
    int_time: float = 0.01                    # pre-detection integration [s]
    cn0_interval: int = 50                    # epochs per C/N0 estimate
    # B1C wideband code-DLL blend:
    #   "composite" - the reference's QMBOC composite-pilot E-L blend
    #     (WB_tracking.m:414-419).  Measured on synthesized truth: the
    #     composite envelope's equilibrium is Doppler-dependent by up
    #     to ~1 sample (the BOC(6,1) oscillatory ACF under the
    #     0.06-chip spacing), biasing pseudoranges by meters.
    #   "nb" - data + BOC(1,1)-pilot 11/29 code blend (the NB DLL) with
    #     the composite pilot kept for the CARRIER loop; recovers <2 m
    #     fixes while preserving the wideband carrier advantage.
    #   "split" - per-component envelope discriminators, each slope-
    #     normalized, blended 0.3 BOC(1,1) + 0.7 BOC(6,1): the BOC(6,1)
    #     bank runs at its own narrow spacing (dll_spacing_boc61, inside
    #     its +-1/23-chip main peak — at the shared 0.06 spacing its E/L
    #     taps sit past the ACF sign reversal and the blend has a false
    #     equilibrium) and, being ~12x steeper than BOC(1,1), cuts code
    #     noise ~3x while BOC(1,1) keeps the pull-in range.  No
    #     composite cross term, so no Doppler-dependent bias.
    #   "dotprod" - coherent normalized dot-product discriminator on
    #     the composite correlators (linear in E-L, no envelope
    #     rectification).
    wb_code_blend: str = "composite"
    # E-L half-spacing [chips] for the BOC(6,1) correlator bank in
    # wb_code_blend="split" (must sit inside the +-1/23-chip main peak
    # and be <= dll_spacing); other modes keep the shared dll_spacing
    # for reference parity (WB_tracking.m uses one spacing everywhere).
    dll_spacing_boc61: float = 0.02

    # --- navigation ------------------------------------------------------
    # Soft 64-ary LDPC(96,48) decode of B-CNAV2 frames whose hard
    # systematic read fails CRC (navmsg/ldpc.py — extension; the
    # reference always skips LDPC, BCNAV2decoding.m:129-132).  Off by
    # default for parity.
    ldpc_decode: bool = False
    nav_sol_period_ms: int = 200
    elevation_mask_deg: float = 5.0
    use_tropo_corr: bool = True
    start_offset_ms: float = 68.802           # initial travel-time guess
    # UTM E/N datum: "wgs84" (direct), or "ed50" for exact parity with
    # the reference's historic cart2utm.m path (see pvt/geodesy.py)
    utm_datum: str = "wgs84"

    # ---------------------------------------------------------------------
    @property
    def samples_per_code(self) -> int:
        """IF samples in one primary code period (reference samplesPerCode)."""
        return round(
            self.sampling_freq / (self.code_freq_basis / self.code_length)
        )

    @property
    def samples_per_ms(self) -> float:
        return self.sampling_freq * 1e-3

    @property
    def code_period_ms(self) -> float:
        return self.code_length / self.code_freq_basis * 1e3

    @property
    def num_doppler_bins(self) -> int:
        return 2 * int(round(self.acq_search_band / self.acq_step)) + 1

    @property
    def int_epochs(self) -> int:
        """Tracking epochs for ms_to_process."""
        return int(self.ms_to_process / (self.int_time * 1e3))


def b1c_settings(**overrides) -> Settings:
    """B1C preset (reference BDS-3_B1C/initSettings.m defaults, with the
    documented 99.375 MHz / 14.58 MHz dataset front end)."""
    base = dict(
        signal=Signal.B1C,
        file_name="B1C_fs_99.375_if14.58.bin",
        sampling_freq=99.375e6,
        intermediate_freq=14.58e6,
        code_freq_basis=1.023e6,
        carr_freq_basis=1575.42e6,
        ms_to_process=37_000,
        num_channels=10,
        acq_coh_ms=10,
        acq_step=50.0,           # 1000/acqCohT/2
        acq_threshold=7.5,       # GLRT metric
        track_mode=TrackMode.WIDEBAND,
        dll_bw=1.0,
        dll_spacing=0.06,
        pll_bw=12.0,
        int_time=0.01,
        nav_sol_period_ms=200,
        cn0_interval=50,
        # Device-side bandpass-decimate acquisition by default: ~6x faster
        # at the full dataset rate with identical detections (measured,
        # docs/PERF.md).  The reference ships resampling off
        # (initSettings.m:102 `resamplingflag = 0`) — pass
        # resampling=False for the full-grid parity configuration.
        resampling=True,
        resampling_threshold=15e6,
    )
    base.update(overrides)
    return Settings(**base)


def b2a_settings(**overrides) -> Settings:
    """B2a preset (reference BDS-3_B2a/initSettings.m defaults)."""
    base = dict(
        signal=Signal.B2A,
        file_name="BDS_B2a_IF_signal.bin",
        sampling_freq=99.375e6,
        intermediate_freq=13.55e6,
        code_freq_basis=10.23e6,
        carr_freq_basis=1176.45e6,
        ms_to_process=49_000,
        num_channels=12,
        acq_coh_ms=1,            # 1 ms code period
        acq_step=400.0,
        acq_threshold=1.5,       # peak/second-peak metric
        acq_noncoh_rounds=15,    # fine-search non-coherent rounds
        track_mode=TrackMode.NARROWBAND,  # data+pilot, no BOC
        dll_bw=2.0,
        dll_spacing=0.5,
        pll_bw=20.0,
        int_time=0.001,
        nav_sol_period_ms=500,
        cn0_interval=200,
    )
    base.update(overrides)
    return Settings(**base)
