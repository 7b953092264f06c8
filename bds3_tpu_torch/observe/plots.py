"""Diagnostic plots — parity with the reference L0 layer
(`include/plotAcquisition.m`, `plotTracking.m`, `plotNavigation.m`,
`skyPlot.m`, `probeData.m`).

All functions return the matplotlib Figure (callers save or show); the
library never blocks on a GUI.
"""
from __future__ import annotations

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def plot_acquisition(acq, threshold: float):
    """Bar chart of acquisition metrics (plotAcquisition.m:36-60)."""
    fig, ax = plt.subplots(figsize=(10, 4))
    colors = ["tab:green" if d else "tab:blue" for d in acq.detected]
    ax.bar(acq.prns, acq.peak_metric, color=colors)
    ax.axhline(threshold, color="r", ls="--", label="threshold")
    ax.set_xlabel("PRN")
    ax.set_ylabel("acquisition metric")
    ax.set_title("Acquisition results")
    ax.legend()
    fig.tight_layout()
    return fig


def plot_tracking(track, channel: int):
    """Per-channel tracking dashboard (plotTracking.m:40-167): IQ
    constellation, nav bits, discriminators, correlator envelopes,
    and the per-interval C/N0 + PLL-lock archives (the reference's
    CNo panel, plotTracking.m:40-167)."""
    o = track.outputs
    ip, qp = o["d_ip"][channel], o["d_qp"][channel]
    t = np.arange(len(ip)) * track.int_time
    fig, axs = plt.subplots(4, 2, figsize=(12, 12))
    fig.suptitle(f"Channel {channel} (PRN {track.prns[channel]})")

    axs[0, 0].plot(ip, qp, ".", ms=1)
    axs[0, 0].set_title("Discrete-time constellation")
    axs[0, 0].set_xlabel("I_P")
    axs[0, 0].set_ylabel("Q_P")

    axs[0, 1].plot(t, ip, lw=0.5)
    axs[0, 1].set_title("Nav bits (I_P)")

    axs[1, 0].plot(t, o["code_err"][channel], lw=0.5)
    axs[1, 0].set_title("Raw DLL discriminator")
    axs[1, 1].plot(t, o["carr_err"][channel], lw=0.5)
    axs[1, 1].set_title("Raw PLL discriminator")

    env = {k: np.sqrt(o[f"d_i{k}"][channel] ** 2 + o[f"d_q{k}"][channel] ** 2)
           for k in ("e", "p", "l")}
    for k, style in (("e", "-"), ("p", "-"), ("l", "-")):
        axs[2, 0].plot(t, env[k], style, lw=0.6, label=f"$\\sqrt{{I_{k.upper()}^2+Q_{k.upper()}^2}}$")
    axs[2, 0].legend()
    axs[2, 0].set_title("Correlation envelopes")

    axs[2, 1].plot(t, track.carr_freq[channel] - track.acquired_freq[channel],
                   lw=0.6)
    axs[2, 1].set_title("Carrier freq - acquired [Hz]")

    # C/N0 + lock archives every cn0_interval epochs (Calc_CNo_PLD.m
    # cadence; the reference plots its CNo archive in this slot)
    from bds3_tpu_torch.observe.cn0 import cn0_pld_series

    series = cn0_pld_series(track, channel)
    interval = track.settings.cn0_interval
    tw = (np.arange(len(series["total_cn0"])) + 0.5) * interval \
        * track.int_time
    axs[3, 0].plot(tw, series["total_cn0"], ".-", label="total")
    axs[3, 0].plot(tw, series["data_cn0"], ".-", ms=2, lw=0.5,
                   label="data")
    if np.any(series["pilot_cn0"] != 0):
        axs[3, 0].plot(tw, series["pilot_cn0"], ".-", ms=2, lw=0.5,
                       label="pilot")
    axs[3, 0].set_title("C/N0 [dB-Hz]")
    axs[3, 0].set_xlabel("Time [s]")
    axs[3, 0].legend(fontsize=8)

    axs[3, 1].plot(tw, series["data_lock"], ".-", label="data NBD/NBP")
    if np.any(series["pilot_lock"] != 0):
        axs[3, 1].plot(tw, series["pilot_lock"], ".-", label="pilot")
    axs[3, 1].set_ylim(-1.1, 1.1)
    axs[3, 1].set_title("PLL lock detector")
    axs[3, 1].set_xlabel("Time [s]")
    axs[3, 1].legend(fontsize=8)
    for ax in axs.flat:
        ax.grid(alpha=0.3)
    fig.tight_layout()
    return fig


def plot_navigation(nav, true_enu=None):
    """ENU scatter + height + PDOP (plotNavigation.m:40-139)."""
    ok = np.isfinite(nav.x)
    e = nav.east[ok] - np.nanmean(nav.east[ok])
    n = nav.north[ok] - np.nanmean(nav.north[ok])
    u = nav.up[ok] - np.nanmean(nav.up[ok])
    fig, axs = plt.subplots(1, 3, figsize=(14, 4))
    axs[0].plot(e, n, "o", ms=3)
    axs[0].set_xlabel("E variation [m]")
    axs[0].set_ylabel("N variation [m]")
    axs[0].set_title("EN scatter vs mean")
    axs[0].axis("equal")
    axs[1].plot(u, ".-")
    axs[1].set_title("U variation [m]")
    axs[2].plot(nav.dop[1, ok], ".-", label="PDOP")
    axs[2].plot(nav.dop[2, ok], ".-", label="HDOP")
    axs[2].legend()
    axs[2].set_title("DOP")
    for ax in axs:
        ax.grid(alpha=0.3)
    fig.tight_layout()
    return fig


def sky_plot(nav, prns=None):
    """Azimuth/elevation polar plot (skyPlot.m:46-177)."""
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="polar")
    ax.set_theta_zero_location("N")
    ax.set_theta_direction(-1)
    C = nav.az.shape[0]
    for ch in range(C):
        az = np.radians(nav.az[ch])
        r = 90 - nav.el[ch]
        m = np.isfinite(az) & np.isfinite(r)
        if m.any():
            ax.plot(az[m], r[m], ".-", ms=3,
                    label=f"PRN {int(nav.prns[ch])}")
    ax.set_rlim(0, 90)
    ax.set_yticks([0, 30, 60, 90])
    ax.set_yticklabels(["90", "60", "30", "0"])
    mean_pdop = np.nanmean(nav.dop[1][np.isfinite(nav.x)])
    ax.set_title(f"Sky plot (mean PDOP {mean_pdop:.2f})")
    ax.legend(loc="lower right", fontsize=7)
    return fig


def plot_probe(stats: dict, fs: float):
    """Raw IF data sanity plots — all of probeData.m:86-170's panels:
    time-domain snippet, Welch PSD (pwelch 32768/2048 equivalent), and
    amplitude histogram with the moments."""
    fig, axs = plt.subplots(2, 2, figsize=(11, 7))

    snip = stats.get("time_snippet")
    ax = axs[0][0]
    if snip is not None and len(snip):
        t_ms = np.arange(len(snip)) / fs * 1e3
        if stats.get("complex"):
            ax.plot(t_ms, np.real(snip), lw=0.7, label="I")
            ax.plot(t_ms, np.imag(snip), lw=0.7, label="Q")
            ax.legend(loc="upper right", fontsize=8)
        else:
            ax.plot(t_ms, snip, lw=0.7)
    ax.set_title("Time domain")
    ax.set_xlabel("Time [ms]")

    ax = axs[0][1]
    w = stats.get("welch")
    if w is not None:
        f_mhz = w["freq_cycles"] * fs / 1e6
        psd_db = 10 * np.log10(np.maximum(w["psd"], 1e-20))
        ax.plot(f_mhz, psd_db, lw=0.8)
    ax.axvline(stats["spectrum_peak_bin"] * fs / (1 << 18) / 1e6,
               color="r", ls="--", lw=0.8)
    ax.set_title("Welch PSD [dB]")
    ax.set_xlabel("Frequency [MHz]")

    ax = axs[1][0]
    centers = (stats["hist_edges"][:-1] + stats["hist_edges"][1:]) / 2
    ax.bar(centers, stats["hist"], width=1.0)
    ax.set_title(f"Histogram (mean {stats['mean']:.2f}, "
                 f"std {stats['std']:.2f})")
    ax.set_xlim(-40, 40)

    ax = axs[1][1]
    ax.axis("off")
    ax.text(0.05, 0.8,
            f"mean {stats['mean']:+.3f}\nstd  {stats['std']:.3f}\n"
            f"min  {stats['min']:.0f}\nmax  {stats['max']:.0f}",
            family="monospace", fontsize=11, va="top")
    fig.tight_layout()
    return fig


def channel_init_table(channels) -> str:
    """Text channel table from the post-acquisition assignment
    (showChannelStatus.m:37-56, printed by postProcessing.m:124)."""
    lines = ["Ch | PRN |  Acquired freq [Hz] | Metric",
             "---+-----+---------------------+-------"]
    for ch, c in enumerate(channels):
        lines.append(f"{ch:2d} | {c.prn:3d} | {c.acquired_freq:19.1f} | "
                     f"{c.peak_metric:6.2f}")
    return "\n".join(lines)


def channel_status_table(track, acq=None, health=None) -> str:
    """Text channel table (showChannelStatus.m:37-56), optionally with the
    C/N0 + PLL-lock health summary (observe.cn0.channel_health)."""
    lines = ["Ch | PRN |  Acquired freq [Hz] | C/N0 [dB-Hz] | PLL lock",
             "---+-----+---------------------+--------------+---------"]
    for ch in range(len(track.prns)):
        if health is not None and ch < len(health):
            h = health[ch]
            tail = (f"{h['cn0_db']:12.1f} | {h['pll_lock']:+.2f}"
                    + ("" if h["lock_ok"] else " LOW"))
        else:
            tail = f"{'-':>12} |    -"
        lines.append(f"{ch:2d} | {int(track.prns[ch]):3d} | "
                     f"{track.acquired_freq[ch]:19.1f} | {tail}")
    return "\n".join(lines)
