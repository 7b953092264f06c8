"""The port's channel- and Doppler-sharded paths (bds3_tpu_torch.parallel
.sharded) over 8 gloo ranks on the CPU, against the JAX package's sharded
functions on its 8-device CPU mesh (tests/conftest.py) and against the
port's own one-rank run.

The ranks start once for the module (`parallel.worker`, every case in one
launch, rendezvous through a FileStore); the inputs are
tests/test_parallel.py's, synthesized here with numpy's seeds and handed
to both packages, with a satellite planted under each tracking channel
(that test's capture holds PRN 5 alone, at another Doppler, so its
channels track noise, where one boundary sample rounded the other way
already moves a correlator by 2e-2 of the scale).  On the CPU the port's
tracking kernel runs as its plain version, the direct sum, so tracking
is held to JAX's "gather" path at tests/test_torch_track.py's rule
(scaled atol 2e-2, carrier within 0.05 Hz, blksize exact).  Acquisition
winners must be equal; peaks within rtol 1e-4, because XLA's FFT and
PyTorch's round differently (up to 4.3e-5 apart here).  Against the
port's one-rank run every result is expected to be equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bds3_tpu.acquire.pcps import acq_code_tables, make_acq_config
from bds3_tpu.config import b2a_settings
from bds3_tpu.io import SatParams, synthesize_if
from bds3_tpu.parallel.mesh import make_mesh as jax_mesh
from bds3_tpu.parallel.sharded import (
    doppler_sharded_coarse_search as jax_doppler,
    sharded_coarse_search as jax_prn,
    sharded_track_block as jax_track_block,
)
from bds3_tpu.track.driver import channel_code_tables
from bds3_tpu.track.state import (
    ChannelInit, channel_consts, code_coarse_tables, initial_state,
    make_track_config,
)
from bds3_tpu.utils.phase import phase_tables
from bds3_tpu_torch import convert
from bds3_tpu_torch.acquire import pcps as port_pcps
from bds3_tpu_torch.parallel import worker
from bds3_tpu_torch.parallel.mesh import (
    Mesh,
    channel_sharding,
    make_mesh,
    replicated,
)
from bds3_tpu_torch.parallel.sharded import (
    doppler_sharded_coarse_search,
    sharded_coarse_search,
    shard_map_track_block,
    sharded_track_block,
)
from bds3_tpu_torch.track import driver as port_driver
from bds3_tpu_torch.track.scan import output_names

N_DEV = 8
W = 5
PROMPTS = ("d_ip", "d_qp", "d_ie", "d_il", "p11_ip", "p11_qp")


def settings():
    return b2a_settings(sampling_freq=10e6, intermediate_freq=2.5e6,
                        acq_satellite_list=tuple(range(1, 17)))


def inits():
    return [ChannelInit(prn=1 + i, acquired_freq=2.5e6 + 10.0 * i,
                        code_phase=11 * i, peak_metric=2.0)
            for i in range(8)]


def bins(cfg, padded: bool) -> int:
    """tests/test_parallel.py:71-107's grids: whole bin chunks, and for
    the Doppler split that many rounded up to a multiple of the ranks."""
    n_bc = -(-cfg.n_bins // cfg.bin_chunk)
    if padded:
        return N_DEV * (-(-n_bc // N_DEV) * cfg.bin_chunk)
    return n_bc * cfg.bin_chunk


def planted(s):
    """A satellite under each of inits(): its PRN, its Doppler, its code
    starting at its code_phase."""
    sats = []
    for c in inits():
        fd = c.acquired_freq - s.intermediate_freq
        rate = s.code_freq_basis * (1 + fd / s.carr_freq_basis)
        chi0 = (s.code_length - c.code_phase * rate / s.sampling_freq) \
            % s.code_length
        sats.append(SatParams(prn=c.prn, doppler_hz=fd,
                              code_phase_chips=chi0, amplitude=1.0))
    return sats


@pytest.fixture(scope="module")
def case():
    """(settings, the acquisition capture, the tracking block)."""
    s = settings()
    sat = SatParams(prn=5, doppler_hz=900.0, code_phase_chips=1000.0,
                    amplitude=1.0)
    sig = synthesize_if(s, [sat], n_ms=40.0, noise_std=1.5, seed=9)
    cfg = make_track_config(s, epochs_per_block=W)
    n_block = 77 + W * (cfg.q0_int + 3) + cfg.n_max
    trk = synthesize_if(s, planted(s), n_ms=10.0, noise_std=1.5, seed=9)
    return s, sig, trk[:n_block]


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    """Every case of the module on 8 gloo ranks, in one launch."""
    s, sig, block = case
    ps = convert.settings_from_reference(s)
    acfg = make_acq_config(s)
    common = dict(settings="s", n_devices=N_DEV)
    cases = [
        dict(name="channel", mode="channel", signal="block", inits="inits",
             epochs=W, epochs_per_block=W, **common),
        dict(name="shard_map", mode="channel", signal="block",
             inits="inits", epochs=W, epochs_per_block=W, shard_map=True,
             **common),
        dict(name="prn", mode="acq_prn", signal="sig",
             bins=bins(acfg, False), **common),
        dict(name="doppler", mode="acq_doppler", signal="sig",
             bins=bins(acfg, True), **common),
    ]
    d = tmp_path_factory.mktemp("ranks")
    worker.write_job(d / "job.npz", cases, {"s": ps},
                     {"sig": sig, "block": block,
                      "inits": worker.inits_to_array(inits())})
    return worker.run_job(N_DEV, d / "job.npz", d / "out.npz",
                          store=str(d / "store"), device="cpu", timeout=600,
                          env_extra={"OMP_NUM_THREADS": "1"})


def _port_tables(s, block):
    """The port's tables, constants and state for the channel case, on
    the CPU, with block-relative cursors (the block starts at 0)."""
    ps = convert.settings_from_reference(s)
    capture = port_driver.as_capture(block, torch.device("cpu"))
    setup = port_driver.setup_tracking(capture, ps, inits(), W, W)
    return capture, setup


def test_channel_fanout_matches_jax(case, ranks):
    """8 ranks x 1 channel against JAX's sharded_track_block (the gather
    path) over its 8-device mesh."""
    s, _, block = case
    cfg = dataclasses.replace(make_track_config(s, epochs_per_block=W),
                              correlator="gather")
    ch = inits()
    consts = channel_consts(cfg, ch, s)
    data_t, p11_t, p61_t = channel_code_tables(cfg, ch)
    cki, ckf = code_coarse_tables(cfg, cfg.m_data)
    state = initial_state(cfg, ch, consts,
                          np.array([c.code_phase for c in ch]))
    _, ref = jax_track_block(
        jax_mesh(N_DEV, ("channel",)), cfg, jnp.asarray(block),
        jnp.asarray(data_t), jnp.asarray(p11_t), jnp.asarray(p61_t),
        jnp.asarray(cki), jnp.asarray(ckf), jnp.asarray(cki),
        jnp.asarray(ckf), consts, state)
    ref = {k: np.asarray(v).T for k, v in ref.items()}      # (C, W)
    np.testing.assert_array_equal(ranks["channel/blksize"], ref["blksize"])
    for k in PROMPTS:
        scale = np.abs(ref[k]).mean() + 1.0
        np.testing.assert_allclose(ranks[f"channel/{k}"] / scale,
                                   ref[k] / scale, atol=2e-2, err_msg=k)
    np.testing.assert_allclose(ranks["channel/d_cyc"] * s.sampling_freq,
                               ref["d_cyc"] * s.sampling_freq, atol=0.05)


@pytest.mark.parametrize("fn", [sharded_track_block, shard_map_track_block])
def test_channel_fanout_equals_one_rank(case, ranks, fn):
    """The gathered rows and states equal the same block on one rank, and
    shard_map_track_block equals sharded_track_block."""
    _, _, block = case
    capture, setup = _port_tables(case[0], block)
    st, rows = fn(make_mesh(1, device="cpu"), setup.cfg, capture,
                  setup.tables, setup.consts, setup.state)
    names = output_names(setup.cfg)
    label = "channel" if fn is sharded_track_block else "shard_map"
    for i, k in enumerate(names):
        np.testing.assert_array_equal(ranks[f"{label}/{k}"],
                                      rows[:, :, i].numpy().T, err_msg=k)
    np.testing.assert_array_equal(ranks[f"{label}/cursor"],
                                  st.cursor.numpy())
    np.testing.assert_array_equal(ranks[f"{label}/statef"],
                                  st.statef.numpy())


def test_shard_map_refuses_channels_that_do_not_divide(case):
    capture, setup = _port_tables(case[0], case[2])
    # rank 0 of a 3-rank channel axis: 8 channels do not divide over it
    mesh = Mesh(("channel",), {"channel": 3}, (0,), (None,), (None,),
                torch.device("cpu"))
    with pytest.raises(ValueError, match="divide the mesh axis"):
        shard_map_track_block(mesh, setup.cfg, capture, setup.tables,
                              setup.consts, setup.state)


def _jax_search(fn, s, sig, n_bins):
    cfg = make_acq_config(s)
    d8, p8 = acq_code_tables(s, np.asarray(s.acq_satellite_list))
    freqs = cfg.freq_base + cfg.freq_step * np.arange(n_bins)
    a_b, c1_b = phase_tables(freqs, cfg.fs)
    out = fn(jax_mesh(N_DEV, ("channel",)), jnp.asarray(sig),
             jnp.asarray(d8), jnp.asarray(p8), jnp.asarray(a_b),
             jnp.asarray(c1_b), cfg)
    return [np.asarray(x) for x in out]


def _port_search(fn, s, sig, n_bins):
    ps = convert.settings_from_reference(s)
    cfg = port_pcps.make_acq_config(ps)
    d8, p8 = (torch.from_numpy(x) for x in port_pcps.acq_code_tables(
        ps, np.asarray(ps.acq_satellite_list)))
    freqs = cfg.freq_base + cfg.freq_step * np.arange(n_bins)
    a_b, c1_b = (torch.from_numpy(x) for x in phase_tables(freqs, cfg.fs))
    sig = torch.from_numpy(np.asarray(sig[: cfg.n_fft], np.float32))
    out = fn(make_mesh(1, device="cpu"), sig, d8, p8, a_b, c1_b, cfg)
    return [x.numpy() for x in out]


SEARCHES = [("prn", jax_prn, sharded_coarse_search, False),
            ("doppler", jax_doppler, doppler_sharded_coarse_search, True)]


@pytest.mark.parametrize("label,jax_fn,port_fn,padded", SEARCHES,
                         ids=[c[0] for c in SEARCHES])
def test_sharded_search_matches_jax(case, ranks, label, jax_fn, port_fn,
                                    padded):
    """Every PRN's winning bin and phase equal JAX's, peaks within rtol
    1e-4; the planted PRN 5 wins at 900 Hz."""
    s, sig, _ = case
    v, b, p = _jax_search(jax_fn, s, sig, bins(make_acq_config(s), padded))
    np.testing.assert_array_equal(ranks[f"{label}/bin"], b)
    np.testing.assert_array_equal(ranks[f"{label}/phase"], p)
    np.testing.assert_allclose(ranks[f"{label}/peak"], v, rtol=1e-4)
    cfg = make_acq_config(s)
    f5 = cfg.freq_base + cfg.freq_step * ranks[f"{label}/bin"][4]
    assert abs(f5 - (s.intermediate_freq + 900.0)) <= s.acq_step / 2


@pytest.mark.parametrize("label,jax_fn,port_fn,padded", SEARCHES,
                         ids=[c[0] for c in SEARCHES])
def test_sharded_search_equals_one_rank(case, ranks, label, jax_fn, port_fn,
                                        padded):
    s, sig, _ = case
    v, b, p = _port_search(port_fn, s, sig,
                           bins(make_acq_config(s), padded))
    np.testing.assert_array_equal(ranks[f"{label}/bin"], b)
    np.testing.assert_array_equal(ranks[f"{label}/phase"], p)
    np.testing.assert_array_equal(ranks[f"{label}/peak"], v)


def test_no_kernel_launch_on_the_cpu(ranks):
    """On the CPU every rank ran the plain version: no launch counted."""
    for k in ("channel", "shard_map", "prn", "doppler"):
        assert ranks[f"{k}/k1_launches"].shape == (N_DEV,)
        assert not ranks[f"{k}/k1_launches"].any()


def test_placements_are_slices_or_the_whole():
    """P(axis) is this rank's slice of the leading axis, P() all of it;
    a leading axis that does not divide over the axis raises."""
    mesh = Mesh(("time", "channel"), {"time": 2, "channel": 4}, (1, 2),
                (None, None), (None, None), torch.device("cpu"))
    x = np.arange(16)
    np.testing.assert_array_equal(channel_sharding(mesh).local(x),
                                  [8, 9, 10, 11])
    np.testing.assert_array_equal(channel_sharding(mesh, "time").local(x),
                                  x[8:])
    np.testing.assert_array_equal(replicated(mesh).local(x), x)
    with pytest.raises(ValueError, match="does not divide"):
        channel_sharding(mesh).local(np.arange(6))
