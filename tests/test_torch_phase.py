"""bds3_tpu_torch.utils.phase against bds3_tpu.utils.phase."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bds3_tpu.utils import phase as ref
from bds3_tpu_torch.utils import phase as port

torch.set_num_threads(2)

FREQS = 13.55e6 + np.linspace(-5000.0, 5000.0, 26)


@pytest.mark.parametrize("fs", [10e6, 30e6, 99.375e6])
def test_phase_tables_equal(fs):
    for a, b in zip(ref.phase_tables(FREQS, fs), port.phase_tables(FREQS, fs)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fs,n,sign", [
    (10e6, 3 * 4096 + 17, -1.0),
    (30e6, 65536, -1.0),
    (99.375e6, 262144, -1.0),
    (99.375e6, 5000, 1.0),
])
def test_carrier_table_matches(fs, n, sign):
    a, c1 = ref.phase_tables(FREQS, fs)
    want = np.asarray(ref.carrier_table(jnp.asarray(a), jnp.asarray(c1), n,
                                        sign=sign))
    got = port.carrier_table(torch.from_numpy(a), torch.from_numpy(c1), n,
                             sign=sign)
    assert got.dtype == torch.complex64 and got.shape == (len(FREQS), n)
    # same float32 phase, floor-mod'ed the same way; cos/sin of two
    # libraries differ by a few float32 ulps
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_carrier_table_negative_phase_wraps():
    # negative phase increments give negative cycle counts: floor-mod
    # keeps them in [0, 1) as jnp.mod does (a truncating mod would not)
    a, c1 = ref.phase_tables(FREQS, 10e6)
    a, c1 = -a, -c1
    want = np.asarray(ref.carrier_table(jnp.asarray(a), jnp.asarray(c1), 9000))
    got = port.carrier_table(torch.from_numpy(a), torch.from_numpy(c1), 9000)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
