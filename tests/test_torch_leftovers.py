"""The last numpy pieces of the reference's plan layer, copied into the
port and held bit-identical: ``ShiftedExponential``'s eq. (8) closed
form of 1/E[1/T_(n)], ``spsg(model="realized")`` and
``ClusterConfig.record_events``."""
import numpy as np
import pytest

from repro.core import ShiftedExponential as JShiftedExp
from repro.core import spsg as jspsg
from repro.sim import ClusterConfig as JClusterConfig
from repro.sim import ClusterSim as JClusterSim
from repro.sim import schedule_from_x as jschedule
from repro_torch.core import ShiftedExponential, spsg
from repro_torch.sim import ClusterConfig, ClusterSim, schedule_from_x


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("mu,t0", [(1e-3, 50.0), (0.5, 2.0)])
def test_eq8_bit_identical(n, mu, t0):
    got = ShiftedExponential(mu=mu, t0=t0).inv_expected_inv_order_stats(n, method="eq8")
    want = JShiftedExp(mu=mu, t0=t0).inv_expected_inv_order_stats(n, method="eq8")
    np.testing.assert_array_equal(got, want)
    quad = ShiftedExponential(mu=mu, t0=t0).inv_expected_inv_order_stats(n)
    np.testing.assert_allclose(got, quad, rtol=1e-6)  # the oracle agrees at small N


def test_eq8_refuses_t0_zero():
    with pytest.raises(ValueError, match="t0 > 0"):
        ShiftedExponential(mu=1e-3, t0=0.0).inv_expected_inv_order_stats(3, method="eq8")


@pytest.mark.parametrize("model", ["paper", "realized"])
def test_spsg_models_bit_identical(model):
    kw = dict(n_iters=200, batch=16, rng=3, eval_every=50, eval_samples=500, model=model)
    got = spsg(ShiftedExponential(mu=1e-3, t0=50.0), 4, 12.0, **kw)
    want = jspsg(JShiftedExp(mu=1e-3, t0=50.0), 4, 12.0, **kw)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.x_last, want.x_last)
    assert got.history == want.history


def test_spsg_realized_differs_from_paper():
    kw = dict(n_iters=200, batch=16, rng=3)
    paper = spsg(ShiftedExponential(mu=1e-3, t0=50.0), 4, 12.0, model="paper", **kw)
    real = spsg(ShiftedExponential(mu=1e-3, t0=50.0), 4, 12.0, model="realized", **kw)
    assert not np.array_equal(paper.x, real.x)


@pytest.mark.parametrize("wave", [True, False])
def test_record_events_bit_identical(wave):
    x = np.array([4.0, 3.0, 2.0, 3.0])
    kw = dict(wave=wave, comm_delay=1.0, seed=7)
    got = ClusterSim(schedule_from_x(x), ShiftedExponential(mu=1e-3, t0=50.0), 4,
                     record_events=True, **kw).run(5)
    want = JClusterSim(jschedule(x), JShiftedExp(mu=1e-3, t0=50.0), 4,
                       record_events=True, **kw).run(5)
    assert got.events and got.events == want.events
    assert {e[1] for e in got.events} >= {"start", "finish", "deliver", "decode"}
    off = ClusterSim(schedule_from_x(x), ShiftedExponential(mu=1e-3, t0=50.0), 4,
                     **kw).run(5)
    assert off.events is None
    np.testing.assert_array_equal(off.decode_times, got.decode_times)
