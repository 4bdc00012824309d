"""Round-5 advisor burn-down (two findings of the round-4 review).

1. The sustained noise counter is chunking-invariant across the 2^30-sample
   clock rebase: _maybe_rebase subtracts whole REBASE_PERIOD multiples and
   _noise_for_blocks wraps its block index modulo the period, so a live
   engine (block dispatches) and a timeline bake (span dispatches) draw
   bit-identical noise even for >6.7 h sessions.
2. set_ar_params rejects unstable AR(2) tunings (characteristic root
   magnitude >= 1) before mutating state — reachable from the wire via the
   ``arparam`` command, and an unstable tuning would overflow the host
   impulse tables to inf/NaN and poison whole spans.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from openpbso_tpu.config import REBASE_PERIOD
from openpbso_tpu.ops.coeffs import bank_from_material
from openpbso_tpu.ops.forces import (_noise_for_blocks, ar_stability_radius,
                                     make_sustained_state)
from openpbso_tpu.runtime.session import ModalSession
from openpbso_tpu.runtime.solver import SolverConfig
from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data


def _session(block_size=128):
    md = synth_mode_data(12, 8)
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta,
                              block_size=block_size, dtype=jnp.float32)
    return ModalSession(bank, config=SolverConfig(
        block_size=block_size, backend="blocked", decay_fast_path=False))


def test_noise_counter_wraps_modulo_rebase_period():
    """A span straddling the 2^30-sample boundary draws the same noise as
    per-block dispatches whose clock has already been rebased (wrapped)."""
    s = 1024
    sus = make_sustained_state(3, 8, seed=7)
    start = REBASE_PERIOD - 2 * s
    # one span of 4 blocks crossing the boundary (un-rebased clock)
    span = _noise_for_blocks(sus.key, jnp.asarray(start, jnp.int32),
                             4, s, jnp.float32)
    # the live engine's view: each block dispatched with a wrapped clock
    for i in range(4):
        wrapped = (start + i * s) % REBASE_PERIOD
        blk = _noise_for_blocks(sus.key, jnp.asarray(wrapped, jnp.int32),
                                1, s, jnp.float32)
        np.testing.assert_array_equal(np.asarray(span[:, i]),
                                      np.asarray(blk[:, 0]))


def test_rebase_subtracts_whole_period_multiples():
    """_maybe_rebase quantizes its subtraction so the device clock at a
    dispatch start is always absolute_clock mod REBASE_PERIOD — the
    anchor the noise counter's wrap relies on. An un-quantized rebase
    (the round-4 advisor finding) re-zeroed at chunking-dependent
    positions."""
    sess = _session()
    extra = 7 * 128  # dispatch boundary past the period, NOT aligned to it
    sess._clock = REBASE_PERIOD + extra
    sess.state = dataclasses.replace(
        sess.state,
        block_start=jnp.asarray(REBASE_PERIOD + extra, jnp.int32))
    sess._maybe_rebase()
    assert sess._clock_base == REBASE_PERIOD          # whole multiple only
    assert int(np.asarray(sess.state.block_start)) == extra


def test_ar_stability_radius_values():
    # default tuning: stable
    assert ar_stability_radius((0.783, 0.116)) < 1.0
    # a1 + a2 >= 1 puts a root at/past +1
    assert ar_stability_radius((0.5, 0.6)) >= 1.0
    assert ar_stability_radius((1.2, 0.3)) >= 1.0
    # complex-root (oscillatory) cases: radius = sqrt(-a2)
    assert ar_stability_radius((0.1, -0.5)) < 1.0
    assert ar_stability_radius((0.1, -1.5)) >= 1.0


def test_set_ar_params_rejects_unstable_tuning():
    sess = _session()
    before_a = np.asarray(sess.state.sustained.a).copy()
    with pytest.raises(ValueError, match="unstable"):
        sess.set_ar_params(0, a=(0.5, 0.6))
    # validate-before-mutate: nothing changed, host mirror intact
    np.testing.assert_array_equal(np.asarray(sess.state.sustained.a),
                                  before_a)
    np.testing.assert_array_equal(sess._ar_host[0],
                                  np.asarray([0.783, 0.116]))
    # a stable retune still lands
    sess.set_ar_params(0, a=(0.9, 0.05))
    np.testing.assert_allclose(np.asarray(sess.state.sustained.a[0]),
                               [0.9, 0.05], rtol=1e-6)


def test_engine_rejects_unstable_tuning_at_enqueue():
    from openpbso_tpu.runtime.audio import RawCollectorSink
    from openpbso_tpu.runtime.engine import StreamingEngine
    engine = StreamingEngine(_session(), RawCollectorSink())
    with pytest.raises(ValueError, match="unstable"):
        engine.set_ar_params(0, a=(1.2, 0.3))


def test_ar_stability_radius_nonfinite_is_inf():
    """json.loads accepts NaN/Infinity, so a wire ``arparam`` can carry
    them; ``nan >= 1.0`` is False, so the radius itself must collapse
    non-finite tunings to inf for every ``< 1`` check to reject."""
    assert ar_stability_radius((float("nan"), 0.0)) == float("inf")
    assert ar_stability_radius((0.3, float("nan"))) == float("inf")
    assert ar_stability_radius((float("inf"), 0.1)) == float("inf")


def test_set_ar_params_rejects_nan_tuning():
    sess = _session()
    before_a = np.asarray(sess.state.sustained.a).copy()
    with pytest.raises(ValueError, match="unstable"):
        sess.set_ar_params(0, a=(float("nan"), 0.0))
    np.testing.assert_array_equal(np.asarray(sess.state.sustained.a),
                                  before_a)
    from openpbso_tpu.runtime.audio import RawCollectorSink
    from openpbso_tpu.runtime.engine import StreamingEngine
    engine = StreamingEngine(_session(), RawCollectorSink())
    with pytest.raises(ValueError, match="unstable"):
        engine.set_ar_params(0, a=(float("nan"), 0.0))
