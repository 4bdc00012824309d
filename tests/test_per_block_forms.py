"""The live per-block forms on per-object (heterogeneous) banks.

A stream dispatches one block at a time, either the blocked step
(``ModalSession.step`` with lam-power tables) or the single-block
chunked span the engine takes when the session has lam64
(``_step_span_sound(1)``). Both are held to the float64 oracle per
object, over the object counts, block sizes and multi-block state
carries a stream meets; and the backend choice is shown to depend on
the bank alone, never on the platform.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openpbso_tpu.ops.coeffs import build_modal_bank, lambda_from_modes
from openpbso_tpu.ops.integrator import resolve_backend_name
from openpbso_tpu.runtime.session import ModalSession
from openpbso_tpu.runtime.solver import SolverConfig
from openpbso_tpu.utils.oracle import (OracleGaussianForce, OraclePointForce,
                                       OracleSolver, iir_coefficients)
from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data

M = 24
WIDTH_US = 300.0


def _scene(o, s, tables=True):
    mds = [synth_mode_data(M, 8, seed=60 + i, f_low=90.0 + 11 * i,
                           f_high=9000.0 + 150 * i) for i in range(o)]
    lams, bs, valids = zip(*(lambda_from_modes(
        CERAMIC.density, md.omega_squared, CERAMIC.alpha, CERAMIC.beta)
        for md in mds))
    lam64 = np.stack(lams)
    bank = build_modal_bank(lam64, np.stack(bs), np.stack(valids),
                            block_size=s if tables else None, shared=False,
                            dtype=jnp.float32)
    sess = ModalSession(bank, lam64=lam64, dtype=jnp.float32,
                        config=SolverConfig(block_size=s,
                                            backend="blocked"))
    oracles = []
    for md in mds:
        c = iir_coefficients(CERAMIC.density, md.omega_squared,
                             CERAMIC.alpha, CERAMIC.beta, 1.0 / 44100)
        oracles.append(OracleSolver(*c, s))
    return sess, oracles


def _render(sess, form, n_blocks):
    """[O, n_blocks * S] per-object sound, one dispatch per block."""
    out = []
    for _ in range(n_blocks):
        if form == "blocked":
            out.append(np.asarray(sess.step()[0]))
        else:
            out.append(np.asarray(sess._step_span_sound(1)))
    return np.concatenate(out, axis=-1)


def _strike(sess, oracles, rng, obj):
    space = rng.standard_normal(M)
    sess.hit(obj, space, kind="gaussian", width_us=WIDTH_US)
    oracles[obj].hit(space, OracleGaussianForce(WIDTH_US))


FORMS = ["blocked", "span"]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("o", [1, 3, 8, 9])
def test_hetero_per_block_matches_oracle(o, form, dberr):
    s, n = 128, 4
    sess, oracles = _scene(o, s)
    rng = np.random.default_rng(o)
    for obj in range(o):
        _strike(sess, oracles, rng, obj)
    got = _render(sess, form, n)
    ref = np.stack([orc.render(n) for orc in oracles])
    assert got.shape == ref.shape
    assert dberr(got, ref) < -80


@pytest.mark.parametrize("form", FORMS)
def test_hetero_per_block_state_carries_across_blocks(form, dberr):
    """A hit lands mid-stream while earlier hits still ring: the carried
    state of every object must keep tracking the oracle."""
    s, o = 128, 3
    sess, oracles = _scene(o, s)
    rng = np.random.default_rng(7)
    _strike(sess, oracles, rng, 0)
    _strike(sess, oracles, rng, 2)
    first = _render(sess, form, 3)
    ref_first = np.stack([orc.render(3) for orc in oracles])
    space = rng.standard_normal(M)
    sess.hit(1, space, kind="point")
    oracles[1].hit(space, OraclePointForce())
    got = np.concatenate([first, _render(sess, form, 5)], axis=-1)
    ref = np.concatenate(
        [ref_first, np.stack([orc.render(5) for orc in oracles])], axis=-1)
    assert dberr(got, ref) < -80


@pytest.mark.parametrize("form", FORMS)
def test_hetero_per_block_small_block(form, dberr):
    """Blocks shorter than the live span's 64-sample chunk."""
    s, o = 32, 2
    sess, oracles = _scene(o, s)
    rng = np.random.default_rng(3)
    for obj in range(o):
        _strike(sess, oracles, rng, obj)
    got = _render(sess, form, 6)
    ref = np.stack([orc.render(6) for orc in oracles])
    assert dberr(got, ref) < -80


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
@pytest.mark.parametrize("tables", [True, False])
def test_auto_backend_follows_the_bank_not_the_platform(platform, tables,
                                                        monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    sess, _ = _scene(2, 64, tables=tables)
    want = "blocked" if tables else "scan"
    assert resolve_backend_name("auto", sess.bank) == want
    assert resolve_backend_name("blocked", sess.bank) == "blocked"
