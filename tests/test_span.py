"""Span integrator (ops/span.py): N blocks in one dispatch.

Correctness contract: step_span over N = n_blocks * S samples must match
running step_block (blocked backend) n_blocks times — same constant
transfer, no sustained channel — and track the float64 oracle at <= -60 dB.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openpbso_tpu.config import SAMPLE_RATE, UNIT_TRANSFER
from openpbso_tpu.ops.coeffs import (bank_from_material, build_modal_bank,
                                     lambda_from_modes)
from openpbso_tpu.ops.span import (SpanTables, build_span_tables, choose_radix,
                                   decay_span, integrate_span)
from openpbso_tpu.runtime.solver import (decay_span_step, step_block,
                                         step_multi, step_span)
from openpbso_tpu.runtime.state import make_solver_state
from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data

S = 64
H = 1.0 / SAMPLE_RATE


def _hetero_bank(o=3, m=10, s=S, dtype=jnp.float32):
    lams, bs, valids = [], [], []
    for i in range(o):
        md = synth_mode_data(m, 8, seed=50 + i, f_low=80.0 + 7 * i,
                             f_high=9000.0 + 100 * i)
        lam, b, valid = lambda_from_modes(
            CERAMIC.density, md.omega_squared, CERAMIC.alpha, CERAMIC.beta)
        lams.append(lam); bs.append(b); valids.append(valid)
    lam64 = np.stack(lams)
    bank = build_modal_bank(lam64, np.stack(bs), np.stack(valids),
                            block_size=s, shared=False, dtype=dtype)
    return bank, lam64


def _shared_bank(o=4, m=10, s=S, dtype=jnp.float32):
    md = synth_mode_data(m, 8, seed=11)
    lam64, _, _ = lambda_from_modes(CERAMIC.density, md.omega_squared,
                                    CERAMIC.alpha, CERAMIC.beta)
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta, num_objects=o,
                              block_size=s, dtype=dtype)
    return bank, lam64


def _seeded_state(bank, n_blocks, seed=0):
    """State with two hits planted: one at t=0, one inside the span."""
    o, m = bank.num_objects, bank.num_modes
    state = make_solver_state(o, m, num_slots=4)
    rng = np.random.default_rng(seed)
    slots = state.slots
    slots = dataclasses.replace(
        slots,
        # gaussian at span start on every object
        ftype=slots.ftype.at[:, 0].set(2).at[:, 1].set(1),
        width=slots.width.at[:, 0].set(9.0),
        # point impulse firing at the start of block n_blocks//2
        t0=slots.t0.at[:, 1].set(S * (n_blocks // 2)),
        space=slots.space.at[:, 0, :].set(
            jnp.asarray(rng.standard_normal((o, m)), jnp.float32))
        .at[:, 1, :].set(
            jnp.asarray(rng.standard_normal((o, m)), jnp.float32)),
    )
    transfer = jnp.asarray(rng.uniform(0.5, 2.0, (o, m)), jnp.float32)
    return dataclasses.replace(state, slots=slots, transfer=transfer)


def test_choose_radix():
    # span-scaled default: min(512, max(64, span // 8)) — small chunks for
    # single-block (live) spans where table traffic dominates, 512 for
    # long offline spans
    assert choose_radix(512) == 64
    assert choose_radix(512 * 8) == 512
    assert choose_radix(512 * 512) == 512
    assert choose_radix(256) == 64
    assert 512 * 3 % choose_radix(512 * 3) == 0
    assert choose_radix(7) == 7
    assert choose_radix(13 * 13, target=16) == 13


@pytest.mark.parametrize("kind,form", [
    ("hetero", "chunked"), ("hetero", "factored"),
    ("shared", "chunked"), ("shared", "factored"), ("shared", "full"),
])
def test_span_matches_blocked_sequence(kind, form, dberr):
    n_blocks = 8
    bank, lam64 = (_hetero_bank() if kind == "hetero" else _shared_bank())
    tables = build_span_tables(lam64, n_blocks * S,
                               num_modes=bank.num_modes, form=form)
    assert tables.shared == (kind == "shared")
    state = _seeded_state(bank, n_blocks)
    gains = jnp.ones((bank.num_objects, 2), jnp.float32)

    st_b = state
    mixes = []
    for _ in range(n_blocks):
        st_b, _, mix, _ = step_block(st_b, bank, gains, block_size=S,
                                     backend="blocked")
        mixes.append(np.asarray(mix))
    ref_mix = np.concatenate(mixes, axis=0)

    st_s, mix_s = step_span(state, bank, tables, gains,
                            n_blocks=n_blocks, block_size=S)
    assert mix_s.shape == (n_blocks * S, 2)
    assert dberr(np.asarray(mix_s), ref_mix) <= -100.0
    assert dberr(np.asarray(st_s.z_im), np.asarray(st_b.z_im)) <= -100.0
    assert int(st_s.block_start) == int(st_b.block_start)


def test_two_spans_continuity(dberr):
    """State carried across span boundaries keeps the stream seamless."""
    bank, lam64 = _hetero_bank()
    n_blocks = 4
    tables = build_span_tables(lam64, n_blocks * S, num_modes=bank.num_modes)
    state = _seeded_state(bank, 2 * n_blocks)
    gains = jnp.ones((bank.num_objects, 2), jnp.float32)
    st, mix1 = step_span(state, bank, tables, gains,
                         n_blocks=n_blocks, block_size=S)
    st, mix2 = step_span(st, bank, tables, gains,
                         n_blocks=n_blocks, block_size=S)
    got = np.concatenate([np.asarray(mix1), np.asarray(mix2)], axis=0)
    st_m, ref = step_multi(state, bank, gains, n_blocks=2 * n_blocks,
                           block_size=S, backend="blocked")
    assert dberr(got, np.asarray(ref)) <= -100.0


def test_span_vs_oracle_impulse(dberr):
    """f32 span render vs the float64 oracle at <= -60 dB (the contract)."""
    from openpbso_tpu.utils.oracle import OracleIntegrator, iir_coefficients
    md = synth_mode_data(12, 8, seed=7)
    lam64, b, valid = lambda_from_modes(CERAMIC.density, md.omega_squared,
                                        CERAMIC.alpha, CERAMIC.beta)
    bank = build_modal_bank(lam64, b, valid, block_size=S, dtype=jnp.float32)
    n_blocks = 16
    n = n_blocks * S
    tables = build_span_tables(lam64, n, num_modes=bank.num_modes)
    rng = np.random.default_rng(3)
    space_np = rng.standard_normal(md.num_modes)
    m_pad = bank.num_modes
    space_k = jnp.zeros((1, 1, m_pad)).at[0, 0, : md.num_modes].set(
        jnp.asarray(space_np, jnp.float32))
    transfer = jnp.full((1, m_pad), UNIT_TRANSFER, jnp.float32)
    f_k = jnp.zeros((1, 1, n)).at[0, 0, 0].set(1.0)
    _, _, sound = integrate_span(
        jnp.zeros((1, m_pad)), jnp.zeros((1, m_pad)), bank, tables,
        space_k, f_k, transfer)

    c1, c2, c3 = iir_coefficients(CERAMIC.density, md.omega_squared,
                                  CERAMIC.alpha, CERAMIC.beta, H)
    oracle = OracleIntegrator(c1, c2, c3)
    tvec = np.full(md.num_modes, UNIT_TRANSFER)
    ref = np.empty(n)
    for i in range(n):
        q = oracle.step(space_np * (1.0 if i == 0 else 0.0))
        ref[i] = q @ tvec
    assert dberr(np.asarray(sound[0]), ref) <= -60.0


def test_decay_span_matches_full_span(dberr):
    """Zero excitation: decay_span == integrate_span exactly."""
    bank, lam64 = _hetero_bank()
    n_blocks = 4
    n = n_blocks * S
    tables = build_span_tables(lam64, n, num_modes=bank.num_modes)
    o, m = bank.num_objects, bank.num_modes
    rng = np.random.default_rng(5)
    z_re = jnp.asarray(rng.standard_normal((o, m)) * np.asarray(bank.mask),
                       jnp.float32)
    z_im = jnp.asarray(rng.standard_normal((o, m)) * np.asarray(bank.mask),
                       jnp.float32)
    transfer = jnp.asarray(rng.uniform(0.5, 2.0, (o, m)), jnp.float32)
    zero_space = jnp.zeros((o, 1, m), jnp.float32)
    zero_prof = jnp.zeros((o, 1, n), jnp.float32)
    r_full = integrate_span(z_re, z_im, bank, tables, zero_space, zero_prof,
                            transfer)
    r_dec = decay_span(z_re, z_im, bank, tables, transfer)
    for a, b_ in zip(r_full, r_dec):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))


def test_decay_span_step_matches_step_multi(dberr):
    """Host-gated idle span vs the scan path on a rung-down scene."""
    bank, lam64 = _shared_bank()
    n_blocks = 6
    tables = build_span_tables(lam64, n_blocks * S, num_modes=bank.num_modes)
    o, m = bank.num_objects, bank.num_modes
    state = make_solver_state(o, m, num_slots=4)
    rng = np.random.default_rng(9)
    state = dataclasses.replace(
        state,
        z_re=jnp.asarray(rng.standard_normal((o, m)) * np.asarray(bank.mask),
                         jnp.float32),
        z_im=jnp.asarray(rng.standard_normal((o, m)) * np.asarray(bank.mask),
                         jnp.float32))
    gains = jnp.ones((o, 2), jnp.float32)
    st_d, mix_d = decay_span_step(state, bank, tables, gains,
                                  n_blocks=n_blocks, block_size=S)
    st_m, mix_m = step_multi(state, bank, gains, n_blocks=n_blocks,
                             block_size=S, backend="blocked")
    assert dberr(np.asarray(mix_d), np.asarray(mix_m)) <= -100.0
    assert dberr(np.asarray(st_d.z_im), np.asarray(st_m.z_im)) <= -100.0


@pytest.mark.slow
def test_span_f32_ten_seconds_vs_oracle(dberr):
    """Long-horizon accuracy of the production chunked span at the new
    chunk=512 default: a 10 s f32 render of an impulse tracks the float64
    oracle at <= -60 dB (phase error accrues per chunk, ~860 chunks)."""
    from openpbso_tpu.utils.oracle import OracleIntegrator, iir_coefficients
    s = 512
    n_blocks = 860                      # ~10 s
    md = synth_mode_data(8, 6, seed=19)
    lam64, b, valid = lambda_from_modes(CERAMIC.density, md.omega_squared,
                                        CERAMIC.alpha, CERAMIC.beta)
    bank = build_modal_bank(lam64, b, valid, block_size=s,
                            dtype=jnp.float32)
    n = n_blocks * s
    tables = build_span_tables(lam64, n, num_modes=bank.num_modes)
    rng = np.random.default_rng(4)
    space_np = rng.standard_normal(md.num_modes)
    m_pad = bank.num_modes
    space_k = jnp.zeros((1, 1, m_pad), jnp.float32).at[
        0, 0, : md.num_modes].set(jnp.asarray(space_np, jnp.float32))
    transfer = jnp.full((1, m_pad), UNIT_TRANSFER, jnp.float32)
    f_k = jnp.zeros((1, 1, n), jnp.float32).at[0, 0, 0].set(1.0)
    _, _, sound = integrate_span(
        jnp.zeros((1, m_pad), jnp.float32),
        jnp.zeros((1, m_pad), jnp.float32), bank, tables,
        space_k, f_k, transfer)

    c1, c2, c3 = iir_coefficients(CERAMIC.density, md.omega_squared,
                                  CERAMIC.alpha, CERAMIC.beta, H)
    oracle = OracleIntegrator(c1, c2, c3)
    tvec = np.full(md.num_modes, UNIT_TRANSFER)
    ref = np.empty(n)
    for i in range(n):
        q = oracle.step(space_np * (1.0 if i == 0 else 0.0))
        ref[i] = q @ tvec
    err = dberr(np.asarray(sound[0]), ref)
    assert err <= -60.0, f"{err:.1f} dB over 10 s"


@pytest.mark.parametrize("layout", ["shared", "hetero"])
def test_superchunk_hierarchy_matches_single_level(layout, dberr):
    """Two-level chunk hierarchy (round-2 VERDICT item 9): spans long
    enough to carry superchunk tables (X >= 64) produce the same output
    and final state as the single-level X-step scan, for excitation,
    ring-down, and the sustained channel."""
    import dataclasses as dc

    from openpbso_tpu.ops.forces import ar_impulse_g
    from openpbso_tpu.ops.span import ChunkSpanTables
    from openpbso_tpu.runtime.solver import step_span

    if layout == "shared":
        bank, lam64 = _shared_bank(o=3, m=10, s=S)
    else:
        bank, lam64 = _hetero_bank(o=3, m=10, s=S)
    n_blocks = 64                       # 64 * 64 = 4096 samples
    tables = build_span_tables(lam64, n_blocks * S,
                               num_modes=bank.num_modes, radix=S)
    assert isinstance(tables, ChunkSpanTables)
    if layout == "shared":
        assert tables.superchunk > 1, "expected superchunk tables at X=64"
    else:
        # hetero spans keep the single-level scan by default (an
        # einsum mixing form measured slower, ops/span.py); the
        # scan-mix form (pass A/C in _chunk_start_states) is opt-in via
        # hetero_superchunk pending its GPU A/B
        assert tables.superchunk == 1
        tables = build_span_tables(lam64, n_blocks * S,
                                   num_modes=bank.num_modes, radix=S,
                                   hetero_superchunk=True)
        assert tables.superchunk == 32
    flat = dc.replace(tables, s_re=None, s_im=None)   # single-level ref

    state = _seeded_state(bank, n_blocks)
    sus = state.sustained
    state = dataclasses.replace(
        state, sustained=dataclasses.replace(
            sus, active=sus.active.at[2].set(True),
            space=sus.space.at[2, :4].set(1.0)))
    gains = jnp.ones((bank.num_objects, 2), jnp.float32)
    ar_g = jnp.asarray(ar_impulse_g((0.783, 0.116), S), jnp.float32)

    st_a, mix_a = step_span(state, bank, tables, gains, n_blocks=n_blocks,
                            block_size=S, with_sustained=True, ar_g=ar_g)
    st_b, mix_b = step_span(state, bank, flat, gains, n_blocks=n_blocks,
                            block_size=S, with_sustained=True, ar_g=ar_g)
    assert dberr(np.asarray(mix_a), np.asarray(mix_b)) <= -100
    assert dberr(np.asarray(st_a.z_re), np.asarray(st_b.z_re)) <= -100

    # ring-down too (decay_span takes the carry-only hierarchy)
    idle = dataclasses.replace(
        state,
        slots=jax.tree.map(jnp.zeros_like, state.slots),
        sustained=dataclasses.replace(
            state.sustained, active=jnp.zeros_like(sus.active)),
        z_re=jnp.asarray(
            np.random.default_rng(3).standard_normal(state.z_re.shape),
            jnp.float32),
        z_im=jnp.asarray(
            np.random.default_rng(4).standard_normal(state.z_re.shape),
            jnp.float32))
    za, zb, snd_a = decay_span(idle.z_re, idle.z_im, bank, tables,
                               idle.transfer)
    zc, zd, snd_b = decay_span(idle.z_re, idle.z_im, bank, flat,
                               idle.transfer)
    assert dberr(np.asarray(snd_a), np.asarray(snd_b)) <= -100
    assert dberr(np.asarray(za), np.asarray(zc)) <= -100
