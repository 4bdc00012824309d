"""The bench's analytic FLOP model vs XLA's own cost analysis.

bench.py reports model FLOPs per sample for each cell, the numerator of
any achieved-rate or roofline figure. Its honesty rests on
span_flops_per_sample tracking the real executable; this pins the model
against the compiled span's XLA cost analysis so model drift (a new span
stage, a changed contraction) fails a test instead of silently skewing
the telemetry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bench import span_flops_per_sample
from openpbso_tpu.ops.coeffs import bank_from_material, lambda_from_modes
from openpbso_tpu.ops.span import build_span_tables
from openpbso_tpu.runtime.solver import step_span
from openpbso_tpu.runtime.state import make_solver_state
from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data


@pytest.mark.slow   # compiles two 64x256 span executables — the
#   heaviest CPU compiles in the suite; a telemetry guard, not core
#   correctness, so it stays out of the driver's in-round budget
@pytest.mark.parametrize("sustained", [False, True])
def test_span_flop_model_matches_xla_cost_analysis(sustained):
    o, m, s, nb = 64, 256, 512, 32
    md = synth_mode_data(m, 8, seed=0)
    lam64, _, _ = lambda_from_modes(CERAMIC.density, md.omega_squared,
                                    CERAMIC.alpha, CERAMIC.beta)
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta, num_objects=o,
                              block_size=s)
    state = make_solver_state(o, bank.num_modes, num_slots=8,
                              dtype=jnp.float32)
    slots = state.slots
    slots = dataclasses.replace(slots, ftype=slots.ftype.at[:, 0].set(2),
                                width=slots.width.at[:, 0].set(40.0))
    state = dataclasses.replace(state, slots=slots)
    gains = jnp.ones((o, 2), jnp.float32)
    tables = build_span_tables(lam64, nb * s, num_modes=bank.num_modes)
    ar_g = None
    num_slots = 1
    if sustained:
        from openpbso_tpu.ops.forces import ar_impulse_g, span_group
        sus = dataclasses.replace(
            state.sustained, active=jnp.ones_like(state.sustained.active))
        state = dataclasses.replace(state, sustained=sus)
        grp = span_group(nb, 512)
        ar_g = jnp.asarray(ar_impulse_g((0.783, 0.116), grp * s),
                           jnp.float32)
        num_slots = 0

    def f(st, gains):
        return step_span(st, bank, tables, gains, n_blocks=nb,
                         block_size=s, num_slots=num_slots,
                         with_sustained=sustained, ar_g=ar_g)

    c = jax.jit(f).lower(state, gains).compile()
    ca = c.cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    xla = float(ca.get("flops", 0.0))
    assert xla > 0, "cost analysis unavailable"
    model = span_flops_per_sample(o, m, s, nb, k=0 if sustained else 1,
                                  sustained=sustained) * nb * s
    ratio = model / xla
    # the model counts the dominant contractions at 2 FLOP/MAC and omits
    # small elementwise work; XLA counts every op. Hold to a band wide
    # enough for compiler-version noise, tight enough to catch a missing
    # or double-counted stage (those shift the ratio 2x+).
    assert 0.7 <= ratio <= 1.3, (
        f"sustained={sustained}: model {model:.3e} vs XLA {xla:.3e} "
        f"(ratio {ratio:.2f}) — span_flops_per_sample has drifted")
