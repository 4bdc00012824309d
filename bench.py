"""Benchmark: audio samples/s on one GPU at 256 objects x 1024 modes.

Three cells, each one chunked span (ops/span.py) at its own size:

- ``shared``     one mode bank shared by every object, a Gaussian hit per
                 object, 512-block span in the 1-slot bucket;
- ``hetero``     a mode bank per object, 1024-block span;
- ``sustained``  an AR(2) drag on every object, 512-block span in the
                 drag-only bucket (the AR channel is the span's only slot).

The parent process stays off JAX and runs one child per cell, one at a
time: one JAX process per card. Each child prints one JSON line naming its
cell and device, with set-up and compile time apart from the timed window,
which ends in ``jax.block_until_ready``. The parent prints the three lines
only when every cell succeeded; a failed cell prints none and exits
non-zero. There is one attempt per cell.

    python bench.py                                          # the GPU
    python bench.py --platform=cpu --objects=8 --modes=128   # CPU rehearsal

``vs_baseline`` is the real-time factor: samples/s over 44.1 kHz.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

CELLS = {
    # cell: (per-object banks, sustained drag, blocks per span)
    "shared": (False, False, 512),
    "hetero": (True, False, 1024),
    "sustained": (False, True, 512),
}
CELL_TIMEOUT_S = 900


def build(o, m, s, dtype_name="float32", hetero=False, need_tables=True,
          listeners=1):
    import dataclasses

    import jax.numpy as jnp
    from openpbso_tpu.ops.coeffs import (bank_from_material,
                                         lambda_from_modes)
    from openpbso_tpu.runtime.state import make_solver_state
    from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data

    dtype = getattr(jnp, dtype_name)
    md = synth_mode_data(m, 8, seed=0)
    if hetero:
        # every object gets its own mode bank (no shared lam tables)
        from openpbso_tpu.ops.coeffs import build_modal_bank
        lams, bs, valids = [], [], []
        for i in range(o):
            mdi = synth_mode_data(m, 8, seed=100 + i,
                                  f_low=100.0 + i, f_high=15000.0 + 3 * i)
            lam, b, valid = lambda_from_modes(
                CERAMIC.density, mdi.omega_squared, CERAMIC.alpha,
                CERAMIC.beta)
            lams.append(lam); bs.append(b); valids.append(valid)
        lam64 = np.stack(lams)
        bank = build_modal_bank(lam64, np.stack(bs),
                                np.stack(valids),
                                block_size=s if need_tables else None,
                                shared=False, dtype=dtype)
    else:
        lam64, _, _ = lambda_from_modes(CERAMIC.density, md.omega_squared,
                                        CERAMIC.alpha, CERAMIC.beta)
        bank = bank_from_material(CERAMIC.density, md.omega_squared,
                                  CERAMIC.alpha, CERAMIC.beta,
                                  num_objects=o, block_size=s, dtype=dtype)
    state = make_solver_state(o, bank.num_modes, num_slots=8, dtype=dtype,
                              num_listeners=listeners)
    # plant one gaussian hit per object so the force path does real work
    rng = np.random.default_rng(0)
    slots = state.slots
    slots = dataclasses.replace(
        slots,
        ftype=slots.ftype.at[:, 0].set(2),
        width=slots.width.at[:, 0].set(40.0),
        space=slots.space.at[:, 0, :].set(
            jnp.asarray(rng.standard_normal((o, bank.num_modes)), dtype)))
    state = dataclasses.replace(state, slots=slots)
    if listeners > 1:
        # shared-state multi-listener: [L, O, M] transfer rows, one output
        # channel per listener (distinct rows so no contraction collapses)
        state = dataclasses.replace(state, transfer=jnp.asarray(
            rng.uniform(0.5, 2.0, (listeners, o, bank.num_modes)), dtype))
    gains = jnp.ones((o, 2 if listeners <= 1 else listeners), dtype)
    return bank, state, gains, lam64


def time_span(bank, lam64, state, gains, s, n_blocks=128, iters=4,
              num_slots=1, sustained=False, hetero_superchunk=False):
    """Time one span dispatch of n_blocks; returns a dict of samples/s,
    set-up seconds (span tables) and compile seconds (first dispatch).

    num_slots=1 matches the one planted hit (the session's slot-bucket
    gating dispatches exactly this at runtime). ``sustained=True``
    activates the AR(2) channel on every object; a steady drag has no
    live impact slot, so it dispatches num_slots=0 — the AR channel is
    the span's only slot (session._span_bucket's drag-only bucket).
    The rate is the best of three windows: host load can only lengthen
    a window."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from openpbso_tpu.ops.span import build_span_tables
    from openpbso_tpu.runtime.solver import step_span
    t0 = time.perf_counter()
    tables = build_span_tables(lam64, n_blocks * s,
                               num_modes=bank.num_modes,
                               hetero_superchunk=hetero_superchunk)
    ar_g = None
    if sustained:
        from openpbso_tpu.ops.forces import ar_impulse_g, span_group
        rng = np.random.default_rng(1)
        sus = state.sustained
        sus = dataclasses.replace(
            sus,
            active=jnp.ones_like(sus.active),
            space=jnp.asarray(rng.standard_normal(sus.space.shape),
                              sus.space.dtype))
        state = dataclasses.replace(state, sustained=sus)
        # span-covering table -> scan-free companion propagation
        # (ops/forces.py::_companion_states); grp capped like the session
        grp = span_group(n_blocks, 512)
        ar_g = jnp.asarray(ar_impulse_g((0.783, 0.116), grp * s),
                           state.z_re.dtype)
        num_slots = 0
    jax.block_until_ready((tables, ar_g))
    setup = time.perf_counter() - t0

    def dispatch(st):
        return step_span(st, bank, tables, gains, n_blocks=n_blocks,
                         block_size=s, num_slots=num_slots,
                         with_sustained=sustained, ar_g=ar_g)

    t0 = time.perf_counter()
    st, mix = jax.block_until_ready(dispatch(state))
    compile_s = time.perf_counter() - t0
    st, mix = jax.block_until_ready(dispatch(st))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            st, mix = dispatch(st)
        jax.block_until_ready(mix)
        best = min(best, time.perf_counter() - t0)
    if not np.isfinite(np.asarray(mix)).all():
        raise RuntimeError("non-finite span output")
    return {"samples_per_s": iters * n_blocks * s / best,
            "setup_s": setup, "compile_s": compile_s}


def span_flops_per_sample(o, m, s, n_blocks, k=1, listeners=1,
                          sustained=False):
    """Model FLOPs per audio sample of the chunked span (ops/span.py).
    Counted as 2 FLOPs/MAC on the dominant contractions; small
    [O,M]-shaped elementwise work and the chunk-state scan are omitted
    (<2% at 256 x 1024).

    Per span of N = n_blocks*S samples with chunk C (choose_radix):
      hom pair          2 * L * O * M * N        ([O*X, M] @ [M, C] x2)
      g kernels         2 * L * O * K * M * C
      Toeplitz conv     L * O * K * C * N
      injection pair    2 * O * K * N * M        (listener-independent)
      mixdown           L * O * N
    sustained adds the AR(2) stages (noise conv O*S*N + inj/hom, all
    <3% of the modal work) — folded in as the Toeplitz term of the extra
    slot when the channel is live (K includes it).
    """
    from openpbso_tpu.ops.span import choose_radix
    n = n_blocks * s
    c = choose_radix(n)
    ll = listeners
    if sustained:
        k = k + 1 if k else 1
    macs = (2 * ll * o * m * n          # hom
            + 2 * ll * o * k * m * c    # per-slot kernels
            + ll * o * k * c * n        # within-chunk Toeplitz conv
            + 2 * o * k * n * m         # state injection
            + ll * o * n)               # mixdown
    if sustained:
        macs += o * s * n               # AR noise Toeplitz
    return 2.0 * macs / n


def parse_args(argv):
    opts = {"objects": 256, "modes": 1024, "block": 512, "platform": "gpu",
            "listeners": 1, "cell": None, "hetero_superchunk": False}
    for arg in argv:
        key, _, val = arg.lstrip("-").partition("=")
        key = key.replace("-", "_")
        if key not in opts:
            raise SystemExit(f"bench: unknown option {arg!r}")
        if isinstance(opts[key], bool):
            opts[key] = True
        elif isinstance(opts[key], int):
            opts[key] = int(val)
        else:
            opts[key] = val
    if opts["cell"] is not None and opts["cell"] not in CELLS:
        raise SystemExit(f"bench: unknown cell {opts['cell']!r}; "
                         f"have {sorted(CELLS)}")
    return opts


def run_cell(opts) -> dict:
    """Measure one cell in this process; returns its result line."""
    from openpbso_tpu.utils.platform import (enable_compile_cache,
                                             force_platform)
    force_platform(opts["platform"])
    enable_compile_cache()
    import jax

    from openpbso_tpu.config import SAMPLE_RATE
    o, m, s = opts["objects"], opts["modes"], opts["block"]
    hetero, sustained, nb = CELLS[opts["cell"]]
    bank, state, gains, lam64 = build(o, m, s, hetero=hetero,
                                      need_tables=False,
                                      listeners=opts["listeners"])
    r = time_span(bank, lam64, state, gains, s, n_blocks=nb,
                  sustained=sustained,
                  hetero_superchunk=opts["hetero_superchunk"])
    d = jax.devices()[0]
    sps = r["samples_per_s"]
    how = "drag-only bucket" if sustained else "1-slot bucket"
    if opts["listeners"] > 1:
        how += f", {opts['listeners']} shared-state listeners"
    return {
        "cell": opts["cell"],
        "metric": f"audio samples/s at {o} obj x {m} modes "
                  f"({'per-object' if hetero else 'shared'} banks, "
                  f"{nb}-block span, {how}); real-time factor vs 44.1 kHz",
        "value": sps,
        "unit": "samples/s",
        "vs_baseline": sps / SAMPLE_RATE,
        "setup_s": r["setup_s"],
        "compile_s": r["compile_s"],
        "model_flop_per_sample": span_flops_per_sample(
            o, m, s, nb, k=0 if sustained else 1,
            listeners=opts["listeners"], sustained=sustained),
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    opts = parse_args(argv)
    if opts["cell"] is not None:
        print(json.dumps(run_cell(opts)), flush=True)
        return 0
    lines = []
    for cell in CELLS:
        cmd = [sys.executable, os.path.abspath(__file__), f"--cell={cell}",
               *argv]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=CELL_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            print(f"bench: cell {cell} timed out after {CELL_TIMEOUT_S} s",
                  file=sys.stderr)
            return 1
        found = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        if r.returncode != 0 or len(found) != 1:
            sys.stderr.write(r.stderr[-4000:])
            print(f"bench: cell {cell} failed (rc={r.returncode})",
                  file=sys.stderr)
            return 1
        lines.append(found[0])
    for line in lines:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
