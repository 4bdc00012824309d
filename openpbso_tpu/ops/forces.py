"""Contact-force excitation — functional force-slot tables.

The reference keeps a linked list of polymorphic ``Force`` objects per solver
and calls virtual ``Add`` per block (modal_solver.h:206-240, forces.h). On
the device, forces become *data*: a fixed-size slot table of typed records, and the
per-block time profile is synthesized on device branchlessly from the global
sample clock. A slot's lifetime is a pure function of its start sample, so the
device carries no per-slot state — the host recycles expired slots.

Reference semantics preserved exactly (modal_solver.h:206-221): all active
forces' *time* profiles are summed into one [S] buffer and their *spatial*
modal amplitude vectors into one [M] buffer; the excitation is the rank-1
product of the two sums. A force contributes its spatial term only on blocks
where its profile is still producing.

Force types (forces.h:12-16):

- ``POINT``    unit impulse on the first sample of the activation block
               (forces.h:81-90); produces for exactly one block.
- ``GAUSSIAN`` exp(-0.5((t - 4.5w)/w)^2) with w = width samples; produces
               while block_start < 10w (forces.h:33-48, 92-105 — the cutoff is
               checked at block granularity, so the tail of the final block is
               evaluated, matching the reference).
- ``AR``       AR(2) noise for sustained contact (forces.h:107-137), handled
               separately as the *sustained* channel with carried device state
               (one sustained force per object, modal_solver.h:190-240).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import REBASE_PERIOD
from .integrator import PRECISION

FORCE_NONE = 0
FORCE_POINT = 1
FORCE_GAUSSIAN = 2
FORCE_HERTZ = 3

GAUSSIAN_CUTOFF = 5  # profile truncated after cutoff*2*width samples


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ForceSlots:
    """[O, K] typed force records + [O, K, M] spatial amplitudes."""
    ftype: jax.Array      # [O, K] int32 (FORCE_* codes)
    t0: jax.Array         # [O, K] int32 global sample of activation block
    width: jax.Array      # [O, K] float32 gaussian width in samples
    amp: jax.Array        # [O, K] float32 profile amplitude scale
    space: jax.Array      # [O, K, M] modal amplitudes

    @property
    def num_slots(self) -> int:
        return self.ftype.shape[1]


def make_force_slots(num_objects: int, num_slots: int, num_modes: int,
                     dtype=jnp.float32) -> ForceSlots:
    o, k, m = num_objects, num_slots, num_modes
    return ForceSlots(
        ftype=jnp.zeros((o, k), jnp.int32),
        t0=jnp.zeros((o, k), jnp.int32),
        width=jnp.ones((o, k), dtype),
        amp=jnp.ones((o, k), dtype),
        space=jnp.zeros((o, k, m), dtype),
    )


def slot_duration(ftype: int, width: float, block_size: int) -> int:
    """Samples during which a slot produces (host-side recycling helper).

    A slot is expired once ``block_start - t0 >= duration``; POINT forces
    produce for one block (the reference erases a force the first block its
    Add returns false), GAUSSIAN for cutoff*2*width samples, HERTZ for one
    contact time (width samples). Must mirror the device-side ``producing``
    predicate in :func:`force_block`.
    """
    if ftype == FORCE_POINT:
        return block_size
    if ftype == FORCE_GAUSSIAN:
        return int(GAUSSIAN_CUTOFF * 2 * max(width, 1.0))
    if ftype == FORCE_HERTZ:
        return int(max(width, 1.0))
    return 0



def _slot_kinds(slots: ForceSlots):
    """(is_point, is_gauss, is_hertz, clamped width) per slot."""
    return (slots.ftype == FORCE_POINT,
            slots.ftype == FORCE_GAUSSIAN,
            slots.ftype == FORCE_HERTZ,
            jnp.maximum(slots.width, 1.0))


def _slot_duration_table(is_point, is_gauss, is_hertz, w):
    """Productive duration in samples per slot (0 for empty slots)."""
    return jnp.where(is_point, 1,
                     jnp.where(is_gauss,
                               (GAUSSIAN_CUTOFF * 2 * w).astype(jnp.int32),
                               jnp.where(is_hertz, w.astype(jnp.int32), 0)))


def _slot_profile(t_local, is_point, is_gauss, is_hertz, w, dtype):
    """Force value of each slot at local sample times ``t_local``
    [..., T] — the reference's Force::Add evaluated branchlessly
    (PointForce forces.h:81-90, GaussianForce :92-105 with the truncated
    center of :45, Hertzian contact pulse beyond-reference). ONE
    implementation shared by force_block and force_span: their parity
    contract (per-block outputs reproduced bit-for-block inside a span)
    depends on these formulas being identical.
    """
    tf = t_local.astype(dtype)
    point_prof = (t_local == 0).astype(dtype)
    # center is truncated to int in the reference (forces.h:45)
    center = jnp.floor((GAUSSIAN_CUTOFF - 0.5) * w)
    dt = (tf - center[..., None]) / w[..., None]
    gauss_prof = jnp.exp(-0.5 * dt * dt)
    # Hertzian contact pulse: sin(pi t/tau)^{3/2} over one contact time
    # tau (Hertz impact theory). Masked per sample — unlike the gaussian,
    # the pulse is identically zero outside [0, tau).
    ph = jnp.clip(tf / w[..., None], 0.0, 1.0)
    hertz_prof = jnp.sin(jnp.pi * ph) ** 1.5 * \
        ((t_local >= 0) & (tf < w[..., None])).astype(dtype)
    return jnp.where(is_point[..., None], point_prof,
                     jnp.where(is_gauss[..., None], gauss_prof,
                               jnp.where(is_hertz[..., None], hertz_prof,
                                         0.0)))


@partial(jax.jit, static_argnames=("block_size",))
def force_block(
    slots: ForceSlots,
    block_start: jax.Array,     # [] int32 global sample index of the block
    block_size: int,
):
    """Synthesize the rank-1 excitation for one block.

    Returns (time_profile [O, S], space [O, M]).

    Contract: slot ``t0`` values are block-aligned (the session/engine
    always activates forces at the next block boundary, matching the
    reference's block-granular force dequeue, modal_solver.h:184). A
    mid-block t0 would begin producing only at the following block
    boundary with the profile's leading samples skipped.
    """
    s = block_size
    # per-slot local time at block start (samples since activation)
    local0 = block_start - slots.t0                       # [O, K]
    is_point, is_gauss, is_hertz, w = _slot_kinds(slots)
    dur = _slot_duration_table(is_point, is_gauss, is_hertz, w)
    # producing iff the block *starts* before the cutoff (reference checks
    # count >= cutoff at Add entry only, forces.h:95)
    producing = (local0 >= 0) & (local0 < dur)

    # ---- time profiles, summed over slots -> [O, S]
    t_local = local0[..., None] + jnp.arange(s, dtype=jnp.int32)  # [O, K, S]
    prof = _slot_profile(t_local, is_point, is_gauss, is_hertz, w,
                         slots.amp.dtype)
    prof = prof * (producing * slots.amp)[..., None].astype(prof.dtype)
    time_profile = jnp.sum(prof, axis=1)

    # ---- spatial amplitudes, summed over producing slots -> [O, M]
    space = jnp.sum(
        slots.space * producing[..., None].astype(slots.space.dtype), axis=1)
    return time_profile, space


@partial(jax.jit, static_argnames=("n_samples", "block_size"))
def force_span(
    slots: ForceSlots,
    block_start: jax.Array,     # [] int32 global sample of the span start
    n_samples: int,
    block_size: int,
):
    """Per-slot excitation over a span of many blocks (ops/span.py).

    The reference applies forces at *block* granularity: each block, every
    producing force adds its profile to one shared time buffer and its
    modal amplitudes to one shared space vector, and the excitation is the
    rank-1 product of the two sums (modal_solver.h:206-221). Slot
    membership therefore changes per block inside a span. Decomposing per
    slot reproduces that exactly:

        Q[m, n] = sum_k space_k[m] * (time_total[n] * member_k(block(n)))

    where time_total is the sum of every slot's (block-cut) profile and
    member_k is the block-granular producing predicate — including the
    reference's cross terms (slot A's profile excites slot B's spatial
    pattern while both are members of a block).

    Returns (f_k [O, K, N] per-slot effective profiles, space_k [O, K, M]).
    Per-block outputs of force_block are reproduced bit-for-block by
    construction (same profile formulas, same producing predicate evaluated
    at each block's start).
    """
    n = n_samples
    local0 = block_start - slots.t0                       # [O, K]
    is_point, is_gauss, is_hertz, w = _slot_kinds(slots)
    dur = _slot_duration_table(is_point, is_gauss, is_hertz, w)

    t_local = local0[..., None] + jnp.arange(n, dtype=jnp.int32)  # [O, K, N]
    # block-granular membership: the producing predicate evaluated at the
    # start of the block containing each sample (t0 is block-aligned, so
    # flooring the local time to a block multiple gives that block's local0)
    t_block = (t_local // block_size) * block_size
    member = (t_block >= 0) & (t_block < dur[..., None])

    prof = _slot_profile(t_local, is_point, is_gauss, is_hertz, w,
                         slots.amp.dtype)
    prof = prof * member * slots.amp[..., None]
    time_total = jnp.sum(prof, axis=1)                    # [O, N]
    f_k = time_total[:, None, :] * member.astype(prof.dtype)
    return f_k, slots.space


# ---------------------------------------------------------------------------
# sustained AR(2) channel
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SustainedState:
    """Per-object sustained-force channel (modal_solver.h:190-240).

    ``active`` gates the channel; while active, the block excitation is the
    AR(2) profile times ``space`` and the slot table is ignored (the reference
    clears other forces on sustained start, modal_solver.h:191-194).
    """
    active: jax.Array     # [O] bool
    space: jax.Array      # [O, M]
    ar_hist: jax.Array    # [O, 2] mu_tilde_{k-1}, mu_tilde_{k-2}
    a: jax.Array          # [O, 2] AR coefficients
    sigma: jax.Array      # [O]
    mu: jax.Array         # [O]
    key: jax.Array        # [O, 2] uint32 per-object BASE keys (never
    #   advanced: each block's noise key is fold_in(key, block index) —
    #   _noise_for_blocks — so the stream is a pure function of the
    #   solver clock and replays deterministically)


def make_sustained_state(num_objects: int, num_modes: int, seed: int = 0,
                         dtype=jnp.float32) -> SustainedState:
    o, m = num_objects, num_modes
    keys = jax.random.split(jax.random.PRNGKey(seed), o)
    return SustainedState(
        active=jnp.zeros((o,), jnp.bool_),
        space=jnp.zeros((o, m), dtype),
        ar_hist=jnp.zeros((o, 2), dtype),
        a=jnp.tile(jnp.asarray([[0.783, 0.116]], dtype), (o, 1)),
        sigma=jnp.full((o,), 0.00148, dtype),
        mu=jnp.full((o,), 0.142, dtype),
        key=jnp.stack([jax.random.key_data(k) for k in keys]).astype(
            jnp.uint32),
    )


def ar_stability_radius(a) -> float:
    """Largest characteristic-root magnitude of the AR(2) recurrence
    mu[n] = a1 mu[n-1] + a2 mu[n-2] (roots of r^2 - a1 r - a2 = 0).

    < 1 means the tuning is stable. set_ar_params rejects radius >= 1
    before mutating any state: an unstable tuning makes ar_impulse_g's
    r^(d+1) tables (up to ~262k samples) overflow to inf/NaN under
    errstate(over='ignore') and silently poison the span output — and
    the ``arparam`` command is reachable from the wire (round-4 advisor
    finding). The reference never validates (forces.h:130-137) but its
    per-sample recurrence merely diverges audibly instead of NaN-ing a
    whole span.

    Non-finite coefficients (json.loads accepts ``NaN`` on the wire)
    return inf so every ``radius < 1.0`` stability check rejects them —
    a bare ``radius >= 1.0`` comparison is False for NaN and would
    silently admit the tuning."""
    a = np.asarray(a, np.float64).reshape(2)
    if not np.all(np.isfinite(a)):
        return float("inf")
    half = a[0] / 2.0
    root = np.sqrt(np.complex128(half * half + a[1]))
    return float(max(abs(half + root), abs(half - root)))


def ar_impulse_g(a: np.ndarray, length: int) -> np.ndarray:
    """Host float64 impulse response of the AR(2) recurrence: g[d] for
    d in [0, length], with g[0] = 1, g[1] = a1, g[d] = a1 g[d-1] +
    a2 g[d-2].

    g is the kernel of the span factorization (sustained_span): the
    AR(2) companion matrix A = [[a1, a2], [1, 0]] satisfies
    A^d e1 = [g[d], g[d-1]], so every power of A used by the span is a
    pair of g entries. Tables longer than one block unlock the span's
    scan-free group propagation (the powers A^(dS) are static gathers of
    g — see sustained_span); the session sizes them per span length.

    ``a``: [2] or [O, 2]; returns [O, length+1] (callers cast to the
    device dtype). Evaluated in closed form from the characteristic
    roots (g[d] = (r1^(d+1) - r2^(d+1))/(r1 - r2)) so quarter-million-
    sample tables build in microseconds. Near-degenerate roots (the
    closed form cancels catastrophically there) use the binomial
    expansion in e2 = a1^2/4 + a2 instead: g[d] = (d+1) r^d +
    C(d+1,3) r^(d-2) e2 + C(d+1,5) r^(d-4) e2^2 + ..., which within the
    fallback region (|e2| <= 2.5e-17 r^2, d <= ~2^18) is f64-exact after
    three terms — no per-sample Python loop (a live retune to a
    critically damped tuning must not stall the synthesis thread).
    """
    a = np.atleast_2d(np.asarray(a, np.float64))
    o = a.shape[0]
    d = np.arange(length + 1, dtype=np.float64)
    half = a[:, :1] / 2.0
    root = np.sqrt((half * half + a[:, 1:2]).astype(np.complex128))
    r1, r2 = half + root, half - root
    sep = np.abs(r1 - r2)
    scale = np.maximum(np.abs(r1), np.abs(r2)).clip(min=1e-30)
    ok = (sep > 1e-8 * scale)[:, 0]
    g = np.zeros((o, length + 1))
    with np.errstate(over="ignore", invalid="ignore"):
        if ok.any():
            g[ok] = ((r1[ok] ** (d + 1) - r2[ok] ** (d + 1))
                     / (r1[ok] - r2[ok])).real
    if not ok.all():
        idx = np.nonzero(~ok)[0]
        r = half[idx]                                   # [k, 1] real
        e2 = (half * half + a[:, 1:2])[idx]             # [k, 1] ~ 0
        dp1 = d + 1.0
        c3 = dp1 * (dp1 - 1) * (dp1 - 2) / 6.0
        c5 = c3 * (dp1 - 3) * (dp1 - 4) / 20.0
        with np.errstate(over="ignore", invalid="ignore"):
            t0 = dp1 * r ** d
            t1 = np.where(d >= 2, c3 * r ** np.maximum(d - 2, 0), 0.0) * e2
            t2 = np.where(d >= 4, c5 * r ** np.maximum(d - 4, 0),
                          0.0) * (e2 * e2)
        g[idx] = t0 + t1 + t2
    return g


def _noise_for_blocks(key_data: jax.Array, block_start: jax.Array,
                      n_blocks: int, block_size: int, dtype):
    """Per-block AR noise, derived counter-style from the absolute block
    index: noise for block i of object o = N(0,1)^S drawn from
    fold_in(key_o, block_start//S + i). No sequential key chain — every
    block's stream is independent of how the stream was chunked into
    dispatches, so per-block stepping, any span split, and offline
    timeline replay all produce bit-identical noise (the reference's
    std::normal_distribution stream is stateful and NOT reproduced;
    stochastic force — spectra are compared, not samples, forces.h:112).

    Returns [O, n_blocks, S] — object-major, the layout every consumer
    contracts in, so no [X, O, S] -> [O, N] transpose ever materializes
    (a pure memory-traffic pass over the largest noise tensor). NOTE
    the session's int32 clock rebase (runtime/session.py::_rebase_clock)
    wraps block indices every 2^30 samples (~6.7 h at 44.1 kHz), so the
    noise stream repeats with that period — statistically irrelevant and
    inaudible (different AR state, different contact), documented for
    exactness.

    The index is taken MODULO the rebase period in blocks (when the block
    size divides it, which every power-of-two block size does): the
    session's rebase quantizes its subtraction to whole REBASE_PERIOD
    multiples (runtime/session.py::_maybe_rebase), so ``block_start`` at a
    dispatch start is exactly ``absolute_clock mod REBASE_PERIOD`` — but a
    span whose blocks straddle a period boundary would otherwise fold in
    un-wrapped indices past the period while a live block-by-block engine
    folds in wrapped ones. The mod makes the two streams bit-identical
    across the boundary regardless of dispatch chunking.
    """
    keys = jax.vmap(jax.random.wrap_key_data)(key_data)          # [O]
    idx0 = (block_start // block_size).astype(jnp.int32)
    bidx = idx0 + jnp.arange(n_blocks, dtype=jnp.int32)          # [X]
    if REBASE_PERIOD % block_size == 0:
        bidx = bidx % jnp.int32(REBASE_PERIOD // block_size)
    nkeys = jax.vmap(
        lambda k: jax.vmap(lambda i: jax.random.fold_in(k, i))(bidx))(keys)
    return jax.vmap(jax.vmap(
        lambda k: jax.random.normal(k, (block_size,), dtype)))(nkeys)


def span_group(n_blocks: int, cap: int) -> int:
    """Largest divisor of ``n_blocks`` that is <= ``cap`` (>= 1): the
    block-group size for the scan-free companion propagation. ONE
    definition shared by _companion_states, the session's AR-table
    sizing (runtime/session.py::ar_span_table), and bench.py — if the
    table builder and the propagation ever disagreed, the table would
    silently stop covering the span and the scan would lengthen with no
    error."""
    for cand in range(min(n_blocks, cap), 0, -1):
        if n_blocks % cand == 0:
            return cand
    return 1


def _companion_powers(g: jax.Array, a2: jax.Array, grp: int,
                      block_size: int):
    """A^(d*S) for d in [0, grp] from static gathers of the impulse table
    (A^d = [[g[d], a2 g[d-1]], [g[d-1], a2 g[d-2]]]; d=0 fixed to I).

    ``g``: [Og, >=grp*S] table, ``a2``: [Og]. Returns [Og, grp+1, 2, 2].
    """
    s = block_size
    idxp = np.arange(grp + 1) * s
    gpad = jnp.concatenate([jnp.zeros_like(g[:, :2]), g], axis=-1)
    p00 = g[:, idxp]                       # g[dS]
    p10 = gpad[:, idxp + 1]                # g[dS-1]
    p01 = a2[:, None] * p10
    p11 = a2[:, None] * gpad[:, idxp]      # a2 g[dS-2]
    p00 = p00.at[:, 0].set(1.0)
    p10 = p10.at[:, 0].set(0.0)
    p01 = p01.at[:, 0].set(0.0)
    p11 = p11.at[:, 0].set(1.0)
    return jnp.stack([jnp.stack([p00, p01], axis=-1),
                      jnp.stack([p10, p11], axis=-1)], axis=-2)


def _companion_states(h0: jax.Array, inj: jax.Array, g: jax.Array,
                      a2: jax.Array, n_blocks: int, block_size: int):
    """Propagate h_{b+1} = A^S h_b + inj[b] across n_blocks blocks;
    ``inj`` [O, X, 2] object-major; returns (h_final [O, 2],
    hs [O, X, 2] start-of-block states, same layout).

    Scan-free up to the group size the g table affords (grp = largest
    divisor of X with grp*S < len(g)): group-start states ride an
    X/grp-step scan (1 step = no scan work when the table covers the
    whole span — the shared-tuning default), and interior states are
    2x2-batched einsums against the companion-power tables — the modal
    superchunk trick (ops/span.py::_chunk_start_states) applied to the
    AR(2) recurrence, where it wins for per-object tunings too because
    the mixing tables are [*, grp, grp, 2, 2] (KB-MB, not the [O,G,G,M]
    blowup that reverted the modal hetero superchunk)."""
    o = h0.shape[0]
    x = n_blocks
    s = block_size
    shared = g.shape[0] == 1
    grp = span_group(x, (g.shape[1] - 1) // s)
    pows = _companion_powers(g, a2, grp, s)        # [Og, grp+1, 2, 2]
    xg = x // grp
    ir = inj.reshape(o, xg, grp, 2)
    # group injection: INJ_q = sum_j A^((grp-1-j)S) inj[qG + j]
    wf = jnp.flip(pows[:, :grp], axis=1)
    if shared:
        inj_g = jnp.einsum("oqjb,jrb->qor", ir, wf[0],
                           precision=PRECISION)
    else:
        inj_g = jnp.einsum("oqjb,ojrb->qor", ir, wf,
                           precision=PRECISION)
    rot = pows[:, grp]                             # A^(grp*S)

    def gbody(h, iq):
        if shared:
            hn = jnp.einsum("ob,rb->or", h, rot[0],
                            precision=PRECISION) + iq
        else:
            hn = jnp.einsum("orb,ob->or", rot, h,
                            precision=PRECISION) + iq
        return hn, h

    h_f, hq = jax.lax.scan(gbody, h0, inj_g)       # hq [XG, O, 2]
    # interior: h[qG+j] = A^(jS) H_q + sum_{i<j} A^((j-1-i)S) inj[qG+i]
    if shared:
        car = jnp.einsum("qob,jrb->oqjr", hq, pows[0, :grp],
                         precision=PRECISION)
    else:
        car = jnp.einsum("qob,ojrb->oqjr", hq, pows[:, :grp],
                         precision=PRECISION)
    # powsp[k] = A^((k-1)S) with powsp[0] = 0: the clipped (j-i) gather
    # is self-masking for i >= j
    powsp = jnp.concatenate([jnp.zeros_like(pows[:, :1]), pows], axis=1)
    delta = np.arange(grp)[:, None] - np.arange(grp)[None, :]
    tmix = jnp.take(powsp, jnp.asarray(delta.clip(0)), axis=1)
    if shared:
        mix = jnp.einsum("oqib,jirb->oqjr", ir, tmix[0],
                         precision=PRECISION)
    else:
        mix = jnp.einsum("oqib,ojirb->oqjr", ir, tmix,
                         precision=PRECISION)
    hs = (car + mix).reshape(o, x, 2)
    return h_f, hs


@partial(jax.jit, static_argnames=("n_blocks", "block_size"))
def sustained_span(state: SustainedState, g: jax.Array, n_blocks: int,
                   block_size: int, block_start: jax.Array | int = 0):
    """Whole-span AR(2) sustained profiles — the span form of
    ``sustained_block`` (VERDICT round-2 item 2; serial work removed in
    round 4).

    The AR(2) recurrence (forces.h:107-128) is LTI, so it factors exactly
    like the modal oscillators did (ops/span.py): with h_b the companion
    state [mu~_{b-1}, mu~_{b-2}] at block b's start and g the host-f64
    impulse response table (ar_impulse_g),

        h_{b+1}    = A^S h_b + sigma * [n_b . rev(g[:S]), n_b . rev(gp[:S])]
        mu~_b[k]   = g[k+1] h_b[0] + a2 g[k] h_b[1]
                     + sigma * sum_{j<=k} g[k-j] n_b[j]

    Every stage is batched: noise keys are counter-derived from the
    absolute block index (no key-split chain — _noise_for_blocks), the
    h_b start states come from the scan-free group propagation
    (_companion_states), the injections are one [X*O, S] @ [S, 2]
    contraction, the homogeneous part one [X*O, 2] @ [2, S], and the
    noise conv one [S, S] g-Toeplitz batched matmul. No per-sample
    serial work anywhere; the only lax.scan shrinks to X/grp steps
    (1 when the g table covers the span).

    ``g``: [1, L+1] (all objects share one AR tuning — the default) or
    [O, L+1] per-object tables, from ar_impulse_g on the HOST mirror of
    the AR params (ModalSession keeps them in sync; f64 source for the
    same reason as the lam tables). L >= S; L >= n_blocks*S makes the
    propagation fully scan-free.

    Returns (new_state, profile [O, N], space [O, M]); inactive objects
    produce zeros and their ar_hist is carried untouched. The noise for
    block i depends only on (state.key, block index), so any dispatch
    split — and offline replay — produces the identical stream.
    """
    assert block_size >= 2, (
        "sustained_span needs block_size >= 2 (the AR(2) injection rows "
        "g2/h_rows and companion algebra assume two lags per block)")
    o = state.active.shape[0]
    s, x = block_size, n_blocks
    dtype = state.space.dtype
    shared = g.shape[0] == 1
    g = g.astype(dtype)
    a2 = (state.a[:1, 1] if shared else state.a[:, 1])    # [Og]
    sigma = state.sigma[:, None]                          # [O, 1]

    # gp[d+1] = g[d] with gp[0] = g[-1] = 0: every shifted row below is a
    # static slice of gp (no dynamic gathers)
    gp = jnp.concatenate([jnp.zeros_like(g[:, :1]), g], axis=-1)
    # injection rows: inj[0] needs g[S-1-j], inj[1] needs g[S-2-j] (j<S)
    g2 = jnp.stack([jnp.flip(gp[:, 1:s + 1], -1),
                    jnp.flip(gp[:, :s], -1)], axis=-1)    # [Og, S, 2]

    # 1) counter-derived noise, one batched draw, object-major [O, X, S]
    #    (the layout every contraction below consumes — no [O, N]
    #    transpose anywhere in this function)
    noise = _noise_for_blocks(state.key, jnp.asarray(block_start), x, s,
                              dtype)
    if shared:
        inj = sigma[..., None] * jnp.einsum("oxs,st->oxt", noise, g2[0],
                                                precision=PRECISION)
    else:
        inj = sigma[..., None] * jnp.einsum("oxs,ost->oxt", noise, g2,
                                                precision=PRECISION)

    # 2) start-of-block companion states, scan-free group propagation
    h_f, hs = _companion_states(state.ar_hist, inj, g, a2, x, s)

    # 3) within-block homogeneous part: g[k+1] h0 + a2 g[k] h1
    h_rows = jnp.stack([g[:, 1:s + 1], a2[:, None] * g[:, :s]],
                       axis=1)                            # [Og, 2, S]
    if shared:
        mu_hom = jnp.matmul(hs.reshape(o * x, 2), h_rows[0],
                            precision=PRECISION).reshape(o, x, s)
    else:
        mu_hom = jnp.einsum("oxh,ohs->oxs", hs, h_rows,
                            precision=PRECISION)
    # noise conv: Toeplitz T[k, j] = g[k-j] (k >= j), like ops/span.py;
    # shared banks flatten to one [O*X, S] @ [S, S] matmul
    delta = np.arange(s)[:, None] - np.arange(s)[None, :]
    t_g = jnp.take(g, jnp.asarray(delta.clip(0)), axis=-1) \
        * jnp.asarray(delta >= 0, dtype)                  # [Og, S, S]
    if shared:
        mu_conv = jnp.matmul(noise.reshape(o * x, s), t_g[0].T,
                             precision=PRECISION).reshape(o, x, s)
    else:
        mu_conv = jnp.einsum("oxj,okj->oxk", noise, t_g,
                             precision=PRECISION)
    mu_tilde = mu_hom + sigma[..., None] * mu_conv        # [O, X, S]

    gate = state.active
    profile = (state.mu[:, None] + mu_tilde.reshape(o, x * s)) \
        * gate[:, None].astype(dtype)
    space = state.space * gate[:, None].astype(dtype)
    new_state = dataclasses.replace(
        state,
        ar_hist=jnp.where(gate[:, None], h_f, state.ar_hist),
    )
    return new_state, profile, space


@partial(jax.jit, static_argnames=("block_size",))
def sustained_block(state: SustainedState, block_size: int,
                    block_start: jax.Array | int = 0):
    """Generate one block of AR(2) profiles for every object.

    Returns (new_state, time_profile [O, S], space [O, M]); inactive objects
    produce zeros. mu_tilde_k = a1 mu_tilde_{k-1} + a2 mu_tilde_{k-2} +
    sigma N(0,1); output mu + mu_tilde (forces.h:107-128). The noise is
    counter-derived from ``block_start`` (the solver clock) — see
    _noise_for_blocks — so per-block stepping is bitwise the span stream.
    """
    dtype = state.space.dtype
    noise = _noise_for_blocks(state.key, jnp.asarray(block_start), 1,
                              block_size, dtype)[:, 0]    # [O, S]

    def body(hist, n_s):
        mu_t = state.a[:, 0] * hist[:, 0] + state.a[:, 1] * hist[:, 1]
        mu_t = mu_t + state.sigma * n_s
        return jnp.stack([mu_t, hist[:, 0]], axis=1), mu_t

    hist, mu_tilde = jax.lax.scan(body, state.ar_hist,
                                  jnp.swapaxes(noise, 0, 1))
    profile = state.mu[:, None] + jnp.swapaxes(mu_tilde, 0, 1)  # [O, S]
    gate = state.active
    profile = profile * gate[:, None].astype(dtype)
    space = state.space * gate[:, None].astype(dtype)
    new_state = dataclasses.replace(
        state,
        ar_hist=jnp.where(gate[:, None], hist, state.ar_hist),
    )
    return new_state, profile, space
