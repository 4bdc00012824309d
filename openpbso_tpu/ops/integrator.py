"""Modal IIR block integrator — device backends.

Semantics (all backends identical, validated against utils/oracle.py): given
carried complex state ``z_{-1}`` per (object, mode), a rank-1 excitation
``Q_s[m] = space[m] * time[s]`` (the reference's forceSpreadSpace x
forceSpreadTime, modal_solver.h:206-240,262-271), and a transfer row ``t[m]``,
produce over a block of S samples

    z_s      = lam z_{s-1} + b space time_s          (q_s = Im z_s)
    sound_s  = sum_m t_m q_s[m]                      (modal_solver.h:267-269)
    qnorm_m  = sqrt(sum_s q_s[m]^2)                  (modal_solver.h:270-272)

Backends:

- ``scan``    — lax.scan over samples; reference semantics on any platform.
- ``blocked`` — the matmul block form: with lam-power tables
  ``P_d = lam^d`` (host-precomputed float64, see ops/coeffs.py),

      sound = Im( sum_m t_m P_{s+1} z_{-1} )         [matmul over modes]
            + (G (*) time)_s,  G_d = sum_m t_m Im(P_d b space)   [matmul]
      z_out = P_S z_{-1} + b space sum_j P_{S-1-j} time_j        [matmul]

  i.e. the whole block is a handful of mode-reduction matmuls plus one length-S
  causal convolution (done via FFT) — no serial dependency, matmul-shaped,
  and per-block rather than per-sample f32 phase rounding.

The qnorm channel (per-mode energy telemetry feeding the transfer-ball HUD) is
optional: in the blocked form it is the only term that requires materializing
per-mode-per-sample values, so it is computed lazily via an FFT convolution
only when requested.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .coeffs import ModalBank


# Every correctness-critical contraction pins its precision instead of
# taking XLA's default: on an NVIDIA GPU the default float32 matmul runs in
# TF32 (a 10-bit mantissa), whose error against the -60 dB oracle contract
# has not been measured. HIGHEST is true float32 with no TF32. On the GPU
# OPENPBSO_MATMUL_PRECISION=high selects TF32 at import time, for precision
# experiments only (PERF.md lists what is measured).
import os as _os

PRECISION = {
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}[_os.environ.get("OPENPBSO_MATMUL_PRECISION", "highest").lower()]


def _complex_weights(t_re, t_im, v_re, v_im):
    """Reduce-channel weights of Im(t * P * v) for a possibly-COMPLEX
    transfer t = t_re + i*t_im (t_im None = the real case):

        Im(t P v) = P_re (t_re v_im + t_im v_re)
                  + P_im (t_re v_re - t_im v_im)

    Returns (w_pr, w_pi). A complex transfer costs no extra matmuls —
    both P channels are already reduced; only these elementwise
    pre-products change. Per-mode phase = a time shift at that mode's
    frequency (modes are narrowband), giving exact interaural time
    differences / phase-accurate complex FFAT on every fast path."""
    if t_im is None:
        return t_re * v_im, t_re * v_re
    return t_re * v_im + t_im * v_re, t_re * v_re - t_im * v_im


def _mode_reduce(w: jax.Array, table: jax.Array) -> jax.Array:
    """einsum('om,oms->os') that lowers to a true matmul for shared tables.

    ``w`` may carry a leading listener axis ([L, O, M] -> [L, O, S]): sound
    is linear in the transfer weights, so L listeners sharing one [O, M]
    oscillator state cost only L mode-reduces, not L-fold state/force work
    (the shared-state multi-listener path, models/scene.py)."""
    if w.ndim == 3:
        if table.shape[0] == 1:
            lo, o, m = w.shape
            out = jnp.matmul(w.reshape(lo * o, m), table[0],
                             precision=PRECISION)
            return out.reshape(lo, o, -1)
        return jnp.einsum("lom,oms->los", w, table, precision=PRECISION)
    if table.shape[0] == 1:
        return jnp.matmul(w, table[0], precision=PRECISION)
    return jnp.einsum("om,oms->os", w, table, precision=PRECISION)


def _weighted_gather(table: jax.Array, f: jax.Array) -> jax.Array:
    """einsum('omd,od->om') (shared-table aware)."""
    if table.shape[0] == 1:
        return jnp.matmul(f, table[0].T, precision=PRECISION)
    return jnp.einsum("omd,od->om", table, f, precision=PRECISION)


def _causal_conv_fft(g: jax.Array, f: jax.Array) -> jax.Array:
    """FFT form of the causal conv (S and the padded length 2S are powers
    of two in the native block size). Precise and fast on CPU."""
    s = g.shape[-1]
    n = 2 * s
    gf = jnp.fft.rfft(g, n=n, axis=-1)
    ff = jnp.fft.rfft(f, n=n, axis=-1)
    out = jnp.fft.irfft(gf * ff, n=n, axis=-1)[..., :s]
    return out.astype(g.dtype)


def _causal_conv(g: jax.Array, f: jax.Array) -> jax.Array:
    """Per-object causal convolution: out[s] = sum_{j<=s} g[s-j] f[j].

    g, f: [O, S] -> [O, S]. FFT form on every platform (a grouped
    lax.conv direct form lowers to per-group loops, and the dense-input
    deviation it was once meant to fix was einsum precision, not the
    FFT)."""
    return _causal_conv_fft(g, f)


@partial(jax.jit, static_argnames=("compute_qnorm",))
def step_block_scan(
    z_re: jax.Array,            # [O, M]
    z_im: jax.Array,            # [O, M]
    bank: ModalBank,
    space: jax.Array,           # [O, M]
    time_profile: jax.Array,    # [O, S]
    transfer: jax.Array,        # [O, M]
    compute_qnorm: bool = False,
    transfer_im: jax.Array | None = None,
):
    """lax.scan backend. Returns (z_re, z_im, sound [O,S], qnorm [O,M]|None)."""
    be_re = bank.b_re * space
    be_im = bank.b_im * space
    tmask = transfer * bank.mask
    timask = None if transfer_im is None else transfer_im * bank.mask

    def body(carry, f_s):
        zr, zi = carry
        # f_s: [O] one sample of the time profile
        zr_n = bank.lam_re * zr - bank.lam_im * zi + be_re * f_s[:, None]
        zi_n = bank.lam_im * zr + bank.lam_re * zi + be_im * f_s[:, None]
        # tmask may carry a leading listener axis ([L, O, M] -> [L, O]);
        # a complex transfer adds the Re(z) channel (see _complex_weights)
        sound = jnp.sum(tmask * zi_n, axis=-1)
        if timask is not None:
            sound = sound + jnp.sum(timask * zr_n, axis=-1)
        out = (sound, zi_n * zi_n) if compute_qnorm else (sound, None)
        return (zr_n, zi_n), out

    (z_re, z_im), (sound, qsq) = jax.lax.scan(
        body, (z_re, z_im), jnp.swapaxes(time_profile, 0, 1))
    sound = jnp.moveaxis(sound, 0, -1)   # [S, (L,) O] -> [(L,) O, S]
    qnorm = jnp.sqrt(jnp.sum(qsq, axis=0)) if compute_qnorm else None
    return z_re, z_im, sound, qnorm


@partial(jax.jit, static_argnames=("compute_qnorm",))
def step_block_blocked(
    z_re: jax.Array,            # [O, M]
    z_im: jax.Array,            # [O, M]
    bank: ModalBank,
    space: jax.Array,           # [O, M]
    time_profile: jax.Array,    # [O, S]
    transfer: jax.Array,        # [O, M]
    compute_qnorm: bool = False,
    transfer_im: jax.Array | None = None,
):
    """Block-form backend (requires bank lam-power tables of size S+1)."""
    s = time_profile.shape[-1]
    assert bank.pow_re is not None and bank.pow_re.shape[-1] == s + 1, (
        "bank tables missing or built for a different block size")
    pr, pi = bank.pow_re, bank.pow_im           # [Ot, M, S+1]
    be_re = bank.b_re * space                   # [O, M]
    be_im = bank.b_im * space
    tmask = transfer * bank.mask
    timask = None if transfer_im is None else transfer_im * bank.mask

    # _mode_reduce lowers to a true [O,M]@[M,S] matmul for shared tables
    # and a batched einsum otherwise
    wz_pr, wz_pi = _complex_weights(tmask, timask, z_re, z_im)
    hom = (_mode_reduce(wz_pr, pr[..., 1:])
           + _mode_reduce(wz_pi, pi[..., 1:]))
    wg_pr, wg_pi = _complex_weights(tmask, timask, be_re, be_im)
    g = (_mode_reduce(wg_pi, pi[..., :s])
         + _mode_reduce(wg_pr, pr[..., :s]))
    sound = hom + _causal_conv(g, time_profile)

    # state at block end: z_out = lam^S z_{-1} + b*space * C,
    # C = sum_j lam^{S-1-j} time_j
    f_rev = time_profile[..., ::-1]
    c_re = _weighted_gather(pr[..., :s], f_rev)
    c_im = _weighted_gather(pi[..., :s], f_rev)
    ps_re, ps_im = pr[..., s], pi[..., s]
    z_re_out = ps_re * z_re - ps_im * z_im + be_re * c_re - be_im * c_im
    z_im_out = ps_im * z_re + ps_re * z_im + be_re * c_im + be_im * c_re

    qnorm = (_qnorm_blocked(bank, pr, pi, be_re, be_im, time_profile,
                            z_re, z_im, s)
             if compute_qnorm else None)
    return z_re_out, z_im_out, sound, qnorm


def _qnorm_blocked(bank, pr, pi, be_re, be_im, time_profile, z_re, z_im, s):
    """Per-mode energy over the block: homogeneous part + per-mode causal
    convolution of the time profile with the mode's impulse kernel
    Im(lam^d b space). Shared by the plain and xfade blocked steps
    (qnorm is transfer-independent)."""
    n = 2 * s
    ker = be_re[..., None] * pi[..., :s] + be_im[..., None] * pr[..., :s]
    kf = jnp.fft.rfft(ker, n=n, axis=-1)
    ff = jnp.fft.rfft(time_profile, n=n, axis=-1)[:, None, :]
    conv = jnp.fft.irfft(kf * ff, n=n, axis=-1)[..., :s].astype(z_re.dtype)
    q = (pr[..., 1:] * z_im[..., None] + pi[..., 1:] * z_re[..., None]
         + conv)
    return jnp.sqrt(jnp.sum(q * q, axis=-1)) * bank.mask


def _xfade_rows(transfer_prev, transfer, transfer_prev_im, transfer_im,
                mask):
    """(t0_re, dt_re, t0_im|None, dt_im|None) for the ramped transfer.

    A COMPLEX xfade ramps the real and imaginary rows independently —
    the output is linear in both, so the ramped complex dot still splits
    into two constant-weight renders. A side that lacks an imaginary row
    ramps from/to zero phase (e.g. an ITD row fading in)."""
    t0 = transfer_prev * mask
    dt = (transfer - transfer_prev) * mask
    if transfer_prev_im is None and transfer_im is None:
        return t0, dt, None, None
    pim = (jnp.zeros_like(transfer_prev) if transfer_prev_im is None
           else transfer_prev_im)
    nim = jnp.zeros_like(transfer) if transfer_im is None else transfer_im
    return t0, dt, pim * mask, (nim - pim) * mask


@partial(jax.jit, static_argnames=("compute_qnorm",))
def step_block_scan_xfade(
    z_re: jax.Array,
    z_im: jax.Array,
    bank: ModalBank,
    space: jax.Array,
    time_profile: jax.Array,
    transfer_prev: jax.Array,   # [O, M] transfer at the block start
    transfer: jax.Array,        # [O, M] transfer at the block end
    compute_qnorm: bool = False,
    transfer_prev_im: jax.Array | None = None,
    transfer_im: jax.Array | None = None,
):
    """scan backend with per-sample linear transfer interpolation.

    The reference holds the transfer constant per block (modal_solver.h
    computeTransfer consumes one listener update per block), which steps
    the output level discontinuously when the listener moves fast. Here
    the transfer row ramps linearly across the block:
    t(s) = t_prev + (s+1)/S (t_new - t_prev). Complex rows (per-mode
    phase, see _complex_weights) ramp re and im independently.
    """
    s = time_profile.shape[-1]
    be_re = bank.b_re * space
    be_im = bank.b_im * space
    t0, dt, t0i, dti = _xfade_rows(transfer_prev, transfer,
                                   transfer_prev_im, transfer_im, bank.mask)
    ramp = (jnp.arange(1, s + 1, dtype=time_profile.dtype) / s)

    def body(carry, inp):
        zr, zi = carry
        f_s, w = inp
        zr_n = bank.lam_re * zr - bank.lam_im * zi + be_re * f_s[:, None]
        zi_n = bank.lam_im * zr + bank.lam_re * zi + be_im * f_s[:, None]
        sound = jnp.sum((t0 + w * dt) * zi_n, axis=-1)
        if t0i is not None:
            sound = sound + jnp.sum((t0i + w * dti) * zr_n, axis=-1)
        out = (sound, zi_n * zi_n) if compute_qnorm else (sound, None)
        return (zr_n, zi_n), out

    (z_re, z_im), (sound, qsq) = jax.lax.scan(
        body, (z_re, z_im), (jnp.swapaxes(time_profile, 0, 1), ramp))
    sound = jnp.moveaxis(sound, 0, -1)   # [S, (L,) O] -> [(L,) O, S]
    qnorm = jnp.sqrt(jnp.sum(qsq, axis=0)) if compute_qnorm else None
    return z_re, z_im, sound, qnorm


@partial(jax.jit, static_argnames=("compute_qnorm",))
def step_block_blocked_xfade(
    z_re: jax.Array,
    z_im: jax.Array,
    bank: ModalBank,
    space: jax.Array,
    time_profile: jax.Array,
    transfer_prev: jax.Array,
    transfer: jax.Array,
    compute_qnorm: bool = False,
    transfer_prev_im: jax.Array | None = None,
    transfer_im: jax.Array | None = None,
):
    """Blocked backend with per-sample linear transfer interpolation.

    Since the output is linear in the transfer weights, the ramped dot
    splits into two constant-weight renders:
    sound_s = <t_prev, q_s> + ramp_s <dt, q_s> — i.e. the standard hom/G
    machinery evaluated for both weight rows, plus one elementwise ramp.
    Complex rows ramp re and im independently (the render is linear in
    both channels, _complex_weights); the state update is
    transfer-independent and identical to step_block_blocked.
    """
    s = time_profile.shape[-1]
    assert bank.pow_re is not None and bank.pow_re.shape[-1] == s + 1, (
        "bank tables missing or built for a different block size")
    pr, pi = bank.pow_re, bank.pow_im
    be_re = bank.b_re * space
    be_im = bank.b_im * space
    t0, dt, t0i, dti = _xfade_rows(transfer_prev, transfer,
                                   transfer_prev_im, transfer_im, bank.mask)

    def render(w, wi):
        wz_pr, wz_pi = _complex_weights(w, wi, z_re, z_im)
        hom = (_mode_reduce(wz_pr, pr[..., 1:])
               + _mode_reduce(wz_pi, pi[..., 1:]))
        wg_pr, wg_pi = _complex_weights(w, wi, be_re, be_im)
        g = (_mode_reduce(wg_pi, pi[..., :s])
             + _mode_reduce(wg_pr, pr[..., :s]))
        return hom + _causal_conv(g, time_profile)

    ramp = (jnp.arange(1, s + 1, dtype=time_profile.dtype) / s)
    sound = render(t0, t0i) + ramp[None, :] * render(dt, dti)

    f_rev = time_profile[..., ::-1]
    c_re = _weighted_gather(pr[..., :s], f_rev)
    c_im = _weighted_gather(pi[..., :s], f_rev)
    ps_re, ps_im = pr[..., s], pi[..., s]
    z_re_out = ps_re * z_re - ps_im * z_im + be_re * c_re - be_im * c_im
    z_im_out = ps_im * z_re + ps_re * z_im + be_re * c_im + be_im * c_re

    qnorm = (_qnorm_blocked(bank, pr, pi, be_re, be_im, time_profile,
                            z_re, z_im, s)
             if compute_qnorm else None)
    return z_re_out, z_im_out, sound, qnorm


@partial(jax.jit, static_argnames=("compute_qnorm",))
def decay_block_blocked(
    z_re: jax.Array,            # [O, M]
    z_im: jax.Array,            # [O, M]
    bank: ModalBank,
    transfer: jax.Array,        # [O, M]
    compute_qnorm: bool = False,
    transfer_im: jax.Array | None = None,
):
    """Homogeneous-only block step: the scene is ringing down, no forces.

    Exactly ``step_block_blocked`` with a zero excitation: the convolution
    and state-injection terms vanish (x + 0.0 in float), leaving the two
    mode-reduction matmuls and the lam^S state rotation — roughly the cheap
    half of the full step. The host decides eligibility (all force slots
    expired + no sustained channel active, which it tracks exactly); this
    is the "G-caching during pure decay" optimization, taken to its limit
    (the whole forced path is skipped, not just the kernel build).
    """
    s = bank.pow_re.shape[-1] - 1
    pr, pi = bank.pow_re, bank.pow_im
    tmask = transfer * bank.mask
    timask = None if transfer_im is None else transfer_im * bank.mask
    w_pr, w_pi = _complex_weights(tmask, timask, z_re, z_im)
    sound = (_mode_reduce(w_pr, pr[..., 1:])
             + _mode_reduce(w_pi, pi[..., 1:]))
    ps_re, ps_im = pr[..., s], pi[..., s]
    z_re_out = ps_re * z_re - ps_im * z_im
    z_im_out = ps_im * z_re + ps_re * z_im
    qnorm = None
    if compute_qnorm:
        q = pr[..., 1:] * z_im[..., None] + pi[..., 1:] * z_re[..., None]
        qnorm = jnp.sqrt(jnp.sum(q * q, axis=-1)) * bank.mask
    return z_re_out, z_im_out, sound, qnorm


BACKENDS = {
    "scan": step_block_scan,
    "blocked": step_block_blocked,
}


def resolve_backend_name(name: str, bank: ModalBank | None = None) -> str:
    """'auto' -> the per-block form the bank can run: ``blocked`` when it
    carries lam-power tables, ``scan`` for a table-less bank (built
    without block_size; blocked asserts on the missing tables)."""
    if name != "auto":
        return name
    if bank is not None and bank.pow_re is None:
        return "scan"
    return "blocked"


def get_backend(name: str, bank: ModalBank | None = None):
    name = resolve_backend_name(name, bank)
    if name in BACKENDS:
        return BACKENDS[name]
    raise KeyError(f"unknown integrator backend {name!r}; "
                   f"have {sorted(BACKENDS)}")
