"""Modal oscillator bank: host-side (float64) coefficient construction.

The reference time-steps N decoupled damped oscillators with a 2nd-order real
IIR ``q_k = c1 q_{k-1} + c2 q_{k-2} + c3 Q_k`` (modal_integrator.h:88-113).
This build reformulates each oscillator as a *first-order complex*
recurrence

    z_k = lam * z_{k-1} + b * Q_k,      q_k = Im(z_k)

with ``lam = eps * e^{i theta}`` (the reference's own eps/theta,
modal_integrator.h:89-90) and ``b = c3 * (cot(theta) + i)``. This is exactly
equivalent (lam, conj(lam) are the roots of x^2 - c1 x - c2) and unlocks the
batched device formulations:

- a 1-step ``lax.scan`` (state = one complex number per mode), and
- the *block form*: over S samples, ``z_s = lam^{s+1} z_{-1} +
  sum_j lam^{s-j} b Q_j`` — with lam-power tables precomputed on host in
  float64, an entire audio block collapses into a few [O,M]x[M,S] matmuls with
  no serial dependency, and per-block (rather than per-sample) float32 phase
  rounding. That makes the block form both faster *and* more accurate than a
  float32 per-sample scan.

All transcendental math happens here in float64 numpy; the device only ever
sees the resulting (cast) tables.

Overdamped modes (xi >= 1) would produce NaN in the reference
(sqrt of a negative under modal_integrator.h:90); here they are masked to
silence and counted in ``num_invalid``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MODAL_GAIN, SAMPLE_RATE


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ModalBank:
    """Per-(object, mode) oscillator parameters, device-resident.

    Shapes are ``[O, M]`` (padded M; invalid/padding modes have mask 0 and
    lam = b = 0). ``pow_re/pow_im`` are the lam-power tables
    ``lam^d for d in [0, S]`` with shape ``[O, M, S+1]`` (or ``[1, M, S+1]``
    when every object shares one mode bank — the common instanced-scene case).
    """
    lam_re: jax.Array
    lam_im: jax.Array
    b_re: jax.Array
    b_im: jax.Array
    mask: jax.Array
    pow_re: jax.Array | None
    pow_im: jax.Array | None

    @property
    def num_objects(self) -> int:
        return self.lam_re.shape[0]

    @property
    def num_modes(self) -> int:
        return self.lam_re.shape[1]

    @property
    def block_size(self) -> int | None:
        return None if self.pow_re is None else self.pow_re.shape[-1] - 1

    @property
    def shared_tables(self) -> bool:
        return self.pow_re is not None and self.pow_re.shape[0] == 1


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def lambda_from_modes(density: float, omega_squared: np.ndarray, alpha: float,
                      beta: float, h: float = 1.0 / SAMPLE_RATE
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lam, b, valid) in float64/complex128 for one material + mode set.

    Derivation from the reference coefficients (modal_integrator.h:62-99):
    omega = sqrt(omega_squared/density), xi = 0.5(alpha/omega + beta*omega),
    a = 2 xi omega, bq = omega^2, eps = exp(-a h/2), theta = h sqrt(bq - a^2/4);
    then lam = eps e^{i theta} and Im(b) = c3, Re(b) = c3 cot(theta), which
    makes Im(z_k) reproduce the reference recurrence exactly.
    """
    omega_squared = np.asarray(omega_squared, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        omega = np.sqrt(omega_squared / density)
        xi = 0.5 * (alpha / omega + beta * omega)
        a = 2.0 * xi * omega
        bq = omega ** 2
        disc = bq - a * a / 4.0
        valid = (omega > 0) & (disc > 0) & np.isfinite(disc)
        disc = np.where(valid, disc, 1.0)
        omega_s = np.where(valid, omega, 1.0)
        eps = np.exp(-a / 2.0 * h)
        theta = h * np.sqrt(disc)
        gamma = np.arcsin(a / (2.0 * np.sqrt(bq)))
        omega_d = np.sqrt(disc)
        c3 = 2.0 * (eps * np.cos(theta + gamma)
                    - eps ** 2 * np.cos(2.0 * theta + gamma))
        c3 = c3 / (3.0 * omega_s * omega_d) * MODAL_GAIN
        lam = eps * np.exp(1j * theta)
        b = c3 * (np.cos(theta) / np.sin(theta) + 1j)
    lam = np.where(valid, lam, 0.0)
    b = np.where(valid, b, 0.0)
    return lam, b, valid


def _power_table(lam: np.ndarray, powers) -> np.ndarray:
    """[..., len(powers)] complex128 table of lam^d, exact-angle form.

    ``powers``: int (meaning arange(powers+1)) or an explicit int array of
    exponents (used by the span tables for strided giant-step powers).
    Computed from polar form (d*log) rather than repeated multiplication so the
    float64 angle does not accumulate rounding across hundreds of powers.
    """
    mag = np.abs(lam)
    ang = np.angle(lam)
    if np.isscalar(powers) or np.ndim(powers) == 0:
        d = np.arange(int(powers) + 1, dtype=np.float64)
    else:
        d = np.asarray(powers, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        logmag = np.where(mag > 0, np.log(mag), -np.inf)
        magd = np.exp(logmag[..., None] * d)  # mag^d (0^0 -> 1 below)
    magd = np.where((mag[..., None] == 0) & (d == 0), 1.0,
                    np.nan_to_num(magd, nan=0.0))
    angd = ang[..., None] * d
    return magd * np.exp(1j * angd)


def build_modal_bank(
    lam: np.ndarray,
    b: np.ndarray,
    valid: np.ndarray,
    *,
    block_size: int | None = None,
    pad_modes_to: int = 128,
    shared: bool | None = None,
    dtype=jnp.float32,
) -> ModalBank:
    """Assemble a device ModalBank from per-(object, mode) lam/b arrays.

    ``lam/b/valid`` may be [M] (single object) or [O, M]. Modes are padded to
    a multiple of ``pad_modes_to`` for lane alignment. When ``shared`` is true
    (or lam is 1-object), the lam-power tables are stored once and broadcast
    across objects.
    """
    lam = np.atleast_2d(np.asarray(lam))
    b = np.atleast_2d(np.asarray(b))
    valid = np.atleast_2d(np.asarray(valid))
    o, m = lam.shape
    mp = round_up(max(m, 1), pad_modes_to)
    pad = ((0, 0), (0, mp - m))
    lam = np.pad(lam, pad)
    b = np.pad(b, pad)
    mask = np.pad(valid.astype(np.float64), pad)
    lam = lam * mask
    b = b * mask

    pow_re = pow_im = None
    if block_size is not None:
        if shared is None:
            shared = o == 1 or all(
                np.array_equal(lam[0], lam[i]) for i in range(1, o))
        tbl = _power_table(lam[:1] if shared else lam, block_size)
        pow_re = jnp.asarray(tbl.real, dtype)
        pow_im = jnp.asarray(tbl.imag, dtype)
    return ModalBank(
        lam_re=jnp.asarray(lam.real, dtype),
        lam_im=jnp.asarray(lam.imag, dtype),
        b_re=jnp.asarray(b.real, dtype),
        b_im=jnp.asarray(b.imag, dtype),
        mask=jnp.asarray(mask, dtype),
        pow_re=pow_re,
        pow_im=pow_im,
    )


def bank_from_material(
    density: float,
    omega_squared: np.ndarray,
    alpha: float,
    beta: float,
    *,
    num_objects: int = 1,
    block_size: int | None = None,
    h: float = 1.0 / SAMPLE_RATE,
    pad_modes_to: int = 128,
    dtype=jnp.float32,
) -> ModalBank:
    """Build a bank where ``num_objects`` instances share one mode set."""
    lam, b, valid = lambda_from_modes(density, omega_squared, alpha, beta, h)
    lam = np.broadcast_to(lam, (num_objects, lam.shape[-1]))
    b = np.broadcast_to(b, (num_objects, b.shape[-1]))
    valid = np.broadcast_to(valid, (num_objects, valid.shape[-1]))
    return build_modal_bank(lam, b, valid, block_size=block_size,
                            pad_modes_to=pad_modes_to, shared=True,
                            dtype=dtype)
