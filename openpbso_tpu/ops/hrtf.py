"""Parametric spherical-head HRTF rendering.

The reference renders mono duplicated to both ears
(real_time_modal_sound.cpp:207-210); the Scene binaural mode adds true
interaural *level* cues via per-ear FFAT lookups. This module adds the
head itself: interaural time difference and head-shadow filtering from the
classic spherical-head model (Brown & Duda, "A structural model for
binaural sound synthesis", IEEE TSAP 1998 — public literature, no code
copied):

- head shadow: the first-order filter H(s) = (alpha(theta) s + w0) /
  (s + w0), w0 = c / a, with alpha(theta) = 1 + cos(theta) — a gentle
  high-shelf boost on the ipsilateral side, a 6 dB/oct high rolloff on the
  contralateral side;
- ITD: Woodworth's delay tau(theta) = (a / c) (1 - cos(theta)) toward the
  far ear (theta is the angle between the source direction and the ear
  direction).

Design: the per-(object, ear) filter is materialized host-side
as a short FIR (fractional-delay windowed sinc convolved with the
bilinear-transformed shadow filter), and a whole block of O objects is
rendered in ONE frequency-domain mix on device:

    mix_c = sum_o  h_{o,c} (*) sound_o

i.e. an rfft over the block, one [O,F] x [O,C,F] reduce, one irfft — the
same shape as the integrator's causal conv — with the
(T-1)-sample convolution tail carried across blocks as explicit state.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import OUTPUT_SCALE, SAMPLE_RATE, SOUND_SPEED
from .integrator import PRECISION

DEFAULT_HEAD_RADIUS = 0.0875   # meters (average adult)
DEFAULT_TAPS = 128


def _shadow_coeffs(alpha: np.ndarray, w0: float, fs: float):
    """Bilinear transform of H(s) = (alpha s + w0) / (s + w0).

    Returns (b0, b1, a1) for y[n] = b0 x[n] + b1 x[n-1] - a1 y[n-1].
    """
    k = 2.0 * fs
    b0 = (w0 + alpha * k) / (w0 + k)
    b1 = (w0 - alpha * k) / (w0 + k)
    a1 = (w0 - k) / (w0 + k)
    return b0, b1, a1


def _fractional_delay(tau_samples: np.ndarray, n_taps: int) -> np.ndarray:
    """Windowed-sinc fractional delay FIRs, shape [..., n_taps]."""
    n = np.arange(n_taps)
    x = n - tau_samples[..., None]
    h = np.sinc(x)
    # Hann window centered on the delay keeps the kernel compact
    w = 0.5 + 0.5 * np.cos(np.clip(x / (n_taps / 2), -1.0, 1.0) * np.pi)
    return h * w


def spherical_hrtf_fir(
    directions: np.ndarray,            # [O, 3] source dir in listener frame
    *,
    ear_axis=(1.0, 0.0, 0.0),          # left ear at -axis, right at +axis
    head_radius: float = DEFAULT_HEAD_RADIUS,
    n_taps: int = DEFAULT_TAPS,
    sample_rate: float = SAMPLE_RATE,
    base_delay_taps: float = 4.0,
) -> np.ndarray:
    """Build per-(object, ear) FIRs [O, 2, n_taps] (float64, host).

    ``directions`` need not be normalized (zero vectors fall back to a
    frontal source). Ear order is (left, right). ``base_delay_taps`` is a
    common lead-in so the ipsilateral fractional delay stays causal.
    """
    d = np.asarray(directions, np.float64)
    norm = np.linalg.norm(d, axis=-1, keepdims=True)
    d = np.where(norm > 1e-12, d / np.maximum(norm, 1e-12),
                 np.asarray([0.0, 0.0, 1.0]))
    ear = np.asarray(ear_axis, np.float64)
    ear = ear / np.linalg.norm(ear)
    cos_t = np.stack([-d @ ear, d @ ear], axis=-1)      # [O, 2], +1 = at ear

    a_over_c = head_radius / SOUND_SPEED
    tau = a_over_c * (1.0 - cos_t) * sample_rate + base_delay_taps  # samples
    alpha = 1.0 + cos_t                                  # [0, 2]
    w0 = SOUND_SPEED / head_radius

    delay = _fractional_delay(tau, n_taps)               # [O, 2, T]
    b0, b1, a1 = _shadow_coeffs(alpha, w0, sample_rate)

    # impulse response of the shadow IIR, then FIR = shadow (*) delay,
    # truncated back to n_taps (the one-pole tail decays in ~80 taps)
    t = delay.shape[-1]
    x = np.concatenate([delay, np.zeros_like(delay)], axis=-1)
    y = np.zeros_like(x)
    y[..., 0] = b0 * x[..., 0]
    for n in range(1, 2 * t):
        y[..., n] = (b0 * x[..., n] + b1 * x[..., n - 1]
                     - a1 * y[..., n - 1])
    return y[..., :t]


@partial(jax.jit, static_argnames=("block_size",))
def hrtf_mix_block(
    sound: jax.Array,     # [O, S] raw per-object modal sound
    hf: jax.Array,        # [O, C, F] rfft of the FIRs at n = 2 * S
    carry: jax.Array,     # [C, T-1] convolution tail from the prior block
    *,
    block_size: int,
) -> tuple[jax.Array, jax.Array]:
    """One block of frequency-domain HRTF mixdown.

    Returns (mix [S, C] float32 output-scaled, carry' [C, T-1]). Requires
    n_taps <= block_size + 1 (the rfft length is 2 * block_size).
    """
    s = block_size
    n = 2 * s
    t1 = carry.shape[-1]                        # n_taps - 1
    sf = jnp.fft.rfft(sound, n=n, axis=-1)      # [O, F]
    yf = jnp.einsum("of,ocf->cf", sf, hf,
                precision=PRECISION)
    y = jnp.fft.irfft(yf, n=n, axis=-1)[:, : s + t1]   # [C, S+T-1]
    y = y.at[:, :t1].add(carry)
    mix = (y[:, :s] / OUTPUT_SCALE).T.astype(jnp.float32)
    return mix, y[:, s:].astype(carry.dtype)


def fir_to_freq(fir: np.ndarray, block_size: int, dtype=jnp.complex64):
    """Host: rfft the [O, C, T] FIRs to the device layout [O, C, F]."""
    t = fir.shape[-1]
    if t > block_size + 1:
        raise ValueError(f"n_taps {t} > block_size+1 {block_size + 1}; "
                         f"the 2S-point FFT would wrap the tail")
    hf = np.fft.rfft(fir, n=2 * block_size, axis=-1)
    return jnp.asarray(hf, dtype)


@partial(jax.jit, static_argnames=("n_samples",))
def hrtf_mix_span(
    sound: jax.Array,     # [O, N] raw per-object modal sound (whole span)
    hf: jax.Array,        # [O, C, F] rfft of the FIRs at n = 2 * N
    carry: jax.Array,     # [C, T-1] convolution tail from the prior span
    *,
    n_samples: int,
) -> tuple[jax.Array, jax.Array]:
    """A whole span of HRTF mixdown in ONE frequency-domain pass.

    The per-block form pays one FFT triple per block; the mix is a plain
    causal convolution, so a span of N samples is the same overlap-save
    with a 2N-point FFT — block-exact output (same carry semantics: the
    (T-1)-sample tail hands over across spans AND blocks, so mixing span
    and per-block calls mid-stream stays seamless). This is what lets
    broadband-binaural streams ride the engine's span dispatches
    (round-2 VERDICT item 4). Returns (mix [N, C], carry' [C, T-1]).
    """
    n2 = 2 * n_samples
    t1 = carry.shape[-1]
    sf = jnp.fft.rfft(sound, n=n2, axis=-1)           # [O, F]
    yf = jnp.einsum("of,ocf->cf", sf, hf, precision=PRECISION)
    y = jnp.fft.irfft(yf, n=n2, axis=-1)[:, : n_samples + t1]
    y = y.at[:, :t1].add(carry)
    mix = (y[:, :n_samples] / OUTPUT_SCALE).T.astype(jnp.float32)
    return mix, y[:, n_samples:].astype(carry.dtype)


class HRTFPostMix:
    """StreamingEngine ``post_mix`` hook: binaural HRTF mixdown per block.

    Replaces the session's plain gain mixdown inside a live stream::

        pm = HRTFPostMix(positions, block_size=sess.config.block_size)
        engine = StreamingEngine(sess, sink, post_mix=pm)

    The engine calls ``on_listener`` when listener events apply (so the
    direction-dependent filters track moves) and ``reset`` after warmup.
    Only the synthesis thread calls ``__call__``/``on_listener`` (both run
    inside _apply_events/_synth_once), so the carry needs no locking.
    """

    def __init__(self, positions: np.ndarray, *, block_size: int,
                 ear_axis=(1.0, 0.0, 0.0),
                 head_radius: float = DEFAULT_HEAD_RADIUS,
                 n_taps: int = DEFAULT_TAPS):
        self.positions = np.asarray(positions, np.float64)
        self.block_size = block_size
        self.ear_axis = ear_axis
        self.head_radius = head_radius
        self.n_taps = min(n_taps, block_size + 1)
        self._carry = jnp.zeros((2, self.n_taps - 1), jnp.float32)
        # per-span-length frequency tables (process_span); rebuilt lazily
        # after each listener move
        self._hf_span: dict[int, jax.Array] = {}
        self.on_listener(np.zeros(3))

    def on_listener(self, pos: np.ndarray) -> None:
        self._fir = spherical_hrtf_fir(
            self.positions - np.asarray(pos, np.float64),
            ear_axis=self.ear_axis,
            head_radius=self.head_radius,
            n_taps=self.n_taps)
        self._hf = fir_to_freq(self._fir, self.block_size)
        self._hf_span.clear()

    def reset(self) -> None:
        self._carry = jnp.zeros_like(self._carry)

    def __call__(self, sound, mix):
        out, self._carry = hrtf_mix_block(sound, self._hf, self._carry,
                                          block_size=self.block_size)
        return out

    def process_span(self, sound) -> jax.Array:
        """[O, N] whole-span sound -> [N, C] binaural mix (hrtf_mix_span).

        The engine detects this method and keeps the span dispatch even
        with a post-mix installed (StreamingEngine._synth_once): one
        length-2N FFT mix instead of N/S per-block FFT triples. The carry
        is shared with the per-block path, so a stream may interleave
        both (e.g. a qnorm block between spans) without a seam."""
        n = int(sound.shape[-1])
        hf = self._hf_span.get(n)
        if hf is None:
            hf = jnp.asarray(np.fft.rfft(self._fir, n=2 * n, axis=-1),
                             jnp.complex64)
            self._hf_span[n] = hf
        out, self._carry = hrtf_mix_span(sound, hf, self._carry,
                                         n_samples=n)
        return out


class HRTFRenderer:
    """Binaural post-renderer over a ModalSession.

    Wraps a session whose ``sound`` output is per-object mono; applies the
    spherical-head HRTF for each object's direction relative to the
    listener. Use instead of the session's built-in gains mixdown::

        r = HRTFRenderer(session, positions)   # [O, 3] object centers
        r.set_listener(np.array([1.0, 0.0, 0.5]))
        session.hit(0, space)
        stereo = r.render(num_blocks)          # [N*S, 2]

    The session's own FFAT transfer still shapes per-mode magnitudes (it is
    part of ``sound``); the HRTF adds the interaural time/shadow cues the
    transfer maps cannot express. One extra device dispatch per block.
    """

    def __init__(self, session, positions: np.ndarray, *,
                 ear_axis=(1.0, 0.0, 0.0),
                 head_radius: float = DEFAULT_HEAD_RADIUS,
                 n_taps: int = DEFAULT_TAPS):
        self.session = session
        self.positions = np.asarray(positions, np.float64)
        if self.positions.shape != (session.bank.num_objects, 3):
            raise ValueError("positions must be [num_objects, 3]")
        self.ear_axis = ear_axis
        self.head_radius = head_radius
        self.n_taps = min(n_taps, session.config.block_size + 1)
        self._carry = jnp.zeros((2, self.n_taps - 1), jnp.float32)
        self._hf = None
        self.set_listener(np.zeros(3))

    def set_listener(self, pos: np.ndarray) -> None:
        """Move the listener: updates the session's FFAT transfer AND the
        per-object HRTF filters (directions are listener-relative)."""
        pos = np.asarray(pos, np.float64)
        self.session.set_listener(pos)
        fir = spherical_hrtf_fir(self.positions - pos[None, :],
                                 ear_axis=self.ear_axis,
                                 head_radius=self.head_radius,
                                 n_taps=self.n_taps)
        self._hf = fir_to_freq(fir, self.session.config.block_size)

    def step(self) -> jax.Array:
        """One block -> [S, 2] float32 binaural mix."""
        sound, _, _ = self.session.step()
        mix, self._carry = hrtf_mix_block(
            sound, self._hf, self._carry,
            block_size=self.session.config.block_size)
        return mix

    def render(self, num_blocks: int) -> np.ndarray:
        out = [np.asarray(self.step()) for _ in range(num_blocks)]
        return np.concatenate(out, axis=0)
