"""Physical Doppler for moving listeners — time-varying propagation delay.

Beyond-reference: the reference recomputes the acoustic transfer when the
listener moves but applies NO propagation delay — each block plays as if
sound reached the listener instantly (modal_solver.h:286-300,
ffat_solver.h:1180-1214 evaluate amplitude only). For a listener moving at
velocity v relative to a source, the physically received signal is

    y(t) = s(t - r(t)/c)

and the time-varying delay IS the Doppler effect: a radial approach speed v
compresses the received phase by the factor (1 + v/c). The amplitude-vs-
distance part is already handled per block by the FFAT transfer (|Psi/kr|
falls off with the listener radius), so the delay is the one missing
physical term.

Implementation: the session renders each object's raw signal s_o[n] over
the span (solver.step_multi_transfers_sound), the host builds per-sample
listener-object distances by linear interpolation of the per-block
positions, and ``delay_resample`` gathers s_o at the fractional sample
index n - r_o[n] * SR / c (linear interpolation between neighbors — first
order, like the per-sample transfer ramp). Samples whose emission time
precedes the render start are silence (the wavefront has not arrived).
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from ..config import OUTPUT_SCALE, SAMPLE_RATE, SOUND_SPEED
from .integrator import PRECISION


@jax.jit
def delay_resample(
    sound: jax.Array,      # [O, N] raw per-object signal (emission time)
    i0: jax.Array,         # [O, N] int32 floor(n - delay_n) source index
    frac: jax.Array,       # [O, N] fractional part of (n - delay_n)
    gains: jax.Array,      # [O, C] channel gains
) -> jax.Array:
    """Fractional-delay gather + channel mixdown -> mix [N, C].

    y_o[n] = s_o[n - delay_o[n]] by linear interpolation; n - delay < 0
    reads silence (signal emitted before the render started). The mixdown
    applies the reference's 1/1E10 output scale like solver._mixdown.

    (i0, frac) come from :func:`delay_indices` — the absolute index
    n - delay MUST be split on the float64 host: an f32 index grid loses
    fractional resolution past ~2^23/8 samples (~24 s of audio) and
    collapses to whole-sample steps past ~3 minutes, turning a smooth
    Doppler shift into zipper artifacts.
    """
    o, n = sound.shape
    frac = frac.astype(sound.dtype)
    take = lambda i: jnp.take_along_axis(  # noqa: E731
        sound, jnp.clip(i, 0, n - 1), axis=-1)
    y = (take(i0) * (1.0 - frac) * (i0 >= 0)
         + take(i0 + 1) * frac * (i0 + 1 >= 0))
    mix = jnp.einsum("on,oc->nc", y, gains, precision=PRECISION)
    return (mix / OUTPUT_SCALE).astype(jnp.float32)


def delay_indices(dist, c: float = SOUND_SPEED,
                  sample_rate: int = SAMPLE_RATE):
    """Host-side (float64) split of the fractional source index.

    ``dist``: [O, N] float64 distances -> (i0 int32, frac float32) with
    i0 + frac == n - dist * SR / c computed at full double precision
    (see delay_resample's precision note).
    """
    dist = np.asarray(dist, np.float64)
    n = dist.shape[-1]
    idx = np.arange(n, dtype=np.float64)[None, :] - dist * (sample_rate / c)
    i0 = np.floor(idx)
    frac = (idx - i0).astype(np.float32)
    return i0.astype(np.int32), frac


@jax.jit
def _doppler_mix_multi(hist, sound, d0, d1, gains):
    """Per-listener live delay lines (per-client serving + live Doppler).

    ``hist`` [O, L, H], ``sound`` [O, L, N] — the chunked span's
    multi-listener layout (ops/span.py::_integrate_span_chunked: listener
    axis INSIDE, what the per-object contractions produce contiguously).
    Listener l's
    channel gathers each object's signal AS HEARD BY l (the sound row
    already carries l's transfer amplitude) at l's own retarded time;
    delays ramp d0 -> d1 per (object, listener). Returns
    (mix [N, L] — one mono column per listener, the per-client layout —
    and the new hist)."""
    o, l, n = sound.shape
    h = hist.shape[-1]
    buf = jnp.concatenate([hist, sound], axis=-1)        # [O, L, H+N]
    t = jnp.arange(n, dtype=sound.dtype)
    d = d0[..., None] + (d1 - d0)[..., None] * ((t + 1.0) / n)
    idx = h + t[None, None, :] - d                       # [O, L, N]
    i0 = jnp.floor(idx).astype(jnp.int32)
    frac = (idx - i0.astype(idx.dtype)).astype(sound.dtype)
    take = lambda i: jnp.take_along_axis(  # noqa: E731
        buf, jnp.clip(i, 0, h + n - 1), axis=-1)
    y = take(i0) * (1.0 - frac) + take(i0 + 1) * frac
    mix = jnp.einsum("oln,ol->nl", y, gains, precision=PRECISION)
    return (mix / OUTPUT_SCALE).astype(jnp.float32), buf[..., -h:]


@jax.jit
def _doppler_mix(hist, sound, d0, d1, gains):
    """One dispatch of the LIVE fractional delay-line (DopplerPostMix).

    ``hist`` [O, H] is the tail of previously-synthesized samples (the
    delay line); ``sound`` [O, N] the new span/block. Each object's delay
    ramps linearly from d0 to d1 samples across the N outputs — the ramp
    IS the Doppler shift (d(delay)/dt = -v/c compresses the phase by
    1 + v/c). Index math runs in f32 on device: unlike the offline path's
    absolute sample index (see delay_resample), buffer-relative indices
    are bounded by H+N (~10^4), where f32 still resolves ~1e-3 of a
    sample. Returns (mix [N, C], new_hist [O, H]).
    """
    o, n = sound.shape
    h = hist.shape[-1]
    buf = jnp.concatenate([hist, sound], axis=-1)        # [O, H+N]
    t = jnp.arange(n, dtype=sound.dtype)
    d = d0[:, None] + (d1 - d0)[:, None] * ((t + 1.0) / n)
    idx = h + t[None, :] - d                             # [O, N]
    i0 = jnp.floor(idx).astype(jnp.int32)
    frac = (idx - i0.astype(idx.dtype)).astype(sound.dtype)
    take = lambda i: jnp.take_along_axis(  # noqa: E731
        buf, jnp.clip(i, 0, h + n - 1), axis=-1)
    y = take(i0) * (1.0 - frac) + take(i0 + 1) * frac
    mix = jnp.einsum("on,oc->nc", y, gains, precision=PRECISION)
    return (mix / OUTPUT_SCALE).astype(jnp.float32), buf[:, -h:]


class DopplerPostMix:
    """StreamingEngine ``post_mix`` hook: LIVE physical Doppler.

    A per-object fractional delay-line fed by listener-move events makes
    render_doppler's physics available in streaming mode (round-2 VERDICT
    item 7; the offline form is session.render_doppler). Each applied
    listener event retargets every object's propagation delay r_o/c; the
    next dispatch ramps the delay there across its samples, which IS the
    Doppler shift of the move's radial velocity. Amplitude-vs-distance
    stays with the session's FFAT transfer, exactly as offline.

    Implements both post-mix entries (per-block ``__call__`` and
    ``process_span``), so Doppler streams ride the engine's span
    dispatches. The delay line is zero-initialized: samples whose
    emission time precedes the stream start are silent (the wavefront
    has not arrived).
    """

    def __init__(self, positions: np.ndarray, *, gains=None,
                 c: float = SOUND_SPEED, max_distance: float = 20.0,
                 sample_rate: int = SAMPLE_RATE, dtype=jnp.float32,
                 num_listeners: int = 1):
        """``positions``: [O, 3] object centers (world frame);
        ``max_distance`` bounds the delay line (meters).

        ``num_listeners`` = L > 1 is the per-client-listener serving
        mode: the span feeds per-listener sound [O, L, N] and each
        (object, listener) pair gets its OWN delay line — listener
        events carry [L, 3] world rows (the server's merged latest-wins
        per-client moves), the mix is [N, L] per-client columns, and
        ``gains`` is [O, L]."""
        # explicit COPY: _run and set_position mutate this in place (the
        # live audio-clock positions; server code reads pm.positions as
        # the source of truth). asarray would alias a float64 ndarray
        # input and silently drift the CALLER's array as objects move.
        self.positions = np.array(positions, np.float64)
        o = self.positions.shape[0]
        ll = int(num_listeners)
        self._nl = ll
        self._sr = float(sample_rate)
        self._scale = sample_rate / float(c)
        h = int(np.ceil(max_distance * self._scale)) + 2
        self._hist = (jnp.zeros((o, h), dtype) if ll == 1
                      else jnp.zeros((o, ll, h), dtype))
        self._h_max = float(h - 2)
        # per-object world velocities (object_vel events): integrated on
        # the AUDIO clock, one position step per dispatch, so a constant
        # radial velocity yields an exactly constant delay ramp rate —
        # i.e. a constant Doppler factor 1 + v/c — independent of
        # wall-clock jitter in the synth thread. Written from the network
        # thread, read on the synth thread (latest-wins, like positions).
        self.velocities = np.zeros((o, 3))
        if gains is not None:
            self.gains = jnp.asarray(gains, dtype)
        else:
            self.gains = (jnp.ones((o, 2), dtype) if ll == 1
                          else jnp.ones((o, ll), dtype))
        self._d_cur = np.zeros(o if ll == 1 else (o, ll))
        self._d_tgt = np.zeros_like(self._d_cur)
        self.on_listener(np.zeros(3) if ll == 1 else np.zeros((ll, 3)))
        self._d_cur = self._d_tgt.copy()   # start settled (no initial chirp)

    def on_listener(self, pos: np.ndarray) -> None:
        """One world listener [3], or — per-client mode — the merged
        [L, 3] per-client rows (a [3] event moves ALL listeners there)."""
        pos = np.asarray(pos, np.float64)
        if self._nl > 1 and pos.ndim == 1:
            pos = np.broadcast_to(pos, (self._nl, 3))
        self._last_listener = pos.copy()
        if self._nl > 1:
            # [O, L] per-(object, listener) propagation delays
            r = np.linalg.norm(self.positions[:, None, :]
                               - pos[None, :, :], axis=-1)
        else:
            r = np.linalg.norm(self.positions - pos, axis=-1)
        self._d_tgt = np.minimum(r * self._scale, self._h_max)

    def set_velocity(self, obj: int, vel: np.ndarray) -> None:
        """Give ONE object a constant world velocity (the server's
        ``object_vel`` command). Every subsequent dispatch advances that
        object's position by v * (N / sample_rate) BEFORE retargeting its
        delay, so the per-dispatch delay ramp carries the motion's exact
        Doppler shift without any per-frame client traffic. Zero velocity
        stops the motion (position stays where it integrated to)."""
        self.velocities[int(obj)] = np.asarray(vel, np.float64).reshape(3)

    def set_position(self, obj: int, world_pos: np.ndarray) -> None:
        """Move ONE object (live object motion, Scene.move_object /
        the server's object_pos command): retargets that object's delay
        from the remembered listener, so the next dispatch's ramp carries
        the object's own Doppler shift."""
        self.positions[obj] = np.asarray(world_pos, np.float64)
        self.on_listener(self._last_listener)

    def reset(self) -> None:
        self._hist = jnp.zeros_like(self._hist)
        self._d_cur = self._d_tgt.copy()

    def _run(self, sound):
        if self.velocities.any():
            # audio-clock kinematics: this dispatch covers N samples of
            # stream time; move first, then retarget, so the delay ramps
            # from r(t)/c to r(t + N/SR)/c across exactly those samples
            self.positions += self.velocities * (sound.shape[-1] / self._sr)
            self.on_listener(self._last_listener)
        d0 = jnp.asarray(self._d_cur, sound.dtype)
        d1 = jnp.asarray(self._d_tgt, sound.dtype)
        if self._nl > 1:
            if sound.ndim != 3:
                raise ValueError(
                    f"per-client Doppler needs multi-listener per-object "
                    f"sound ([O, L, N] span / [L, O, S] block), got "
                    f"{sound.shape}")
            mix, self._hist = _doppler_mix_multi(self._hist, sound, d0, d1,
                                                 self.gains)
        else:
            mix, self._hist = _doppler_mix(self._hist, sound, d0, d1,
                                           self.gains)
        self._d_cur = self._d_tgt.copy()
        return mix

    def __call__(self, sound, mix):
        # per-BLOCK entry: the multi-listener block step emits [L, O, S]
        # (listener axis OUTSIDE — solver.step_block* vmap layout), vs the
        # span's [O, L, N]; normalize to the span layout the delay lines
        # carry
        if self._nl > 1 and sound.ndim == 3:
            sound = jnp.swapaxes(sound, 0, 1)
        return self._run(sound)

    def process_span(self, sound):
        return self._run(sound)


def sample_distances(
    positions,             # [T, O, 3] per-block listener-relative positions
    block_size: int,
):
    """Per-sample listener-object distances [O, T*S] (host, float64).

    Block t's position row is the listener at that block's START sample;
    distances are linearly interpolated between consecutive block starts
    and held constant through the final block (matching the block-constant
    tail of the transfer schedule).
    """
    positions = np.asarray(positions, np.float64)
    t, o, _ = positions.shape
    r = np.linalg.norm(positions, axis=-1)        # [T, O]
    n = t * block_size
    starts = np.arange(t) * block_size
    grid = np.arange(n)
    out = np.empty((o, n))
    for i in range(o):
        out[i] = np.interp(grid, starts, r[:, i])  # holds past the last row
    return out

