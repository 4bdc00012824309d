"""ModalSession — host-side control surface over the device solver.

Plays the role of the reference's message-queue API around ModalSolver
(modal_solver.h:165-178): hits become force-slot writes, listener moves become
transfer recomputes, sustained start/end and AR-parameter updates flip the
sustained channel — all as *data* updates against static shapes, so the jitted
block step never recompiles.

Slot lifecycle is tracked host-side (a slot's productive lifetime is a pure
function of its start sample, ops/forces.py), mirroring the reference's
erase-on-exhaustion (modal_solver.h:210-221): an expired slot is recyclable.
If all slots are busy the oldest is overwritten (the reference's force queue
drops sends when full, modal_solver.h:330-333).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_BLOCK, REBASE_PERIOD, UNIT_TRANSFER
from ..ops.coeffs import ModalBank
from ..ops.ffat import FFATMaps, compute_transfer
from ..ops.forces import FORCE_GAUSSIAN, FORCE_POINT, ForceSlots
from .solver import (SolverConfig, decay_block, default_gains, step_block,
                     step_block_xfade)
from .state import make_solver_state


@partial(jax.jit, donate_argnames=("slots",))
def _write_slot(slots: ForceSlots, obj: jax.Array, slot: jax.Array,
                ftype: jax.Array, t0: jax.Array, width: jax.Array,
                amp: jax.Array, space: jax.Array) -> ForceSlots:
    return ForceSlots(
        ftype=slots.ftype.at[obj, slot].set(ftype),
        t0=slots.t0.at[obj, slot].set(t0),
        width=slots.width.at[obj, slot].set(width),
        amp=slots.amp.at[obj, slot].set(amp),
        space=slots.space.at[obj, slot].set(space),
    )


@partial(jax.jit, donate_argnames=("state",))
def _rebase_clock(state, delta: jax.Array):
    """Shift the device time origin by ``delta`` samples (block-aligned).

    block_start and slot t0 are int32 on device; a continuous stream would
    wrap at 2^31 samples (~13.5 h at 44.1 kHz). The session re-zeroes the
    device clock every REBASE_PERIOD samples instead; expired slots whose
    shifted t0 would keep drifting negative are clamped (their ``producing``
    predicate is already false forever, so the clamp is output-invariant).
    """
    slots = state.slots
    return dataclasses.replace(
        state,
        block_start=state.block_start - delta,
        slots=dataclasses.replace(
            slots, t0=jnp.maximum(slots.t0 - delta, -(1 << 30))))


# REBASE_PERIOD (re-exported from config.py above): the device clock
# re-zeroes after ~6.7 h of audio, with 2x headroom before int32 wrap
# even if a rebase is missed for another full period. It lives in
# config.py because the sustained noise counter
# (ops/forces._noise_for_blocks) wraps modulo the same period.


@partial(jax.jit, donate_argnames=("slots",))
def _clear_slots(slots: ForceSlots, objs: jax.Array) -> ForceSlots:
    """Deactivate every slot of the given object rows (``objs``: [K])."""
    return ForceSlots(
        ftype=slots.ftype.at[objs].set(0),
        t0=slots.t0,
        width=slots.width,
        amp=slots.amp,
        space=slots.space,
    )


class ModalSession:
    """A batch of sounding objects driven block-by-block.

    ``bank`` holds O objects x M modes; ``ffat`` is optional (unit transfer
    when absent or when ``use_transfer`` is off, modal_solver.h:249-255).
    """

    def __init__(
        self,
        bank: ModalBank,
        ffat: FFATMaps | None = None,
        config: SolverConfig | None = None,
        num_slots: int = 16,
        seed: int = 0,
        dtype=jnp.float32,
        lam64: np.ndarray | None = None,
        num_listeners: int = 1,
    ):
        """``lam64``: the float64 complex eigenvalues the bank was built
        from (lambda_from_modes), [M] or [O, M]. Optional; when present the
        session can build span tables (ops/span.py) and render_multi takes
        the one-dispatch span path instead of the per-block scan.

        ``num_listeners`` > 1 switches to shared-state multi-listener
        rendering: ONE [O, M] oscillator state with [L, O, M] transfer rows
        and one output channel per listener (sound is linear in the
        transfer, so each extra listener costs only a mode-reduce — not the
        L-fold state/force replication of building L copies of each
        object). Listener moves pass [L, 3] (or [L, O, 3]) positions."""
        self.bank = bank
        self.ffat = ffat
        self._lam64 = (None if lam64 is None
                       else np.atleast_2d(np.asarray(lam64, np.complex128)))
        self._span_cache: dict[int, object] = {}
        self.config = config or SolverConfig()
        o, m = bank.num_objects, bank.num_modes
        self.num_listeners = int(num_listeners)
        # recorded in exported timelines: sustained-drag noise is a pure
        # function of (per-object base keys from this seed, block index),
        # so a bake seeded identically replays drags deterministically
        self.seed = int(seed)
        self.state = make_solver_state(
            o, m, num_slots=num_slots, seed=seed, dtype=dtype,
            num_listeners=self.num_listeners)
        if self.num_listeners > 1:
            self.gains = jnp.ones((o, self.num_listeners), dtype)
        else:
            self.gains = default_gains(o, dtype)
        self.use_transfer = ffat is not None
        # compressed-vs-raw Psi selection for transfer queries
        # (GetMapVal(pos, useCompressed), ffat_solver.h:1180-1214)
        self.use_compressed = False
        self._dtype = dtype
        # host mirror for slot recycling: absolute expiry sample per slot
        self._expiry = np.zeros((o, num_slots), np.int64)
        self._t0 = np.zeros((o, num_slots), np.int64)
        self._last_listener: np.ndarray | None = None
        # host mirrors of the sample clock and sustained activity, so the
        # idle test (decay fast path) never syncs with the device
        self._clock = 0
        # device time origin: device block_start == _clock - _clock_base
        # (rebased periodically so the int32 device clock never wraps)
        self._clock_base = 0
        self._sus_active = np.zeros((o,), bool)
        # host mirror of the per-object AR(2) coefficients (default matches
        # make_sustained_state) — source for the sustained-span impulse
        # tables; _ar_g caches the device-cast tables (keyed by length)
        # until a retune
        self._ar_host = np.tile(np.asarray([[0.783, 0.116]]), (o, 1))
        self._ar_g = {}
        # transfer row before the latest listener move, pending an
        # interpolated block (smooth_transfer)
        self._xfade_from = None
        # optional world->session coordinate transform applied to every
        # incoming listener position (Scene installs one so engine/server
        # listener events are scene-correct: the session's native frame is
        # per-object relative, the world has object positions)
        self.listener_frame = None
        # multi-listener sessions with lam64: derive per-mode ITD phases
        # from the listener geometry on every move (set_listener_relative)
        self.auto_itd = False

    # ------------------------------------------------------------------ events

    @property
    def sample_clock(self) -> int:
        """Host mirror of state.block_start (no device sync); advanced by
        step()/render_multi() and refreshed by checkpoint restores."""
        return self._clock

    def _alloc_slot(self, obj: int) -> int:
        now = self.sample_clock
        free = np.nonzero(self._expiry[obj] <= now)[0]
        if free.size:
            return int(free[0])
        return int(np.argmin(self._t0[obj]))  # overwrite the oldest

    def hit(self, obj: int, space: np.ndarray, *,
            kind: str = "point", width_us: float = 100.0,
            amp: float = 1.0, when: int | None = None) -> None:
        """Strike object ``obj`` with modal amplitudes ``space`` [M_audible].

        ``kind``: 'point' (unit impulse), 'gaussian' (width in microseconds,
        converted to samples as in forces.h:42-46), or 'hertz' (width =
        contact duration in microseconds). The profile starts at the
        beginning of the *next* block, like a dequeued ForceMessage.

        ``when``: optional absolute block-aligned sample index >= the
        current clock — a future-dated hit fires at the right block inside
        a later multi-block/span dispatch (slot lifetimes are pure
        functions of the sample clock), letting offline renders schedule a
        whole impact train up front and stay at one dispatch per chunk.
        """
        from ..config import SAMPLE_RATE
        m = self.bank.num_modes
        vec = np.zeros((m,), np.float64)
        space = np.asarray(space, np.float64).ravel()
        vec[: min(space.size, m)] = space[: m]
        from ..ops.forces import FORCE_HERTZ, slot_duration
        if kind == "point":
            ftype, width = FORCE_POINT, 1.0
        elif kind == "gaussian":
            ftype = FORCE_GAUSSIAN
            width = max(1, int(width_us / 1e6 * SAMPLE_RATE))
        elif kind == "hertz":
            ftype = FORCE_HERTZ
            width = max(1, int(width_us / 1e6 * SAMPLE_RATE))
        else:
            raise ValueError(f"unknown force kind {kind!r}")
        dur = slot_duration(ftype, width, self.config.block_size)
        slot = self._alloc_slot(obj)
        t0 = self.sample_clock
        if when is not None:
            if when < t0 or when % self.config.block_size:
                raise ValueError(
                    f"when={when} must be a block-aligned sample >= the "
                    f"current clock {t0}")
            t0 = int(when)
        t0_dev = t0 - self._clock_base   # device time is origin-rebased
        self.state = dataclasses.replace(
            self.state,
            slots=_write_slot(
                self.state.slots,
                jnp.asarray(obj, jnp.int32), jnp.asarray(slot, jnp.int32),
                jnp.asarray(ftype, jnp.int32), jnp.asarray(t0_dev, jnp.int32),
                jnp.asarray(float(width), self._dtype),
                jnp.asarray(amp, self._dtype),
                jnp.asarray(vec, self._dtype)))
        self._t0[obj, slot] = t0
        self._expiry[obj, slot] = t0 + dur

    def clear_forces(self, obj: int | None = None) -> None:
        """Drop all active forces (clearAllForces, modal_solver.h:186-189)."""
        objs = np.arange(self.bank.num_objects) if obj is None else [obj]
        # one vectorized scatter for any number of objects (a per-object
        # loop costs one device dispatch each)
        slots = _clear_slots(self.state.slots,
                             jnp.asarray(np.asarray(objs), jnp.int32))
        self._expiry[np.asarray(objs)] = 0
        sus = dataclasses.replace(
            self.state.sustained,
            active=self.state.sustained.active.at[np.asarray(objs)].set(False))
        self.state = dataclasses.replace(self.state, slots=slots,
                                         sustained=sus)
        self._sus_active[np.asarray(objs)] = False

    def sustained_start(self, obj: int, space: np.ndarray) -> None:
        """Begin a sustained AR contact (modal_solver.h:190-194)."""
        m = self.bank.num_modes
        vec = np.zeros((m,), np.float64)
        space = np.asarray(space, np.float64).ravel()
        vec[: min(space.size, m)] = space[: m]
        sus = self.state.sustained
        self.state = dataclasses.replace(
            self.state,
            sustained=dataclasses.replace(
                sus,
                active=sus.active.at[obj].set(True),
                space=sus.space.at[obj].set(
                    jnp.asarray(vec, self._dtype)),
                ar_hist=sus.ar_hist.at[obj].set(0.0)))
        self._sus_active[obj] = True

    def sustained_update(self, obj: int, space: np.ndarray) -> None:
        """Live-update the sustained force direction (modal_solver.h:197-199)."""
        m = self.bank.num_modes
        vec = np.zeros((m,), np.float64)
        space = np.asarray(space, np.float64).ravel()
        vec[: min(space.size, m)] = space[: m]
        sus = self.state.sustained
        self.state = dataclasses.replace(
            self.state,
            sustained=dataclasses.replace(
                sus, space=sus.space.at[obj].set(
                    jnp.asarray(vec, self._dtype))))

    def sustained_end(self, obj: int) -> None:
        sus = self.state.sustained
        self.state = dataclasses.replace(
            self.state,
            sustained=dataclasses.replace(
                sus, active=sus.active.at[obj].set(False)))
        self._sus_active[obj] = False

    def set_ar_params(self, obj: int, a=(0.783, 0.116), sigma=0.00148,
                      mu=0.142) -> None:
        """Retune the AR(2) model live (forces.h:130-137; resets history).

        Rejects unstable tunings (characteristic root magnitude >= 1)
        before mutating anything — see ops/forces.ar_stability_radius."""
        from ..ops.forces import ar_stability_radius
        radius = ar_stability_radius(a)
        if not (radius < 1.0):   # NaN-safe: rejects radius >= 1 AND nan
            raise ValueError(
                f"unstable AR(2) tuning a={tuple(float(v) for v in a)}: "
                f"characteristic root magnitude {radius:.4f} >= 1 (the "
                f"impulse tables would overflow)")
        sus = self.state.sustained
        self.state = dataclasses.replace(
            self.state,
            sustained=dataclasses.replace(
                sus,
                a=sus.a.at[obj].set(jnp.asarray(a, self._dtype)),
                sigma=sus.sigma.at[obj].set(sigma),
                mu=sus.mu.at[obj].set(mu),
                ar_hist=sus.ar_hist.at[obj].set(0.0)))
        # keep the host AR mirror in sync: the sustained-span impulse table
        # (ops/forces.py::ar_impulse_g) is host-built from these params.
        # The cached device tables depend ONLY on a — a sigma/mu-only
        # retune must not force a full per-object table rebuild + upload
        # on the synthesis thread (the 256-object table is ~16 MB)
        a64 = np.asarray(a, np.float64)
        if not np.array_equal(self._ar_host[obj], a64):
            self._ar_host[obj] = a64
            self._ar_g = {}

    def set_listener(self, pos: np.ndarray) -> None:
        """Update acoustic transfer for a listener at ``pos``.

        ``pos``: [3] world position (shared) or [O, 3] per object. Equivalent
        to computeTransfer + the capacity-1 latest-wins trans queue
        (modal_solver.h:286-300: per mode |GetMapVal|). A session-level
        ``listener_frame`` transform (installed by Scene) maps world
        positions into the session's per-object relative frame first;
        callers that already have relative positions (Scene internals)
        use :meth:`set_listener_relative`.
        """
        if self.listener_frame is not None:
            pos = self.listener_frame(np.asarray(pos, np.float64))
        self.set_listener_relative(pos)

    def set_listener_relative(self, pos: np.ndarray) -> None:
        """set_listener in the session's native (per-object relative)
        frame, bypassing any installed ``listener_frame``."""
        self._last_listener = np.asarray(pos, np.float64)
        if self.ffat is None or not self.use_transfer:
            return
        pos = jnp.asarray(pos, self._dtype)
        o = self.bank.num_objects
        if self.num_listeners > 1:
            # [3] -> all listeners at one spot; [L, 3] -> per listener;
            # [L, O, 3] -> per listener per object
            if pos.ndim == 1:
                pos = jnp.broadcast_to(pos, (self.num_listeners, 3))
            if pos.ndim == 2:
                if pos.shape != (self.num_listeners, 3):
                    raise ValueError(
                        f"expected [{self.num_listeners}, 3] listener "
                        f"positions, got {pos.shape}")
                pos = jnp.broadcast_to(pos[:, None, :],
                                       (self.num_listeners, o, 3))
            transfer = jax.vmap(
                lambda p: compute_transfer(
                    self.ffat, p,
                    compressed=self.use_compressed))(pos)  # [L, O, M]
        else:
            if pos.ndim == 1:
                pos = jnp.broadcast_to(pos, (o, 3))
            transfer = compute_transfer(self.ffat, pos,
                                        compressed=self.use_compressed)
        if self.config.smooth_transfer and self._xfade_from is None:
            # remember the outgoing rows (re AND im: a complex row ramps
            # both channels); the next block ramps to the new one
            # (repeated moves within one block keep the oldest start)
            self._xfade_from = (self.state.transfer, self.state.transfer_im)
        if self.state.transfer_im is not None:
            # FFAT lookups are magnitude-only; a previously installed
            # complex row's phase must not survive the move (auto_itd
            # reinstalls a fresh phase below)
            self.state = dataclasses.replace(self.state, transfer_im=None)
        transfer = transfer.astype(self._dtype)
        if (self.auto_itd and self.num_listeners > 1
                and self._lam64 is not None and pos.ndim == 3):
            # interaural time differences from the geometry: listener l
            # hears object o delayed by (r_lo - min_l r_lo)/c relative to
            # the nearest ear; per-mode phase e^{-i theta_m d} IS that
            # delay for a narrowband mode (theta = omega_d * h, so d is
            # in samples; see set_complex_transfer)
            from ..config import SAMPLE_RATE, SOUND_SPEED
            r = np.linalg.norm(np.asarray(pos, np.float64), axis=-1)
            d = (r - r.min(axis=0, keepdims=True))                 * (SAMPLE_RATE / SOUND_SPEED)            # [L, O] samples
            theta = np.zeros((self.bank.num_objects, self.bank.num_modes))
            lam = (np.broadcast_to(self._lam64,
                                   (self.bank.num_objects,
                                    self._lam64.shape[-1]))
                   if self._lam64.shape[0] == 1 else self._lam64)
            theta[:, : lam.shape[-1]] = np.angle(lam)
            phase = jnp.asarray(theta[None] * d[:, :, None], self._dtype)
            self.state = dataclasses.replace(
                self.state,
                transfer=transfer * jnp.cos(phase),
                transfer_im=-transfer * jnp.sin(phase))
            return
        self.state = dataclasses.replace(self.state, transfer=transfer)

    def set_complex_transfer(self, t: np.ndarray) -> None:
        """Install a COMPLEX transfer ([O, M] or [L, O, M] complex array):
        the imaginary part applies per-mode PHASE — each mode is
        narrowband, so phase = a time shift at that mode's frequency,
        giving exact interaural time differences (and phase-accurate
        complex FFAT) on the blocked/scan/span fast paths at no extra
        matmul cost (ops/integrator._complex_weights).

        Beyond-reference: the reference's runtime map reconstructs
        magnitude only (|Psi|/kr, ffat_solver.h:899-906) even though its
        1-shell map stores complex Psi. Install BEFORE warmup/start (the
        complex row changes the jit signature); a later set_listener
        (magnitude-only FFAT lookup) clears the phase. With
        smooth_transfer on, a mid-stream install ramps both channels
        across the next block (complex xfade)."""
        t = np.asarray(t)
        if self.config.smooth_transfer and self._xfade_from is None:
            self._xfade_from = (self.state.transfer, self.state.transfer_im)
        self.state = dataclasses.replace(
            self.state,
            transfer=jnp.asarray(t.real, self._dtype),
            transfer_im=jnp.asarray(t.imag, self._dtype))

    def set_use_compressed(self, use: bool) -> None:
        """Runtime compressed-vs-raw FFAT toggle: select which Psi texture
        transfer queries sample (the reference keeps both and picks per
        query — TransMessage.useCompressed, modal_solver.h:84-98; live
        ImGui toggle real_time_modal_sound.cpp:835-853). Takes effect
        immediately by recomputing the transfer from the remembered
        listener position; zero rebuild (both textures are resident,
        DeviceFFAT.psi_c)."""
        use = bool(use)
        if use and (self.ffat is None or self.ffat.geom.psi_c is None):
            raise ValueError(
                "FFAT maps carry no compressed Psi set (build with "
                "build_ffat(compressed_maps=...))")
        if use == self.use_compressed:
            return
        self.use_compressed = use
        if (self.ffat is not None and self.use_transfer
                and self._last_listener is not None):
            self.set_listener_relative(self._last_listener)

    def set_use_transfer(self, use: bool) -> None:
        """Toggle FFAT transfer vs the 1E7 unit transfer
        (modal_solver.h:249-255)."""
        self.use_transfer = use and self.ffat is not None
        if not use:
            # the unit transfer is pure-real: a previously installed
            # complex row's phase term must clear too, or the "unit"
            # output would keep mixing im_old * Re(z)
            self.state = dataclasses.replace(
                self.state,
                transfer=jnp.full_like(self.state.transfer, UNIT_TRANSFER),
                transfer_im=None)
        elif self._last_listener is not None:
            # re-enable must take effect immediately (the reference's toggle
            # just resumes consuming computeTransfer results; here we
            # recompute from the remembered position, which is already in
            # the session's relative frame)
            self.set_listener_relative(self._last_listener)

    # ------------------------------------------------------------------ audio

    def _maybe_rebase(self) -> None:
        """Re-zero the device clock origin before int32 wrap (see
        _rebase_clock). Called at dispatch sites; cheap host compare.

        The subtraction is QUANTIZED to whole multiples of REBASE_PERIOD
        (never the raw delta): the device clock is therefore always
        ``absolute_clock mod REBASE_PERIOD`` at a dispatch start, no matter
        how the stream was chunked into dispatches. Together with the
        modular block index in ops/forces._noise_for_blocks this keeps the
        counter-derived sustained noise bit-identical between a live engine
        (block-sized dispatches) and a timeline bake (span-sized
        dispatches) even across the ~6.7 h rebase boundary (round-4
        advisor finding: an un-quantized rebase reset the noise counter at
        chunking-dependent positions, silently breaking replay for
        sessions longer than 2^30 samples)."""
        delta = self._clock - self._clock_base
        if delta >= REBASE_PERIOD:
            sub = (delta // REBASE_PERIOD) * REBASE_PERIOD
            self.state = _rebase_clock(self.state,
                                       jnp.asarray(sub, jnp.int32))
            self._clock_base += sub

    def decay_eligible(self) -> bool:
        """Whether this session can ever take the idle fast path: it needs
        the lam-power tables (blocked form) and a table-form backend, so a
        decay block is numerically the full step with zero excitation."""
        from ..ops.integrator import resolve_backend_name
        if not self.config.decay_fast_path:
            return False
        if (self.bank.pow_re is None
                or self.bank.pow_re.shape[-1] != self.config.block_size + 1):
            return False
        return resolve_backend_name(self.config.backend,
                                    self.bank) == "blocked"

    def _idle(self) -> bool:
        """True when the host mirrors prove the excitation is exactly zero:
        every force slot has expired and no sustained channel is active."""
        return (not self._sus_active.any()
                and bool((self._expiry <= self._clock).all()))

    def _step_decay(self):
        """Dispatch the homogeneous-only block (see solver.decay_block)."""
        self.state, sound, mix, qnorm = decay_block(
            self.state, self.bank, self.gains,
            block_size=self.config.block_size,
            compute_qnorm=self.config.compute_qnorm)
        self._clock += self.config.block_size
        return sound, mix, qnorm

    def step(self):
        """Synthesize one block; returns BlockOutput-like tuple.

        (sound [O,S] raw, mix [S,2] output-scaled stereo, qnorm or None)

        When the scene is provably idle (all slots expired, no sustained
        force) and the backend is table-form, dispatches the cheaper
        homogeneous-only decay step instead — same output, ~half the
        device work during ring-down. A pending smooth listener move
        (smooth_transfer) dispatches the transfer-ramping variant for one
        block and takes priority over the decay path.
        """
        self._maybe_rebase()
        if self._xfade_from is not None:
            prev, self._xfade_from = self._xfade_from, None
            return self._step_xfade(prev)
        if self._idle() and self.decay_eligible():
            return self._step_decay()
        return self._step_full()

    def _step_xfade(self, prev, with_sustained: bool | None = None,
                    num_slots: int | None | str = "auto"):
        """Dispatch the transfer-ramp block (see step()); warmup passes
        explicit variant flags so every reachable (sustained, slot-bucket)
        xfade executable compiles up front — a listener move during a
        sustained drag or a multi-hit burst must not hit a cold compile
        mid-stream. ``prev`` is the outgoing (re, im) row pair (im None
        for real rows; bare arrays are accepted for compatibility)."""
        prev_re, prev_im = (prev if isinstance(prev, tuple) else (prev, None))
        if with_sustained is None:
            with_sustained = self._with_sustained()
        if num_slots == "auto":
            num_slots = self._slot_bucket()
        self.state, sound, mix, qnorm = step_block_xfade(
            self.state, self.bank, self.gains, prev_re,
            block_size=self.config.block_size,
            backend=self.config.backend,
            compute_qnorm=self.config.compute_qnorm,
            with_sustained=with_sustained,
            num_slots=num_slots,
            transfer_prev_im=prev_im)
        self._clock += self.config.block_size
        return sound, mix, qnorm

    def _with_sustained(self) -> bool:
        """Static sustained flag from the host mirror: when every channel
        is inactive the 512-step serial AR(2) scan is dead work and the
        ungated step is bitwise identical (solver._step_block_impl)."""
        return bool(self._sus_active.any())

    def _step_full(self, with_sustained: bool | None = None,
                   num_slots: int | None | str = "auto"):
        """The host-gated full block step; warmup passes explicit variant
        flags so every dispatchable executable compiles up front."""
        if with_sustained is None:
            with_sustained = self._with_sustained()
        if num_slots == "auto":
            num_slots = self._slot_bucket()
        self.state, sound, mix, qnorm = step_block(
            self.state, self.bank, self.gains,
            block_size=self.config.block_size,
            backend=self.config.backend,
            compute_qnorm=self.config.compute_qnorm,
            with_sustained=with_sustained,
            num_slots=num_slots)
        self._clock += self.config.block_size
        return sound, mix, qnorm

    # ---------------------------------------------------------------- span

    def span_tables_for(self, n_blocks: int):
        """SpanTables for n_blocks*block_size samples (cached), or None
        when the session was built without lam64."""
        if self._lam64 is None:
            return None
        tables = self._span_cache.get(n_blocks)
        if tables is None:
            from ..ops.span import build_span_tables
            tables = build_span_tables(
                self._lam64, n_blocks * self.config.block_size,
                num_modes=self.bank.num_modes, dtype=self._dtype)
            self._span_cache[n_blocks] = tables
        return tables

    def _slot_bucket(self, ignore_sustained: bool = False) -> int | None:
        """Static per-slot work bound: the smallest configured bucket
        covering every live slot index (the host expiry mirror knows
        exactly which slots can still produce), or None for the full
        table. Buckets quantize the jit-variant count: each distinct
        value is one compiled executable (config.slot_buckets). On the
        PER-BLOCK path an active sustained channel uses the full table —
        it keeps the warmed variant matrix at (buckets + 1) x qnorm
        instead of the cross product. The span path passes
        ``ignore_sustained=True``: its sustained variants are warmed per
        bucket, and an unpruned 16-slot table on a long span is
        gigabytes of [O, K, N] force intermediates."""
        if self._sus_active.any() and not ignore_sustained:
            return None
        k = self.state.slots.num_slots
        live = self._expiry > self._clock
        need = (int(np.max(np.nonzero(live.any(axis=0))[0])) + 1
                if live.any() else 1)
        for b in sorted(set(self.config.slot_buckets)):
            if need <= b < k:
                return b
        return None  # full table (no extra jit variant)

    def _span_bucket(self, with_sustained: bool) -> int | None:
        """Slot bucket for a span dispatch. While a sustained drag is the
        only live excitation (every impact slot expired), the bucket is
        0: the AR channel becomes the span's single slot, so the per-slot
        span work (Toeplitz convs, injection gathers) matches the 1-slot
        impact headline instead of doubling it (solver._span_channels)."""
        if with_sustained and not (self._expiry > self._clock).any():
            return 0
        return self._slot_bucket(ignore_sustained=with_sustained)

    def span_eligible(self) -> bool:
        """The span path needs only the lam64 eigenvalues. Sustained AR(2)
        scenes ride it too since round 3: the AR recurrence is LTI, so it
        span-factors exactly like the oscillators did
        (ops/forces.py::sustained_span). A live arparam retune makes the
        AR tables per-object ([O, grp*S+1] capped at grp=32 plus the
        [O, S, S] noise Toeplitz — one extra ~270 MB HBM read at the
        north star, affordable since round 4), and warmup compiles the
        per-object variant for the drag-only bucket, so retuned drags
        ride the span too. The one remaining carve-out: an impact hit
        landing on ANOTHER object during a retuned drag needs a bucketed
        per-object variant warmup doesn't compile — those blocks fall
        back to the WARMED per-block sustained step until the hit
        expires (the dragged object's own slots are gated off by the
        reference's replace semantics either way, modal_solver.h:195)."""
        if self._lam64 is None:
            return False
        if self._with_sustained():
            a = self._ar_host
            if not (a == a[:1]).all() \
                    and (self._expiry > self._clock).any():
                return False
        return True

    # AR-table length policy for sustained_span's scan-free group
    # propagation (ops/forces.py::_companion_states): the table covers
    # grp blocks, shrinking the companion scan to n_blocks/grp steps.
    # Shared tunings cover the whole span (scan-free, tables are [1, L]);
    # per-object tunings cap at 32 blocks so a retuned 256-object table
    # stays ~16 MB instead of ~270 MB.
    AR_GROUP_CAP_SHARED = 512
    AR_GROUP_CAP_PER_OBJECT = 32

    def ar_span_table(self, n_blocks: int = 1,
                      force_per_object: bool = False) -> jax.Array:
        """Device AR impulse table [Og, grp*S+1] for sustained_span,
        rebuilt from the host AR mirror after a retune; Og=1 while every
        object keeps one shared tuning (the common case — one shared
        Toeplitz). ``n_blocks`` sizes the table for the span being
        dispatched (grp = largest divisor of n_blocks under the cap).
        ``force_per_object`` builds the [O, ...] layout even for uniform
        tunings — warmup uses it to compile the retuned-drag span
        variant before any retune happens."""
        from ..ops.forces import ar_impulse_g, span_group
        a = self._ar_host
        shared = bool((a == a[:1]).all()) and not force_per_object
        cap = (self.AR_GROUP_CAP_SHARED if shared
               else self.AR_GROUP_CAP_PER_OBJECT)
        grp = span_group(n_blocks, cap)
        length = grp * self.config.block_size
        key = (length, shared)
        tbl = self._ar_g.get(key)
        if tbl is None:
            tbl = jnp.asarray(
                ar_impulse_g(a[:1] if shared else a, length), self._dtype)
            self._ar_g[key] = tbl
        return tbl

    # force_span materializes [O, K, N]-shaped intermediates (per-slot
    # profiles, membership, f_k): cap K*N*O so a full 16-slot table on a
    # long offline span cannot transiently demand many GB of HBM (e.g.
    # 256 obj x 16 slots x 512-block span = 4.3 GB for f_k alone). Spans
    # above the cap fall back to the step_multi scan for that dispatch —
    # only reachable offline (live lookahead spans are far below it).
    SPAN_FORCE_BUDGET = 1 << 28

    def _step_span(self, n_blocks: int, num_slots: int | None | str = "auto",
                   idle: bool | None = None,
                   with_sustained: bool | None = None,
                   ar_per_object: bool = False):
        """Advance n_blocks via one span dispatch; returns device mix
        [n_blocks*S, C] (not host-synced). Caller checked span_eligible.
        ``num_slots``/``idle``/``with_sustained``/``ar_per_object``
        override the host gating (warmup)."""
        from .solver import decay_span_step, step_multi, step_span
        # the engine dispatches spans directly (without step()/render_multi
        # wrappers), so the int32 clock-wrap rebase must live here too
        self._maybe_rebase()
        if idle is None:
            idle = self._idle() and self.config.decay_fast_path
        if with_sustained is None:
            with_sustained = self._with_sustained()
        k_eff = (self._span_bucket(with_sustained)
                 if num_slots == "auto" else num_slots)
        num_slots = k_eff   # computed once; the dispatches below reuse it
        k = (self.state.slots.num_slots if k_eff is None else int(k_eff))
        if (not idle and k * n_blocks * self.config.block_size
                * self.bank.num_objects > self.SPAN_FORCE_BUDGET):
            self.state, mix = step_multi(
                self.state, self.bank, self.gains, n_blocks=n_blocks,
                block_size=self.config.block_size,
                backend=self.config.backend,
                with_sustained=with_sustained,
                num_slots=k_eff)
            self._clock += n_blocks * self.config.block_size
            return mix
        tables = self.span_tables_for(n_blocks)
        if idle:
            self.state, mix = decay_span_step(
                self.state, self.bank, tables, self.gains,
                n_blocks=n_blocks, block_size=self.config.block_size)
        else:
            self.state, mix = step_span(
                self.state, self.bank, tables, self.gains,
                n_blocks=n_blocks, block_size=self.config.block_size,
                num_slots=num_slots, with_sustained=with_sustained,
                ar_g=(self.ar_span_table(n_blocks, ar_per_object)
                      if with_sustained else None))
        self._clock += n_blocks * self.config.block_size
        return mix

    def _step_span_sound(self, n_blocks: int,
                         num_slots: int | None | str = "auto",
                         idle: bool | None = None,
                         with_sustained: bool | None = None,
                         ar_per_object: bool = False):
        """_step_span returning the raw per-object sound [O, N] (device,
        not host-synced) for span-shaped post-mix stages (HRTF). No
        SPAN_FORCE_BUDGET fallback: only the engine dispatches this, at
        lookahead-sized spans far below the budget."""
        from .solver import step_span_sound
        self._maybe_rebase()
        if idle is None:
            idle = self._idle() and self.config.decay_fast_path
        if with_sustained is None:
            with_sustained = self._with_sustained()
        k_eff = (self._span_bucket(with_sustained)
                 if num_slots == "auto" else num_slots)
        tables = self.span_tables_for(n_blocks)
        if idle:
            self.state, sound = step_span_sound(
                self.state, self.bank, tables, n_blocks=n_blocks,
                block_size=self.config.block_size, idle=True)
        else:
            self.state, sound = step_span_sound(
                self.state, self.bank, tables, n_blocks=n_blocks,
                block_size=self.config.block_size, num_slots=k_eff,
                with_sustained=with_sustained,
                ar_g=(self.ar_span_table(n_blocks, ar_per_object)
                      if with_sustained else None))
        self._clock += n_blocks * self.config.block_size
        return sound

    def qnorm_probe_eligible(self) -> bool:
        """The probe runs decay_block_blocked, which needs the lam-power
        tables; table-less (scan-only) banks cannot probe."""
        return self.bank.pow_re is not None

    def qnorm_probe(self):
        """Per-mode energy telemetry [O, M] of the CURRENT state over one
        ring-down block, WITHOUT advancing the stream.

        Lets the engine keep qnorm flowing while the audio itself rides
        span dispatches (breaking the span for an exact per-block qnorm
        costs a synced single-block round trip on the synthesis thread).
        The probe
        omits the in-flight force contribution of the probed block; the
        reference's qnorm channel is best-effort drop telemetry
        (modal_solver.h:272-273), so the HUD reads the ring-down energy
        one dispatch late — visually indistinguishable."""
        from ..ops.integrator import decay_block_blocked
        _, _, _, qnorm = decay_block_blocked(
            self.state.z_re, self.state.z_im, self.bank,
            self.state.transfer, True)
        return qnorm

    # -------------------------------------------------------------- warmup

    def warmup(self, *, qnorm: bool = False, post_mix=None,
               sustained: bool = True, span_blocks: tuple[int, ...] = (),
               ) -> None:
        """Compile every jit variant the steady-state loop can dispatch.

        A first compile takes seconds at the 256 x 1024 width, so a live
        stream must never hit an un-compiled executable. Variants are
        gated to ones that can actually fire for THIS session:

        - the full step for every slot bucket (sustained off), and the
          sustained-on variant (full slot table) when ``sustained`` —
          pass False for sessions that will never receive sustained events;
        - the decay step when the session is decay-eligible;
        - the transfer-ramp (xfade) step only when smooth_transfer is on
          AND an FFAT is present (without one the transfer never changes);
        - each of the above with compute_qnorm=True when ``qnorm``;
        - span dispatches for each length in ``span_blocks`` (engine
          lookahead) when the session has span tables;
        - the hit/clear slot-scatter kernels;
        - ``post_mix(sound, mix)`` when given (e.g. an HRTF stage; its
          ``reset()`` is called afterwards so the stream starts clean).

        The session's device state and host mirrors are snapshotted and
        fully restored: warmup synthesizes no observable audio and leaves
        the sample clock untouched.
        """
        import jax

        saved_state = self.state
        saved_clock = self._clock
        saved_base = self._clock_base
        # hit/clear donate the slot buffers, so keep a host copy to rebuild
        slots_np = jax.tree.map(np.asarray, self.state.slots)
        saved_expiry = self._expiry.copy()
        saved_t0 = self._t0.copy()
        saved_sus = self._sus_active.copy()
        saved_xfade = self._xfade_from
        saved_config = self.config
        saved_listener = self._last_listener
        try:
            if self.ffat is not None and self.use_transfer:
                # a live listener move dispatches compute_transfer on the
                # synthesis thread; compile it now (state.transfer is
                # restored below, so this changes nothing observable)
                o = self.bank.num_objects
                shape = ((o, 3) if self.num_listeners <= 1
                         else (self.num_listeners, o, 3))
                self.set_listener_relative(np.ones(shape))
                if self.ffat.geom.psi_c is not None:
                    # both Psi textures are live-toggleable
                    # (set_use_compressed); compile the other variant too
                    # so the toggle never stalls the stream on a compile
                    saved_comp = self.use_compressed
                    self.use_compressed = not saved_comp
                    self.set_listener_relative(np.ones(shape))
                    self.use_compressed = saved_comp
            self.hit(0, np.zeros(self.bank.num_modes), amp=0.0)
            self.clear_forces()
            k = self.state.slots.num_slots
            buckets = sorted({b for b in self.config.slot_buckets
                              if b < k}) + [None]
            variants = [(False, b) for b in buckets]
            if sustained:
                variants.append((True, None))
            qnorms = [False] + ([True] if qnorm else [])
            for q in qnorms:
                self.config = dataclasses.replace(self.config,
                                                  compute_qnorm=q)
                for ws, b in variants:
                    sound, mix, _ = self._step_full(with_sustained=ws,
                                                    num_slots=b)
                    if post_mix is not None and not q and ws is False \
                            and b is buckets[0]:
                        np.asarray(post_mix(sound, mix))
                    np.asarray(mix)  # the sync that forces the compile
                    if self.config.smooth_transfer and self.ffat is not None:
                        # a mid-stream listener move can dispatch the
                        # transfer-ramp step under ANY (sustained, bucket)
                        # variant; ramping from the current row to itself
                        # compiles each without changing the output
                        _, mix, _ = self._step_xfade(
                            (self.state.transfer, self.state.transfer_im),
                            with_sustained=ws, num_slots=b)
                        np.asarray(mix)
                if self.decay_eligible():
                    _, mix, _ = self._step_decay()
                    np.asarray(mix)
                pm_span = (post_mix is not None
                           and hasattr(post_mix, "process_span"))
                for n_blocks in span_blocks:
                    if q or not self.span_eligible():
                        continue

                    def span_once(**kw):
                        # with a span-capable post-mix the engine takes
                        # the sound-span + process_span pair; compile
                        # exactly that (otherwise the mix span)
                        if pm_span:
                            return post_mix.process_span(
                                self._step_span_sound(n_blocks, **kw))
                        return self._step_span(n_blocks, **kw)

                    for b in buckets:
                        np.asarray(span_once(num_slots=b, idle=False,
                                             with_sustained=False))
                    if sustained:
                        # a sustained drag rides the span too (round-3);
                        # its bucket tracks live slots, with bucket 0 for
                        # the steady-drag case (no live impact slot — the
                        # AR channel is the span's only slot, _span_bucket)
                        for b in [0] + buckets:
                            np.asarray(span_once(num_slots=b, idle=False,
                                                 with_sustained=True))
                        # the retuned-drag variant ([O, ...] AR tables,
                        # drag-only bucket): a live arparam retune must
                        # never cold-compile mid-stream (round-4)
                        np.asarray(span_once(num_slots=0, idle=False,
                                             with_sustained=True,
                                             ar_per_object=True))
                    if self.config.decay_fast_path:
                        np.asarray(span_once(idle=True))
        finally:
            self.config = saved_config
            self.state = dataclasses.replace(
                saved_state, slots=jax.tree.map(jnp.asarray, slots_np))
            self._clock = saved_clock
            self._clock_base = saved_base
            self._expiry[...] = saved_expiry
            self._t0[...] = saved_t0
            self._sus_active[...] = saved_sus
            self._xfade_from = saved_xfade
            self._last_listener = saved_listener
            if post_mix is not None and hasattr(post_mix, "reset"):
                post_mix.reset()

    def render(self, num_blocks: int) -> np.ndarray:
        """Offline render: [num_blocks * S, 2] stereo float32."""
        out = []
        for _ in range(num_blocks):
            _, mix, _ = self.step()
            out.append(np.asarray(mix))
        return np.concatenate(out, axis=0)

    def render_multi(self, num_blocks: int,
                     blocks_per_dispatch: int = 16) -> np.ndarray:
        """Offline render using multi-block device dispatch.

        Much faster than render() when per-dispatch overhead dominates;
        events already enqueued (hits with future t0) still fire at the
        correct sample inside the span. Sessions built with lam64 use the
        one-dispatch span path (ops/span.py); otherwise the step_multi
        scan.
        """
        from .solver import step_multi
        self._maybe_rebase()
        out = []
        done = 0
        if self._xfade_from is not None and num_blocks > 0:
            # flush the pending smooth listener move as a single step so the
            # span/scan starts from a settled transfer row
            _, mix, _ = self.step()
            out.append(np.asarray(mix))
            done += 1
        use_span = self.span_eligible()
        while done < num_blocks:
            n = min(blocks_per_dispatch, num_blocks - done)
            if use_span:
                mix = self._step_span(n)
            else:
                self.state, mix = step_multi(
                    self.state, self.bank, self.gains, n_blocks=n,
                    block_size=self.config.block_size,
                    backend=self.config.backend,
                    with_sustained=self._with_sustained(),
                    num_slots=self._slot_bucket())
                self._clock += n * self.config.block_size
            out.append(np.asarray(mix))
            done += n
        return np.concatenate(out, axis=0)

    def render_moving(self, positions: np.ndarray,
                      blocks_per_dispatch: int = 64,
                      smooth: bool | None = None) -> np.ndarray:
        """Offline render with a per-block listener path in chunked single
        dispatches (solver.step_multi_transfers).

        ``positions``: [T, 3] (shared listener) or [T, O, 3]; row t is the
        listener for block t (hold rows to move slower). Multi-listener
        sessions accept [T, 3] / [T, L, 3] / [T, L, O, 3] and return one
        output channel per listener. ``smooth`` ramps
        each block from the previous row (defaults to
        config.smooth_transfer). The whole moving-listener render is
        ceil(T / blocks_per_dispatch) dispatches — the reference's flow
        costs one transfer recompute + one block per move
        (modal_solver.h:286-300). Transfer rows are computed per
        dispatch chunk, so the working set is [bpd, (L,) O, M] however
        long the path is (a T=20k-block 256x1024 render would otherwise
        materialize ~10 GB of rows up front). Returns [T * S, C] float32.
        """
        from .solver import step_multi_transfers
        if self.ffat is None or not self.use_transfer:
            raise ValueError("render_moving needs an FFAT transfer "
                             "(build the session with ffat=...)")
        self._maybe_rebase()
        if smooth is None:
            smooth = self.config.smooth_transfer
        positions = self._moving_path(positions)
        t_total = positions.shape[0]
        if self._xfade_from is not None and smooth:
            # the pending move's outgoing row becomes the scan's carry
            # (real row only: render_moving is a magnitude-FFAT path)
            self.state = dataclasses.replace(self.state,
                                             transfer=self._xfade_from[0])
        self._xfade_from = None
        out = []
        done = 0
        while done < t_total:
            n = min(blocks_per_dispatch, t_total - done)
            rows = self._transfer_rows(positions[done:done + n])
            self.state, mix = step_multi_transfers(
                self.state, self.bank, self.gains, rows,
                n_blocks=n, block_size=self.config.block_size,
                backend=self.config.backend, smooth=smooth,
                with_sustained=self._with_sustained(),
                num_slots=self._slot_bucket())
            self._clock += n * self.config.block_size
            out.append(np.asarray(mix))
            done += n
        self._last_listener = positions[-1]
        return np.concatenate(out, axis=0)

    def _moving_path(self, positions: np.ndarray) -> np.ndarray:
        """Normalize a moving-listener path to [T, O, 3] (single
        listener) or [T, L, O, 3] (multi-listener; [T, 3] and [T, L, 3]
        broadcast — views, no copies). Multi-listener block t renders
        with the [L, O, M] row stack of row t — one more vmap axis over
        the same step_multi_transfers scan (round-2 VERDICT gap 3)."""
        positions = np.asarray(positions, np.float64)
        t_total = positions.shape[0]
        o = self.bank.num_objects
        nl = self.num_listeners
        if nl > 1:
            if positions.ndim == 2:
                positions = np.broadcast_to(positions[:, None, :],
                                            (t_total, nl, 3))
            if positions.ndim == 3:
                if positions.shape[1] != nl:
                    raise ValueError(
                        f"expected [T, {nl}, 3] listener path, got "
                        f"{positions.shape}")
                positions = np.broadcast_to(positions[:, :, None, :],
                                            (t_total, nl, o, 3))
        elif positions.ndim == 2:
            positions = np.broadcast_to(positions[:, None, :],
                                        (t_total, o, 3))
        return positions

    def _transfer_rows(self, positions_chunk: np.ndarray) -> jax.Array:
        """FFAT transfer rows for one dispatch chunk of a moving path:
        [n, O, 3] -> [n, O, M] or [n, L, O, 3] -> [n, L, O, M]. Chunked
        callers bound the row working set to one dispatch; per-row
        outputs are identical however the path is chunked (each row's
        lookup is independent)."""
        fn = lambda p: compute_transfer(self.ffat, p,  # noqa: E731
                                        compressed=self.use_compressed)
        if positions_chunk.ndim == 4:
            rows = jax.vmap(jax.vmap(fn))(
                jnp.asarray(positions_chunk, self._dtype))
        else:
            rows = jax.vmap(fn)(jnp.asarray(positions_chunk, self._dtype))
        return rows.astype(self._dtype)

    def render_doppler(self, positions: np.ndarray,
                       blocks_per_dispatch: int = 64,
                       smooth: bool | None = None,
                       c: float | None = None,
                       state_events=None,
                       object_centers=None) -> np.ndarray:
        """Moving-listener render with physical Doppler (beyond-reference).

        Like render_moving, but the received signal is delayed by the
        time-varying propagation time r(t)/c per object — which IS the
        Doppler effect (a radial approach speed v compresses the received
        phase by 1 + v/c). The reference applies no propagation delay at
        all (modal_solver.h:286-300 evaluates amplitude only). Amplitude
        falloff stays with the per-block FFAT transfer, exactly as in
        render_moving; the delay is the one added physical term
        (ops/doppler.py).

        ``positions``: [T, 3] (shared) or [T, O, 3] listener positions
        *relative to each object* (the FFAT map frame), row t = block t;
        multi-listener sessions accept [T, 3] / [T, L, 3] / [T, L, O, 3]
        and return one Doppler-delayed channel per listener (each
        listener's delay follows ITS OWN distance trajectory).
        Returns [T * S, C] float32. Samples whose emission time precedes
        the render start are silent (the wavefront has not arrived yet).

        Transfer rows are computed per dispatch chunk like render_moving
        (bounded working set); the per-object sound buffer itself is the
        length of the render ([O, T*S] — the global delay resample needs
        it whole), which bounds practical single-call length to what host
        memory holds (~40 min of 256-object audio per 10 GB).

        ``state_events``: optional [(block_index, fn)] sorted ascending;
        each ``fn(session)`` is applied when generation reaches that block
        (the sound-generation loop splits its dispatch chunks at event
        boundaries). This is how timeline bakes replay sustained AR drags
        under Doppler (apps/render_timeline.bake): the state change lands
        at the exact block it did live, while the delay resample still
        operates on the COMPLETE pre-delay stream — the resample needs the
        whole buffer, but nothing about it requires the *generation* to be
        un-split (round-4 VERDICT item 4; the live drag semantics being
        baked are modal_solver.h:190-240).

        ``object_centers``: optional [O, 3] offsets subtracted from the
        listener path for the DELAY distances only. This reproduces a
        live engine streaming through ``DopplerPostMix(positions=...)``
        with non-origin object centers: live, the session's transfer
        amplitude sees the raw listener (session frame) while the
        post-mix delay measures |center - listener| / c — the bake must
        keep the same two frames (timeline key ``objects``, exported by
        StreamingEngine.export_timeline).
        """
        from ..config import SOUND_SPEED
        from ..ops.doppler import (delay_indices, delay_resample,
                                   sample_distances)
        from .solver import step_multi_transfers_sound
        self._maybe_rebase()
        if smooth is None:
            smooth = self.config.smooth_transfer
        if c is None:
            c = SOUND_SPEED
        positions = self._moving_path(positions)
        # delay frame: listener relative to each object's center (the
        # post-mix frame); transfer amplitude keeps the session frame
        delay_pos = positions
        if object_centers is not None:
            centers = np.asarray(object_centers, np.float64)
            if centers.shape != (self.bank.num_objects, 3):
                raise ValueError(
                    f"object_centers must be [{self.bank.num_objects}, 3],"
                    f" got {centers.shape}")
            delay_pos = positions - centers   # broadcasts over T (and L)
        t_total = positions.shape[0]
        nl = self.num_listeners
        has_ffat = self.ffat is not None and self.use_transfer
        if self._xfade_from is not None and smooth:
            self.state = dataclasses.replace(self.state,
                                             transfer=self._xfade_from[0])
        self._xfade_from = None
        pending = list(state_events or [])
        sounds = []
        done = 0
        while done < t_total:
            while pending and pending[0][0] <= done:
                pending.pop(0)[1](self)
            n = min(blocks_per_dispatch, t_total - done)
            if pending:
                n = min(n, pending[0][0] - done)
            if has_ffat:
                rows = self._transfer_rows(positions[done:done + n])
            else:
                rows = jnp.broadcast_to(
                    self.state.transfer,
                    (n,) + tuple(self.state.transfer.shape))
            self.state, snd = step_multi_transfers_sound(
                self.state, self.bank, rows,
                n_blocks=n, block_size=self.config.block_size,
                backend=self.config.backend, smooth=smooth,
                with_sustained=self._with_sustained(),
                num_slots=self._slot_bucket())
            self._clock += n * self.config.block_size
            sounds.append(np.asarray(snd))
            done += n
        for _, fn in pending:
            fn(self)   # events at/past the end: no audio effect, but the
            #            session state (host mirrors included) must land
            #            where a live run would leave it
        sound = np.concatenate(sounds, axis=-1)      # [(L,) O, N]
        if nl > 1:
            # per-listener delay trajectories: listener l resamples ITS
            # transfer-weighted sound by ITS distances (host loop over L —
            # L is small; [L, O, N] gathers stay chunked per listener)
            cols = []
            for li in range(nl):
                dist = sample_distances(delay_pos[:, li],
                                        self.config.block_size)
                i0, frac = delay_indices(dist, c)
                cols.append(np.asarray(delay_resample(
                    jnp.asarray(sound[li], self._dtype),
                    jnp.asarray(i0), jnp.asarray(frac),
                    self.gains[:, li: li + 1])))
            self._last_listener = positions[-1]
            return np.concatenate(cols, axis=-1)     # [N, L]
        dist = sample_distances(delay_pos, self.config.block_size)
        i0, frac = delay_indices(dist, c)   # float64 host split
        mix = delay_resample(jnp.asarray(sound, self._dtype),
                             jnp.asarray(i0), jnp.asarray(frac),
                             self.gains)
        self._last_listener = positions[-1]
        return np.asarray(mix)

    def render_raw(self, num_blocks: int) -> np.ndarray:
        """Offline render of per-object raw sound: [O, num_blocks * S]."""
        out = []
        for _ in range(num_blocks):
            sound, _, _ = self.step()
            out.append(np.asarray(sound))
        return np.concatenate(out, axis=-1)
