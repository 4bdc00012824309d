"""The block synthesis step — the batched equivalent of ModalSolver::step().

One call synthesizes one S-sample block for every object in the scene
(reference modal_solver.h:181-276 synthesizes one block for one object):

1. force synthesis: slot table + sustained channel -> rank-1 excitation
   (space [O,M], time [O,S])                    (modal_solver.h:206-240)
2. modal integration: z' = lam z + b Q, per-object sound = q . transfer
   via the chosen backend                        (modal_solver.h:262-271)
3. optional per-mode energy telemetry qnorm      (modal_solver.h:270-273)
4. stereo mixdown over objects with per-object gain/pan (the batched-scene
   extension; the reference duplicates one mono signal,
   real_time_modal_sound.cpp:207-210)

Everything is jitted with static (block_size, backend, compute_qnorm); event
ingestion (hits, listener moves, AR params) mutates only *data*, never shapes,
so the step never recompiles at runtime.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..config import DEFAULT_BLOCK, OUTPUT_SCALE
from ..ops.coeffs import ModalBank
from ..ops.forces import force_block, sustained_block
from ..ops.integrator import PRECISION, get_backend
from .state import SolverState


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    block_size: int = DEFAULT_BLOCK
    backend: str = "auto"   # blocked, or scan for a table-less bank
    compute_qnorm: bool = False
    decay_fast_path: bool = True  # homogeneous-only step when scene is idle
    smooth_transfer: bool = False  # ramp transfer across the block after a
    #   listener move (beyond-reference; off = reference block-constant)
    slot_buckets: tuple[int, ...] = (1,)  # static force-slot slice sizes the
    #   session may dispatch (besides the full table): per-slot force work
    #   scales with the bucket, and each bucket is one extra jit variant
    #   (warmed by session.warmup). () disables slot pruning.


@dataclasses.dataclass(frozen=True)
class BlockOutput:
    sound: jax.Array          # [O, S] per-object raw modal sound
    mix: jax.Array            # [S, 2] stereo mixdown (already 1/1E10 scaled)
    qnorm: jax.Array | None   # [O, M] per-mode energy, if requested


def _mixdown(sound: jax.Array, gains: jax.Array) -> jax.Array:
    """Object mixdown -> output channels, already 1/1E10 scaled.

    ``sound`` [O, S] with gains [O, C] (stereo / per-channel), or the
    shared-state multi-listener form [L, O, S] with gains [O, L] where
    channel l is listener l's own mix. (Span dispatches use the [O, L, N]
    layout instead — _mixdown_span.)"""
    if sound.ndim == 3:
        mix = jnp.einsum("los,ol->sl", sound, gains, precision=PRECISION)
    else:
        mix = jnp.einsum("os,oc->sc", sound, gains, precision=PRECISION)
    return mix / OUTPUT_SCALE


def _mixdown_span(sound: jax.Array, gains: jax.Array) -> jax.Array:
    """Span-path mixdown: multi-listener span sound is [O, L, N] (listener
    axis inside — the layout the per-object contractions produce without a
    large transpose, ops/span.py::_integrate_span_chunked)."""
    if sound.ndim == 3:
        mix = jnp.einsum("oln,ol->nl", sound, gains, precision=PRECISION)
        return mix / OUTPUT_SCALE
    return _mixdown(sound, gains)


def _step_block_impl(
    state: SolverState,
    bank: ModalBank,
    gains: jax.Array,
    block_size: int,
    backend: str,
    compute_qnorm: bool,
    mode_axis: str | None = None,
    obj_axis: str | None = None,
    transfer_prev: jax.Array | None = None,
    with_sustained: bool = True,
    num_slots: int | None = None,
    transfer_prev_im: jax.Array | None = None,
):
    """Core block step; ``mode_axis``/``obj_axis`` name shard_map mesh axes
    to psum partial results over (used by parallel/sharding.py so the SPMD
    path shares this single implementation). ``transfer_prev`` selects the
    transfer-interpolating variant: the transfer ramps linearly from it to
    state.transfer across the block (smooth listener motion).

    Dead-work gating (host-driven, output-invariant):
    ``with_sustained=False`` skips the 512-step serial AR(2) scan when the
    host sustained mirror proves every channel inactive (the skipped terms
    are exact float zeros); ``num_slots`` statically slices the force-slot
    table to its first k slots when the host expiry mirror proves the rest
    can no longer produce."""
    slots = state.slots
    if num_slots is not None and num_slots < slots.num_slots:
        slots = jax.tree.map(lambda x: x[:, :num_slots], slots)
    time_imp, space_imp = force_block(slots, state.block_start, block_size)
    if with_sustained:
        sus, time_sus, space_sus = sustained_block(state.sustained,
                                                   block_size,
                                                   state.block_start)
        # sustained mode replaces the impact path for that object
        # (modal_solver.h:195-204: non-sustained forces are not accumulated
        # while a sustained force is active)
        gate = sus.active[:, None].astype(time_imp.dtype)
        time_profile = time_imp * (1 - gate) + time_sus
        space = space_imp * (1 - gate[:, : 1]) + space_sus
    else:
        # inactive sustained channels produce exact zero profiles, so this
        # branch is bitwise-identical to the gated sum above
        sus = state.sustained
        time_profile, space = time_imp, space_imp

    if transfer_prev is None:
        integrate = get_backend(backend, bank)
        z_re, z_im, sound, qnorm = integrate(
            state.z_re, state.z_im, bank, space, time_profile,
            state.transfer, compute_qnorm,
            transfer_im=state.transfer_im)
    else:
        from ..ops.integrator import (resolve_backend_name,
                                      step_block_blocked_xfade,
                                      step_block_scan_xfade)
        name = resolve_backend_name(backend, bank)
        fn = (step_block_scan_xfade if name == "scan"
              else step_block_blocked_xfade)
        z_re, z_im, sound, qnorm = fn(
            state.z_re, state.z_im, bank, space, time_profile,
            transfer_prev, state.transfer, compute_qnorm,
            transfer_prev_im=transfer_prev_im,
            transfer_im=state.transfer_im)
    if mode_axis is not None:
        # each mode shard contributed a partial transfer dot
        sound = jax.lax.psum(sound, mode_axis)

    mix = _mixdown(sound, gains)
    if obj_axis is not None:
        mix = jax.lax.psum(mix, obj_axis)
    new_state = dataclasses.replace(
        state,
        z_re=z_re,
        z_im=z_im,
        sustained=sus,
        block_start=state.block_start + block_size,
    )
    return new_state, sound, mix.astype(jnp.float32), qnorm


@partial(jax.jit, static_argnames=("block_size", "backend", "compute_qnorm",
                                   "with_sustained", "num_slots"))
def step_block(
    state: SolverState,
    bank: ModalBank,
    gains: jax.Array,          # [O, 2] stereo gain/pan per object
    *,
    block_size: int = DEFAULT_BLOCK,
    backend: str = "blocked",
    compute_qnorm: bool = False,
    with_sustained: bool = True,
    num_slots: int | None = None,
) -> tuple[SolverState, jax.Array, jax.Array, jax.Array | None]:
    """Advance one block. Returns (state', sound [O,S], mix [S,2], qnorm)."""
    return _step_block_impl(state, bank, gains, block_size, backend,
                            compute_qnorm, with_sustained=with_sustained,
                            num_slots=num_slots)


@partial(jax.jit, static_argnames=("block_size", "backend", "compute_qnorm",
                                   "with_sustained", "num_slots"))
def step_block_xfade(
    state: SolverState,
    bank: ModalBank,
    gains: jax.Array,
    transfer_prev: jax.Array,   # [O, M] transfer before the listener moved
    *,
    block_size: int = DEFAULT_BLOCK,
    backend: str = "blocked",
    compute_qnorm: bool = False,
    with_sustained: bool = True,
    num_slots: int | None = None,
    transfer_prev_im: jax.Array | None = None,
) -> tuple[SolverState, jax.Array, jax.Array, jax.Array | None]:
    """One block with the transfer ramping linearly from ``transfer_prev``
    to ``state.transfer`` — dispatched by the session for the single block
    after a listener move when SolverConfig.smooth_transfer is on, removing
    the per-block level step ("zipper") of the reference's block-constant
    transfer (modal_solver.h:286-300). Complex rows ramp re and im
    independently (``transfer_prev_im`` is the outgoing imaginary row,
    None = zero phase)."""
    return _step_block_impl(state, bank, gains, block_size, backend,
                            compute_qnorm, transfer_prev=transfer_prev,
                            with_sustained=with_sustained,
                            num_slots=num_slots,
                            transfer_prev_im=transfer_prev_im)


@partial(jax.jit, static_argnames=("block_size", "compute_qnorm"))
def decay_block(
    state: SolverState,
    bank: ModalBank,
    gains: jax.Array,
    *,
    block_size: int = DEFAULT_BLOCK,
    compute_qnorm: bool = False,
) -> tuple[SolverState, jax.Array, jax.Array, jax.Array | None]:
    """Idle-scene fast path: advance one block with no active forces.

    Produces the same output as step_block when every force slot has
    expired and no sustained channel is active (the excitation is exactly
    zero), at roughly half the device work (ops/integrator.py
    decay_block_blocked). The host gates eligibility via its slot-expiry
    and sustained mirrors (session._idle). Slots and the sustained channel
    (including its PRNG stream) are carried through untouched; the
    sustained stream only matters while active, and sustained_start resets
    the history.
    """
    from ..ops.integrator import decay_block_blocked
    z_re, z_im, sound, qnorm = decay_block_blocked(
        state.z_re, state.z_im, bank, state.transfer, compute_qnorm,
        transfer_im=state.transfer_im)
    mix = _mixdown(sound, gains)
    new_state = dataclasses.replace(
        state, z_re=z_re, z_im=z_im,
        block_start=state.block_start + block_size)
    return new_state, sound, mix.astype(jnp.float32), qnorm


@partial(jax.jit,
         static_argnames=("n_blocks", "block_size", "backend",
                          "with_sustained", "num_slots"))
def step_multi(
    state: SolverState,
    bank: ModalBank,
    gains: jax.Array,
    *,
    n_blocks: int,
    block_size: int = DEFAULT_BLOCK,
    backend: str = "blocked",
    with_sustained: bool = True,
    num_slots: int | None = None,
) -> tuple[SolverState, jax.Array]:
    """Advance n_blocks in ONE dispatch via lax.scan.

    Used for offline rendering and throughput benchmarking: per-dispatch
    host overhead dominates small blocks, so batching blocks on device
    recovers the true device rate. Force slots are stateless per block
    (pure functions of the sample clock), so hits scheduled inside the span
    fire at the right block automatically.

    Returns (state', mix [n_blocks*S, 2]).
    """
    def body(st, _):
        st, _sound, mix, _ = _step_block_impl(
            st, bank, gains, block_size, backend, False,
            with_sustained=with_sustained, num_slots=num_slots)
        return st, mix

    state, mixes = jax.lax.scan(body, state, None, length=n_blocks)
    # channel-agnostic: gains may carry 2 (stereo) or L (multi-listener)
    return state, mixes.reshape(n_blocks * block_size, mixes.shape[-1])


@partial(jax.jit,
         static_argnames=("n_blocks", "block_size", "backend", "smooth",
                          "with_sustained", "num_slots"))
def step_multi_transfers(
    state: SolverState,
    bank: ModalBank,
    gains: jax.Array,
    transfers: jax.Array,      # [n_blocks, O, M] per-block transfer rows
    *,
    n_blocks: int,
    block_size: int = DEFAULT_BLOCK,
    backend: str = "blocked",
    smooth: bool = False,
    with_sustained: bool = True,
    num_slots: int | None = None,
) -> tuple[SolverState, jax.Array]:
    """Moving-listener multi-block dispatch: block i renders with
    ``transfers[i]``.

    The reference recomputes the transfer once per listener move and holds
    it block-constant (modal_solver.h:286-300); a 10 Hz listener sweep
    therefore forced one dispatch per move. Scanning a *transfer schedule*
    keeps a whole moving-listener render at one dispatch per chunk
    (render_offline config 3: <= 3 dispatches per second of audio).

    ``smooth=True`` ramps each block linearly from the previous block's
    row (the session's smooth_transfer semantics, continuous motion =
    no zipper); False holds each row block-constant like the reference.
    The scan carries the previous row, so a ramp from an unchanged row is
    exactly the constant-transfer render. Returns (state', mix [N, C]).
    """
    def body(carry, tr):
        st, prev = carry
        st = dataclasses.replace(st, transfer=tr)
        st, _sound, mix, _ = _step_block_impl(
            st, bank, gains, block_size, backend, False,
            transfer_prev=(prev if smooth else None),
            with_sustained=with_sustained, num_slots=num_slots)
        return (st, tr), mix

    (state, _), mixes = jax.lax.scan(body, (state, state.transfer),
                                     transfers)
    return state, mixes.reshape(n_blocks * block_size, mixes.shape[-1])


@partial(jax.jit,
         static_argnames=("n_blocks", "block_size", "backend", "smooth",
                          "with_sustained", "num_slots"))
def step_multi_transfers_sound(
    state: SolverState,
    bank: ModalBank,
    transfers: jax.Array,      # [n_blocks, O, M] per-block transfer rows
    *,
    n_blocks: int,
    block_size: int = DEFAULT_BLOCK,
    backend: str = "blocked",
    smooth: bool = False,
    with_sustained: bool = True,
    num_slots: int | None = None,
) -> tuple[SolverState, jax.Array]:
    """step_multi_transfers returning the raw per-object sound instead of
    the mix: (state', sound [O, n_blocks*S]), or — with multi-listener
    row stacks ``transfers`` [n_blocks, L, O, M] — the per-listener
    weighted sounds ([L, O, n_blocks*S]).

    Used by the Doppler renderer (session.render_doppler), which must
    delay-resample each object's signal BEFORE the channel mixdown."""
    gains_dummy = jnp.zeros((state.z_re.shape[0], 1), state.z_re.dtype)

    def body(carry, tr):
        st, prev = carry
        st = dataclasses.replace(st, transfer=tr)
        st, sound, _mix, _ = _step_block_impl(
            st, bank, gains_dummy, block_size, backend, False,
            transfer_prev=(prev if smooth else None),
            with_sustained=with_sustained, num_slots=num_slots)
        return (st, tr), sound

    (state, _), sounds = jax.lax.scan(body, (state, state.transfer),
                                      transfers)
    # [n_blocks, (L,) O, S] -> [(L,) O, n_blocks * S]
    sound = jnp.moveaxis(sounds, 0, -2).reshape(
        sounds.shape[1:-1] + (n_blocks * block_size,))
    return state, sound


def _span_channels(state, n_blocks, block_size, num_slots, with_sustained,
                   ar_g):
    """The span's excitation channels: slot-table forces (statically
    sliced to ``num_slots``) plus, with ``with_sustained``, the AR(2)
    channel as ONE extra slot under the reference's replace-semantics
    gating (modal_solver.h:195-204). Shared by step_span,
    step_span_sound, and the SPMD span (parallel/sharding.py).
    Returns (sustained_state', f_k [O, K(+1), N], space_k).

    ``num_slots == 0`` (with sustained) is the steady-drag fast path:
    the host expiry mirror proved no impact slot can produce, so the
    sustained channel is the span's ONLY slot — the per-slot span work
    (Toeplitz convs, injection gathers) matches the 1-slot impact
    headline instead of doubling it."""
    from ..ops.forces import force_span, sustained_span
    n = n_blocks * block_size
    sus = state.sustained
    if with_sustained:
        sus, prof, space_sus = sustained_span(
            state.sustained, ar_g, n_blocks, block_size,
            state.block_start)
        if num_slots == 0:
            return sus, prof[:, None, :], space_sus[:, None, :]
    slots = state.slots
    if num_slots is not None and num_slots < slots.num_slots:
        slots = jax.tree.map(lambda x: x[:, :num_slots], slots)
    f_k, space_k = force_span(slots, state.block_start, n, block_size)
    if with_sustained:
        gate = sus.active[:, None].astype(f_k.dtype)       # [O, 1]
        f_k = jnp.concatenate(
            [f_k * (1 - gate)[..., None], prof[:, None, :]], axis=1)
        space_k = jnp.concatenate(
            [space_k * (1 - gate)[..., None], space_sus[:, None, :]],
            axis=1)
    return sus, f_k, space_k


@partial(jax.jit, static_argnames=("n_blocks", "block_size", "num_slots",
                                   "with_sustained"))
def step_span(
    state: SolverState,
    bank: ModalBank,
    tables,                    # ops.span.SpanTables for n_blocks*block_size
    gains: jax.Array,
    *,
    n_blocks: int,
    block_size: int = DEFAULT_BLOCK,
    num_slots: int | None = None,
    with_sustained: bool = False,
    ar_g: jax.Array | None = None,   # [Og, S+1] host AR impulse table
) -> tuple[SolverState, jax.Array]:
    """Advance n_blocks in ONE dispatch with no serial dependency at all.

    The matmul-shaped successor to step_multi for offline rendering and
    throughput (ops/span.py): instead of scanning the per-block step, the
    whole N = n_blocks * block_size sample span is synthesized by a few
    batched matmuls against lam-power tables — for heterogeneous banks
    far less memory traffic than the blocked per-block [O, M, S] tables. Reference
    block-granular force semantics are preserved exactly via the per-slot
    decomposition (ops/forces.py::force_span).

    ``num_slots`` statically slices the force-slot table to its first k
    slots (host-maintained active count): per-slot work scales with k.

    ``with_sustained=True`` adds the sustained AR(2) channel as ONE extra
    span slot: ops/forces.py::sustained_span factors the AR recurrence
    over the whole span (bitwise the per-block noise stream), and per the
    reference's replace-semantics (modal_solver.h:195-204) the slot
    channels of sustained-active objects are gated off. ``ar_g`` is the
    host AR impulse table (ar_impulse_g); required when with_sustained.
    The transfer is constant across the span, like the reference's
    block-constant transfer held over a lookahead batch.
    Returns (state', mix [N, C]).
    """
    from ..ops.span import integrate_span
    n = n_blocks * block_size
    sus, f_k, space_k = _span_channels(state, n_blocks, block_size,
                                       num_slots, with_sustained, ar_g)
    z_re, z_im, sound = integrate_span(
        state.z_re, state.z_im, bank, tables, space_k, f_k, state.transfer,
        transfer_im=state.transfer_im)
    mix = _mixdown_span(sound, gains)
    new_state = dataclasses.replace(
        state, z_re=z_re, z_im=z_im, sustained=sus,
        block_start=state.block_start + n)
    return new_state, mix.astype(jnp.float32)


@partial(jax.jit, static_argnames=("n_blocks", "block_size", "num_slots",
                                   "with_sustained", "idle"))
def step_span_sound(
    state: SolverState,
    bank: ModalBank,
    tables,
    *,
    n_blocks: int,
    block_size: int = DEFAULT_BLOCK,
    num_slots: int | None = None,
    with_sustained: bool = False,
    ar_g: jax.Array | None = None,
    idle: bool = False,
) -> tuple[SolverState, jax.Array]:
    """step_span returning the raw per-object sound instead of the mix:
    (state', sound [O, N]).

    Feeds post-mix stages that consume per-object signals over a whole
    span in one shot — the HRTF frequency-domain mix is length-agnostic
    (ops/hrtf.py::hrtf_mix_span), so broadband-binaural streams ride the
    span dispatch instead of paying per-block rates (round-2 VERDICT
    item 4). ``idle=True`` is the ring-down fast path (decay_span)."""
    from ..ops.span import decay_span, integrate_span
    n = n_blocks * block_size
    if idle:
        z_re, z_im, sound = decay_span(
            state.z_re, state.z_im, bank, tables, state.transfer,
            transfer_im=state.transfer_im)
        new_state = dataclasses.replace(
            state, z_re=z_re, z_im=z_im,
            block_start=state.block_start + n)
        return new_state, sound
    sus, f_k, space_k = _span_channels(state, n_blocks, block_size,
                                       num_slots, with_sustained, ar_g)
    z_re, z_im, sound = integrate_span(
        state.z_re, state.z_im, bank, tables, space_k, f_k, state.transfer,
        transfer_im=state.transfer_im)
    new_state = dataclasses.replace(
        state, z_re=z_re, z_im=z_im, sustained=sus,
        block_start=state.block_start + n)
    return new_state, sound


@partial(jax.jit, static_argnames=("n_blocks", "block_size"))
def decay_span_step(
    state: SolverState,
    bank: ModalBank,
    tables,
    gains: jax.Array,
    *,
    n_blocks: int,
    block_size: int = DEFAULT_BLOCK,
) -> tuple[SolverState, jax.Array]:
    """Idle-scene span: n_blocks of pure ring-down in one dispatch
    (host-gated like decay_block). Returns (state', mix [N, C])."""
    from ..ops.span import decay_span
    n = n_blocks * block_size
    z_re, z_im, sound = decay_span(
        state.z_re, state.z_im, bank, tables, state.transfer,
        transfer_im=state.transfer_im)
    mix = _mixdown_span(sound, gains)
    new_state = dataclasses.replace(
        state, z_re=z_re, z_im=z_im,
        block_start=state.block_start + n)
    return new_state, mix.astype(jnp.float32)


def default_gains(num_objects: int, dtype=jnp.float32) -> jax.Array:
    """Unit mono-to-stereo gains (reference duplicates mono to L/R)."""
    return jnp.ones((num_objects, 2), dtype)
