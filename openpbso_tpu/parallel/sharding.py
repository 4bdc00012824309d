"""Multi-chip scale-out: shard_map over an ('obj', 'mode') device mesh.

The reference is strictly single-process; its only "communication layer" is
intra-process SPSC queues (SURVEY.md section 5). The multi-device scale-out
shards the embarrassingly parallel axes of the workload:

- ``obj``  — objects are fully independent (data parallel); each shard
  integrates its own object rows. The only cross-object communication is the
  stereo mixdown sum, a single ``psum`` over the object axis.
- ``mode`` — a mode bank can be split across devices (tensor parallel); each
  shard owns a mode slice, and the per-sample transfer dot becomes a partial
  sum reduced with the same ``psum``.

Everything else in the block step is elementwise in (object, mode), so the
per-block communication volume is exactly one [S, 2] stereo block per
device — a few KB per 11.6 ms of audio. The mesh shape follows the
algorithm: on an all-to-all interconnect (four NVLink-joined GPUs) every
device reaches every other at the same rate.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DEFAULT_BLOCK
from ..ops.coeffs import ModalBank
from ..runtime.state import SolverState


def make_mesh(n_obj_shards: int, n_mode_shards: int = 1,
              devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    need = n_obj_shards * n_mode_shards
    if devices.size < need:
        raise ValueError(f"need {need} devices, have {devices.size}")
    grid = devices[:need].reshape(n_obj_shards, n_mode_shards)
    return Mesh(grid, axis_names=("obj", "mode"))


def state_specs(num_listeners: int = 1,
                complex_rows: bool = False) -> SolverState:
    """PartitionSpecs for every SolverState leaf.

    ``num_listeners`` > 1: the transfer is [L, O, M] (shared-state
    multi-listener rows, runtime/state.py) — the listener axis replicates
    while obj/mode shard as usual. ``complex_rows`` adds the transfer_im
    spec (same layout as transfer: a complex row is just a second weight
    channel, ops/integrator._complex_weights)."""
    from ..ops.forces import ForceSlots, SustainedState
    om = P("obj", "mode")
    o = P("obj")
    tspec = om if num_listeners <= 1 else P(None, "obj", "mode")
    return SolverState(
        z_re=om, z_im=om,
        slots=ForceSlots(ftype=o, t0=o, width=o, amp=o,
                         space=P("obj", None, "mode")),
        sustained=SustainedState(
            active=o, space=om, ar_hist=o, a=o, sigma=o, mu=o, key=o),
        transfer=tspec,
        block_start=P(),
        transfer_im=(tspec if complex_rows else None),
    )


def _sound_spec(num_listeners: int):
    """Per-block sound is [O, S] or [L, O, S] (listener axis leading)."""
    return (P("obj", None) if num_listeners <= 1
            else P(None, "obj", None))


def bank_specs(bank: ModalBank) -> ModalBank:
    om = P("obj", "mode")
    table = None
    if bank.pow_re is not None:
        # shared tables replicate over obj shards but split their mode axis
        table = (P(None, "mode", None) if bank.shared_tables
                 else P("obj", "mode", None))
    return ModalBank(lam_re=om, lam_im=om, b_re=om, b_im=om, mask=om,
                     pow_re=table, pow_im=table)


def make_sharded_step(mesh: Mesh, bank: ModalBank, *,
                      block_size: int = DEFAULT_BLOCK,
                      backend: str = "blocked",
                      compute_qnorm: bool = False,
                      with_sustained: bool = True,
                      num_slots: int | None = None,
                      num_listeners: int = 1,
                      complex_rows: bool = False):
    """Build a jitted SPMD block step over ``mesh``.

    Returns ``step(state, bank, gains) -> (state', sound, mix, qnorm)`` where
    per-shard object/mode rows integrate locally and the stereo mix is
    psum-reduced over both mesh axes. ``with_sustained``/``num_slots`` are
    the host-gated dead-work flags (runtime/solver.py); ``complex_rows``
    declares the state carries a transfer_im leaf (complex transfer).
    """
    from ..runtime.solver import _step_block_impl

    def local_step(state: SolverState, bank: ModalBank, gains: jax.Array):
        # the single shared block-step implementation, with mesh axis names
        # so the transfer dot (partial over mode shards) and stereo mix
        # (partial over object shards) are psum-reduced
        return _step_block_impl(state, bank, gains, block_size, backend,
                                compute_qnorm, mode_axis="mode",
                                obj_axis="obj",
                                with_sustained=with_sustained,
                                num_slots=num_slots)

    specs_in = (state_specs(num_listeners, complex_rows), bank_specs(bank),
                P("obj", None))
    specs_out = (state_specs(num_listeners, complex_rows),
                 _sound_spec(num_listeners), P(), None)
    if compute_qnorm:
        specs_out = specs_out[:3] + (P("obj", "mode"),)

    sharded = jax.shard_map(local_step, mesh=mesh, in_specs=specs_in,
                            out_specs=specs_out, check_vma=False)
    return jax.jit(sharded)


def make_sharded_xfade_step(mesh: Mesh, bank: ModalBank, *,
                            block_size: int = DEFAULT_BLOCK,
                            backend: str = "blocked",
                            compute_qnorm: bool = False,
                            with_sustained: bool = True,
                            num_slots: int | None = None,
                            num_listeners: int = 1,
                            complex_rows: bool = False):
    """SPMD transfer-ramp block step (runtime/solver.py::step_block_xfade):
    the transfer interpolates linearly from ``transfer_prev`` to
    state.transfer across the block after a listener move.

    Returns ``step(state, bank, gains, transfer_prev) -> (...)`` — with
    ``complex_rows``, ``step(state, bank, gains, transfer_prev,
    transfer_prev_im)`` (both channels ramp, ops/integrator._xfade_rows).
    """
    from ..runtime.solver import _step_block_impl

    def local_step(state, bank, gains, transfer_prev,
                   transfer_prev_im=None):
        return _step_block_impl(state, bank, gains, block_size, backend,
                                compute_qnorm, mode_axis="mode",
                                obj_axis="obj",
                                transfer_prev=transfer_prev,
                                with_sustained=with_sustained,
                                num_slots=num_slots,
                                transfer_prev_im=transfer_prev_im)

    tspec = (P("obj", "mode") if num_listeners <= 1
             else P(None, "obj", "mode"))
    specs_in = (state_specs(num_listeners, complex_rows), bank_specs(bank),
                P("obj", None), tspec) + ((tspec,) if complex_rows else ())
    specs_out = (state_specs(num_listeners, complex_rows),
                 _sound_spec(num_listeners),
                 P(), P("obj", "mode") if compute_qnorm else None)
    sharded = jax.shard_map(local_step, mesh=mesh, in_specs=specs_in,
                            out_specs=specs_out, check_vma=False)
    return jax.jit(sharded)


def make_sharded_multi(mesh: Mesh, bank: ModalBank, *, n_blocks: int,
                       block_size: int = DEFAULT_BLOCK,
                       backend: str = "blocked",
                       with_sustained: bool = True,
                       num_slots: int | None = None,
                       num_listeners: int = 1,
                       complex_rows: bool = False):
    """SPMD multi-block scan: n_blocks per dispatch, one [S,C] psum per
    block (the only cross-device traffic).

    Returns ``step(state, bank, gains) -> (state', mix [n_blocks*S, C])``.
    """
    from ..runtime.solver import _step_block_impl

    def local_multi(state, bank, gains):
        def body(st, _):
            st, _sound, mix, _ = _step_block_impl(
                st, bank, gains, block_size, backend, False,
                mode_axis="mode", obj_axis="obj",
                with_sustained=with_sustained, num_slots=num_slots)
            return st, mix
        state, mixes = jax.lax.scan(body, state, None, length=n_blocks)
        return state, mixes.reshape(n_blocks * block_size, -1)

    specs_in = (state_specs(num_listeners, complex_rows), bank_specs(bank),
                P("obj", None))
    specs_out = (state_specs(num_listeners, complex_rows), P())
    sharded = jax.shard_map(local_multi, mesh=mesh, in_specs=specs_in,
                            out_specs=specs_out, check_vma=False)
    return jax.jit(sharded)


def span_table_specs(tables) -> object:
    """PartitionSpecs for ops.span tables: mode axis splits, the
    power axis replicates, the object axis follows the bank layout."""
    from ..ops.span import ChunkSpanTables, FullSpanTables, SpanTables
    if isinstance(tables, FullSpanTables):
        spec = P("mode", None)
        return FullSpanTables(p_re=spec, p_im=spec)
    spec = (P(None, None, "mode") if tables.shared
            else P("obj", None, "mode"))
    if isinstance(tables, ChunkSpanTables):
        # superchunk powers lam^(dC) ([Og, G+1, M]) shard like the baby
        # tables; None when the span keeps the single-level scan
        sup = None if tables.s_re is None else spec
        return ChunkSpanTables(b_re=spec, b_im=spec,
                               n_chunks=tables.n_chunks, s_re=sup, s_im=sup)
    return SpanTables(a_re=spec, a_im=spec, b_re=spec, b_im=spec)


def make_sharded_span(mesh: Mesh, bank: ModalBank, tables, *,
                      n_blocks: int,
                      block_size: int = DEFAULT_BLOCK,
                      num_slots: int | None = None,
                      decay: bool = False,
                      num_listeners: int = 1,
                      complex_rows: bool = False,
                      with_sustained: bool = False,
                      ar_g_shared: bool = True):
    """SPMD span dispatch (ops/span.py): N = n_blocks*S samples per
    dispatch with ONE [N, C] psum over the mesh — the minimum possible
    cross-chip traffic per second of audio.

    The mode-sharded hom/g partial sums stay partial through the (linear)
    causal convolution and are reduced together with the object-axis mix
    sum. Returns ``step(state, bank, tables, gains) -> (state', mix)``;
    with ``with_sustained``, ``step(state, bank, tables, gains, ar_g)``
    (the host AR impulse table, replicated when ``ar_g_shared`` else
    obj-sharded) — the sustained AR(2) channel is entirely per-object
    (keys, history, profile), so it shards with no extra communication.
    """
    from ..ops.span import decay_span, integrate_span
    from ..runtime.solver import _mixdown_span, _span_channels
    n = n_blocks * block_size

    def local_span(state, bank, tables, gains, ar_g=None):
        if decay:
            z_re, z_im, sound = decay_span(
                state.z_re, state.z_im, bank, tables, state.transfer,
                transfer_im=state.transfer_im)
        else:
            sus, f_k, space_k = _span_channels(
                state, n_blocks, block_size, num_slots, with_sustained,
                ar_g)
            z_re, z_im, sound = integrate_span(
                state.z_re, state.z_im, bank, tables, space_k, f_k,
                state.transfer, transfer_im=state.transfer_im)
            state = dataclasses.replace(state, sustained=sus)
        # the mix is linear in sound, so the mode-partial sound reduces
        # AFTER the mixdown: ONE [N, C] psum over both axes instead of
        # psumming the full [O, (L,) N] sound tensor over 'mode' (O-fold
        # more interconnect traffic for the same result)
        mix = _mixdown_span(sound, gains)
        mix = jax.lax.psum(mix, ("mode", "obj"))
        new_state = dataclasses.replace(
            state, z_re=z_re, z_im=z_im,
            block_start=state.block_start + n)
        return new_state, mix.astype(jnp.float32)

    specs_in = (state_specs(num_listeners, complex_rows), bank_specs(bank),
                span_table_specs(tables), P("obj", None))
    if with_sustained:
        # the mode axis of sustained_span's spatial gate lives in
        # state.sustained.space (already obj x mode sharded); ar_g's mode
        # axis is the AR lag, replicated over 'mode'
        specs_in = specs_in + (
            P(None, None) if ar_g_shared else P("obj", None),)
    specs_out = (state_specs(num_listeners, complex_rows), P())
    sharded = jax.shard_map(local_span, mesh=mesh, in_specs=specs_in,
                            out_specs=specs_out, check_vma=False)
    return jax.jit(sharded)


def make_sharded_span_sound(mesh: Mesh, bank: ModalBank, tables, *,
                            n_blocks: int,
                            block_size: int = DEFAULT_BLOCK,
                            num_slots: int | None = None,
                            decay: bool = False,
                            complex_rows: bool = False,
                            with_sustained: bool = False,
                            ar_g_shared: bool = True,
                            num_listeners: int = 1):
    """SPMD span returning the RAW per-object sound (the span-shaped
    post-mix feed, solver.step_span_sound): the [O, N] sound gathers the
    mode-axis partials with one psum and stays obj-sharded — the
    post-mix (HRTF/Doppler frequency-domain mixes) then runs under jit
    on the obj-sharded sound. Returns ``step(state, bank, tables[,
    ar_g]) -> (state', sound [O, N])``."""
    from ..ops.span import decay_span, integrate_span
    from ..runtime.solver import _span_channels
    n = n_blocks * block_size

    def local_span(state, bank, tables, ar_g=None):
        if decay:
            z_re, z_im, sound = decay_span(
                state.z_re, state.z_im, bank, tables, state.transfer,
                transfer_im=state.transfer_im)
        else:
            sus, f_k, space_k = _span_channels(
                state, n_blocks, block_size, num_slots, with_sustained,
                ar_g)
            z_re, z_im, sound = integrate_span(
                state.z_re, state.z_im, bank, tables, space_k, f_k,
                state.transfer, transfer_im=state.transfer_im)
            state = dataclasses.replace(state, sustained=sus)
        sound = jax.lax.psum(sound, "mode")   # mode-partial transfer dot
        new_state = dataclasses.replace(
            state, z_re=z_re, z_im=z_im,
            block_start=state.block_start + n)
        return new_state, sound

    specs_in = (state_specs(num_listeners, complex_rows), bank_specs(bank),
                span_table_specs(tables))
    if with_sustained:
        specs_in = specs_in + (
            P(None, None) if ar_g_shared else P("obj", None),)
    sound_spec = (P("obj", None) if num_listeners <= 1
                  else P("obj", None, None))     # span layout [O, L, N]
    specs_out = (state_specs(num_listeners, complex_rows), sound_spec)
    sharded = jax.shard_map(local_span, mesh=mesh, in_specs=specs_in,
                            out_specs=specs_out, check_vma=False)
    return jax.jit(sharded)


def shard_span_tables(mesh: Mesh, tables):
    specs = span_table_specs(tables)
    return jax.tree.map(lambda x, s: _put(mesh, x, s), tables, specs,
                        is_leaf=lambda x: x is None)


def make_sharded_decay_step(mesh: Mesh, bank: ModalBank, *,
                            block_size: int = DEFAULT_BLOCK,
                            compute_qnorm: bool = False,
                            num_listeners: int = 1,
                            complex_rows: bool = False):
    """SPMD variant of the idle-scene decay step (solver.decay_block).

    Same host gating contract as the single-chip path: dispatch only when
    the host mirrors prove the excitation is zero. Communication is
    identical to the full step (one psum for the mode-partial transfer
    dot, one for the stereo mix).
    """
    from ..ops.integrator import decay_block_blocked
    from ..runtime.solver import _mixdown

    def local_step(state: SolverState, bank: ModalBank, gains: jax.Array):
        z_re, z_im, sound, qnorm = decay_block_blocked(
            state.z_re, state.z_im, bank, state.transfer, compute_qnorm,
            transfer_im=state.transfer_im)
        sound = jax.lax.psum(sound, "mode")
        # _mixdown pins full-f32 precision (ops/integrator.PRECISION) and
        # handles the [L, O, S] multi-listener layout
        mix = _mixdown(sound, gains)
        mix = jax.lax.psum(mix, "obj")
        new_state = dataclasses.replace(
            state, z_re=z_re, z_im=z_im,
            block_start=state.block_start + block_size)
        return new_state, sound, mix.astype(jnp.float32), qnorm

    specs_in = (state_specs(num_listeners, complex_rows), bank_specs(bank),
                P("obj", None))
    specs_out = (state_specs(num_listeners, complex_rows),
                 _sound_spec(num_listeners),
                 P(), P("obj", "mode") if compute_qnorm else None)
    sharded = jax.shard_map(local_step, mesh=mesh, in_specs=specs_in,
                            out_specs=specs_out, check_vma=False)
    return jax.jit(sharded)


def _put(mesh: Mesh, x, spec):
    if x is None:
        return None  # table-less banks (scan backend) have None leaves
    return jax.device_put(x, NamedSharding(mesh, spec))


def shard_state(mesh: Mesh, state: SolverState) -> SolverState:
    nl = state.transfer.shape[0] if state.transfer.ndim == 3 else 1
    specs = state_specs(nl, complex_rows=state.transfer_im is not None)
    return jax.tree.map(lambda x, s: _put(mesh, x, s), state, specs,
                        is_leaf=lambda x: x is None)


def shard_bank(mesh: Mesh, bank: ModalBank) -> ModalBank:
    specs = bank_specs(bank)
    return jax.tree.map(lambda x, s: _put(mesh, x, s), bank, specs,
                        is_leaf=lambda x: x is None)
