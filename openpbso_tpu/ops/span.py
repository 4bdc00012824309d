"""Span integrator — N samples (many blocks) in one matmul-shaped dispatch.

The heterogeneous-bank bottleneck of the per-block form: per-object
lam-power tables are [O, M, S]-sized memory traffic in the blocked form
(~1 GB/block at 256x1024x512), and a chunk-serial kernel that avoids the
traffic does ~6 M*S elementwise ops per object per block. Both keep the
per-dispatch floor of the hot loop they inherit from the reference
(modal_integrator.h:104-113: one serial IIR step per sample).

This module removes the serial dependency entirely with a *baby-step /
giant-step* factorization of the lam powers over a span of N = n_blocks * S
samples:

    lam^(x*R + r) = lam^(x*R) * lam^r        x in [0, X], r in [0, R]

with N = X * R. Host-precomputed float64 factor tables A[x] = lam^(xR)
("giant") and B[r] = lam^r ("baby") are O((X + R) * M) per object instead of
O(N * M), and every per-sample quantity becomes a matmul (per force slot k,
the per-slot decomposition of the reference's block-granular rank-1 force,
ops/forces.py::force_span):

    hom[x*R + r - 1] = Im( sum_m (A[x] t z)_m B[r]_m )    [O,X,M] @ [O,M,R]
    g_k[x*R + r]     = Im( sum_m (A[x] t b e_k)_m B[r]_m ) [O,KX,M] @ [O,M,R]
    F_k,m (state inject) = sum_x A[x]_m (sum_r f_k_rev[xR+r] B[r]_m)
                                                           [O,KX,R] @ [O,R,M]
    sound = hom + sum_k causal_conv(g_k, f_k)   (one FFT pair over 2N)
    z'    = lam^N z + sum_k b e_k F_k           (lam^N = A[X])

For shared banks the batched einsums collapse to single giant matmuls
([O*X, M] @ [M, R]). Because every sample's power is a product of two
f64-derived factors, there is *no* accumulated phase rounding within a span
(better than a chunk-serial recurrence); across spans the state advances
by the f64-derived lam^N.

Semantics are identical to running step_block_blocked n_blocks times with the
same constant transfer and no sustained channel (the caller gates sustained
scenes to the per-block path; force slots are pure functions of the sample
clock, so hits scheduled anywhere inside the span fire at the right sample).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .coeffs import ModalBank, _power_table, round_up
from .integrator import PRECISION, _complex_weights


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SpanTables:
    """Factored lam-power tables for one span length.

    a_*: [Og, X+1, M] giant steps lam^(x*R); b_*: [Og, R+1, M] baby steps
    lam^r. Og == 1 for shared banks (every object one mode set).
    """
    a_re: jax.Array
    a_im: jax.Array
    b_re: jax.Array
    b_im: jax.Array

    @property
    def big_steps(self) -> int:
        return self.a_re.shape[1] - 1

    @property
    def radix(self) -> int:
        return self.b_re.shape[1] - 1

    @property
    def span(self) -> int:
        return self.big_steps * self.radix

    @property
    def shared(self) -> bool:
        return self.a_re.shape[0] == 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FullSpanTables:
    """One shared [M, N+1] lam-power table (shared banks only).

    For a shared bank the factored form's [O, X, M] row intermediates cost
    more memory traffic than simply holding every power: the table is static across
    spans, and the whole span becomes three giant [O(K), M] @ [M, N]
    matmuls with no intermediates at all (the span generalization of the
    blocked backend's shared-table fast path, ops/integrator._mode_reduce).
    """
    p_re: jax.Array   # [M, N+1]
    p_im: jax.Array

    @property
    def span(self) -> int:
        return self.p_re.shape[-1] - 1

    @property
    def shared(self) -> bool:
        return True


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ChunkSpanTables:
    """Baby-table-only span form: chunk kernels + a chunk-state scan.

    The conv-based span forms pay one length-2N FFT triple per span.
    This form needs only lam^r for r in [0, C] ([Og, C+1, M]): forces
    inject per-chunk states (a batched matmul), a C-strided lax.scan
    propagates them (X = N/C steps of one [O, M] complex multiply-add),
    and one more matmul renders every chunk's homogeneous response from
    its start state. Within-chunk causal convs are [C, C] Toeplitz
    batched matmuls. No FFT anywhere; everything is a matmul.

    Accuracy class: chunk-serial lam^C rotation in f32 (like the blocked
    per-block path) — phase error accrues per chunk, not per sample.
    """
    b_re: jax.Array   # [Og, C+1, M]
    b_im: jax.Array
    n_chunks: int = dataclasses.field(metadata=dict(static=True))
    s_re: jax.Array | None = None   # [Og, G+1, M] SUPERCHUNK powers
    s_im: jax.Array | None = None   # lam^(dC) for d in [0, G]: the
    #   two-level hierarchy that turns most of the X-step chunk-state
    #   scan into matmuls (the scan is X sequential loop steps; with
    #   G-grouping the serial length drops to X/G)

    @property
    def chunk(self) -> int:
        return self.b_re.shape[1] - 1

    @property
    def span(self) -> int:
        return self.chunk * self.n_chunks

    @property
    def shared(self) -> bool:
        return self.b_re.shape[0] == 1

    @property
    def superchunk(self) -> int:
        """Chunks per superchunk group (1 = plain single-level scan)."""
        return 1 if self.s_re is None else self.s_re.shape[1] - 1


def choose_radix(span: int, target: int | None = None) -> int:
    """Largest divisor of ``span`` <= target (baby-table length R).

    Default target scales with the span: ``min(512, max(64, span // 8))``
    — at least ~8 chunks reuse each table load, capped at 512 because the
    within-chunk Toeplitz conv work scales with C*N. Single-block spans
    (the live per-block path) get chunk 64: there table traffic
    dominates, so small chunks win. These targets were tuned on earlier
    hardware and have not been re-swept on the GPU (ROADMAP Speed item 4).

    Larger chunks also mean FEWER serial f32 lam^C rotations (better
    phase accuracy). NOTE the Toeplitz intermediate is [O, K, C, C]: at
    C=512 a full 16-slot table materializes ~4.3 GB — the session's
    slot-bucket gating (usually K=1) keeps this small.
    """
    if target is None:
        target = min(512, max(64, span // 8))
    for r in range(min(target, span), 0, -1):
        if span % r == 0:
            return r
    return 1


def build_span_tables(
    lam64: np.ndarray,
    span: int,
    *,
    radix: int | None = None,
    num_modes: int | None = None,
    pad_modes_to: int = 128,
    shared: bool | None = None,
    dtype=jnp.float32,
    form: str = "auto",
    hetero_superchunk: bool = False,
):
    """Span tables from the float64 eigenvalues (NOT the bank's f32 cast:
    lam^N amplifies base rounding by N, so the f64 source is required —
    same reason the blocked tables are host-f64, ops/coeffs.py).

    ``lam64``: [M] or [O, M] complex128 (as returned by lambda_from_modes);
    modes are zero-padded to ``num_modes`` (or a lane multiple).
    ``form``: 'chunked' (ChunkSpanTables, FFT-free — the default for
    shared AND heterogeneous banks), 'factored'
    (baby/giant SpanTables + FFT conv), 'full' (one [M, N+1]
    FullSpanTables + FFT conv, shared banks only), or 'auto' (= chunked).
    """
    lam = np.atleast_2d(np.asarray(lam64, np.complex128))
    o, m = lam.shape
    mp = num_modes if num_modes is not None else round_up(m, pad_modes_to)
    if mp < m:
        raise ValueError(f"num_modes {mp} < actual modes {m}")
    lam = np.pad(lam, ((0, 0), (0, mp - m)))
    if shared is None:
        shared = o == 1 or all(np.array_equal(lam[0], lam[i])
                               for i in range(1, o))
    src = lam[:1] if shared else lam
    if form == "auto":
        form = "chunked"
    # radix doubles as the chunk size in the chunked form; the full form
    # needs neither (it holds every power)
    r = radix if radix is not None else choose_radix(span)
    if form != "full" and span % r:
        raise ValueError(f"radix {r} does not divide span {span}")
    if form == "chunked":
        b = np.moveaxis(_power_table(src, r), -1, 1)
        x = span // r
        # two-level hierarchy: group G chunks per superchunk so the
        # X-step serial scan shrinks to X/G (shared banks: the [G, G]
        # within-group mixing becomes matmuls). For PER-OBJECT banks an
        # einsum form's [O, G, G, M] mixing tables cost more than the
        # scan; the scan-mix form (_chunk_start_states pass A/C:
        # 2G + X/G serial steps, no blowup table) is OPT-IN via
        # ``hetero_superchunk`` pending a GPU A/B — parity is
        # contract-tested either way (tests/test_span.py).
        g_cap = 32 if (shared or hetero_superchunk) else 1
        g = 1
        if x >= 64:
            for cand in range(min(g_cap, x), 1, -1):
                if x % cand == 0:
                    g = cand
                    break
        s_re = s_im = None
        if g > 1:
            s = np.moveaxis(_power_table(
                src, np.arange(g + 1, dtype=np.int64) * r), -1, 1)
            s_re = jnp.asarray(s.real, dtype)
            s_im = jnp.asarray(s.imag, dtype)
        return ChunkSpanTables(b_re=jnp.asarray(b.real, dtype),
                               b_im=jnp.asarray(b.imag, dtype),
                               n_chunks=x, s_re=s_re, s_im=s_im)
    if form == "full":
        if not shared:
            raise ValueError("full span tables need a shared bank "
                             "([O, M, N] would defeat the purpose)")
        p = _power_table(src[0], span)          # [M, N+1]
        return FullSpanTables(p_re=jnp.asarray(p.real, dtype),
                              p_im=jnp.asarray(p.imag, dtype))
    # _power_table puts the exponent axis last; tables are [Og, rows, M]
    x = span // r
    a = np.moveaxis(_power_table(src, np.arange(x + 1, dtype=np.int64) * r),
                    -1, 1)
    b = np.moveaxis(_power_table(src, r), -1, 1)
    return SpanTables(
        a_re=jnp.asarray(a.real, dtype), a_im=jnp.asarray(a.imag, dtype),
        b_re=jnp.asarray(b.real, dtype), b_im=jnp.asarray(b.imag, dtype),
    )


def _contract_xr(w: jax.Array, tbl: jax.Array) -> jax.Array:
    """sum_m w[o,x,m] tbl[og,r,m] -> [o,x,r]; one giant matmul when shared."""
    if tbl.shape[0] == 1:
        o, x, m = w.shape
        out = jnp.matmul(w.reshape(o * x, m), tbl[0].T, precision=PRECISION)
        return out.reshape(o, x, -1)
    return jnp.einsum("oxm,orm->oxr", w, tbl, precision=PRECISION)


def _slot_conv_fft(g: jax.Array, f_k: jax.Array, n: int,
                   dtype) -> jax.Array:
    """sum_k causal_conv(g[:, k], f_k[:, k]) via one padded FFT triple
    (conv is linear, so the slot sum happens in the frequency domain).
    Shared by the factored and full span forms."""
    nf = 2 * n
    conv_f = jnp.sum(jnp.fft.rfft(g, n=nf, axis=-1)
                     * jnp.fft.rfft(f_k, n=nf, axis=-1), axis=1)
    return jnp.fft.irfft(conv_f, n=nf, axis=-1)[..., :n].astype(dtype)


def _contract_xm(f: jax.Array, tbl: jax.Array) -> jax.Array:
    """sum_r f[o,x,r] tbl[og,r,m] -> [o,x,m]; one giant matmul when shared."""
    if tbl.shape[0] == 1:
        o, x, r = f.shape
        out = jnp.matmul(f.reshape(o * x, r), tbl[0], precision=PRECISION)
        return out.reshape(o, x, -1)
    return jnp.einsum("oxr,orm->oxm", f, tbl, precision=PRECISION)


@jax.jit
def integrate_span(
    z_re: jax.Array,            # [O, M]
    z_im: jax.Array,            # [O, M]
    bank: ModalBank,
    tables: SpanTables,
    space_k: jax.Array,         # [O, K, M] per-slot modal amplitudes
    f_k: jax.Array,             # [O, K, N] per-slot effective profiles
    transfer: jax.Array,        # [O, M]
    transfer_im: jax.Array | None = None,
):
    """Integrate one span. Returns (z_re', z_im', sound [O, N]).

    The excitation is the per-slot decomposition of the reference's
    block-granular rank-1 force (ops/forces.py::force_span): slot k
    contributes space_k x f_k; summing the per-slot responses reproduces
    n_blocks sequential step_block_blocked calls (constant transfer, no
    sustained channel) to f32 reduction-order noise.
    """
    o, m = z_re.shape
    k = space_k.shape[1]
    n = f_k.shape[-1]
    assert tables.span == n, (
        f"span tables built for {tables.span} samples, got {n}")
    if isinstance(tables, ChunkSpanTables):
        return _integrate_span_chunked(z_re, z_im, bank, tables, space_k,
                                       f_k, transfer, transfer_im)
    if transfer_im is not None:
        raise ValueError("complex transfer rows need the chunked span "
                         "form (build_span_tables form='chunked')")
    if transfer.ndim == 3:
        raise ValueError("multi-listener transfer rows need the chunked "
                         "span form (build_span_tables form='chunked')")
    if isinstance(tables, FullSpanTables):
        return _integrate_span_full(z_re, z_im, bank, tables, space_k, f_k,
                                    transfer)
    x, r = tables.big_steps, tables.radix
    a_re, a_im = tables.a_re, tables.a_im
    b_re, b_im = tables.b_re, tables.b_im
    dtype = z_re.dtype

    tmask = transfer * bank.mask
    tz_re = (tmask * z_re)[:, None, :]
    tz_im = (tmask * z_im)[:, None, :]
    axr, axi = a_re[:, :x], a_im[:, :x]        # giant rows 0..X-1

    # hom[n = x*R + rr] = Im(A[x] B[rr+1] z) . t  for rr in [0, R)
    wh_re = axr * tz_re - axi * tz_im          # [O, X, M]
    wh_im = axi * tz_re + axr * tz_im
    hom = (_contract_xr(wh_re, b_im[:, 1:])
           + _contract_xr(wh_im, b_re[:, 1:])).reshape(o, n)

    # per-slot forced response: g_k[d = x*R + r] = Im(A[x] B[r] b e_k) . t
    be_re = bank.b_re[:, None, :] * space_k    # [O, K, M]
    be_im = bank.b_im[:, None, :] * space_k
    tb_re = tmask[:, None, None, :] * be_re[:, :, None, :]   # [O, K, 1, M]
    tb_im = tmask[:, None, None, :] * be_im[:, :, None, :]
    wg_re = (axr[:, None] * tb_re - axi[:, None] * tb_im).reshape(
        o, k * x, m)
    wg_im = (axi[:, None] * tb_re + axr[:, None] * tb_im).reshape(
        o, k * x, m)
    g = (_contract_xr(wg_re, b_im[:, :r])
         + _contract_xr(wg_im, b_re[:, :r])).reshape(o, k, n)

    sound = hom + _slot_conv_fft(g, f_k, n, dtype)

    # state injection per slot: F_k,m = sum_d lam^d f_k_rev[d], d = x*R + rr
    f_rev = f_k[:, :, ::-1].reshape(o, k * x, r)
    t_re = _contract_xm(f_rev, b_re[:, :r]).reshape(o, k, x, m)
    t_im = _contract_xm(f_rev, b_im[:, :r]).reshape(o, k, x, m)
    fk_re = jnp.sum(axr[:, None] * t_re - axi[:, None] * t_im, axis=2)
    fk_im = jnp.sum(axi[:, None] * t_re + axr[:, None] * t_im, axis=2)
    inj_re = jnp.sum(be_re * fk_re - be_im * fk_im, axis=1)   # [O, M]
    inj_im = jnp.sum(be_re * fk_im + be_im * fk_re, axis=1)

    pn_re, pn_im = a_re[:, x], a_im[:, x]      # lam^N
    z_re_out = pn_re * z_re - pn_im * z_im + inj_re
    z_im_out = pn_im * z_re + pn_re * z_im + inj_im
    return z_re_out, z_im_out, sound


def _chunk_start_states(z_re, z_im, inj_re, inj_im,
                        tables: ChunkSpanTables):
    """Propagate z_{x+1} = lam^C z_x + inj[x] across X chunks; returns
    (z_final_re, z_final_im, starts_re [O, X, M], starts_im).

    Single-level: one X-step lax.scan (loop-overhead bound at
    [256, 1024]). Two-level (when the
    tables carry superchunk powers lam^(dC), d in [0, G]): group G chunks,
    scan only the X/G group boundaries, and produce each group's interior
    starts with matmul-shaped mixing —

        Z_{g+1}   = lam^(GC) Z_g + sum_j lam^((G-1-j)C) inj[gG + j]
        z_{gG+j}  = lam^(jC) Z_g + sum_{i<j} lam^((j-1-i)C) inj[gG + i]

    the exact factorization that span-formed the per-sample recurrence,
    applied once more at chunk level (round-2 VERDICT item 9).
    """
    o, m = z_re.shape
    x = tables.n_chunks
    b_re, b_im = tables.b_re, tables.b_im
    c = tables.chunk
    g = tables.superchunk
    decay = inj_re is None
    if g <= 1 or x % g:
        pc_re, pc_im = b_re[:, c], b_im[:, c]          # [Og, M]

        def body(carry, inj_x):
            zr, zi = carry
            zr_n = pc_re * zr - pc_im * zi
            zi_n = pc_im * zr + pc_re * zi
            if inj_x is not None:
                zr_n = zr_n + inj_x[0]
                zi_n = zi_n + inj_x[1]
            return (zr_n, zi_n), (zr, zi)

        xs = (None if decay else
              (jnp.moveaxis(inj_re, 1, 0), jnp.moveaxis(inj_im, 1, 0)))
        (zr_f, zi_f), (zs_re, zs_im) = jax.lax.scan(
            body, (z_re, z_im), xs, length=x)
        return (zr_f, zi_f, jnp.moveaxis(zs_re, 0, 1),
                jnp.moveaxis(zs_im, 0, 1))

    s_re, s_im = tables.s_re, tables.s_im              # [Og, G+1, M]
    shared = tables.shared
    xg = x // g
    rot_re, rot_im = s_re[:, g], s_im[:, g]            # lam^(GC)
    if not decay:
        ir = inj_re.reshape(o, xg, g, m)
        ii = inj_im.reshape(o, xg, g, m)
        if shared:
            # group injection: INJ_g = sum_j lam^((G-1-j)C) inj[g, j]
            wfr = jnp.flip(s_re[:, :g], axis=1)        # [1, G, M]
            wfi = jnp.flip(s_im[:, :g], axis=1)

            def esum(spec, a, b):
                # these contract up to G=32 products into the
                # CHUNK-START STATES feeding the whole span's homogeneous
                # render — pinned like every other correctness-critical
                # contraction (ops/integrator.PRECISION)
                return jnp.einsum(spec, a, b, precision=PRECISION)

            inj_g_re = (esum("oxjm,jm->oxm", ir, wfr[0])
                        - esum("oxjm,jm->oxm", ii, wfi[0]))
            inj_g_im = (esum("oxjm,jm->oxm", ir, wfi[0])
                        + esum("oxjm,jm->oxm", ii, wfr[0]))
        else:
            # PER-OBJECT banks, three-pass scan form: an einsum form's
            # [O, G, G, M] mixing tables cost more memory traffic than
            # the single-level scan they would replace. Group-aggregated injections instead ride
            # a G-step scan over [O, X/G, M] — every group in parallel,
            # only lam^C needed — cutting the serial length to
            # 2G + X/G (pass C below emits the interiors the same way).
            pc_re = b_re[:, c][:, None, :]             # lam^C [O, 1, M]
            pc_im = b_im[:, c][:, None, :]
            ir_j = jnp.moveaxis(ir, 2, 0)              # [G, O, XG, M]
            ii_j = jnp.moveaxis(ii, 2, 0)

            def abody(carry, inj_j):
                ar, ai = carry
                return (pc_re * ar - pc_im * ai + inj_j[0],
                        pc_im * ar + pc_re * ai + inj_j[1]), None

            zero = jnp.zeros((o, xg, m), ir.dtype)
            (inj_g_re, inj_g_im), _ = jax.lax.scan(
                abody, (zero, zero), (ir_j, ii_j))

    def gbody(carry, inj_x):
        zr, zi = carry
        zr_n = rot_re * zr - rot_im * zi
        zi_n = rot_im * zr + rot_re * zi
        if inj_x is not None:
            zr_n = zr_n + inj_x[0]
            zi_n = zi_n + inj_x[1]
        return (zr_n, zi_n), (zr, zi)

    xs = (None if decay else
          (jnp.moveaxis(inj_g_re, 1, 0), jnp.moveaxis(inj_g_im, 1, 0)))
    (zr_f, zi_f), (zg_re, zg_im) = jax.lax.scan(
        gbody, (z_re, z_im), xs, length=xg)
    zg_re = jnp.moveaxis(zg_re, 0, 1)                  # [O, XG, M]
    zg_im = jnp.moveaxis(zg_im, 0, 1)

    if not decay and not shared:
        # pass C: re-run the within-group recurrence from every group's
        # start state simultaneously, emitting the interior chunk starts
        # (z emitted BEFORE the update = start-of-chunk state)
        def cbody(carry, inj_j):
            wr, wi = carry
            return (pc_re * wr - pc_im * wi + inj_j[0],
                    pc_im * wr + pc_re * wi + inj_j[1]), (wr, wi)

        _, (ws_re, ws_im) = jax.lax.scan(cbody, (zg_re, zg_im),
                                         (ir_j, ii_j))
        # ws [G, O, XG, M] -> x-major [O, X, M] with x = q*G + j
        zs_re = jnp.moveaxis(ws_re, 0, 2).reshape(o, x, m)
        zs_im = jnp.moveaxis(ws_im, 0, 2).reshape(o, x, m)
        return zr_f, zi_f, zs_re, zs_im

    # interior starts: lam^(jC) Z_g (carry term) + within-group mixing
    car_re = (zg_re[:, :, None, :] * s_re[:, None, :g, :]
              - zg_im[:, :, None, :] * s_im[:, None, :g, :])
    car_im = (zg_re[:, :, None, :] * s_im[:, None, :g, :]
              + zg_im[:, :, None, :] * s_re[:, None, :g, :])
    if decay:
        return (zr_f, zi_f, car_re.reshape(o, x, m),
                car_im.reshape(o, x, m))
    # T2[j, i] = lam^((j-1-i)C) for i < j, 0 otherwise (gp2[0] = 0 makes
    # the clipped gather self-masking)
    gp2_re = jnp.concatenate([jnp.zeros_like(s_re[:, :1]), s_re], axis=1)
    gp2_im = jnp.concatenate([jnp.zeros_like(s_im[:, :1]), s_im], axis=1)
    delta = np.arange(g)[:, None] - np.arange(g)[None, :]   # j - i
    didx = jnp.asarray(delta.clip(0))
    t2_re = jnp.take(gp2_re, didx, axis=1)             # [1, G, G, M]
    t2_im = jnp.take(gp2_im, didx, axis=1)

    def esum2(spec, a, b):
        return jnp.einsum(spec, a, b, precision=PRECISION)

    mix_re = (esum2("oxim,jim->oxjm", ir, t2_re[0])
              - esum2("oxim,jim->oxjm", ii, t2_im[0]))
    mix_im = (esum2("oxim,jim->oxjm", ir, t2_im[0])
              + esum2("oxim,jim->oxjm", ii, t2_re[0]))
    zs_re = (car_re + mix_re).reshape(o, x, m)
    zs_im = (car_im + mix_im).reshape(o, x, m)
    return zr_f, zi_f, zs_re, zs_im


def _integrate_span_chunked(z_re, z_im, bank, tables: ChunkSpanTables,
                            space_k, f_k, transfer, transfer_im=None):
    """FFT-free span: per-chunk force injection + chunk-state scan +
    cross-chunk hom, all matmul-shaped (see ChunkSpanTables).

    ``transfer`` may carry a leading listener axis ([L, O, M] -> sound
    [O, L, N]): the state/injection work is listener-independent, so L
    listeners sharing one oscillator state pay only L-fold mode-reduces.
    NOTE the multi-listener sound layout is [O, L, N] (listener axis
    *inside*): every per-object contraction batches on O, so this is the
    layout the contractions produce contiguously — transposing to
    [L, O, N] would cost a full extra memory round trip of the largest
    tensor in the span."""
    o, m = z_re.shape
    k = space_k.shape[1]
    n = f_k.shape[-1]
    c, x = tables.chunk, tables.n_chunks
    b_re, b_im = tables.b_re, tables.b_im
    dtype = z_re.dtype
    multi = transfer.ndim == 3
    nl = transfer.shape[0] if multi else 1
    tmask = transfer * bank.mask
    timask = None if transfer_im is None else transfer_im * bank.mask
    be_re = bank.b_re[:, None, :] * space_k            # [O, K, M]
    be_im = bank.b_im[:, None, :] * space_k
    if multi:
        # [O, L, M]: the only transpose in the multi path (L*O*M, small)
        tmask_t = jnp.swapaxes(tmask, 0, 1)
        timask_t = None if timask is None else jnp.swapaxes(timask, 0, 1)

    # short per-slot kernels g_k[d] = Im(B[d] t b e_k) . 1, d in [0, C);
    # complex transfers reshuffle the pre-products (_complex_weights)
    if multi:
        w_pr, w_pi = _complex_weights(
            tmask_t[:, :, None, :],
            None if timask_t is None else timask_t[:, :, None, :],
            be_re[:, None, :, :], be_im[:, None, :, :])
        tb_pr = w_pr.reshape(o, nl * k, m)
        tb_pi = w_pi.reshape(o, nl * k, m)
    else:
        tb_pr, tb_pi = _complex_weights(
            tmask[:, None, :],
            None if timask is None else timask[:, None, :],
            be_re, be_im)
    g = (_contract_xr(tb_pr, b_re[:, :c])
         + _contract_xr(tb_pi, b_im[:, :c]))           # [O, (L*)K, C]

    # within-chunk causal conv: Toeplitz batched matmul, summed over slots
    fc = f_k.reshape(o, k, x, c)
    delta = np.arange(c)[:, None] - np.arange(c)[None, :]
    t_g = jnp.take(g, jnp.asarray(delta.clip(0)), axis=-1) \
        * jnp.asarray(delta >= 0, dtype)               # [O, K, C(out), C(in)]
    if multi:
        conv = jnp.einsum("olkcj,okxj->olxc",
                          t_g.reshape(o, nl, k, c, c), fc,
                          precision=PRECISION)         # [O, L, X, C]
    else:
        conv = jnp.einsum("okcj,okxj->oxc", t_g, fc,
                          precision=PRECISION)         # [O, X, C]

    # per-chunk modal force gathers: t_k = sum_j B[C-1-j] f_chunk[j]
    rows = fc[..., ::-1].reshape(o, k * x, c)
    t_re = _contract_xm(rows, b_re[:, :c]).reshape(o, k, x, m)
    t_im = _contract_xm(rows, b_im[:, :c]).reshape(o, k, x, m)
    inj_re = jnp.sum(be_re[:, :, None, :] * t_re
                     - be_im[:, :, None, :] * t_im, axis=1)  # [O, X, M]
    inj_im = jnp.sum(be_re[:, :, None, :] * t_im
                     + be_im[:, :, None, :] * t_re, axis=1)

    # chunk-state propagation: z_{x+1} = lam^C z_x + inj[x]; emits every
    # chunk's start state (single-level scan, or the two-level superchunk
    # hierarchy when the tables carry lam^(dC) powers)
    zr_f, zi_f, zs_re, zs_im = _chunk_start_states(
        z_re, z_im, inj_re, inj_im, tables)

    # cross-chunk hom from each chunk's start state: Im(B[1..C] t z_x)
    if multi:
        w_pr, w_pi = _complex_weights(
            tmask_t[:, :, None, :],
            None if timask_t is None else timask_t[:, :, None, :],
            zs_re[:, None, :, :], zs_im[:, None, :, :])
        hom = (_contract_xr(w_pr.reshape(o, nl * x, m), b_re[:, 1:])
               + _contract_xr(w_pi.reshape(o, nl * x, m),
                              b_im[:, 1:]))            # [O, L*X, C]
        sound = (hom.reshape(o, nl, x, c) + conv).reshape(o, nl, n)
    else:
        w_pr, w_pi = _complex_weights(
            tmask[:, None, :],
            None if timask is None else timask[:, None, :],
            zs_re, zs_im)
        hom = (_contract_xr(w_pr, b_re[:, 1:])
               + _contract_xr(w_pi, b_im[:, 1:]))      # [O, X, C]
        sound = (hom + conv).reshape(o, n)
    return zr_f, zi_f, sound


def _integrate_span_full(z_re, z_im, bank, tables: FullSpanTables,
                         space_k, f_k, transfer):
    """Shared-bank span via the full [M, N+1] power table: three giant
    matmul pairs, no per-object tables, no row intermediates."""
    o, m = z_re.shape
    k = space_k.shape[1]
    n = f_k.shape[-1]
    dtype = z_re.dtype
    p_re, p_im = tables.p_re, tables.p_im          # [M, N+1]
    tmask = transfer * bank.mask

    def mm(a, b):
        return jnp.matmul(a, b, precision=PRECISION)

    # hom[o, s] = Im(P_{s+1} z) . t
    hom = mm(tmask * z_im, p_re[:, 1:]) + mm(tmask * z_re, p_im[:, 1:])

    # per-slot g_k[d] = Im(P_d b e_k) . t
    be_re = bank.b_re[:, None, :] * space_k        # [O, K, M]
    be_im = bank.b_im[:, None, :] * space_k
    tb_re = (tmask[:, None, :] * be_re).reshape(o * k, m)
    tb_im = (tmask[:, None, :] * be_im).reshape(o * k, m)
    g = (mm(tb_re, p_im[:, :n]) + mm(tb_im, p_re[:, :n])).reshape(o, k, n)

    sound = hom + _slot_conv_fft(g, f_k, n, dtype)

    # state injection: F_k,m = sum_d P_d f_k_rev[d]
    f_rev = f_k[:, :, ::-1].reshape(o * k, n)
    fk_re = mm(f_rev, p_re[:, :n].T).reshape(o, k, m)
    fk_im = mm(f_rev, p_im[:, :n].T).reshape(o, k, m)
    inj_re = jnp.sum(be_re * fk_re - be_im * fk_im, axis=1)
    inj_im = jnp.sum(be_re * fk_im + be_im * fk_re, axis=1)

    pn_re, pn_im = p_re[:, n], p_im[:, n]          # lam^N
    z_re_out = pn_re * z_re - pn_im * z_im + inj_re
    z_im_out = pn_im * z_re + pn_re * z_im + inj_im
    return z_re_out, z_im_out, sound


@jax.jit
def decay_span(
    z_re: jax.Array,
    z_im: jax.Array,
    bank: ModalBank,
    tables: SpanTables,
    transfer: jax.Array,
    transfer_im: jax.Array | None = None,
):
    """Homogeneous-only span (scene ringing down, zero excitation).

    The G/conv/state-injection terms of integrate_span vanish exactly; what
    remains is the hom matmul pair and the lam^N state rotation — the span
    generalization of ops/integrator.decay_block_blocked.
    """
    o, m = z_re.shape
    n = tables.span
    if transfer_im is not None and not isinstance(tables, ChunkSpanTables):
        raise ValueError("complex transfer rows need the chunked span "
                         "form (build_span_tables form='chunked')")
    if isinstance(tables, ChunkSpanTables):
        c, x = tables.chunk, tables.n_chunks
        b_re, b_im = tables.b_re, tables.b_im
        tmask = transfer * bank.mask
        zr_f, zi_f, zs_re, zs_im = _chunk_start_states(
            z_re, z_im, None, None, tables)
        timask = None if transfer_im is None else transfer_im * bank.mask
        if transfer.ndim == 3:                         # [L, O, M] listeners
            nl = transfer.shape[0]
            tmask_t = jnp.swapaxes(tmask, 0, 1)        # [O, L, M]
            timask_t = (None if timask is None
                        else jnp.swapaxes(timask, 0, 1))
            w_pr, w_pi = _complex_weights(
                tmask_t[:, :, None, :],
                None if timask_t is None else timask_t[:, :, None, :],
                zs_re[:, None, :, :], zs_im[:, None, :, :])
            sound = (_contract_xr(w_pr.reshape(o, nl * x, m), b_re[:, 1:])
                     + _contract_xr(w_pi.reshape(o, nl * x, m),
                                    b_im[:, 1:]))
            # [O, L, N]: listener axis inside (see _integrate_span_chunked)
            return zr_f, zi_f, sound.reshape(o, nl, n)
        w_pr, w_pi = _complex_weights(
            tmask[:, None, :],
            None if timask is None else timask[:, None, :],
            zs_re, zs_im)
        sound = (_contract_xr(w_pr, b_re[:, 1:])
                 + _contract_xr(w_pi, b_im[:, 1:])).reshape(o, n)
        return zr_f, zi_f, sound
    if transfer.ndim == 3:
        raise ValueError("multi-listener transfer rows need the chunked "
                         "span form (build_span_tables form='chunked')")
    if isinstance(tables, FullSpanTables):
        p_re, p_im = tables.p_re, tables.p_im
        tmask = transfer * bank.mask
        sound = (jnp.matmul(tmask * z_im, p_re[:, 1:], precision=PRECISION)
                 + jnp.matmul(tmask * z_re, p_im[:, 1:],
                              precision=PRECISION))
        pn_re, pn_im = p_re[:, n], p_im[:, n]
        return (pn_re * z_re - pn_im * z_im,
                pn_im * z_re + pn_re * z_im, sound)
    x = tables.big_steps
    a_re, a_im = tables.a_re, tables.a_im
    b_re, b_im = tables.b_re, tables.b_im
    tmask = transfer * bank.mask
    tz_re = (tmask * z_re)[:, None, :]
    tz_im = (tmask * z_im)[:, None, :]
    axr, axi = a_re[:, :x], a_im[:, :x]
    wh_re = axr * tz_re - axi * tz_im
    wh_im = axi * tz_re + axr * tz_im
    sound = (_contract_xr(wh_re, b_im[:, 1:])
             + _contract_xr(wh_im, b_re[:, 1:])).reshape(o, n)
    pn_re, pn_im = a_re[:, x], a_im[:, x]
    z_re_out = pn_re * z_re - pn_im * z_im
    z_im_out = pn_im * z_re + pn_re * z_im
    return z_re_out, z_im_out, sound
