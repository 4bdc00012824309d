"""FFAT acoustic-transfer maps on device — gather-based cubemap lookup.

The reference evaluates, per listener move, one cubemap bilinear lookup per
mode on the CPU (ffat_solver.h:677-803, 1180-1214). Here the decoded maps
become dense device arrays and the lookup is a fully vectorized
intersect/gather/reconstruct over every (object, mode) at once.

Layout: per-face amplitude grids are kept in the reference's *flat* row-major
indexing (``stride[face] + u * Nv[face] + v``, ffat_solver.h:141-144) so the
file's Psi vector uploads unchanged; the flat axis is padded to a lane
multiple. Geometry (bboxes, face low-corners, strides) is carried per
(object, mode) but stored once (leading axis 1) when all objects share the
same model — the common instanced-scene case.

All math is elementwise/gather, runs at listener-update rate
(UI rate, not audio rate), and differentiates cleanly if needed.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..io.fatcube import FatcubeMap
from .coeffs import round_up


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceFFAT:
    """Device-resident FFAT maps for a batch of objects.

    Leading geometry axis ``Og`` is 1 (shared across objects) or O. ``M`` is
    the padded mode count; modes without a map have ``mode_mask`` 0 and yield
    zero transfer (the reference's q.head(N) dot, modal_solver.h:267-269).
    """
    psi: jax.Array          # [Og, M, P] flat amplitudes (padded)
    k: jax.Array            # [Og, M] wavenumber per mode
    center: jax.Array       # [Og, M, 3]
    bbox_low: jax.Array     # [Og, M, 3]
    bbox_top: jax.Array     # [Og, M, 3]
    low_corners: jax.Array  # [Og, M, 6, 3]
    n_elements: jax.Array   # [Og, M, 6, 2] int32 (Nu, Nv)
    strides: jax.Array      # [Og, M, 6] int32
    mode_mask: jax.Array    # [Og, M] 1.0 where a map exists
    psi_c: jax.Array | None = None   # optional COMPRESSED amplitudes,
    #   same layout: the reference keeps both Psi sets and selects per
    #   query (GetMapVal(pos, getCompressed), ffat_solver.h:1180-1214);
    #   carrying the second texture makes the toggle a zero-rebuild
    #   runtime switch (compute_transfer(compressed=True))

    @property
    def shared(self) -> bool:
        return self.psi.shape[0] == 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FFATMaps:
    geom: DeviceFFAT
    cell_size: jax.Array    # [Og, M]


def build_ffat(
    maps: dict[int, FatcubeMap],
    num_modes: int,
    *,
    dtype=jnp.float32,
    compressed_maps: dict[int, FatcubeMap] | str | None = None,
) -> FFATMaps:
    """Pack decoded fatcube maps (mode id -> map) into device arrays.

    One geometry/texture set, shared by however many instances query it
    (the object count comes from the query positions, compute_transfer).

    ``compressed_maps`` carries the reference's SECOND Psi set for the
    runtime compressed-vs-raw toggle (GetMapVal(pos, useCompressed),
    ffat_solver.h:1180-1214): a dict of compressed FatcubeMaps (same
    geometry), or the string "auto" to run each map through
    ffat_fit.compress_map at the reference tool's JPEG quality 65.
    """
    m = num_modes
    if compressed_maps == "auto":
        from .ffat_fit import compress_map
        compressed_maps = {mid: compress_map(mm, jpeg_quality=65)
                           for mid, mm in maps.items()}
    p_max = 0
    for mm in maps.values():
        p_max = max(p_max, mm.psi.shape[0])
    p_pad = round_up(max(p_max, 1), 128)

    psi = np.zeros((1, m, p_pad), np.float64)
    k = np.ones((1, m), np.float64)
    center = np.zeros((1, m, 3), np.float64)
    bbox_low = np.zeros((1, m, 3), np.float64)
    bbox_top = np.ones((1, m, 3), np.float64)
    low_corners = np.zeros((1, m, 6, 3), np.float64)
    n_elements = np.ones((1, m, 6, 2), np.int32)
    strides = np.zeros((1, m, 6), np.int32)
    mask = np.zeros((1, m), np.float64)
    cell = np.ones((1, m), np.float64)

    for mode_id, mm in maps.items():
        if mode_id >= m:
            continue
        s = mm.shell
        psi[0, mode_id, : mm.psi.shape[0]] = mm.psi
        k[0, mode_id] = mm.k
        center[0, mode_id] = mm.center
        bbox_low[0, mode_id] = s.bbox_low
        bbox_top[0, mode_id] = s.bbox_top
        low_corners[0, mode_id] = s.low_corners
        n_elements[0, mode_id] = s.n_elements
        strides[0, mode_id] = s.strides
        mask[0, mode_id] = 1.0
        cell[0, mode_id] = s.cell_size

    psi_c = None
    if compressed_maps:
        psi_c_np = np.zeros((1, m, p_pad), np.float64)
        for mode_id, mm in compressed_maps.items():
            if mode_id < m:
                psi_c_np[0, mode_id, : mm.psi.shape[0]] = mm.psi
        psi_c = jnp.asarray(psi_c_np, dtype)
    geom = DeviceFFAT(
        psi=jnp.asarray(psi, dtype),
        k=jnp.asarray(k, dtype),
        center=jnp.asarray(center, dtype),
        bbox_low=jnp.asarray(bbox_low, dtype),
        bbox_top=jnp.asarray(bbox_top, dtype),
        low_corners=jnp.asarray(low_corners, dtype),
        n_elements=jnp.asarray(n_elements, jnp.int32),
        strides=jnp.asarray(strides, jnp.int32),
        mode_mask=jnp.asarray(mask, dtype),
        psi_c=psi_c,
    )
    return FFATMaps(geom=geom, cell_size=jnp.asarray(cell, dtype))


def build_ffat_hetero(per_object_maps: list[dict[int, FatcubeMap]],
                      num_modes: int, *, dtype=jnp.float32,
                      compressed_maps=None) -> FFATMaps:
    """Per-object FFAT maps (heterogeneous scene): geometry axis Og = O.

    ``compressed_maps``: per-object list of compressed dicts, or "auto"
    (forwarded to build_ffat per object)."""
    singles = [build_ffat(maps, num_modes, dtype=dtype,
                          compressed_maps=(compressed_maps[i]
                                           if isinstance(compressed_maps,
                                                         list)
                                           else compressed_maps))
               for i, maps in enumerate(per_object_maps)]
    p_max = max(f.geom.psi.shape[-1] for f in singles)

    def cat(get, pad_psi=False):
        parts = []
        for f in singles:
            a = get(f)
            if pad_psi and a.shape[-1] < p_max:
                a = jnp.pad(a, ((0, 0), (0, 0), (0, p_max - a.shape[-1])))
            parts.append(a)
        return jnp.concatenate(parts, axis=0)

    psi_c = (cat(lambda f: f.geom.psi_c, pad_psi=True)
             if all(f.geom.psi_c is not None for f in singles) else None)
    geom = DeviceFFAT(
        psi=cat(lambda f: f.geom.psi, pad_psi=True),
        k=cat(lambda f: f.geom.k),
        center=cat(lambda f: f.geom.center),
        bbox_low=cat(lambda f: f.geom.bbox_low),
        bbox_top=cat(lambda f: f.geom.bbox_top),
        low_corners=cat(lambda f: f.geom.low_corners),
        n_elements=cat(lambda f: f.geom.n_elements),
        strides=cat(lambda f: f.geom.strides),
        mode_mask=cat(lambda f: f.geom.mode_mask),
        psi_c=psi_c,
    )
    return FFATMaps(geom=geom, cell_size=cat(lambda f: f.cell_size))


@partial(jax.jit, static_argnames=("compressed",))
def compute_transfer(ffat: FFATMaps, listener: jax.Array,
                     compressed: bool = False) -> jax.Array:
    """Transfer magnitudes |Psi(dir)/(k r)| for every (object, mode).

    ``listener``: [O, 3] listener position relative to each object's frame
    (or [3], broadcast). Returns [O, M].

    Mirrors FFAT_Map<T,3>::GetMapVal (ffat_solver.h:1180-1214): slab-test ray
    from the listener toward the map center, nearest-plane face pick, bilinear
    interpolation with edge clamping on the outer shell, then the 1/(kr)
    reconstruct (ffat_solver.h:899-906). computeTransfer then takes the
    absolute value per mode (modal_solver.h:294-297). ``compressed=True``
    samples the second (compressed) Psi texture — the reference's
    useCompressed query flag (modal_solver.h:84-98, live ImGui toggle
    real_time_modal_sound.cpp:835-853).
    """
    g = ffat.geom
    if compressed:
        if g.psi_c is None:
            raise ValueError("FFAT maps were built without a compressed "
                             "Psi set (build_ffat compressed_maps=...)")
        g = dataclasses.replace(g, psi=g.psi_c)
    p = jnp.atleast_2d(listener)                    # [O, 3]
    # per-object maps (Og = O > 1) with a [3] listener: the broadcast
    # must widen to the GEOMETRY's object count, not the listener's
    # (round-5 review: o = p.shape[0] crashed the documented [3] form)
    o = max(p.shape[0], g.psi.shape[0])
    if p.shape[0] != o:
        p = jnp.broadcast_to(p, (o, 3))
    eps = jnp.asarray(1e-30, p.dtype)

    pm = p[:, None, :]                              # [O, 1, 3]
    d = g.center - pm                               # [Og->O, M, 3]
    d_safe = jnp.where(jnp.abs(d) < eps, eps, d)
    t_min = (g.bbox_low - pm) / d_safe
    t_max = (g.bbox_top - pm) / d_safe
    t_enter = jnp.minimum(t_min, t_max)
    t_en = jnp.max(t_enter, axis=-1, keepdims=True)  # [O, M, 1]
    surf = pm + t_en * d                             # [O, M, 3]

    # face pick: first strict minimum over the C++ scan order
    # (low0, top0, low1, top1, low2, top2) -> faces (1, 0, 3, 2, 5, 4)
    d_low = jnp.abs(g.bbox_low - surf)               # [O, M, 3]
    d_top = jnp.abs(g.bbox_top - surf)
    dists = jnp.stack([d_low[..., 0], d_top[..., 0],
                       d_low[..., 1], d_top[..., 1],
                       d_low[..., 2], d_top[..., 2]], axis=-1)
    scan_face = jnp.asarray([1, 0, 3, 2, 5, 4], jnp.int32)
    face = scan_face[jnp.argmin(dists, axis=-1)]     # [O, M]

    dk = face // 2
    di = (dk + 1) % 3
    dj = (dk + 2) % 3

    def take_axis(arr3, axis_idx):
        # arr3 [O, M, 3], axis_idx [O, M] -> [O, M]
        return jnp.take_along_axis(arr3, axis_idx[..., None],
                                   axis=-1)[..., 0]

    face_b = jnp.broadcast_to(face, surf.shape[:2])
    low_f = jnp.take_along_axis(
        jnp.broadcast_to(g.low_corners, (o,) + g.low_corners.shape[1:]),
        face_b[..., None, None].astype(jnp.int32) *
        jnp.ones((1, 1, 1, 3), jnp.int32),
        axis=2)[:, :, 0, :]                          # [O, M, 3]
    ne_f = jnp.take_along_axis(
        jnp.broadcast_to(g.n_elements, (o,) + g.n_elements.shape[1:]),
        face_b[..., None, None] * jnp.ones((1, 1, 1, 2), jnp.int32),
        axis=2)[:, :, 0, :]                          # [O, M, 2] (Nu, Nv)
    stride_f = jnp.take_along_axis(
        jnp.broadcast_to(g.strides, (o,) + g.strides.shape[1:]),
        face_b[..., None], axis=2)[..., 0]           # [O, M]

    h = ffat.cell_size                               # [Og, M] -> broadcast
    nu = ne_f[..., 0]
    nv = ne_f[..., 1]
    surf_i = take_axis(surf, di)
    surf_j = take_axis(surf, dj)
    low_i = take_axis(low_f, di)
    low_j = take_axis(low_f, dj)

    # bilinear stencil with edge clamping (ffat_solver.h:737-803)
    x_f = (surf_i - (low_i + 0.5 * h)) / h
    y_f = (surf_j - (low_j + 0.5 * h)) / h
    x = jnp.floor(x_f).astype(jnp.int32)
    y = jnp.floor(y_f).astype(jnp.int32)
    x_in = (x >= 0) & (x < nu - 1)
    y_in = (y >= 0) & (y < nv - 1)
    xc = jnp.clip(x, 0, nu - 1)
    yc = jnp.clip(y, 0, nv - 1)
    xp = jnp.where(x_in, xc + 1, xc)
    yp = jnp.where(y_in, yc + 1, yc)
    tx = jnp.where(x_in, x_f - xc.astype(x_f.dtype), 0.0)
    ty = jnp.where(y_in, y_f - yc.astype(y_f.dtype), 0.0)
    tx = jnp.clip(tx, 0.0, 1.0)
    ty = jnp.clip(ty, 0.0, 1.0)

    base = stride_f
    idx00 = base + xc * nv + yc
    idx10 = base + xp * nv + yc
    idx01 = base + xc * nv + yp
    idx11 = base + xp * nv + yp
    idx = jnp.stack([idx00, idx10, idx01, idx11], axis=-1)  # [O, M, 4]
    w = jnp.stack([(1 - tx) * (1 - ty), tx * (1 - ty),
                   (1 - tx) * ty, tx * ty], axis=-1)

    if g.shared:
        vals = jax.vmap(
            lambda ii: jnp.take_along_axis(g.psi[0], ii, axis=-1))(idx)
    else:
        vals = jnp.take_along_axis(g.psi, idx, axis=-1)
    psi = jnp.sum(vals * w, axis=-1)                 # [O, M]

    r = jnp.linalg.norm(pm - g.center, axis=-1)      # [O, M]
    kr = g.k * jnp.maximum(r, eps)
    return jnp.abs(psi / jnp.maximum(kr, eps)) * g.mode_mask
