"""StreamingEngine pipeline semantics (queues, pacing, underrun handling)."""
import time

import jax.numpy as jnp
import numpy as np

from openpbso_tpu.ops.coeffs import bank_from_material
from openpbso_tpu.runtime.audio import (RawCollectorSink, RealTimePacerSink,
                                        WavFileSink)
from openpbso_tpu.runtime.engine import BufferHealth, LatestWins, StreamingEngine
from openpbso_tpu.runtime.session import ModalSession
from openpbso_tpu.runtime.solver import SolverConfig
from openpbso_tpu.utils.synth import CERAMIC, synth_mode_data


def _engine(sink, o=1, s=256, n_modes=16):
    md = synth_mode_data(n_modes, 8)
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta, num_objects=o,
                              block_size=s, dtype=jnp.float32)
    sess = ModalSession(bank, config=SolverConfig(block_size=s,
                                                  backend="blocked"))
    sess.step()  # warm the jit cache so engine timing isn't compile-bound
    return StreamingEngine(sess, sink), md


def test_latest_wins_slot():
    slot = LatestWins()
    assert slot.take() is None
    slot.put(1)
    slot.put(2)
    assert slot.take() == 2
    assert slot.take() is None


def test_buffer_health_ring():
    h = BufferHealth(size=4)
    assert h.health == 1.0
    h.record(False)
    h.record(False)
    assert h.health == 0.5
    for _ in range(4):
        h.record(True)
    assert h.health == 1.0


def test_engine_produces_audio_from_hit():
    sink = RawCollectorSink()
    engine, md = _engine(sink)
    engine.start()
    engine.hit(0, np.ones(md.num_modes))
    time.sleep(1.0)
    engine.stop()
    audio = sink.concatenated()
    assert audio.shape[0] > 0
    assert np.abs(audio).max() > 0
    assert np.isfinite(audio).all()


def test_engine_event_types():
    sink = RawCollectorSink()
    engine, md = _engine(sink)
    engine.start()
    engine.sustained_start(0, np.ones(md.num_modes))
    engine.set_ar_params(0, a=(0.5, 0.2), sigma=0.01, mu=0.3)
    time.sleep(0.4)
    engine.sustained_end(0)
    engine.set_listener(np.asarray([1.0, 0.0, 0.0]))  # no ffat -> no-op
    engine.clear_forces()
    time.sleep(0.2)
    engine.stop()
    audio = sink.concatenated()
    assert np.abs(audio).max() > 0  # sustained AR produced sound


def test_engine_pacing_against_realtime_sink():
    """With a real-time paced consumer the producer must keep up and the
    health ring must stay near 1 (CPU synth of a small scene)."""
    sink = RealTimePacerSink()
    engine, md = _engine(sink, s=512)
    engine.start()
    engine.hit(0, np.ones(md.num_modes), kind="gaussian", width_us=2000.0)
    time.sleep(1.5)
    engine.stop()
    assert sink.total_blocks > 0
    assert engine.health.health > 0.5


def test_wav_sink_roundtrip(tmp_path):
    import wave
    path = str(tmp_path / "t.wav")
    sink = WavFileSink(path)
    sink.write(np.full((64, 2), 0.5, np.float32))
    sink.close()
    with wave.open(path) as w:
        assert w.getnchannels() == 2
        assert w.getnframes() == 64
        frames = np.frombuffer(w.readframes(64), "<i2")
        assert abs(int(frames[0]) - int(0.5 * 32767)) <= 1


def test_underrun_stale_replay():
    """When synthesis can't keep up, the consumer replays the last block and
    marks the health ring (real_time_modal_sound.cpp:203-210 semantics)."""
    import queue
    import threading
    sink = RawCollectorSink()
    engine, md = _engine(sink, s=128)
    # don't start the synth thread: hand-feed one block, then starve
    block = np.full((128, 2), 0.25, np.float32)
    engine._sound.put(block)
    t = threading.Thread(target=engine._consume_loop, daemon=True)
    engine._stop.clear()
    t.start()
    time.sleep(0.8)
    engine._stop.set()
    t.join(5.0)
    audio = sink.blocks
    assert len(audio) >= 2              # consumed + replayed stale blocks
    np.testing.assert_array_equal(audio[0], block)
    np.testing.assert_array_equal(audio[1], block)  # stale replay
    assert engine.health.health < 1.0   # underruns recorded


def test_synth_failure_is_observable():
    """A dying synthesis thread must surface via .error / .healthy instead
    of silently streaming stale blocks."""
    sink = RawCollectorSink()
    engine, md = _engine(sink)

    def boom():
        raise RuntimeError("injected device failure")

    engine.session.step = boom  # fault injection
    engine._synth_once = lambda: (_ for _ in ()).throw(
        RuntimeError("injected device failure"))
    try:
        engine.start()
    except RuntimeError:
        # warmup path may surface it synchronously — also acceptable
        return
    time.sleep(0.3)
    assert not engine.healthy
    assert isinstance(engine.error, RuntimeError)
    engine.stop()


def test_stream_exercises_all_step_variants():
    """One live stream through full, decay, xfade, and qnorm variants."""
    import time

    import jax.numpy as jnp

    from openpbso_tpu.ops.coeffs import bank_from_material
    from openpbso_tpu.ops.ffat import build_ffat
    from openpbso_tpu.runtime.audio import RawCollectorSink
    from openpbso_tpu.runtime.engine import StreamingEngine
    from openpbso_tpu.runtime.session import ModalSession
    from openpbso_tpu.runtime.solver import SolverConfig
    from openpbso_tpu.utils.synth import CERAMIC, synth_fatcube, \
        synth_mode_data

    md = synth_mode_data(12, 8, seed=3)
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta,
                              block_size=128, dtype=jnp.float32)
    freqs = md.frequencies_hz(CERAMIC.density)
    maps = {i: synth_fatcube(i, float(freqs[i]), n=8, seed=3)
            for i in range(12)}
    ffat = build_ffat(maps, bank.num_modes, dtype=jnp.float32)
    sess = ModalSession(bank, ffat=ffat, config=SolverConfig(
        block_size=128, backend="blocked", smooth_transfer=True))
    sess.set_listener(np.asarray([0.6, 0.4, 0.3]))
    sink = RawCollectorSink()
    eng = StreamingEngine(sess, sink, qnorm_every=4)
    eng.start()
    try:
        eng.hit(0, np.ones(12), kind="point")         # full variant
        time.sleep(0.3)                               # ...then decay
        eng.set_listener(np.asarray([0.1, 0.8, 0.5]))  # xfade variant
        time.sleep(0.3)
        q = eng.latest_qnorm()                        # qnorm variants
    finally:
        eng.stop()
    assert eng.error is None
    audio = sink.concatenated()
    assert audio.shape[0] > 0 and np.abs(audio).max() > 0
    assert np.isfinite(audio).all()
    assert q is not None and np.isfinite(np.asarray(q)).all()


def test_lookahead1_span_live_path():
    """A session with lam64 tables streams at lookahead=1 through the
    single-block span dispatch (the production live path) — audio
    matches the per-block step, events still apply,
    and the span cache proves the path was taken."""
    from openpbso_tpu.ops.coeffs import lambda_from_modes

    md = synth_mode_data(16, 8)
    lam64, _, _ = lambda_from_modes(CERAMIC.density, md.omega_squared,
                                    CERAMIC.alpha, CERAMIC.beta)
    s = 256

    def make(with_lam):
        bank = bank_from_material(CERAMIC.density, md.omega_squared,
                                  CERAMIC.alpha, CERAMIC.beta,
                                  num_objects=1, block_size=s,
                                  dtype=jnp.float32)
        return ModalSession(bank, config=SolverConfig(block_size=s,
                                                      backend="blocked"),
                            lam64=lam64 if with_lam else None)

    sess = make(True)
    sink = RawCollectorSink()
    engine = StreamingEngine(sess, sink, lookahead=1)
    engine.start()
    engine.hit(0, np.ones(16), kind="gaussian", width_us=500.0)
    # wait on PRODUCED blocks, generously: under heavy host load the
    # first span dispatch can compile for tens of seconds, during which
    # the consume loop pads the sink with silent underrun blocks — a
    # short fixed deadline then asserts on all-zero padding (observed
    # flake). The explicit progress assert keeps a genuine hang loud.
    deadline = time.time() + 120
    while time.time() < deadline and engine._blocks_done < 20:
        time.sleep(0.05)
    produced = engine._blocks_done
    engine.stop()
    assert engine.error is None
    assert produced >= 20, \
        f"engine produced only {produced} blocks in 120 s"
    audio = sink.concatenated()
    assert np.abs(audio).max() > 0
    # the span path compiled single-block tables => it actually ran
    assert 1 in sess._span_cache
    # sustained events fall back to the per-block path mid-stream
    sess2 = make(True)
    engine2 = StreamingEngine(sess2, RawCollectorSink(), lookahead=1)
    engine2.start()
    engine2.sustained_start(0, np.ones(16))
    t0 = time.time()
    while time.time() - t0 < 10 and engine2._blocks_done < 10:
        time.sleep(0.05)
    engine2.sustained_end(0)
    engine2.stop()
    assert engine2.error is None


def test_qnorm_cadence_with_even_lookahead():
    """Regression: a modulo-based qnorm schedule starves with lookahead>1
    (blocks advance by lookahead, landing off the modulo grid forever);
    the threshold schedule must keep telemetry flowing."""
    from openpbso_tpu.ops.coeffs import lambda_from_modes

    md = synth_mode_data(16, 8)
    lam64, _, _ = lambda_from_modes(CERAMIC.density, md.omega_squared,
                                    CERAMIC.alpha, CERAMIC.beta)
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta,
                              num_objects=1, block_size=128,
                              dtype=jnp.float32)
    sess = ModalSession(bank, config=SolverConfig(block_size=128,
                                                  backend="blocked"),
                        lam64=lam64)
    got = []
    engine = StreamingEngine(sess, RawCollectorSink(), lookahead=4,
                             qnorm_every=8, on_qnorm=None)
    engine.start()
    engine.hit(0, np.ones(16))
    deadline = time.time() + 30
    while time.time() < deadline and len(got) < 3:
        q = engine.latest_qnorm()
        if q is not None:
            got.append(q)
        time.sleep(0.01)
    engine.stop()
    assert len(got) >= 3, f"qnorm telemetry starved: {len(got)} values"


def test_qnorm_flows_alongside_span_lookahead():
    """The span+qnorm branch: telemetry rides a parallel state probe
    instead of breaking the span for a synced per-block dispatch.
    Audio and qnorm must both flow."""
    from openpbso_tpu.ops.coeffs import lambda_from_modes

    md = synth_mode_data(16, 8)
    lam64, _, _ = lambda_from_modes(CERAMIC.density, md.omega_squared,
                                    CERAMIC.alpha, CERAMIC.beta)
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta,
                              num_objects=2, block_size=128,
                              dtype=jnp.float32)
    sess = ModalSession(bank, config=SolverConfig(block_size=128,
                                                  backend="blocked"),
                        lam64=lam64)
    sink = RawCollectorSink()
    engine = StreamingEngine(sess, sink, lookahead=4, qnorm_every=8)
    engine.start()
    engine.hit(0, np.ones(16))
    got = 0
    deadline = time.time() + 30
    while time.time() < deadline and got < 3:
        if engine.latest_qnorm() is not None:
            got += 1
        time.sleep(0.01)
    engine.stop()
    assert engine.error is None
    assert got >= 3, "qnorm telemetry starved on the span path"
    assert np.abs(sink.concatenated()).max() > 0
    assert 4 in sess._span_cache   # the span actually ran


def test_double_start_refused():
    """Two synth threads racing one session would corrupt state; start()
    on a running engine must refuse."""
    import pytest as _pytest
    engine, _ = _engine(RawCollectorSink())
    engine.start()
    try:
        with _pytest.raises(RuntimeError, match="already running"):
            engine.start()
    finally:
        engine.stop()
    # a stopped engine can start again
    engine.start()
    engine.stop()


def test_restart_clears_stale_error():
    """A stopped-after-failure engine restarts clean: healthy again, the
    old error not re-raised."""
    engine, _ = _engine(RawCollectorSink())
    engine.start()
    engine.error = RuntimeError("injected")
    engine._stop.set()
    engine.stop()
    assert not engine.healthy
    engine.start()
    try:
        assert engine.healthy and engine.error is None
    finally:
        engine.stop()


def test_event_validation_on_producer_thread():
    """sustained/arparam/clear validate obj (and AR shape) at enqueue —
    a bad event applied on the synthesis thread would kill the stream."""
    import pytest as _pytest
    engine, _ = _engine(RawCollectorSink(), o=2)
    with _pytest.raises(IndexError):
        engine.sustained_start(7, np.ones(16))
    with _pytest.raises(IndexError):
        engine.sustained_end(-1)
    with _pytest.raises(IndexError):
        engine.clear_forces(5)
    with _pytest.raises(ValueError):
        engine.set_ar_params(0, a=(0.1, 0.2, 0.3))
    with _pytest.raises(IndexError):
        engine.set_ar_params(9)
