"""Smoke run of the production path on NVIDIA GPUs, at the full width.

    python chip_smoke.py               # phases 1-7 on one card
    python chip_smoke.py --multichip   # ShardedSession on four cards only

Every phase drives a user entry point (ModalSession, StreamingEngine, the
TCP AudioServer built by ``serve``'s build_server, ShardedSession) at
256 objects x 1024 modes, 512-sample blocks, 44.1 kHz, in this one
process: a second JAX process on the card would fail for want of memory.

1. device     JAX must report GPUs only; there is no CPU fallback
2. shared     one shared mode bank, a Gaussian hit on every object,
              one 512-block span through ModalSession.render_multi
3. hetero     a mode bank per object, one 1024-block span; then the
              per-block blocked step against the nb=1 span, per block
4. sustained  an AR(2) drag on every object, a 512-block drag-only span
5. parity     4 objects x 1024 modes over 1 s: impact and hetero against
              the float64 oracle, sustained against the same JAX code on
              the CPU backend; all at <= -60 dB
6. engine     StreamingEngine, lookahead 1 (the nb=1 live span), ~2 s of
              paced stream with a hit every 100 ms and one listener move
7. server     build_server for ``serve --demo-synth`` in a thread, driven
              by an AudioClient: hit, stats, load_model hot-swap

``--multichip`` runs ShardedSession on make_mesh(4, 1) and make_mesh(2, 2)
for a shared, a hetero and a sustained 256 x 1024 span, each against
ModalSession on card 0 (-100 dB deterministic, -60 dB sustained).

A failing phase raises: the script exits non-zero and prints no result
line. The last stdout line is
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HIT_US = 1000.0          # Gaussian hit width in microseconds (44 samples)
SAMPLE_RATE = 44100
PARITY_DB = -60.0        # the repo's oracle contract
SHARDED_DB = -100.0      # sharded vs single device, deterministic content


@dataclasses.dataclass(frozen=True)
class Size:
    objects: int = 256
    modes: int = 1024
    block: int = 512
    shared_blocks: int = 512
    hetero_blocks: int = 1024
    sustained_blocks: int = 512
    parity_objects: int = 4
    parity_blocks: int = 88            # 1.02 s at 512-sample blocks
    per_block_iters: int = 100
    engine_seconds: float = 2.0
    hit_every_s: float = 0.1
    ffat_cells: int = 6


FULL = Size()


@dataclasses.dataclass(frozen=True)
class Run:
    size: Size
    card: str                          # "name, power limit" from nvidia-smi


def log(msg: str) -> None:
    print(msg, flush=True)


def db_error(test, ref) -> float:
    """20 log10(||test - ref|| / ||ref||); -inf when they agree exactly."""
    test = np.asarray(test, np.float64)
    ref = np.asarray(ref, np.float64)
    err = float(np.linalg.norm(test - ref))
    if err == 0.0:
        return float("-inf")
    return 20.0 * np.log10(err / float(np.linalg.norm(ref)))


def check_audio(name: str, out: np.ndarray, *, decays: bool) -> None:
    """Finite, not silent, and (for impacts) ringing down."""
    if not np.isfinite(out).all():
        raise RuntimeError(f"{name}: non-finite samples")
    peak = float(np.abs(out).max())
    if peak == 0.0:
        raise RuntimeError(f"{name}: silent output")
    if decays:
        energy = [float(np.sum(part ** 2))
                  for part in np.array_split(out, 10)]
        if not energy[-1] < 0.5 * max(energy):
            raise RuntimeError(f"{name}: no decay (energy {max(energy):.3e} "
                               f"in the loudest tenth, {energy[-1]:.3e} in "
                               f"the last)")


# ------------------------------------------------------------------ scenes


def hit_spaces(objects: int, modes: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((objects, modes))


def shared_modes(size: Size):
    """One mode set for every object, as bench.py builds it."""
    from openpbso_tpu.utils.synth import synth_mode_data
    return synth_mode_data(size.modes, 8, seed=0)


def hetero_modes(size: Size, objects: int):
    """A mode set per object (bench.py's heterogeneous scene)."""
    from openpbso_tpu.utils.synth import synth_mode_data
    return [synth_mode_data(size.modes, 8, seed=100 + i, f_low=100.0 + i,
                            f_high=15000.0 + 3 * i) for i in range(objects)]


def shared_bank(size: Size, objects: int, *, tables: bool):
    """(bank, lam64) for ``objects`` objects sharing one mode bank."""
    from openpbso_tpu.ops.coeffs import bank_from_material, lambda_from_modes
    from openpbso_tpu.utils.synth import CERAMIC
    md = shared_modes(size)
    lam64, _, _ = lambda_from_modes(CERAMIC.density, md.omega_squared,
                                    CERAMIC.alpha, CERAMIC.beta)
    bank = bank_from_material(CERAMIC.density, md.omega_squared,
                              CERAMIC.alpha, CERAMIC.beta,
                              num_objects=objects,
                              block_size=size.block if tables else None)
    return bank, lam64


def hetero_bank(size: Size, objects: int, *, tables: bool):
    """(bank, lam64 [O, M]) with every object on its own mode bank."""
    from openpbso_tpu.ops.coeffs import build_modal_bank, lambda_from_modes
    from openpbso_tpu.utils.synth import CERAMIC
    lams, bs, valids = [], [], []
    for md in hetero_modes(size, objects):
        lam, b, valid = lambda_from_modes(CERAMIC.density, md.omega_squared,
                                          CERAMIC.alpha, CERAMIC.beta)
        lams.append(lam)
        bs.append(b)
        valids.append(valid)
    lam64 = np.stack(lams)
    bank = build_modal_bank(lam64, np.stack(bs), np.stack(valids),
                            block_size=size.block if tables else None,
                            shared=False)
    return bank, lam64


def session(bank, lam64, size: Size, backend: str = "auto", **kw):
    from openpbso_tpu.runtime.session import ModalSession
    from openpbso_tpu.runtime.solver import SolverConfig
    return ModalSession(bank, lam64=lam64, config=SolverConfig(
        block_size=size.block, backend=backend), **kw)


def hit_all(sess, spaces) -> None:
    for o in range(spaces.shape[0]):
        sess.hit(o, spaces[o], kind="gaussian", width_us=HIT_US)


def drag_all(sess, spaces) -> None:
    for o in range(spaces.shape[0]):
        sess.sustained_start(o, spaces[o])


# ------------------------------------------------------------------ phases


def phase_device(run: Run) -> None:
    """Report the card; check_devices already refused anything but GPUs."""
    import jax

    from openpbso_tpu.ops.integrator import PRECISION
    d = jax.devices()[0]
    log(f"device_kind: {d.device_kind}; devices: {len(jax.devices())}")
    log(f"jax {jax.__version__}; compile cache: "
        f"{jax.config.jax_compilation_cache_dir}")
    log(f"matmul precision: {PRECISION} (HIGHEST: true float32 on the "
        f"GPU, no TF32)")


def render_twice(sess, excite, spaces, n_blocks: int):
    """Build the span tables, then two span renders through render_multi,
    each after ``excite``: the first pays the compile, the second reuses
    it. Returns (first render's output, table set-up seconds, first
    render seconds, warm seconds); checks the warm output too."""
    t0 = time.perf_counter()
    sess.span_tables_for(n_blocks)
    setup = time.perf_counter() - t0
    excite(sess, spaces)
    t0 = time.perf_counter()
    out = sess.render_multi(n_blocks, blocks_per_dispatch=n_blocks)
    first = time.perf_counter() - t0
    excite(sess, spaces)
    t0 = time.perf_counter()
    again = sess.render_multi(n_blocks, blocks_per_dispatch=n_blocks)
    warm = time.perf_counter() - t0
    check_audio("warm render", again, decays=False)
    return out, setup, first, warm


def bake(run: Run, name: str, sess, n_blocks: int, excite, *,
         decays: bool) -> None:
    size = run.size
    spaces = hit_spaces(sess.bank.num_objects, size.modes)
    out, setup, first, warm = render_twice(sess, excite, spaces, n_blocks)
    check_audio(name, out, decays=decays)
    n = n_blocks * size.block
    sps = n / warm
    log(f"{name}: {sess.bank.num_objects} obj x {size.modes} modes, "
        f"{n_blocks}-block span ({n / SAMPLE_RATE:.2f} s): span tables "
        f"{setup:.2f} s, first render {first:.2f} s (compile ~"
        f"{first - warm:.2f} s), warm {warm:.4f} s -> {sps:,.0f} samples/s, "
        f"RTF {sps / SAMPLE_RATE:.2f} [{run.card}]")


def phase_shared(run: Run) -> None:
    bank, lam64 = shared_bank(run.size, run.size.objects, tables=True)
    bake(run, "shared", session(bank, lam64, run.size),
         run.size.shared_blocks, hit_all, decays=True)


def phase_hetero(run: Run) -> None:
    import jax
    size = run.size
    bank, lam64 = hetero_bank(size, size.objects, tables=True)
    sess = session(bank, lam64, size, backend="blocked")
    bake(run, "hetero", sess, size.hetero_blocks, hit_all, decays=True)
    # the live per-block forms on this scene: the blocked step (per-object
    # [O, M, S+1] tables) against the nb=1 chunked span, one synced block
    # per dispatch like a stream; forces held live (slot bucket 1)
    hit_all(sess, hit_spaces(size.objects, size.modes, seed=1))
    deadline_ms = size.block / SAMPLE_RATE * 1e3
    forms = (
        ("blocked step", lambda: sess._step_full(with_sustained=False,
                                                 num_slots=1)[1]),
        ("nb=1 span", lambda: sess._step_span(1, num_slots=1, idle=False,
                                              with_sustained=False)),
    )
    for label, dispatch in forms:
        mix = jax.block_until_ready(dispatch())       # compile
        check_audio(f"hetero {label}", np.asarray(mix), decays=False)
        times = []
        for _ in range(size.per_block_iters):
            t0 = time.perf_counter()
            jax.block_until_ready(dispatch())
            times.append(time.perf_counter() - t0)
        ms = np.asarray(times) * 1e3
        log(f"hetero per-block {label}: p50 {np.percentile(ms, 50):.3f} "
            f"ms, p99 {np.percentile(ms, 99):.3f} ms per {size.block}-sample"
            f" block vs {deadline_ms:.1f} ms deadline ({len(ms)} blocks) "
            f"[{run.card}]")


def phase_sustained(run: Run) -> None:
    bank, lam64 = shared_bank(run.size, run.size.objects, tables=True)
    sess = session(bank, lam64, run.size)
    bake(run, "sustained", sess, run.size.sustained_blocks, drag_all,
         decays=False)


def oracle_mix(mode_sets, spaces, size: Size) -> np.ndarray:
    """float64 reference of the span's mono mix: sum over objects of the
    OracleSolver's sound, output-scaled like the device mixdown."""
    from openpbso_tpu.config import OUTPUT_SCALE
    from openpbso_tpu.utils.oracle import (OracleGaussianForce, OracleSolver,
                                           iir_coefficients)
    from openpbso_tpu.utils.synth import CERAMIC
    total = np.zeros(size.parity_blocks * size.block)
    for md, space in zip(mode_sets, spaces):
        c1, c2, c3 = iir_coefficients(CERAMIC.density, md.omega_squared,
                                      CERAMIC.alpha, CERAMIC.beta,
                                      1.0 / SAMPLE_RATE)
        oracle = OracleSolver(c1, c2, c3, size.block)
        oracle.hit(space[: md.num_modes], OracleGaussianForce(HIT_US))
        total += oracle.render(size.parity_blocks)
    return total / OUTPUT_SCALE


def parity_render(bank, lam64, size: Size, excite, spaces) -> np.ndarray:
    sess = session(bank, lam64, size)
    excite(sess, spaces)
    return sess.render_multi(size.parity_blocks,
                             blocks_per_dispatch=size.parity_blocks)


def phase_parity(run: Run) -> None:
    import jax
    size = run.size
    p = size.parity_objects
    spaces = hit_spaces(p, size.modes, seed=2)
    cases = (
        ("impact", shared_bank(size, p, tables=False),
         [shared_modes(size)] * p),
        ("hetero", hetero_bank(size, p, tables=False), hetero_modes(size, p)),
    )
    for name, (bank, lam64), mode_sets in cases:
        got = parity_render(bank, lam64, size, hit_all, spaces)
        ref = oracle_mix(mode_sets, spaces, size)
        db = db_error(got[:, 0], ref)
        log(f"parity {name}: {db:.1f} dB vs the float64 oracle ({p} obj x "
            f"{size.modes} modes, {ref.shape[0] / SAMPLE_RATE:.2f} s; "
            f"contract {PARITY_DB:.0f} dB)")
        if not db <= PARITY_DB:
            raise RuntimeError(f"parity {name}: {db:.1f} dB misses the "
                               f"{PARITY_DB:.0f} dB contract")
    # the AR noise is counter-derived (threefry), so the same JAX code on
    # the CPU backend draws the same stream: compare device against CPU
    bank, lam64 = shared_bank(size, p, tables=False)
    got = parity_render(bank, lam64, size, drag_all, spaces)
    with jax.default_device(jax.devices("cpu")[0]):
        bank, lam64 = shared_bank(size, p, tables=False)
        ref = parity_render(bank, lam64, size, drag_all, spaces)
    check_audio("parity sustained", got, decays=False)
    db = db_error(got, ref)
    log(f"parity sustained: {db:.1f} dB, {jax.default_backend()} vs the CPU "
        f"backend ({p} obj x {size.modes} modes; contract "
        f"{PARITY_DB:.0f} dB)")
    if not db <= PARITY_DB:
        raise RuntimeError(f"parity sustained: {db:.1f} dB misses the "
                           f"{PARITY_DB:.0f} dB contract")


class _CountingPacer:
    """Real-time pacer sink that also records each block's peak."""

    def __init__(self):
        from openpbso_tpu.runtime.audio import RealTimePacerSink
        self._pacer = RealTimePacerSink()
        self.peaks: list[float] = []
        self.finite = True

    def write(self, block) -> bool:
        block = np.asarray(block)
        self.finite &= bool(np.isfinite(block).all())
        self.peaks.append(float(np.abs(block).max()))
        return self._pacer.write(block)

    def close(self) -> None:
        self._pacer.close()


def phase_engine(run: Run) -> None:
    import jax.numpy as jnp

    from openpbso_tpu.ops.ffat import build_ffat
    from openpbso_tpu.runtime.engine import StreamingEngine
    from openpbso_tpu.utils.synth import CERAMIC, synth_fatcube
    size = run.size
    bank, lam64 = shared_bank(size, size.objects, tables=True)
    freqs = shared_modes(size).frequencies_hz(CERAMIC.density)
    ffat = build_ffat({i: synth_fatcube(i, float(f), n=size.ffat_cells)
                       for i, f in enumerate(freqs)},
                      bank.num_modes, dtype=jnp.float32)
    sess = session(bank, lam64, size, ffat=ffat)
    sess.set_listener(np.asarray([1.0, 0.5, 0.5]))
    sink = _CountingPacer()
    engine = StreamingEngine(sess, sink, lookahead=1)
    t0 = time.perf_counter()
    engine.start()                      # warms every variant it can reach
    warmup = time.perf_counter() - t0
    spaces = hit_spaces(size.objects, size.modes, seed=3)
    n_hits = max(1, int(round(size.engine_seconds / size.hit_every_s)))
    try:
        for i in range(n_hits):
            if not engine.healthy:
                break
            engine.hit(i % size.objects, spaces[i % size.objects],
                       kind="gaussian", width_us=HIT_US)
            if i == n_hits // 2:
                engine.set_listener(np.asarray([0.4, -0.6, 0.8]))
            time.sleep(size.hit_every_s)
    finally:
        engine.stop()
    if engine.error is not None:
        raise RuntimeError("engine synthesis failed") from engine.error
    st = engine.profiler.stats()
    if st is None or not sink.peaks:
        raise RuntimeError("engine produced no blocks")
    if not sink.finite:
        raise RuntimeError("engine: non-finite samples")
    if max(sink.peaks) == 0.0:
        raise RuntimeError("engine: silent stream")
    log(f"engine: {size.objects} obj x {size.modes} modes, block "
        f"{size.block}, lookahead 1: warmup {warmup:.1f} s; {st.count} "
        f"blocks, p50 {st.p50_ms:.3f} ms, p99 {st.p99_ms:.3f} ms, max "
        f"{st.max_ms:.3f} ms vs {st.deadline_ms:.1f} ms deadline; "
        f"{engine.health.missed} underruns of {engine.health.total} "
        f"played blocks [{run.card}]")


def _read_until(client, pred, blocks: int, what: str):
    for _ in range(blocks):
        block = client.read_block()
        hit = pred(block)
        if hit:
            return hit
    raise RuntimeError(f"server: no {what} within {blocks} blocks")


def phase_server(run: Run) -> None:
    from openpbso_tpu.apps import serve
    from openpbso_tpu.io.meta import resolve_model_dir, write_meta
    from openpbso_tpu.runtime.server import AudioClient
    from openpbso_tpu.utils.synth import synth_model_dir
    args = serve.parse_args(["--demo-synth", "--host", "127.0.0.1",
                             "--port", "0"])
    t0 = time.perf_counter()
    srv = serve.build_server(args)
    built = time.perf_counter() - t0
    thread = threading.Thread(target=srv.serve_one, kwargs={"timeout": 300},
                              daemon=True)
    thread.start()
    try:
        with tempfile.TemporaryDirectory() as root:
            synth_model_dir(root, "swap", num_modes=24, ffat_n=8, seed=5)
            meta = os.path.join(root, "swap.meta")
            write_meta(meta, resolve_model_dir(root, "swap"))
            c = AudioClient(*srv.address)
            try:
                t0 = time.perf_counter()
                c.send(cmd="hit_space", obj=0, space=[1.0] * 64,
                       kind="gaussian", width_us=2000.0)
                peak = _read_until(
                    c, lambda b: float(np.abs(b).max()) or None, 400,
                    "audio after a hit")
                t_hit = time.perf_counter() - t0
                t0 = time.perf_counter()
                c.send(cmd="stats")
                stats = _read_until(
                    c, lambda b: next((m for m in c.messages
                                       if "health" in m), None),
                    2000, "stats reply")
                t_stats = time.perf_counter() - t0
                c.messages.clear()
                t0 = time.perf_counter()
                c.send(cmd="load_model", meta=meta)
                loaded = _read_until(
                    c, lambda b: next((m for m in c.messages
                                       if "loaded" in m or "error" in m),
                                      None),
                    4000, "load_model reply")
                if loaded.get("loaded") != meta:
                    raise RuntimeError(f"server: hot-swap failed: {loaded}")
                t_swap = time.perf_counter() - t0
                c.send(cmd="hit_space", obj=0, space=[1.0] * 24)
                _read_until(c, lambda b: float(np.abs(b).max()) or None,
                            400, "audio from the swapped-in model")
                c.send(cmd="quit")
            finally:
                c.close()
    finally:
        srv.close()
        thread.join(timeout=60)
    log(f"server: built in {built:.1f} s; hit -> audio (peak {peak:.3e}) "
        f"in {t_hit * 1e3:.0f} ms, stats round trip {t_stats * 1e3:.0f} ms "
        f"(health {stats['health']:.2f}), load_model hot-swap to "
        f"{loaded['modes']} modes in {t_swap:.2f} s")


def sharded_case(run: Run, name: str, build, excite, n_blocks: int,
                 floor: float) -> None:
    """ShardedSession on (4, 1) and (2, 2) meshes vs ModalSession on the
    first device, one span through render_multi each."""
    from openpbso_tpu.parallel import ShardedSession, make_mesh
    from openpbso_tpu.runtime.solver import SolverConfig
    size = run.size
    bank, lam64 = build(size, size.objects, tables=False)
    spaces = hit_spaces(size.objects, size.modes, seed=4)
    ref, _, _, t_ref = render_twice(session(bank, lam64, size), excite,
                                    spaces, n_blocks)
    check_audio(f"sharded {name} reference", ref, decays=False)
    for shape in ((4, 1), (2, 2)):
        sess = ShardedSession(bank, make_mesh(*shape), lam64=lam64,
                              config=SolverConfig(block_size=size.block))
        got, _, first, warm = render_twice(sess, excite, spaces, n_blocks)
        check_audio(f"sharded {name} {shape}", got, decays=False)
        db = db_error(got, ref)
        log(f"sharded {name}: mesh {shape[0]} obj x {shape[1]} mode, "
            f"{n_blocks}-block span: {db:.1f} dB vs ModalSession on device "
            f"0 (floor {floor:.0f} dB); first render {first:.2f} s, warm "
            f"{warm:.4f} s vs {t_ref:.4f} s on one device [{run.card}]")
        if not db <= floor:
            raise RuntimeError(f"sharded {name} {shape}: {db:.1f} dB "
                               f"misses the {floor:.0f} dB floor")


def phase_sharded(run: Run) -> None:
    size = run.size
    sharded_case(run, "shared", shared_bank, hit_all, size.shared_blocks,
                 SHARDED_DB)
    sharded_case(run, "hetero", hetero_bank, hit_all, size.hetero_blocks,
                 SHARDED_DB)
    sharded_case(run, "sustained", shared_bank, drag_all,
                 size.sustained_blocks, PARITY_DB)


PHASES = (("device", phase_device), ("shared", phase_shared),
          ("hetero", phase_hetero), ("sustained", phase_sustained),
          ("parity", phase_parity), ("engine", phase_engine),
          ("server", phase_server))
MULTICHIP_PHASES = (("device", phase_device), ("sharded", phase_sharded))


# ------------------------------------------------------------- entry point


def check_devices(count: int, platform: str = "gpu"):
    """The devices to run on; SystemExit unless JAX reports at least
    ``count`` devices, all of ``platform``."""
    import jax
    devices = jax.devices()
    kinds = sorted({d.platform for d in devices})
    if kinds != [platform] or len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} {platform} device(s); "
                         f"JAX reports {len(devices)} on {kinds}")
    return devices


def card_line() -> str:
    """``name, power limit`` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip()


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def run(size: Size, phases, devices, card: str) -> None:
    """Run ``phases`` in order, then print the result line. Any phase's
    exception propagates: no result line is printed."""
    state = Run(size=size, card=card.splitlines()[0])
    for name, fn in phases:
        log(f"== {name}")
        t0 = time.perf_counter()
        fn(state)
        log(f"== {name} ok ({time.perf_counter() - t0:.1f} s)")
    log(result_line(devices))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--multichip", action="store_true",
                   help="run ShardedSession on four cards, nothing else")
    args = p.parse_args(argv)
    count = 4 if args.multichip else 1
    devices = check_devices(count)
    card = card_line()
    log(card)
    from openpbso_tpu.utils.platform import enable_compile_cache
    enable_compile_cache()
    run(FULL, MULTICHIP_PHASES if args.multichip else PHASES, devices, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
