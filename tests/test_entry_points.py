"""Entry points: device selection, the compile cache, the bench's and the
chip smoke's failure contracts, and the matmul precision pin.

What needs the GPU is a phase of chip_smoke.py; here each phase runs on
the CPU at a tiny size, so its control flow and checks are exercised.
"""
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openpbso_tpu.utils import platform as plat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod          # dataclasses resolve through it
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------- app parsers


def _parse(app, argv):
    if app == "real_time_modal_sound":
        from openpbso_tpu.apps import real_time_modal_sound as m
        return m.build_argparser().parse_args(argv)
    if app == "serve":
        from openpbso_tpu.apps import serve as m
        return m.parse_args(argv)
    if app == "render_timeline":
        from openpbso_tpu.apps import render_timeline as m
        return m.main(["--timeline", "missing.json"] + argv)
    if app == "render_offline":
        from openpbso_tpu.apps import render_offline as m
        return m.main(argv)
    from openpbso_tpu.ml import train as m
    return m.main(argv)


@pytest.mark.parametrize("app", ["real_time_modal_sound", "serve",
                                 "render_timeline", "render_offline"])
def test_app_rejects_pallas_backend(app, capsys):
    with pytest.raises(SystemExit) as e:
        _parse(app, ["--backend", "pallas"])
    assert e.value.code == 2
    assert "pallas" in capsys.readouterr().err


@pytest.mark.parametrize("app", ["real_time_modal_sound", "serve",
                                 "render_timeline", "train"])
def test_app_rejects_tpu_platform(app, capsys):
    with pytest.raises(SystemExit) as e:
        _parse(app, ["--platform", "tpu"])
    assert e.value.code == 2
    assert "tpu" in capsys.readouterr().err


def test_app_accepts_live_cpu_platform():
    args = _parse("serve", ["--platform", "cpu", "--port", "0"])
    assert args.platform == "cpu"


# ------------------------------------------------------- device selection


def test_force_platform_gpu_raises_on_live_cpu_backend():
    assert jax.default_backend() == "cpu"
    with pytest.raises(RuntimeError, match="already runs on 'cpu'"):
        plat.force_platform("gpu")
    assert jax.default_backend() == "cpu"


def test_force_platform_rejects_unknown_and_allows_none():
    with pytest.raises(ValueError):
        plat.force_platform("tpu")
    plat.force_platform(None)
    plat.force_platform("cpu")   # the live backend: a no-op


# ---------------------------------------------------------- compile cache


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = plat.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", "sentinel")
    try:
        assert plat.enable_compile_cache() == str(tmp_path)
        # nothing set in code: JAX reads the variable itself
        assert jax.config.jax_compilation_cache_dir == "sentinel"
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# ------------------------------------------------------------------ bench


class _Done:
    def __init__(self, rc, stdout="", stderr=""):
        self.returncode, self.stdout, self.stderr = rc, stdout, stderr


@pytest.mark.parametrize("failure", ["rc", "no_line", "timeout"])
def test_bench_failed_cell_exits_nonzero_without_result(failure,
                                                        monkeypatch, capsys):
    bench = _load("bench")
    good = '{"cell": "shared", "value": 1.0}\n'
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        if len(calls) == 1:
            return _Done(0, good)
        if failure == "timeout":
            raise subprocess.TimeoutExpired(cmd, kw.get("timeout"))
        return _Done(1 if failure == "rc" else 0, "", "boom\n")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert bench.main(["--platform=cpu"]) != 0
    out = capsys.readouterr().out
    assert "{" not in out                     # not even the good cell
    assert len(calls) == 2                    # one attempt, no retry rung
    assert all("--platform=cpu" in c for c in calls)


def test_bench_prints_every_cell_once(monkeypatch, capsys):
    bench = _load("bench")

    def fake_run(cmd, **kw):
        cell = [a for a in cmd if a.startswith("--cell=")][0][7:]
        return _Done(0, json.dumps({"cell": cell}) + "\n")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert bench.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln)["cell"] for ln in lines] == list(bench.CELLS)


def test_bench_rejects_unknown_option():
    bench = _load("bench")
    with pytest.raises(SystemExit):
        bench.parse_args(["--pipelined"])


# -------------------------------------------------------------- chip smoke

# shared_blocks=512 makes 64 chunks of 512: the superchunk span form
TINY = dict(objects=8, modes=128, block=64, shared_blocks=512,
            hetero_blocks=128, sustained_blocks=128, parity_objects=2,
            parity_blocks=8, per_block_iters=2, engine_seconds=0.6,
            hit_every_s=0.1, ffat_cells=4)


@pytest.fixture(scope="module")
def smoke():
    return _load("chip_smoke")


def test_chip_smoke_refuses_cpu_devices(smoke):
    with pytest.raises(SystemExit) as e:
        smoke.check_devices(1)
    assert e.value.code not in (0, None)


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """Without the repo beside it (and without a GPU) the script fails
    and prints no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_failing_phase_prints_no_result(smoke, capsys):
    def broken(run):
        raise RuntimeError("phase failed")

    phases = (("device", smoke.phase_device), ("broken", broken))
    with pytest.raises(RuntimeError, match="phase failed"):
        smoke.run(smoke.Size(**TINY), phases, jax.devices(), "card, 1 W")
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_result_is_the_last_line(smoke, capsys):
    smoke.run(smoke.Size(**TINY), (("device", smoke.phase_device),),
              jax.devices(), "NVIDIA H100 80GB HBM3, 700.00 W")
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    d = jax.devices()[0]
    assert last == {"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}
    assert lines[-1] == smoke.result_line(jax.devices())


@pytest.mark.parametrize("phase", ["shared", "hetero", "sustained",
                                   "parity", "engine", "server",
                                   "sharded"])
def test_chip_smoke_phase_runs_tiny_on_cpu(smoke, phase, capsys):
    fn = dict(smoke.PHASES + smoke.MULTICHIP_PHASES)[phase]
    smoke.run(smoke.Size(**TINY), ((phase, fn),), jax.devices(),
              "cpu, n/a")
    out = capsys.readouterr().out
    assert f"== {phase} ok" in out


def test_chip_smoke_check_audio_rejects_bad_output(smoke):
    ring = np.exp(-np.arange(1000) / 50.0)[:, None] * np.ones((1, 2))
    smoke.check_audio("ok", ring, decays=True)
    with pytest.raises(RuntimeError, match="silent"):
        smoke.check_audio("x", np.zeros((10, 2)), decays=False)
    with pytest.raises(RuntimeError, match="non-finite"):
        smoke.check_audio("x", np.full((10, 2), np.nan), decays=False)
    with pytest.raises(RuntimeError, match="no decay"):
        smoke.check_audio("x", ring[::-1], decays=True)


# ------------------------------------------------------- precision pinning


def _dot_precisions(jaxpr):
    """Every dot_general's precision in a jaxpr and its sub-jaxprs."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    found += _dot_precisions(inner)
    return found


def _main_path_programs():
    import dataclasses

    from openpbso_tpu.ops.doppler import DopplerPostMix
    from openpbso_tpu.ops.forces import ar_impulse_g
    from openpbso_tpu.ops.hrtf import HRTFPostMix
    from openpbso_tpu.runtime import solver

    from openpbso_tpu.ops.span import build_span_tables

    bench = _load("bench")
    o, m, s, nb = 4, 128, 64, 4
    out = {}
    for hetero in (False, True):
        bank, state, gains, lam64 = bench.build(o, m, s, hetero=hetero)
        tables = build_span_tables(lam64, nb * s, num_modes=m)
        tag = "hetero" if hetero else "shared"
        out[f"span {tag}"] = lambda st=state, b=bank, t=tables, g=gains: \
            solver.step_span(st, b, t, g, n_blocks=nb, block_size=s,
                             num_slots=1)
        out[f"block {tag}"] = lambda st=state, b=bank, g=gains: \
            solver.step_block(st, b, g, block_size=s, backend="blocked")
    bank, state, gains, lam64 = bench.build(o, m, s)
    tables = build_span_tables(lam64, nb * s, num_modes=m)
    state = dataclasses.replace(state, sustained=dataclasses.replace(
        state.sustained, active=jnp.ones_like(state.sustained.active)))
    ar_g = jnp.asarray(ar_impulse_g((0.783, 0.116), nb * s), jnp.float32)
    out["span sustained"] = lambda: solver.step_span(
        state, bank, tables, gains, n_blocks=nb, block_size=s,
        num_slots=0, with_sustained=True, ar_g=ar_g)
    sound = jnp.ones((o, nb * s), jnp.float32)
    pos = np.random.default_rng(0).uniform(-2, 2, (o, 3))
    out["doppler post-mix"] = lambda: DopplerPostMix(pos).process_span(sound)
    out["hrtf post-mix"] = lambda: HRTFPostMix(
        pos, block_size=s).process_span(sound)
    return out


@pytest.mark.parametrize("program", ["span shared", "span hetero",
                                     "span sustained", "block shared",
                                     "block hetero", "doppler post-mix",
                                     "hrtf post-mix"])
def test_main_path_contractions_pin_precision(program):
    """A float32 contraction left at XLA's default runs in TF32 on an
    NVIDIA GPU: every one on the main path names the pinned PRECISION
    (HIGHEST unless OPENPBSO_MATMUL_PRECISION says otherwise)."""
    from openpbso_tpu.ops.integrator import PRECISION
    fn = _main_path_programs()[program]
    found = _dot_precisions(jax.make_jaxpr(fn)().jaxpr)
    assert found, f"{program}: no contraction traced"
    assert all(p == (PRECISION, PRECISION) for p in found), (program, found)
