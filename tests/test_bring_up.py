"""Portability of the main path: compile-cache placement, the host setup
device, the reduced-precision guard, the optional pandas/matplotlib
dependencies, the smoke script's refusal to run without a GPU, and the
smoke phases that run anywhere."""

import json
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_py(code, env_extra=None, cwd=ROOT, timeout=600):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, cwd=cwd, env=env,
                          timeout=timeout)


CACHE_PROBE = """
    import json, jax
    from bayes_drt_tpu.progcache import enable_compile_cache
    path = enable_compile_cache()
    print(json.dumps([path, jax.config.jax_compilation_cache_dir]))
"""


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(tmp_path, env_dir):
    from bayes_drt_tpu.progcache import DEFAULT_COMPILE_CACHE_DIR
    extra = {}
    if env_dir is not None:
        extra["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    proc = _run_py(CACHE_PROBE, extra)
    assert proc.returncode == 0, proc.stderr
    path, configured = json.loads(proc.stdout.strip().splitlines()[-1])
    want = (str(tmp_path / env_dir) if env_dir is not None
            else DEFAULT_COMPILE_CACHE_DIR)
    assert path == configured == want
    if env_dir is None:
        # a fixed directory inside the checkout, ignored by git
        assert os.path.dirname(want) == ROOT
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


def test_chip_smoke_refuses_cpu():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    import shutil
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_setup_device_is_host_cpu(monkeypatch):
    import jax
    from bayes_drt_tpu.parallel import batch
    assert batch.setup_device().platform == "cpu"

    def no_cpu(backend=None):
        raise RuntimeError(f"Unknown backend {backend}")

    monkeypatch.setattr(jax, "devices", no_cpu)
    with pytest.raises(RuntimeError, match="JAX_PLATFORMS"):
        batch.setup_device()


def _tiny_shmc_fit(precision, n_steps=4, samples=6):
    from bayes_drt_tpu import sim
    from bayes_drt_tpu.infer.chees import SHMCConfig
    from bayes_drt_tpu.parallel import fit_spectra_batch
    freq, zb = sim.make_benchmark_batch(2, freq=np.logspace(5, -1, 21),
                                        seed=0)
    cfg = SHMCConfig(n_steps=n_steps, warm_steps=2, precision=precision)
    return fit_spectra_batch(freq, zb, mode="sample", chains=2, warmup=6,
                             samples=samples, sampler="shmc", shmc_cfg=cfg,
                             ncp=True, escalate=False)


@pytest.mark.parametrize("precision,n_steps,warns", [
    ("high", 4, False), ("high", 65, True), ("highest", 65, False)])
def test_precision_guard_keys_on_precision(precision, n_steps, warns):
    """The reduced-precision probe and its regime warning follow the
    precision the fit asked for, on any backend (here the CPU, where both
    precisions agree and the probe reads ~0)."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        res = _tiny_shmc_fit(precision, n_steps=n_steps)
    d = res.diagnostics
    if precision == "high":
        err = np.asarray(d["high_grad_err"])
        assert err.shape == (2,) and (err < 1e-4).all()
    else:
        assert "high_grad_err" not in d
    hit = any("precision='high'" in str(w.message) for w in rec)
    assert hit == warns


NO_PANDAS = """
    import sys
    sys.modules["pandas"] = None
    sys.modules["matplotlib"] = None
    import os, numpy as np
    from bayes_drt_tpu import Inverter, cli, sim
    from bayes_drt_tpu.parallel import fit_spectra_batch, ridge_fit_spectra_batch
    freq, zb = sim.make_benchmark_batch(3, freq=np.logspace(5, -1, 21), seed=0)
    inv = Inverter()
    inv.fit(freq, zb[0])
    inv.ridge_fit(freq, zb[0])
    fit_spectra_batch(freq, zb, mode="optimize", max_iter=50)
    ridge_fit_spectra_batch(freq, zb)
    out = os.environ["OUT_DIR"]
    os.makedirs(out + "/in")
    for i, z in enumerate(zb):
        np.savetxt(f"{out}/in/s{i}.csv",
                   np.column_stack([freq, z.real, z.imag]), delimiter=",",
                   header="Freq,Zreal,Zimag", comments="")
    rc = cli.main(["fit", out + "/in", "--pattern", "*.csv", "--mode",
                   "optimize", "--max-iter", "50", "--peaks", "--out",
                   out + "/res"])
    assert rc == 0
    assert "pandas" not in {m for m, v in sys.modules.items() if v is not None}
    print("OK")
"""


def test_main_path_without_pandas_or_matplotlib(tmp_path):
    proc = _run_py(NO_PANDAS, {"OUT_DIR": str(tmp_path),
                               "JAX_COMPILATION_CACHE_DIR": str(tmp_path / "c")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
    files = sorted(os.listdir(tmp_path / "res"))
    assert "summary.csv" in files
    assert sum(f.startswith("Gout_") for f in files) == 3
    assert sum(f.startswith("Peaks_") for f in files) == 3


def test_cli_csv_writers(tmp_path):
    from bayes_drt_tpu.cli import _write_columns, _write_csv
    rows = [{"file": "a", "status": "load_error: x"},
            {"file": "b", "status": "ok", "R_inf": 0.5}]
    _write_csv(tmp_path / "s.csv", rows)
    lines = (tmp_path / "s.csv").read_text().splitlines()
    assert lines == ["file,status,R_inf", "a,load_error: x,", "b,ok,0.5"]
    _write_columns(tmp_path / "g.csv", {"tau": np.array([1e-3, 1.0]),
                                        "gamma": np.array([0.25, 0.0])})
    got = np.genfromtxt(tmp_path / "g.csv", delimiter=",", names=True)
    np.testing.assert_array_equal(got["tau"], [1e-3, 1.0])
    np.testing.assert_array_equal(got["gamma"], [0.25, 0.0])


def test_native_csv_fallback_uses_numpy(tmp_path, monkeypatch):
    from bayes_drt_tpu import native
    freq = np.logspace(4, -1, 11)
    z = (1.0 + freq * 1e-3) - 1j * freq * 2e-3
    path = tmp_path / "z.csv"
    np.savetxt(path, np.column_stack([np.arange(11), freq, z.real, z.imag]),
               delimiter=",", header="idx,Freq,Zreal,Zimag", comments="")
    monkeypatch.setattr(native, "_ensure_built", lambda: None)
    monkeypatch.setitem(sys.modules, "pandas", None)
    f2, z2 = native.load_eis_file(str(path))
    np.testing.assert_allclose(f2, freq)
    np.testing.assert_allclose(z2, z)


def test_bench_truth_is_analytic():
    sys.path.insert(0, ROOT)
    import bench
    from bayes_drt_tpu import sim
    tau, g, rp = bench.ground_truth()
    np.testing.assert_array_equal(g, sim.reference_gamma("ZARC", tau))
    assert abs(rp - 1.0) < 1e-3
    assert tau.min() <= 1e-6 and tau.max() >= 1.0


def test_smoke_phases_run_on_cpu(tmp_path):
    """The device-independent smoke phases at reduced sizes: matrix setup on
    the host, single-spectrum MAP/ridge, batched ridge, and the CLI."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    chip_smoke.phase_setup(n_freq=41)
    chip_smoke.phase_single()
    chip_smoke.phase_ridge(b=4, n_freq=41)
    chip_smoke.phase_cli(n=2, n_freq=41, out_dir=str(tmp_path))
    assert (tmp_path / "cli_out" / "summary.csv").exists()


@pytest.mark.gpu
def test_gpu_marker_skips_without_gpu(gpu):
    """Runs only where JAX finds a GPU (the `gpu` fixture skips elsewhere):
    a float32 matrix product at 'highest' precision matches float64."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 101)).astype(np.float32)
    b = rng.standard_normal((101, 162)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        out = np.asarray(jax.jit(jnp.matmul)(a, b), np.float64)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 1e-6
