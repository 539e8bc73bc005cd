"""Platform plumbing: the peaks table, the compile-cache directory, the
smoke run's refusal of a non-GPU platform, and the box kernel compiled
for the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke
from hyteg_tpu.core import compile_cache


def test_peaks_known_kind():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == {"hbm_gb_s": 3350.0, "f32_tflop_s": 67.0,
                     "bf16_tflop_s": 989.0}
    assert bench._vs_baseline(3350.0 / 8, peaks) == 1.0


def test_peaks_unknown_kind_raises():
    with pytest.raises(ValueError, match="no peak rates"):
        bench.device_peaks("cpu")


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path, cache_config):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; nothing is set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_default_dir(monkeypatch, cache_config):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == compile_cache.DEFAULT_DIR
    assert path.endswith(".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_chip_smoke_refuses_cpu(argv, capsys, cache_config):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main(argv) != 0
    out, err = capsys.readouterr()
    assert '"ok"' not in out
    assert "needs" in err


def test_chip_smoke_converged_gate():
    assert chip_smoke.converged([1.0, 1e-2, 1e-5], "x") == 2
    with pytest.raises(chip_smoke.SmokeFailure, match="reduction"):
        chip_smoke.converged([1.0, 0.5, 0.25], "x")
    with pytest.raises(chip_smoke.SmokeFailure, match="rel err"):
        chip_smoke.compare(np.ones(3) * 1.1, np.ones(3), 1e-5, "x")


@pytest.mark.gpu
def test_box_apply_compiled_on_gpu(gpu):
    """apply_raw on a GPU array runs the compiled Triton kernel."""
    from hyteg_tpu.structured import BoxDomain, BoxStencilOperator

    domain = BoxDomain((2, 2, 1), level=4)
    op = BoxStencilOperator(domain)
    u = jax.random.normal(jax.random.PRNGKey(0), domain.block_shape)
    assert "triton" in jax.jit(op.apply_raw).lower(u).as_text().lower()
    want = np.asarray(op._apply_xla(u))
    got = np.asarray(jax.jit(op.apply_raw)(u))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_bench_refuses_cpu(capsys, cache_config):
    assert bench.main() != 0
    out, err = capsys.readouterr()
    assert out == ""
    assert "needs a GPU" in err
