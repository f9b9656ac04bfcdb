"""The one device decision (witch_tpu/device.py) and start-up
(witch_tpu.configure_jax): the platform is whatever JAX reports, the
compile cache honours JAX_COMPILATION_CACHE_DIR, and nothing probes the
accelerator in a subprocess."""

import subprocess

import jax
import pytest

import witch_tpu
from witch_tpu import device


@pytest.mark.parametrize("backend,expected", [
    ("gpu", True), ("cpu", False), ("metal", False)])
def test_on_gpu_follows_default_backend(monkeypatch, backend, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert device.on_gpu() is expected


def test_on_gpu_false_on_this_cpu_host():
    assert jax.default_backend() == "cpu" and not device.on_gpu()


@pytest.fixture
def cache_dir_restored():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_env_set_is_left_to_jax(monkeypatch, cache_dir_restored,
                                          tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "sentinel")
    witch_tpu.configure_jax()
    assert jax.config.jax_compilation_cache_dir == "sentinel"


def test_cache_dir_env_unset_uses_repo_cache(monkeypatch,
                                             cache_dir_restored):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    witch_tpu.configure_jax()
    assert jax.config.jax_compilation_cache_dir == witch_tpu.CACHE_DIR
    assert witch_tpu.CACHE_DIR.endswith("/.jax_cache")


def test_configure_jax_starts_no_process(monkeypatch, cache_dir_restored,
                                         capsys):
    def refuse(*a, **k):
        raise AssertionError("configure_jax started a process")
    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    witch_tpu.configure_jax()
    assert "platform cpu" in capsys.readouterr().err
