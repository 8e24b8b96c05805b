"""The compile-cache rule (utils/jaxenv) and chip_smoke.py's refusal to
run without a GPU, plus a toy-size rehearsal of its phases on the CPU."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from alignment_algos_tpu.utils import jaxenv

from conftest import ROOT


def test_cache_dir_defaults_to_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxenv.compile_cache_dir() == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_dir_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxenv.compile_cache_dir() == str(tmp_path)


@pytest.mark.parametrize("env_set", [False, True])
def test_setup_jax_sets_cache_only_without_env(env_set, tmp_path):
    """In a fresh process: with the variable unset the config points at
    <repo>/.jax_cache; with it set, code sets nothing and JAX reads it."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; from alignment_algos_tpu.utils.jaxenv import "
         "setup_jax; print(setup_jax()); "
         "print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    want = str(tmp_path) if env_set else os.path.join(ROOT, ".jax_cache")
    assert r.stdout.split() == [want, want]


def test_chip_smoke_refuses_cpu():
    """Where JAX finds no GPU the script exits non-zero and prints no
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the package it fails too."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("cards", [1, 4])
def test_chip_smoke_rehearsal(cards):
    """Every phase of chip_smoke.py at toy sizes on the CPU: the XLA
    engines where the GPU would run its own, the Triton kernel in the
    interpreter, every check against the same host references."""
    import chip_smoke
    timings = chip_smoke.run(chip_smoke.SMALL, cards)
    assert all(np.isfinite(v) for v in timings.values())
