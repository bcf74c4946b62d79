"""What every entry point shares: the compile-cache location, the keyed
native host build, and chip_smoke.py's refusal to run without a GPU."""

import os
import shutil

import jax
import pytest

from audio_formats_tpu.host import native
from audio_formats_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: the helper sets no other path
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split(), "cache must be gitignored"


@pytest.fixture
def built_lib_dir(tmp_path, monkeypatch):
    """A build directory holding this host's library under its own key."""
    lib = native.get_lib()
    if lib is None:
        pytest.skip(f"native host stage unavailable: {native.build_error()}")
    key = native.build_key(native._flags())
    shutil.copy(native.lib_path(key), tmp_path / f"af_host-{key}.so")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    return tmp_path, key


@pytest.mark.parametrize("change", ["flags", "source"])
def test_native_build_refuses_other_keys(built_lib_dir, monkeypatch, change):
    """The library loads only from a file named by the current key, and
    the key moves with the flags and the source: a binary built under
    another key (another compiler, CPU, source or flags) is never used."""
    build_dir, key = built_lib_dir
    foreign = build_dir / f"af_host-{'0' * 16}.so"
    foreign.write_bytes(b"not a library")
    assert native._build() == str(build_dir / f"af_host-{key}.so")
    if change == "flags":
        monkeypatch.setenv("AF_TPU_NATIVE_CFLAGS", "-DAF_KEY_PROBE=1")
    else:
        src = build_dir / "af_host.cc"
        shutil.copy(native._SRC, src)
        with open(src, "a") as f:
            f.write("\n// key probe\n")
        monkeypatch.setattr(native, "_SRC", str(src))
    other = native.build_key(native._flags())
    assert other != key
    assert native.lib_path(other) not in (str(foreign), native.lib_path(key))


def test_chip_smoke_refuses_cpu(capsys):
    """The smoke test's device phase exits (non-zero, naming the missing
    GPU) before any work when JAX's first device is not a GPU."""
    import chip_smoke

    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as exc:
        chip_smoke.phase0_device()
    assert "no GPU" in str(exc.value.code)
    assert capsys.readouterr().out == ""
