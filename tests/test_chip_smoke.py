"""chip_smoke.py, the compile-cache and native-build helpers, and the guard
that the package holds no TPU-only kernel code.

The card-only run (`python chip_smoke.py` on a GPU) is marked `gpu` and
skips here; the CPU tests drive the same script through --rehearse.
"""

import ast
import ctypes
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(args, cwd=REPO, extra_env=None, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(extra_env or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("four", [False, True], ids=["one", "four"])
def test_chip_smoke_rehearsal_runs_every_phase(four):
    extra = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    args = ["chip_smoke.py", "--rehearse"] + (["--four"] if four else [])
    r = _run(args, extra_env=extra)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout.strip().splitlines()
    last = json.loads(out[-1])
    assert last["ok"] is True
    assert last["device"] == {"platform": "cpu", "kind": "cpu", "count": 4}
    assert out[0].startswith("nvidia-smi:")
    phases = ("four superblock", "four fec") if four else (
        "phase main_path passed", "phase front_end passed",
        "phase demod passed", "phase fec passed")
    for p in phases:
        assert any(p in line for line in out), p


def test_chip_smoke_without_gpu_fails_and_prints_no_result():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py", "--rehearse"], cwd=tmp_path, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture
def gpu():
    """Skips unless a card is present (this process itself runs JAX on the
    CPU, so the check asks nvidia-smi)."""
    from tetra_tpu import device_info
    if not device_info.nvidia_smi():
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["ok"] is True


@pytest.mark.parametrize("env_dir", [False, True], ids=["default", "env"])
def test_compile_cache_location(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins untouched; otherwise the fixed
    in-checkout directory.  Runs in a fresh process: the setting is
    process-global."""
    code = ("import jax; from tetra_tpu import compile_cache as cc; "
            "d = cc.enable(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    env = {}
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    else:
        env["JAX_COMPILATION_CACHE_DIR"] = ""
    r = _run(["-c", code], extra_env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    used, configured = r.stdout.strip().splitlines()[-2:]
    want = str(tmp_path / "cache") if env_dir else str(REPO / ".jax_cache")
    assert used == want
    assert configured == want


def test_fleet_library_builds_from_a_clean_directory(tmp_path):
    """The native fleet engine compiles from its sources into an empty
    directory, loads, and matches the Python struct layout; a second build
    reuses the hash-keyed binary."""
    from tetra_tpu.rx import fleet

    so = fleet.build_library(str(tmp_path))
    assert os.path.dirname(so) == str(tmp_path)
    lib = ctypes.CDLL(so)
    lib.fleet_chan_size.restype = ctypes.c_int64
    assert lib.fleet_chan_size() == ctypes.sizeof(fleet.FleetChanStruct)
    mtime = os.path.getmtime(so)
    assert fleet.build_library(str(tmp_path)) == so
    assert os.path.getmtime(so) == mtime


def test_native_build_key_follows_the_source(tmp_path):
    from tetra_tpu import native_build

    src = tmp_path / "a.cpp"
    src.write_text('extern "C" int f() { return 1; }\n')
    out = tmp_path / "out"
    first = native_build.build("t", str(src), out_dir=str(out))
    src.write_text('extern "C" int f() { return 2; }\n')
    second = native_build.build("t", str(src), out_dir=str(out))
    assert first != second
    lib = ctypes.CDLL(second)
    assert lib.f() == 2


def test_no_tpu_kernel_imports():
    """No module of the package imports the TPU Pallas backend."""
    tpu_backend = "jax.experimental.pallas." + "tpu"
    bad = []
    for path in (REPO / "tetra_tpu").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] + [f"{node.module}.{a.name}"
                                         for a in node.names]
            if any(n.startswith(tpu_backend) for n in names):
                bad.append(str(path.relative_to(REPO)))
    assert not bad, bad
