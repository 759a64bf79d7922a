"""Kernel selection, compile-cache placement and the GPU-only scripts.

``kernels.backend: auto`` takes the fused Pallas sweep only on a GPU; an
explicit ``pallas`` off the GPU is an error (the kernel compiles only for
the GPU, and the solver never falls back to the interpreter).  The
measurement scripts refuse to run without a GPU.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cedar_jax import FivePt, NinePt, SevenPt, Solver2, Solver3, gallery
from cedar_jax.config import Config
from cedar_jax.settings import MLSettings, device_platform, resolve_backend
from cedar_jax.solver import cycle2
from cedar_jax.utils.cache import ENV, compile_cache_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("requested,platform,expected", [
    ("auto", "gpu", "pallas"),
    ("auto", "cpu", "xla"),
    ("auto", "rocm", "xla"),
    ("xla", "gpu", "xla"),
    ("xla", "cpu", "xla"),
    ("pallas", "gpu", "pallas"),
])
def test_resolve_backend(requested, platform, expected):
    assert resolve_backend(requested, platform) == expected


@pytest.mark.parametrize("platform", ["cpu", "rocm"])
def test_resolve_explicit_pallas_off_gpu_raises(platform):
    with pytest.raises(ValueError, match="GPU"):
        resolve_backend("pallas", platform)


def test_device_platform_of_arrays():
    assert device_platform(jnp.zeros(3)) == "cpu"
    assert device_platform(np.zeros(3)) == "cpu"


@pytest.mark.parametrize("cls,kind,so", [
    (Solver2, FivePt, lambda: gallery.poisson(16, 16)),
    (Solver3, SevenPt, lambda: gallery.poisson3(8, 8, 8)),
])
def test_auto_is_xla_on_cpu(cls, kind, so):
    s = cls(so(), kind, Config({"log": []}))
    assert s.settings.kernel_backend == "xla"


@pytest.mark.parametrize("cls,kind,so", [
    (Solver2, FivePt, lambda: gallery.poisson(16, 16)),
    (Solver3, SevenPt, lambda: gallery.poisson3(8, 8, 8)),
])
def test_explicit_pallas_on_cpu_raises(cls, kind, so):
    with pytest.raises(ValueError, match="GPU"):
        cls(so(), kind, Config({"log": [], "kernels": {"backend": "pallas"}}))


def test_explicit_pallas_on_cpu_mesh_raises():
    from cedar_jax.parallel import DistSolver2, make_mesh

    mesh = make_mesh(2, devices=jax.devices("cpu"))
    with pytest.raises(ValueError, match="GPU"):
        DistSolver2(gallery.poisson(16, 16), FivePt,
                    Config({"log": [], "kernels": {"backend": "pallas"}}),
                    mesh)


def test_dist_auto_keeps_xla_sweeps():
    from cedar_jax.parallel import DistSolver2, make_mesh

    mesh = make_mesh(2, devices=jax.devices("cpu"))
    conf = Config({"log": []})
    s = DistSolver2(gallery.poisson(32, 32), FivePt, conf, mesh)
    assert s.settings.kernel_backend == "xla"
    assert conf.get("kernels.backend") == "xla"


@pytest.mark.parametrize("backend,shape,dtype,periodic,shard,expected", [
    ("pallas", (64, 64), jnp.float32, (False, False), None, True),
    ("pallas", (7, 9), jnp.float32, (True, True), None, True),
    ("pallas", (64, 64), jnp.float64, (False, False), None, False),
    ("pallas", (64, 64), jnp.float32, (False, False), "sharded", False),
    ("pallas", (2, 64), jnp.float32, (True, False), None, False),
    ("xla", (64, 64), jnp.float32, (False, False), None, False),
])
def test_use_pallas_gating(backend, shape, dtype, periodic, shard,
                           expected):
    """The kernel runs on serial float32 levels of the pallas backend
    only; sharded levels keep the XLA sweep."""
    st = MLSettings()
    st.kernel_backend = backend
    for kind in (FivePt, NinePt):
        assert cycle2._use_pallas(st, kind, shape, dtype, periodic,
                                  shard) == expected


def test_compile_cache_dir_from_environment(tmp_path):
    env = {ENV: str(tmp_path / "cache")}
    assert compile_cache_dir("/some/checkout", env) == str(tmp_path /
                                                           "cache")


def test_compile_cache_dir_default_is_fixed():
    """Without the variable: <checkout>/.jax_cache, the same path in every
    process (never temporary or per-process)."""
    a = compile_cache_dir(ROOT, {})
    b = compile_cache_dir(ROOT + "/.", {})
    assert a == b == os.path.join(ROOT, ".jax_cache")
    assert compile_cache_dir(ROOT, {ENV: ""}) == a


def test_compile_cache_dir_is_gitignored():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def _bench():
    sys.path.insert(0, ROOT)
    try:
        import bench
    finally:
        sys.path.remove(ROOT)
    return bench


def test_bench_peak_table_h100():
    assert _bench().peak_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12


@pytest.mark.parametrize("kind", ["AMD Instinct MI300X", "cpu",
                                  "NVIDIA A100-SXM4-80GB", ""])
def test_bench_peak_table_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no peak bandwidth"):
        _bench().peak_bandwidth(kind)


def test_bench_traffic_model_scales_with_area():
    bench = _bench()
    assert bench.vcycle_traffic_bytes(8192, 8192) == pytest.approx(
        4 * bench.vcycle_traffic_bytes(4096, 4096))
