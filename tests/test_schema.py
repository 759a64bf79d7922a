"""Config schema validation + settings edge cases.

The reference ships a JSON schema + offline validator
(src/config/schema.json, src/config/validate.py); here validation runs at
solver construction (tests: typo'd key, invalid enum, recursive cg-config,
zero rhs, relax-symmetric knob, deep cg-config nesting).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from cedar_jax import FivePt, Solver2, gallery
from cedar_jax.config import Config
from cedar_jax.schema import ConfigError, validate
from cedar_jax.settings import CGType, MLSettings


def test_typo_key_rejected():
    with pytest.raises(ConfigError, match="nrelax_pre"):
        validate({"solver": {"cycle": {"nrelax_pre": 2}}})


def test_unknown_top_level_rejected():
    with pytest.raises(ConfigError, match="unknown config key 'slover'"):
        validate({"slover": {"max-iter": 3}})


def test_invalid_enum_rejected():
    with pytest.raises(ConfigError, match="relaxation"):
        validate({"solver": {"relaxation": "pointy"}})
    with pytest.raises(ConfigError, match="cg-solver"):
        validate({"solver": {"cg-solver": "QR"}})


def test_invalid_type_rejected():
    with pytest.raises(ConfigError, match="max-iter"):
        validate({"solver": {"max-iter": "ten"}})
    with pytest.raises(ConfigError, match="log"):
        validate({"log": ["status", "verbose"]})


def test_nested_cg_config_validated():
    with pytest.raises(ConfigError, match="relaxation"):
        validate({"cg-config": {"solver": {"relaxation": "bogus"}}})


def test_valid_cedar_config_accepted():
    validate({
        "log": ["status", "error"],
        "grid": {"periodic": [False, False]},
        "solver": {
            "relaxation": "line-xy",
            "cycle": {"type": "v", "nrelax-pre": 2, "nrelax-post": 1},
            "tol": 1e-8, "max-iter": 10, "min-coarse": 3,
            "cg-solver": "redist",
            "ml-relax": {"enabled": False, "min-gsz": 3},
        },
        "redist": {"search": {"strategy": "coarsen"}},
        "machine": {"bandwidth": 177e6, "latency": 6.5e-7,
                    "fp_perf": 4.4e-10},
        "cg-config": {"solver": {"relaxation": "point"}},
    })


def test_solver_construction_rejects_bad_config():
    so = gallery.poisson(16, 16)
    with pytest.raises(ConfigError):
        Solver2(so, FivePt, {"log": [], "solver": {"relxation": "point"}})


def test_nested_cg_config_depth():
    """Explicit cg-configs nest arbitrarily (reference:
    test/2d/mpi/test-cgredist-1.json nests redist solvers to depth 3);
    the implicit (inherited) inner config terminates with a direct solve."""
    conf = Config({
        "solver": {"cg-solver": "cedar"},
        "cg-config": {
            "solver": {"cg-solver": "cedar"},
            "cg-config": {"solver": {"cg-solver": "LU", "max-iter": 5}},
        },
    })
    s = MLSettings.from_config(conf)
    assert s.coarse_solver == CGType.serial
    assert s.cg_settings.coarse_solver == CGType.serial
    assert s.cg_settings.cg_settings.coarse_solver == CGType.lu
    assert s.cg_settings.cg_settings.maxiter == 5

    # inherited (no explicit cg-config): inner coarse solve forced direct
    s2 = MLSettings.from_config(Config({"solver": {"cg-solver": "cedar"}}))
    assert s2.cg_settings.coarse_solver == CGType.lu


def test_zero_rhs_no_nan():
    """b = 0: the relative-residual history must stay finite (res0 floor)."""
    so = gallery.poisson(32, 32)
    s = Solver2(so, FivePt, {"log": [], "solver": {"max-iter": 3}})
    x = s.solve(jnp.zeros((32, 32)))
    assert np.isfinite(np.asarray(x)).all()
    assert all(np.isfinite(h) for h in s.history)


def test_relax_nonsymmetric_converges():
    """solver.relax-symmetric false: forward sweep order both ways
    (reference IRELAX_SYM branch) — still converges on Poisson."""
    so = gallery.poisson(64, 64)
    b = gallery.poisson_rhs(64, 64)
    s = Solver2(so, FivePt, {
        "log": [],
        "solver": {"relax-symmetric": False, "tol": 1e-8, "max-iter": 20},
    })
    assert s.settings.relax_symmetric is False
    s.solve(b)
    assert s.history[-1] < 1e-8
