"""Test configuration: run on a virtual 8-device CPU mesh with x64 enabled.

Multi-device sharding paths (psum / all_gather over a Mesh) are exercised
without accelerators via ``xla_force_host_platform_device_count``; numeric
parity tests need float64, which is fast on CPU.  The checks that need a
GPU are the phases of ``python chip_smoke.py``.
"""

import os

# tests run on the local CPU with a forced 8-device mesh, whatever
# accelerator the machine has
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
if "parallel_codegen_split_count" not in flags:
    # XLA:CPU's parallel LLVM codegen intermittently segfaults/aborts deep
    # into a long one-process suite (observed at >40 compiled programs;
    # state-dependent, moves between tests).  Single-split codegen trades a
    # little compile time for a deterministic suite.
    flags += " --xla_cpu_parallel_codegen_split_count=1"
os.environ["XLA_FLAGS"] = flags
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REF = "/root/reference"


@pytest.fixture(scope="session")
def arm_datafile():
    path = os.path.join(REF, "datafiles",
                        "arm-3link-markers-noload-50trials_train-10_val-5.mat")
    if not os.path.exists(path):
        pytest.skip("reference arm datafile not available")
    return path


@pytest.fixture(scope="session")
def arm_dataset(arm_datafile):
    from koopman_realizations.utils.matio import load_data4sysid
    return load_data4sysid(arm_datafile)


@pytest.fixture(scope="session")
def blockM_ref():
    path = os.path.join(REF, "trajectories", "files",
                        "blockM_c0p45-0p35_0p5x0p5_15sec.mat")
    if not os.path.exists(path):
        pytest.skip("reference blockM trajectory not available")
    from koopman_realizations.utils.matio import load_ref_trajectory
    return load_ref_trajectory(path)


@pytest.fixture(scope="session")
def arm_generated():
    """The in-repo arm corpus (``utils.data.generate_arm_data``, seed 0):
    15 ramp-and-hold trials of 60 s, 10 train + 5 val."""
    from koopman_realizations.utils.data import generate_arm_data
    return generate_arm_data(seed=0)


@pytest.fixture(scope="session")
def blockM_generated():
    """The blockM reference rebuilt in-repo (reproduces the reference's
    trajectory file to ~1e-15)."""
    from koopman_realizations.utils.trajectories import (
        get_blockM,
        make_trajectory,
    )
    return make_trajectory(get_blockM([0.45, -0.35], 0.5, 0.5), T=15.0,
                           Ts=0.05, flip_y=True)


@pytest.fixture()
def rng():
    # function-scoped: every test sees the same deterministic stream
    # regardless of execution order
    return np.random.default_rng(0)
