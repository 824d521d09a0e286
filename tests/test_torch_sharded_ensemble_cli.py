"""The particle × qubit mesh's island resampler and CLI against
``qbot_tpu``'s, on the CPU (the runners: ``tests/
test_torch_sharded_ensemble.py``).

- ``inference/smc.py:island_indices`` gives the indices and the shared
  weight of the reference's ``_island_resample`` for the same uniform
  draw, and of its ``resample_down_sharded`` (a 1×1 mesh), to 1e-12.
- ``python -m qbot_tpu_torch FILE --compile --ensemble`` with ``--mesh
  2x2``, ``--shard 1``, ``--mesh auto`` and ``--mesh 3x4`` (``--device
  cpu``: gloo ranks) prints ``python -m qbot_tpu``'s readout within 1e-6,
  its exit code, its ``mesh auto:`` and ``mesh error:`` lines and the
  branches and particles of its ``device ensemble:`` line.
- ``utils/config.py:auto_mesh_shape``: the reference's shapes with the
  default budget; on the card the CLI budgets half of a device's memory.
"""
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_precision import _same_numbers
from qbot_tpu.tpu import sharded_ensemble as jse
from qbot_tpu.tpu.sharding import make_mesh
from qbot_tpu_torch import lower_program
from qbot_tpu_torch.cli import main as torch_cli
from qbot_tpu_torch.inference.smc import island_indices
from qbot_tpu_torch.utils import config

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("seed", range(6))
def test_island_indices_match_reference(seed):
    """The island resampler's indices and shared weight: the reference's
    ``_island_resample`` for the same uniform draw, and its
    ``resample_down_sharded`` (a 1×1 mesh) resampling down to fewer
    particles."""
    rng = np.random.default_rng(seed)
    Bl = 16
    log_w = np.log(rng.dirichlet(np.ones(Bl) * 0.3) + 1e-9) + seed
    key = jax.random.PRNGKey(seed)
    u0 = float(jax.random.uniform(key, ()))
    want_lw, want_idx = jse._island_resample(
        key, jnp.asarray(log_w), jnp.arange(Bl), 0.0, None)
    idx, island = island_indices(torch.from_numpy(log_w), u0)
    assert idx.tolist() == np.asarray(want_idx).tolist()
    np.testing.assert_allclose(float(island) - np.log(Bl),
                               np.asarray(want_lw), rtol=1e-12)
    B_out = 6
    psi = np.zeros((Bl, 2, 2), np.float32)
    psi[:, 0, 0] = np.arange(Bl)
    emesh = jse.EnsembleMesh(make_mesh((1, 1), devices=jax.devices()[:1]))
    ens = jse.ShardedEnsemble(jnp.asarray(log_w), jnp.asarray(psi), 0.0)
    down = jse.resample_down_sharded(key, ens, B_out, emesh)
    u_down = float(jax.random.uniform(jax.random.fold_in(key, 0), ()))
    idx, island = island_indices(torch.from_numpy(log_w), u_down, B_out)
    assert idx.tolist() == np.asarray(down.psi)[:, 0, 0].astype(int).tolist()
    np.testing.assert_allclose(float(island) - np.log(B_out),
                               np.asarray(down.log_w), rtol=1e-12)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _run(module, *args):
    # each run compiles afresh (tests/test_torch_precision.py:_run)
    env = {**os.environ, "QBOT_TPU_COMPILE_CACHE": "off"}
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=300)


def _lines(stderr, *prefixes):
    return [line for line in stderr.splitlines() if line.startswith(prefixes)]


@pytest.mark.parametrize("flags", [["--mesh", "2x2"], ["--shard", "1"],
                                   ["--mesh", "auto"], ["--mesh", "3x4"]])
def test_cli_mesh_matches_reference(flags, capsys):
    """The exit code, the readout within 1e-6, the ``mesh auto:`` and
    ``mesh error:`` lines, and the branches and particles of the
    ``device ensemble:`` line of ``python -m qbot_tpu``'s run."""
    args = ["examples/mid_measurement.qb", "--compile", "--ensemble", *flags]
    rc = torch_cli([*args, "--device", "cpu"])
    got = capsys.readouterr()
    want = _run("qbot_tpu", *args)
    assert rc == want.returncode, got.err + want.stderr
    _same_numbers(got.out, want.stdout, 1e-6)
    assert (_lines(got.err, "mesh auto:", "mesh error:")
            == _lines(want.stderr, "mesh auto:", "mesh error:"))
    ours = _lines(got.err, "device ensemble:")
    theirs = _lines(want.stderr, "device ensemble:")
    assert [s.split(", pruned")[0] for s in ours] == \
        [s.split(", pruned")[0] for s in theirs]
    if flags[-1] == "auto":
        assert len(_lines(got.err, "mesh auto:")) == 1


def test_auto_mesh_shape_default_budget_is_the_reference():
    """The default budget picks the reference's shapes (the CPU runs and
    the tests rely on it)."""
    from qbot_tpu.utils.config import auto_mesh_shape as ref_auto

    for devices in (1, 2, 4, 8):
        for n in (None, 4, 24, 29, 30, 31, 32, 34):
            assert (config.auto_mesh_shape(devices, n)
                    == ref_auto(devices, n)), (devices, n)


def test_cli_auto_mesh_on_the_card_uses_half_its_memory(monkeypatch,
                                                        capsys):
    """On the card ``--mesh auto`` counts the CUDA devices and budgets
    half of one's memory: a register of S bytes (planar float32) on cards
    of 1.5·S bytes takes two qubit shards; on cards of 1 GiB, none."""
    from qbot_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    src = ROOT / "examples" / "mid_measurement.qb"
    state = 2 * 2 ** lower_program(src.read_text(), mid_measure=True).n * 4
    args = types.SimpleNamespace(shard=0, mesh="auto", device="cuda")
    for memory, shape in ((1.5 * state, (2, 2)), (2**30, (4, 1))):
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda dev, m=memory: types.SimpleNamespace(
                                total_memory=m))
        got, error = cli._ensemble_mesh_shape(str(src), args)
        assert error is None and got == shape
        assert capsys.readouterr().err.strip() == (
            f"mesh auto: {shape[0]}x{shape[1]} (particles x qubit-shards)")
    assert cli.CPU_MESH_RANKS == 8
