"""The particle × qubit mesh of the port (``qbot_tpu_torch/tpu/
sharded_ensemble.py``, ``run_lowered_sharded_ensemble``,
``execute_lines_device_ensemble(mesh=)``) against ``qbot_tpu``'s, on the
CPU.

One gloo group of spawned CPU ranks for each mesh shape of the module
(1×2, 2×1, 2×2, 2×4; ``sharding.launch``), each rank running every case of
``tests/_torch_sharded_ensemble_ranks.py`` for its shape, rank 0 writing
the results to npz files, held to the reference's runners on the 8-device
emulated mesh of ``tests/conftest.py`` of the same shape, on the cases of
``tests/test_sharded_ensemble.py`` and ``tests/test_device_ensemble.py``
(:226-290), each reference result built once: outcome distributions and
the final mixture within 1e-5 (float32 states), and the register's width,
its particles, ``lost_mass``, ``collapse_events``, ``num_reshards``,
``comm_bytes``, ``hbm_bytes`` and ``num_collectives`` equal; the
hand-counted collectives (:275-333); a run stopped by an injected fault
resumed from its snapshots (:200-271); the epilogue.

Sampled mode cannot repeat the reference's draws (torch generators are not
JAX keys), so it is held three ways: on a P = 1 mesh the runner gives the
marginals of the port's own single-device ``run_lowered_ensemble`` with
the same seed (one island: the same draws); the island resampler gives the
reference's indices for the same uniform (``tests/
test_torch_sharded_ensemble_cli.py``); sampled marginals of 1024
particles lie within 0.06 (> 3σ) of the exact ones (:515-596), and a
degenerate island mixture fires the island exchange.

``tests/test_torch_sharded_ensemble_cli.py`` holds the resampler and the
CLI.
"""
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import _torch_sharded_ensemble_ranks as cases
from qbot_tpu.frontend import lowering as jl
from qbot_tpu.frontend.device_ensemble import (
    executeTxtDeviceEnsemble as ref_device,
)
from qbot_tpu.tpu import sharded_ensemble as jse
from qbot_tpu.tpu.sharding import make_mesh
from qbot_tpu_torch import executeTxt, executeTxtEnsemble
from qbot_tpu_torch.tpu.sharding import launch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5


def _mesh(shape):
    return make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """``group(shape)``: the directory of the npz files the ranks of one
    gloo mesh of ``shape`` wrote, running every case once for the
    module."""
    dirs = {}

    def get(shape):
        if shape not in dirs:
            out = tmp_path_factory.mktemp(f"mesh_{shape[0]}x{shape[1]}")
            try:
                launch(cases.run_rank, shape, str(out), device="cpu",
                       timeout=600,
                       collective_timeout=cases.COLLECTIVE_TIMEOUT)
            except RuntimeError as e:   # each test of this shape fails
                dirs[shape] = e
                raise
            dirs[shape] = out
        if isinstance(dirs[shape], RuntimeError):
            raise dirs[shape]
        return dirs[shape]
    return get


def _load(group, shape, name):
    with np.load(group(shape) / f"{name}.npz") as f:
        return {key: f[key] for key in f.files}


_REF: dict = {}


def _ref_run(src, shape, **kw):
    """(results, ensemble, perm, stats) of the reference's mesh runner,
    once a case."""
    key = (src, shape, tuple(sorted(kw.items())))
    if key not in _REF:
        stats = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            res, ens, perm, _ = jl.run_lowered_sharded_ensemble(
                jl.lower_program(src, mid_measure=True), mesh=_mesh(shape),
                stats=stats, **kw)
        _REF[key] = res, ens, perm, stats
    return _REF[key]


def _close_probs(got: dict, results, prefix: str = "probs_",
                 tol: float = TOL) -> None:
    names = sorted(k[len(prefix):] for k in got if k.startswith(prefix))
    assert names == sorted(results)
    for name in names:
        np.testing.assert_allclose(got[prefix + name],
                                   np.asarray(results[name].probs), atol=tol)


RUN_CASES = [(name, shape) for name in cases.RUNS
             for shape in cases.RUN_SHAPES[name]]
# the cases that measure in a basis other than the computation basis
ROTATED = ("bell",)


@pytest.mark.parametrize("name,shape", RUN_CASES)
def test_run_matches_reference(group, name, shape):
    """Outcome distributions, the final mixture, the register's width and
    every counter of ``stats`` against the reference's run on the same
    mesh shape."""
    got = _load(group, shape, f"run_{name}")
    src, kw = cases.RUNS[name]
    res, ens, perm, stats = _ref_run(src, shape, **kw)
    _close_probs(got, res)
    np.testing.assert_allclose(got["mixture"],
                               jse.sharded_ensemble_mixture(ens, perm),
                               atol=TOL)
    assert int(got["width"]) * shape[1] == ens.psi.shape[-1]
    assert int(got["perm_len"]) == len(perm)
    assert int(got["particles"]) == ens.num_particles
    np.testing.assert_allclose(float(got["lost_mass"]),
                               float(np.asarray(ens.lost_mass)), atol=1e-6)
    assert int(got["num_collectives"]) == stats["num_collectives"]
    assert int(got["collapse_events"]) == stats["collapse_events"]
    for key in ("num_reshards", "comm_bytes", "hbm_bytes"):
        # the port also counts a measurement basis's rotation plans, which
        # the reference runs without counting
        if name in ROTATED:
            assert int(got[key]) >= stats[key], key
        else:
            assert int(got[key]) == stats[key], key
    assert {"init", "collapse", "fetch"} <= set(got["phases"])


@pytest.mark.parametrize("name", ["disc_dense", "qset_probval"])
def test_run_matches_dense_interpreter(group, name):
    """A shrunk register and ProbVal target sets: the dense interpreter's
    marginal and state."""
    got = _load(group, (2, 2), f"run_{name}")
    ns = executeTxt(cases.RUNS[name][0])
    np.testing.assert_allclose(got["probs_m"], ns["m"].probs, atol=1e-6)
    if name == "disc_dense":
        np.testing.assert_allclose(got["mixture"],
                                   np.asarray(ns["state"], complex),
                                   atol=TOL)


def test_disc_shrinks_the_register(group):
    for shape in cases.SHAPES:
        got = _load(group, shape, "run_disc")
        assert int(got["width"]) * shape[1] == 2**3
        assert int(got["perm_len"]) == 3


def test_lost_mass_bound_matches_single_device(group):
    """P = 1: the per-row quota prune is the global top-k, so the bound is
    the single-device runner's."""
    got = _load(group, (1, 2), "run_lost_mass")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        _, ref_ens = jl.run_lowered_ensemble(
            jl.lower_program(cases.RUNS["lost_mass"][0], mid_measure=True),
            max_particles=3)
    assert float(got["lost_mass"]) > 0
    np.testing.assert_allclose(float(got["lost_mass"]),
                               float(ref_ens.lost_mass), rtol=1e-6)


def test_collective_counts_are_exact(group):
    """The hand counts of tests/test_sharded_ensemble.py:275-333 (P = 2):
    a fan-out without a prune 6, with one 8; the runner's program 17 over
    3 collapse events."""
    counts = _load(group, (2, 2), "fanout_counts")
    assert int(counts["count_no_prune"]) == 6
    assert int(counts["count_prune"]) == 8
    got = _load(group, (2, 2), "run_hand")
    assert int(got["collapse_events"]) == 3
    assert int(got["num_collectives"]) == 17


def test_epilogue_runs_with_results_bound(group):
    assert "0.5" in str(_load(group, (2, 2), "epilogue")["stdout"])


def test_restart_from_snapshot_matches_uninterrupted(group):
    """A run whose third fan-out raised resumes from its last snapshot:
    the same distributions and final mixture as an uninterrupted run (and
    the reference's); snapshots roll, one an event, three kept."""
    got = _load(group, (2, 2), "resume")
    res, ens, perm, _ = _ref_run(cases.SRC_RESUME, (2, 2))
    for name in ("a", "b", "c"):
        np.testing.assert_allclose(got[f"got_probs_{name}"],
                                   got[f"want_probs_{name}"], atol=1e-6)
        np.testing.assert_allclose(got[f"want_probs_{name}"],
                                   res[name].probs, atol=TOL)
    np.testing.assert_allclose(got["got_mixture"], got["want_mixture"],
                               atol=TOL)
    np.testing.assert_allclose(got["want_mixture"],
                               jse.sharded_ensemble_mixture(ens, perm),
                               atol=TOL)
    assert list(got["roll_steps"]) == [2, 3, 4]
    np.testing.assert_allclose(got["roll_probs_c"], got["want_probs_c"],
                               atol=1e-6)


DEVICE_CASES = [(name, shape) for name in cases.DEVICE
                for shape in cases.DEVICE_SHAPES[name]]


@pytest.mark.parametrize("name,shape", DEVICE_CASES)
def test_device_ensemble_mesh_matches_reference(group, name, shape):
    """``executeTxtDeviceEnsemble(mesh=)``: the reference's on the same
    mesh shape and the port's host ensemble (a sampled run: its
    measurement before any draw)."""
    got = _load(group, shape, f"device_{name}")
    src, kw = cases.DEVICE[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = ref_device(src, mesh=_mesh(shape), **kw)
    host = executeTxtEnsemble(src)
    for key in ("m", "b"):
        if f"probs_{key}" in got:
            np.testing.assert_allclose(got[f"probs_{key}"], want[key].probs,
                                       atol=TOL)
            np.testing.assert_allclose(got[f"probs_{key}"], host[key].probs,
                                       atol=TOL)
    assert bool(got["state_is_probval"]) == (
        type(want["state"]).__name__ == "ProbVal")
    if "state" in got and not kw:
        np.testing.assert_allclose(got["state"],
                                   np.asarray(want["state"], complex),
                                   atol=TOL)


@pytest.mark.parametrize("name", ["qset_mixed", "disc_targets", "deep"])
def test_sampled_p1_mesh_matches_single_device(group, name):
    """On a P = 1 mesh the runner's draws are the single-device
    ``run_lowered_ensemble``'s for the same seed: its row generator is
    seeded with the seed and draws in the same order."""
    got = _load(group, (1, 2), "sampled_p1")
    names = sorted(k[len(f"{name}_mesh_"):] for k in got
                   if k.startswith(f"{name}_mesh_"))
    assert names
    for key in names:
        np.testing.assert_allclose(got[f"{name}_mesh_{key}"],
                                   got[f"{name}_single_{key}"], atol=1e-6)


@pytest.mark.parametrize("name", ["qset", "qset_mixed", "qset_targets",
                                  "disc_targets"])
def test_sampled_marginals_within_bound_of_exact(group, name):
    """1024 sampled particles within 0.06 of the exact marginals, whose
    run matches the reference's."""
    got = _load(group, (2, 2), "sampled")
    assert int(got[f"{name}_particles"]) == cases.SAMPLED_B
    res, _, _, _ = _ref_run(cases.SAMPLED[name], (2, 2))
    _close_probs(got, res, f"{name}_exact_probs_")
    names = [k[len(f"{name}_exact_"):] for k in got
             if k.startswith(f"{name}_exact_")]
    for key in names:
        np.testing.assert_allclose(got[f"{name}_sampled_{key}"],
                                   got[f"{name}_exact_{key}"],
                                   atol=cases.SAMPLED_TOL)


def test_island_exchange_rebalances_islands(group):
    """A skewed initial mixture over 8 collapses: the exchange fired, the
    islands end balanced, the first marginal (drawn before any
    resampling) is the dense interpreter's, every marginal sums to 1."""
    got = _load(group, (2, 2), "sampled")
    assert int(got["deep_exchanges"]) >= 1
    L = got["deep_island_log_weights"]
    w = np.exp(L - L.max())
    w = w / w.sum()
    assert 1.0 / np.sum(w * w) >= 0.99 * 2 - 1e-9
    ns = executeTxt(cases.DEEP)
    np.testing.assert_allclose(got["deep_probs_m0"], ns["m0"].probs,
                               atol=1e-6)
    for i in range(8):
        np.testing.assert_allclose(np.sum(got[f"deep_probs_m{i}"]), 1.0,
                                   atol=1e-5)
