"""The qubit-sharded register of the port (``qbot_tpu_torch/tpu/sharded.py``,
``run_lowered_sharded``, ``--compile --shard K``) against ``qbot_tpu``'s, on
the CPU.

- The plans (no process group): ``compile_sharded`` and
  ``compile_sharded_density`` equal the reference's ``ShardedPlan`` field
  by field (items, ``final_perm``, the counts) and in ``num_reshards``,
  ``comm_bytes`` and ``hbm_bytes``, on the circuits of
  ``tests/test_sharded_planar.py`` and ``tests/test_sharded_density.py``
  (n = 8, 9; k = 1, 2, 3), random brickworks (the card's 26-qubit one
  included) and Grover; so do ``plan_perm_to_identity``,
  ``plan_reshards_to_localize`` and ``density_circuit``.
- The executor: one gloo group of K = 2, 4 and 8 spawned CPU ranks for the
  module, each rank running every case of ``tests/_torch_sharded_ranks.py``
  (rank 0 writes the gathered results to npz files), held to the
  reference's ``make_sharded_planar_runner`` on the emulated 8-device mesh
  (``tests/conftest.py``) from the same seeded input: the state, every item
  kind (Reshard, BitSwap, ShardedDiag, ShardedFlip, ShardedReflect,
  LocalPerm), ``sharded_probs_fn`` with targets on sharded and local axes,
  the density runner, its marginals and ``sharded_density_discard``, and
  ``run_lowered_sharded`` on programs and the examples.  Tolerance: 1e-5
  absolute, float32, as ``tests/test_torch_planar.py`` holds the
  single-device plan.
- The CLI: ``python -m qbot_tpu_torch FILE --compile --shard K --device
  cpu`` prints the readout and the ``sharded:`` (or ``sharding error:``)
  stderr line of ``python -m qbot_tpu FILE --compile --shard K``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_sharded_ranks as cases
from _torch_parity import assert_same, brickwork
from test_torch_precision import _same_numbers
from qbot_tpu.frontend import lowering as jl
from qbot_tpu.tpu import circuit as jax_circuit
from qbot_tpu.tpu import sharded as js
from qbot_tpu.tpu.sharding import make_mesh
from qbot_tpu_torch.cli import main as torch_cli
from qbot_tpu_torch.tpu import circuit as torch_circuit
from qbot_tpu_torch.tpu import sharded as ts
from qbot_tpu_torch.tpu.sharding import launch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
SIZES = (2, 4, 8)
KINDS = {"LocalSegment", "Reshard", "BitSwap", "ShardedDiag", "ShardedFlip",
         "ShardedReflect", "LocalPerm"}


def _k(K):
    return K.bit_length() - 1


def _mesh(K):
    return make_mesh((1, K), devices=jax.devices()[:K])


def _shard(arr, mesh):
    return jax.device_put(jnp.asarray(arr), NamedSharding(mesh, P(None,
                                                                "qubits")))


def _theta(params):
    return None if params is None else jnp.asarray(params)


def assert_same_splan(got, want):
    assert_same(got, want, "splan")
    assert got.num_reshards == want.num_reshards
    assert got.comm_bytes() == want.comm_bytes()
    assert got.hbm_bytes() == want.hbm_bytes()


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", list(cases.state_cases(torch_circuit, 1)))
def test_compile_sharded_matches_reference(name, k):
    circ, _ = cases.state_cases(torch_circuit, k)[name]
    ref, _ = cases.state_cases(jax_circuit, k)[name]
    assert_same_splan(ts.compile_sharded(circ, k), js.compile_sharded(ref, k))


@pytest.mark.parametrize("k", [1, 2])
def test_compile_sharded_matches_reference_26q_brickwork(k):
    """The plan of the card's sharded brickwork (``chip_smoke.py`` phase
    14): 26 qubits, 16 layers."""
    got = ts.compile_sharded(brickwork(torch_circuit, 26, 16), k)
    want = js.compile_sharded(brickwork(jax_circuit, 26, 16), k)
    assert_same_splan(got, want)


def test_compile_sharded_refuses_what_the_reference_refuses():
    for k in (-1, 5):
        with pytest.raises(ValueError, match="cannot shard"):
            ts.compile_sharded(torch_circuit.Circuit(8).h(0), k)
        with pytest.raises(ValueError, match="cannot shard"):
            js.compile_sharded(jax_circuit.Circuit(8).h(0), k)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", list(cases.density_cases(torch_circuit, 1)))
def test_compile_sharded_density_matches_reference(name, k):
    circ = cases.density_cases(torch_circuit, k)[name][0]
    ref = cases.density_cases(jax_circuit, k)[name][0]
    assert_same(ts.density_circuit(circ), js.density_circuit(ref), "circuit")
    assert_same_splan(ts.compile_sharded_density(circ, k),
                      js.compile_sharded_density(ref, k))


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", list(cases.layout_cases(1)))
def test_layout_planners_match_reference(name, k):
    n, perm, kind, targets = cases.layout_cases(k)[name]
    got = cases.layout_items(ts, kind, perm, n, k, targets)
    want = cases.layout_items(js, kind, perm, n, k, targets)
    assert_same(got, want, "layout")


# ---------------------------------------------------------------------------
# the executor, on K gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """``group(K)``: the directory of the npz files that K spawned CPU
    ranks wrote, running every case once for the module."""
    dirs = {}

    def get(K):
        if K not in dirs:
            out = tmp_path_factory.mktemp(f"sharded_{K}")
            try:
                launch(cases.run_rank, K, str(out), device="cpu",
                       timeout=600)
            except RuntimeError as e:   # each test of this K fails with it
                dirs[K] = e
                raise
            dirs[K] = out
        if isinstance(dirs[K], RuntimeError):
            raise dirs[K]
        return dirs[K]
    return get


def _load(group, K, name):
    with np.load(group(K) / f"{name}.npz") as f:
        return {key: f[key] for key in f.files}


_REF: dict = {}


def _ref_state(name, K):
    """(sharded plan, mesh, output) of the reference's runner on a
    statevector case."""
    if (name, K) not in _REF:
        k = _k(K)
        circ, params = cases.state_cases(jax_circuit, k)[name]
        mesh = _mesh(K)
        splan = js.compile_sharded(circ, k)
        psi = js.make_sharded_planar_runner(splan, mesh)(
            js.sharded_zero_state(circ.n, mesh), _theta(params))
        _REF[name, K] = splan, mesh, psi
    return _REF[name, K]


@pytest.mark.parametrize("K", SIZES)
@pytest.mark.parametrize("name", list(cases.state_cases(torch_circuit, 1)))
def test_sharded_state_matches_reference(group, K, name):
    got = _load(group, K, f"state_{name}")
    splan, _, want = _ref_state(name, K)
    assert list(got["kinds"]) == [type(i).__name__ for i in splan.items]
    np.testing.assert_allclose(got["state"], np.asarray(want), atol=TOL)


@pytest.mark.parametrize("K", SIZES)
@pytest.mark.parametrize("label", list(cases.PROB_TARGETS))
@pytest.mark.parametrize("name", cases.PROB_CASES)
def test_sharded_probs_match_reference(group, K, name, label):
    got = _load(group, K, f"state_{name}")[f"probs_{label}"]
    splan, mesh, psi = _ref_state(name, K)
    targets = cases._resolve(cases.PROB_TARGETS[label], splan.n)
    want = np.asarray(js.sharded_probs_fn(splan, mesh, targets)(psi))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("K", SIZES)
@pytest.mark.parametrize("name", list(cases.layout_cases(1)))
def test_layouts_match_reference(group, K, name):
    """BitSwaps, LocalPerms and Reshards on a random state: the
    reference's runner on the same items; a layout restored to the
    identity is also the input in logical order."""
    k = _k(K)
    n, perm, kind, targets = cases.layout_cases(k)[name]
    items, final = cases.layout_items(js, kind, perm, n, k, targets)
    mesh = _mesh(K)
    psi0 = cases.random_state(n, 11 + k)
    want = js.make_sharded_planar_runner(
        js.ShardedPlan(n=n, k=k, items=items, final_perm=final), mesh)(
        _shard(psi0, mesh))
    got = _load(group, K, f"layout_{name}")
    assert list(got["kinds"]) == [type(i).__name__ for i in items]
    np.testing.assert_allclose(got["state"], np.asarray(want), atol=TOL)
    if kind == "identity":
        logical = ts.unpermute_planar(torch.from_numpy(psi0), perm).numpy()
        np.testing.assert_array_equal(got["state"], logical)


@pytest.mark.parametrize("K", SIZES)
def test_every_item_kind_ran(group, K):
    ran = set()
    for path in group(K).glob("*.npz"):
        with np.load(path) as f:
            if "kinds" in f.files:
                ran.update(f["kinds"])
    assert ran == KINDS


def _ref_density(name, K):
    if ("density", name, K) not in _REF:
        k = _k(K)
        circ, params, rho0 = cases.density_cases(jax_circuit, k)[name]
        mesh = _mesh(K)
        splan = js.compile_sharded_density(circ, k)
        rho = (js.sharded_zero_density(circ.n, mesh) if rho0 is None
               else js.shard_density(rho0, mesh))
        out = js.make_sharded_planar_runner(splan, mesh)(rho, _theta(params))
        _REF["density", name, K] = splan, mesh, out
    return _REF["density", name, K]


@pytest.mark.parametrize("K", SIZES)
@pytest.mark.parametrize("name", list(cases.density_cases(torch_circuit, 1)))
def test_sharded_density_matches_reference(group, K, name):
    got = _load(group, K, f"density_{name}")["rho"]
    _, _, want = _ref_density(name, K)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL)


@pytest.mark.parametrize("K", SIZES)
@pytest.mark.parametrize("label", list(cases.PROB_TARGETS))
def test_sharded_density_probs_match_reference(group, K, label):
    got = _load(group, K, "density_random")[f"probs_{label}"]
    splan, mesh, rho = _ref_density("random", K)
    targets = cases._resolve(cases.PROB_TARGETS[label], splan.n // 2)
    want = np.asarray(js.sharded_density_probs_fn(splan, mesh,
                                                  targets)(rho))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("K", SIZES)
@pytest.mark.parametrize("label", list(cases.DISCARDS))
def test_sharded_density_discard_matches_reference(group, K, label):
    got = _load(group, K, "density_random")
    splan, mesh, rho = _ref_density("random", K)
    n = splan.n // 2
    targets = cases._resolve(cases.DISCARDS[label], n)
    reduced, perm = js.sharded_density_discard(rho, n, _k(K), targets, mesh,
                                               perm=splan.final_perm)
    assert list(got[f"discard_{label}_perm"]) == list(perm)
    np.testing.assert_allclose(got[f"discard_{label}"], np.asarray(reduced),
                               atol=TOL)


PROGRAM_RUNS = [(K, name) for K in SIZES
                for name in cases.programs(_k(K))]


@pytest.mark.parametrize("K,name", PROGRAM_RUNS)
def test_run_lowered_sharded_matches_reference(group, K, name):
    got = _load(group, K, f"program_{name.replace('.', '_')}")["probs"]
    src = cases.programs(_k(K))[name]
    want, _, _ = jl.run_lowered_sharded(jl.lower_program(src), k=_k(K),
                                        mesh=_mesh(K))
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL)


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        launch(cases.fail_on_rank, 2, 1, device="cpu", timeout=120)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _run(module, *args):
    # each run compiles afresh (tests/test_torch_precision.py:_run)
    env = {**os.environ, "QBOT_TPU_COMPILE_CACHE": "off"}
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=300)


def _shard_line(stderr):
    return [line for line in stderr.splitlines()
            if line.startswith(("sharded:", "sharding error:"))]


@pytest.mark.parametrize("K", [1, 2])
def test_cli_shard_matches_reference(K, capsys):
    """The readout, the exit code and the ``sharded:`` line (or, on a
    register too narrow for 2^K shards, the ``sharding error:`` line) of
    ``qbot_tpu``."""
    args = ["examples/grover.qb", "--compile", "--shard", str(K)]
    rc = torch_cli([*args, "--device", "cpu"])
    got = capsys.readouterr()
    want = _run("qbot_tpu", *args)
    assert rc == want.returncode, got.err + want.stderr
    _same_numbers(got.out, want.stdout, 1e-6)
    assert _shard_line(got.err) == _shard_line(want.stderr)
    assert len(_shard_line(got.err)) == 1


def test_cli_shard_on_too_few_cards_is_a_sharding_error(monkeypatch, capsys):
    """Under ``--device cuda`` each rank takes a card of its own (nccl):
    too few cards is one ``sharding error`` line naming both counts, and
    nothing falls back to gloo or to the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert torch_cli(["examples/grover.qb", "--compile", "--shard", "1"]) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert out.err.splitlines() == [
        "sharding error: --shard 1 runs 2 ranks under nccl, one a CUDA "
        "device: 2 needed, 1 available"]


@pytest.mark.parametrize("flags,message", [
    (["--mesh", "1x4"], "sharding error: --mesh 1x4 has 4 qubit shards, "
                        "--shard 1 runs 2"),
    (["--mesh", "garbage"], "mesh error: --mesh expects exactly two factors"),
    (["--mesh", "auto"], "mesh error: --mesh expects exactly two factors")])
def test_cli_shard_flags_it_refuses(flags, message, capsys):
    """What the register path refuses, as ``qbot_tpu`` does (``--mesh
    auto`` is the device ensemble's: tests/
    test_torch_sharded_ensemble_cli.py runs ``--shard 1 --ensemble``)."""
    assert torch_cli(["examples/grover.qb", "--compile", "--shard", "1",
                      "--device", "cpu", *flags]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and message in err[0]
