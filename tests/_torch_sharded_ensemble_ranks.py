"""The ranks of ``tests/test_torch_sharded_ensemble.py``.

Every rank of a gloo mesh on the CPU runs every case of its mesh shape;
rank 0 writes each case's results to one npz file.  The ranks start with
the spawn method and import this module, which imports neither ``jax`` nor
``qbot_tpu``; the test runs the same programs through ``qbot_tpu`` on its
emulated mesh.
"""
import contextlib
import io
import warnings
from pathlib import Path

import numpy as np
import torch

import qbot_tpu_torch.tpu.sharded_ensemble as se
from qbot_tpu_torch.frontend.device_ensemble import executeTxtDeviceEnsemble
from qbot_tpu_torch.frontend.lowering import (
    lower_program,
    run_lowered_ensemble,
    run_lowered_sharded_ensemble,
)
from qbot_tpu_torch.probval import ProbVal
from qbot_tpu_torch.tpu.planar import to_planar
from qbot_tpu_torch.utils import profiling

# the mesh shapes of the module (P, Q): one gloo group each
SHAPES = ((1, 2), (2, 1), (2, 2), (2, 4))
# the collective timeout of the test groups: a deadlock fails the test
COLLECTIVE_TIMEOUT = 120.0
# the sampled runs' population: > 3 sigma of a Bernoulli(0.5) mean within
# SAMPLED_TOL (tests/test_sharded_ensemble.py:527-528)
SAMPLED_B = 1024
SAMPLED_TOL = 0.06

SRC_MID = ("qset tensorExp(comp[0], 5)\n"
           "gate hadamardGate ; 0\n"
           "gate pauliXGate ; 3 ; [0]\n"
           "gate hadamardGate ; 1\n"
           "meas a ; computation ; [0]\n"
           "gate pauliXGate ; 4 ; [3]\n"
           "meas b ; computation ; [3, 4]")
SRC_QSET = ("qset tensorExp(comp[0], 5)\n"
            "gate hadamardGate ; 0\n"
            "gate pauliXGate ; 3 ; [0]\n"
            "qset hadamard.kets[0] ; [3]\n"
            "gate pauliXGate ; 1 ; [3]\n"
            "meas m ; computation")
SRC_RESUME = ("qset tensorExp(comp[0], 5)\n"
              "gate hadamardGate ; 0\n"
              "gate pauliXGate ; 3 ; [0]\n"
              "meas a ; computation ; [0]\n"
              "gate hadamardGate ; 2\n"
              "meas b ; computation ; [2]\n"
              "disc [2]\n"
              "meas c ; computation ; [0, 3]")
SRC_HAND = ("qset tensorExp(comp[0], 4)\n"
            "gate hadamardGate ; 0\n"
            "meas a ; computation ; [0]\n"
            "disc [1]\n"
            "meas b ; computation")
DEEP = ("qset ProbVal([0.85, 0.09, 0.03, 0.03],"
        " [tensorProd(comp[0], comp[0], comp[0]),"
        "  tensorProd(comp[0], comp[0], comp[1]),"
        "  tensorProd(comp[0], comp[1], comp[0]),"
        "  tensorProd(comp[1], comp[0], comp[0])])\n"
        + "".join(f"gate hadamardGate ; {q % 3}\n"
                  f"meas m{i} ; computation ; [{q % 3}]\n"
                  for i, q in enumerate(range(8))))

# {name: (source, keyword arguments)} of run_lowered_sharded_ensemble,
# and the shapes each runs on (tests/test_sharded_ensemble.py:22-198, 363,
# 420-470, 515-596)
RUNS = {
    "mid": (SRC_MID, {}),
    "disc": ("qset tensorExp(comp[0], 5)\n"
             "gate hadamardGate ; 0\n"
             "gate pauliXGate ; 2 ; [0]\n"
             "disc [0, 3]\n"
             "meas m ; computation", {}),
    "disc_dense": ("qset tensorExp(comp[0], 4)\n"
                   "gate hadamardGate ; 0\n"
                   "gate pauliXGate ; 3 ; [0]\n"
                   "disc [1, 3]\n"
                   "meas m ; computation", {}),
    "bell": ("qset tensorExp(comp[0], 4)\n"
             "gate hadamardGate ; 0\n"
             "gate pauliXGate ; 1 ; [0]\n"
             "meas b ; bell ; [0, 1]\n"
             "gate hadamardGate ; 2", {}),
    "peek": ("qset tensorExp(comp[0], 4)\n"
             "gate hadamardGate ; 0\n"
             "gate pauliXGate ; 1 ; [0]\n"
             "peek p ; computation ; [0]\n"
             "meas m ; computation ; [0, 1]", {}),
    "mixed": ("qset ProbVal([0.25, 0.75], [comp[0], comp[1]])\n"
              "gate hadamardGate ; 0\n"
              "meas m ; computation", {}),
    "lost_mass": ("qset tensorExp(comp[0], 4)\n"
                  + "".join(f"gate hadamardGate ; {q}\n" for q in range(4))
                  + "meas a ; computation ; [0]\n"
                  "meas b ; computation ; [1]\n"
                  "meas c ; computation ; [2]", {"max_particles": 3}),
    "qset": (SRC_QSET, {}),
    "qset_probval": ("qset tensorExp(comp[0], 4)\n"
                     "gate hadamardGate ; 0\n"
                     "qset comp[1] ; ProbVal([0.25, 0.75], [[1], [3]])\n"
                     "meas m ; computation", {}),
    "hand": (SRC_HAND, {"max_particles": 64}),
    "projective": (SRC_RESUME, {"collapse_mode": "projective"}),
}
RUN_SHAPES = {
    "mid": SHAPES, "disc": SHAPES, "qset": ((1, 2), (2, 2), (2, 4)),
    "disc_dense": ((2, 2),), "bell": ((2, 2), (2, 4)), "peek": ((2, 2),),
    "mixed": ((2, 1),), "lost_mass": ((1, 2),), "qset_probval": ((2, 2),),
    "hand": ((2, 2),), "projective": ((2, 2), (2, 4)),
}
# the sampled programs held within SAMPLED_TOL of their exact run
# (tests/test_sharded_ensemble.py:530-596)
SAMPLED = {
    "qset": ("qset tensorExp(comp[0], 4)\n"
             "gate hadamardGate ; 0\n"
             "gate pauliXGate ; 2 ; [0]\n"
             "qset hadamard.kets[0] ; [2]\n"
             "gate hadamardGate ; 2\n"
             "meas m ; computation ; [2]\n"
             "meas w ; computation ; [0, 1]"),
    "qset_mixed": ("qset tensorExp(comp[0], 4)\n"
                   "gate hadamardGate ; 0\n"
                   "qset ProbVal([0.25, 0.75], [comp[0], comp[1]]) ; [1]\n"
                   "meas m ; computation ; [1]\n"),
    "qset_targets": ("qset tensorExp(comp[0], 4)\n"
                     "gate hadamardGate ; 0\n"
                     "qset comp[1] ; ProbVal([0.25, 0.75], [[1], [3]])\n"
                     "meas m ; computation"),
    "disc_targets": ("qset tensorExp(comp[0], 4)\n"
                     "gate hadamardGate ; 0\n"
                     "gate pauliXGate ; 3 ; [0]\n"
                     "disc ProbVal([0.5, 0.5], [[0], [3]])\n"
                     "meas m ; computation"),
    "deep": DEEP,
}
# the device ensemble's mesh cases (tests/test_device_ensemble.py:226-290)
DEVICE = {
    "branching": ("qset tensorExp(comp[0], 4)\n"
                  "gate hadamardGate ; 0\n"
                  "gate pauliXGate ; 3 ; [0]\n"
                  "cjmp alt ; ProbVal([0.5, 0.5], [True, False])\n"
                  "meas m ; computation ; [0]\n"
                  "gate hadamardGate ; 1\n"
                  "halt\n"
                  "mark alt\n"
                  "meas m ; computation ; [3]\n"
                  "disc 0", {}),
    "gate_fanout": ("qset tensorExp(comp[0], 4)\n"
                    "gate ProbVal([0.5, 0.5], [pauliXGate, hadamardGate]) "
                    "; 0\n"
                    "meas m ; computation ; [0]", {}),
    "bell": ("qset tensorExp(comp[0], 4)\n"
             "gate hadamardGate ; 0\n"
             "gate pauliXGate ; 1 ; [0]\n"
             "meas b ; bell ; [0, 1]", {}),
    "smc": ("qset tensorExp(comp[0], 4)\n"
            "gate hadamardGate ; 0\n"
            "gate pauliXGate ; 1 ; [0]\n"
            "meas m ; computation ; [0]", {"sample": 32, "seed": 3}),
    "targeted_qset": (SRC_QSET, {}),
}
DEVICE_SHAPES = {"branching": SHAPES, "gate_fanout": ((2, 2),),
                 "bell": ((2, 2),), "smc": ((2, 2),),
                 "targeted_qset": ((2, 2), (2, 4))}


def _probs(results) -> dict:
    return {f"probs_{k}": np.asarray(v.probs) for k, v in results.items()}


def _lowered(src):
    with contextlib.redirect_stdout(io.StringIO()):
        return lower_program(src, mid_measure=True)


def _run(emesh, src, **kw):
    """(results, ensemble, perm, stats) of the mesh runner on ``src``."""
    stats = {}
    # the program's spans on: they fill stats["phase_walls"]
    with warnings.catch_warnings(), profiling.tracing():
        warnings.simplefilter("ignore", RuntimeWarning)
        res, ens, perm, _ = run_lowered_sharded_ensemble(
            _lowered(src), mesh=emesh, stats=stats, **kw)
    return res, ens, perm, stats


def _record(emesh, src, **kw) -> dict:
    res, ens, perm, stats = _run(emesh, src, **kw)
    return {**_probs(res),
            "mixture": se.sharded_ensemble_mixture(ens, emesh, perm),
            "lost_mass": float(ens.lost_mass),
            "width": ens.psi.shape[-1], "perm_len": len(perm),
            "particles": ens.num_particles,
            "num_collectives": stats["num_collectives"],
            "collapse_events": stats["collapse_events"],
            "num_reshards": stats["num_reshards"],
            "comm_bytes": stats["comm_bytes"],
            "hbm_bytes": stats["hbm_bytes"],
            "phases": sorted(stats["phase_walls"])}


def _fanout_counts(emesh) -> dict:
    """Collectives of measure_fanout_sharded on the hand-counted batch of
    tests/test_sharded_ensemble.py:275-298: without and with a prune."""
    psi = to_planar(np.ones(2**4, complex) / 4.0)
    ens = se.init_sharded_ensemble(np.stack([psi, psi]), emesh)
    out = {}
    for label, targets, cap in (("no_prune", [0], 64),
                                ("prune", [0, 1], 4)):
        stats = {}
        se.measure_fanout_sharded(ens, 4, targets, emesh, max_particles=cap,
                                  mode="projective", stats=stats)
        out[f"count_{label}"] = stats["num_collectives"]
    return out


def _resume(emesh, ckpt: Path) -> dict:
    """A run whose third fan-out raises (a lost host), then a re-run
    from its snapshots, beside an uninterrupted run."""
    want = _record(emesh, SRC_RESUME)
    real = se.measure_fanout_sharded
    calls = {"n": 0}

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("injected host loss")
        return real(*a, **kw)

    se.measure_fanout_sharded = dying
    try:
        _run(emesh, SRC_RESUME, checkpoint_dir=str(ckpt))
        raise AssertionError("the injected loss did not stop the run")
    except RuntimeError as e:
        if "injected host loss" not in str(e):
            raise
    finally:
        se.measure_fanout_sharded = real
    got = _record(emesh, SRC_RESUME, checkpoint_dir=str(ckpt))
    roll = _record(emesh, SRC_RESUME, checkpoint_dir=str(ckpt.parent
                                                          / "roll"))
    from qbot_tpu_torch.utils.checkpoint import CheckpointManager

    return {**{f"want_{k}": v for k, v in want.items()},
            **{f"got_{k}": v for k, v in got.items()},
            "roll_steps": np.array(CheckpointManager(
                str(ckpt.parent / "roll")).all_steps()),
            "roll_probs_c": roll["probs_c"]}


def _device(emesh, src, **kw) -> dict:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ns = executeTxtDeviceEnsemble(src, mesh=emesh, **kw)
    out = {f"probs_{k}": np.asarray(v.probs) for k, v in ns.items()
           if not k.startswith("__") and hasattr(v, "probs")
           and not isinstance(v, ProbVal)}
    out["state_is_probval"] = isinstance(ns["state"], ProbVal)
    if not isinstance(ns["state"], ProbVal):
        out["state"] = np.asarray(ns["state"], complex)
    return out


def _sampled_p1(emesh) -> dict:
    """A P = 1 mesh against the single-device run_lowered_ensemble, both
    sampled from one seed."""
    out = {}
    for name in ("qset_mixed", "disc_targets", "deep"):
        res, _, _, _ = _run(emesh, SAMPLED[name], sample=64, seed=5)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            single, _ = run_lowered_ensemble(_lowered(SAMPLED[name]),
                                             sample=64, seed=5, device="cpu")
        out.update({f"{name}_mesh_{k}": v for k, v in _probs(res).items()})
        out.update({f"{name}_single_{k}": v
                    for k, v in _probs(single).items()})
    return out


def _sampled(emesh) -> dict:
    """Every SAMPLED program, sampled (SAMPLED_B particles) and exact."""
    out = {}
    for name, src in SAMPLED.items():
        if name == "deep":
            continue
        res, ens, _, _ = _run(emesh, src, sample=SAMPLED_B, seed=3)
        out.update({f"{name}_sampled_{k}": v
                    for k, v in _probs(res).items()})
        out[f"{name}_particles"] = ens.num_particles
        res, _, _, _ = _run(emesh, src)
        out.update({f"{name}_exact_{k}": v for k, v in _probs(res).items()})
    # the island exchange: a skewed mixture degenerates the island
    # weights; with a threshold above 1/P the exchange must fire
    res, ens, _, stats = _run(emesh, DEEP, sample=32, seed=3,
                              island_ess_threshold=0.99)
    L = se.island_log_weights(ens, emesh).numpy()
    out.update({f"deep_{k}": v for k, v in _probs(res).items()})
    out["deep_exchanges"] = stats.get("island_exchanges", 0)
    out["deep_island_log_weights"] = L
    return out


def smc_program_run(emesh, src: str, sample: int) -> dict:
    """The mesh runner on ``src`` with ``sample`` particles (0: exact)
    on every rank: rank 0's outcome distributions, each rank's kernel
    launches (a card's ranks: ``tests/test_torch_cuda.py``)."""
    from qbot_tpu_torch.tpu import kernels

    kernels.reset_launch_counts()
    res, _, _, _ = _run(emesh, src, sample=sample, seed=0)
    return {**_probs(res), "launches": kernels.launch_counts()}


def device_namespace(emesh, src: str, **kw) -> dict:
    """:func:`_device` on every rank; rank 0's result is kept."""
    return _device(emesh, src, **kw)


def run_rank(emesh, out_dir: str) -> None:
    """Every case of this mesh shape; rank 0 writes ``<case>.npz``."""
    shape = (emesh.P, emesh.K)
    out = Path(out_dir)

    def save(name, arrays):
        if emesh.rank == 0:
            np.savez(out / f"{name}.npz", **arrays)

    for name, (src, kw) in RUNS.items():
        if shape in RUN_SHAPES[name]:
            save(f"run_{name}", _record(emesh, src, **kw))
    for name, (src, kw) in DEVICE.items():
        if shape in DEVICE_SHAPES[name]:
            save(f"device_{name}", _device(emesh, src, **kw))
    if shape == (2, 2):
        save("fanout_counts", _fanout_counts(emesh))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _run(emesh, "qset tensorExp(comp[0], 4)\n"
                        "gate hadamardGate ; 0\n"
                        "meas m ; computation ; [0]\n"
                        "cout m.probs[0]")
        save("epilogue", {"stdout": np.array(buf.getvalue())})
        save("resume", _resume(emesh, out / "ckpt" / "snap"))
        save("sampled", _sampled(emesh))
    if shape == (1, 2):
        save("sampled_p1", _sampled_p1(emesh))
    torch.distributed.barrier()
