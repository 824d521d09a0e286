"""Sandboxed expression evaluation and the builtin namespace.

Capability parity with the reference's ``qbot/evaluation.py``
(qbot/evaluation.py:13-586): operand expressions are Python
expressions evaluated with empty ``__builtins__`` against a prepopulated
namespace of gates, bases, tensor helpers, and the ``math_*`` / ``np_*`` /
``linalg_*`` wrapper families — every callable lifted for ProbVal
compatibility.

Differences from the reference:

* The ~550 wrapper entries are *generated* from the live module surfaces
  instead of hand-written, so the set tracks the installed NumPy (the
  reference pinned names from an older NumPy; entries that no longer exist
  there cannot be exposed) and kwargs lifting actually works
  (reference defect, SURVEY.md §2.3.2).
* As in the reference, the sandbox is a convenience, not a security
  boundary (evaluation.py:573-580).
"""
from __future__ import annotations

import math

import numpy as np

import qbot_tpu_torch.errors as err
from qbot_tpu_torch.basis import ALL_BASES
from qbot_tpu_torch.ops import core, gates
from qbot_tpu_torch.ops.measurement import tensor_permute
from qbot_tpu_torch.probval import ProbVal, lift

__all__ = ["global_namespace", "evaluate", "evaluate_expr"]


def _lifted(func):
    return lambda *args, **kwargs: lift(func, *args, **kwargs)


def _build_namespace() -> dict:
    ns: dict = {
        "__builtins__": {},
        "ProbVal": ProbVal.from_unzipped,
        "ProbValZipped": ProbVal.from_zipped,

        # constant gates
        "identityGate": np.eye(2),
        "hadamardGate": gates.hadamard(),
        "pauliXGate": gates.pauli_x(),
        "pauliYGate": gates.pauli_y(),
        "pauliZGate": gates.pauli_z(),

        # gate constructors
        "xRotGate": _lifted(gates.rot_x),
        "yRotGate": _lifted(gates.rot_y),
        "zRotGate": _lifted(gates.rot_z),
        "phaseGate": _lifted(gates.phase),
        "qftGate": gates.qft,
        "simonsGate": _lifted(gates.simons_oracle),
        "swapGate": _lifted(gates.swap_qubits),
        "shiftGate": _lifted(
            lambda numQubits, up=True, numShifts=1:
            gates.shift_gate(numQubits, up, numShifts)),

        # ProbVal-friendly collections
        "plist": lambda *args: lift(lambda *a: list(a), *args),
        "ptuple": lambda *args: lift(lambda *a: tuple(a), *args),
        "pset": lambda *args: lift(lambda *a: set(a), *args),

        # tensor helpers
        "tensorProd": _lifted(core.tensor_product),
        "tensorExp": _lifted(core.tensor_power),
        "tensorPermute": _lifted(tensor_permute),
        "ketToDensity": _lifted(core.ket_to_density),
        "ketsToDensity": _lifted(core.kets_to_density_zipped),
        "densityToKets": core.density_to_ensemble,

        # math constants
        "math_pi": math.pi,
        "math_e": math.e,
        "math_tau": math.tau,
        "math_inf": math.inf,
        "math_nan": math.nan,
    }

    for name in dir(math):
        if name.startswith("_"):
            continue
        obj = getattr(math, name)
        if callable(obj):
            ns[f"math_{name}"] = _lifted(obj)

    _SKIP_NP = {"math", "char", "ctypeslib", "dtypes", "emath", "errstate",
                "exceptions", "f2py", "fft", "lib", "linalg", "ma", "polynomial",
                "random", "rec", "strings", "testing", "typing", "test",
                "show_config", "show_runtime", "info", "load", "loads", "save",
                "savez", "savez_compressed", "savetxt", "loadtxt", "genfromtxt",
                "fromfile", "tofile", "memmap", "lookfor", "source", "get_include",
                "set_printoptions", "get_printoptions", "printoptions",
                "DataSource", "open_memmap"}
    for name in dir(np):
        if name.startswith("_") or name in _SKIP_NP:
            continue
        obj = getattr(np, name)
        if isinstance(obj, type):
            # expose scalar/dtype classes directly so `dtype=np_complex128`
            # works (the reference wrapped these in lifting lambdas, which
            # made them unusable as dtype arguments)
            ns[f"np_{name}"] = obj
        elif callable(obj):
            ns[f"np_{name}"] = _lifted(obj)

    for name in dir(np.linalg):
        if name.startswith("_") or name in ("linalg", "test"):
            continue
        obj = getattr(np.linalg, name)
        if callable(obj):
            ns[f"linalg_{name}"] = _lifted(obj)

    for basis in ALL_BASES:
        for name in basis.names:
            ns[name] = basis

    return ns


global_namespace = _build_namespace()


def evaluate(expression: str, local_namespace: dict):
    code = compile(expression, "<string>", "eval")
    return eval(code, global_namespace, local_namespace)


def evaluate_expr(lines, line_num, expression: str, local_namespace: dict):
    """Evaluate an operand expression, wrapping failures in a script error."""
    try:
        return evaluate(expression, local_namespace)
    except err.QbotScriptError:
        raise
    except Exception as e:
        raise err.python_error(lines, line_num, e) from e
