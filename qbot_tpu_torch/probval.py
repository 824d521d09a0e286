"""ProbVal: first-class classical superposition values.

Capability parity with the reference's ``qbot/probVal.py`` (see
qbot/probVal.py:18-390).  A ProbVal stores parallel
probability / value branch lists and gives

* cartesian-product semantics to arithmetic operators,
* probability-of-truth semantics to comparisons and logical operators,
* automatic normalisation (drop branches with p < 1e-5, collapse
  near-duplicate values, renormalise, round to 15 decimal places), and
* automatic flattening of nested ProbVals at construction.

This host-side representation is the *conformance* surface — branch counts
are tiny and data-dependent, so it stays in Python.  The scalable device-side
twin is the JAX package's SMC particle ensemble, where the
branch axis becomes a vmapped/sharded array dimension.

Reference defects deliberately fixed here (SURVEY.md §2.3):

* kwargs lifting works (`probVal.py:358` iterated dict keys as pairs);
* ProbVal⊗ProbVal non-commutative binary ops use the natural operand order
  (`probVal.py:193-195` computed ``other op self`` for the un-reversed case);
* ``to_density_matrix`` conjugates kets (`probVal.py:107` did not).
"""
from __future__ import annotations

import math
import operator
from typing import Callable, List, Sequence

import numpy as np

SMALL_PROB = 1e-5
PROB_DECIMALS = 15

__all__ = ["ProbVal", "SMALL_PROB", "PROB_DECIMALS", "values_close", "lift"]


def values_close(a, b) -> bool:
    """Branch-merging equality: floats within 1e-5, arrays exact, else ==."""
    if isinstance(a, float):
        return abs(a - b) < SMALL_PROB
    if hasattr(a, "ndim") or hasattr(b, "ndim"):  # numpy or jax arrays
        if getattr(a, "shape", None) != getattr(b, "shape", None):
            return False
        return bool(np.asarray(a == b).all())
    return a == b


class ProbVal:
    """A weighted list of possible values behaving like a single value."""

    __slots__ = ("probs", "values")

    probs: List[float]
    values: list

    def __init__(self, probs: Sequence[float], values: Sequence):
        if len(probs) != len(values):
            raise ValueError("len of probs and values must be the same")
        flat_probs: list[float] = []
        flat_values: list = []
        for p, v in zip(probs, values):
            if isinstance(v, ProbVal):
                flat_probs.extend(p * sp for sp in v.probs)
                flat_values.extend(v.values)
            else:
                flat_probs.append(p)
                flat_values.append(v)
        self.probs = flat_probs
        self.values = flat_values
        self._normalize()

    def _normalize(self) -> None:
        """Prune tiny branches, drop duplicate values, renormalise, round.

        Scan order matters and matches the reference (probVal.py:22-51): a
        duplicate's probability mass is *discarded* before renormalisation,
        not merged into the kept branch.
        """
        probs, values = self.probs, self.values
        i = 0
        while i < len(probs):
            if probs[i] < SMALL_PROB:
                del probs[i], values[i]
                continue
            j = i + 1
            while j < len(probs):
                if values_close(values[i], values[j]):
                    del probs[j], values[j]
                    continue
                j += 1
            i += 1
        total = sum(probs)
        for i in range(len(probs)):
            probs[i] = round(probs[i] / total, PROB_DECIMALS)

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_unzipped(probs: Sequence[float], values: Sequence):
        """Build a ProbVal, collapsing certain outcomes back to plain values."""
        if len(values) == 1:
            return values[0]
        pv = ProbVal(probs, values)
        if len(pv.probs) == 1:
            return pv.values[0]
        return pv

    @staticmethod
    def raw(probs: Sequence[float], values: Sequence) -> "ProbVal":
        """Build a ProbVal verbatim: no flattening, pruning or renormalise.

        For internal callers that already hold a normalised distribution and
        need a *copy* with transformed values (e.g. operand coercion) without
        mutating the user's object or re-running branch merging.
        """
        pv = object.__new__(ProbVal)
        pv.probs = list(probs)
        pv.values = list(values)
        return pv

    @staticmethod
    def from_zipped(pairs: Sequence[tuple]):
        if len(pairs) == 1:
            return pairs[0][1]
        return ProbVal.from_unzipped([p for p, _ in pairs], [v for _, v in pairs])

    # camelCase aliases for reference API compatibility
    fromUnzipped = from_unzipped
    fromZipped = from_zipped

    # -- introspection -----------------------------------------------------

    def instance(self):
        """First value if all branches share a type, else None (duck typing)."""
        if not self.values:
            return None
        first = self.values[0]
        t = type(first)
        if all(isinstance(v, t) for v in self.values[1:]):
            return first
        return None

    def type_string(self) -> str:
        inst = self.instance()
        return "ProbVal<mixed>" if inst is None else f"ProbVal<{type(inst).__name__}>"

    typeString = type_string

    def is_equivalent(self, other) -> bool:
        """Distribution equality (unlike ==, which returns a ProbVal of bools)."""
        if not isinstance(other, ProbVal) or len(self.probs) != len(other.probs):
            return False
        for p, v in zip(self.probs, self.values):
            try:
                idx = other.values.index(v)
            except ValueError:
                return False
            if abs(p - other.probs[idx]) >= SMALL_PROB:
                return False
        return True

    isEquivalent = is_equivalent

    def map(self, func: Callable):
        return ProbVal.from_unzipped(self.probs, [func(v) for v in self.values])

    def to_density_matrix(self) -> np.ndarray:
        """Fold ProbVal<ndarray> branches into one mixed density matrix."""
        from qbot_tpu_torch.backend import is_array
        if not is_array(self.instance()):
            raise TypeError("to_density_matrix requires all values to be arrays")
        total = np.zeros(
            self.values[0].shape if self.values[0].ndim == 2
            else (self.values[0].shape[0],) * 2,
            dtype=complex,
        )
        for p, v in zip(self.probs, self.values):
            if v.ndim == 1:
                v = np.outer(v, np.conj(v))
            total = total + p * np.asarray(v)
        return total

    toDensityMatrix = to_density_matrix
    toDensity = to_density_matrix

    def __str__(self) -> str:
        return f"ProbVal({self.probs}, {self.values})"

    __repr__ = __str__

    # -- operator semantics ------------------------------------------------

    def _elementwise(self, op: Callable, *extra):
        return ProbVal.from_unzipped(
            list(self.probs), [op(v, *extra) for v in self.values]
        )

    def _truth_prob(self, other, op: Callable):
        """Probability-of-truth semantics for comparisons / logical ops."""
        p_true = 0.0
        p_false = 0.0
        if isinstance(other, ProbVal):
            for p1, v1 in zip(self.probs, self.values):
                for p2, v2 in zip(other.probs, other.values):
                    if op(v1, v2):
                        p_true += p1 * p2
                    else:
                        p_false += p1 * p2
        else:
            for p, v in zip(self.probs, self.values):
                if op(v, other):
                    p_true += p
                else:
                    p_false += p
        return ProbVal.from_unzipped([p_true, p_false], [True, False])

    def _pairwise(self, other, op: Callable, flipped: bool):
        """Cartesian-product semantics for binary arithmetic."""
        probs: list[float] = []
        vals: list = []
        if isinstance(other, ProbVal):
            for p1, v1 in zip(self.probs, self.values):
                for p2, v2 in zip(other.probs, other.values):
                    probs.append(p1 * p2)
                    vals.append(op(v2, v1) if flipped else op(v1, v2))
        else:
            for p, v in zip(self.probs, self.values):
                probs.append(p)
                vals.append(op(other, v) if flipped else op(v, other))
        return ProbVal.from_unzipped(probs, vals)


def _install_operators():
    """Generate the ~40 dunder methods from op tables."""
    comparisons = {
        "__eq__": operator.eq, "__ne__": operator.ne,
        "__gt__": operator.gt, "__lt__": operator.lt,
        "__ge__": operator.ge, "__le__": operator.le,
        "__and__": operator.and_, "__or__": operator.or_,
        "__xor__": operator.xor,
    }
    for name, op in comparisons.items():
        def meth(self, other, _op=op):
            return self._truth_prob(other, _op)
        meth.__name__ = name
        setattr(ProbVal, name, meth)
    for name in ("__rand__", "__ror__", "__rxor__"):
        fwd = "__" + name[3:]
        def rmeth(self, other, _fwd=fwd):
            return getattr(self, _fwd)(other)
        rmeth.__name__ = name
        setattr(ProbVal, name, rmeth)

    unary = {
        "__neg__": operator.neg, "__pos__": operator.pos,
        "__abs__": operator.abs, "__invert__": operator.inv,
        "__trunc__": math.trunc, "__floor__": math.floor,
        "__ceil__": math.ceil, "__not__": operator.not_,
    }
    for name, op in unary.items():
        def meth(self, _op=op):
            return self._elementwise(_op)
        meth.__name__ = name
        setattr(ProbVal, name, meth)

    def __round__(self, ndigits=None):
        return self._elementwise(round, ndigits)
    setattr(ProbVal, "__round__", __round__)

    binary = {
        "add": operator.add, "sub": operator.sub, "mul": operator.mul,
        "truediv": operator.truediv, "floordiv": operator.floordiv,
        "mod": operator.mod, "lshift": operator.lshift,
        "rshift": operator.rshift, "matmul": operator.matmul,
        "pow": operator.pow,
    }
    for stem, op in binary.items():
        def fwd(self, other, _op=op):
            return self._pairwise(other, _op, flipped=False)
        def rev(self, other, _op=op):
            return self._pairwise(other, _op, flipped=True)
        fwd.__name__ = f"__{stem}__"
        rev.__name__ = f"__r{stem}__"
        setattr(ProbVal, f"__{stem}__", fwd)
        setattr(ProbVal, f"__r{stem}__", rev)

    # defining __eq__ disables hashing, matching the reference
    ProbVal.__hash__ = None


_install_operators()


def lift(func: Callable, *args, **kwargs):
    """Lift any function to ProbVal-in / ProbVal-out.

    Enumerates the cartesian product of branch values of every ProbVal
    positional and keyword argument (mixed-radix decode, positional args
    first — same enumeration order as the reference ``funcWrapper``,
    probVal.py:347-390, so resulting branch order is bit-compatible), calls
    ``func`` on each concrete combination and re-wraps the weighted results.
    """
    n_combos = 1
    for a in args:
        if isinstance(a, ProbVal):
            n_combos *= len(a.probs)
    for v in kwargs.values():
        if isinstance(v, ProbVal):
            n_combos *= len(v.probs)

    probs: list[float] = []
    results: list = []
    concrete_args = list(args)
    concrete_kwargs = dict(kwargs)
    for combo in range(n_combos):
        rem = combo
        prob = 1.0
        for i, a in enumerate(args):
            if isinstance(a, ProbVal):
                idx = rem % len(a.probs)
                rem //= len(a.probs)
                prob *= a.probs[idx]
                concrete_args[i] = a.values[idx]
            else:
                concrete_args[i] = a
        for key, v in kwargs.items():
            if isinstance(v, ProbVal):
                idx = rem % len(v.probs)
                rem //= len(v.probs)
                prob *= v.probs[idx]
                concrete_kwargs[key] = v.values[idx]
            else:
                concrete_kwargs[key] = v
        probs.append(prob)
        results.append(func(*concrete_args, **concrete_kwargs))

    return ProbVal.from_unzipped(probs, results)


# reference-compatible alias
funcWrapper = lift
