"""Numeric health guards on states and engine outputs.

Port of :mod:`qbot_tpu.utils.guards`: NaN/Inf checks on engine outputs and
norm-drift audits on unitary evolution, with the same messages.  They take
tensors on either device (or numpy arrays) and test them where they lie;
each check reads one number back to the host, so it synchronises once.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["assert_finite", "check_norm", "checked", "NumericError",
           "CheckError"]


class NumericError(RuntimeError):
    """A state tensor failed a numeric-health check."""


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def assert_finite(x, name: str = "array"):
    """Raise :class:`NumericError` if ``x`` holds a NaN or an Inf; return
    ``x``."""
    bad = int(torch.count_nonzero(~torch.isfinite(_tensor(x))))
    if bad:
        raise NumericError(f"{name}: {bad} non-finite elements")
    return x


def check_norm(state, atol: float = 1e-3, name: str = "state"):
    """Norm-drift audit of a pure state: a planar ``(2, 2^n)`` real tensor
    or a complex vector, summed in float64; raise :class:`NumericError`
    when the norm is more than ``atol`` from 1, else return ``state``."""
    t = _tensor(state)
    if not t.is_complex() and t.dim() == 2 and t.shape[0] == 2:  # planar
        norm = float(torch.sum(torch.square(t.double())))
    else:
        norm = float(torch.sum(torch.square(torch.abs(t.cdouble()))))
    if abs(norm - 1.0) > atol:
        raise NumericError(f"{name}: norm drifted to {norm:.6f}")
    return state


class CheckError:
    """The outcome of a :func:`checked` call: :meth:`get` is the failure's
    message or None, :meth:`throw` raises it."""

    def __init__(self, message: Optional[str] = None):
        self.message = message

    def get(self) -> Optional[str]:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise NumericError(self.message)


def _leaves(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _leaves(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _leaves(v)


def checked(fn):
    """Wrap a state transformation with a finiteness check of its output.

    Calling the returned function gives ``(error, value)`` and
    ``error.throw()`` raises, as ``qbot_tpu``'s checkify wrapper does.
    Every floating or complex tensor in the output (nested in tuples,
    lists and dicts) is tested on its own device, real and imaginary parts
    alike, and the verdicts come back to the host in one read.
    """
    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        oks = [torch.all(torch.isfinite(leaf)) for leaf in _leaves(out)
               if leaf.is_floating_point() or leaf.is_complex()]
        if oks and not bool(torch.stack(
                [ok.to(oks[0].device) for ok in oks]).all()):
            return CheckError("non-finite value in engine output"), out
        return CheckError(), out
    return run
