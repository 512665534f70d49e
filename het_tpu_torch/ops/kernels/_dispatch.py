"""How a kernel wrapper picks its version and calls its library.

Every wrapper picks its version the same way (:func:`takes_plain`): a CPU
tensor takes the plain PyTorch version, a CUDA tensor launches the kernel
or the wrapper raises, and ``impl="plain"`` asks for the plain version on
the card as well, which is how a run compares the two.  The libraries
themselves are built and loaded by ``_build``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build

IMPLS = ("kernel", "plain")


def bind(name: str, symbol: str, argtypes: Sequence, restype=ctypes.c_int):
    """C function ``symbol`` of kernel library ``name``, with its ctypes
    signature set (every pointer and the stream as ``c_void_p``)."""
    fn = getattr(_build.load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return fn


def check_launch(name: str, err: int, what: str) -> None:
    """Raise if a launch in library ``name`` returned a CUDA error."""
    if err:
        text = bind(name, "het_cuda_error_string", [ctypes.c_int],
                    ctypes.c_char_p)(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {text}")


def launches(t: torch.Tensor, impl: str) -> bool:
    """Whether a wrapper given ``t`` launches its kernel: a CUDA tensor
    under ``impl="kernel"``.  An op whose route rests on it (which kernels
    it calls, not which version of one) asks here."""
    return t.device.type == "cuda" and impl == "kernel"


def takes_plain(t: torch.Tensor, impl: str, what: str) -> bool:
    """Whether a wrapper given ``t`` runs its plain version: on a CPU
    tensor, or where ``impl="plain"``.  Raises for an unknown ``impl`` and
    for a device that has no kernel."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if t.device.type == "cpu" or impl == "plain":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no {what} kernel for {t.device}")
    return False
