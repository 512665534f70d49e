"""Published peaks of the card the benchmark counts against: NVIDIA's H100
SXM data sheet (dense, without sparsity, at the 700 W limit), copied from
the port's ``utils/profiling.py::H100_SXM`` so that a change to the
program cannot move them."""

from __future__ import annotations

from typing import Dict

H100_SXM = {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12}


def peaks_of(device_name: str) -> Dict[str, float]:
    """The H100 SXM's row for an H100 SXM (its name holds "H100" and
    "HBM3"); any other card raises, since no other row is known."""
    if "H100" in device_name and "HBM3" in device_name:
        return dict(H100_SXM)
    raise ValueError(f"no published peaks known for {device_name!r}")
