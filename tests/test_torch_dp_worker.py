"""Rank worker of ``tests/test_torch_dp.py``.  Spawned ranks import this
module by name, so it imports nothing of JAX or het_tpu (the test below
holds it to that)."""

import os

import torch

from het_tpu_torch.parallel import masked_nll, sum_grads
from het_tpu_torch.parallel.launch import job_inputs, run_job


def record_job(rank, dev, job):
    """The job's training run (``run_job``), plus this rank's logits,
    the loss and the gradients summed over the ranks at the initial
    parameters."""
    dp, shard, x_loc, labels = job_inputs(rank, dev, job)
    logits = dp(shard, x_loc)
    local, value = masked_nll(logits, labels)
    local.backward()
    sum_grads(dp)
    out = run_job(rank, dev, job)
    out.update(logits=logits.detach().cpu(), loss=value.item(),
               grads={name: p.grad.cpu() for name, p in dp.named_parameters()})
    return out


def test_worker_imports_no_jax():
    from tests.test_torch_rules import FORBIDDEN, _imports

    mods = list(_imports(os.path.abspath(__file__)))
    assert "het_tpu_torch.parallel" in mods
    for mod in mods:
        assert mod.split(".")[0] not in FORBIDDEN, mod
