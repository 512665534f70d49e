"""Rank worker of ``tests/test_torch_dp.py``.  Spawned ranks import this
module by name, so it imports nothing of JAX or het_tpu (the test below
holds it to that)."""

import os

import torch
import torch.distributed as dist

from het_tpu_torch.parallel import masked_nll, sum_grads, timed_collectives
from het_tpu_torch.parallel.launch import job_inputs, job_mesh, run_job


def record_job(rank, dev, job):
    """The job's training run (``run_job``), plus this rank's logits,
    the loss, the gradients summed over the ranks and the collective
    calls of each kind, at the initial parameters (over the job's mesh
    where it names one, whose groups' ranks it records)."""
    mesh = job_mesh(job)
    dp, shard, x_loc, labels = job_inputs(rank, dev, job,
                                          mesh.pair if mesh else None)
    with timed_collectives() as times:
        times.on = True
        logits = dp(shard, x_loc)
        local, value = masked_nll(logits, labels, group=dp.group)
        local.backward()
        sum_grads(dp, dp.group)
    out = run_job(rank, dev, job)
    out.update(logits=logits.detach().cpu(), loss=value.item(),
               grads={name: p.grad.cpu() for name, p in dp.named_parameters()},
               collective_calls=dict(times.calls))
    if mesh is not None:
        out["mesh_ranks"] = {axis: dist.get_process_group_ranks(
            getattr(mesh, axis)) for axis in ("host", "chip", "pair")}
    return out


def test_worker_imports_no_jax():
    from tests.test_torch_rules import FORBIDDEN, _imports

    mods = list(_imports(os.path.abspath(__file__)))
    assert "het_tpu_torch.parallel" in mods
    for mod in mods:
        assert mod.split(".")[0] not in FORBIDDEN, mod
