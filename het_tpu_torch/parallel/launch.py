"""Spawn data-parallel ranks and run training jobs on them.

:func:`spawn_ranks` starts ``world`` processes with
``torch.multiprocessing`` (start method ``spawn``, so a parent that has
already touched CUDA may call it), opens their group through a
``file://`` rendezvous in ``workdir`` and runs a list of jobs in each, in
order, through ``job_fn`` (:func:`run_job` unless told otherwise).
Every rank writes its results to ``workdir``; a failure in any rank raises
in the parent.  Nothing here imports JAX, so a test that does may spawn
these ranks.

A job is a dict:

* ``shards``: the list ``partition_by_dst`` returned (rank ``r`` takes
  ``shards[r]``), ``nodes_per_part``;
* ``x`` and ``labels``: padded global node features (f32) and labels
  (-1 where unlabelled), numpy;
* ``family``: "RGAT" (when absent), "RGCN" or "HGT", the model whose layers
  the rank's ``DPGNN`` stacks; ``model``: that model's keyword
  arguments; or, in their place, ``layers``: ``[(family, keyword
  arguments), ...]``, one layer of ``RGATLayer``, ``RGCNLayer`` or
  ``HGTLayer`` each, in stack order, an ``activation`` named by a string
  (``ACTIVATIONS``) so that spawn can pickle the job; ``state``: the
  stack's state dict (``layers.{i}.*``);
* ``steps``, ``lr``, ``impl`` ("kernel" or "plain");
* ``mesh2`` (optional): ``(n_hosts, chips_per_host)``; every rank builds
  ``make_mesh2`` and trains over the group of its axis pair;
* ``profile`` (optional): rank 0 traces its warm steps and every rank
  times its collectives in them (``utils/profile_step.py::profile_dp``),
  which takes ``profile_step``'s six steps whatever ``steps`` says;
* ``job_fn`` (optional): a module-level function that runs this job in
  place of the spawn's ``job_fn``, so that jobs of several kinds share
  one spawn.

A rank's result from :func:`run_job`: the losses and step times of
``train_dp``, each kernel's launches over the training steps, its peak
device memory, and which of its typed linears' segmentations hold their
offsets only on the device; with ``mesh2``, its ``(host, chip)``
coordinates; with ``profile``, rank 0's split of a warm step.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..models import (HGTLayer, HGTModel, RGATLayer, RGATModel, RGCNLayer,
                      RGCNModel)
from ..ops import kernels
from .dp import DPGNN, Mesh2, make_mesh2, setup_rank, train_dp


def _device_only(shard) -> Dict[str, bool]:
    """Per segmentation a typed linear multiplies over: whether its
    offsets live only on the device (what sends it to the kernels)."""
    segs = {"edge_rel_seg": shard.edge_rel_seg, "ntype_seg": shard.ntype_seg}
    if shard.compact_src is not None:
        segs["compact_src"] = shard.compact_src.seg
        segs["compact_dst"] = shard.compact_dst.seg
    return {k: s.seg_ptrs_static is None for k, s in segs.items()}


MODELS = {"RGAT": RGATModel, "RGCN": RGCNModel, "HGT": HGTModel}
LAYERS = {"RGAT": RGATLayer, "RGCN": RGCNLayer, "HGT": HGTLayer}
ACTIVATIONS = {"relu": torch.relu}


def job_layers(job: Dict) -> List[torch.nn.Module]:
    """The job's layers, with its ``impl``: its ``layers`` list, else its
    model's layers."""
    impl = job["impl"]
    if "layers" not in job:
        return list(MODELS[job.get("family", "RGAT")](**job["model"],
                                                      impl=impl).layers)
    out = []
    for family, kw in job["layers"]:
        kw = dict(kw)
        if "activation" in kw:
            kw["activation"] = ACTIVATIONS[kw["activation"]]
        out.append(LAYERS[family](**kw, impl=impl))
    return out


# this rank's meshes, by (n_hosts, chips_per_host), while its group lives
_meshes: Dict[Tuple[int, int], Mesh2] = {}


def job_mesh(job: Dict) -> Optional[Mesh2]:
    """The job's two-level mesh, or None for the flat world.  The first
    job of a layout builds it (collective: every rank runs the same jobs
    in the same order) and later ones reuse it."""
    if "mesh2" not in job:
        return None
    key = tuple(job["mesh2"])
    if key not in _meshes:
        _meshes[key] = make_mesh2(*key)
    return _meshes[key]


def job_inputs(rank: int, dev: torch.device, job: Dict, group=None
               ) -> Tuple[DPGNN, object, torch.Tensor, torch.Tensor]:
    """This rank's ``DPGNN`` over ``group`` (the world when None) with the
    job's parameters, its shard, local features and labels, on ``dev``."""
    per = job["nodes_per_part"]
    rows = slice(rank * per, (rank + 1) * per)
    shard = job["shards"][rank].to(dev)
    x_loc = torch.as_tensor(job["x"][rows]).to(dev)
    labels = torch.as_tensor(job["labels"][rows]).to(dev)
    dp = DPGNN(job_layers(job), impl=job["impl"], group=group)
    dp.load_state_dict(job["state"])
    return dp.to(dev).train(), shard, x_loc, labels


def run_job(rank: int, dev: torch.device, job: Dict) -> Dict:
    """One training job on this rank (see the module docstring)."""
    mesh = job_mesh(job)
    dp, shard, x_loc, labels = job_inputs(rank, dev, job,
                                          mesh.pair if mesh else None)
    out = {"device_only": _device_only(shard)}
    if mesh is not None:
        out["coords"] = mesh.coords
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    if job.get("profile"):
        from ..utils.profile_step import profile_dp

        out.update(profile_dp(dp, shard, x_loc, labels, lr=job["lr"],
                              trace=rank == 0))
    else:
        out.update(train_dp(dp, shard, x_loc, labels, steps=job["steps"],
                            lr=job["lr"]))
    out["launches"] = kernels.launch_counts()
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                          if dev.type == "cuda" else 0.0)
    return out


def _rank_main(rank: int, world: int, init_method: str, device: str,
               jobs: List[Dict], workdir: str, job_fn: Callable) -> None:
    dev = setup_rank(rank, world, init_method=init_method, device=device)
    if dev.type == "cpu":  # ranks are processes sharing the host's cores
        torch.set_num_threads(1)
    try:
        results = [dict(job.get("job_fn", job_fn)(rank, dev, job),
                        backend=dist.get_backend(), device=str(dev))
                   for job in jobs]
        torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        _meshes.clear()
        dist.destroy_process_group()


def spawn_ranks(world: int, jobs: List[Dict], *, workdir: str,
                device: str = "cuda",
                job_fn: Callable[[int, torch.device, Dict], Dict]
                = run_job) -> List[List[Dict]]:
    """Run ``job_fn(rank, device, job)`` for each of ``jobs`` on ``world``
    spawned ranks, or the job's own ``job["job_fn"]`` where it names one;
    returns ``results[rank][job]``.  Each must be a module-level function
    (spawn pickles it by name).  ``workdir`` must
    exist and be private to this call."""
    init = "file://" + os.path.join(os.path.abspath(workdir), "rendezvous")
    mp.start_processes(_rank_main,
                       args=(world, init, device, jobs, workdir, job_fn),
                       nprocs=world, start_method="spawn", join=True)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]
