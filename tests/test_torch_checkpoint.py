"""Checkpoints, resume, early stopping and the skipped step.

* ``save_checkpoint`` / ``load_checkpoint`` round trip, and
  ``latest_step`` sees only whole ``step_<n>.pt`` files, never a
  temporary one (het_tpu's counts orbax's temporary directories).
* Resume parity, het_tpu's ``tests/test_train.py::test_resume_parity``
  carried over: 8 epochs straight against 4, a checkpoint, and 4 more
  resumed, dropout 0.3, bit for bit on the CPU, in f32 and in bf16 with
  dynamic loss scaling (the checkpoint holds the parameters, Adam, the
  loss scale and the dropout generator).
* An early-stopped run's last checkpoint carries the epoch it reached
  (het_tpu stamps ``num_epochs``).
* ``--patience`` stops at the same epoch as het_tpu's trainer, from the
  same initial parameters, with the same losses (rtol 1e-4 / atol 2e-4,
  the trainer test's tolerance; the losses chosen lie far further apart
  than that where the decision is taken).
* Under dynamic loss scaling a step whose gradients are not all finite
  leaves the parameters, Adam's state and its step count as they were,
  and halves the scale.
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from het_tpu.data import load_dataset as j_load_dataset
from het_tpu.train import TrainConfig as JTrainConfig
from het_tpu.train import train as j_train
from het_tpu_torch.data.loaders import load_dataset
from het_tpu_torch.models import params_from_jax
from het_tpu_torch.train import TrainConfig, train
from het_tpu_torch.train.checkpoint import (latest_step, load_checkpoint,
                                            save_checkpoint)
from het_tpu_torch.train.driver import build_model
from het_tpu_torch.train.loop import train_steps
from het_tpu_torch.utils.misc import EarlyStopping
from tests.test_torch_bf16 import _jax_initial_params

VAL = dict(rtol=1e-4, atol=2e-4)
RESUME = dict(model="RGAT", dataset="mag", dataset_scale=0.002,
              n_infeat=16, hidden=16, num_heads=2, num_layers=1,
              num_classes=4, num_epochs=8, warmup_epochs=1, dropout=0.3,
              lr=5e-2, device="cpu")


def test_checkpoint_round_trip(tmp_path):
    gen = torch.Generator().manual_seed(3)
    state = {"model": {"w": torch.randn(3, 4), "b": torch.randn(
        2, dtype=torch.bfloat16), "idx": torch.arange(5, dtype=torch.int32)},
             "optimizer": {"state": {0: {"step": torch.tensor(4.0)}},
                           "param_groups": [{"lr": 0.01, "betas": (0.9,
                                                                   0.999),
                                             "params": [0]}]},
             "loss_scale": {"scale": torch.tensor(2.0 ** 14),
                            "good_steps": torch.tensor(7,
                                                       dtype=torch.int32)},
             "generator": gen.get_state(), "epoch": 4}
    path = save_checkpoint(str(tmp_path), state, 4)
    assert os.path.basename(path) == "step_4.pt"
    back = load_checkpoint(str(tmp_path))
    assert back["epoch"] == 4
    for k, v in state["model"].items():
        assert back["model"][k].dtype == v.dtype
        assert torch.equal(back["model"][k], v)
    assert back["optimizer"]["param_groups"] == state["optimizer"][
        "param_groups"]
    assert torch.equal(back["loss_scale"]["good_steps"],
                       state["loss_scale"]["good_steps"])
    g2 = torch.Generator()
    g2.set_state(back["generator"])
    assert torch.equal(torch.rand(4, generator=g2), torch.rand(4,
                                                               generator=gen))


def test_latest_step_ignores_temporary_files(tmp_path):
    assert latest_step(str(tmp_path / "none")) is None
    assert latest_step(str(tmp_path)) is None
    for step in (2, 10):
        save_checkpoint(str(tmp_path), {"epoch": step}, step)
    # what an interrupted save or another writer leaves behind
    (tmp_path / ".step_30.abc.tmp").write_bytes(b"partial")
    (tmp_path / "step_20.pt.tmp").write_bytes(b"partial")
    (tmp_path / "step_40.orbax-checkpoint-tmp-1").mkdir()
    (tmp_path / "step_50").mkdir()
    assert latest_step(str(tmp_path)) == 10
    assert load_checkpoint(str(tmp_path))["epoch"] == 10
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "empty"))


@pytest.mark.parametrize("mixed", [
    pytest.param({}, id="f32"),
    pytest.param(dict(dtype="bfloat16", loss_scale="dynamic"), id="bf16"),
])
def test_resume_reproduces_the_uninterrupted_run(tmp_path, mixed):
    base = TrainConfig(**RESUME, **mixed,
                       checkpoint_dir=str(tmp_path / "ckpt"))
    data = load_dataset("mag", scale=0.002, num_classes=4, seed=0)

    def seeded():  # the trainer's own initialisation
        return build_model(base, data,
                           generator=torch.Generator().manual_seed(0))

    net = seeded()
    ref = train(base, data, net=net, log=lambda s: None)
    want = net.state_dict()

    half = dataclasses.replace(base, num_epochs=4, save_every=4)
    train(half, data, log=lambda s: None)
    assert latest_step(base.checkpoint_dir) == 4
    net2 = seeded()
    resumed = train(dataclasses.replace(base, resume=True), data, net=net2,
                    log=lambda s: None)
    assert len(resumed["loss_list"]) == 4
    assert resumed["loss_list"] == ref["loss_list"][4:]
    assert resumed["epochs_done"] == 8
    assert resumed["loss_scale_state"] == ref["loss_scale_state"]
    for k, v in net2.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert resumed["train_acc"] == ref["train_acc"]


def test_early_stopped_checkpoint_carries_the_epoch_reached(tmp_path):
    """lr 0.5 makes the loss rise at once: with --patience 1 the run
    stops after its second epoch, and its last checkpoint is step 2 (the
    epoch reached, not num_epochs)."""
    cfg = TrainConfig(**dict(RESUME, dropout=0.0, lr=0.5, num_epochs=20,
                             warmup_epochs=0),
                      patience=1, save_every=5,
                      checkpoint_dir=str(tmp_path / "ckpt"))
    m = train(cfg, log=lambda s: None)
    n = len(m["loss_list"])
    assert n < cfg.num_epochs and m["epochs_done"] == n
    assert latest_step(cfg.checkpoint_dir) == n
    ck = load_checkpoint(cfg.checkpoint_dir)
    assert ck["epoch"] == n
    assert sorted(os.listdir(cfg.checkpoint_dir)) == [f"step_{n}.pt"]


@pytest.mark.parametrize("patience", [1, 2])
def test_patience_stops_where_het_tpu_does(tmp_path, patience):
    shared = dict(model="RGAT", dataset="mag", dataset_scale=0.002,
                  n_infeat=16, hidden=16, num_heads=2, num_layers=2,
                  num_classes=8, num_epochs=30, warmup_epochs=0,
                  dropout=0.0, lr=0.2, compact=True, multiply_first=True,
                  seed=0, patience=patience)
    jcfg = JTrainConfig(**shared)
    jdata = j_load_dataset(jcfg.dataset, scale=jcfg.dataset_scale,
                           num_classes=jcfg.num_classes, seed=jcfg.seed,
                           build_compact=True)
    tree = _jax_initial_params(jcfg, jdata)
    jm = j_train(jcfg, jdata)
    m = train(TrainConfig(**shared, device="cpu"), state=params_from_jax(
        tree), log=lambda s: None)
    assert 2 <= len(jm["loss_list"]) < shared["num_epochs"]
    assert len(m["loss_list"]) == len(jm["loss_list"])
    np.testing.assert_allclose(m["loss_list"], jm["loss_list"], **VAL)
    # the stop is the stopper's on these losses, with room to spare
    stopper = EarlyStopping(patience=patience)
    losses = jm["loss_list"]
    stops = [stopper.update(v, i) for i, v in enumerate(losses)]
    assert stops.index(True) == len(losses) - 1
    best = min(losses[:-patience])
    assert min(abs(v - best) for v in losses[-patience:]) > 1e-3


def test_nonfinite_step_is_skipped_and_halves_the_scale():
    """Step 2 of 4 has an infinite loss: its gradients are not finite,
    so Adam does not step (parameters, moments and step count as after
    step 1) and the scale halves; steps 3-4 update again."""
    torch.manual_seed(0)
    module = torch.nn.Linear(3, 2)
    x = torch.randn(5, 3)
    calls = []

    def step_loss():
        loss = module(x).square().mean()
        if len(calls) == 1:
            loss = loss * float("inf")
        calls.append(1)
        return loss, loss

    seen = []

    def stop(epoch, loss, snapshot):
        snap = copy.deepcopy(snapshot())  # Adam updates its state in place
        seen.append(({k: v.clone() for k, v in module.state_dict().items()},
                     snap))
        return False

    out = train_steps(module, step_loss, steps=4, lr=0.1,
                      device=torch.device("cpu"), loss_scale="dynamic",
                      stop=stop)
    (p1, s1), (p2, s2), (p3, s3), _ = seen
    for k in p1:
        assert torch.equal(p1[k], p2[k]) and not torch.equal(p2[k], p3[k])
    for i, st in s1["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, s2["optimizer"]["state"][i][k]), k
    assert s1["optimizer"]["state"][0]["step"].item() == 1
    assert s3["optimizer"]["state"][0]["step"].item() == 2
    scales = [s["loss_scale"]["scale"].item() for s in (s1, s2, s3)]
    assert scales == [2.0 ** 15, 2.0 ** 14, 2.0 ** 14]
    assert [s["loss_scale"]["good_steps"].item() for s in (s1, s2, s3)] == [
        1, 0, 1]
    assert np.isinf(out["loss_list"][1])
    assert np.isfinite(out["loss_list"][2:]).all()
