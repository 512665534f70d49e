"""The port's trainer against het_tpu's, from the same initial parameters:
het_tpu's own initialisation (``PRNGKey(seed)`` split three ways,
``embed.init``, ``model.init``) carried over by ``params_from_jax``, at
dropout 0 on a tiny synthetic mag: RGAT compact multiply-first, and
``--model RGCN`` and ``--model HGT`` plain and compact (given the same
heads, layers and multiply-first flag, which both trainers ignore for
RGCN and HGT; HGT takes the heads and layers), and ``--model GAT`` on the
cora stand-in (R = 1).  Both take
their warm-up Adam steps before the timed ones (or none with
``no_warm_up``); the timed losses and the final parameters (het_tpu's
from its end-of-run checkpoint) must agree, and so must the report:
het_tpu's keys, ``train_acc`` and ``test_acc``, and the compact
duplication warning.  Tolerance: rtol 1e-4 / atol 2e-4, the forward one
of the backend-parity tests."""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest

from het_tpu.data import load_dataset as j_load_dataset
from het_tpu.models import NodeEmbed as JNodeEmbed
from het_tpu.train import TrainConfig as JTrainConfig
from het_tpu.train import train as j_train
from het_tpu.train.driver import build_model as j_build_model
from het_tpu_torch.data.loaders import load_dataset
from het_tpu_torch.models import params_from_jax
from het_tpu_torch.train import TrainConfig, train
from het_tpu_torch.train.driver import build_model

VAL = dict(rtol=1e-4, atol=2e-4)
SHARED = dict(model="RGAT", dataset="mag", dataset_scale=0.002, n_infeat=16,
              hidden=16, num_heads=2, num_layers=2, num_classes=8,
              num_epochs=2, warmup_epochs=2, dropout=0.0, compact=True,
              multiply_first=True, seed=0)


def _jax_initial_params(cfg, data):
    """het_tpu's trainer's initial parameters, made as its ``train``
    makes them."""
    key = jax.random.PRNGKey(cfg.seed)
    k_embed, k_model, _ = jax.random.split(key, 3)
    embed = JNodeEmbed(num_nodes=data.graph.num_nodes,
                       embed_dim=cfg.n_infeat, param_dtype=jnp.float32)
    e_params = embed.init(k_embed)
    m_params = j_build_model(cfg, data).init(
        k_model, jax.device_put(data.graph), embed.apply(e_params))
    return jax.tree.map(np.asarray, {"embed": e_params, "model": m_params})


@pytest.mark.parametrize("model,no_warm_up", [
    pytest.param({}, False, id="False"),
    pytest.param({}, True, id="True"),
    pytest.param(dict(model="RGCN", compact=False), False, id="RGCN-plain"),
    pytest.param(dict(model="RGCN", compact=True), False, id="RGCN-compact"),
    pytest.param(dict(model="HGT", compact=False), False, id="HGT-plain"),
    pytest.param(dict(model="HGT", compact=True), False, id="HGT-compact"),
    pytest.param(dict(model="GAT", dataset="cora", dataset_scale=0.5,
                      compact=False, multiply_first=False), False, id="GAT"),
])
def test_trainer_matches_het_tpu(tmp_path, model, no_warm_up):
    shared = dict(SHARED, **model)
    jcfg = JTrainConfig(**shared, no_warm_up=no_warm_up, save_every=2,
                        checkpoint_dir=str(tmp_path / "ckpt"))
    jdata = j_load_dataset(jcfg.dataset, scale=jcfg.dataset_scale,
                           num_classes=jcfg.num_classes, seed=jcfg.seed,
                           build_compact=True)
    tree = _jax_initial_params(jcfg, jdata)
    jm = j_train(jcfg, jdata)
    with ocp.PyTreeCheckpointer() as ckptr:
        j_final = ckptr.restore(str(tmp_path / "ckpt" / "step_2"))["params"]

    cfg = TrainConfig(**shared, no_warm_up=no_warm_up, device="cpu")
    data = load_dataset(cfg.dataset, scale=cfg.dataset_scale,
                        num_classes=cfg.num_classes, seed=cfg.seed)
    net = build_model(cfg, data)
    logs = []
    m = train(cfg, data, state=params_from_jax(tree), log=logs.append,
              net=net)
    assert len(m["loss_list"]) == len(logs) == cfg.num_epochs
    np.testing.assert_allclose(m["loss_list"], jm["loss_list"], **VAL)
    final = net.state_dict()
    want = params_from_jax(jax.tree.map(np.asarray, j_final))
    assert sorted(final) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(final[name].numpy(), value.numpy(),
                                   err_msg=name, **VAL)
    # the report: het_tpu's keys beside the port's own, the accuracies of
    # the final parameters (dropout 0: het_tpu's accuracy applies it)
    assert set(jm) <= set(m), set(jm) - set(m)
    assert {"device", "step_ms_list", "timer"} <= set(m)
    assert m["flags"]["impl"] == "kernel"
    # the same predictions: one flip moves an accuracy by 1/len(idx),
    # far past f32's rounding of the mean
    for key in ("train_acc", "test_acc"):
        assert m[key] == pytest.approx(jm[key], rel=1e-6, abs=0), key
    steps = cfg.num_epochs
    for key in ("forward", "backward", "training"):
        times = m[f"{key}_time_list"]
        assert len(times) == steps and all(t >= 0 for t in times)
        assert m[f"mean_{key}_time"] == pytest.approx(
            np.mean(times[steps // 4:]))
    np.testing.assert_allclose(
        np.add(m["forward_time_list"], m["backward_time_list"]),
        m["training_time_list"])
    assert m["max_memory_usage (mb)"] is None  # no device statistics
    assert m["intermediate_memory_usage (mb)"] is None


def _warnings_of(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return [str(w.message) for w in caught
            if "duplication factor" in str(w.message)]


def test_compact_duplication_warning_matches_het_tpu():
    """Compact rows on a graph with fewer than 1.5 edges per unique
    (relation, source) pair (the aifb stand-in): both trainers warn, with
    the same words and factor."""
    shared = dict(model="RGCN", dataset="aifb", dataset_scale=0.1,
                  n_infeat=8, hidden=8, num_classes=4, num_epochs=1,
                  dropout=0.0, compact=True, no_warm_up=True, seed=0)
    want = _warnings_of(lambda: j_train(JTrainConfig(**shared)))
    got = _warnings_of(lambda: train(TrainConfig(**shared, device="cpu"),
                                     log=lambda s: None))
    assert len(want) == 1 and got == want


def test_logfile_appends_one_json_line(tmp_path):
    """``--logfile_enabled`` appends the returned metrics to
    ``--logfilename`` as one JSON line a run."""
    path = tmp_path / "metrics.json"
    cfg = TrainConfig(model="GAT", dataset="cora", dataset_scale=0.2,
                      n_infeat=8, hidden=4, num_heads=2, num_classes=4,
                      num_epochs=2, no_warm_up=True, device="cpu",
                      logfile_enabled=True, logfilename=str(path))
    runs = [train(cfg, log=lambda s: None) for _ in range(2)]
    lines = path.read_text().splitlines()
    assert [json.loads(line) for line in lines] == [
        json.loads(json.dumps(m)) for m in runs]
    assert runs[0]["loss_list"] == runs[1]["loss_list"]


@pytest.mark.parametrize("argv", [
    [],
    ["--dtype", "bfloat16", "--loss_scale", "dynamic"],
    ["--dtype", "bfloat16", "--loss_scale", "1024", "--patience", "3"],
    ["--save_every", "2", "--checkpoint_dir", "ck", "--resume",
     "--patience", "1", "-e", "7"],
])
def test_new_flags_parse_as_het_tpus(argv):
    """``--dtype``, ``--loss_scale``, ``--patience``, ``--save_every``,
    ``--checkpoint_dir`` and ``--resume`` parse to het_tpu's values for the
    same argv, defaults included."""
    import argparse

    from het_tpu.train.config import add_args as j_add_args
    from het_tpu.train.config import config_from_args as j_config_from_args
    from het_tpu_torch.train.config import add_args, config_from_args

    jp, p = argparse.ArgumentParser(), argparse.ArgumentParser()
    j_add_args(jp)
    add_args(p)
    want = j_config_from_args(jp.parse_args(argv))
    got = config_from_args(p.parse_args(argv))
    for name in ("dtype", "loss_scale", "patience", "save_every",
                 "checkpoint_dir", "resume", "num_epochs"):
        assert getattr(got, name) == getattr(want, name), name
