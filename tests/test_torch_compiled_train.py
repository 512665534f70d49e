"""The port's trainer with ``--use_compiler`` against het_tpu's, from the
same initial parameters (het_tpu's own initialisation, carried over by
``params_from_jax``, whose compiled models keep a plain ``layer_{i}``
dict), at dropout 0 on a tiny synthetic mag loaded with
``data_roots=()`` on both sides: RGAT under its four flag combinations,
HGT and RGCN plain and compact.  Both take their warm-up Adam steps
before the timed ones; the timed losses and the final parameters
(het_tpu's from its end-of-run checkpoint) must agree, within rtol 1e-4 /
atol 2e-4.  Then the flag's rules: ``--minibatch --use_compiler`` trains
(the minibatch trainer builds through ``build_model``), ``--task link
--use_compiler`` and ``--model GAT --use_compiler`` raise."""

import json
import math
import sys

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
from het_tpu_torch.ops import kernels
from het_tpu_torch.train import TrainConfig, train
from het_tpu_torch.train.compiled import FAMILIES
from het_tpu_torch.train.driver import build_model

VAL = dict(rtol=1e-4, atol=2e-4)
SHARED = dict(dataset="mag", dataset_scale=0.002, n_infeat=16, hidden=16,
              num_heads=2, num_layers=2, num_classes=8, num_epochs=2,
              warmup_epochs=2, dropout=0.0, seed=0, use_compiler=True)
RUNS = [("RGAT", c, m) for c in (False, True) for m in (False, True)] + [
    (f, c, False) for f in ("HGT", "RGCN") for c in (False, True)]


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


@pytest.mark.parametrize("model,compact,mf", RUNS)
def test_compiled_trainer_matches_het_tpu(tmp_path, model, compact, mf):
    shared = dict(SHARED, model=model, compact=compact, multiply_first=mf)
    jcfg = JTrainConfig(**shared, save_every=2,
                        checkpoint_dir=str(tmp_path / "ckpt"))
    jdata = j_load_dataset(jcfg.dataset, scale=jcfg.dataset_scale,
                           num_classes=jcfg.num_classes, seed=jcfg.seed,
                           build_compact=True, data_roots=())
    tree = _jax_initial_params(jcfg, jdata)
    assert "params" not in tree["model"]  # the compiled models' plain dict
    jm = j_train(jcfg, jdata)
    with ocp.PyTreeCheckpointer() as ckptr:
        j_final = ckptr.restore(str(tmp_path / "ckpt" / "step_2"))["params"]

    cfg = TrainConfig(**shared, device="cpu")
    data = load_dataset(cfg.dataset, scale=cfg.dataset_scale,
                        num_classes=cfg.num_classes, seed=cfg.seed,
                        data_roots=())
    net = build_model(cfg, data)
    assert isinstance(net.model, FAMILIES[model])
    m = train(cfg, data, state=params_from_jax(tree), log=lambda s: None,
              net=net)
    np.testing.assert_allclose(m["loss_list"], jm["loss_list"], **VAL)
    final = net.state_dict()
    want = params_from_jax(jax.tree.map(np.asarray, j_final))
    assert sorted(final) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(final[name].numpy(), value.numpy(),
                                   err_msg=name, **VAL)
    for key in ("train_acc", "test_acc"):
        assert m[key] == pytest.approx(jm[key], rel=1e-6, abs=0), key


def _cli(monkeypatch, capsys, *flags):
    from het_tpu_torch.train.__main__ import main

    monkeypatch.setattr(sys, "argv", ["het_tpu_torch.train", *flags,
                                      "--device", "cpu"])
    main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("model,flags", [
    ("RGAT", ["--compact_as_of_node_flag",
              "--multiply_among_weights_first_flag"]),
    ("HGT", []), ("RGCN", ["--compact_as_of_node_flag"])])
def test_minibatch_trains_through_the_compiler(monkeypatch, capsys, model,
                                               flags):
    """``--minibatch --use_compiler``: the sampled subgraphs run the
    compiled model (on the CPU here, so no kernel launches)."""
    kernels.reset_launches()
    m = _cli(monkeypatch, capsys, "--minibatch", "--use_compiler",
             "--model", model, "-d", "aifb", "--dataset_scale", "0.05",
             "--batch_size", "32", "--fanout", "4", "--tile", "8",
             "--max_batches", "3", "--num_layers", "2", "--n_infeat", "8",
             "--hidden", "8", *flags)
    assert m["n_batches"] == 3 and all(map(math.isfinite, m["loss_list"]))
    assert 0.0 <= m["test_acc"] <= 1.0
    assert not any(kernels.launch_counts().values())


def test_full_graph_trains_through_the_cli(monkeypatch, capsys):
    """The slice's command at a tiny scale: finite losses that fall."""
    m = _cli(monkeypatch, capsys, "--model", "RGAT", "-d", "mag",
             "--dataset_scale", "0.002", "--num_layers", "2", "--n_infeat",
             "16", "--hidden", "16", "--use_compiler",
             "--compact_as_of_node_flag",
             "--multiply_among_weights_first_flag", "-e", "6",
             "--dropout", "0")
    losses = m["loss_list"]
    assert len(losses) == 6 and all(map(math.isfinite, losses))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("flags,match", [
    (["--task", "link", "-d", "fb15k"], "--use_compiler"),
    (["--model", "GAT", "-d", "mag"], "RGAT/HGT/RGCN, got GAT")])
def test_compiler_refusals(monkeypatch, capsys, flags, match):
    """het_tpu's link trainer drops ``--use_compiler`` without a word (the
    port raises), and its ``build_model`` refuses GAT (so does the
    port's)."""
    with pytest.raises(ValueError, match=match):
        _cli(monkeypatch, capsys, "--use_compiler", "--dataset_scale",
             "0.002", "-e", "1", *flags)
