"""The port's minibatch trainer (``het_tpu_torch/train/minibatch.py``)
against het_tpu's ``train_minibatch``, from het_tpu's initial parameters
(``PRNGKey(seed)``: the table from its first split, ``model.init`` from
the second) carried over by ``params_from_jax``, on the same batches.
Both trainers draw natively (the port's host library and het_tpu's
``native/graphops.cpp`` share one random stream), so the port's trainer
is held to het_tpu's unpatched ``train_minibatch`` (compact
multiply-first RGAT), every batch's ``node_map`` too.  The plain draw is
held the same way: het_tpu's ``NeighborSampler`` is replaced
(``monkeypatch``, no file edited) by one whose ``sample`` takes the
port's ``draw_plain`` through het_tpu's own ``_finalize``, and the port's
trainer draws with ``draw_plain`` too; there het_tpu's fwd/bwd timing
(``op_time_ms``) is stubbed out: it times, and changes nothing.
Compared: the losses batch for batch, then ``train_acc``, ``test_acc``
and ``embed_trained_delta``, at rtol 1e-4 / atol 2e-4, for compact
multiply-first RGAT, plain RGAT and RGCN on the aifb stand-in at 0.02
(batch 32, fanout 4, tile 8, 3 batches).  Also: HGT and GAT train,
``--patience`` stops on the epochs' mean losses, the flags het_tpu drops
raise, and the CLI's ``--minibatch`` prints het_tpu's keys."""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from het_tpu.data import load_dataset as j_load_dataset
from het_tpu.data.sampling import NeighborSampler as JSampler
from het_tpu.graph import native as j_native
from het_tpu.train import TrainConfig as JTrainConfig
from het_tpu.train import minibatch as j_minibatch
from het_tpu.train.driver import build_model as j_build_model
from het_tpu_torch.data.loaders import load_dataset
from het_tpu_torch.data.sampling import NeighborSampler
from het_tpu_torch.models import params_from_jax
from het_tpu_torch.train import TrainConfig, train_minibatch

VAL = dict(rtol=1e-4, atol=2e-4)
SHARED = dict(model="RGAT", dataset="aifb", dataset_scale=0.02, n_infeat=8,
              hidden=8, num_heads=2, num_layers=2, num_classes=4,
              num_epochs=2, batch_size=32, fanout=4, num_hops=2, tile=8,
              max_batches=3, dropout=0.0, seed=0, full_graph_training=False)
FAMILIES = {
    "compact-multiply-first": dict(compact=True, multiply_first=True),
    "plain": dict(compact=False, multiply_first=False),
    "RGCN": dict(model="RGCN", compact=False),
}
HET_KEYS = ("task", "loss_list", "n_batches", "wall_s", "sample_wall_s",
            "batch_size", "fanout", "num_hops", "train_acc", "test_acc",
            "embed_trained_delta", "early_stopped", "mean_forward_time",
            "mean_backward_time", "mean_training_time")


class _PortDraws(JSampler):
    """het_tpu's sampler drawing through the port's ``draw_plain`` (seeded
    as the port's trainer seeds its sampler) and building through its own
    ``_finalize``."""

    def __init__(self, src, dst, rel, num_nodes, num_rels, **kw):
        super().__init__(src, dst, rel, num_nodes, num_rels, **kw)
        self.port = NeighborSampler(src, dst, rel, num_nodes, num_rels,
                                    **kw)

    def sample(self, seeds, *, tile=8, pad_edges_to=None, pad_nodes_to=None,
               build_compact=False):
        drawn = self.port.draw_plain(seeds, max_edges=pad_edges_to,
                                     max_nodes=pad_nodes_to)
        return self._finalize(*drawn, tile, pad_edges_to, pad_nodes_to,
                              build_compact)


def _jax_initial_state(cfg, jdata):
    """het_tpu's minibatch trainer's initial table and model, made as it
    makes them, as the port's state dict."""
    key = jax.random.PRNGKey(cfg.seed)
    k_emb, key = jax.random.split(key)
    embed0 = jax.random.uniform(k_emb, (jdata.graph.num_nodes, cfg.n_infeat),
                                jnp.float32, -0.5, 0.5)
    k_init, key = jax.random.split(key)
    m_params = j_build_model(cfg, jdata).init(
        k_init, jax.device_put(jdata.graph), embed0)
    return params_from_jax(jax.tree.map(np.asarray, {
        "embed": {"params": {"embed": embed0}}, "model": m_params}))


def _port_data(cfg):
    return load_dataset(cfg.dataset, scale=cfg.dataset_scale,
                        num_classes=cfg.num_classes, seed=cfg.seed,
                        tile=cfg.tile, build_compact=False)


def het_tpu_native_loaded():
    """True once het_tpu's native library is loaded.  Its loader builds
    the library with ``make`` and gives up for good, falling back to its
    Python sampler, when the load fails; a load can fail while another
    test process is writing the same library, so try again."""
    for _ in range(5):
        if j_native.available():
            return True
        j_native._TRIED = False
        time.sleep(2)
    return False


class _Recorded(JSampler):
    """het_tpu's sampler as it is, recording each batch's ``node_map``."""

    maps = []

    def sample(self, seeds, **kw):
        sub, node_map = super().sample(seeds, **kw)
        self.maps.append(node_map)
        return sub, node_map


def _compare(shared, jm, state):
    """The port's trainer from ``state`` against het_tpu's metrics
    ``jm``."""
    cfg = TrainConfig(**shared, device="cpu")
    m = train_minibatch(cfg, _port_data(cfg), state=state,
                        log=lambda s: None)
    assert set(HET_KEYS) <= set(m) and m["task"] == "minibatch_entity"
    assert m["n_batches"] == jm["n_batches"] == 3
    np.testing.assert_allclose(m["loss_list"], jm["loss_list"], **VAL)
    for key in ("train_acc", "test_acc", "embed_trained_delta"):
        np.testing.assert_allclose(m[key], jm[key], err_msg=key, **VAL)
    assert m["embed_trained_delta"] > 0
    assert len(m["build_ms_list"]) == len(m["copy_ms_list"]) == 3


def _jax_side(shared):
    jcfg = JTrainConfig(**shared)
    jdata = j_load_dataset(jcfg.dataset, scale=jcfg.dataset_scale,
                           num_classes=jcfg.num_classes, seed=jcfg.seed,
                           tile=jcfg.tile, build_compact=jcfg.compact)
    return jcfg, jdata, _jax_initial_state(jcfg, jdata)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_minibatch_matches_het_tpu(monkeypatch, family):
    """The plain draw: both trainers draw with the port's
    ``draw_plain``."""
    shared = dict(SHARED, **FAMILIES[family])
    jcfg, jdata, state = _jax_side(shared)
    monkeypatch.setattr(j_minibatch, "NeighborSampler", _PortDraws)
    monkeypatch.setattr("het_tpu.utils.timing.op_time_ms",
                        lambda *a, **k: 0.0)
    jm = j_minibatch.train_minibatch(jcfg, jdata)
    monkeypatch.setattr(NeighborSampler, "draw", NeighborSampler.draw_plain)
    _compare(shared, jm, state)


def test_minibatch_matches_unpatched_het_tpu(monkeypatch):
    """Both trainers as they are, drawing natively from one seed: the
    same batches, training and accuracy ones in the same order (fanout 4
    is below most in-degrees of the stand-in, so the draws are random),
    the same losses.  Each side's batches are only recorded: het_tpu's
    sampler through a subclass that calls its ``sample``, the port's
    through a wrapper of its ``draw``."""
    assert het_tpu_native_loaded()
    shared = dict(SHARED, **FAMILIES["compact-multiply-first"])
    jcfg, jdata, state = _jax_side(shared)
    monkeypatch.setattr(_Recorded, "maps", [])
    monkeypatch.setattr(j_minibatch, "NeighborSampler", _Recorded)
    jm = j_minibatch.train_minibatch(jcfg, jdata)
    drawn, draw = [], NeighborSampler.draw

    def recorded_draw(self, seeds, **kw):
        out = draw(self, seeds, **kw)
        drawn.append(out[3])
        return out

    monkeypatch.setattr(NeighborSampler, "draw", recorded_draw)
    _compare(shared, jm, state)
    assert len(drawn) == len(_Recorded.maps) > 3
    for t_map, j_map in zip(drawn, _Recorded.maps):
        np.testing.assert_array_equal(j_map[:len(t_map)], t_map)
        assert (j_map[len(t_map):] == 0).all()


@pytest.mark.parametrize("model", ["HGT", "GAT"])
def test_other_families_train(model):
    """HGT and GAT train on the sampled subgraphs too, the table with
    them (het_tpu's minibatch trainer takes every family its
    ``build_model`` does)."""
    cfg = TrainConfig(**dict(SHARED, model=model), device="cpu")
    m = train_minibatch(cfg, _port_data(cfg), log=lambda s: None)
    assert m["n_batches"] == 3 and np.isfinite(m["loss_list"]).all()
    assert m["embed_trained_delta"] > 0 and 0 <= m["test_acc"] <= 1


def test_patience_stops_on_epoch_means():
    """``--patience 1`` ends the run after the first epoch whose mean
    loss is not below the best before it (het_tpu's minibatch trainer
    calls a ``stopper.step`` that ``EarlyStopping`` lacks)."""
    cfg = TrainConfig(**dict(SHARED, batch_size=64, num_epochs=12,
                             max_batches=1000, lr=0.3, patience=1),
                      device="cpu")
    data = _port_data(cfg)
    m = train_minibatch(cfg, data, log=lambda s: None)
    per_epoch = len(data.train_idx) // cfg.batch_size
    losses = np.asarray(m["loss_list"]).reshape(-1, per_epoch)
    means = losses.mean(1)
    worse = [ep for ep in range(1, len(means))
             if not means[ep] < means[:ep].min()]
    assert m["early_stopped"] and worse == [len(means) - 1], means
    assert len(means) < cfg.num_epochs


@pytest.mark.parametrize("flag", [dict(dtype="bfloat16"),
                                  dict(save_every=1), dict(resume=True),
                                  dict(compact_union=True)])
def test_dropped_flags_raise(flag):
    with pytest.raises(ValueError, match="--minibatch does not take"):
        train_minibatch(TrainConfig(**SHARED, **flag, device="cpu"))


def test_cli_minibatch(monkeypatch, capsys):
    from het_tpu_torch.train.__main__ import main

    monkeypatch.setattr(sys, "argv", [
        "train", "--minibatch", "-d", "aifb", "--dataset_scale", "0.05",
        "--n_infeat", "8", "--hidden", "8", "--num_classes", "4",
        "--batch_size", "32", "--fanout", "4", "--tile", "8",
        "--max_batches", "2", "--device", "cpu",
        "--compact_as_of_node_flag", "--multiply_among_weights_first_flag"])
    main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(HET_KEYS) <= set(out) and out["n_batches"] == 2
    assert out["flags"]["compact"] and out["device"] == "cpu"
