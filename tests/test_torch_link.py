"""The port's link-prediction trainer (``het_tpu_torch/train/link.py``)
against het_tpu's ``train_link``, from het_tpu's initial parameters
(``PRNGKey(seed)`` split three ways: the embeddings, the encoder and
``w_rel`` from the second) carried over by ``params_from_jax``, with
het_tpu's own negatives, re-derived from its ``k_run`` as its loss does
(``jax.random.split`` an epoch, the first half of the epoch key's split
for ``randint``).  The losses must agree at rtol 1e-4 / atol 2e-4 (the
trainers' tolerance), and the port's ranking on het_tpu's final state and
candidates (``PRNGKey(1)``) must give het_tpu's MRR and Hits@10 within
0.02, as ``tests/test_accuracy_parity.py`` allows for ties.  On the
fb15k stand-in at 0.01 (145 nodes, R = 474), plain and compact
multiply-first RGAT.  Also: what the trainer does not take raises, and
the CLI's ``--task link`` prints het_tpu's keys."""

import json
import sys

import jax
import numpy as np
import pytest
import torch

from het_tpu.data import load_dataset as j_load_dataset
from het_tpu.models import NodeEmbed as JNodeEmbed
from het_tpu.models import RGATModel as JRGATModel
from het_tpu.train import TrainConfig as JTrainConfig
from het_tpu.train.link import train_link as j_train_link
from het_tpu_torch.data.loaders import load_dataset
from het_tpu_torch.models import params_from_jax
from het_tpu_torch.train import TrainConfig, train_link
from het_tpu_torch.train.link import NUM_CANDIDATES, rank_metrics

VAL = dict(rtol=1e-4, atol=2e-4)
SHARED = dict(model="RGAT", dataset="fb15k", dataset_scale=0.01, n_infeat=16,
              hidden=16, num_heads=2, num_layers=1, num_epochs=6,
              dropout=0.0, lr=5e-2, tile=8, seed=0)
NEG_RATIO = 4
HET_KEYS = ("task", "loss_list", "mrr", "hits@10", "epochs", "wall_s",
            "num_supervision_edges")


def _jax_initial_state(cfg, g):
    """het_tpu's link trainer's initial parameters as the port's state
    dict."""
    k_embed, k_model, _ = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)
    embed = JNodeEmbed(num_nodes=g.num_nodes, embed_dim=cfg.n_infeat)
    e_params = embed.init(k_embed)
    model = JRGATModel(
        in_feat=cfg.n_infeat, hidden=cfg.hidden, num_classes=cfg.hidden,
        num_rels=g.num_rels, num_heads=cfg.num_heads,
        num_layers=max(cfg.num_layers, 1), compact=cfg.compact,
        multiply_first=cfg.multiply_first, dropout=cfg.dropout,
        stable_softmax=cfg.stable_softmax)
    m_params = model.init(k_model, jax.device_put(g), embed.apply(e_params))
    w_rel = jax.random.normal(k_model, (g.num_rels, cfg.hidden)) * 0.1
    state = params_from_jax(jax.tree.map(np.asarray, {
        "embed": e_params, "model": m_params}))
    state["w_rel"] = torch.from_numpy(np.array(w_rel))
    return state


def _jax_negatives(cfg, n, num_nodes):
    """The corrupted objects of each of het_tpu's epochs."""
    k_run = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)[2]
    out = []
    for _ in range(cfg.num_epochs):
        k_run, k = jax.random.split(k_run)
        k1, _ = jax.random.split(k)
        out.append(np.asarray(jax.random.randint(k1, (n,), 0, num_nodes)))
    return out


@pytest.mark.parametrize("flags", [
    pytest.param(dict(compact=False, multiply_first=False), id="plain"),
    pytest.param(dict(compact=True, multiply_first=True),
                 id="compact-multiply-first"),
])
def test_link_matches_het_tpu(flags):
    shared = dict(SHARED, **flags)
    jcfg = JTrainConfig(**shared)
    jdata = j_load_dataset(jcfg.dataset, scale=jcfg.dataset_scale,
                           seed=jcfg.seed, tile=jcfg.tile,
                           build_compact=jcfg.compact)
    jm = j_train_link(jcfg, jdata, neg_ratio=NEG_RATIO, return_state=True)
    N = jdata.graph.num_nodes
    n_sup = jm["num_supervision_edges"]
    negs = _jax_negatives(jcfg, n_sup * NEG_RATIO, N)

    cfg = TrainConfig(**shared, device="cpu")
    data = load_dataset(cfg.dataset, scale=cfg.dataset_scale, seed=cfg.seed,
                        tile=cfg.tile, build_compact=False)
    m = train_link(cfg, data, neg_ratio=NEG_RATIO,
                   negatives=lambda ep: negs[ep],
                   state=_jax_initial_state(jcfg, jdata.graph),
                   return_state=True, log=lambda s: None)
    assert set(HET_KEYS) <= set(m) and m["task"] == "link_prediction"
    assert m["num_supervision_edges"] == n_sup
    for a, b in zip(m["_state"]["sup"], jm["_state"]["sup"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(m["loss_list"], jm["loss_list"], **VAL)
    assert m["loss_list"][-1] < m["loss_list"][0]

    st = jm["_state"]
    cand = np.asarray(jax.random.randint(jax.random.PRNGKey(1),
                                         (n_sup, NUM_CANDIDATES), 0, N))
    mrr, hits = rank_metrics(
        torch.from_numpy(st["emb"]), torch.from_numpy(st["w_rel"]),
        *(torch.from_numpy(a.astype(np.int64)) for a in st["sup"]),
        torch.from_numpy(cand.astype(np.int64)))
    assert abs(mrr - jm["mrr"]) <= 0.02, (mrr, jm["mrr"])
    assert abs(hits - jm["hits@10"]) <= 0.02, (hits, jm["hits@10"])
    # the port's own metrics of its own run, on its own candidates
    assert 0.0 < m["mrr"] <= 1.0 and 0.0 <= m["hits@10"] <= 1.0


def test_rank_metrics_chunks(monkeypatch):
    """Chunks of triples give the metrics of one pass, ranks counting only
    strictly greater candidate scores."""
    import het_tpu_torch.train.link as link

    gen = torch.Generator().manual_seed(0)
    emb = torch.randn(50, 8, generator=gen)
    w = torch.randn(3, 8, generator=gen)
    s, r, o = (torch.randint(0, k, (37,), generator=gen)
               for k in (50, 3, 50))
    cand = torch.randint(0, 50, (37, NUM_CANDIDATES), generator=gen)
    cand[:, 0] = o  # the object itself ties its own score
    whole = rank_metrics(emb, w, s, r, o, cand)
    monkeypatch.setattr(link, "EVAL_CHUNK_BYTES", 5 * NUM_CANDIDATES * 8 * 4)
    assert rank_metrics(emb, w, s, r, o, cand) == pytest.approx(whole)
    pos = (emb[s] * w[r] * emb[o]).sum(-1)
    sc = ((emb[s] * w[r])[:, None, :] * emb[cand]).sum(-1)
    rank = 1 + (sc > pos[:, None] + 1e-5).sum(1)
    assert whole[0] == pytest.approx((1.0 / rank.double()).mean().item(),
                                     abs=0.02)


@pytest.mark.parametrize("flag", [dict(model="RGCN"), dict(dtype="bfloat16"),
                                  dict(save_every=1), dict(resume=True),
                                  dict(patience=2),
                                  dict(compact_union=True)])
def test_untaken_flags_raise(flag):
    with pytest.raises(ValueError, match="--task link does not take"):
        train_link(TrainConfig(**dict(SHARED, **flag), device="cpu"))


def test_cli_link(monkeypatch, capsys):
    from het_tpu_torch.train.__main__ import main

    monkeypatch.setattr(sys, "argv", [
        "train", "--task", "link", "-d", "fb15k", "--dataset_scale", "0.01",
        "--n_infeat", "8", "--hidden", "8", "-e", "2", "--tile", "8",
        "--device", "cpu"])
    main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(HET_KEYS) <= set(out) and out["epochs"] == 2
    assert len(out["loss_list"]) == 2 and "_state" not in out
