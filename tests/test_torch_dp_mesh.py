"""The rest of the port's data-parallel path against het_tpu on the CPU:
the two-level ``(host, chip)`` mesh (``make_mesh2``), the halo's bytes by
link class, ``entry()`` and ``dryrun_multichip``'s RGCN -> HGT -> RGAT
stack (``het_tpu_torch/entry.py`` against ``__graft_entry__.py``), and
``bench.halo_bytes`` against ``scripts/halo_bytes_report.py``'s numbers.

One spawn of 4 gloo ranks for the file runs two jobs on the 2 x 2 mesh:
the dry run's mixed stack at ``dryrun_multichip(4)``'s shapes, held to
het_tpu's ``DPGNN`` over the same three layers on ``make_mesh2(2, 2)`` of
the suite's virtual CPU devices with the same parameters (its
``DPGNN.init``, carried by ``dp_params_from_jax``): logits on every real
node (forward rtol 1e-4 / atol 2e-4), every summed gradient (rtol 5e-3 /
atol 2e-4), and the loss after one Adam step of optax's ``adam(1e-2)``
(rtol 1e-4); and a one-layer RGAT with the boundary halo against
het_tpu's single-chip layer, as ``tests/test_parallel.py::
test_two_level_mesh_boundary_halo`` holds het_tpu's own (rtol 2e-4 /
atol 1e-5)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import __graft_entry__ as graft
from het_tpu.graph import build_heterograph as j_build
from het_tpu.models import HGTLayer as JHGTLayer
from het_tpu.models import RGATLayer as JRGATLayer
from het_tpu.models.rgcn import RGCNLayer as JRGCNLayer
from het_tpu.parallel import DPGNN as JDPGNN
from het_tpu.parallel import halo_bytes as j_halo_bytes
from het_tpu.parallel import partition_by_dst as j_partition
from het_tpu.parallel import shard_stacked
from het_tpu.parallel.dp import make_mesh2 as j_make_mesh2
from het_tpu_torch import entry as t_entry
from het_tpu_torch.bench import halo_bytes as halo_bench
from het_tpu_torch.models import dp_params_from_jax
from het_tpu_torch.parallel import halo_bytes, partition_by_dst
from het_tpu_torch.parallel.launch import spawn_ranks
from tests.test_torch_dp_worker import record_job

VAL = dict(rtol=1e-4, atol=2e-4)
GRAD = dict(rtol=5e-3, atol=2e-4)
MESH_VAL = dict(rtol=2e-4, atol=1e-5)
H, C = 2, 2
P = H * C
AXIS = ("host", "chip")
# the one-layer RGAT's graph: 85% of the sources in the destination's block
N, E, R, F, O = 256, 1000, 3, 8, 4


def _mesh_graph():
    rng = np.random.default_rng(23)
    per_block = N // P
    dst = rng.integers(0, N, E)
    local = rng.random(E) < 0.85
    src = np.where(local,
                   (dst // per_block) * per_block + rng.integers(0, per_block,
                                                                 E),
                   rng.integers(0, N, E))
    rel = rng.integers(0, R, E)
    x = rng.standard_normal((N, F), dtype=np.float32)
    labels = rng.integers(0, O, N)
    return src, dst, rel, x, labels


def _dryrun_reference(meta, x_pad, labels_pad):
    """het_tpu's dry-run step on ``make_mesh2(2, 2)``: its parameters
    (``DPGNN.init``), logits, loss, gradients, and the loss after one
    Adam step."""
    f, r = t_entry.DRY_FEAT, meta["r"]
    sg, _ = j_partition(meta["src"], meta["dst"], meta["rel"], meta["n"], r,
                        P, tile=8, build_compact=True, halo="auto")
    mesh = j_make_mesh2(H, C)
    sg = shard_stacked(sg, mesh, axis=AXIS)
    layers = [
        JRGCNLayer(in_feat=f, out_feat=16, num_rels=r,
                   activation=jax.nn.relu),
        JHGTLayer(in_dim=16, out_dim=16, num_ntypes=1, num_rels=r,
                  num_heads=2, dropout=0.0),
        JRGATLayer(in_feat=16, out_feat=t_entry.DRY_CLASSES, num_rels=r,
                   num_heads=2, dropout=0.0, compact=True),
    ]
    dp = JDPGNN(layers, mesh, axis=AXIS)
    x, labels = jnp.asarray(x_pad), jnp.asarray(labels_pad)
    params = jax.jit(lambda key: dp.init(key, sg, x))(jax.random.PRNGKey(0))

    def loss_fn(params):
        logits = dp.apply(params, sg, x)
        logp = jax.nn.log_softmax(logits, axis=-1)
        mask = (labels >= 0).astype(jnp.float32)
        oh = jax.nn.one_hot(jnp.maximum(labels, 0), logp.shape[-1])
        ll = jnp.sum(logp * oh, axis=-1)
        return -jnp.sum(ll * mask) / jnp.sum(mask), logits

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (value, logits), grads = grad_fn(params)
    tx = optax.adam(t_entry.DRY_LR)
    updates, _ = tx.update(grads, tx.init(params), params)
    (after, _), _ = grad_fn(optax.apply_updates(params, updates))
    return dict(params=jax.tree.map(np.asarray, params), loss=float(value),
                logits=np.asarray(logits), after=float(after),
                grads=jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jobs, meta = t_entry.dryrun_jobs(P, steps=2, impls=("kernel",))
    dry = jobs[0]
    assert dry["mesh2"] == (H, C) and meta["mesh"] == (H, C)
    ref = _dryrun_reference(meta, dry["x"], dry["labels"])
    dry["state"] = dp_params_from_jax(ref["params"])

    src, dst, rel, x, labels = _mesh_graph()
    shards, info = partition_by_dst(src, dst, rel, N, R, P, tile=8,
                                    halo="boundary")
    g1 = j_build(src, dst, rel, N, R, tile=8)
    layer = JRGATLayer(in_feat=F, out_feat=O, num_rels=R, num_heads=2,
                       dropout=0.0)
    params = layer.init(jax.random.PRNGKey(1), g1, jnp.asarray(x))
    single = np.asarray(layer.apply(params, g1, jnp.asarray(x)))
    one = dict(shards=shards, nodes_per_part=info.nodes_per_part,
               x=info.pad_node_data(x),
               labels=info.pad_node_data(labels, fill=-1),
               layers=[("RGAT", dict(in_feat=F, out_feat=O, num_rels=R,
                                     num_heads=2, dropout=0.0))],
               state=dp_params_from_jax([jax.tree.map(np.asarray, params)]),
               steps=1, lr=1e-2, impl="kernel", mesh2=(H, C))
    workdir = tmp_path_factory.mktemp("mesh_ranks")
    results = spawn_ranks(P, [dry, one], workdir=str(workdir), device="cpu",
                          job_fn=record_job)
    return dict(dry=[r_[0] for r_ in results], one=[r_[1] for r_ in results],
                ref=ref, meta=meta, single=single, info=info)


def _cat(ranks, key):
    return torch.cat([r_[key] for r_ in ranks]).numpy()


def test_mixed_stack_matches_het_tpu_on_the_two_level_mesh(runs):
    ranks, ref, meta = runs["dry"], runs["ref"], runs["meta"]
    for p, r_ in enumerate(ranks):
        assert r_["coords"] == (p // C, p % C)
        assert r_["backend"] == "gloo" and r_["device"] == "cpu"
        # the host axis: this chip on every host; the chip axis: this
        # host's chips; the pair: every rank, host-major
        assert r_["mesh_ranks"] == {
            "host": [h * C + p % C for h in range(H)],
            "chip": [p // C * C + c for c in range(C)],
            "pair": list(range(P))}
    rows = meta["info"].relabel(np.arange(meta["n"]))
    np.testing.assert_allclose(_cat(ranks, "logits")[rows],
                               ref["logits"][rows], **VAL)
    np.testing.assert_allclose(ranks[0]["loss"], ref["loss"], **VAL)
    names = sorted(ranks[0]["grads"])
    assert len(names) == 2 + 8 + 4  # RGCN, HGT, RGAT leaves
    for name in names:
        _, i, leaf = name.split(".")
        want = ref["grads"][int(i)]["params"][leaf]
        for r_ in ranks:
            np.testing.assert_allclose(r_["grads"][name].numpy(), want,
                                       err_msg=name, **GRAD)
    for r_ in ranks:
        # the loss before and after one Adam step of adam(1e-2)
        np.testing.assert_allclose(r_["loss_list"],
                                   [ref["loss"], ref["after"]], rtol=1e-4)
        assert r_["launches"] == {k: 0 for k in r_["launches"]}
    # halo "auto" took the boundary exchange: RGCN's features out (its
    # input needs no gradient), HGT's k and v out and back, RGAT's out
    # and back; the loss's sums and one gradient sum a parameter
    assert meta["halo"]["mode"] == "boundary"
    assert ranks[0]["collective_calls"] == {
        "all_gather / reduce_scatter": 0, "all_to_all": 7,
        "all_reduce": 1 + len(names)}


def test_rgat_layer_over_the_two_level_mesh_matches_single_chip(runs):
    ranks, info = runs["one"], runs["info"]
    assert [r_["coords"] for r_ in ranks] == [(0, 0), (0, 1), (1, 0),
                                              (1, 1)]
    out = _cat(ranks, "logits")[info.relabel(np.arange(N))]
    np.testing.assert_allclose(out, runs["single"], **MESH_VAL)


@pytest.mark.parametrize("n_parts,chips", [(4, 2), (8, 4)])
@pytest.mark.parametrize("halo", ["gather", "boundary"])
def test_halo_bytes_by_link_class_match_het_tpu(n_parts, chips, halo):
    src, dst, rel, _, _ = _mesh_graph()
    shards, _ = partition_by_dst(src, dst, rel, N, R, n_parts, tile=8,
                                 halo=halo)
    sg, _ = j_partition(src, dst, rel, N, R, n_parts, tile=8, halo=halo)
    g0 = jax.tree.map(lambda a: a[0], sg)
    want = j_halo_bytes(g0, n_parts, feat_width=F, chips_per_host=chips)
    got = halo_bytes(shards[0], n_parts, F, chips_per_host=chips)
    assert got["mode"] == want["mode"] == halo
    assert got["intra_host_bytes"] == want["ici_bytes"]
    assert got["inter_host_bytes"] == want["dcn_bytes"]
    assert got["bytes"] == want["ici_bytes"] + want["dcn_bytes"]
    assert got["gather_bytes"] == want["gather_bytes"]
    assert got["bytes"] == halo_bytes(shards[0], n_parts, F)["bytes"]
    with pytest.raises(ValueError, match="hosts of 3"):
        halo_bytes(shards[0], n_parts, F, chips_per_host=3)


def test_entry_forward_matches_het_tpu():
    fn, (params, x) = t_entry.entry("cpu")
    assert tuple(x.shape) == (t_entry.N_NODES, t_entry.F_IN)
    jfn, (jparams, jx) = graft.entry()
    carried = dp_params_from_jax([{"params": jparams["params"][
        f"RGATLayer_{i}"]} for i in range(2)])
    assert set(carried) == set(params)
    with torch.no_grad():
        got = fn(carried, torch.from_numpy(np.array(jx))).numpy()
        own = fn(params, x)
    assert tuple(own.shape) == (t_entry.N_NODES, t_entry.CLASSES)
    assert bool(torch.isfinite(own).all())
    np.testing.assert_allclose(got, np.asarray(jax.jit(jfn)(jparams, jx)),
                               **VAL)


def test_halo_bytes_report_matches_het_tpu():
    src, dst, rel, n, r, what = halo_bench.load_coo(0.002)
    assert what == "synthetic mag at 0.002"
    rows = list(halo_bench.rows(src, dst, rel, n, r, chips_per_host=4))
    assert [(x["parts"], x["balance"]) for x in rows] == [
        (p, b) for p in (2, 4, 8) for b in ("nodes", "edges")]
    for row in rows:
        p = row["parts"]
        sg, _ = j_partition(src, dst, rel, n, r, p, tile=128,
                            balance=row["balance"], halo="boundary")
        g0 = jax.tree.map(lambda a: a[0], sg)
        c = min(4, p)
        hb = j_halo_bytes(g0, p, feat_width=64, itemsize=4,
                          chips_per_host=c)
        assert row["b_self"] == int(g0.halo_self_idx.shape[0])
        assert row["b_off"] == int(g0.halo_send_idx.shape[-1])
        assert row["chips_per_host"] == c
        assert round(row["intra_host_mb"] * 1e6) == hb["ici_bytes"]
        assert round(row["inter_host_mb"] * 1e6) == hb["dcn_bytes"]
        assert round(row["boundary_mb"] * 1e6) == (hb["ici_bytes"]
                                                   + hb["dcn_bytes"])
        assert round(row["gather_mb"] * 1e6) == hb["gather_bytes"]
