"""A run with its timed path broken underneath comes out not correct,
once for each fault a one-card training cell can have: a step that
leaves the state unchanged, half of the batch left out of the loss (the
mean over the rest), and an answer (the model's output) altered where it
is produced; and a step that leaves one leaf unchanged, for each leaf.  The harness's look for a card is skipped: the run is on the
CPU at a tiny size, held to the cell's own limits."""

import pytest
import torch

from benchmark import control, run
from benchmark.tests.tiny import CELLS, CPU, tiny_spec
from het_tpu_torch.train.driver import NodeClassifier
from het_tpu_torch.utils import misc


def _state_unchanged(monkeypatch):
    step = torch.optim.Adam.step

    def unchanged(self, *a, **kw):
        before = [p.detach().clone() for g in self.param_groups
                  for p in g["params"]]
        out = step(self, *a, **kw)
        with torch.no_grad():
            for p, b in zip((p for g in self.param_groups
                             for p in g["params"]), before):
                p.copy_(b)
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", unchanged)


def _half_batch(monkeypatch):
    nll = misc.nll_loss

    def half(logits, labels):
        n = logits.shape[0] // 2
        return nll(logits[:n], labels[:n])

    monkeypatch.setattr(misc, "nll_loss", half)


def _altered_answer(monkeypatch):
    forward = NodeClassifier.forward

    def altered(self, g, **kw):
        out = forward(self, g, **kw)
        return out + torch.nn.functional.pad(out.new_full((1, 1), control.ALTER),
                                             (0, out.shape[1] - 1))

    monkeypatch.setattr(NodeClassifier, "forward", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    spec = tiny_spec(cell)
    FAULTS[fault](monkeypatch)
    result, _ = run.run_cell(spec, 2**31 + 5, 0.1, False, CPU)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_one_leaf_left_unchanged_is_not_correct(cell, monkeypatch):
    """Adam moves every leaf but one; for each leaf in turn, the run
    comes out not correct."""
    spec = tiny_spec(cell)
    step = torch.optim.Adam.step
    frozen = {"at": 0}

    def all_but_one(self, *a, **kw):
        leaf = [p for g in self.param_groups for p in g["params"]][
            frozen["at"]]
        before = leaf.detach().clone()
        out = step(self, *a, **kw)
        with torch.no_grad():
            leaf.copy_(before)
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", all_but_one)
    cfg = spec.config
    n = len(run.load("reference", cfg["family"]).param_shapes(cfg, 1, 1, 1))
    for at in range(n):
        frozen["at"] = at
        result, _ = run.run_cell(spec, 2**31 + 5, 0.1, False, CPU)
        assert result["correct"] is False, at
