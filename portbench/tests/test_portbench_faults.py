"""A whole run but for the look for a card, with the timed path broken
underneath: ``correct`` must come out false for each fault a cell can
have, and true without one."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import drivers, harness
from portbench.tests.helpers import fitted, one_torch_thread, small_root  # noqa: F401


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("faults"))


def unchanged(classify):
    """A step that returns its state unchanged."""
    def run(self, batch):
        classify(self, batch)
        return batch
    return run


def half_left_out(classify):
    """The first half of the batch (rounded down) classified, the rest
    passed through as it came."""
    def run(self, batch):
        out = classify(self, batch)
        h = batch.batch // 2
        return dataclasses.replace(
            out, **{f: torch.cat([getattr(out, f)[:h], getattr(batch, f)[h:]
                                  .to(getattr(out, f).device)])
                    for f in ("rslt", "codes", "svm_acc")})
    return run


def answer_altered(classify):
    """One packet's answer altered where it is produced."""
    def run(self, batch):
        out = classify(self, batch)
        rslt = out.rslt.clone()
        rslt[0] = rslt[0] + 1
        return dataclasses.replace(out, rslt=rslt)
    return run


def _run(root, cell, seed=2**31 + 7):
    res, _ = harness.run_cell(cell, seed, 0.3, False, device="cpu",
                              root=root, log=lambda s: None)
    return res


@pytest.mark.parametrize("cell", ["zoo4-b4096", "fattree4-b4096",
                                  "zoo4-open"])
def test_sound_run_is_correct(root, fitted, cell):  # noqa: F811
    res = _run(root, cell)
    assert res["correct"], res["checks"]
    assert res["checks"]["packets_compared"]["value"] > 0


@pytest.mark.parametrize("fault", [unchanged, half_left_out, answer_altered])
@pytest.mark.parametrize("cell,executor", [
    ("zoo4-b4096", "SingleSwitchExecutor"),
    ("fattree4-b4096", "SequentialPathExecutor"),
    ("zoo4-open", "SingleSwitchExecutor")])
def test_fault_makes_run_incorrect(root, fitted, monkeypatch, cell,  # noqa: F811
                                   executor, fault):
    from repro_torch.runtime import executors

    cls = getattr(executors, executor)
    monkeypatch.setattr(cls, "classify", fault(cls.classify))
    # every answer compared: a run of a few requests keeps a quarter of few
    monkeypatch.setattr(drivers, "CHECK_SHARE", 1.0)
    assert not _run(root, cell)["correct"]


def test_hop_hand_off_left_out(root, fitted, monkeypatch):  # noqa: F811
    """The exchange between switches left out: each hop classifies the
    packets as they left the host, not as the hop before left them."""
    from repro_torch.core.plane import _classify_impl
    from repro_torch.runtime.executors import SequentialPathExecutor

    def chain(self, batch):
        out = batch
        for packed in self.programs:
            out = _classify_impl(packed, batch, n_classes=self.n_classes,
                                 mode=self.mode)
        return out
    monkeypatch.setattr(SequentialPathExecutor, "_chain", chain)
    assert not _run(root, "fattree4-b4096")["correct"]
