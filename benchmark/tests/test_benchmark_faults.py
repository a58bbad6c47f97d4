"""The rest of a run, with the timed path broken underneath, has to come
out not ``correct``: once for each fault a cell can have. Neither cell
spans chips, so no exchange between chips can be left out; the single
cell's batch is one query, so it has no half to leave out."""

import pytest
import torch

from iresearch_tpu_torch.exec import batch as B
from iresearch_tpu_torch.exec import segmerge as M
from tiny import run_tiny


def _grouped(fault):
    orig = B.PreparedBatch.run_grouped

    def run_grouped(self, *a, **kw):
        out = orig(self, *a, **kw)
        nq = self.num_queries
        broken = []
        for gi, ((v, d), qis) in enumerate(out):
            v, d = v.clone(), d.clone()
            if fault == "half":  # the batch's second half left out
                for j, qi in enumerate(qis):
                    if qi >= nq // 2:
                        v[j] = float("-inf")
            elif fault == "altered" and gi == 0:  # one answer's doc moved
                d[0, 0] += 1
            elif fault == "unchanged":  # the output buffers left as they were
                v.zero_()
                d.zero_()
            broken.append(((v, d), qis))
        return broken

    return run_grouped


@pytest.mark.parametrize("fault", ["half", "altered", "unchanged"])
def test_replay_fault_is_not_correct(tiny_root, monkeypatch, fault):
    monkeypatch.setattr(B.PreparedBatch, "run_grouped", _grouped(fault))
    line, _ = run_tiny(tiny_root, "wiki2m-1seg.replay400")
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", ["stale", "altered"])
def test_single_fault_is_not_correct(tiny_root, monkeypatch, fault):
    orig = M.MergedBatch.run
    last = []

    def run(self, *a, **kw):
        vals, docs = orig(self, *a, **kw)
        if fault == "stale":  # each request answered with the one before
            last.append((vals, docs))
            return last[-2] if len(last) > 1 else (vals, docs)
        return vals * torch.tensor(1.001), docs  # a score altered

    monkeypatch.setattr(M.MergedBatch, "run", run)
    line, _ = run_tiny(tiny_root, "wiki2m-4seg.single")
    assert line["correct"] is False, line["checks"]
