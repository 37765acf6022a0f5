"""A run of the harness on the CPU, with the port's timed path broken
underneath, comes out not correct: once for each fault a training cell
can have (a step that returns its state unchanged; half of the batch left
out, the mean taken over the rest; an answer altered where it is
produced). One chip: no exchange between chips to leave out."""
import pytest
import torch

from bench import harness
from bench.conftest import DOMST, MAMBA2


def _frozen_step(self, state, batch):
    """``Engine.step`` that computes the loss and returns the state as it
    was given."""
    with torch.no_grad():
        loss, mets = self.loss_fn(state.params, batch)
    return state, self._unstack({**mets, "loss": loss})


def _plant(monkeypatch, name, fault):
    from repro_torch.core import domst
    from repro_torch.models import transformer as tfm
    from repro_torch.train.engine import Engine
    if fault == "unchanged_state":
        monkeypatch.setattr(Engine, "step", _frozen_step)
    elif name == DOMST and fault == "half_batch":
        loss_fn = domst.loss_fn

        def half(p, cfg, batch, ops=domst.KERNELS):
            n = batch["discharge"].shape[1] // 2
            return loss_fn(p, cfg, {k: v[:, :n] for k, v in batch.items()},
                           ops)
        monkeypatch.setattr(domst, "loss_fn", half)
    elif name == DOMST:
        forward = domst.forward

        def altered(*a, **k):
            q = forward(*a, **k)
            return torch.cat([q[:, :1] + 1.0, q[:, 1:]], dim=1)
        monkeypatch.setattr(domst, "forward", altered)
    else:
        lm_loss = tfm.lm_loss

        def broken(params, cfg, batch, **k):
            if fault == "half_batch":
                n = batch["tokens"].shape[0] // 2
                batch = {key: v[:n] for key, v in batch.items()}
            else:
                t = batch["targets"]
                batch = {**batch, "targets": torch.cat(
                    [t[:1].roll(1, dims=1), t[1:]])}
            return lm_loss(params, cfg, batch, **k)
        monkeypatch.setattr(tfm, "lm_loss", broken)


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "altered_answer"])
@pytest.mark.parametrize("name", [DOMST, MAMBA2])
def test_a_broken_step_is_not_correct(monkeypatch, tiny_cell, name, fault):
    cell = tiny_cell(name)
    _plant(monkeypatch, name, fault)
    out = harness.run(cell, 2 ** 31 + 29, 0.3, False, torch.device("cpu"),
                      0.0)
    assert out["result"]["correct"] is False, out["numbers"]
