"""The training job every driver builds: the port's ``Engine`` fed by its
``ShardedLoader``, driven through its first steps in set-up (where the
check reads the program's own state) and then handed, the same object,
to the timed window."""
from __future__ import annotations

import gc
from typing import Callable, Dict, Mapping

import numpy as np
import torch

from bench.harness import Spans, log


def replica_norms(tree: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Each leaf's norm per replica (the leading axis), as float64."""
    return {k: torch.linalg.vector_norm(
        v.detach().float().reshape(v.shape[0], -1), dim=1
    ).double().cpu().numpy() for k, v in tree.items()}


class EngineJob:
    """``engine`` and its ``state``, fed by the port's ``ShardedLoader``
    over ``source`` (prefetching ``traffic["prefetch"]`` batches)."""

    units = ""

    def __init__(self, engine, state, source, traffic: Mapping,
                 work_per_step: int):
        from repro_torch.data.loader import ShardedLoader
        self.engine, self.state = engine, state
        self.traffic = traffic
        self.work_per_step = work_per_step
        self.loader = ShardedLoader(source, engine,
                                    prefetch=traffic["prefetch"])
        self.it = iter(self.loader)
        self.losses = []
        self.readings = None

    def step(self, spans: Spans) -> None:
        """One step of the timed path: the next batch, then the update."""
        with spans("loader_wait"):
            batch = next(self.it)
        with spans("dispatch"):
            self.state, m = self.engine.step(self.state, batch)
        self.losses.append(m["loss"])

    def drive(self, params0: Callable[[], Mapping[str, torch.Tensor]]
              ) -> None:
        """The checked steps, then the warm-up steps. After the first the
        optimizer's first moment holds (1 - b1) times the clipped
        gradient; after the last checked one the params' change is taken
        against ``params0()``, the initial weights made again."""
        spans = Spans()
        b1 = self.traffic["train"]["b1"]
        losses, grad = [], None
        log("the program's state is built")
        for i in range(self.traffic["checked_steps"]):
            self.step(spans)
            losses.append(self.losses[-1].detach().double().reshape(-1)
                          .cpu().numpy())
            log(f"checked step {i + 1} done")
            if i == 0:
                grad = {k: v / (1 - b1) for k, v in replica_norms(
                    self.state.opt_state.mu).items()}
        p0 = params0()
        change = replica_norms({k: self.state.params[k] - p0[k].reshape(
            self.state.params[k].shape) for k in p0})
        del p0
        self.readings = {"loss": np.stack(losses), "grad": grad,
                         "change": change}
        for _ in range(self.traffic["warm_steps"]):
            self.step(spans)
        log("warm-up steps enqueued")

    def program_readings(self) -> Dict:
        return self.readings

    def finish(self) -> None:
        """Stop the loader's thread and free the program's state."""
        self.it.close()
        del self.it, self.loader, self.state, self.engine
        self.losses = []
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
