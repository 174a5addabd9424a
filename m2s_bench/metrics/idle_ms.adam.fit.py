"""Device idle ms a step while the host was in Adam's step
(``optimizer.step()``, torch.optim's ``Optimizer.step#Adam.step``)."""

from m2s_bench.spans import OPTIMIZER, idle_ms


def read(run):
    return idle_ms(run, OPTIMIZER)
