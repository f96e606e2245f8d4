"""The port's learning-rate schedulers against the JAX package's.

Every scheduler of `paddle_tpu_torch.optimizer.lr` is built with the same
arguments as its `paddle_tpu.optimizer.lr` twin and stepped through the
same sequence (`step()`, `step(epoch)`, and `step(metrics)` for
ReduceOnPlateau): `get_lr()` must equal the JAX one exactly at every
point, the arithmetic being the same host-side floats. A `state_dict`
taken midway restores into a fresh scheduler that then continues as the
JAX one does. Then the optimizer: `AdamW(learning_rate=sched)` reads
`get_lr()` once per `step()` (a step under a scheduler equals, bit for
bit, a step of a constant-rate optimizer at the rate the scheduler gave),
`set_lr` raises under a scheduler as in JAX, a foreign object is refused,
and the optimizer's `state_dict` carries ``"lr_scheduler"`` and
``"step"``. Also the port's counterparts of tests/test_optimizer.py::
test_lr_scheduler (on AdamW: the port has no SGD) and test_cosine_warmup.
"""

import math

import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import AdamW, lr

torch.set_num_threads(1)


def _cases(mod):
    """(name, constructor) of every scheduler, built the same way in both
    packages (``mod`` is either lr module)."""
    return {
        "step": lambda: mod.StepDecay(0.1, step_size=3, gamma=0.5),
        "multistep": lambda: mod.MultiStepDecay(0.2, [2, 5, 6], gamma=0.3),
        "exponential": lambda: mod.ExponentialDecay(0.1, gamma=0.9),
        "natural_exp": lambda: mod.NaturalExpDecay(0.1, gamma=0.25),
        "inverse_time": lambda: mod.InverseTimeDecay(0.3, gamma=0.7),
        "polynomial": lambda: mod.PolynomialDecay(0.1, decay_steps=5,
                                                  end_lr=0.01, power=2.0),
        "polynomial_cycle": lambda: mod.PolynomialDecay(
            0.1, decay_steps=4, end_lr=0.0, power=1.5, cycle=True),
        "cosine": lambda: mod.CosineAnnealingDecay(0.1, T_max=7,
                                                   eta_min=0.001),
        "noam": lambda: mod.NoamDecay(d_model=64, warmup_steps=4,
                                      learning_rate=2.0),
        "warmup_const": lambda: mod.LinearWarmup(0.05, warmup_steps=3,
                                                 start_lr=0.0, end_lr=0.1),
        "warmup_cosine": lambda: mod.LinearWarmup(
            mod.CosineAnnealingDecay(2e-4, T_max=10, eta_min=2e-5),
            warmup_steps=4, start_lr=0.0, end_lr=2e-4),
        "lambda": lambda: mod.LambdaDecay(0.5, lambda e: 0.95 ** e + 0.1),
    }


CASES = sorted(_cases(lr))
# a step sequence: plain steps, then jumps to explicit epochs and back
STEPS = [None] * 9 + [12, None, 3, None, None, 20, None]


@pytest.mark.parametrize("name", CASES)
def test_scheduler_sequence_equals_jax(name):
    ours, ref = _cases(lr)[name](), _cases(jlr)[name]()
    seq = [(ours.get_lr(), ref.get_lr())]
    for epoch in STEPS:
        ours.step(epoch)
        ref.step(epoch)
        seq.append((ours.get_lr(), ref.get_lr()))
    assert [a for a, _ in seq] == [b for _, b in seq]
    assert ours.last_epoch == ref.last_epoch
    assert len({a for a, _ in seq}) > 1


@pytest.mark.parametrize("name", CASES)
def test_scheduler_state_dict_round_trip(name):
    ours, ref = _cases(lr)[name](), _cases(jlr)[name]()
    for _ in range(5):
        ours.step()
        ref.step()
    state = ours.state_dict()
    assert state == ref.state_dict()
    resumed = _cases(lr)[name]()
    resumed.set_state_dict(state)
    assert resumed.get_lr() == ref.get_lr()
    for _ in range(4):
        resumed.step()
        ref.step()
        assert resumed.get_lr() == ref.get_lr()


METRICS = [5.0, 4.0, 4.0, 4.5, 4.2, 4.1, 4.0, 3.0, 3.0, 3.1, 3.2, 3.3, 3.0,
           2.0]


@pytest.mark.parametrize("mode,kw", [
    ("min", dict(factor=0.5, patience=1)),
    ("min", dict(factor=0.1, patience=2, cooldown=2, min_lr=1e-3,
                 threshold=0.05)),
    ("max", dict(factor=0.5, patience=0)),
])
def test_reduce_on_plateau_equals_jax(mode, kw):
    ours = lr.ReduceOnPlateau(0.1, mode=mode, **kw)
    ref = jlr.ReduceOnPlateau(0.1, mode=mode, **kw)
    seq = []
    for i, m in enumerate(METRICS):
        if i % 5 == 4:                  # a step without a metric
            ours.step()
            ref.step()
        # a 0-d tensor metric in the port, a float in JAX
        ours.step(torch.tensor(m))
        ref.step(m)
        seq.append((ours.get_lr(), ref.get_lr(), ours.num_bad, ref.num_bad))
    assert [s[0] for s in seq] == [s[1] for s in seq]
    assert [s[2] for s in seq] == [s[3] for s in seq]
    assert ours.last_epoch == ref.last_epoch
    assert len({s[0] for s in seq}) > 1


def test_lr_scheduler():
    """tests/test_optimizer.py::test_lr_scheduler on the port's AdamW."""
    sched = lr.StepDecay(0.1, step_size=2, gamma=0.5)
    w = torch.ones(1, requires_grad=True)
    opt = AdamW(learning_rate=sched, parameters=[w])
    lrs = []
    for _ in range(5):
        lrs.append(opt.get_lr())
        sched.step()
    np.testing.assert_allclose(lrs, [0.1, 0.1, 0.05, 0.05, 0.025])


def test_cosine_warmup():
    """tests/test_optimizer.py::test_cosine_warmup on the port."""
    base = lr.CosineAnnealingDecay(0.1, T_max=10)
    warm = lr.LinearWarmup(base, warmup_steps=5, start_lr=0.0, end_lr=0.1)
    lrs = [warm.get_lr()]
    for _ in range(6):
        warm.step()
        lrs.append(warm.get_lr())
    assert lrs[0] == 0.0
    np.testing.assert_allclose(lrs[5], 0.1, rtol=1e-6)
    assert lrs[6] < 0.1


def _param_and_grads(seed=0, n=4):
    rng = np.random.default_rng(seed)
    p0 = rng.standard_normal((16, 8)).astype(np.float32)
    return p0, [rng.standard_normal(p0.shape).astype(np.float32)
                for _ in range(n)]


def test_optimizer_reads_the_schedule_once_per_step():
    """Each step of AdamW(learning_rate=sched) equals, bit for bit, the
    step of an AdamW whose constant rate is set to what the scheduler
    gives before that step (the caller steps the scheduler)."""
    p0, grads = _param_and_grads()
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(0.1, T_max=5,
                                                    eta_min=0.01),
                            warmup_steps=2, start_lr=0.0, end_lr=0.1)
    a = torch.from_numpy(p0.copy())
    b = torch.from_numpy(p0.copy())
    sched_opt = AdamW(learning_rate=sched, parameters=[a],
                      weight_decay=0.1)
    const_opt = AdamW(learning_rate=1.0, parameters=[b], weight_decay=0.1)
    seen = []
    for g in grads:
        rate = sched.get_lr()
        seen.append(rate)
        const_opt.set_lr(rate)
        a.grad, b.grad = torch.from_numpy(g), torch.from_numpy(g.copy())
        sched_opt.step()
        const_opt.step()
        assert sched_opt.param_groups[0]["lr"] == rate
        assert torch.equal(a, b)
        sched.step()
    assert seen[0] == 0.0 and seen[2] == pytest.approx(0.1)
    assert not np.array_equal(a.numpy(), p0)


def test_set_lr_raises_under_a_scheduler_and_foreign_rates_are_refused():
    w = torch.ones(3, requires_grad=True)
    opt = AdamW(learning_rate=lr.StepDecay(0.1, 2), parameters=[w])
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.5)
    const = AdamW(learning_rate=0.1, parameters=[w])
    const.set_lr(0.5)
    assert const.get_lr() == 0.5
    # the JAX package's scheduler is not the port's
    with pytest.raises(TypeError, match="LRScheduler"):
        AdamW(learning_rate=jlr.StepDecay(0.1, 2), parameters=[w])


def test_optimizer_state_dict_carries_the_scheduler():
    p0, grads = _param_and_grads(1, 3)
    sched = lr.ExponentialDecay(0.05, gamma=0.8)
    w = torch.from_numpy(p0.copy())
    opt = AdamW(learning_rate=sched, parameters=[w])
    for g in grads:
        w.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
    sd = opt.state_dict()
    assert sd["step"] == 3
    assert sd["lr_scheduler"] == {"last_epoch": 3,
                                  "last_lr": 0.05 * 0.8 ** 3}
    w2 = torch.from_numpy(p0.copy())
    sched2 = lr.ExponentialDecay(0.05, gamma=0.8)
    opt2 = AdamW(learning_rate=sched2, parameters=[w2])
    opt2.set_state_dict(sd)
    assert opt2._step_i == 3 and sched2.last_epoch == 3
    assert math.isclose(opt2.get_lr(), opt.get_lr())
    assert torch.equal(opt2.state[w2]["moment1"], opt.state[w]["moment1"])
