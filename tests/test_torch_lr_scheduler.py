"""``mx.lr_scheduler`` in the port against the JAX build: every scheduler's
value at updates 0-100 is equal, and an optimizer drives it by its update
count."""
import pickle

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

SCHEDULERS = [
    ("FactorScheduler", dict(step=7, factor=0.5, stop_factor_lr=1e-3)),
    ("FactorScheduler", dict(step=1, factor=0.9)),
    ("MultiFactorScheduler", dict(step=[2, 4], factor=0.1)),
    ("MultiFactorScheduler", dict(step=[10, 35, 60], factor=0.3)),
    ("PolyScheduler", dict(max_update=80, base_lr=0.2, pwr=2)),
    ("PolyScheduler", dict(max_update=50, pwr=0.5)),
    ("CosineScheduler", dict(max_update=90, base_lr=0.3, final_lr=0.01)),
    ("CosineScheduler", dict(max_update=60, base_lr=0.1, warmup_steps=12,
                             warmup_begin_lr=0.001)),
]


@pytest.mark.parametrize("name,kwargs", SCHEDULERS, ids=[
    "%s-%d" % (n, i) for i, (n, _) in enumerate(SCHEDULERS)])
def test_schedule_matches_jax(name, kwargs):
    got = getattr(tmx.lr_scheduler, name)(**kwargs)
    want = getattr(jmx.lr_scheduler, name)(**kwargs)
    if name in ("FactorScheduler", "MultiFactorScheduler"):
        got.base_lr = want.base_lr = 0.05
    assert [got(t) for t in range(101)] == [want(t) for t in range(101)]
    again = pickle.loads(pickle.dumps(got))
    assert [again(t) for t in range(101)] == [want(t) for t in range(101)]


@pytest.mark.parametrize("name,kwargs", [
    ("FactorScheduler", dict(step=0)),
    ("FactorScheduler", dict(step=2, factor=1.5)),
    ("MultiFactorScheduler", dict(step=[3, 3])),
    ("MultiFactorScheduler", dict(step=[])),
    ("PolyScheduler", dict(max_update=0)),
])
def test_invalid_schedules_raise_as_in_jax(name, kwargs):
    for pkg in (tmx, jmx):
        with pytest.raises(ValueError):
            getattr(pkg.lr_scheduler, name)(**kwargs)


def test_optimizer_drives_the_schedule_by_update_count():
    """SGD's learning rate follows the scheduler at its update count, with
    ``base_lr`` set to the optimizer's learning rate."""
    sched = tmx.lr_scheduler.MultiFactorScheduler(step=[2, 4], factor=0.1)
    opt = tmx.optimizer.create("sgd", learning_rate=0.1, lr_scheduler=sched)
    assert sched.base_lr == 0.1
    w = tmx.nd.array(np.ones(3, np.float32), ctx=tmx.cpu())
    g = tmx.nd.array(np.ones(3, np.float32), ctx=tmx.cpu())
    seen = []
    for _ in range(6):
        opt.update(0, w, g, None)
        seen.append(opt._get_lr(0))
    np.testing.assert_allclose(seen, [0.1, 0.1, 0.01, 0.01, 0.001, 0.001],
                               rtol=1e-12)
