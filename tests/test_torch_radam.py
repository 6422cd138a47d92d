"""The port's RAdam (``train/state.py``) against ``optax.radam``.

``make_radam`` of both packages (b1=0, b2=0.999, eps=1e-8, threshold=5) over
15 steps of seeded gradients, which crosses ``rho_t >= 5`` at step 6, with a
constant learning rate and with the staircase decay. The JAX update runs
under ``jax.jit``, as in the JAX train step: eager JAX evaluates
``b2 ** count`` by another route, one f32 ulp off, which the cancellation in
``1 - b2**t`` amplifies to ~1 % of the rectification factor near
``rho_t = 5``. Bound: parameters atol 1e-7 + rtol 1e-6 after every step
(the same f32 formulas; the per-step scalars may differ in their last bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ess_tpu.train.state import apply_updates as jax_apply
from ess_tpu.train.state import make_radam as jax_radam

from ess_tpu_torch.train.state import RAdam, apply_updates, make_radam


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    from tests.test_torch_loop import one_torch_thread
    yield from one_torch_thread()


STEPS = 15


def rho(t, b2=0.999):
    rho_inf = 2 / (1 - b2) - 1
    return rho_inf - 2 * t * b2 ** t / (1 - b2 ** t)


@pytest.mark.parametrize("lr_decay,steps_per_epoch", [(1.0, 1), (0.5, 4),
                                                      (0.9, 1)])
def test_radam_matches_optax(lr_decay, steps_per_epoch):
    assert rho(5) < 5 <= rho(6)
    rng = np.random.default_rng(int(lr_decay * 10) + steps_per_epoch)
    init = {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-3, 2))
              .astype(np.float32) for k, v in init.items()}
             for _ in range(STEPS)]
    lr = 1e-2

    opt_j = jax_radam(lr, lr_decay=lr_decay, steps_per_epoch=steps_per_epoch)
    update_j = jax.jit(lambda p, g, s: jax_apply(p, g, opt_j, s))
    pj = {k: jnp.asarray(v) for k, v in init.items()}
    sj = opt_j.init(pj)
    pt = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt_t = make_radam(list(pt.values()), lr, lr_decay=lr_decay,
                       steps_per_epoch=steps_per_epoch)
    assert isinstance(opt_t, RAdam)
    for t, g in enumerate(grads, start=1):
        pj, sj = update_j(pj, {k: jnp.asarray(v) for k, v in g.items()}, sj)
        apply_updates(list(pt.values()),
                      [torch.from_numpy(g[k]) for k in pt], opt_t)
        assert opt_t.step_count == t
        for k in init:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} at step {t}")


def test_radam_skips_parameters_without_grad():
    p, q = torch.ones(3), torch.ones(2)
    opt = make_radam([p, q], 0.1)
    p.grad = torch.full((3,), 2.0)
    opt.step()
    assert torch.equal(q, torch.ones(2))
    # step 1: rho_1 = 1 < 5, so the update is the bias-corrected moment
    torch.testing.assert_close(p, torch.full((3,), 1.0 - 0.1 * 2.0))
