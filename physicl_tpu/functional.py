"""Differentiable functional driver: the step pipeline as a pure function.

``scan_steps`` runs the same ``Step.apply`` transforms the engine scans,
but as a plain ``(state, key) -> (state, records)`` function with no
threads, no host loop, and no device-side effects — so the whole
simulation composes with ``jax.jit``, ``jax.grad``, ``jax.vmap``, and
``jax.lax`` like any other JAX program. This is a capability
with no reference counterpart (the reference's host loop mutates Python
objects; physicl/__init__.py:501-524): transport becomes a differentiable
model whose physics parameters can be *fit* by gradient descent.

What is differentiable: any observable that is a smooth function of the
parameters. In Monte Carlo transport that means **implicit-capture
weighted transport** (``ScatterDeleteStep(implicit_capture=True)`` without
roulette): the statistical weight decays deterministically as
``w *= 1 - min(pcoll, 1)``, so transmission/deposition curves are exact,
draw-free, and smooth in the cross-section parameters. Analog kills and
roulette are discrete events — their gradients are zero almost everywhere
and should not be differentiated through (document of record:
docs/api.md).

Pass step parameters as traced values (``jax.grad`` arguments used to
construct the steps inside the differentiated function): the step
constructors keep tracers intact (``light._as_code``).

Example — fit an absorption cross-section to a measured transmission::

    def transmission(A):
        steps = [phys.UpdateTimeStep(lambda x: 1e-3),
                 newton.NewtonianKinematicsStep(),
                 light.ScatterDeleteStep(n=1.0, A=A, implicit_capture=True)]
        out = functional.scan_steps(steps, state0, n_iters=200)
        return jnp.sum(out.w * out.alive) / n_photons

    g = jax.grad(transmission)(A0)   # exact dT/dA
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from physicl_tpu.engine import Step, StepContext
from physicl_tpu.state import SimState

__all__ = ["scan_steps", "FunctionalSim"]


class FunctionalSim:
    """Minimal stand-in for ``Simulation`` handed to ``Step.setup``/user
    lambdas on the functional path: carries only the host-side attributes
    steps read (``bounds``, ``seed``). No thread, no device plumbing."""

    def __init__(self, bounds=None, seed: int = 0):
        self.bounds = np.zeros(3) if bounds is None else bounds
        self.seed = seed


def scan_steps(steps: List[Step], state: SimState, n_iters: int,
               key=None, sim: Optional[object] = None,
               record: bool = False, remat: bool = False):
    """Apply ``steps`` (in list order — reference insertion-order
    semantics) for ``n_iters`` iterations via one ``lax.scan``; pure and
    transformable (jit / grad / vmap / checkpoint).

    ``key``: a jax PRNG key or an int seed; default is ``sim.seed`` when a
    sim shim is given (so ``FunctionalSim(seed=7)`` actually seeds the
    scan), else 0. ``sim``: optional :class:`FunctionalSim` (or a real
    Simulation) for steps whose setup reads host attributes like
    ``bounds``. With ``record=True`` returns
    ``(state, records)`` where records is a dict of per-iteration stacked
    arrays keyed ``"s{i}/{name}"`` in step order (e.g. the alive counts a
    measure step logs); otherwise returns the final state.

    Gradients: differentiate smooth observables only (implicit-capture
    weights, positions/velocities under deterministic dynamics). Discrete
    events (analog kills, roulette, plane-crossing counts) have
    zero-almost-everywhere derivatives.

    ``remat=True`` wraps the scan body in ``jax.checkpoint``: reverse-mode
    residuals shrink from O(n_iters x intermediates) to O(n_iters x state)
    by recomputing each iteration's forward pass during the backward sweep
    — the standard memory/FLOPs trade for long-horizon gradients.
    """
    shim = sim if sim is not None else FunctionalSim()
    if key is None:
        key = jax.random.PRNGKey(int(getattr(shim, "seed", 0) or 0))
    elif isinstance(key, int):
        key = jax.random.PRNGKey(int(key))
    for i, s in enumerate(steps):
        s._step_uid = f"s{i}"
        s.setup(shim)

    def body(carry, _):
        st, k = carry
        k, ik = jax.random.split(k)
        ctx = StepContext(ik, shim)
        for s in steps:
            st = s.apply(st, ctx)
        return (st, k), (ctx.records if record else None)

    if remat:
        body = jax.checkpoint(body)
    (state, _), recs = jax.lax.scan(body, (state, key), None,
                                    length=int(n_iters))
    return (state, recs) if record else state
