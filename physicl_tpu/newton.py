"""Newtonian kinematics (reference: physicl/newton.py:3-16).

The reference updates every object with a per-object Python loop
(``obj.dr = obj.v * sim.dt; obj.r += obj.dr``). Here the whole population
advances in one fused elementwise transform over the ``(3, C)`` SoA arrays —
a single elementwise pass, no interpreter work, no host transfers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from physicl_tpu.engine import Object, Step, StepContext
from physicl_tpu.state import OBJ_PHOTON, SimState, mod_floor
from physicl_tpu.units import Measurement, raw_code_value

__all__ = ["NewtonianKinematicsStep", "AbsorbingBoundaryStep",
           "AbsorbingSphereStep",
           "ReflectingBoundaryStep", "PeriodicBoundaryStep",
           "ChargedObject", "LorentzForceStep", "generate_particle_state"]


def generate_particle_state(n, v=None, r=None, device=False, w=None) -> dict:
    """Bulk SoA massive-particle population — the generic-species
    counterpart of :func:`physicl_tpu.light.generate_photon_state` (no
    per-particle Python objects; feeds ``Simulation.add_particles``).
    Single-species bulk populations take the fused charged-particle path
    with :class:`LorentzForceStep(q_over_m=...)`.

    ``v``/``r``: (3,) or (3, n) [code units], default zero; ``w``: scalar or
    (n,) statistical weights. ``device=True`` builds the arrays with jnp on
    the accelerator (zero host staging at large N).
    """
    from physicl_tpu.light import generate_photon_state
    from physicl_tpu.state import OBJ_GENERIC

    out = generate_photon_state(
        n, E=0.0, v=(np.zeros(3) if v is None else v), r=r,
        device=device, w=w)
    out["otype"] = OBJ_GENERIC
    return out


class NewtonianKinematicsStep(Step):
    """Euler position update: ``dr = v * dt; r += dr`` for every object.

    Matches the reference exactly by default: position-only Euler, no
    acceleration integration (physicl/newton.py:14-16). Passing
    ``integrate_acceleration=True`` enables a semi-implicit (symplectic)
    Euler extension that also integrates ``state.a``:
    ``dv = a*dt; v += dv; dr = v*dt; r += dr`` (no reference counterpart —
    the reference stores ``a`` but never uses it).
    """

    def __init__(self, integrate_acceleration: bool = False):
        self.integrate_acceleration = integrate_acceleration

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        if self.integrate_acceleration:
            dv = state.a * state.dt
            v = state.v + dv
            dr = v * state.dt
            return state.replace(dv=dv, v=v, dr=dr, r=state.r + dr)
        dr = state.v * state.dt
        return state.replace(dr=dr, r=state.r + dr)


def _parse_bounds(bounds):
    """Accept the reference's ``sim.bounds`` 3-vector (box [0, b] per axis,
    physicl/__init__.py:412) or an explicit ((lo0,hi0),(lo1,hi1),(lo2,hi2));
    returns host (lo, hi) float64 3-vectors."""
    b = np.asarray(raw_code_value(bounds), np.float64)
    if b.shape == (3,):
        return np.zeros(3), b
    if b.shape == (3, 2):
        return b[:, 0], b[:, 1]
    raise ValueError("bounds must be (3,) or (3, 2)")


def _static_bounds(step, sim):
    """Host-side ((lo, hi) per axis) floats for the fused-plan prover."""
    lo, hi = _parse_bounds(step.bounds if step.bounds is not None
                           else sim.bounds)
    return tuple((float(lo[d]), float(hi[d])) for d in range(3))


def _bounds_arrays(bounds, dtype):
    lo, hi = _parse_bounds(bounds)
    return jnp.asarray(lo, dtype), jnp.asarray(hi, dtype)


class AbsorbingBoundaryStep(Step):
    """Deletes particles leaving the box (the behavior ``sim.bounds``
    suggests but the reference never implements — physicl/__init__.py:412
    stores it unused). ``bounds=None`` uses ``sim.bounds``."""

    def __init__(self, bounds=None):
        self.bounds = bounds
        self._sim_bounds = None

    def setup(self, sim) -> None:
        if self.bounds is None:
            self._sim_bounds = sim.bounds

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        b = self.bounds if self.bounds is not None else self._sim_bounds
        lo, hi = _bounds_arrays(b, state.r.dtype)
        inside = jnp.all((state.r >= lo[:, None]) & (state.r <= hi[:, None]),
                         axis=0)
        return state.replace(alive=state.alive & inside)


class ReflectingBoundaryStep(Step):
    """Specular reflection at the box walls: position folded back inside,
    velocity component flipped. ``bounds=None`` uses ``sim.bounds``."""

    def __init__(self, bounds=None):
        self.bounds = bounds
        self._sim_bounds = None

    def setup(self, sim) -> None:
        if self.bounds is None:
            self._sim_bounds = sim.bounds

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        b = self.bounds if self.bounds is not None else self._sim_bounds
        lo, hi = _bounds_arrays(b, state.r.dtype)
        lo, hi = lo[:, None], hi[:, None]
        # Triangle-wave fold: maps ANY overshoot (even > one box width, i.e.
        # multiple wall bounces in one dt) back inside [lo, hi]. y in [0, 2L)
        # parameterizes one full reflection period; the descending half
        # (y > L) is a position reflected an odd number of times, so the
        # velocity component flips there.
        L = hi - lo
        y = mod_floor(state.r - lo, 2 * L)
        odd = y > L
        r = lo + jnp.where(odd, 2 * L - y, y)
        outside = (state.r > hi) | (state.r < lo)
        v = jnp.where(outside & odd, -state.v, state.v)
        r = jnp.where(outside, r, state.r)
        # keep dr consistent with the folded position (same-iteration
        # plane-crossing tests compute the segment as [r - dr, r]); the
        # straight old->folded segment approximates the multi-leg bounce path
        dr = r - (state.r - state.dr)
        return state.replace(r=r, dr=dr, v=v)


class ChargedObject(Object):
    """A charged massive particle: requires charge ``q`` and mass ``m``
    (Measurements or raw code-unit scalars). Convenience constructor for
    :class:`LorentzForceStep`'s per-particle ``q/m`` mode — the attributes
    land in ``state.extras['q']/['m']`` like any extra Object kwarg
    (reference Objects accept arbitrary kwargs, physicl/__init__.py:395-396;
    charge dynamics itself is a extension — the reference stores ``a``
    but integrates no forces)."""

    def __init__(self, **kwargs):
        if "q" not in kwargs or "m" not in kwargs:
            raise ValueError("ChargedObject requires q= and m=")
        if float(raw_code_value(kwargs["m"])) <= 0.0:
            raise ValueError("ChargedObject mass must be positive")
        super().__init__(**kwargs)


def _field_fn(field, name):
    """Normalize a field spec: a 3-vector constant (Measurement or raw) or a
    callable ``(rx, ry, rz) -> (3-seq of arrays)``; None = zero field.
    Returns ``(callable over the (3, C) position planes or None,
    static 3-tuple or None)`` — the static form lets the fused-plan prover
    fold constant fields as scalars (callables cap the kernel unroll)."""
    if field is None:
        return None, None
    if callable(field):
        return field, None
    try:
        vec = np.asarray(raw_code_value(field), np.float64).reshape(3)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"{name} must be a 3-vector (Measurement or raw) or a callable "
            f"(rx, ry, rz) -> 3 arrays; got {field!r}") from e

    def const(rx, ry, rz):
        one = jnp.ones_like(rx)
        return (vec[0] * one, vec[1] * one, vec[2] * one)

    return const, tuple(float(x) for x in vec)


class LorentzForceStep(Step):
    """Charged-particle dynamics in electromagnetic fields via the Boris
    pusher (extension; the reference integrates no forces — its ``a``
    attribute is stored unused, physicl/__init__.py:392).

    Velocity update for ``F = q (E + v x B)`` with the standard Boris
    half-accelerate / rotate / half-accelerate split — the workhorse of
    particle-in-cell codes because the magnetic rotation conserves ``|v|``
    EXACTLY (no secular energy drift on gyro-orbits, unlike RK/Euler):

    ``h = (q/m) dt / 2;  v- = v + h E``
    ``t = h B;  v' = v- + v- x t;  v+ = v- + v' x 2t/(1+|t|^2)``
    ``v_new = v+ + h E``

    The discrete gyro-phase advance per step is ``2 atan(h |B|)`` (exact
    rotation, frequency within O((w dt)^2) of ``w = qB/m``). Pair with
    :class:`NewtonianKinematicsStep` AFTER this step for the position
    update (velocity-then-position leapfrog ordering).

    ``E_field`` / ``B_field``: 3-vector constants (Measurements or raw code
    units) or callables ``(rx, ry, rz) -> 3-tuple`` for spatially varying
    fields (traced into the scan like ``variable_n_fn``). ``q_over_m``:
    a single charge-to-mass ratio for the whole species, or None to read
    per-particle ``q``/``m`` from Object kwargs
    (:class:`ChargedObject(q=, m=)`). Photons are never pushed; dead
    particles are never pushed. ``dv`` records the velocity change and
    ``a`` the effective acceleration ``dv/dt`` (so measurement steps and
    ``integrate_acceleration=False`` kinematics observe consistent state).

    Fused-path op (single-species populations): an all-generic population
    with UpdateTime + Lorentz + Kinematics (+ boundaries/measures) runs
    inside the fused Pallas kernel, same as photon transport — both with a
    species-wide ``q_over_m`` and with per-particle charge/mass
    (``q_over_m=None`` + :class:`ChargedObject(q=, m=)`), which packs a
    derived ``q/m`` plane alongside the core kernel state. One fused-path
    delta: the packed state carries no ``a`` plane, so ``state.a`` keeps
    its initial value after a fused run (``dv`` is maintained; divide by
    the final dt for the effective acceleration).
    """

    def __init__(self, E_field=None, B_field=None, q_over_m=None):
        self._e_fn, self._e_const = _field_fn(E_field, "E_field")
        self._b_fn, self._b_const = _field_fn(B_field, "B_field")
        if q_over_m is None:
            self.q_over_m = None
        else:
            if isinstance(q_over_m, Measurement):
                q_over_m = raw_code_value(q_over_m)
            try:
                self.q_over_m = float(q_over_m)
            except (TypeError, jax.errors.TracerArrayConversionError,
                    jax.errors.ConcretizationTypeError):
                # traced parameter: the differentiable functional path
                # (physicl_tpu.functional) fits q/m by jax.grad
                self.q_over_m = q_over_m

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        dtype = state.v.dtype
        if self.q_over_m is not None:
            qm = jnp.asarray(self.q_over_m, dtype)
        else:
            if "q" not in state.extras or "m" not in state.extras:
                raise ValueError(
                    "LorentzForceStep(q_over_m=None) needs per-particle "
                    "charge/mass: add objects with q= and m= kwargs "
                    "(newton.ChargedObject) or pass q_over_m=")
            m = state.extras["m"]
            qm = jnp.where(m != 0, state.extras["q"]
                           / jnp.where(m != 0, m, jnp.ones_like(m)), 0.0)
        push = state.alive & (state.otype != OBJ_PHOTON)
        h = 0.5 * qm * state.dt

        if self._e_fn is not None:
            ef = jnp.stack(jnp.broadcast_arrays(*[
                jnp.asarray(x, dtype) for x in
                self._e_fn(state.r[0], state.r[1], state.r[2])]))
            v = state.v + h * ef
        else:
            v = state.v
        if self._b_fn is not None:
            bf = [jnp.asarray(x, dtype) * h for x in
                  self._b_fn(state.r[0], state.r[1], state.r[2])]
            tx, ty, tz = bf
            # v' = v- + v- x t
            vpx = v[0] + (v[1] * tz - v[2] * ty)
            vpy = v[1] + (v[2] * tx - v[0] * tz)
            vpz = v[2] + (v[0] * ty - v[1] * tx)
            s = 2.0 / (1.0 + tx * tx + ty * ty + tz * tz)
            # v+ = v- + v' x s*t
            v = jnp.stack([
                v[0] + s * (vpy * tz - vpz * ty),
                v[1] + s * (vpz * tx - vpx * tz),
                v[2] + s * (vpx * ty - vpy * tx),
            ])
        if self._e_fn is not None:
            v = v + h * ef

        v_new = jnp.where(push, v, state.v)
        dv = v_new - state.v
        inv_dt = jnp.where(state.dt != 0, 1.0 / jnp.where(
            state.dt != 0, state.dt, jnp.ones_like(state.dt)), 0.0)
        return state.replace(v=v_new, dv=dv, a=dv * inv_dt)


class PeriodicBoundaryStep(Step):
    """Periodic (wrap-around) box: a particle leaving through one face
    re-enters through the opposite one, velocity unchanged — the standard
    infinite-medium idealization (no reference counterpart; its ``sim.bounds``
    is stored unused, physicl/__init__.py:412). ``bounds=None`` uses
    ``sim.bounds``. Handles overshoots of any number of box lengths in one
    dt. ``dr`` is left unchanged: the wrapped segment ``[r - dr, r]`` is the
    translated image of the true path, so same-iteration plane-crossing
    tests remain valid away from the wrap seam. Fused-path op."""

    def __init__(self, bounds=None):
        self.bounds = bounds
        self._sim_bounds = None

    def setup(self, sim) -> None:
        if self.bounds is None:
            self._sim_bounds = sim.bounds

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        b = self.bounds if self.bounds is not None else self._sim_bounds
        lo, hi = _bounds_arrays(b, state.r.dtype)
        lo, hi = lo[:, None], hi[:, None]
        L = hi - lo
        r = lo + mod_floor(state.r - lo, L)
        return state.replace(r=r)


class AbsorbingSphereStep(Step):
    """Deletes particles outside (default) or inside a sphere — escape
    spheres and central absorbers, the spherical counterpart of
    :class:`AbsorbingBoundaryStep` (extension; the reference has no
    geometry beyond the unused ``sim.bounds`` box).

    ``kill_inside=False`` (default): particles with ``|r - center| >
    radius`` die (an escape sphere / outer vacuum boundary).
    ``kill_inside=True``: particles entering the sphere die (a perfectly
    absorbing central body). Pair with
    :class:`physicl_tpu.light.SphericalShellMeasureStep` just inside the
    kill radius to tally the escape flux. Fuses (op kind "sabsorb").
    """

    def __init__(self, radius, center=(0.0, 0.0, 0.0),
                 kill_inside: bool = False):
        self.radius = float(raw_code_value(radius))
        if self.radius <= 0:
            raise ValueError(f"radius must be positive, got {self.radius}")
        self.center = tuple(
            float(x) for x in np.asarray(raw_code_value(center),
                                         np.float64).reshape(3))
        self.kill_inside = bool(kill_inside)

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        dtype = state.r.dtype
        c = jnp.asarray(self.center, dtype)[:, None]
        d = state.r - c
        inside = jnp.sum(d * d, axis=0) <= jnp.asarray(
            self.radius * self.radius, dtype)
        keep = jnp.logical_not(inside) if self.kill_inside else inside
        return state.replace(alive=state.alive & keep)
