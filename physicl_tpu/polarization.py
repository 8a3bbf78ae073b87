"""Polarized photon transport: Stokes-vector Rayleigh/Thomson scattering.

extension with no reference counterpart (the reference's scattering is
scalar-intensity only, physicl/light.py:262-359); this module adds the full
Stokes formalism on top of the same collision model so polarization
observables (sky polarization, scattering-induced polarization degrees,
circular-polarization transfer) come out of the same transport loop.

Design
------
Each photon carries two extra per-particle planes in ``SimState.extras``:

* ``"stokes"`` — ``(3, C)`` normalized Stokes components ``(Q, U, V)`` with
  ``I = 1`` (intensity rides the statistical weight ``w``, the standard
  polarized-MC normalization);
* ``"pol_ref"`` — ``(3, C)`` unit vector perpendicular to ``v`` defining the
  local frame: ``Q > 0`` means linear polarization along ``pol_ref``. The
  frame basis is right-handed ``(e1, e2, d)`` with ``e1 = pol_ref``,
  ``d = v/|v|``, ``e2 = d x e1``.

A Rayleigh/Thomson scatter through polar angle ``theta`` (``c = cos theta``)
and azimuth ``phi`` (measured from ``e1`` toward ``e2``) applies the dipole
Mueller matrix in the scattering-plane frame::

    I' = (1+c^2)/2 + (c^2-1)/2 * Q_r        Q_r = Q cos2phi + U sin2phi
    Q' = (c^2-1)/2 + (1+c^2)/2 * Q_r        U_r = U cos2phi - Q sin2phi
    U' = c * U_r
    V' = c * V_r                            V_r = V

and the outgoing Stokes vector is renormalized to ``I = 1``. The angles are
drawn EXACTLY from the polarized intensity ``p(theta, phi) ∝ I'(theta,
phi)``: the ``theta`` marginal is the unpolarized dipole phase function
(closed-form Cardano inverse CDF, shared with
:class:`physicl_tpu.light.ScatterRayleighStep`), and ``phi | theta`` has
density ``(1 + a cos2phi + b sin2phi) / 2pi`` with ``a = r(theta) Q``,
``b = r(theta) U``, ``r = (c^2-1)/(1+c^2)``, inverted by monotone bisection.
This is unbiased with NO weight change: the sampled-intensity factor
cancels against the Stokes renormalization (standard polarized MC, cf.
Chandrasekhar's Rayleigh phase matrix).

Two scatter families share the formalism: :class:`ScatterPolarizedRayleighStep`
(Thomson/Rayleigh, the dipole matrix) and :class:`ScatterPolarizedComptonStep`
(Compton off cold electrons — Klein-Nishina angles, the Fano/McMaster phase
matrix, and the E' = E/eta recoil; the dipole matrix is its kappa = 2 limit).

All the steps run on the FUSED Pallas path: the Stokes and frame triples pack
as six writable extras planes after the 15 core ones (``FusedPlan.extras``
+ ``extras_writeback``), the dipole-marginal theta draw shares the "rayl"
op's Cardano closed form, and the azimuth bisection runs in-kernel on
rotation recurrences with compile-time trig constants (ops/fused.py
``_bisect_phi_sincos`` — zero in-loop transcendentals). The generic jitted
scan remains the oracle twin for differential tests, and every other
feature — mesh sharding, checkpointing, measurement records, population
injection — works unchanged on either path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from physicl_tpu.engine import MeasureStep, Simulation, Step, StepContext
from physicl_tpu.light import (ScatterIsotropicStep, _as_code,
                               _compile_variable_n, _dr_norm,
                               _rayleigh_cos_theta, generate_photon_state)
from physicl_tpu.state import OBJ_PHOTON, SimState
from physicl_tpu.units import raw_code_value

__all__ = [
    "polarized_photon_state",
    "ScatterPolarizedRayleighStep",
    "ScatterPolarizedComptonStep",
    "StokesMeasureStep",
]

_MISSING_PLANES_MSG = (
    "population carries no Stokes planes: build it with "
    "physicl_tpu.polarization.polarized_photon_state(...) (extras "
    "'stokes' (3,n) and 'pol_ref' (3,n)) instead of generate_photon_state"
)


def _perp_candidate(d, xp):
    """Elementwise unit vector guaranteed non-parallel to ``d``: z-hat where
    |dz| < 0.9, else y-hat."""
    use_z = xp.abs(d[2]) < 0.9
    zero = xp.zeros_like(d[0])
    one = xp.ones_like(d[0])
    return (zero,
            xp.where(use_z, zero, one),
            xp.where(use_z, one, zero))


def _orthonormal_ref(d, ref, xp, eps=1e-12):
    """Project ``ref`` perpendicular to unit direction ``d`` and normalize;
    returns (e1, norm-before-normalization) so callers can detect a
    degenerate (parallel/zero) reference."""
    dot = d[0] * ref[0] + d[1] * ref[1] + d[2] * ref[2]
    p = tuple(ref[i] - dot * d[i] for i in range(3))
    n = xp.sqrt(p[0] ** 2 + p[1] ** 2 + p[2] ** 2)
    safe = xp.maximum(n, eps)
    return tuple(p[i] / safe for i in range(3)), n


def polarized_photon_state(n, E, v=None, r=None, w=None,
                           stokes=(0.0, 0.0, 0.0), pol_ref=None,
                           device: bool = False) -> dict:
    """Bulk photon population carrying Stokes planes — the polarized
    counterpart of :func:`physicl_tpu.light.generate_photon_state` (same
    core arguments and device fast path).

    ``stokes``: ``(3,)`` or ``(3, n)`` normalized ``(Q, U, V)`` components
    (degree of polarization ``sqrt(Q^2+U^2+V^2) <= 1``; the default is
    unpolarized). ``pol_ref``: ``(3,)`` or ``(3, n)`` reference direction
    for ``Q > 0`` — it is projected perpendicular to each photon's ``v``
    and normalized (error if parallel). Default: z-hat where possible,
    y-hat for photons flying along z.
    """
    bulk = generate_photon_state(n, E, v=v, r=r, device=device, w=w)
    xp = jnp if device else np
    n = int(n)
    vv = bulk["v"] if device else np.asarray(bulk["v"], np.float64)
    inv = 1.0 / xp.sqrt(vv[0] ** 2 + vv[1] ** 2 + vv[2] ** 2)
    d = tuple(vv[i] * inv for i in range(3))

    st = xp.asarray(raw_code_value(stokes), xp.float32 if device
                    else np.float64)
    st = xp.broadcast_to(st.reshape(3, -1), (3, n))
    deg = st[0] ** 2 + st[1] ** 2 + st[2] ** 2
    if not device and float(np.max(deg)) > 1.0 + 1e-6:
        raise ValueError(
            f"degree of polarization sqrt(Q^2+U^2+V^2) must be <= 1, got "
            f"max {float(np.max(deg)) ** 0.5:.6f}")

    if pol_ref is None:
        ref = _perp_candidate(d, xp)
    else:
        pr = xp.asarray(raw_code_value(pol_ref), xp.float32 if device
                        else np.float64)
        pr = xp.broadcast_to(pr.reshape(3, -1), (3, n))
        ref = (pr[0], pr[1], pr[2])
    e1, norm = _orthonormal_ref(d, ref, xp)
    if pol_ref is not None and not device and float(np.min(norm)) < 1e-6:
        raise ValueError(
            "pol_ref is (near-)parallel to v for at least one photon; the "
            "Q-axis must have a component perpendicular to the flight "
            "direction")
    bulk.setdefault("extras", {})
    bulk["extras"]["stokes"] = (jnp.stack(
        [jnp.asarray(x, jnp.float32) for x in (st[0], st[1], st[2])])
        if device else np.asarray(st, np.float64))
    bulk["extras"]["pol_ref"] = (jnp.stack(
        [jnp.asarray(x, jnp.float32) for x in e1])
        if device else np.stack([np.asarray(x, np.float64) for x in e1]))
    return bulk


def _bisect_phi(u, a, b, iters: int = 26):
    """Invert the conditional-azimuth CDF
    ``F(phi) = (phi + (a/2) sin2phi + (b/2)(1 - cos2phi)) / 2pi`` for
    ``F(phi) = u`` by monotone bisection on [0, 2pi] (F' = pdf >= 0;
    26 halvings resolve phi to 2pi * 2^-26 ≈ 1e-7). Branch-free, exact
    ``phi = 2pi u`` in the unpolarized a = b = 0 limit."""
    two_pi = 2.0 * np.pi
    target = u * two_pi

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        f = mid + 0.5 * a * jnp.sin(2.0 * mid) \
            + 0.5 * b * (1.0 - jnp.cos(2.0 * mid))
        go_hi = f < target
        return (jnp.where(go_hi, mid, lo), jnp.where(go_hi, hi, mid))

    lo, hi = jax.lax.fori_loop(
        0, iters, body, (jnp.zeros_like(u), jnp.full_like(u, two_pi)))
    return 0.5 * (lo + hi)


class ScatterPolarizedRayleighStep(Step):
    """Rayleigh/Thomson scattering with the FULL Stokes phase matrix (see
    the module docstring for the formalism). Same collision model as the
    scalar family: ``pcoll = A * n(r) * |dr|`` with the inclusive ``>=``
    test, optional ``wavelength_dep_scattering`` (the physical lambda^-4
    Rayleigh cross-section) and ``variable_n`` / ``variable_n_fn``.

    Requires a population built by :func:`polarized_photon_state` (raises
    an instructive error otherwise). Thomson scattering off free electrons
    uses the identical phase matrix — set ``A`` to the Thomson cross
    section and this step covers both regimes.

    Updates per scattering photon: direction (exact polarized angular
    distribution), ``dv = v_new - v_old``, the normalized Stokes vector,
    and the frame vector ``pol_ref`` (re-orthonormalized against the new
    direction each scatter, so f32 drift never accumulates). Statistical
    weights are untouched — the phase-matrix intensity factor cancels
    against the Stokes renormalization exactly.

    Fused-path step: the planner packs the Stokes/frame triples as
    writable kernel planes (op kind ``"pol"``); populations built without
    :func:`polarized_photon_state` get the structured
    ``polarization-planes`` refusal and the generic path's instructive
    error. This apply() is the generic/oracle twin (identical physics,
    jax.random stream instead of the kernel PRNG).
    """

    _ALLOWED = {"n", "A", "wavelength_dep_scattering", "variable_n",
                "variable_n_fn"}

    def __init__(self, **kwargs):
        unknown = set(kwargs) - self._ALLOWED
        if unknown:
            raise ValueError(
                f"unknown option(s) {sorted(unknown)}; supported: "
                f"{sorted(self._ALLOWED)}")
        self.n = _as_code(kwargs.get("n", 1))
        self.A = _as_code(kwargs.get("A", 1))
        self.wavelength_dep_scattering = kwargs.get(
            "wavelength_dep_scattering", False)
        self.variable_n = kwargs.get("variable_n", False)
        self.variable_n_fn = kwargs.get("variable_n_fn", None)
        self._n_fn = (_compile_variable_n(self.variable_n_fn)
                      if self.variable_n else None)
        self._c = None
        self._coef = None
        self._wl_base = None

    # pcoll folding is identical to the scalar scatter family
    setup = ScatterIsotropicStep.setup

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        if self._c is None:
            self.setup(None)
        if "stokes" not in state.extras or "pol_ref" not in state.extras:
            raise ValueError(_MISSING_PLANES_MSG)
        dtype = state.r.dtype
        norm = _dr_norm(state)
        pcoll = jnp.asarray(self._coef, dtype) * norm
        if self._n_fn is not None:
            pcoll = pcoll * jnp.asarray(
                self._n_fn(state.r[0], state.r[1], state.r[2]), dtype)
        if self._wl_base is not None:
            base = state.E * jnp.asarray(self._wl_base, dtype)
            base2 = base * base
            pcoll = pcoll * (base2 * base2)

        k = ctx.next_key()
        u3 = jax.random.uniform(k, (3,) + norm.shape, dtype)
        scatter = (pcoll >= u3[0]) & (state.otype == OBJ_PHOTON) & state.alive

        # theta from the dipole marginal (the Thomson limit of the Fano
        # matrix: kappa = 2); phi | theta and the Stokes/frame/direction
        # update in the shared phase-matrix core
        cos_t = _rayleigh_cos_theta(u3[1], dtype)
        v_out, dv, st_out, pr_out = _apply_phase_matrix(
            state, scatter, cos_t, u3[2], jnp.asarray(2.0, dtype),
            self._c, dtype)
        extras = dict(state.extras)
        extras["stokes"] = st_out
        extras["pol_ref"] = pr_out
        return state.replace(v=v_out, dv=dv, extras=extras)


def _apply_phase_matrix(state, scatter, cos_t, u_phi, kappa, c_speed,
                        dtype):
    """Shared polarized-scatter core: given the sampled scattering cosine
    and the Compton energy-ratio sum ``kappa = E/E' + E'/E`` (== 2 in the
    Thomson/Rayleigh limit), draw ``phi | theta`` from the exact
    conditional ``1 + a cos2phi + b sin2phi`` with ``a = r Q``, ``b = r U``,
    ``r = -sin^2 theta / (kappa - sin^2 theta)``, apply the Fano phase
    matrix in the scattering-plane frame::

        I' = (kappa - s2) -       s2  * Q_r        (s2 = sin^2 theta)
        Q' =         -s2  + (1 + c^2) * Q_r
        U' =                   2 cos  * U_r
        V' =               kappa cos  * V_r

    (Thomson limit kappa = 2 reduces every row to the dipole Mueller
    matrix), renormalize to I = 1 with the over-purity clamp, and rotate
    the direction and frame. Returns ``(v_out, dv, st_out, pr_out)``; the
    caller handles the energy recoil (Compton) and writes extras."""
    # local right-handed frame (e1, e2, d); re-orthonormalize e1 and fall
    # back to a fresh perpendicular where the stored reference is
    # degenerate (e.g. zero-filled slots from an unpolarized injection)
    inv_v = jax.lax.rsqrt(jnp.maximum(
        jnp.sum(state.v * state.v, axis=0), jnp.asarray(1e-30, dtype)))
    d = tuple(state.v[i] * inv_v for i in range(3))
    st = state.extras["stokes"]
    pr = state.extras["pol_ref"]
    e1, e1n = _orthonormal_ref(d, (pr[0], pr[1], pr[2]), jnp, eps=1e-20)
    cand = _perp_candidate(d, jnp)
    fb, _ = _orthonormal_ref(d, cand, jnp, eps=1e-20)
    degen = e1n < 1e-4
    e1 = tuple(jnp.where(degen, fb[i], e1[i]) for i in range(3))
    e2 = (d[1] * e1[2] - d[2] * e1[1],
          d[2] * e1[0] - d[0] * e1[2],
          d[0] * e1[1] - d[1] * e1[0])

    q, u_st, v_st = st[0], st[1], st[2]
    c2 = cos_t * cos_t
    s2_ = 1.0 - c2
    r_t = -s2_ / (kappa - s2_)
    phi = _bisect_phi(u_phi, r_t * q, r_t * u_st)
    cos_p, sin_p = jnp.cos(phi), jnp.sin(phi)
    cos2p = cos_p * cos_p - sin_p * sin_p
    sin2p = 2.0 * sin_p * cos_p

    # rotate Stokes into the scattering plane, apply the phase matrix,
    # renormalize to I = 1
    q_r = q * cos2p + u_st * sin2p
    u_r = u_st * cos2p - q * sin2p
    i_new = (kappa - s2_) - s2_ * q_r
    inv_i = 1.0 / jnp.maximum(i_new, jnp.asarray(1e-7, dtype))
    q_new = jnp.clip((-s2_ + (1.0 + c2) * q_r) * inv_i, -1.0, 1.0)
    u_new = jnp.clip(2.0 * cos_t * u_r * inv_i, -1.0, 1.0)
    v_new_st = jnp.clip(kappa * cos_t * v_st * inv_i, -1.0, 1.0)
    # physical constraint p <= 1: near the Mueller null (90-degree
    # scatter of fully polarized light, I' -> 0) the 1/I' renorm
    # amplifies f32 roundoff past purity 1 for rare draws; rescale
    # over-pure states only (max(p^2, 1) == 1 leaves p <= 1 untouched)
    p2 = q_new * q_new + u_new * u_new + v_new_st * v_new_st
    pscale = jax.lax.rsqrt(jnp.maximum(p2, jnp.asarray(1.0, dtype)))
    q_new = q_new * pscale
    u_new = u_new * pscale
    v_new_st = v_new_st * pscale

    # new direction and frame: d' = c d + sin a, e1' = c a - sin d
    # (both exactly unit up to f32 roundoff; renormalized anyway)
    sin_t = jnp.sqrt(jnp.maximum(s2_, 0.0))
    a_vec = tuple(cos_p * e1[i] + sin_p * e2[i] for i in range(3))
    d_new = tuple(cos_t * d[i] + sin_t * a_vec[i] for i in range(3))
    inv_dn = jax.lax.rsqrt(jnp.maximum(
        sum(x * x for x in d_new), jnp.asarray(1e-30, dtype)))
    c_val = jnp.asarray(c_speed, dtype) * inv_dn
    v_new = jnp.stack([x * c_val for x in d_new])
    e1_new = tuple(cos_t * a_vec[i] - sin_t * d[i] for i in range(3))
    inv_e1 = jax.lax.rsqrt(jnp.maximum(
        sum(x * x for x in e1_new), jnp.asarray(1e-30, dtype)))
    e1_new = jnp.stack([x * inv_e1 for x in e1_new])

    v_out = jnp.where(scatter, v_new, state.v)
    dv = jnp.where(scatter, v_new - state.v, jnp.zeros_like(state.v))
    st_out = jnp.where(scatter, jnp.stack([q_new, u_new, v_new_st]), st)
    pr_out = jnp.where(scatter, e1_new, jnp.stack(e1))
    return v_out, dv, st_out, pr_out


class ScatterPolarizedComptonStep(Step):
    """Compton scattering with the FULL Stokes phase matrix (Fano 1949 /
    McMaster 1961) off cold electrons — the physics of X-ray polarimetry
    (IXPE-class instruments, polarized gamma transport).

    extension with no reference counterpart. The scattering angle is
    drawn from the exact unpolarized Klein-Nishina law (Kahn < 1+sqrt(3)
    <= Koblinger per photon, shared with
    :class:`physicl_tpu.light.ScatterComptonStep` — valid because the
    phi-dependent phase-matrix term integrates to zero, so the polarized
    theta-marginal IS the unpolarized KN distribution), then
    ``phi | theta`` from the exact conditional with
    ``r = -sin^2 theta / (kappa - sin^2 theta)``, ``kappa = eta + 1/eta``,
    ``eta = E/E' = 1 + alpha (1 - cos theta)``. The Stokes update applies
    the Fano matrix (see :func:`_apply_phase_matrix`): in the Thomson
    limit ``alpha -> 0`` it reduces EXACTLY to
    :class:`ScatterPolarizedRayleighStep`'s dipole matrix, and at finite
    energy the extra ``kappa - 2`` in the intensity row is the textbook
    Compton depolarization. The recoil ``E' = E / eta`` applies per
    scatter; ``kn_cross_section=True`` multiplies ``pcoll`` by the exact
    ``sigma_KN(E)/sigma_T`` (the unpolarized total — correct for any
    input polarization, since the azimuthal term carries no net cross
    section).

    Per-photon exact laws pinned by the tests: unpolarized input acquires
    ``Q' = -sin^2 theta / (kappa - sin^2 theta)`` (the classic
    polarization-vs-angle curve of Compton polarimetry); circular input
    transfers ``V' = kappa cos theta V / (kappa - sin^2 theta)``.

    Options: ``A`` (cross-section scale), ``n`` / ``variable_n`` /
    ``variable_n_fn`` (electron density), ``mec2`` (electron rest energy
    in code units; defaults to the physical m_e c^2), ``kn_max_tries``,
    ``kn_cross_section``, ``measure_deposition`` (per-iteration net
    heating ``sum w (E - E')``). Thermal electrons are NOT supported here
    (boosting Stokes frames between electron rest frames is out of scope;
    use the scalar :class:`~physicl_tpu.light.ScatterComptonStep` with
    ``T_e=`` when polarization is not tracked). Fused-path step (op kind
    ``"polc"``); requires :func:`polarized_photon_state` planes.
    """

    _ALLOWED = {"n", "A", "variable_n", "variable_n_fn", "mec2",
                "kn_max_tries", "kn_cross_section", "measure_deposition",
                "out_fn"}

    def __init__(self, **kwargs):
        unknown = set(kwargs) - self._ALLOWED
        if unknown:
            raise ValueError(
                f"unknown option(s) {sorted(unknown)}; supported: "
                f"{sorted(self._ALLOWED)}")
        self.out_fn = kwargs.get("out_fn", None)  # deposition CSV target
        self.n = _as_code(kwargs.get("n", 1))
        self.A = _as_code(kwargs.get("A", 1))
        self.wavelength_dep_scattering = False
        self.variable_n = kwargs.get("variable_n", False)
        self.variable_n_fn = kwargs.get("variable_n_fn", None)
        self._n_fn = (_compile_variable_n(self.variable_n_fn)
                      if self.variable_n else None)
        self.mec2 = kwargs.get("mec2", None)
        self.kn_max_tries = int(kwargs.get("kn_max_tries", 12))
        self.kn_cross_section = bool(kwargs.get("kn_cross_section", False))
        self.measure_deposition = bool(kwargs.get("measure_deposition",
                                                  False))
        self.data = []
        self._c = None
        self._coef = None
        self._wl_base = None
        self._inv_mec2 = None

    def setup(self, sim) -> None:
        ScatterIsotropicStep.setup(self, sim)
        # late imports: light.refresh_constants() rebinds these on
        # code-scale changes, so read them at setup time, not import time
        from physicl_tpu.light import c as _c, m_e
        mec2 = (_as_code(self.mec2) if self.mec2 is not None
                else float(raw_code_value(m_e))
                * float(raw_code_value(_c)) ** 2)
        if mec2 <= 0:
            raise ValueError("mec2 must be positive")
        self._inv_mec2 = 1.0 / float(mec2)

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        from physicl_tpu.light import _kn_cos_eta, _kn_sigma_ratio

        if self._c is None or self._inv_mec2 is None:
            self.setup(None)
        if "stokes" not in state.extras or "pol_ref" not in state.extras:
            raise ValueError(_MISSING_PLANES_MSG)
        dtype = state.r.dtype
        norm = _dr_norm(state)
        pcoll = jnp.asarray(self._coef, dtype) * norm
        if self._n_fn is not None:
            pcoll = pcoll * jnp.asarray(
                self._n_fn(state.r[0], state.r[1], state.r[2]), dtype)
        alpha = state.E * jnp.asarray(self._inv_mec2, dtype)
        if self.kn_cross_section:
            pcoll = pcoll * _kn_sigma_ratio(alpha, dtype)

        k = ctx.next_key()
        T = self.kn_max_tries
        u = jax.random.uniform(k, (2 + 3 * T,) + norm.shape, dtype)
        triples = [(u[2 + 3 * i], u[3 + 3 * i], u[4 + 3 * i])
                   for i in range(T)]
        cos_t, eta, accepted = _kn_cos_eta(alpha, triples, dtype)
        scatter = ((pcoll >= u[0]) & (state.otype == OBJ_PHOTON)
                   & state.alive & accepted)

        kappa = eta + 1.0 / eta
        v_out, dv, st_out, pr_out = _apply_phase_matrix(
            state, scatter, cos_t, u[1], kappa, self._c, dtype)
        if self.measure_deposition:
            ctx.record(self, "t", state.t)
            ctx.record(self, "dep", jnp.sum(jnp.where(
                scatter, state.w * (state.E - state.E / eta), 0.0)))
        E = jnp.where(scatter, state.E / eta, state.E)
        extras = dict(state.extras)
        extras["stokes"] = st_out
        extras["pol_ref"] = pr_out
        return state.replace(v=v_out, dv=dv, E=E, extras=extras)

    def collect(self, sim, records) -> None:
        if not self.measure_deposition:
            return
        for i in range(len(records["t"])):
            self.data.append([float(records["t"][i]),
                              float(records["dep"][i])])

    terminate = MeasureStep.terminate


class StokesMeasureStep(MeasureStep):
    """Per-iteration polarization summary over ALIVE photons: mean degree
    of polarization ``<p> = <sqrt(Q^2+U^2+V^2)>`` and mean circular
    polarization ``<V>`` — both invariant under each photon's local-frame
    rotation — plus (``local_qu=True``) the LOCAL-FRAME means ``<Q>``,
    ``<U>``, which are physically meaningful only while the ensemble's
    frames are aligned (e.g. an unscattered beam) — documented caveat.

    ``data`` rows are ``[t(, n), p_mean, V_mean(, Q_mean, U_mean)]``; CSV
    via ``out_fn`` like every MeasureStep. ``weighted=True`` weights every
    mean by the statistical weight ``w``. Fused-path step (op kind
    ``"polmeas"``: the kernel tallies weight/p/V(/Q/U) sums into float
    record channels — psum-correct on meshes — and the host divides)."""

    def __init__(self, out_fn=None, measure_n: bool = True,
                 weighted: bool = False, local_qu: bool = True):
        super().__init__(out_fn)
        self.measure_n = measure_n
        self.weighted = bool(weighted)
        self.local_qu = bool(local_qu)

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        if "stokes" not in state.extras:
            raise ValueError(_MISSING_PLANES_MSG)
        st = state.extras["stokes"]
        wt = state.alive.astype(st.dtype)
        if self.weighted:
            wt = wt * state.w
        denom = jnp.maximum(jnp.sum(wt), jnp.asarray(1e-30, st.dtype))

        def mean(x):
            return jnp.sum(x * wt) / denom

        ctx.record(self, "t", state.t)
        if self.measure_n:
            ctx.record(self, "n", state.n_alive)
        p = jnp.sqrt(st[0] ** 2 + st[1] ** 2 + st[2] ** 2)
        ctx.record(self, "p_mean", mean(p))
        ctx.record(self, "V_mean", mean(st[2]))
        if self.local_qu:
            ctx.record(self, "Q_mean", mean(st[0]))
            ctx.record(self, "U_mean", mean(st[1]))
        return state

    def collect(self, sim: Simulation, records) -> None:
        for i in range(len(records["t"])):
            row = [records["t"][i]]
            if self.measure_n:
                row.append(records["n"][i])
            row.extend([records["p_mean"][i], records["V_mean"][i]])
            if self.local_qu:
                row.extend([records["Q_mean"][i], records["U_mean"][i]])
            self.data.append(np.array(row))
