"""Photon-transport toolkit: constants, photon model, Planck generation,
scattering and measurement steps (capability parity with physicl/light.py).

Design notes:

* every scatter step is a pure elementwise transform over the ``(3, C)`` SoA
  state — XLA fuses the whole kinematics+scatter+measure pipeline into the scan
  body (the fused fast path lives in ``physicl_tpu.ops``);
* photon deletion is an ``alive``-mask update, not list mutation
  (reference: ``sim.remove_obj`` per flagged photon, physicl/light.py:203-205);
* randomness is counter-based ``jax.random`` / the fused chunk's hash, threaded through the
  state (reference: ``np.random.random()`` per photon on host,
  physicl/light.py:181,235,285);
* Planck sampling integrates the reference's Wien-form density analytically
  (closed form, exactly) instead of per-bin ``scipy.integrate.quad``
  (physicl/light.py:84-93), and samples all N photons at once by inverse CDF.

Statistical-parity details preserved on purpose: the inclusive ``pcoll >= rand``
collision test (physicl/light.py:151,243,307) and the angle-uniform (NOT
area-uniform) sphere sampling ``theta = 2*pi*U, phi = pi*U``
(physicl/light.py:309-311,344-347).
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from physicl_tpu.engine import (
    MeasureStep,
    Object,
    ReduceMeasureStep,
    Simulation,
    Step,
    StepContext,
)
from physicl_tpu.state import OBJ_PHOTON, SimState
from physicl_tpu.units import Measurement, raw_code_value

__all__ = [
    "c", "h", "kB", "refresh_constants",
    "PhotonObject",
    "E_from_wavelength", "wavelength_from_E",
    "planck_distribution", "planck_probability", "planck_phot_distribution",
    "planck_cdf", "planck_sample_E", "PlanckSampler",
    "generate_photons_from_E", "generate_photons", "generate_photon_state",
    "PhotonEmitterStep",
    "ImportanceSplitStep", "WeightWindowStep",
    "ScatterDeleteStep", "ScatterDeleteStepReference",
    "ScatterIsotropicStep", "ScatterSphericalStep",
    "ScatterHenyeyGreensteinStep", "ScatterRayleighStep",
    "ScatterPhaseFunctionStep", "mie_phase_table",
    "layered_density", "voxel_density",
    "ScatterComptonStep", "m_e", "RefractiveInterfaceStep",
    "ScatterMeasureStep", "ScatterSignMeasureStep", "SpectrumMeasureStep",
    "SphericalShellMeasureStep", "MeshTallyStep",
    "TracePathMeasureStep",
]

# ---------------------------------------------------------------------------
# Physical constants (SI definitions; reference: physicl/light.py:14-16).
# Created at import time, exactly like the reference; call refresh_constants()
# after set_code_scale to rebuild them under a new code scale.
# ---------------------------------------------------------------------------

c = Measurement(np.double(299792458), "m**1 s**-1")
h = Measurement(np.double(6.62607015e-34), "J**1 s**1")
kB = Measurement(np.double(1.380649e-23), "J**1 K**-1")
m_e = Measurement(np.double(9.1093837015e-31), "kg**1")  # electron mass


def refresh_constants() -> None:
    """Rebuild c/h/kB/m_e under the current code scale (the reference's
    constants silently keep their import-time scale — 'code scale is set at
    the beginning', physicl/__init__.py:124)."""
    global c, h, kB, m_e
    c = Measurement(np.double(299792458), "m**1 s**-1")
    h = Measurement(np.double(6.62607015e-34), "J**1 s**1")
    kB = Measurement(np.double(1.380649e-23), "J**1 K**-1")
    m_e = Measurement(np.double(9.1093837015e-31), "kg**1")


class PhotonObject(Object):
    """A photon: requires an energy ``E`` and |v| == c
    (reference: physicl/light.py:18-35)."""

    _obj_type_code = OBJ_PHOTON

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if not np.isclose(float(np.linalg.norm(np.asarray(self.v, np.double))),
                          float(np.linalg.norm(np.asarray(c, np.double))),
                          rtol=1e-12):
            raise Exception("Not a valid speed.")
        if "E" not in kwargs:
            raise Exception("Needs a valid energy.")


def E_from_wavelength(wavelength):
    """lambda [m] -> E [J] (reference: physicl/light.py:39-43)."""
    return (h * c) / wavelength


def wavelength_from_E(E):
    """E [J] -> lambda [m] (reference: physicl/light.py:45-49)."""
    return (h * c) / E


# ---------------------------------------------------------------------------
# Planck (Wien-form) spectrum — matches the reference's density exactly
# (physicl/light.py:53-60): p(E) = 15/(pi^4 kB T) * x^3 * e^-x,  x = E/(kB T).
# ---------------------------------------------------------------------------


def _as_float(x):
    """SI (unscaled) float — the PLANCK-function convention: the reference's
    planck_* family explicitly unscales its arguments
    (physicl/light.py:78)."""
    return float(x.__unscaled__()) if isinstance(x, Measurement) else float(x)


def _as_code(x):
    """Code-unit float — the SCATTER-step convention: device state (|dr|,
    E) is in code units, so step constants must be too. The reference passes
    its Measurement attributes raw into kernel args (physicl/light.py:236),
    which are likewise code-unit stored values.

    A traced value (jax tracer) passes through untouched: that is the
    differentiable functional path (:mod:`physicl_tpu.functional`), where a
    step parameter like ``A`` is a ``jax.grad`` input. Concrete values
    still fold to host floats so fused-kernel cache keys stay hashable."""
    if isinstance(x, Measurement):
        return float(raw_code_value(x))
    try:
        return float(x)
    except (jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError):
        # Only TRACERS pass through; a concrete non-scalar (e.g. a 3-vector
        # passed as A or n) raises TypeError right here at the constructor,
        # not as a cryptic broadcast error deep inside a later trace.
        return x


def planck_distribution(E, T):
    """Normalized blackbody density (the reference's Wien-approximation form)."""
    E_conv = E.__unscaled__() if isinstance(E, Measurement) else E
    T_conv = T.__unscaled__() if isinstance(T, Measurement) else T
    kB_conv = kB.__unscaled__()
    x = E_conv / (kB_conv * T_conv)
    val = 15.0 / (np.pi ** 4 * kB_conv * T_conv) * x ** 3 * np.exp(-x)
    return Measurement(val, "J**-1")


def _wien_antideriv(x):
    """Closed-form antiderivative: d/dx [-e^-x (x^3+3x^2+6x+6)] = x^3 e^-x."""
    return -np.exp(-x) * (x ** 3 + 3 * x ** 2 + 6 * x + 6)


def planck_probability(E_min, E_max, T, integrator=None):
    """Integral of the density over [E_min, E_max] -> (value, abs_error).

    The default integrator is the exact closed form (the reference runs
    ``scipy.integrate.quad`` per bin, physicl/light.py:63-64); passing a custom
    ``integrator(fn, a, b)`` reproduces the reference call signature.
    """
    if integrator is not None:
        return integrator(lambda x: planck_distribution(x, T), E_min, E_max)
    a, b, T_v = _as_float(E_min), _as_float(E_max), _as_float(T)
    kT = float(kB.__unscaled__()) * T_v
    val = 15.0 / np.pi ** 4 * (_wien_antideriv(b / kT) - _wien_antideriv(a / kT))
    return (float(val), 0.0)


_planck_cache: dict = {}


def planck_cdf(E_min, E_max, T, bins: int = 1000):
    """Vectorized, memoized per-bin CDF of the Wien-form density.

    Returns ``(E_edges, cdf)`` as float64 numpy arrays: ``E_edges`` has
    ``bins`` entries (linspace as in physicl/light.py:82); ``cdf[i]`` is the
    normalized cumulative probability up to edge ``i+1``.
    """
    key = (_as_float(E_min), _as_float(E_max), _as_float(T), int(bins))
    if key in _planck_cache:
        return _planck_cache[key]
    a, b, T_v, nb = key
    kT = float(kB.__unscaled__()) * T_v
    E = np.linspace(a, b, nb)
    F = _wien_antideriv(E / kT)
    gamma = F[1:] - F[:-1]                  # per-bin mass (exact)
    cdf = np.cumsum(gamma / gamma.sum())
    _planck_cache[key] = (E, cdf)
    return E, cdf


def planck_phot_distribution(E_min, E_max, T, bins: int = 1000):
    """Inverse-CDF sample ONE photon energy (API parity with
    physicl/light.py:73-106).

    Bin convention matches the reference exactly: a draw landing in mass bin
    ``x`` (``cdf[x-1] <= rand <= cdf[x]``) returns the bin's lower energy
    edge ``E[x]`` (physicl/light.py:101-104). The reference's possible
    ``None`` return when ``rand`` falls below ``cdf[0]`` is a documented
    quirk we fix by returning the first edge ``E[0]`` instead."""
    E, cdf = planck_cdf(E_min, E_max, T, bins)
    rand = np.random.rand()
    idx = int(np.searchsorted(cdf, rand, side="left"))
    return Measurement(E[min(idx, len(E) - 1)], "J**1")


_planck_inv_cache: dict = {}
_INV_TABLE = 4096


from functools import partial as _partial


@_partial(jax.jit, static_argnums=2)
def _sample_from_table(table, key, n):
    """One fused dispatch: uniforms + inverse-CDF linear interpolation."""
    u = jax.random.uniform(key, (n,), jnp.float32)
    x = u * (_INV_TABLE - 1)
    i0 = jnp.floor(x).astype(jnp.int32)
    frac = x - i0
    i0 = jnp.clip(i0, 0, _INV_TABLE - 2)
    return table[i0] * (1 - frac) + table[i0 + 1] * frac


_planck_poly_cache: dict = {}
_POLY_SEGS = 32
_POLY_DEG = 7


def _planck_poly_data(E_min, E_max, T, bins):
    """Memoized piecewise-polynomial inverse-CDF fit (host-side constants).

    Segments are warped-uniform in ENERGY — breakpoints at
    ``E_lo + (E_hi-E_lo) * t**1.5`` — which bounds the inverse CDF's slope
    per segment while concentrating resolution where the inverse is steepest
    (u -> 0: the density vanishes as x^3 toward E_lo, so the CDF is flat and
    its inverse steep there). Each segment carries a degree-7 monomial fit.
    Max error ~0.01 CDF-table bins (uniform breakpoints measured ~3 bins;
    the warp is where the round-2 accuracy gain came from). Returns
    ``(pb, mids, halves, coeffs, (E_lo, E_hi))`` as float32 Python constants
    that fold into any trace (jit, Pallas kernel) as immediates.
    """
    cache_key = ("data", _as_float(E_min), _as_float(E_max), _as_float(T),
                 int(bins))
    if cache_key in _planck_poly_cache:
        return _planck_poly_cache[cache_key]

    E, cdf = planck_cdf(E_min, E_max, T, bins)
    probs = np.concatenate([[0.0], cdf])
    Eb = E[0] + (E[-1] - E[0]) * np.linspace(0.0, 1.0, _POLY_SEGS + 1) ** 1.5
    pb = np.interp(Eb, E, probs)
    pb[0], pb[-1] = 0.0, 1.0 + 1e-7

    mids = 0.5 * (pb[1:] + pb[:-1])
    halves = np.maximum(0.5 * (pb[1:] - pb[:-1]), 1e-12)
    coeffs = np.zeros((_POLY_SEGS, _POLY_DEG + 1))
    nodes = np.cos(np.pi * (np.arange(128) + 0.5) / 128)  # Chebyshev nodes
    for s in range(_POLY_SEGS):
        # fit on nodes sampled WITHIN the segment (always well-conditioned —
        # a shared dense grid leaves near-zero-mass tail segments with too
        # few points and garbage rank-deficient fits)
        ps = mids[s] + halves[s] * nodes
        ch = np.polynomial.chebyshev.Chebyshev.fit(
            ps, np.interp(ps, probs, E), _POLY_DEG,
            domain=[pb[s], pb[s + 1]])
        coeffs[s] = np.polynomial.chebyshev.cheb2poly(ch.coef)

    data = (
        [np.float32(x) for x in pb],
        [np.float32(x) for x in mids],
        [np.float32(x) for x in halves],
        [[np.float32(c) for c in row] for row in coeffs],
        (np.float32(E[0]), np.float32(E[-1])),
    )
    _planck_poly_cache[cache_key] = data
    return data


def _poly_icdf_eval(u, data):
    """Traced inverse-CDF evaluation: uniforms in [0,1) -> energies.

    Pure elementwise jnp (mask-multiply segment selection, Horner eval) — no
    gathers, so it runs identically under jit, inside lax.scan bodies, and
    inside the fused Triton kernel (~400 ops per sample).
    """
    pb_f, mid_f, half_f, coef_f, (e_lo, e_hi) = data
    mid = jnp.zeros_like(u)
    half = jnp.ones_like(u)
    cs = [jnp.zeros_like(u) for _ in range(_POLY_DEG + 1)]
    for s in range(_POLY_SEGS):
        m = ((u >= pb_f[s]) & (u < pb_f[s + 1])).astype(jnp.float32)
        mid = mid + m * mid_f[s]
        half = half + m * (half_f[s] - 1.0)
        for j in range(_POLY_DEG + 1):
            cs[j] = cs[j] + m * coef_f[s][j]
    x = (u - mid) / half
    acc = cs[_POLY_DEG]
    for j in range(_POLY_DEG - 1, -1, -1):
        acc = acc * x + cs[j]
    return jnp.clip(acc, e_lo, e_hi)


def _planck_poly(E_min, E_max, T, bins):
    """Memoized jitted sampler ``f(key, n) -> (n,) energies`` (gather-free)."""
    cache_key = (_as_float(E_min), _as_float(E_max), _as_float(T), int(bins))
    if cache_key in _planck_poly_cache:
        return _planck_poly_cache[cache_key]
    data = _planck_poly_data(E_min, E_max, T, bins)

    @_partial(jax.jit, static_argnums=1)
    def sample(key, n):
        u = jax.random.uniform(key, (n,), jnp.float32)
        return _poly_icdf_eval(u, data)

    _planck_poly_cache[cache_key] = sample
    return sample


class PlanckSampler:
    """Blackbody photon-energy sampler (Wien-form density, reference
    physicl/light.py:53-106) packaged for every execution tier:

    * ``sampler(key, k)`` — vectorized sampling for host code and the generic
      engine path (``PhotonEmitterStep(E=sampler)`` works unfused);
    * ``sampler.icdf(u)`` — the traced inverse CDF over uniforms: pure
      elementwise jnp, so the fused transport chunk evaluates it on its
      own uniforms *inside* the chunk (sampled-energy emitters keep
      ``used_fused=True``);
    * ``sampler.sample_device(seed, n)`` — bulk population creation on the
      device: the same polynomial on ``jax.random`` uniforms of
      ``PRNGKey(seed)``.
    """

    def __init__(self, E_min, E_max, T, bins: int = 1000):
        self.E_min = _as_float(E_min)
        self.E_max = _as_float(E_max)
        self.T = _as_float(T)
        self.bins = int(bins)
        # emitted energies land in the CODE-UNIT E plane of the state; the
        # spectrum is defined in SI joules, so fold the J code factor into
        # every output (captured now — code scale is set at the beginning,
        # physicl/__init__.py:124)
        self._code = float(raw_code_value(Measurement(1.0, "J**1")))

    def __call__(self, key, k):
        E = _planck_poly(self.E_min, self.E_max, self.T, self.bins)(
            key, int(k))
        return E * jnp.float32(self._code) if self._code != 1.0 else E

    def icdf(self, u):
        E = _poly_icdf_eval(
            u, _planck_poly_data(self.E_min, self.E_max, self.T, self.bins))
        return E * jnp.float32(self._code) if self._code != 1.0 else E

    def sample_device(self, seed: int, n: int):
        E = _planck_poly(self.E_min, self.E_max, self.T, self.bins)(
            jax.random.PRNGKey(int(seed)), int(n))
        return E * jnp.float32(self._code) if self._code != 1.0 else E


def _planck_inverse_table(E_min, E_max, T, bins):
    """Memoized inverse-CDF table: probability grid -> energy (host f64)."""
    key = (_as_float(E_min), _as_float(E_max), _as_float(T), int(bins))
    if key not in _planck_inv_cache:
        E, cdf = planck_cdf(E_min, E_max, T, bins)
        # cdf[i] is cumulative mass up to edge E[i+1]; prepend (0, E[0])
        probs = np.concatenate([[0.0], cdf])
        _planck_inv_cache[key] = np.interp(
            np.linspace(0.0, 1.0, _INV_TABLE), probs, E)
    return _planck_inv_cache[key]


def planck_sample_E(n, E_min, E_max, T, bins: int = 1000, key=None,
                    seed: int = 0, device: bool = False,
                    device_method: str = "auto"):
    """Sample ``n`` photon energies at once (batch generation).

    ``device=True`` keeps the samples on the accelerator (feed directly into
    ``generate_photon_state(..., device=True)`` — no host round trip).
    ``device_method``:

    * "auto" (default) == "poly": the gather-free piecewise-poly inverse CDF
      on ``jax.random`` uniforms — one fused XLA dispatch;
    * "table": exact inverse-CDF table interpolation (a dynamic gather,
      kept as the accuracy oracle).
    """
    if key is None:
        key = jax.random.PRNGKey(seed)
    if device:
        if device_method == "auto":
            device_method = "poly"
        if device_method == "poly":  # gather-free: ~50x faster than table
            return _planck_poly(E_min, E_max, T, bins)(key, int(n))
        table = jnp.asarray(_planck_inverse_table(E_min, E_max, T, bins),
                            jnp.float32)
        return _sample_from_table(table, key, int(n))
    u = jax.random.uniform(key, (int(n),), jnp.float32)
    E, cdf = planck_cdf(E_min, E_max, T, bins)
    # lower-edge bin convention, matching the reference scan and
    # planck_phot_distribution above
    idx = jnp.clip(jnp.searchsorted(jnp.asarray(cdf, jnp.float32), u),
                   0, len(E) - 1)
    return E[np.asarray(idx)]  # gather in host float64, exact bin edges


# ---------------------------------------------------------------------------
# Photon generation (reference: physicl/light.py:109-128)
# ---------------------------------------------------------------------------


def generate_photons_from_E(E) -> List[PhotonObject]:
    """One +x photon per energy in E (reference: physicl/light.py:109-110)."""
    return [PhotonObject(E=x, v=c * [1, 0, 0]) for x in E]


def generate_photons(n, fn=None, min=0, max=0, bins=-1) -> List[PhotonObject]:
    """n photons with ``E = min + (max-min) * sample`` moving along +x
    (reference: physicl/light.py:112-128; default sample ~ np.random.power(3)).

    ``fn`` may be the reference-style zero-arg scalar sampler (host loop) or a
    vectorized sampler ``fn(size)``; the default is vectorized.
    """
    n = int(n)
    if fn is None:
        samples = np.random.power(3, size=n)
    else:
        try:
            samples = np.asarray(fn(n), np.double)
            if samples.shape != (n,):
                raise TypeError
        except TypeError:
            samples = np.array([fn() for _ in range(n)], np.double)
    out = []
    for i in range(n):
        Eo = min + (max - min) * samples[i]
        out.append(PhotonObject(E=Eo, v=Measurement([c, 0, 0], "m**1 s**-1")))
    return out


def generate_photon_state(n, E, v=None, r=None, device=False, w=None,
                          extras=None) -> dict:
    """Bulk SoA photon population — the fast path for large N (no per-photon
    Python objects). Returns a dict for ``Simulation.add_photons``.

    ``E``: scalar or (n,) energies [code units]; ``v``: (3,) or (3,n) velocities
    (default +x at c); ``r``: (3,) or (3,n) positions (default origin);
    ``w``: scalar or (n,) statistical weights (default 1.0 — analog transport;
    set for source biasing with weighted measurements).

    ``extras``: dict of per-photon aux planes, each a scalar / (n,) value or
    a (3,) / (3, n) 3-vector — stored as ``state.extras[name]`` and readable
    from user steps declaring ``extras=("name", ...)``
    (:class:`~physicl_tpu.engine.ElementwiseStep` /
    :class:`~physicl_tpu.engine.ReduceMeasureStep`, both execution paths).

    ``device=True`` builds the arrays with jnp on the accelerator (zero host
    staging — the right path at 1e7+ photons); ``E`` may then be a jax array
    (e.g. straight from :func:`planck_sample_E` device output).
    """
    n = int(n)
    c_val = float(raw_code_value(c))

    def _extras_out(xp, dtype):
        out = {}
        for name, val in (extras or {}).items():
            arr = xp.asarray(raw_code_value(val), dtype)
            if arr.ndim <= 1 and arr.size in (1, n):
                out[name] = xp.broadcast_to(arr.reshape(-1), (n,))
            elif arr.ndim <= 2 and arr.size in (3, 3 * n):
                out[name] = xp.broadcast_to(arr.reshape(3, -1), (3, n))
            else:
                raise ValueError(
                    f"extras[{name!r}] must be scalar/({n},) or "
                    f"(3,)/(3, {n}), got shape {arr.shape}")
        return out
    if device:
        import jax.numpy as jnp

        E_arr = jnp.broadcast_to(
            jnp.asarray(E, jnp.float32).reshape(-1), (n,))
        if v is None:
            v_arr = jnp.zeros((3, n), jnp.float32).at[0].set(c_val)
        else:
            v_arr = jnp.broadcast_to(jnp.asarray(
                raw_code_value(v), jnp.float32).reshape(3, -1), (3, n))
        if r is None:
            r_arr = jnp.zeros((3, n), jnp.float32)
        else:
            r_arr = jnp.broadcast_to(jnp.asarray(
                raw_code_value(r), jnp.float32).reshape(3, -1), (3, n))
        out = {"n": n, "E": E_arr, "v": v_arr, "r": r_arr,
               "otype": OBJ_PHOTON}
        if w is not None:
            w_arr = jnp.asarray(raw_code_value(w), jnp.float32).reshape(-1)
            if w_arr.shape[0] not in (1, n):
                raise ValueError(f"w must be scalar or length {n}")
            out["w"] = jnp.broadcast_to(w_arr, (n,))
        if extras:
            out["extras"] = _extras_out(jnp, jnp.float32)
        return out
    E_flat = np.asarray(raw_code_value(E), np.float64).reshape(-1)
    if E_flat.size not in (1, n):
        raise ValueError(f"E must be scalar or length {n}")
    E_arr = np.broadcast_to(E_flat, (n,)).copy()
    if v is None:
        v_arr = np.zeros((3, n)); v_arr[0, :] = c_val
    else:
        v_arr = np.broadcast_to(
            np.asarray(raw_code_value(v), np.float64).reshape(3, -1), (3, n)).copy()
    if r is None:
        r_arr = np.zeros((3, n))
    else:
        r_arr = np.broadcast_to(
            np.asarray(raw_code_value(r), np.float64).reshape(3, -1), (3, n)).copy()
    out = {"n": n, "E": E_arr, "v": v_arr, "r": r_arr, "otype": OBJ_PHOTON}
    if w is not None:
        w_flat = np.asarray(raw_code_value(w), np.float64).reshape(-1)
        if w_flat.size not in (1, n):
            raise ValueError(f"w must be scalar or length {n}")
        out["w"] = np.broadcast_to(w_flat, (n,)).copy()
    if extras:
        out["extras"] = _extras_out(np, np.float64)
    return out


# ---------------------------------------------------------------------------
# Scatter steps
# ---------------------------------------------------------------------------


def _dr_norm(state: SimState) -> jax.Array:
    return jnp.sqrt(jnp.sum(state.dr * state.dr, axis=0))


class ScatterDeleteStep(MeasureStep):
    """Absorption: photon deleted with probability ``pcoll = A*n*|dr|``
    (reference kernel ``light_scatter_step_del``, physicl/light.py:146-158 and
    the CLProgram twin at physicl/light.py:225-260). Deletion = alive-mask
    clear; the exit predicate sees the updated count the same iteration.

    Extensions (the reference's absorption is constant-coefficient):

    * ``A_fn`` — energy-dependent cross-section: ``pcoll`` is multiplied by
      ``A_fn(E)`` per photon (so ``A`` becomes the scale and ``A_fn`` the
      dimensionless spectral shape, or pass ``A=1`` and let ``A_fn`` return
      the absolute cross-section). A jnp callable over the photon-energy
      array, or a C-expression string over ``E[gid]`` in the reference's
      ``variable_n_fn`` grammar. E.g. photoelectric ``(E0/E)**3``.
    * ``variable_n`` / ``variable_n_fn`` — spatially varying number density
      ``n(r)``, same option pair as :class:`ScatterIsotropicStep`
      (physicl/light.py:295-299 grammar, or a callable).

    Both run fused and on the generic scan; together they give the full
    attenuation model ``pcoll = A * A_fn(E) * n(r) * |dr|``.

    Variance reduction (extension — standard Monte Carlo transport
    techniques the reference lacks):

    * ``implicit_capture=True`` — survival biasing: instead of killing a
      photon with probability ``pcoll``, its statistical weight is
      deterministically multiplied by ``1 - min(pcoll, 1)`` every iteration
      (NO random draw). Every photon survives to contribute to weighted
      tallies, so deep-penetration observables lose the e^tau blow-up of
      analog survival statistics. Measurements must then sum ``p.w``
      (``SpectrumMeasureStep(weighted=True)``, or ``p.w`` in a
      ReduceMeasureStep) — unweighted counts stop being physical.
    * ``roulette=(w_min, w_survive)`` — Russian roulette keeps implicit
      capture unbiased AND bounded: a photon whose weight falls below
      ``w_min`` survives with probability ``w / w_survive`` (weight reset
      to ``w_survive``) and is killed otherwise — expected weight is
      exactly conserved. Without roulette nothing ever dies, so
      ``exit="extinction"`` never fires; prefer ``until_t=``.
    * ``stretch=b`` (with ``stretch_dir=(1,0,0)``) — exponential transform
      (MCNP EXT analog, discrete-step form): the analog kill probability is
      biased per particle to ``p' = p*(1 - b*mu)`` with ``mu`` the flight
      direction cosine along ``stretch_dir``, and survivors carry the
      likelihood ratio ``w *= (1-p)/(1-p')`` — forward movers see the
      medium ``~(1-b)`` times thinner (penetrating ``1/(1-b)`` optical
      depths per analog depth) while backward movers die faster, all
      unbiased. Requires analog mode (no ``implicit_capture``); tallies
      must be weighted. Deposition tallies scale killed energy by
      ``p/p'``, keeping the expected dose exact.
    * ``measure_deposition=True`` — records the energy DEPOSITED in the
      medium each iteration (``data`` rows ``[t, E_dep]``, CSV via
      ``out_fn`` like any MeasureStep; psum across mesh shards). Analog:
      ``sum(w*E)`` over killed photons; implicit capture: the exact
      expected value ``sum(w*min(pcoll,1)*E)`` — a draw-free dose/heating
      curve. Roulette weight games are variance bookkeeping, not physics,
      and do not contribute. Energy is conserved exactly:
      ``initial = sum(deposited) + in-flight sum(w*E)``.
    * ``fluorescence=(Y, E_f)`` — photoelectric fluorescence (extension;
      K-shell re-emission): an absorbed photon with
      ``E >= fluorescence_edge`` is, with fluorescence-yield probability
      ``Y``, re-emitted in its slot at the characteristic line energy
      ``E_f`` in a TRUE-isotropic direction (cos-theta uniform on
      [-1, 1] — physical emission, unlike the scatter family's
      reference-parity angle-uniform convention) at speed c; with
      probability ``1 - Y`` (and always below the edge) it is absorbed
      outright. ``dv`` is written only on re-emitted lanes so upstream
      scatter flags survive; Stokes/frame extras of re-emitted photons
      are zeroed (fluorescence light is unpolarized). Deposition
      bookkeeping stays exact: re-emission deposits ``w*(E - E_f)``,
      outright absorption ``w*E``, so
      ``initial = sum(deposited) + in-flight sum(w*E)`` still holds
      (``fluorescence_edge`` must be ``>= E_f`` to forbid up-conversion
      and defaults to ``E_f``; set it to the physical absorption edge,
      e.g. the Fe K-edge 7.11 keV with ``E_f`` the K-alpha 6.40 keV, so
      re-emitted line photons are below the edge and cannot
      re-fluoresce). The edge test is inclusive (``E >= edge``), so at
      the default edge a line photon re-absorbed later re-emits again —
      with ``Y = 1`` that means nothing can ever die; prefer
      ``until_t=`` over ``exit="extinction"``. Analog-only (exclusive
      with ``implicit_capture`` and ``stretch``); runs fused and on the
      generic scan.
    """

    def __init__(self, n, A, A_fn=None, variable_n=False,
                 variable_n_fn=None, implicit_capture=False, roulette=None,
                 measure_deposition=False, out_fn=None, stretch=None,
                 stretch_dir=(1.0, 0.0, 0.0), fluorescence=None,
                 fluorescence_edge=None):
        super().__init__(out_fn)
        self.measure_deposition = bool(measure_deposition)
        # exponential transform (MCNP EXT analog): bias the kill toward
        # backward movers, p' = p*(1 - b*mu), mu = dr_hat . stretch_dir;
        # survivors reweight by (1-p)/(1-p'), so forward-moving particles
        # penetrate ~1/(1-b) optical depths per analog depth, unbiased
        if stretch is not None:
            if implicit_capture:
                raise ValueError("stretch biases the analog kill; "
                                 "implicit_capture has no kill to bias "
                                 "(use one or the other)")
            b = float(raw_code_value(stretch))
            if not (0.0 < b < 1.0):
                raise ValueError(f"stretch must be in (0, 1), got {b}")
            d = np.asarray(raw_code_value(stretch_dir), np.float64)
            if d.shape != (3,) or not np.isfinite(d).all() or not d.any():
                raise ValueError("stretch_dir must be a nonzero 3-vector")
            d = d / np.linalg.norm(d)
            stretch = (b, float(d[0]), float(d[1]), float(d[2]))
        self.stretch = stretch
        self.n = _as_code(n)
        self.A = _as_code(A)
        self._a_fn = (None if A_fn is None else
                      _compile_field_expr(A_fn, ("E",), "A_fn"))
        if variable_n and variable_n_fn is None:
            raise ValueError("variable_n=True requires variable_n_fn")
        self._n_fn = (_compile_variable_n(variable_n_fn) if variable_n
                      else None)
        self.implicit_capture = bool(implicit_capture)
        if roulette is not None:
            if not self.implicit_capture:
                raise ValueError("roulette requires implicit_capture=True "
                                 "(analog transport kills outright)")
            w_min, w_survive = (float(roulette[0]), float(roulette[1]))
            if not (0.0 < w_min <= w_survive):
                raise ValueError("roulette=(w_min, w_survive) needs "
                                 "0 < w_min <= w_survive")
            roulette = (w_min, w_survive)
        self.roulette = roulette
        # fluorescent re-emission (analog-only: the re-emit branch replaces
        # the kill, which implicit capture / the exponential transform have
        # already re-shaped)
        if fluorescence is not None:
            if self.implicit_capture:
                raise ValueError("fluorescence replaces the analog kill; "
                                 "implicit_capture has no kill to replace "
                                 "(use one or the other)")
            if self.stretch is not None:
                raise ValueError("fluorescence + stretch would need the "
                                 "likelihood ratio threaded through the "
                                 "re-emit branch; unsupported — pick one")
            Y = float(raw_code_value(fluorescence[0]))
            E_f = float(raw_code_value(fluorescence[1]))
            if not (0.0 < Y <= 1.0):
                raise ValueError(f"fluorescence yield must be in (0, 1], "
                                 f"got {Y}")
            if not (E_f > 0.0):
                raise ValueError(f"fluorescence line energy must be "
                                 f"positive, got {E_f}")
            edge = (E_f if fluorescence_edge is None
                    else float(raw_code_value(fluorescence_edge)))
            if edge < E_f:
                raise ValueError(
                    f"fluorescence_edge ({edge}) below the line energy "
                    f"({E_f}) would re-emit photons ABOVE their absorbed "
                    f"energy (negative deposition)")
            fluorescence = (Y, E_f, edge)
        elif fluorescence_edge is not None:
            raise ValueError("fluorescence_edge requires fluorescence=")
        self.fluorescence = fluorescence

    @property
    def _c(self):
        # re-emission speed; read at apply/pack time so a code-scale change
        # (refresh_constants) after construction is honored, like the
        # scatter family's setup()-time fold
        return float(raw_code_value(c))

    @property
    def _coef(self):
        # family convention: variable_n REPLACES the constant n
        # (physicl/light.py:295-299; matches ScatterIsotropicStep.setup)
        return self.A * (1.0 if self._n_fn is not None else self.n)

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        norm = _dr_norm(state)
        pcoll = jnp.asarray(self._coef, norm.dtype) * norm
        if self._a_fn is not None:
            pcoll = pcoll * jnp.asarray(self._a_fn(state.E), norm.dtype)
        if self._n_fn is not None:
            pcoll = pcoll * jnp.asarray(
                self._n_fn(state.r[0], state.r[1], state.r[2]), norm.dtype)
        sel = (state.otype == OBJ_PHOTON) & state.alive
        if self.implicit_capture:
            p = jnp.clip(pcoll, 0.0, 1.0)
            w = jnp.where(sel, state.w * (1.0 - p), state.w)
            if self.measure_deposition:  # exact expected deposition w*p*E
                ctx.record(self, "t", state.t)
                ctx.record(self, "dep", jnp.sum(jnp.where(
                    sel, state.w * p * state.E, 0.0)))
            if self.roulette is None:
                return state.replace(w=w)
            w_min, w_sur = self.roulette
            u = jax.random.uniform(ctx.next_key(), norm.shape, norm.dtype)
            low = sel & (w < w_min)
            # survive with probability w / w_survive at weight w_survive:
            # expected weight is conserved exactly
            kill = low & (u * w_sur >= w)
            w = jnp.where(low & ~kill, jnp.asarray(w_sur, w.dtype), w)
            return state.replace(w=w, alive=state.alive & ~kill)
        u = jax.random.uniform(ctx.next_key(), norm.shape, norm.dtype)
        if self.stretch is not None:
            tiny = jnp.finfo(norm.dtype).tiny
            b, dx, dy, dz = (jnp.asarray(x, norm.dtype)
                             for x in self.stretch)
            mu = ((state.dr[0] * dx + state.dr[1] * dy + state.dr[2] * dz)
                  / jnp.maximum(norm, tiny))
            p_true = jnp.clip(pcoll, 0.0, 1.0)
            p_bias = jnp.clip(pcoll * (1.0 - b * mu), 0.0, 1.0)
            # unbiasedness requires survivors to exist wherever p_true < 1:
            # cap the biased kill so the likelihood ratio stays finite.
            # The cap engages exactly where the uncapped transform would
            # LOSE the surviving weight (p_bias saturating at 1 against
            # p_true < 1, e.g. backward movers in a thick medium), and
            # bounds the weight amplification at 8x(1 - p_true)
            # (a gentler cap keeps the rare-survivor lottery variance low).
            p_bias = jnp.where(p_true < 1.0,
                               jnp.minimum(p_bias, 7.0 / 8.0), p_bias)
            hit = (p_bias >= u) & sel
            # survivors carry the likelihood ratio; killed dump w*E*(p/p')
            ratio = (1.0 - p_true) / jnp.maximum(1.0 - p_bias, tiny)
            w = jnp.where(sel & jnp.logical_not(hit), state.w * ratio,
                          state.w)
            if self.measure_deposition:
                ctx.record(self, "t", state.t)
                ctx.record(self, "dep", jnp.sum(jnp.where(
                    hit, state.w * state.E
                    * (p_true / jnp.maximum(p_bias, tiny)), 0.0)))
            return state.replace(
                w=w, alive=state.alive & jnp.logical_not(hit))
        hit = (pcoll >= u) & sel
        if self.fluorescence is not None:
            Y, E_f, E_edge = (jnp.asarray(x, norm.dtype)
                              for x in self.fluorescence)
            y = jax.random.uniform(ctx.next_key(), norm.shape, norm.dtype)
            fluo = hit & (y < Y) & (state.E >= E_edge)
            killed = hit & jnp.logical_not(fluo)
            if self.measure_deposition:
                # re-emission deposits the line deficit, absorption all of E
                ctx.record(self, "t", state.t)
                ctx.record(self, "dep", jnp.sum(jnp.where(
                    killed, state.w * state.E, jnp.where(
                        fluo, state.w * (state.E - E_f), 0.0))))
            cu = jax.random.uniform(ctx.next_key(), norm.shape, norm.dtype)
            au = jax.random.uniform(ctx.next_key(), norm.shape, norm.dtype)
            # TRUE isotropic (physical emission): cos-theta uniform
            cos_t = 2.0 * cu - 1.0
            sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
            phi = au * (2 * np.pi)
            n_hat = jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi),
                               cos_t])
            v_new = n_hat * jnp.asarray(self._c, norm.dtype)
            v = jnp.where(fluo, v_new, state.v)
            # dv only on re-emitted lanes: an upstream scatter op's flags
            # this iteration must survive for trace/ScatterMeasure capture
            dv = jnp.where(fluo, v_new - state.v, state.dv)
            E = jnp.where(fluo, E_f, state.E)
            extras = dict(state.extras)
            for nm in ("stokes", "pol_ref"):
                if nm in extras:  # fluorescence light is unpolarized
                    extras[nm] = jnp.where(fluo, 0.0, extras[nm])
            return state.replace(
                E=E, v=v, dv=dv, extras=extras,
                alive=state.alive & jnp.logical_not(killed))
        if self.measure_deposition:  # analog: killed photons dump w*E
            ctx.record(self, "t", state.t)
            ctx.record(self, "dep", jnp.sum(jnp.where(
                hit, state.w * state.E, 0.0)))
        return state.replace(alive=state.alive & jnp.logical_not(hit))

    def collect(self, sim, records) -> None:
        if not self.measure_deposition:
            return
        for i in range(len(records["t"])):
            self.data.append([float(records["t"][i]),
                              float(records["dep"][i])])


class ScatterDeleteStepReference(Step):
    """Constant-medium absorption REBUILT through the declarative kernel
    bridge — a genuinely independent second implementation whose only
    shared code with :class:`ScatterDeleteStep` is the engine itself.

    The reference ships the same pairing for cross-checking: a
    hand-written pipeline (physicl/light.py:131-223) against a CLProgram
    metadata rebuild (physicl/light.py:225-260). Here the hand-built
    fused op is :class:`ScatterDeleteStep`; THIS class is the bridge
    rebuild — the kill mask is computed by a :class:`~physicl_tpu.kernels.
    KernelProgram` assembled from ``KernelInput``/``KernelOutput``
    metadata (``dr`` gathers, an ``obj_def`` uniform draw, ``const``
    coefficients, the photon ``obj_action`` filter), exactly the
    declarative surface a migrated CLProgram user writes. The two
    implementations cross-check each other statistically in
    tests/test_light_stats.py (same e^-pcoll-per-step survival law) and
    differentially against the reference's own Python physics in
    tests/test_transport_differential.py.

    Independent-implementation choices (deliberately NOT shared):
    the collision test runs on gathered ``dr`` component arrays through
    the bridge's gather pipeline rather than packed kernel planes, and
    the draw comes from the bridge's ``obj_def`` sampler stream rather
    than the transport kernel's salted per-op stream. Physics contract
    is the reference's: kill where ``A * n * |dr| >= rand``, photons
    only, no deposition tally. Runs on the generic scan (the fusability
    prover issues its structured unsupported-step refusal) — use
    :class:`ScatterDeleteStep` for production rates.
    """

    state_need_lock = False

    def __init__(self, n, A):
        from physicl_tpu.kernels import (KernelInput, KernelOutput,
                                         KernelProgram)

        self.n = float(raw_code_value(n))
        self.A = float(raw_code_value(A))

        def kernel_fn(valid, d0, d1, d2, rand, A, n):
            norm = jnp.sqrt(d0 * d0 + d1 * d1 + d2 * d2)
            pcoll = A * n * norm
            return {"res": jnp.where(valid & (pcoll >= rand), 1, 0)}

        prog = KernelProgram(None, "scatter_delete_reference", kernel_fn)
        prog.prep_metadata = [
            KernelInput(name="photon_check", type="obj_action",
                        code=lambda st: st.otype == OBJ_PHOTON),
            KernelInput(name="d0", type="obj", obj_attr="dr[0]"),
            KernelInput(name="d1", type="obj", obj_attr="dr[1]"),
            KernelInput(name="d2", type="obj", obj_attr="dr[2]"),
            KernelInput(name="rand", type="obj_def",
                        obj_def="np.random.random()"),
            KernelInput(name="A", type="const", const_value=self.A),
            KernelInput(name="n", type="const", const_value=self.n),
        ]
        prog.output_metadata = [KernelOutput(name="res", ctype="int")]
        prog.build_kernel()
        self._prog = prog

    def apply(self, state: SimState, ctx) -> SimState:
        out, _mask = self._prog._compiled(state, ctx.next_key())
        return state.replace(alive=state.alive & (out["res"] != 1))


_GID_RE = re.compile(r"\[\s*gid\s*\]")


_EXPR_NS = {
    "exp": jnp.exp, "pow": jnp.power, "sqrt": jnp.sqrt, "fabs": jnp.abs,
    "sin": jnp.sin, "cos": jnp.cos, "tan": jnp.tan, "log": jnp.log,
    "log10": jnp.log10, "floor": jnp.floor, "ceil": jnp.ceil,
    "fmin": jnp.minimum, "fmax": jnp.maximum, "M_PI": np.pi, "M_E": np.e,
}


def _compile_field_expr(fn_or_expr, varnames, label):
    """Turn a user field into a jnp callable over ``varnames``.

    Accepts a Python callable (preferred: strictly more general than the
    reference) or a C-expression string over ``<var>[gid]`` exactly as the
    reference splices into its kernel (physicl/light.py:295-299) — evaluated
    with jnp math, no string codegen.
    """
    if callable(fn_or_expr):
        return fn_or_expr
    expr = _GID_RE.sub("", str(fn_or_expr))
    code = compile(expr, f"<{label}>", "eval")
    for name in code.co_names:
        if name not in _EXPR_NS and name not in varnames:
            raise ValueError(f"{label}: unknown symbol {name!r}")

    def fn(*args):
        return eval(code, {"__builtins__": {}},
                    {**_EXPR_NS, **dict(zip(varnames, args))})

    return fn


def _compile_variable_n(fn_or_expr):
    """Number-density field n(r) as a jnp callable over (r0, r1, r2)."""
    return _compile_field_expr(fn_or_expr, ("r0", "r1", "r2"),
                               "variable_n_fn")


def layered_density(edges, values, axis: str = "x",
                    center=(0.0, 0.0, 0.0), outside: float = 0.0):
    """Piecewise-constant layered medium as a ``variable_n_fn`` callable —
    GATHER-FREE (mask-multiply over static layer edges, the phase-table
    technique), so it traces into the fused Pallas kernel unchanged.

    ``edges`` (increasing, layer i spans ``edges[i] <= coord < edges[i+1]``
    — the framework-wide lower-edge convention) and ``values`` (one density
    per layer, ``len(edges) - 1``) are static host floats. ``axis`` is
    ``"x"``/``"y"``/``"z"`` for slab stacks or ``"r"`` for spherical shells
    of ``|r - center|``; ``outside`` is the density beyond the edge range
    (default vacuum). The atmosphere/shield/CT-slice counterpart of the
    reference's analytic ``variable_n_fn`` C-expressions
    (physicl/light.py:295-299). Keep layer count modest (each layer costs
    one mask-multiply per particle per iteration; ~32 is free, hundreds
    dilute the kernel) — for dense 3-D data use :func:`voxel_density`.
    """
    edges = [float(raw_code_value(e)) for e in np.asarray(edges).ravel()]
    values = [float(raw_code_value(v)) for v in np.asarray(values).ravel()]
    if len(edges) < 2 or len(values) != len(edges) - 1:
        raise ValueError(f"need len(values) == len(edges) - 1 >= 1, got "
                         f"{len(values)} values / {len(edges)} edges")
    if not all(b > a for a, b in zip(edges, edges[1:])):
        raise ValueError("edges must be strictly increasing")
    if axis not in ("x", "y", "z", "r"):
        raise ValueError(f"axis must be 'x', 'y', 'z' or 'r', got {axis!r}")
    cx, cy, cz = (float(raw_code_value(v)) for v in center)
    outside = float(raw_code_value(outside))

    def fn(r0, r1, r2):
        if axis == "r":
            coord = jnp.sqrt((r0 - cx) ** 2 + (r1 - cy) ** 2
                             + (r2 - cz) ** 2)
        else:
            coord = {"x": r0, "y": r1, "z": r2}[axis]
        out_mask = (coord < edges[0]) | (coord >= edges[-1])
        acc = jnp.where(out_mask, jnp.asarray(outside, coord.dtype),
                        jnp.zeros_like(coord))
        for i, v in enumerate(values):
            m = (coord >= edges[i]) & (coord < edges[i + 1])
            acc = acc + jnp.asarray(v, coord.dtype) * m.astype(coord.dtype)
        return acc

    return fn


#: Largest voxel grids (total entries) the fused tier takes. Both chunk
#: builders read the grid by a direct gather from the flat f32 table (a
#: 64^3 grid is 1 MiB), so these caps date from an earlier in-kernel table
#: design; they stay until benchmark cells show what each costs (ROADMAP
#: Queue 3 #2). Continuous grids past the f32 cap need ``quantize=``.
MAX_FUSED_VOXELS = 8192
MAX_FUSED_VOXELS_TRILINEAR = 4096
# grids with <= 256 distinct values (or quantize=): the codebook tier
MAX_FUSED_VOXELS_CODEBOOK = 524288            # 64^3
MAX_FUSED_VOXELS_TRILINEAR_CODEBOOK = 524288  # 64^3


def voxel_density(grid, origin=(0.0, 0.0, 0.0), spacing=1.0,
                  interp: str = "nearest", outside: float = 0.0,
                  quantize: int | None = None):
    """3-D gridded medium (CT phantom / simulation snapshot) as a
    ``variable_n_fn`` callable: ``grid[ix, iy, iz]`` is the density at
    ``origin + (ix, iy, iz) * spacing``.

    ``interp="nearest"`` snaps to the closest voxel center (coverage
    ``origin - spacing/2`` to ``origin + (shape - 1/2) * spacing``);
    ``"trilinear"`` interpolates the 8 surrounding voxels (coverage the
    voxel-center hull; exact for fields linear in position). Positions
    outside the coverage read ``outside`` (default vacuum).

    Fused tiers (the analog of the reference keeping its user n(r) inside
    the OpenCL kernel, physicl/light.py:295-315); the fused chunk reads the
    flat f32 grid by a direct gather either way:

    * grids with <= 256 DISTINCT values — segmented material phantoms,
      which is what real CT workloads are — form the CODEBOOK tier and
      fuse up to ``MAX_FUSED_VOXELS_CODEBOOK`` entries (64^3, both
      interps). Values are exact, so fused-vs-generic parity is bitwise.
    * continuous grids fuse up to ``MAX_FUSED_VOXELS`` entries
      (``MAX_FUSED_VOXELS_TRILINEAR`` for trilinear).
    * continuous grids past the cap: pass ``quantize=K`` (2-256) to
      snap the grid to K quantile-balanced levels — applied to BOTH
      the fused and generic paths (declared semantics, exact parity;
      the max absolute snap error is reported on the returned
      callable as ``fn.quantize_err``) — which makes them codebook
      grids. Without ``quantize=`` they are marked
      ``pallas_incompatible`` and the planner reports a structured
      ``field-fn-gather`` refusal: the pipeline runs on the generic
      jitted-scan path (XLA lowers arbitrary gathers natively there).
      For huge 3-D data consider :func:`layered_density` along the
      dominant axis, or coarsen the grid under the cap.
    """
    grid = jnp.asarray(raw_code_value(grid), jnp.float32)
    if grid.ndim != 3:
        raise ValueError(f"grid must be 3-D (nx, ny, nz), got {grid.shape}")
    if interp not in ("nearest", "trilinear"):
        raise ValueError(f"interp must be 'nearest' or 'trilinear', "
                         f"got {interp!r}")
    origin = np.asarray(raw_code_value(origin), np.float64).reshape(3)
    spacing = np.broadcast_to(
        np.asarray(raw_code_value(spacing), np.float64).ravel(), (3,))
    if (spacing <= 0).any():
        raise ValueError("spacing must be positive")
    nx, ny, nz = grid.shape
    outside = float(raw_code_value(outside))

    flat_np = np.asarray(grid, np.float32).reshape(-1)
    quantize_err = 0.0
    if quantize is not None:
        q = int(raw_code_value(quantize))
        if not 2 <= q <= 256:
            raise ValueError(f"quantize must be in [2, 256], got {q}")
        if np.unique(flat_np).size > q:
            # quantile-balanced bins (equal voxel mass per level), each
            # represented by its bin mean; empty/duplicate bins collapse
            edges = np.unique(np.quantile(
                flat_np, np.linspace(0.0, 1.0, q + 1)[1:-1]))
            bins = np.searchsorted(edges, flat_np, side="right")
            sums = np.bincount(bins, weights=flat_np.astype(np.float64),
                               minlength=edges.size + 1)
            cnts = np.bincount(bins, minlength=edges.size + 1)
            reps = (sums / np.maximum(cnts, 1)).astype(np.float32)
            snapped = reps[bins]
            quantize_err = float(np.abs(snapped - flat_np).max())
            flat_np = snapped
            # the generic path MUST see the same snapped values: the
            # quantization is declared semantics, not a fused-only
            # approximation — fused-vs-generic parity stays exact
            grid = jnp.asarray(flat_np.reshape(nx, ny, nz))

    def fn(r0, r1, r2):
        dtype = r0.dtype
        fx = (r0 - origin[0]) / spacing[0]
        fy = (r1 - origin[1]) / spacing[1]
        fz = (r2 - origin[2]) / spacing[2]
        if interp == "nearest":
            inside = ((fx >= -0.5) & (fx < nx - 0.5)
                      & (fy >= -0.5) & (fy < ny - 0.5)
                      & (fz >= -0.5) & (fz < nz - 0.5))
            ix = jnp.clip(jnp.round(fx).astype(jnp.int32), 0, nx - 1)
            iy = jnp.clip(jnp.round(fy).astype(jnp.int32), 0, ny - 1)
            iz = jnp.clip(jnp.round(fz).astype(jnp.int32), 0, nz - 1)
            val = grid[ix, iy, iz].astype(dtype)
            return jnp.where(inside, val, jnp.asarray(outside, dtype))
        inside = ((fx >= 0) & (fx <= nx - 1) & (fy >= 0) & (fy <= ny - 1)
                  & (fz >= 0) & (fz <= nz - 1))
        x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, nx - 2)
        y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, ny - 2)
        z0 = jnp.clip(jnp.floor(fz).astype(jnp.int32), 0, nz - 2)
        tx = jnp.clip(fx - x0, 0.0, 1.0).astype(dtype)
        ty = jnp.clip(fy - y0, 0.0, 1.0).astype(dtype)
        tz = jnp.clip(fz - z0, 0.0, 1.0).astype(dtype)
        val = jnp.zeros_like(tx)
        for dx_ in (0, 1):
            wx = (1.0 - tx) if dx_ == 0 else tx
            for dy_ in (0, 1):
                wy = (1.0 - ty) if dy_ == 0 else ty
                for dz_ in (0, 1):
                    wz = (1.0 - tz) if dz_ == 0 else tz
                    corner = grid[x0 + dx_, y0 + dy_, z0 + dz_].astype(dtype)
                    val = val + wx * wy * wz * corner
        return jnp.where(inside, val, jnp.asarray(outside, dtype))

    cap = (MAX_FUSED_VOXELS if interp == "nearest"
           else MAX_FUSED_VOXELS_TRILINEAR)
    cbcap = (MAX_FUSED_VOXELS_CODEBOOK if interp == "nearest"
             else MAX_FUSED_VOXELS_TRILINEAR_CODEBOOK)
    # static metadata the fused chunk builder (ops/fused.py) turns into
    # a table input + in-kernel gather field
    base_spec = {
        "flat": flat_np,
        "shape": (int(nx), int(ny), int(nz)),
        "origin": (float(origin[0]), float(origin[1]), float(origin[2])),
        "spacing": (float(spacing[0]), float(spacing[1]),
                    float(spacing[2])),
        "outside": outside,
        "interp": interp,
    }
    vals, codes = np.unique(flat_np, return_inverse=True)
    cb_spec = None
    if vals.size <= 256 and flat_np.size <= cbcap:
        bits = 2 if vals.size <= 4 else (4 if vals.size <= 16 else 8)
        per = 32 // bits
        cb_rows = (-(-flat_np.size // (per * 128))
                   + -(-max(int(vals.size), 1) // 128))
        cb_spec = dict(base_spec, kind="codebook", bits=bits,
                       codes=codes.astype(np.uint8).reshape(-1),
                       codebook=vals.astype(np.float32))
    f32_rows = -(-flat_np.size // 128)
    if cb_spec is not None and (flat_np.size > cap
                                or cb_rows + 1 < f32_rows):
        fn.vox_spec = cb_spec           # fewer walked rows, exact values
    elif flat_np.size <= cap:
        fn.vox_spec = dict(base_spec, kind="f32")
    else:
        fn.pallas_incompatible = True   # > 256 distinct values past the
        # f32 cap: quantize=K (2-256) opts into a codebook snap; the
        # planner's field-fn-gather refusal names this escape hatch
    fn.quantize_err = quantize_err
    return fn


class ScatterIsotropicStep(Step):
    """Isotropic scatter with optional lambda^-4 (Rayleigh-like) weighting and
    variable number density n(r) (reference: physicl/light.py:262-359).

    Statistical parity: ``pcoll = A * n(r) * |dr| * ((h c / E)^-4 if enabled)``,
    inclusive ``>=`` collision test, resample with theta=2*pi*U, phi=pi*U
    (angle-uniform — the reference's distribution, preserved on purpose), and
    ``dv = v_new - v_old`` (the CL path's semantics; the reference's Python twin
    writes dv = v_old, a documented quirk not replicated).
    """

    def __init__(self, **kwargs):
        self.n = _as_code(kwargs.get("n", 1))
        self.A = _as_code(kwargs.get("A", 1))
        self.wavelength_dep_scattering = kwargs.get("wavelength_dep_scattering", False)
        self.variable_n = kwargs.get("variable_n", False)
        self.variable_n_fn = kwargs.get("variable_n_fn", None)
        self._n_fn = (_compile_variable_n(self.variable_n_fn)
                      if self.variable_n else None)
        self._c = None
        self._coef = None
        self._wl_base = None

    def setup(self, sim: Simulation) -> None:
        self._c = float(raw_code_value(c))
        hc = float(raw_code_value(h)) * float(raw_code_value(c))
        # Fold all static factors in float64 on the host so no f32 intermediate
        # under/overflows on device. The reference computes pow(hc/E, -4) raw in
        # float64 OpenCL (physicl/light.py:301); in f32 that blows the exponent
        # range, so we compute pcoll = coef * n_var * norm * (E * wl_base)^4
        # where wl_base^4 carries A (and constant n) at the 1/4 power.
        if self.wavelength_dep_scattering:
            folded = self.A * (1.0 if self.variable_n else self.n)
            self._wl_base = (1.0 / hc) * folded ** 0.25
            self._coef = 1.0
        else:
            self._wl_base = None
            self._coef = self.A * (1.0 if self.variable_n else self.n)

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        if self._c is None:
            self.setup(None)
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
        theta = u3[0] * (2 * np.pi)
        phi = u3[1] * np.pi
        scatter = (pcoll >= u3[2]) & (state.otype == OBJ_PHOTON) & state.alive

        sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
        sin_p, cos_p = jnp.sin(phi), jnp.cos(phi)
        c_val = jnp.asarray(self._c, dtype)
        v_new = jnp.stack([sin_t * cos_p, sin_t * sin_p, cos_t]) * c_val

        v = jnp.where(scatter, v_new, state.v)
        dv = jnp.where(scatter, v_new - state.v, jnp.zeros_like(state.v))
        return state.replace(v=v, dv=dv)


# Public docs and every example call it ScatterSphericalStep
# (docs/_build/phys.html:96 vs physicl/light.py:262) — export both names.
ScatterSphericalStep = ScatterIsotropicStep


def _hg_direction(d, cos_t, sin_t, cos_p, sin_p):
    """Rotate unit direction ``d`` (stack of 3 component arrays) by polar
    angle theta (cos/sin given) and azimuth phi around it.

    Branch-free orthonormal basis (Duff et al. 2017): robust for every
    incoming direction including ±z, all elementwise ops.
    """
    x, y, z = d
    sign = jnp.where(z >= 0, jnp.float32(1.0), jnp.float32(-1.0))
    a = -1.0 / (sign + z)
    b = x * y * a
    e1 = (1.0 + sign * x * x * a, sign * b, -sign * x)
    e2 = (b, sign + y * y * a, -y)
    return tuple(
        cos_t * dd + sin_t * (cos_p * u + sin_p * w)
        for dd, u, w in zip((x, y, z), e1, e2))


class ScatterHenyeyGreensteinStep(Step):
    """Anisotropic scattering with the Henyey-Greenstein phase function —
    the standard single-parameter model for forward/backward-peaked (Mie
    regime, aerosols, tissue) scattering. No reference counterpart (the
    reference only has isotropic scattering, physicl/light.py:262);
    extension in the same family: ``pcoll = A * n(r) * |dr|`` with the same
    inclusive ``>=`` collision test and optional ``variable_n`` /
    ``wavelength_dep_scattering``, but the outgoing direction is drawn
    RELATIVE to the incoming one:

    ``cos(theta) = (1 + g^2 - ((1 - g^2) / (1 - g + 2 g U))^2) / (2 g)``
    (exact HG inverse CDF; ``g=0`` reduces to area-uniform isotropic),
    azimuth uniform. The anisotropy parameter ``g`` in (-1, 1) is the mean
    scattering cosine: <cos theta> == g.

    Runs on the fused Pallas path (op kind "hg") and the generic scan with
    statistically identical distributions.
    """

    def __init__(self, **kwargs):
        self.g = float(kwargs.get("g", 0.0))
        if not -1.0 < self.g < 1.0:
            raise ValueError(f"g must be in (-1, 1), got {self.g}")
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

    # pcoll folding is identical to the isotropic family
    setup = ScatterIsotropicStep.setup

    def _cos_theta(self, u, dtype):
        g = jnp.asarray(self.g, dtype)
        if abs(self.g) < 1e-7:
            return 2.0 * u - 1.0  # exact isotropic limit
        s = (1.0 - g * g) / (1.0 - g + 2.0 * g * u)
        ct = (1.0 + g * g - s * s) / (2.0 * g)
        return jnp.clip(ct, -1.0, 1.0)

    def _rotated_velocity(self, state, scatter, cos_t, u_phi, dtype):
        """Rotate each scattering particle's velocity by ``cos_t`` (polar,
        relative to the incoming direction) and a uniform azimuth drawn
        from ``u_phi``; returns the blended ``(v, dv)`` with ``|v|``
        renormalized to exactly the family speed. Shared by every
        relative-frame scatter step (HG/Rayleigh/Compton)."""
        sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
        phi = u_phi * (2 * np.pi)
        cos_p, sin_p = jnp.cos(phi), jnp.sin(phi)
        inv_v = jax.lax.rsqrt(jnp.maximum(
            jnp.sum(state.v * state.v, axis=0), jnp.asarray(1e-30, dtype)))
        d = tuple(state.v[i] * inv_v for i in range(3))
        n_new = _hg_direction(d, cos_t, sin_t, cos_p, sin_p)
        # renormalize so |v| stays exactly the particle speed
        inv_n = jax.lax.rsqrt(sum(x * x for x in n_new))
        c_val = jnp.asarray(self._c, dtype) * inv_n
        v_new = jnp.stack([x * c_val for x in n_new])
        v = jnp.where(scatter, v_new, state.v)
        dv = jnp.where(scatter, v_new - state.v, jnp.zeros_like(state.v))
        return v, dv

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        if self._c is None:
            self.setup(None)
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

        cos_t = self._cos_theta(u3[1], dtype)
        v, dv = self._rotated_velocity(state, scatter, cos_t, u3[2], dtype)
        return state.replace(v=v, dv=dv)


def _tabulated_cos_icdf(mu, pdf, bins=64):
    """Build a traced inverse CDF ``u -> cos(theta)`` from a tabulated phase
    function ``pdf(mu)`` over a grid ``mu`` in [-1, 1].

    Host precompute: trapezoid CDF, inverted onto ``bins`` uniform-in-u
    knots. The returned closure is GATHER-FREE (uniform knots => the
    segment index is ``floor(u * bins)``; evaluation is a mask-multiply
    over folded scalar knots) so it traces into the fused chunk the same
    way PlanckSampler.icdf does."""
    mu = np.asarray(mu, np.float64)
    pdf = np.asarray(pdf, np.float64)
    if mu.ndim != 1 or mu.size < 2 or pdf.shape != mu.shape:
        raise ValueError("phase_table needs matching 1-D (mu, pdf) arrays "
                         "with >= 2 points")
    if not (np.all(np.diff(mu) > 0) and mu[0] >= -1.0 - 1e-9
            and mu[-1] <= 1.0 + 1e-9):
        raise ValueError("phase_table mu grid must be strictly increasing "
                         "within [-1, 1]")
    if np.any(pdf < 0) or not np.isfinite(pdf).all():
        raise ValueError("phase_table pdf must be finite and nonnegative")
    areas = 0.5 * (pdf[1:] + pdf[:-1]) * np.diff(mu)
    total = areas.sum()
    if total <= 0:
        raise ValueError("phase_table pdf integrates to zero")
    cdf = np.concatenate([[0.0], np.cumsum(areas)]) / total
    knots = np.interp(np.linspace(0.0, 1.0, int(bins) + 1), cdf, mu)
    m0 = tuple(float(x) for x in knots[:-1])
    dm = tuple(float(b - a) for a, b in zip(knots[:-1], knots[1:]))
    nb = int(bins)

    def icdf(u):
        x = u * nb
        acc = None
        for k in range(nb):
            lo = (x >= k) if k else (x >= -1.0)  # u=0 falls in segment 0
            sel = lo & (x < k + 1) if k < nb - 1 else lo
            val = jnp.where(sel, m0[k] + (x - k) * dm[k], 0.0)
            acc = val if acc is None else acc + val
        return acc

    return icdf


def mie_phase_table(x, m=1.33 + 0.0j, n_mu=361):
    """Mie scattering phase function for a homogeneous sphere — the
    standard Bohren & Huffman series — as a ``(mu_grid, pdf)`` pair ready
    for :class:`ScatterPhaseFunctionStep` (host-side numpy; computed once
    at construction, like the reference's host-side Planck CDF).

    ``x = 2 pi a / lambda`` is the size parameter, ``m`` the (complex)
    refractive index of the sphere relative to the medium. The unpolarized
    phase function is ``p(mu) ~ (|S1|^2 + |S2|^2) / 2`` with the amplitude
    functions built from the Mie coefficients ``a_n, b_n`` (logarithmic-
    derivative downward recurrence) and the angular functions ``pi_n,
    tau_n`` (upward recurrence in mu). Also returns the asymmetry
    parameter ``g = <cos theta>`` from the closed-form coefficient series
    — the classic self-consistency check against the table's own first
    moment (pinned in tests to 1e-3).

    Returns ``(mu, pdf, g)``. In the Rayleigh limit (``x -> 0``) the shape
    reduces to the dipole ``1 + mu^2``; large ``x`` gives the strong Mie
    forward peak (use more ``table_bins`` to resolve it).
    """
    x = float(x)
    if x <= 0:
        raise ValueError(f"size parameter x must be positive, got {x}")
    m = complex(m)
    mu = np.linspace(-1.0, 1.0, int(n_mu))
    N = max(3, int(np.ceil(x + 4.05 * x ** (1.0 / 3.0) + 2)))

    # logarithmic derivative D_n(mx) by downward recurrence (stable)
    mx = m * x
    nmx = max(N, int(np.ceil(abs(mx)))) + 16
    D = np.zeros(nmx + 1, np.complex128)
    for k in range(nmx, 0, -1):
        D[k - 1] = k / mx - 1.0 / (D[k] + k / mx)

    # Riccati-Bessel psi, chi by upward recurrence; xi = psi - i*chi
    psi = np.zeros(N + 1)
    chi = np.zeros(N + 1)
    psi_m1, chi_m1 = np.cos(x), -np.sin(x)  # psi_{-1}, chi_{-1}
    psi[0], chi[0] = np.sin(x), np.cos(x)
    for k in range(1, N + 1):
        psi[k] = (2 * k - 1) / x * psi[k - 1] - (psi[k - 2]
                                                 if k >= 2 else psi_m1)
        chi[k] = (2 * k - 1) / x * chi[k - 1] - (chi[k - 2]
                                                 if k >= 2 else chi_m1)
    xi = psi - 1j * chi
    n_arr = np.arange(1, N + 1)
    Dn = D[1:N + 1]
    fa = Dn / m + n_arr / x
    fb = Dn * m + n_arr / x
    a = (fa * psi[1:] - psi[:-1]) / (fa * xi[1:] - xi[:-1])
    b = (fb * psi[1:] - psi[:-1]) / (fb * xi[1:] - xi[:-1])

    # angular functions pi_n, tau_n and the amplitude sums
    S1 = np.zeros_like(mu, np.complex128)
    S2 = np.zeros_like(mu, np.complex128)
    pi_nm1 = np.zeros_like(mu)   # pi_0
    pi_n = np.ones_like(mu)      # pi_1
    for k in range(1, N + 1):
        tau_n = k * mu * pi_n - (k + 1) * pi_nm1
        f = (2 * k + 1) / (k * (k + 1))
        S1 += f * (a[k - 1] * pi_n + b[k - 1] * tau_n)
        S2 += f * (a[k - 1] * tau_n + b[k - 1] * pi_n)
        pi_nm1, pi_n = pi_n, ((2 * k + 1) * mu * pi_n
                              - (k + 1) * pi_nm1) / k
    pdf = 0.5 * (np.abs(S1) ** 2 + np.abs(S2) ** 2)

    # asymmetry parameter from the coefficient series (BH eq. 4.63)
    qsca = (2.0 / x ** 2) * np.sum((2 * n_arr + 1)
                                   * (np.abs(a) ** 2 + np.abs(b) ** 2))
    g_sum = np.sum(n_arr[:-1] * (n_arr[:-1] + 2) / (n_arr[:-1] + 1)
                   * np.real(a[:-1] * np.conj(a[1:])
                             + b[:-1] * np.conj(b[1:])))
    g_sum += np.sum((2 * n_arr + 1) / (n_arr * (n_arr + 1))
                    * np.real(a * np.conj(b)))
    g = (4.0 / (x ** 2 * qsca)) * g_sum
    return mu, pdf, float(g)


class ScatterPhaseFunctionStep(ScatterHenyeyGreensteinStep):
    """Anisotropic scattering with a USER-DEFINED phase function — Mie
    lookup tables, measured aerosol/tissue phase functions, any analytic
    form beyond HG/Rayleigh (extension; no reference counterpart).

    Same collision model and relative-frame rotation as the HG/Rayleigh
    family (``pcoll = A * n(r) * |dr|``, optional lambda^-4 weighting,
    azimuth uniform); the polar angle comes from the user, one of:

    * ``cos_theta_icdf`` — a traced callable ``u -> cos(theta)`` mapping a
      uniform in [0, 1) to the scattering cosine (the exact-inverse-CDF
      route; must be pure jnp, like ``variable_n_fn`` callables);
    * ``phase_table=(mu_grid, pdf)`` — a tabulated phase function,
      converted at construction into a gather-free piecewise-linear
      inverse CDF over ``table_bins`` (default 64) uniform-in-u knots
      (inversion error ~ O(bins^-2) in the CDF).

    Fuses (op kind "phase": the callable traces straight into the Pallas
    kernel, the same mechanism as PlanckSampler.icdf emitters) and runs
    the generic scan identically. Unknown options raise (the strict
    Compton convention).
    """

    _OPTIONS = {"n", "A", "wavelength_dep_scattering", "variable_n",
                "variable_n_fn", "cos_theta_icdf", "phase_table",
                "table_bins"}

    def __init__(self, **kwargs):
        unknown = set(kwargs) - self._OPTIONS
        if unknown:
            raise ValueError(f"unknown option(s) {sorted(unknown)}; "
                             f"supported: {sorted(self._OPTIONS)}")
        icdf = kwargs.pop("cos_theta_icdf", None)
        table = kwargs.pop("phase_table", None)
        bins = int(kwargs.pop("table_bins", 64))
        if (icdf is None) == (table is None):
            raise ValueError("pass exactly one of cos_theta_icdf= or "
                             "phase_table=(mu_grid, pdf)")
        if icdf is not None:
            if not callable(icdf):
                raise TypeError("cos_theta_icdf must be a callable "
                                "u -> cos(theta)")
            self._icdf = icdf
        else:
            self._icdf = _tabulated_cos_icdf(table[0], table[1], bins)
        super().__init__(**kwargs)

    def _cos_theta(self, u, dtype):
        return jnp.clip(jnp.asarray(self._icdf(u), dtype), -1.0, 1.0)


def _rayleigh_cos_theta(u, dtype, fast=False):
    """Exact inverse CDF of the Rayleigh (dipole) phase function
    ``p(cos) = (3/8)(1 + cos^2)``: the CDF ``(c^3 + 3c + 4)/8 = u`` gives
    the depressed cubic ``c^3 + 3c = 8u - 4`` whose single real root
    (discriminant ``w^2 + 1 > 0``) is, by Cardano with ``w = 4u - 2`` and
    ``s = sqrt(w^2 + 1)``: ``c = A - 1/A`` where ``A = cbrt(w + s)`` (the
    second Cardano term folds via ``(w+s)(w-s) = -1``). ``w + s`` lies in
    ``[sqrt(5)-2, sqrt(5)+2]`` — positive and bounded away from 0 — so the
    cube root is computed as ``exp(log/3)``, safe in f32 and available
    inside the Pallas kernel; ``fast=True`` (the fused kernel) computes it
    as ``2^(log2/3)`` with the kernel's polynomial log2/exp2 forms
    (ops/fused) — rel err ~2e-6 in the root, zero transcendentals."""
    w = 4.0 * u - 2.0
    s = jnp.sqrt(w * w + 1.0)
    if fast:
        from physicl_tpu.ops.fused import _fast_exp2, _fast_log2

        a = _fast_exp2(_fast_log2(w + s) * jnp.asarray(1.0 / 3.0, dtype))
    else:
        a = jnp.exp(jnp.log(w + s) * jnp.asarray(1.0 / 3.0, dtype))
    return jnp.clip(a - 1.0 / a, -1.0, 1.0)


class ScatterRayleighStep(ScatterHenyeyGreensteinStep):
    """Rayleigh scattering with the TRUE dipole phase function
    ``p(cos theta) = (3/8)(1 + cos^2 theta)`` (outgoing direction relative
    to the incoming one, azimuth uniform).

    The reference's Rayleigh treatment (physicl/light.py:262-359) applies
    the lambda^-4 *cross-section* but redirects isotropically — unphysical
    for sky/atmosphere problems where the angular distribution matters.
    This step samples the exact phase function via a closed-form Cardano
    inverse CDF (defining property ``<cos^2 theta> = 2/5`` vs ``1/3`` for
    isotropic; ``<cos theta> = 0`` by symmetry). Collision model, options
    (``A``, ``n``, ``variable_n``, ``wavelength_dep_scattering`` — enable
    the latter for the full lambda^-4 Rayleigh cross-section), fused path
    (op kind "rayl") and generic scan all match the
    :class:`ScatterHenyeyGreensteinStep` family.
    """

    def __init__(self, **kwargs):
        kwargs.pop("g", None)  # no anisotropy parameter: the phase is fixed
        super().__init__(**kwargs)

    def _cos_theta(self, u, dtype):
        return _rayleigh_cos_theta(u, dtype)


# Koblinger's direct method is exact (and rejection-free) for
# alpha >= 1 + sqrt(3); below that the 1/x coefficient of the decomposition
# goes negative and Kahn's rejection method (efficiency >= ~0.55 there)
# takes over. Selection is per photon.
_KOBLINGER_ALPHA = 1.0 + np.sqrt(3.0)


# Chebyshev-node interpolant (degree 12 on [0, 0.55], max rel err 2e-6 in
# f32 Horner) of the cancelling bracket B(a) = (2a(1+a)/(1+2a) - ln(1+2a))/a^3
# = 4/3 - 4a + 48/5 a^2 - ...; same technique as the Planck iCDF fits.
_KN_BRACKET_COEF = (
    1.333333331559978, -3.9999989065937434, 9.599886818715182,
    -21.32866514870082, 45.6125841138609, -94.65335761570726,
    187.33218719339675, -337.6267278947943, 517.0327212167587,
    -620.1496910093555, 530.1148157280105, -281.973132286615,
    69.37461960979472)


def _kn_sigma_ratio(alpha, dtype, fast=False):
    """sigma_KN(alpha) / sigma_Thomson — the exact Klein-Nishina total
    cross-section ratio (alpha = E / m_e c^2), f32-accurate to <2e-5 over
    alpha in [0, 1e4] (pinned vs an f64 host oracle in tests/test_compton.py
    for BOTH the libm and the ``fast=True`` polynomial-log2 forms).

    The closed form cancels catastrophically in f32 below alpha ~ 0.5 (the
    bracket 2a(1+a)/b - ln b is O(a^3) against O(a) terms, and error grows
    as eps/a^2), so three branches: Taylor series ``1 - 2a + 26/5 a^2 -
    133/10 a^3`` below 0.01, a cancellation-free middle form for
    [0.01, 0.5) whose bracket/a^3 is the Chebyshev polynomial above, and
    the exact closed form at >= 0.5 where it is stable; all elementwise
    ops, so it traces into the fused chunk."""
    a = jnp.maximum(jnp.asarray(alpha, dtype), jnp.asarray(1e-6, dtype))
    b = 1.0 + 2.0 * a
    if fast:  # ln b = ln2 * log2 b, abs err ~3.4e-8: inside the 2e-5 pin
        from physicl_tpu.ops.fused import _fast_log2

        log_b = jnp.asarray(np.log(2.0), dtype) * _fast_log2(b)
    else:
        log_b = jnp.log(b)
    exact = 0.75 * (
        (1.0 + a) / (a * a * a) * (2.0 * a * (1.0 + a) / b - log_b)
        + log_b / (2.0 * a)
        - (1.0 + 3.0 * a) / (b * b))
    g = jnp.asarray(_KN_BRACKET_COEF[-1], dtype)
    for c in _KN_BRACKET_COEF[-2::-1]:
        g = g * a + jnp.asarray(c, dtype)
    mid = 0.75 * ((1.0 + a) * g + log_b / (2.0 * a)
                  - (1.0 + 3.0 * a) / (b * b))
    a0 = jnp.asarray(alpha, dtype)
    series = 1.0 + a0 * (-2.0 + a0 * (jnp.asarray(26.0 / 5.0, dtype)
                                      + a0 * jnp.asarray(-133.0 / 10.0,
                                                         dtype)))
    return jnp.where(a0 < 0.01, series,
                     jnp.where(a0 < 0.5, mid, exact))


def _kn_cos_eta(alpha, triples, dtype, fast=False):
    """Sample the Klein-Nishina angular distribution for per-element photon
    energies ``alpha = E / m_e c^2``.

    ``triples`` is a static-length list of (r1, r2, r3) uniform draws (the
    Kahn tries; the first triple's (r1, r2) are reused as Koblinger's two
    draws on the disjoint high-alpha lanes). Returns ``(cos_theta, eta,
    accepted)`` with ``eta = E/E' = 1 + alpha (1 - cos_theta)``.

    Kahn's method (alpha < 1+sqrt(3)): decompose the per-unit-eta density
    (1/x^2)(x + 1/x - 1 + cos^2) = (1/x - 1/x^2) + (1/x^2)(1/x + cos^2)
    into branch A (eta uniform on [1, 1+2a], accept with 4(1/eta - 1/eta^2))
    chosen with probability (1+2a)/(9+2a), and branch B (eta ~ 1/eta^2,
    accept with (cos^2 + 1/eta)/2). cos_theta uses the cancellation-free
    forms ``1 - 2 r2`` (A) and ``1 - 2(1-r2)/(1+2a r2)`` (B), stable at any
    alpha. Elements still unaccepted after all tries report
    ``accepted=False`` (probability <= ~0.45^tries; callers suppress the
    scatter, an O(1e-4) collision-rate bias at the default 12 tries).

    Koblinger's direct method (alpha >= 1+sqrt(3)): the same density
    expanded as A1/x + A2/x^2 + A3/x^3 + A4 has all-positive weights, each
    piece inverse-CDF sampleable — branch-free, always accepted. Both
    samplers verified exact (chi^2/dof ~= 1 over 50 bins at 2e7 samples)
    against the bin-integrated analytic distribution for alpha in
    [0.01, 500]."""
    one = jnp.asarray(1.0, dtype)
    a = jnp.maximum(jnp.asarray(alpha, dtype), jnp.asarray(1e-9, dtype))
    two_a = 2.0 * a
    b = one + two_a

    # --- Kahn rejection loop (static unroll; the fused kernel's sampler,
    # ops/fused._kn_cos_eta_fused, statically unrolls the same per-try math
    # — the r4b lax.fori_loop experiment measured 25-30% slower end-to-end
    # and was reverted)
    eta = jnp.ones_like(a)
    cos_t = jnp.ones_like(a)
    accepted = jnp.zeros_like(a, dtype=bool)
    p_branch_a = b / (b + 8.0)
    for r1, r2, r3 in triples:
        eta, cos_t, accepted = _kn_try(
            two_a, b, p_branch_a, r1, r2, r3, eta, cos_t, accepted, dtype)

    return _kn_koblinger_tail(alpha, a, two_a, b, triples[0][0],
                              triples[0][1], eta, cos_t, accepted, dtype,
                              fast=fast)


def _kn_try(two_a, b, p_branch_a, r1, r2, r3, eta, cos_t, accepted, dtype):
    """One Kahn rejection try (shared by the unrolled generic sampler and
    the kernel's loop form — extract-only refactor, bitwise identical)."""
    one = jnp.asarray(1.0, dtype)
    br_a = r1 <= p_branch_a
    # 1 + 2a*r2 doubles as branch A's eta AND branch B's denominator
    eta_a = one + two_a * r2
    inv_a = one / eta_a
    ok_a = r3 <= 4.0 * (inv_a - inv_a * inv_a)
    eta_b = b * inv_a
    cos_b = one - 2.0 * (one - r2) * inv_a
    ok_b = r3 <= 0.5 * (cos_b * cos_b + eta_a / b)
    # logical blend of the two branches' acceptance masks
    not_a = jnp.logical_not(br_a)
    ok = (br_a & ok_a) | (not_a & ok_b)
    take = ok & jnp.logical_not(accepted)
    eta = jnp.where(take, jnp.where(br_a, eta_a, eta_b), eta)
    cos_t = jnp.where(take, jnp.where(br_a, one - 2.0 * r2, cos_b),
                      cos_t)
    return eta, cos_t, accepted | ok


def _kn_koblinger_tail(alpha, a, two_a, b, u_pick, u_inv, eta, cos_t,
                       accepted, dtype, fast=False):
    """Koblinger direct sampling on the disjoint high-alpha lanes (reuses
    the first Kahn triple's r1, r2 as its two draws). ``fast=True`` (the
    fused kernel) computes the log and the 1/x-piece power ``b^u =
    2^(u log2 b)`` with the polynomial log2/exp2 forms (ops/fused) — rel
    err ~1e-6 in eta, zero transcendentals; the generic path keeps libm."""
    one = jnp.asarray(1.0, dtype)
    inv_a1 = one / a
    inv_a2 = inv_a1 * inv_a1
    if fast:
        from physicl_tpu.ops.fused import _fast_exp2, _fast_log2

        log2_b = _fast_log2(b)
        log_b = jnp.asarray(np.log(2.0), dtype) * log2_b
        x1 = _fast_exp2(u_inv * log2_b)              # 1/x piece: b^u
    else:
        log_b = jnp.log(b)
        x1 = jnp.exp(u_inv * log_b)                  # 1/x piece: b^u
    w1 = (one - 2.0 * inv_a1 - 2.0 * inv_a2) * log_b
    w2 = (2.0 * inv_a1 + inv_a2) * (two_a / b)
    inv_b2 = one / (b * b)
    w3 = 0.5 * (one - inv_b2)
    w4 = inv_a2 * two_a
    t = u_pick * (w1 + w2 + w3 + w4)
    x2 = b / (b - two_a * u_inv)                     # 1/x^2 piece
    # 1/x^3 piece: 1 - u*(1 - 1/b^2) loses the 1/b^2 term to f32 rounding
    # once b > ~4096 (the sampled tail then caps at eta ~ 4096 instead of
    # b); the algebraically equal (1-u) + u/b^2 is cancellation-free at
    # any alpha
    x3 = jax.lax.rsqrt(jnp.maximum((one - u_inv) + u_inv * inv_b2,
                                   jnp.asarray(1e-30, dtype)))
    x4 = one + two_a * u_inv                         # constant piece
    x = jnp.where(t < w1, x1,
                  jnp.where(t < w1 + w2, x2,
                            jnp.where(t < w1 + w2 + w3, x3, x4)))
    hi = jnp.asarray(alpha, dtype) >= _KOBLINGER_ALPHA
    eta = jnp.where(hi, x, eta)
    cos_t = jnp.where(hi, one - (x - one) * inv_a1, cos_t)
    # a literal -1 (not -one): the Triton route cannot negate a constant
    cos_t = jnp.clip(cos_t, jnp.asarray(-1.0, dtype), one)
    accepted = accepted | hi
    return cos_t, eta, accepted


def _gauss3_from_uniform(u4, dtype, fast_trig=False):
    """Three standard normals from four uniforms via Box-Muller (the fourth
    normal is discarded). ``u4`` is a stack of 4 uniform arrays in [0, 1);
    all elementwise ops, so it traces into the fused chunk.

    ``fast_trig=True`` (the fused kernel) replaces the 5 transcendentals
    with the kernel's polynomial forms: ``ops.fused._fast_sinpi`` for the
    angle factors (1.1e-3 abs error — a 0.06-degree wobble on an already-
    isotropic Maxwell angle; per-axis variance shifts < 2.3e-3 relative,
    invisible to the SZ/Kompaneets chi2 validations, re-run on chip r5)
    and ``_fast_neg2log`` for the radii (~7e-8 in ln — tail-exact, the
    part that must NOT be approximated: the Kompaneets drift rides the
    Maxwell speed distribution). The generic path keeps the exact libm
    forms."""
    tiny = jnp.asarray(1e-12, dtype)
    if fast_trig:
        from physicl_tpu.ops.fused import (_fast_neg2log, _fast_sinpi,
                                           _wrap1)

        r1 = jnp.sqrt(_fast_neg2log(jnp.maximum(u4[0], tiny)))
        r2 = jnp.sqrt(_fast_neg2log(jnp.maximum(u4[2], tiny)))
        two_a1 = 2.0 * u4[1]
        two_a2 = 2.0 * u4[3]
        cos_a1 = _fast_sinpi(_wrap1(two_a1 + jnp.asarray(0.5, dtype)))
        sin_a1 = _fast_sinpi(_wrap1(two_a1))
        cos_a2 = _fast_sinpi(_wrap1(two_a2 + jnp.asarray(0.5, dtype)))
        return (r1 * cos_a1, r1 * sin_a1, r2 * cos_a2)
    r1 = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u4[0], tiny)))
    r2 = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u4[2], tiny)))
    a1 = u4[1] * (2 * np.pi)
    a2 = u4[3] * (2 * np.pi)
    return (r1 * jnp.cos(a1), r1 * jnp.sin(a1), r2 * jnp.cos(a2))


def _aberrate(n, beta, bn, b2, gamma, sign, dtype):
    """Relativistic aberration of a unit direction ``n`` under a boost of
    velocity ``beta`` (tuple of components, ``bn = beta.n``, ``b2 =
    |beta|^2``): photon 4-momentum transform p' = Lambda p. ``sign`` = -1
    boosts lab -> electron frame, +1 boosts back. Returns (n', doppler)
    with ``E' = E * gamma * (1 + sign * bn) = E * doppler``; n' is NOT
    renormalized (caller divides, or uses the closed form)."""
    one = jnp.asarray(1.0, dtype)
    # beta_hat * ((gamma-1) * mu -/+ gamma*b) written over the beta VECTOR:
    # coef = (gamma-1) * bn / b2 + sign * gamma  (finite at b2 -> 0 via max)
    coef = (gamma - one) * bn / jnp.maximum(b2, jnp.asarray(1e-20, dtype)) \
        + sign * gamma
    doppler = gamma * (one + sign * bn)
    inv = one / doppler
    n_out = tuple((n[i] + beta[i] * coef) * inv for i in range(3))
    return n_out, doppler


def _ic_thermal_scatter(E, n, inv_mec2, theta_e, u4, kn_sample, u_phi,
                        dtype, fast_trig=False):
    """One inverse-Compton scatter off a thermal electron, exact in the
    electron rest frame.

    ``n`` is the unit photon direction (3-tuple of arrays); ``u4`` a stack
    of 4 uniforms (Box-Muller electron draw); ``kn_sample(alpha1) ->
    (cos_t, eta, accepted)`` the Klein-Nishina sampler (the generic path
    closes over drawn triples via :func:`_kn_cos_eta`; the fused kernel
    passes its own static-unroll sampler closure,
    ``ops/fused._kn_cos_eta_fused``); ``u_phi`` the azimuth draw. Electron velocities are
    per-axis Gaussian (non-relativistic Maxwell, sigma^2 = theta_e =
    kT_e / m_e c^2 per axis, |beta| clipped at 0.9) — accurate for
    theta_e <~ 0.05 (kT_e <~ 25 keV: SZ clusters, warm coronae). The
    photon is boosted into the electron frame (exact Lorentz), scattered
    with the exact KN distribution at the BOOSTED energy alpha_1, and
    boosted back; energies and directions are exact for any clipped beta.

    Returns ``(E_new, n_new, alpha1, flux, accepted)``: ``flux`` is the
    relativistic relative-rate factor ``(1 - beta.n)`` the caller folds
    into pcoll (its Maxwell average is 1, so ``A`` keeps its mean-rate
    meaning; this head-on weighting is what produces the Kompaneets
    ``<dE/E> = 4 theta_e - alpha`` drift), and ``alpha1`` the
    electron-frame KN parameter for optional sigma_KN weighting."""
    one = jnp.asarray(1.0, dtype)
    sq = jnp.sqrt(jnp.asarray(float(theta_e), dtype))
    g3 = _gauss3_from_uniform(u4, dtype, fast_trig=fast_trig)
    beta = tuple(g * sq for g in g3)
    b2 = sum(b * b for b in beta)
    b = jnp.sqrt(b2)
    scale = jnp.minimum(one, jnp.asarray(0.9, dtype)
                        / jnp.maximum(b, jnp.asarray(1e-12, dtype)))
    beta = tuple(bc * scale for bc in beta)
    b2 = b2 * (scale * scale)
    gamma = jax.lax.rsqrt(jnp.maximum(one - b2, jnp.asarray(1e-4, dtype)))

    bn = sum(beta[i] * n[i] for i in range(3))
    flux = one - bn
    n1, dop1 = _aberrate(n, beta, bn, b2, gamma,
                         jnp.asarray(-1.0, dtype), dtype)
    inv_n1 = jax.lax.rsqrt(jnp.maximum(sum(x * x for x in n1),
                                       jnp.asarray(1e-30, dtype)))
    n1 = tuple(x * inv_n1 for x in n1)
    E1 = E * dop1

    alpha1 = E1 * jnp.asarray(inv_mec2, dtype)
    cos_t, eta, accepted = kn_sample(alpha1)
    E1p = E1 / eta
    sin_t = jnp.sqrt(jnp.maximum(one - cos_t * cos_t, 0.0))
    if fast_trig:  # uniform azimuth: tail-insensitive, polynomial forms
        from physicl_tpu.ops.fused import _fast_sinpi, _wrap1

        two_pu = 2.0 * u_phi
        cos_phi = _fast_sinpi(_wrap1(two_pu + jnp.asarray(0.5, dtype)))
        sin_phi = _fast_sinpi(_wrap1(two_pu))
    else:
        phi = u_phi * (2 * np.pi)
        cos_phi, sin_phi = jnp.cos(phi), jnp.sin(phi)
    n1p = _hg_direction(n1, cos_t, sin_t, cos_phi, sin_phi)
    inv_n1p = jax.lax.rsqrt(jnp.maximum(sum(x * x for x in n1p),
                                        jnp.asarray(1e-30, dtype)))
    n1p = tuple(x * inv_n1p for x in n1p)

    bnp = sum(beta[i] * n1p[i] for i in range(3))
    n_new, dop2 = _aberrate(n1p, beta, bnp, b2, gamma, one, dtype)
    inv_nn = jax.lax.rsqrt(jnp.maximum(sum(x * x for x in n_new),
                                       jnp.asarray(1e-30, dtype)))
    n_new = tuple(x * inv_nn for x in n_new)
    return E1p * dop2, n_new, alpha1, flux, accepted


class ScatterComptonStep(ScatterHenyeyGreensteinStep):
    """Compton scattering off free electrons at rest — exact Klein-Nishina
    angular distribution with the physical energy shift
    ``E' = E / (1 + alpha (1 - cos theta))``, ``alpha = E / m_e c^2``.

    The first energy-CHANGING interaction in the family (no reference
    counterpart — the reference's photons keep their energy forever,
    physicl/light.py:262-359): gamma-ray transport, Compton telescopes and
    dose deposition need the recoil energy loss. Options follow the family
    (``A``, ``n``, ``variable_n``/``variable_n_fn``; collision test
    ``pcoll = A * n(r) * |dr| >= U`` inclusive); ``wavelength_dep_scattering``
    is rejected — pass ``kn_cross_section=True`` for the physical
    energy-dependent total cross-section (pcoll is multiplied by the exact
    sigma_KN(alpha)/sigma_Thomson ratio, so ``A`` is the THOMSON
    cross-section and the KN suppression at high energy is automatic).

    Sampling: Kahn's rejection method below alpha = 1+sqrt(3), Koblinger's
    direct method above (see :func:`_kn_cos_eta`); azimuth uniform about the
    incoming direction; ``|v|`` stays exactly c (photons). ``mec2``
    overrides the electron rest energy for toy unit systems (defaults to
    the physical ``m_e c^2`` in current code units — with SI photon energies
    in J this is 8.187e-14). ``kn_max_tries`` bounds the in-kernel rejection
    loop (default 12; residual suppressed-scatter probability <= ~1e-4, only
    in the Kahn regime). Runs fused (op kind "compton") and on the generic
    scan with statistically identical distributions.

    **Thermal electrons (Comptonization)**: pass ``theta_e`` (dimensionless
    ``kT_e / m_e c^2``) or ``T_e`` (Kelvin, float or Measurement) to scatter
    off a thermal electron population instead of electrons at rest. Each
    candidate collision draws an electron from a non-relativistic Maxwell
    distribution (accurate for ``theta_e <= ~0.05``, i.e. kT_e <= ~25 keV:
    SZ clusters, warm coronae; accepted with a RuntimeWarning up to 0.2,
    where the |beta| <= 0.9 clip and missing Maxwell-Juttner corrections
    bias the Doppler kernel by O(theta_e)), weights the collision rate by
    the exact relativistic flux factor ``(1 - beta.n)``, boosts the photon
    into the electron frame, applies the exact Klein-Nishina scatter at
    the boosted energy, and boosts back. This reproduces the Kompaneets
    energy drift ``<dE/E> = 4 theta_e - alpha`` per scatter: photons below
    ``4 theta_e m_e c^2`` GAIN energy (inverse Compton / the
    Sunyaev-Zel'dovich effect), photons above it cool.
    ``kn_cross_section`` weights by sigma_KN at the electron-frame energy.

    .. warning:: keep the per-step collision probability UNSATURATED
       (``A * n * |dr| <= ~0.5``): the flux factor reaches 1.9 for
       head-on electrons, and once ``pcoll * flux`` clips at 1 the rate
       weighting stops selecting head-on collisions — the Kompaneets
       drift then biases from ``4 theta_e`` down to ``~3 theta_e``.
       Model optically-thick media with more, thinner steps.
    """

    _ALLOWED_KW = frozenset({"A", "n", "variable_n", "variable_n_fn"})

    def __init__(self, **kwargs):
        if kwargs.pop("wavelength_dep_scattering", False):
            raise ValueError(
                "ScatterComptonStep has no lambda^-4 option; use "
                "kn_cross_section=True for the physical Klein-Nishina "
                "energy dependence")
        # Compton heating tally: per-iteration NET energy transferred to
        # the electrons, sum(w * (E - E')) over scatters — the Compton
        # analog of ScatterDeleteStep(measure_deposition=True). Signed:
        # negative when thermal electrons pump the photons (inverse
        # Compton / SZ). data rows [t, E_dep]; CSV via out_fn.
        self.measure_deposition = bool(kwargs.pop("measure_deposition",
                                                  False))
        self.out_fn = kwargs.pop("out_fn", None)
        self.data = []
        if "g" in kwargs:
            raise ValueError(
                "ScatterComptonStep has no anisotropy parameter g: the "
                "angular law IS the Klein-Nishina distribution")
        self.kn_cross_section = bool(kwargs.pop("kn_cross_section", False))
        self.mec2 = kwargs.pop("mec2", None)
        self.kn_max_tries = int(kwargs.pop("kn_max_tries", 12))
        if self.kn_max_tries < 1:
            raise ValueError("kn_max_tries must be >= 1")
        theta_e = kwargs.pop("theta_e", None)
        T_e = kwargs.pop("T_e", None)
        if theta_e is not None and T_e is not None:
            raise ValueError("pass theta_e (= kT_e / m_e c^2) OR T_e "
                             "(Kelvin), not both")
        self.theta_e = None if theta_e is None else float(theta_e)
        self.T_e = T_e
        if self.theta_e is not None:
            if not 0.0 <= self.theta_e <= 0.2:
                raise ValueError(
                    f"theta_e must be in [0, 0.2] (Maxwell electron "
                    f"sampling validity; ~100 keV), got {self.theta_e}")
            if self.theta_e > 0.05:
                import warnings

                warnings.warn(
                    f"theta_e = {self.theta_e}: above ~0.05 the "
                    "non-relativistic Maxwell electron draw degrades — "
                    "P(|beta| > 0.9) grows to O(10%) and the hard clip "
                    "plus missing Maxwell-Juttner corrections bias the "
                    "Doppler kernel by O(theta_e)", RuntimeWarning,
                    stacklevel=2)
        # the HG family reads options with kwargs.get(), which would
        # silently swallow a typo (e.g. kn_cross_sectionS=True) and run
        # wrong physics — reject anything unknown loudly instead
        unknown = set(kwargs) - self._ALLOWED_KW
        if unknown:
            raise ValueError(
                f"ScatterComptonStep: unknown option(s) {sorted(unknown)}; "
                f"supported: {sorted(self._ALLOWED_KW)} + kn_cross_section/"
                "mec2/kn_max_tries/theta_e/T_e")
        super().__init__(**kwargs)
        self._inv_mec2 = None

    def setup(self, sim: Simulation) -> None:
        super().setup(sim)
        mec2 = (_as_code(self.mec2) if self.mec2 is not None
                else float(raw_code_value(m_e)) * float(raw_code_value(c)) ** 2)
        if mec2 <= 0:
            raise ValueError("mec2 must be positive")
        self._inv_mec2 = 1.0 / float(mec2)
        if self.T_e is not None:
            kT = _as_code(self.T_e) * float(raw_code_value(kB))
            self._theta_e = float(kT * self._inv_mec2)
            if not 0.0 <= self._theta_e <= 0.2:
                raise ValueError(
                    f"T_e gives theta_e = {self._theta_e:.3g}; Maxwell "
                    "electron sampling is valid for theta_e <= 0.2")
        else:
            self._theta_e = self.theta_e

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        if self._c is None or self._inv_mec2 is None:
            self.setup(None)
        dtype = state.r.dtype
        norm = _dr_norm(state)
        pcoll = jnp.asarray(self._coef, dtype) * norm
        if self._n_fn is not None:
            pcoll = pcoll * jnp.asarray(
                self._n_fn(state.r[0], state.r[1], state.r[2]), dtype)

        k = ctx.next_key()
        T = self.kn_max_tries
        thermal = self._theta_e is not None and self._theta_e > 0.0
        n_extra = 4 if thermal else 0
        u = jax.random.uniform(k, (2 + n_extra + 3 * T,) + norm.shape, dtype)
        triples = [(u[2 + n_extra + 3 * i], u[3 + n_extra + 3 * i],
                    u[4 + n_extra + 3 * i]) for i in range(T)]

        if thermal:
            inv_v = jax.lax.rsqrt(jnp.maximum(
                jnp.sum(state.v * state.v, axis=0),
                jnp.asarray(1e-30, dtype)))
            nhat = tuple(state.v[i] * inv_v for i in range(3))
            E_new, n_new, alpha1, flux, accepted = _ic_thermal_scatter(
                state.E, nhat, self._inv_mec2, self._theta_e, u[2:6],
                lambda a1: _kn_cos_eta(a1, triples, dtype), u[1], dtype)
            pcoll = pcoll * flux
            if self.kn_cross_section:
                pcoll = pcoll * _kn_sigma_ratio(alpha1, dtype)
            scatter = ((pcoll >= u[0]) & (state.otype == OBJ_PHOTON)
                       & state.alive & accepted)
            c_val = jnp.asarray(self._c, dtype)
            v_new = jnp.stack([x * c_val for x in n_new])
            v = jnp.where(scatter, v_new, state.v)
            dv = jnp.where(scatter, v_new - state.v,
                           jnp.zeros_like(state.v))
            if self.measure_deposition:
                ctx.record(self, "t", state.t)
                ctx.record(self, "dep", jnp.sum(jnp.where(
                    scatter, state.w * (state.E - E_new), 0.0)))
            E = jnp.where(scatter, E_new, state.E)
            return state.replace(v=v, dv=dv, E=E)

        alpha = state.E * jnp.asarray(self._inv_mec2, dtype)
        if self.kn_cross_section:
            pcoll = pcoll * _kn_sigma_ratio(alpha, dtype)
        cos_t, eta, accepted = _kn_cos_eta(alpha, triples, dtype)
        scatter = ((pcoll >= u[0]) & (state.otype == OBJ_PHOTON)
                   & state.alive & accepted)

        v, dv = self._rotated_velocity(state, scatter, cos_t, u[1], dtype)
        if self.measure_deposition:
            ctx.record(self, "t", state.t)
            ctx.record(self, "dep", jnp.sum(jnp.where(
                scatter, state.w * (state.E - state.E / eta), 0.0)))
        E = jnp.where(scatter, state.E / eta, state.E)
        return state.replace(v=v, dv=dv, E=E)

    def collect(self, sim, records) -> None:
        if not self.measure_deposition:
            return
        for i in range(len(records["t"])):
            self.data.append([float(records["t"][i]),
                              float(records["dep"][i])])

    # CSV at terminate, identical surface to every MeasureStep
    terminate = MeasureStep.terminate


class RefractiveInterfaceStep(Step):
    """Fresnel reflection / Snell refraction at an axis-aligned plane
    interface between two refractive media (extension; no reference
    counterpart — the reference's only geometry is an infinite homogeneous
    medium, physicl/light.py:262-359). Together with
    :class:`ScatterHenyeyGreensteinStep` and
    ``ScatterDeleteStep(implicit_capture=True)`` this completes the standard
    layered-media photon-transport toolkit (the MCML problem class: tissue
    optics, thin films, atmospheres over water).

    The interface is the plane ``r[axis] == loc`` separating a medium of
    refractive index ``n_lo`` (``r[axis] < loc``) from ``n_hi``
    (``r[axis] >= loc``). Each iteration, every photon whose position
    segment ``[r - dr, r]`` crossed the plane is interacted exactly once:

    * unpolarized Fresnel reflectance
      ``R = (rs^2 + rp^2) / 2`` with
      ``rs = (n1 cos_i - n2 cos_t) / (n1 cos_i + n2 cos_t)``,
      ``rp = (n1 cos_t - n2 cos_i) / (n1 cos_t + n2 cos_i)``;
      beyond the critical angle (``sin_t > 1``) ``R = 1`` exactly (total
      internal reflection);
    * a single uniform draw picks reflection (probability ``R``) or
      transmission; the photon is moved to the segment/plane intersection
      and the REMAINDER of its step is retraced in the outgoing direction
      (specular mirror for reflection; exact Snell bend
      ``n1 sin_i = n2 sin_t`` for transmission), so the path kinks ON the
      interface, not at the step boundary;
    * photon energy ``E`` is conserved across the interface (frequency is
      continuous; only the wavelength changes) and ``dv`` is NOT marked —
      like the boundary steps (and unlike scatter steps), an interface event
      does not count as a scattering event for ``trace_dv`` statistics.

    ``match_speed=False`` (default) preserves each photon's speed — the
    interface only bends directions, which is exact for the stationary
    observables (reflectances, transmittances, angular distributions) this
    family measures. ``match_speed=True`` additionally rescales the outgoing
    speed to ``c / n`` of the receiving medium (and the remaining step
    length to match the remaining TIME), making time-of-flight through
    layers physical; initialize photon speeds to ``c / n`` of their source
    medium for consistency, and note that scatter steps resample velocities
    at their own ``c`` (combine with care).

    A photon that would cross the interface more than once in a single dt
    (re-crossing after reflection at another nearby plane) is interacted
    once per step per interface, in step order — resolve layer thickness
    with dt, exactly as with the boundary steps. Runs on the fused Pallas
    path (op kind "fresnel") and the generic scan.
    """

    def __init__(self, loc, n_lo, n_hi, axis: int = 2,
                 match_speed: bool = False):
        self.loc = _as_code(loc)
        self.n_lo = float(n_lo)
        self.n_hi = float(n_hi)
        if not (self.n_lo > 0.0 and self.n_hi > 0.0):
            raise ValueError("refractive indices must be positive")
        self.axis = int(axis)
        if self.axis not in (0, 1, 2):
            raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
        self.match_speed = bool(match_speed)
        self._c = None

    def setup(self, sim: Simulation) -> None:
        self._c = float(raw_code_value(c))

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        if self._c is None:
            self.setup(None)
        dtype = state.r.dtype
        ax = self.axis
        loc = jnp.asarray(self.loc, dtype)
        z1 = state.r[ax]
        z0 = z1 - state.dr[ax]
        side0 = z0 >= loc
        crossed = ((side0 != (z1 >= loc)) & (state.otype == OBJ_PHOTON)
                   & state.alive)

        speed2 = jnp.sum(state.v * state.v, axis=0)
        inv_speed = jax.lax.rsqrt(jnp.maximum(speed2, jnp.asarray(1e-30,
                                                                  dtype)))
        d = state.v * inv_speed  # unit incident direction
        # media seen by each crosser: from lo side (going up) or hi side
        going_up = jnp.logical_not(side0)
        nf = jnp.where(going_up, self.n_lo, self.n_hi).astype(dtype)
        nt = jnp.where(going_up, self.n_hi, self.n_lo).astype(dtype)
        cos_i = jnp.clip(jnp.abs(d[ax]), 0.0, 1.0)
        sin2_i = 1.0 - cos_i * cos_i
        mu = nf / nt
        sin2_t = mu * mu * sin2_i
        tir = sin2_t > 1.0
        cos_t = jnp.sqrt(jnp.clip(1.0 - sin2_t, 0.0, 1.0))
        rs = (nf * cos_i - nt * cos_t) / (nf * cos_i + nt * cos_t)
        rp = (nf * cos_t - nt * cos_i) / (nf * cos_t + nt * cos_i)
        R = jnp.where(tir, 1.0, jnp.clip(0.5 * (rs * rs + rp * rp),
                                         0.0, 1.0))
        u = jax.random.uniform(ctx.next_key(), z1.shape, dtype)
        reflect = crossed & (u < R)

        # segment/plane intersection: r0 + s*dr with s in [0, 1]
        dz = z1 - z0
        s = (loc - z0) / jnp.where(crossed, dz, jnp.ones_like(dz))
        r0 = state.r - state.dr
        p = r0 + s * state.dr
        seg = jnp.sqrt(jnp.sum(state.dr * state.dr, axis=0))

        # outgoing unit directions: mirror (reflect) / Snell bend (transmit)
        flip = jnp.zeros((3, 1), dtype).at[ax, 0].set(1.0)
        d_ref = d * (1.0 - 2.0 * flip)
        sgn = jnp.where(d[ax] >= 0, 1.0, -1.0).astype(dtype)
        d_tr = mu * d
        d_tr = d_tr.at[ax].set(sgn * cos_t)
        # renormalize: |d_tr| == 1 by construction up to rounding
        d_tr = d_tr * jax.lax.rsqrt(jnp.maximum(
            jnp.sum(d_tr * d_tr, axis=0), jnp.asarray(1e-30, dtype)))

        d_out = jnp.where(reflect, d_ref, d_tr)
        if self.match_speed:
            n_out = jnp.where(reflect, nf, nt)
            speed_out = jnp.asarray(self._c, dtype) / n_out
        else:
            speed_out = 1.0 / inv_speed
        # remaining TIME after the interface is (1-s)*dt; the distance it
        # covers is that time at the outgoing speed
        rem = (1.0 - s) * seg * speed_out * inv_speed
        r_new = p + d_out * rem
        v_new = d_out * speed_out

        r = jnp.where(crossed, r_new, state.r)
        v = jnp.where(crossed, v_new, state.v)
        dr = jnp.where(crossed, r_new - r0, state.dr)
        return state.replace(r=r, v=v, dr=dr)


def _emit_extras(extras, fill, start, k):
    """Refresh emitted slots' extras planes: constants from ``fill``
    (polarized sources' Stokes/frame rows), zeros for everything else."""
    from jax import lax

    out = {}
    for name, arr in extras.items():
        if name in fill:
            block = jnp.broadcast_to(
                jnp.asarray(fill[name], arr.dtype)[:, None],
                (arr.shape[0], k))
        elif arr.ndim == 1:
            block = jnp.zeros((k,), arr.dtype)
        else:
            block = jnp.zeros((arr.shape[0], k), arr.dtype)
        idx = (start,) if arr.ndim == 1 else (0, start)
        out[name] = lax.dynamic_update_slice(arr, block, idx)
    return out


class PhotonEmitterStep(Step):
    """Continuous photon source: spawns ``n_per_step`` photons every iteration
    *inside the compiled loop* (no reference counterpart — the reference can
    only populate before ``start()``; combined with absorption this enables
    steady-state transport problems).

    Spawned photons take slots ``[n_spawned, n_spawned + k)``; emission stops
    silently when the capacity is full (size ``Simulation(capacity=...)`` for
    the expected total). ``E`` may be a constant or a sampler
    ``f(key, k) -> (k,)``; ``v`` defaults to +x at c (pass ``isotropic=True``
    for angle-uniform directions, matching the scatter distribution); ``r``
    is the emission point (3-vector, default origin).

    Polarized sources: ``stokes=(Q, U, V)`` emits photons carrying that
    normalized Stokes vector (requires a population built with
    ``physicl_tpu.polarization.polarized_photon_state`` so the Stokes
    planes exist). For a directed source the ``Q > 0`` axis is ``pol_ref``
    (default: z-hat where possible) projected perpendicular to ``v``;
    an ``isotropic=True`` source may only carry circular polarization
    (``V``; linear Q/U has no well-defined transverse frame across
    random directions — a ValueError says so). Default: unpolarized.
    """

    needs_capacity_headroom = True  # engine auto-shrink would eat our slots

    def __init__(self, n_per_step: int, E=1.0, v=None, r=(0.0, 0.0, 0.0),
                 isotropic: bool = False, stokes=None, pol_ref=None):
        self.n_per_step = int(n_per_step)
        self.E = E
        self.v = v
        self.r = np.asarray(raw_code_value(r), np.float64).reshape(3)
        self.isotropic = isotropic
        self.stokes = (None if stokes is None else
                       np.asarray(raw_code_value(stokes),
                                  np.float64).reshape(3))
        self.pol_ref = pol_ref
        if self.stokes is not None:
            deg = float((self.stokes ** 2).sum())
            if deg > 1.0 + 1e-9:
                raise ValueError(
                    f"emitter stokes degree sqrt(Q^2+U^2+V^2) must be <= 1,"
                    f" got {deg ** 0.5:.6f}")
            if isotropic and (self.stokes[0] != 0 or self.stokes[1] != 0):
                raise ValueError(
                    "isotropic polarized emission supports circular (V) "
                    "polarization only: linear Q/U has no well-defined "
                    "transverse frame across random directions — use a "
                    "directed source (v=...) for linear polarization")
        elif pol_ref is not None:
            raise ValueError("pol_ref= without stokes= has no effect; "
                             "pass the emitted Stokes vector too")
        self._c = None
        self._emit_e1 = None

    def setup(self, sim: Simulation) -> None:
        self._c = float(raw_code_value(c))
        if self.stokes is None or self.isotropic:
            # isotropic V-only: frame degenerate (zeros) — any transverse
            # axis represents pure circular light equally well
            self._emit_e1 = (0.0, 0.0, 0.0) if self.stokes is not None \
                else None
            return
        vv = (np.array([1.0, 0.0, 0.0]) if self.v is None
              else np.asarray(raw_code_value(self.v),
                              np.float64).reshape(3))
        d = vv / max(np.linalg.norm(vv), 1e-300)
        ref = (np.asarray(raw_code_value(self.pol_ref),
                          np.float64).reshape(3)
               if self.pol_ref is not None
               else (np.array([0.0, 0.0, 1.0]) if abs(d[2]) < 0.9
                     else np.array([0.0, 1.0, 0.0])))
        p = ref - float(ref @ d) * d
        nrm = float(np.linalg.norm(p))
        if nrm < 1e-6:
            raise ValueError(
                "emitter pol_ref is (near-)parallel to v; the Q-axis must "
                "have a component perpendicular to the flight direction")
        self._emit_e1 = tuple(float(x) for x in p / nrm)

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        if self._c is None:
            self.setup(None)
        if self.stokes is not None and (
                "stokes" not in state.extras
                or "pol_ref" not in state.extras):
            raise ValueError(
                "polarized emitter (stokes=) but the population carries no "
                "Stokes planes: build the initial population with "
                "physicl_tpu.polarization.polarized_photon_state(...) so "
                "the 'stokes'/'pol_ref' extras exist")
        k = self.n_per_step
        dtype = state.r.dtype
        start = state.n_spawned
        key = ctx.next_key()

        if callable(self.E):
            E_new = jnp.asarray(self.E(key, k), dtype)
        else:
            E_new = jnp.full((k,), float(raw_code_value(self.E)), dtype)
        if self.isotropic:
            u = jax.random.uniform(jax.random.fold_in(key, 1), (2, k), dtype)
            theta, phi = u[0] * (2 * np.pi), u[1] * np.pi
            v_new = jnp.stack([
                jnp.sin(theta) * jnp.cos(phi),
                jnp.sin(theta) * jnp.sin(phi),
                jnp.cos(theta),
            ]) * jnp.asarray(self._c, dtype)
        elif self.v is None:
            v_new = jnp.zeros((3, k), dtype).at[0].set(self._c)
        else:
            v_new = jnp.broadcast_to(jnp.asarray(
                raw_code_value(self.v), dtype).reshape(3, -1), (3, k))
        r_new = jnp.broadcast_to(
            jnp.asarray(self.r, dtype)[:, None], (3, k))
        fill = {}
        if self.stokes is not None:
            fill["stokes"] = self.stokes
            fill["pol_ref"] = self._emit_e1

        def emit(state):
            from jax import lax

            def put2(dst, src):
                return lax.dynamic_update_slice(dst, src.astype(dst.dtype),
                                                (0, start))

            def put1(dst, src):
                return lax.dynamic_update_slice(dst, src.astype(dst.dtype),
                                                (start,))

            return state.replace(
                r=put2(state.r, r_new), v=put2(state.v, v_new),
                dr=put2(state.dr, jnp.zeros((3, k), dtype)),
                dv=put2(state.dv, jnp.zeros((3, k), dtype)),
                E=put1(state.E, E_new),
                alive=put1(state.alive, jnp.ones((k,), jnp.bool_)),
                otype=put1(state.otype, jnp.full((k,), OBJ_PHOTON, jnp.int32)),
                # recycled slots may carry a stale roulette/capture weight
                # (the fused kernel resets it the same way, ops/fused.py)
                w=put1(state.w, jnp.ones((k,), dtype)),
                # ... and stale per-particle aux planes (Stokes vectors,
                # charge data): fresh photons start with zeroed extras
                # (unpolarized, degenerate frame -> the polarized scatter's
                # fallback frame; q/m = 0 -> never Lorentz-pushed) — except
                # a polarized source (stokes=) writes its configured Stokes
                # vector + frame instead. The fused kernel mirrors both.
                extras=_emit_extras(state.extras, fill, start, k),
                n_spawned=start + k,
            )

        return jax.lax.cond(start + k <= state.capacity, emit,
                            lambda s: s, state)


# ---------------------------------------------------------------------------
# Population-control variance reduction: splitting + Russian roulette
# (extension; no reference counterpart. Completes the MCNP-style
# variance-reduction toolkit next to ScatterDeleteStep's implicit capture,
# roulette=, and generate_photon_state(w=) source biasing.)
# ---------------------------------------------------------------------------


class _SplitBase(Step):
    """Shared mechanics for particle splitting / Russian roulette.

    A split event replaces one particle of weight ``w`` with ``n`` identical
    particles of weight ``w / n`` — the total statistical weight is conserved
    EXACTLY per event, so every deterministic weighted observable (implicit-
    capture transmission, weighted tallies) is bit-for-bit unaffected while
    the sample count at depth grows. Roulette is the inverse move: survive
    with probability ``q < 1`` carrying weight ``w / q`` (unbiased in
    expectation).

    New particles take contiguous slots ``[n_spawned, n_spawned + k)``
    exactly like :class:`PhotonEmitterStep`; when the arena is full, copies
    that do not fit are simply not created and the survivor keeps the
    correspondingly larger share (``w / n_eff``), which keeps total weight
    conserved under clipping — reduced variance reduction, never bias.

    Subclasses provide ``_ratios(state) -> (split_q, roul_q)``: per-particle
    factors with ``split_q >= 1`` (target copy count, fractional part
    realized probabilistically) and ``roul_q`` (<1 triggers roulette at that
    survival probability). A particle must never have both ``split_q > 1``
    and ``roul_q < 1``.

    Data-dependent population growth cannot be proven into the fused
    Pallas plan, so ``at="step"`` pipelines run on the generic chunked scan
    (``sim.explain_plan()`` reports ``unsupported-step``); they compose
    with the differentiable :func:`physicl_tpu.functional.scan_steps`
    driver as well. ``at="chunk"`` instead applies the population control
    BETWEEN fused dispatches (once per ``chunk_steps`` iterations, as one
    jitted boundary op): the transport itself keeps the fused Pallas
    kernel — the right trade for deep-penetration runs where the window /
    importance surfaces are far apart compared to a step length. Boundary
    application drains the dispatch pipeline each chunk; for the classic
    per-collision control of MCNP lore, use ``at="step"``.
    """

    needs_capacity_headroom = True  # engine auto-shrink would eat our slots
    n_per_step = 1  # headroom signal only: actual growth is data-dependent

    def __init__(self, max_split: int = 8, roulette: bool = True,
                 at: str = "step"):
        self.max_split = int(max_split)
        self.roulette = bool(roulette)
        if self.max_split < 2:
            raise ValueError("max_split must be >= 2")
        if at not in ("step", "chunk"):
            raise ValueError(f"at must be 'step' or 'chunk', got {at!r}")
        self.at_boundary = (at == "chunk")
        self._jit_b = None

    def _ratios(self, state: SimState):
        raise NotImplementedError

    def boundary_apply(self, state: SimState, key) -> SimState:
        """One population-control pass at a chunk boundary (``at="chunk"``),
        jitted whole so a boundary costs one dispatch rather than one per
        op."""
        if self._jit_b is None:
            self._jit_b = jax.jit(
                lambda st, k: self.apply(st, StepContext(k, None)))
        return self._jit_b(state, key)

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        split_q, roul_q = self._ratios(state)
        return self._apply_ratios(state, ctx, split_q, roul_q)

    def _apply_ratios(self, state: SimState, ctx: StepContext,
                      split_q, roul_q) -> SimState:
        dtype = state.r.dtype
        C = state.capacity
        alive = state.alive
        split_q = jnp.where(alive, jnp.asarray(split_q, dtype), 1.0)
        key = ctx.next_key()

        # --- split: n = floor(q) + Bernoulli(frac(q)) copies, capped ------
        u = jax.random.uniform(key, (C,), dtype)
        n_i = jnp.floor(split_q)
        n = (n_i.astype(jnp.int32)
             + (u < (split_q - n_i)).astype(jnp.int32))
        extra = jnp.where(alive, jnp.clip(n, 1, self.max_split) - 1, 0)
        start = state.n_spawned
        off = start + jnp.cumsum(extra) - extra  # exclusive prefix sum
        n_fit = jnp.clip(C - off, 0, extra)      # copies that fit the arena
        n_eff = (1 + n_fit).astype(dtype)
        w = state.w / n_eff

        # --- roulette (only where roul_q < 1; disjoint from splits) ------
        if self.roulette:
            roul_q = jnp.where(alive, jnp.asarray(roul_q, dtype), 1.0)
            do_r = roul_q < 1.0
            surv = jax.random.uniform(jax.random.fold_in(key, 1),
                                      (C,), dtype) < roul_q
            alive = jnp.where(do_r & ~surv, False, alive)
            w = jnp.where(do_r & surv,
                          w / jnp.maximum(roul_q, jnp.finfo(dtype).tiny), w)

        # --- scatter copies into their contiguous fresh slots -------------
        p2 = {f: getattr(state, f) for f in ("r", "dr", "v", "dv", "a")}
        p1 = {"E": state.E, "otype": state.otype}
        ex = dict(state.extras)
        for j in range(self.max_split - 1):
            # copy j of particle i -> slot off[i] + j; C == dropped
            dest = jnp.where(extra > j, off + j, C)
            for f, p in p2.items():
                p2[f] = p.at[:, dest].set(p, mode="drop")
            for f, p in p1.items():
                p1[f] = p.at[dest].set(p, mode="drop")
            for f, p in ex.items():
                ex[f] = p.at[..., dest].set(p, mode="drop")
            w = w.at[dest].set(w, mode="drop")
            alive = alive.at[dest].set(True, mode="drop")
        return state.replace(
            alive=alive, w=w, E=p1["E"], otype=p1["otype"], extras=ex,
            n_spawned=jnp.minimum(start + jnp.sum(extra), C).astype(
                jnp.int32),
            **{f: p2[f] for f in p2})


class ImportanceSplitStep(_SplitBase):
    """MCNP-style geometric importance splitting: particles moving into a
    region of higher importance split, particles moving down-importance play
    Russian roulette — the classic deep-penetration population control
    (extension; the reference has no variance reduction at all).

    ``importance`` is a positive callable ``I(rx, ry, rz)`` over position
    arrays (e.g. ``lambda x, y, z: 2.0 ** jnp.floor(x / 0.5)`` doubles the
    importance every half-unit of shield depth). Each iteration, every alive
    particle is weighed by the ratio ``q = I(r) / I(r - dr)`` across the
    segment it just flew (stateless: the previous position is recovered from
    the ``dr`` plane, so no extra per-particle storage is needed):

    * ``q > 1``: split into ``n ~ q`` particles (fractional part realized by
      a Bernoulli draw, capped at ``max_split``), each with weight ``w/n`` —
      total weight conserved exactly;
    * ``q < 1`` (and ``roulette=True``): survive with probability ``q``,
      survivors carry ``w/q``.

    Pair with ``ScatterDeleteStep(implicit_capture=True)`` for deep-shield
    transmission: the weight decays deterministically while splitting keeps
    the particle count (hence the statistics) at depth.

    With ``at="chunk"`` the ratio is taken against each particle's position
    at the PREVIOUS chunk boundary (a device-resident snapshot) instead of
    ``r - dr``, so the whole importance climb across the chunk counts and
    the transport chunk itself stays on the fused Pallas kernel.
    """

    def __init__(self, importance, max_split: int = 8,
                 roulette: bool = True, at: str = "step"):
        super().__init__(max_split=max_split, roulette=roulette, at=at)
        if not callable(importance):
            raise TypeError("importance must be a callable I(rx, ry, rz) "
                            "over position arrays")
        self.importance = importance
        self._prev_r = None  # at="chunk": positions at the last boundary

    def _q(self, state: SimState, r_prev):
        tiny = jnp.finfo(state.r.dtype).tiny
        I1 = jnp.asarray(self.importance(state.r[0], state.r[1], state.r[2]))
        I0 = jnp.asarray(self.importance(r_prev[0], r_prev[1], r_prev[2]))
        q = I1 / jnp.maximum(I0, tiny)
        return jnp.maximum(q, 1.0), jnp.minimum(jnp.maximum(q, tiny), 1.0)

    def _ratios(self, state: SimState):
        return self._q(state, state.r - state.dr)

    def prime_snapshot(self, state: SimState) -> None:
        """Seed the ``at="chunk"`` boundary snapshot from the initial
        positions (called by the PopulationManager before any transport,
        on both execution paths)."""
        if self.at_boundary and self._prev_r is None:
            self._prev_r = state.r

    def boundary_apply(self, state: SimState, key) -> SimState:
        if self._prev_r is None:
            # first boundary: snapshot only (particles haven't flown a
            # tracked chunk yet)
            self._prev_r = state.r
            return state
        if self._jit_b is None:
            def f(st, k, prev_r):
                split_q, roul_q = self._q(st, prev_r)
                return self._apply_ratios(st, StepContext(k, None),
                                          split_q, roul_q)

            self._jit_b = jax.jit(f)
        state = self._jit_b(state, key, self._prev_r)
        # copies inherit the source position, so post-split r is the right
        # next snapshot for originals AND copies alike
        self._prev_r = state.r
        return state


class WeightWindowStep(_SplitBase):
    """Weight-window population control: particles heavier than ``w_hi``
    split down toward ``w_target``; lighter than ``w_lo`` play Russian
    roulette up toward it (extension; MCNP's WWN analog).

    Keeps every statistical weight within a bounded band — the standard
    companion to source biasing (``generate_photon_state(w=...)``,
    heavy-tailed ``A_fn`` attenuation, or deep implicit capture), where
    runaway weight spread would otherwise dominate the tally variance.
    ``w_target`` defaults to the geometric center ``sqrt(w_lo * w_hi)``.
    Total weight is conserved exactly by splits and in expectation by
    roulette. ``at="chunk"`` enforces the window between fused dispatches
    (weights drift within a chunk, are pulled back into band at each
    boundary) so the transport keeps the fused Pallas kernel.
    """

    def __init__(self, w_lo: float, w_hi: float, w_target=None,
                 max_split: int = 8, at: str = "step"):
        super().__init__(max_split=max_split, roulette=True, at=at)
        self.w_lo = float(raw_code_value(w_lo))
        self.w_hi = float(raw_code_value(w_hi))
        self.w_target = (float(raw_code_value(w_target))
                         if w_target is not None
                         else float(np.sqrt(self.w_lo * self.w_hi)))
        if not (0.0 < self.w_lo <= self.w_target <= self.w_hi):
            raise ValueError("need 0 < w_lo <= w_target <= w_hi "
                             f"(got {self.w_lo}, {self.w_target}, "
                             f"{self.w_hi})")

    def _ratios(self, state: SimState):
        w = state.w
        q = w / jnp.asarray(self.w_target, w.dtype)
        split_q = jnp.where(w > self.w_hi, jnp.maximum(q, 1.0), 1.0)
        roul_q = jnp.where(w < self.w_lo, jnp.minimum(q, 1.0), 1.0)
        return split_q, roul_q


# ---------------------------------------------------------------------------
# Measurement steps
# ---------------------------------------------------------------------------


class SpectrumMeasureStep(ReduceMeasureStep):
    """Per-iteration energy histogram over ALIVE particles, accumulated
    ON-DEVICE inside the fused kernel (extension; no reference
    counterpart — at 10^7+ photons streaming every E to the host is the
    alternative, see ScatterMeasureStep(measure_E=True)). Fused pipelines
    are photon-only by construction; a mixed population runs the generic
    scan and tallies every alive particle's ``E`` — filter species with a
    custom :class:`~physicl_tpu.engine.ReduceMeasureStep` if needed.

    ``edges`` is a static increasing 1-D array of bin edges (reference
    lower-edge convention: bin i counts ``edges[i] <= E < edges[i+1]``).
    ``weight="count"`` tallies photons; ``weight="energy"`` accumulates
    their energies (spectral flux). ``underflow``/``overflow`` add capture
    bins outside the range. ``weighted=True`` multiplies every contribution
    by the photon's statistical weight ``w`` — required for physical
    spectra under ``ScatterDeleteStep(implicit_capture=True)`` transport.
    ``data`` rows are ``[t(, n), bin_0, ..., (underflow,) (overflow,)]``
    with CSV via ``out_fn`` like every MeasureStep; counts cross shards as
    one psum on mesh runs. Tallies accumulate in float32 record channels:
    per-bin counts are integer-exact up to 2**24 (~1.7e7) per iteration
    and lose ulp-level exactness beyond — spread hotter populations over
    more bins (or accept ~1e-7 relative rounding).

    The fused kernel's record row is 128 channels wide, so at most ~120
    bins stay on the fast path (the prover falls back to the generic scan
    beyond that, with a warning naming the limit).
    """

    def __init__(self, out_fn=None, edges=None, measure_n: bool = False,
                 weight: str = "count", underflow: bool = False,
                 overflow: bool = False, weighted: bool = False):
        edges = np.asarray(edges, dtype=np.float64)
        if edges.ndim != 1 or edges.size < 2:
            raise ValueError("edges must be a 1-D array of >= 2 bin edges")
        if not (np.diff(edges) > 0).all():
            raise ValueError("edges must be strictly increasing")
        if weight not in ("count", "energy"):
            raise ValueError(f"weight must be 'count' or 'energy', "
                             f"got {weight!r}")
        self.edges = edges
        self.weight = weight
        names = tuple(f"bin{i}" for i in range(edges.size - 1))
        if underflow:
            names += ("underflow",)
        if overflow:
            names += ("overflow",)
        e = tuple(float(v) for v in edges)

        def contributions(p):
            val = p.E if weight == "energy" else None
            if weighted:
                val = p.w if val is None else val * p.w
            out = {}
            for i in range(len(e) - 1):
                m = (p.E >= e[i]) & (p.E < e[i + 1])
                out[f"bin{i}"] = m if val is None else jnp.where(m, val, 0.0)
            if underflow:
                m = p.E < e[0]
                out["underflow"] = (m if val is None
                                    else jnp.where(m, val, 0.0))
            if overflow:
                m = p.E >= e[-1]
                out["overflow"] = (m if val is None
                                   else jnp.where(m, val, 0.0))
            return out

        super().__init__(out_fn, contributions, outputs=names,
                         measure_n=measure_n)


class MeshTallyStep(ReduceMeasureStep):
    """Per-iteration SPATIAL histogram over alive particles — the cell
    tally / dose-map counterpart of :class:`SpectrumMeasureStep`
    (extension; the reference has only plane-crossing counters,
    physicl/light.py:361-404). Accumulated on-device inside the fused
    kernel via the :class:`~physicl_tpu.engine.ReduceMeasureStep`
    record row; one psum crosses shards on mesh runs.

    ``axis`` selects the binning coordinate: ``"x"``/``"y"``/``"z"``
    (axis-aligned slabs) or ``"r"`` (spherical shells of ``|r - center|``
    around ``center``). ``edges`` is a static increasing 1-D array of bin
    edges with the reference lower-edge convention
    (``edges[i] <= coord < edges[i+1]``); ``underflow``/``overflow`` add
    capture bins outside the range.

    ``value`` picks the deposited quantity per alive particle per
    iteration, binned at the particle's END-of-iteration position:

    * ``"count"`` — particle count per cell (collision-density shape);
    * ``"energy"`` — energy content per cell, ``sum(E)``;
    * ``"pathlength"`` — track-length estimator, ``sum(|dr|)``: the MC
      estimate of ``flux x cell-volume x dt``. Each particle's whole step
      lands in its endpoint cell, so keep ``c*dt`` small against the cell
      width (the standard estimator's track splitting converges as
      ``dt -> 0``). Steady-state scalar flux per cell =
      ``sum-over-rows / (V_cell * t_total)``.

    ``weighted=True`` multiplies every contribution by the statistical
    weight ``w`` — required for physical tallies under
    ``ScatterDeleteStep(implicit_capture=True)`` or population-control
    transport. ``data`` rows are ``[t(, n), bin_0, ...,(underflow,)
    (overflow,)]`` with CSV via ``out_fn`` like every MeasureStep.

    Tallies accumulate in float32 record channels (integer-exact to 2**24
    per iteration for counts); the fused record row is 128 channels wide,
    so at most ~120 bins keep the fast path — beyond that the prover
    falls back to the generic scan with a structured warning.
    """

    def __init__(self, out_fn=None, axis: str = "x", edges=None,
                 value: str = "count", center=(0.0, 0.0, 0.0),
                 measure_n: bool = False, weighted: bool = False,
                 underflow: bool = False, overflow: bool = False):
        edges = np.asarray(edges, dtype=np.float64)
        if edges.ndim != 1 or edges.size < 2:
            raise ValueError("edges must be a 1-D array of >= 2 bin edges")
        if not (np.diff(edges) > 0).all():
            raise ValueError("edges must be strictly increasing")
        if axis not in ("x", "y", "z", "r"):
            raise ValueError(f"axis must be 'x', 'y', 'z' or 'r', "
                             f"got {axis!r}")
        if value not in ("count", "energy", "pathlength"):
            raise ValueError(f"value must be 'count', 'energy' or "
                             f"'pathlength', got {value!r}")
        if axis == "r" and (np.asarray(edges) < 0).any():
            raise ValueError("radial bin edges must be non-negative")
        self.axis = axis
        self.value = value
        self.edges = edges
        self.center = tuple(float(_as_float(v)) for v in center)
        names = tuple(f"bin{i}" for i in range(edges.size - 1))
        if underflow:
            names += ("underflow",)
        if overflow:
            names += ("overflow",)
        e = tuple(float(v) for v in edges)
        cx, cy, cz = self.center

        def contributions(p):
            if axis == "r":
                coord = jnp.sqrt((p.rx - cx) ** 2 + (p.ry - cy) ** 2
                                 + (p.rz - cz) ** 2)
            else:
                coord = {"x": p.rx, "y": p.ry, "z": p.rz}[axis]
            if value == "energy":
                val = p.E
            elif value == "pathlength":
                val = jnp.sqrt(p.drx ** 2 + p.dry ** 2 + p.drz ** 2)
            else:
                val = None
            if weighted:
                val = p.w if val is None else val * p.w
            out = {}
            for i in range(len(e) - 1):
                m = (coord >= e[i]) & (coord < e[i + 1])
                out[f"bin{i}"] = m if val is None else jnp.where(m, val, 0.0)
            if underflow:
                m = coord < e[0]
                out["underflow"] = (m if val is None
                                    else jnp.where(m, val, 0.0))
            if overflow:
                m = coord >= e[-1]
                out["overflow"] = (m if val is None
                                   else jnp.where(m, val, 0.0))
            return out

        super().__init__(out_fn, contributions, outputs=names,
                         measure_n=measure_n)


class ScatterMeasureStep(MeasureStep):
    """Counts photons crossing axis-aligned planes each iteration
    (reference: physicl/light.py:361-404). Plane = 3-vector with the non-axis
    coordinates NaN; crossing test: ``r - dr <= loc <= r`` in either direction.
    Counting is an on-device masked reduction; with ``measure_E`` the crossing
    photons' energies are captured (fetched per chunk, assembled on host; on
    a process-spanning pod mesh the E channel is allgathered so every host
    assembles the identical complete list — the per-particle counterpart of
    the psum'd counts).

    ``weighted=True`` (extension) reports each plane's statistical-weight
    sum over crossing photons instead of the count (a surface-current
    estimator), and energy flux as ``sum(w*E)`` — the physical tallies under
    ``ScatterDeleteStep(implicit_capture=True)`` transport. ``n`` stays the
    structural alive count; per-photon E capture (list mode) is unaffected."""

    def __init__(self, out_fn=None, measure_n: bool = True, measure_locs=(),
                 measure_E: bool = False, measure_E_mode: str = "list",
                 weighted: bool = False):
        super().__init__(out_fn)
        self.measure_locs = list(measure_locs)
        self.measure_n = measure_n
        self.measure_E = measure_E
        self.weighted = bool(weighted)
        # "list": per-crossing energies, reference row format
        # (physicl/light.py:388-402); "sum": per-plane energy flux — scalar
        # per iteration, fusable and cheap at any N
        if measure_E_mode not in ("list", "sum"):
            raise ValueError("measure_E_mode must be 'list' or 'sum'")
        self.measure_E_mode = measure_E_mode
        self._axes = []
        for loc in self.measure_locs:
            loc = np.asarray(loc, np.double)
            axis = 0 if not np.isnan(loc[0]) else (1 if not np.isnan(loc[1]) else 2)
            self._axes.append((axis, float(loc[axis])))

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        ctx.record(self, "t", state.t)
        if self.measure_n:
            ctx.record(self, "n", state.n_alive)
        for j, (axis, L) in enumerate(self._axes):
            hi = state.r[axis]
            lo = hi - state.dr[axis]
            Lv = jnp.asarray(L, hi.dtype)
            crossed = (((lo <= Lv) & (Lv <= hi)) | ((lo >= Lv) & (Lv >= hi)))
            crossed = crossed & state.alive
            if self.weighted:
                ctx.record(self, f"count{j}",
                           jnp.sum(jnp.where(crossed, state.w, 0.0)))
            else:
                ctx.record(self, f"count{j}",
                           jnp.sum(crossed.astype(jnp.int32)))
            if self.measure_E and self.measure_E_mode == "sum":
                flux = state.w * state.E if self.weighted else state.E
                ctx.record(self, f"Esum{j}",
                           jnp.sum(jnp.where(crossed, flux, 0.0)))
            elif self.measure_E:
                ctx.record(self, f"E{j}",
                           jnp.where(crossed, state.E, jnp.nan))
        return state

    def collect(self, sim: Simulation, records) -> None:
        k = len(records["t"])
        for i in range(k):
            row = [records["t"][i]]
            if self.measure_n:
                row.append(records["n"][i])
            for j in range(len(self._axes)):
                row.append(records[f"count{j}"][i])
                if self.measure_E and self.measure_E_mode == "sum":
                    row.append(float(records[f"Esum{j}"][i]))
                elif self.measure_E:
                    Es = records[f"E{j}"][i]
                    row.append(list(Es[~np.isnan(Es)]))
            self.data.append(
                np.array(row, dtype=object)
                if self.measure_E and self.measure_E_mode == "list"
                else np.array(row))


class SphericalShellMeasureStep(MeasureStep):
    """Counts particles crossing a spherical shell ``|r - center| = radius``
    each iteration — the escape-flux / shell-detector counterpart of the
    plane tally (extension; the reference's only detector geometry is
    the axis-aligned plane, physicl/light.py:385-399).

    Same endpoint crossing convention as :class:`ScatterMeasureStep`
    (``|r - dr - c|`` and ``|r - c|`` straddle the radius, either
    direction; a chord that enters AND exits within one step is not
    counted — keep ``c*dt`` small against the shell radius).
    ``weighted=True`` sums statistical weights (the physical tally under
    weighted transport). ``data`` rows ``[t(, n), crossings]``; CSV via
    ``out_fn``. Fuses (op kind "scross") and runs the generic scan.
    """

    def __init__(self, out_fn=None, radius=1.0, center=(0.0, 0.0, 0.0),
                 measure_n: bool = True, weighted: bool = False):
        super().__init__(out_fn)
        self.radius = float(raw_code_value(radius))
        if self.radius <= 0:
            raise ValueError(f"radius must be positive, got {self.radius}")
        self.center = tuple(
            float(x) for x in np.asarray(raw_code_value(center),
                                         np.float64).reshape(3))
        self.measure_n = measure_n
        self.weighted = bool(weighted)

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        ctx.record(self, "t", state.t)
        if self.measure_n:
            ctx.record(self, "n", state.n_alive)
        dtype = state.r.dtype
        c = jnp.asarray(self.center, dtype)[:, None]
        d1 = state.r - c
        d0 = d1 - state.dr
        r1 = jnp.sum(d1 * d1, axis=0)
        r0 = jnp.sum(d0 * d0, axis=0)
        R2 = jnp.asarray(self.radius * self.radius, dtype)
        crossed = (((r0 <= R2) & (R2 <= r1))
                   | ((r0 >= R2) & (R2 >= r1))) & state.alive
        if self.weighted:
            ctx.record(self, "count0",
                       jnp.sum(jnp.where(crossed, state.w, 0.0)))
        else:
            ctx.record(self, "count0", jnp.sum(crossed.astype(jnp.int32)))
        return state

    def collect(self, sim: Simulation, records) -> None:
        for i in range(len(records["t"])):
            row = [records["t"][i]]
            if self.measure_n:
                row.append(records["n"][i])
            row.append(records["count0"][i])
            self.data.append(np.array(row))


class ScatterSignMeasureStep(MeasureStep):
    """Counts objects with strictly positive vx/vy/vz each iteration — the
    isotropy diagnostic (reference: physicl/light.py:406-431).
    ``weighted=True`` (extension) sums statistical weights instead of
    counting (the physical tally under implicit-capture transport)."""

    def __init__(self, out_fn=None, measure_n: bool = True,
                 weighted: bool = False):
        super().__init__(out_fn)
        self.measure_n = measure_n
        self.weighted = bool(weighted)

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        ctx.record(self, "t", state.t)
        if self.measure_n:
            ctx.record(self, "n", state.n_alive)
        pos = (state.v > 0) & state.alive[None, :]
        if self.weighted:
            ctx.record(self, "signs",
                       jnp.sum(jnp.where(pos, state.w[None, :], 0.0), axis=1))
        else:
            ctx.record(self, "signs", jnp.sum(pos.astype(jnp.int32), axis=1))
        return state

    def collect(self, sim: Simulation, records) -> None:
        for i in range(len(records["t"])):
            row = [records["t"][i]]
            if self.measure_n:
                row.append(records["n"][i])
            row.extend(records["signs"][i])
            self.data.append(np.array(row))


class TracePathMeasureStep(MeasureStep):
    """Records every object's position each iteration; ``terminate`` reshapes to
    the reference's t-aligned matrix (physicl/light.py:433-483): first row
    ``["t", t0, ...]``, then per object ``[id_info(, freq), r vectors..., NaN
    padding after death]``.

    Per-iteration positions are DEVICE-RESIDENT — the fused chunk
    stores them to a device stream buffer (and the generic scan
    keeps its record ys on device via the engine's device-records channel);
    nothing crosses to the host until the trace matrix is assembled
    (``data`` / ``as_arrays`` / CSV terminate). Device chunks beyond
    ``device_hold_bytes`` spill to host RAM oldest-first so HBM stays
    bounded on long runs.

    Process-spanning pod meshes trace SHARD-LOCALLY: each host assembles
    only its contiguous span of the particle axis (rows keep GLOBAL slot
    ids; ``col0`` is the global id of local column 0, and CSV paths gain a
    ``.p{process_index}`` suffix) — the per-host matrices tile the full
    one without ever moving a stream buffer over DCN. Mid-run capacity
    growth is refused there (it would reshard the spans); pre-size
    ``capacity=`` for the peak population."""

    needs_stable_ids = True  # disables engine auto-shrink compaction
    device_records = ("pos", "alive", "scat", "traceraw")
    device_hold_bytes = 4 << 30
    _data_override = None
    _cached_rows = None

    def __init__(self, out_fn=None, trace_type=Object,
                 id_info_fn: Callable = lambda x: str(type(x)),
                 trace_dv: bool = False, trace_every: int = 1,
                 trace_dtype: str = "float32"):
        super().__init__(out_fn)
        self.trace_type = trace_type
        self.id_info_fn = id_info_fn
        self.trace_dv = trace_dv
        # strided tracing (extension; the reference records every
        # iteration): sample positions on iterations that are global
        # multiples of trace_every. On the fused path the kernel skips the
        # stream DMA on unsampled iterations, so the per-dispatch stream
        # buffer holds trace_every-fold more iterations — large-N traced
        # runs stop being dispatch-bound.
        self.trace_every = int(trace_every)
        # trace_dtype="bfloat16" (extension) stores recorded positions
        # in bfloat16: half the stream bytes => 2x iterations per dispatch
        # for EVERY-iteration tracing at large N. PRECISION WAIVER: bf16
        # has an 8-bit mantissa (~0.4% relative position error, ~3 decimal
        # digits) but the full f32 exponent range, so nothing overflows and
        # the NaN death-encoding is unchanged. Physics is unaffected — the
        # transport state stays f32; only the recorded copies are rounded.
        self.trace_dtype = str(trace_dtype)
        if self.trace_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"trace_dtype {trace_dtype!r} not supported; use 'float32' "
                "or 'bfloat16'")
        if self.trace_every < 1:
            raise ValueError("trace_every must be >= 1")
        if self.trace_dv and self.trace_every > 1:
            raise ValueError(
                "trace_dv counts scatter events at every iteration and is "
                "incompatible with strided tracing (trace_every > 1)")
        self._pos: List = []    # (k, 3, C) per chunk — jax or (spilled) np
        self._alive: List = []  # (k, C) per chunk
        self._freq = None       # (C,) scatter-event counts (device)
        self._seen = 0          # global iterations consumed (stride phase)
        self._gidx: List = []   # per chunk: sampled global iteration indices
        self._pod = False       # process-spanning mesh: shard-local assembly
        self._col0: List = []   # per chunk: global id of local column 0
        self.col0 = 0           # set at assembly: global id of column 0

    def setup(self, sim) -> None:
        # Process-spanning meshes: SHARD-LOCAL tracing. Stream buffers are
        # multi-GB per chunk, so gathering them across hosts every chunk
        # would make the DCN the bottleneck by construction; instead each
        # host assembles only ITS contiguous span of the particle axis
        # (slots are stable — needs_stable_ids pins compaction) and labels
        # rows with GLOBAL slot ids. `as_arrays`/`data` then cover this
        # host's photons; `col0` gives the global id of local column 0, and
        # CSV paths get a `.p{process_index}` suffix so hosts don't collide.
        from physicl_tpu.parallel.distributed import mesh_spans_processes

        self._pod = mesh_spans_processes(getattr(sim, "mesh", None)
                                         if sim is not None else None)

    def apply(self, state: SimState, ctx: StepContext) -> SimState:
        # generic path honors trace_dtype too: identical record semantics
        # between paths, and bf16 halves the device record footprint
        pos = (state.r.astype(jnp.bfloat16)
               if self.trace_dtype == "bfloat16" else state.r)
        ctx.record(self, "pos", pos)
        ctx.record(self, "alive", state.alive)
        if self.trace_dv:
            scat = jnp.any(state.dv != 0, axis=0) & state.alive
            ctx.record(self, "scat", scat.astype(jnp.int32))
        return state

    def collect(self, sim: Simulation, records) -> None:
        S = self.trace_every
        if "traceraw" in records:
            # fused path: the raw (rows, planes, C) stream buffer, unsliced —
            # positions/alive/scat are extracted on the host at assembly
            # time, so the run itself does zero per-chunk device work here
            x = records["traceraw"]
            n_it = x.n_valid if x.n_valid >= 0 else x.buf.shape[0] * x.every
            if S > 1:
                # buffer rows hold iterations seen + m*every; keep rows on
                # global multiples of trace_every (exact phase across chunks
                # and across fused/generic switches)
                m = np.arange(-(-n_it // x.every))
                g = self._seen + m * x.every
                keep = (g % S) == 0
                x.rows = m[keep]
                self._gidx.append(g[keep])
            self._seen += n_it
            self._pos.append(x)
            self._alive.append(None)
            self._col0.append(None)  # resolved at fetch/spill (shard-local)
        else:
            pos, alive = records["pos"], records["alive"]
            k = int(pos.shape[0])
            if S > 1:
                g = self._seen + np.arange(k)
                keep = np.flatnonzero((g % S) == 0)
                self._gidx.append(g[keep])
                pos = pos[keep]      # (len(keep), 3, C)
                alive = alive[keep]  # device gather before retention
            self._seen += k
            self._pos.append(pos)
            self._alive.append(alive)
            self._col0.append(None)
            if self.trace_dv and "scat" in records:
                s = jnp.sum(jnp.asarray(records["scat"]).astype(jnp.int32),
                            axis=0)
                if self._freq is None:
                    self._freq = s
                else:  # capacity can grow between chunks (mid-run injection)
                    m = max(s.shape[0], self._freq.shape[0])
                    self._freq = (
                        jnp.pad(self._freq, (0, m - self._freq.shape[0]))
                        + jnp.pad(s, (0, m - s.shape[0])))
        self._maybe_spill()

    def _maybe_spill(self) -> None:
        """Move the oldest device-held chunks to host RAM once the total
        device footprint exceeds ``device_hold_bytes``."""
        def held(i):
            x = self._pos[i]
            if hasattr(x, "buf"):  # raw stream record (fused path)
                return int(x.buf.nbytes) if isinstance(x.buf, jax.Array) else 0
            return sum(int(y.nbytes)
                       for y in (x, self._alive[i])
                       if isinstance(y, jax.Array))

        total = sum(held(i) for i in range(len(self._pos)))
        if total <= self.device_hold_bytes:
            return
        for i in range(len(self._pos)):
            if total <= self.device_hold_bytes:
                break
            x = self._pos[i]
            from physicl_tpu.parallel.distributed import local_shard_np

            if hasattr(x, "buf"):
                if isinstance(x.buf, jax.Array):
                    total -= held(i)
                    # reassign through the shared holder: every trace step's
                    # record for this chunk references the same device buffer.
                    # Pod meshes spill only this host's span (shard-local).
                    x.hold.arr, x.hold.col0 = local_shard_np(x.buf)
            elif isinstance(x, jax.Array):
                total -= held(i)
                self._pos[i], c0 = local_shard_np(x)
                self._alive[i], _ = local_shard_np(self._alive[i])
                self._col0[i] = c0

    def _chunk_np(self, i):
        """Normalize chunk i to host arrays: (pos (k,3,C), alive (k,C),
        scat (k,C) or None). Pod meshes fetch shard-local (C = this host's
        span; ``self._col0[i]`` records its first global column)."""
        from physicl_tpu.parallel.distributed import local_shard_np

        x = self._pos[i]
        if hasattr(x, "buf"):  # raw stream record
            if isinstance(x.buf, jax.Array):
                x.hold.arr, x.hold.col0 = local_shard_np(x.buf)
            buf = x.buf
            self._col0[i] = x.hold.col0
            n_it = x.n_valid if x.n_valid >= 0 else buf.shape[0] * x.every
            sel = x.rows if x.rows is not None else slice(
                0, -(-n_it // x.every))  # valid-prefix rows (ceil)
            # bf16 streams come back as ml_dtypes arrays; normalize to f32
            # for the numpy-facing assembly surface. Slice THIS step's
            # planes before converting: several trace steps share one
            # stream buffer, and converting all planes per step duplicates
            # the work and ~doubles peak host RAM at the 2 GB budget
            # (round-3 code-review finding)
            npl = 4 if x.scat else 3
            sub = np.asarray(buf[sel, x.p0:x.p0 + npl], dtype=np.float32)
            pos = sub[:, :3, :]
            alive = ~np.isnan(sub[:, 0, :])
            scat = sub[:, 3, :] if x.scat else None
            return pos, alive, scat
        if isinstance(x, jax.Array):
            self._pos[i], c0 = local_shard_np(x)
            self._alive[i], _ = local_shard_np(self._alive[i])
            self._col0[i] = c0
        elif self._col0[i] is None:
            self._col0[i] = 0
        return (np.asarray(self._pos[i], dtype=np.float32),
                np.asarray(self._alive[i]), None)

    @property
    def data(self):
        """The reference's t-aligned trace matrix, assembled lazily on first
        access (row building is Python-object-heavy at large N; use
        :meth:`as_arrays` for the dense zero-copy form)."""
        if self._data_override is not None:
            return self._data_override
        if self._cached_rows is None:
            self._cached_rows = self._build_rows()
        return self._cached_rows

    @data.setter
    def data(self, value):
        self._data_override = value

    def as_arrays(self):
        """Dense trace: (ts list, positions (T, 3, C), alive (T, C), freq).

        This is the host-assembly point: device-held chunks are fetched here
        (one transfer per chunk), not during the run.
        """
        if not self._pos:
            return [], np.zeros((0, 3, 0)), np.zeros((0, 0), bool), None
        chunks = [self._chunk_np(i) for i in range(len(self._pos))]
        col0s = {c for c in self._col0 if c is not None}
        if len(col0s) > 1:
            # shard-local pod assembly: the host's span moved between chunks
            # (capacity growth reshards the particle axis) — the per-chunk
            # column blocks no longer align to one global offset
            raise NotImplementedError(
                "TracePathMeasureStep on a process-spanning mesh does not "
                f"support mid-run capacity growth (local spans {col0s}); "
                "pre-size capacity= for the peak population")
        self.col0 = col0s.pop() if col0s else 0
        cmax = max(p.shape[-1] for p, _, _ in chunks)
        pos = np.concatenate(
            [np.pad(p, ((0, 0), (0, 0), (0, cmax - p.shape[-1])))
             for p, _, _ in chunks], axis=0)     # (T, 3, C)
        alive = np.concatenate(
            [np.pad(a, ((0, 0), (0, cmax - a.shape[-1])))
             for _, a, _ in chunks], axis=0)     # (T, C)
        # scatter-event counts: generic-path chunks accumulated on device in
        # self._freq; fused raw chunks carry a scat plane summed here
        if self._freq is None:
            freq = None
        else:
            from physicl_tpu.parallel.distributed import local_shard_np

            freq_np, _ = local_shard_np(self._freq)
            freq = np.asarray(freq_np).astype(np.int64)
        raw_freq = None
        for _, _, scat in chunks:
            if scat is None:
                continue
            s = np.nan_to_num(scat).sum(axis=0).astype(np.int64)
            s = np.pad(s, (0, cmax - s.shape[0]))
            raw_freq = s if raw_freq is None else raw_freq + s
        if raw_freq is not None:
            if freq is None:
                freq = raw_freq
            else:
                m = max(freq.shape[0], raw_freq.shape[0])
                freq = (np.pad(freq, (0, m - freq.shape[0]))
                        + np.pad(raw_freq, (0, m - raw_freq.shape[0])))
        if self.trace_every > 1:
            # strided: the t row carries only the sampled iterations' times
            g = (np.concatenate(self._gidx)
                 if self._gidx else np.zeros(0, np.int64))
            ts = [self._ts[int(i)] for i in g if i < len(self._ts)]
        else:
            ts = self._ts
        return ts, pos, alive, freq

    def _build_rows(self):
        ts, pos, alive, freq = self.as_arrays()
        if pos.shape[0] == 0:
            return [["t"]]
        T = pos.shape[0]
        rows: List[list] = [["t"] + list(ts)]
        # columns are global slots [col0, col0 + C) — the whole population on
        # one process, THIS host's span on a pod mesh (rows labeled by the
        # GLOBAL slot id either way; the per-host matrices tile the full one)
        lo = self.col0
        hi = min(self._n_rows, lo + pos.shape[-1])
        for g in range(lo, hi):
            i = g - lo
            info = (self.id_info_fn(self._objs[g])
                    if g < len(self._objs) else str(g))
            row = [info]
            if self.trace_dv:
                row.append(int(freq[i]) if freq is not None
                           and i < len(freq) else 0)
            for ti in range(T):
                if alive[ti, i]:
                    row.append(np.array(pos[ti, :, i]))
                else:
                    row.extend([np.nan, np.nan, np.nan])
            rows.append(row)
        return rows

    def terminate(self, sim: Simulation) -> None:
        self._data_override = None
        self._cached_rows = None
        self._ts = list(sim.ts)
        self._n_rows = max(sim._initial_count, getattr(sim, "_hwm", 0))
        self._objs = list(sim._pending_objects)
        if self._pod and self.out_fn is not None:
            # shard-local matrices: every host writes ITS span; suffix the
            # path per process so hosts sharing a filesystem don't collide
            # (concatenating the .pN files row-wise tiles the full matrix)
            saved = self.out_fn
            try:
                self.out_fn = f"{saved}.p{jax.process_index()}"
                super().terminate(sim)
            finally:
                self.out_fn = saved
            return
        super().terminate(sim)  # writes CSV (builds rows) only if out_fn set
