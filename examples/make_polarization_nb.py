"""Build + execute examples/polarized_sky.ipynb (Stokes-vector Rayleigh
transport: sky polarization, circular transfer, ensemble depolarization).

Run: python examples/make_polarization_nb.py  (executes on the current JAX
backend; PHYSICL_NB_SMALL=1 shrinks photon counts for a CPU smoke run).
"""

import os
import sys

import nbformat as nbf
from nbconvert.preprocessors import ExecutePreprocessor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

CELL0 = '''\
# Polarized Rayleigh transport with full Stokes vectors — extension.
#
# Every photon carries a normalized Stokes vector (Q, U, V) and a local
# frame vector (physicl_tpu.polarization); scattering applies the exact
# dipole phase MATRIX with joint polarized angle sampling. This cell
# reproduces the textbook result behind sky polarimetry: light singly
# scattered by angle theta acquires a linear polarization degree
#     P(theta) = (1 - cos^2) / (1 + cos^2),
# 100% at 90 degrees from the sun. In the photon's own frame (aligned
# with the scattering plane after the event) that is exactly Q = -P.
import sys, os
sys.path.insert(0, os.path.dirname(os.getcwd()))
if os.environ.get("PHYSICL_NB_SMALL") == "1":   # CPU smoke mode
    import jax
    jax.config.update("jax_platforms", "cpu")
import numpy as np
import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light
import physicl_tpu.polarization as pol
import warnings
warnings.filterwarnings("ignore", message=".*unsupported-step.*")

N = 20_000 if os.environ.get("PHYSICL_NB_SMALL") == "1" else 1_000_000
c_dt = float(light.c) * 0.001
A = np.sqrt(2.0 / c_dt)   # pcoll = A*n*c*dt = 2: every photon scatters

def one_polarized_scatter(stokes, n=N, seed=7):
    """One forced Rayleigh scatter of a +x beam; returns (cos theta,
    final Stokes, frame, direction) arrays over the population."""
    s = phys.Simulation(until_t=0.001, seed=seed)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, pol.ScatterPolarizedRayleighStep(A=A, n=A))
    s.add_photons(pol.polarized_photon_state(n, E=1.0, stokes=stokes))
    s.start(); s.join()
    v = np.asarray(s.sim_state.v, np.float64)[:, :n]
    st = np.asarray(s.sim_state.extras["stokes"], np.float64)[:, :n]
    pr = np.asarray(s.sim_state.extras["pol_ref"], np.float64)[:, :n]
    d = v / np.linalg.norm(v, axis=0)
    return d[0], st, pr, d

ct, st_u, _, _ = one_polarized_scatter((0.0, 0.0, 0.0))
P_meas = -st_u[0]                      # Q in the scattering frame = -P
P_analytic = (1 - ct**2) / (1 + ct**2)
print(f"max |P_measured - P(theta)| over {N} photons: "
      f"{np.abs(P_meas - P_analytic).max():.2e}")
print(f"P at 90 deg (|cos|<0.02): {P_meas[np.abs(ct) < 0.02].mean():.4f} "
      "(analytic 1.0)")
'''

CELL1 = '''\
# The sky-polarization curve: degree of polarization vs scattering angle,
# binned from the transport run vs the closed form.
import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt

bins = np.linspace(-1, 1, 41)
centers = 0.5 * (bins[1:] + bins[:-1])
idx = np.digitize(ct, bins) - 1
P_bin = np.array([P_meas[idx == i].mean() for i in range(40)])

fig, ax = plt.subplots(figsize=(5.5, 3.4))
th = np.degrees(np.arccos(centers))
ax.plot(th, P_bin, "o", ms=4, label="transport (binned)")
tt = np.linspace(0, 180, 300)
cc = np.cos(np.radians(tt))
ax.plot(tt, (1 - cc**2) / (1 + cc**2), "k-", lw=1.5,
        label=r"$(1-\\cos^2\\theta)/(1+\\cos^2\\theta)$")
ax.set_xlabel(r"scattering angle $\\theta$ from the sun [deg]")
ax.set_ylabel("degree of linear polarization")
ax.set_title("single-scatter sky polarization (max at 90°)")
ax.legend(); plt.tight_layout(); plt.savefig("polarized_sky.png", dpi=110)
print(f"max binned deviation: {np.abs(P_bin - (1-centers**2)/(1+centers**2)).max():.3e}")
'''

CELL2 = '''\
# Circular polarization transfer: incoming V = 1 leaves the scatter with
# V' = 2 cos(theta) / (1 + cos^2 theta) — circular polarization flips
# handedness on backscatter and vanishes at 90 degrees.
ct_v, st_v, _, _ = one_polarized_scatter((0.0, 0.0, 1.0), seed=11)
V_analytic = 2 * ct_v / (1 + ct_v**2)
print(f"max |V' - 2c/(1+c^2)|: {np.abs(st_v[2] - V_analytic).max():.2e}")

plt.figure(figsize=(5.5, 3.2))
order = np.argsort(ct_v)
sl = slice(None, None, max(1, N // 4000))
plt.plot(ct_v[order][sl], st_v[2][order][sl], ".", ms=2,
         label="transport")
cc = np.linspace(-1, 1, 300)
plt.plot(cc, 2 * cc / (1 + cc**2), "k-", lw=1.5,
         label=r"$2\\cos\\theta/(1+\\cos^2\\theta)$")
plt.xlabel(r"$\\cos\\theta$"); plt.ylabel("V after scatter")
plt.legend(); plt.tight_layout(); plt.savefig("polarized_V.png", dpi=110)
'''

CELL3 = '''\
# Multiple scattering: per-photon PURITY is conserved exactly (Rayleigh
# scattering of a pure state is pure — depolarization is an ensemble
# effect), the local-frame <Q> relaxes to the analytic fixed point -1/2,
# and the MERIDIAN-frame ensemble polarization decays toward zero: the
# multiply-scattered sky is unpolarized even though every photon stays
# fully polarized.
Nm = 10_000 if os.environ.get("PHYSICL_NB_SMALL") == "1" else 200_000
ens = []
for k_scat in (1, 2, 3, 5, 8, 12):
    s = phys.Simulation(until_t=0.001 * k_scat, seed=17)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, pol.ScatterPolarizedRayleighStep(A=A, n=A))
    meas = pol.StokesMeasureStep(None)
    s.add_step(3, meas)
    s.add_photons(pol.polarized_photon_state(Nm, E=1.0,
                                             stokes=(1.0, 0.0, 0.0)))
    s.start(); s.join()
    st = np.asarray(s.sim_state.extras["stokes"], np.float64)[:, :Nm]
    pr = np.asarray(s.sim_state.extras["pol_ref"], np.float64)[:, :Nm]
    v = np.asarray(s.sim_state.v, np.float64)[:, :Nm]
    d = v / np.linalg.norm(v, axis=0)
    # rotate each photon's (Q, U) into the common meridian frame
    zx = np.cross(np.broadcast_to([0.0, 0.0, 1.0], d.T.shape), d.T).T
    nz = np.linalg.norm(zx, axis=0); ok = nz > 1e-9
    e_phi = zx[:, ok] / nz[ok]
    e_th = np.cross(e_phi.T, d[:, ok].T).T
    cchi = (pr[:, ok] * e_th).sum(0); schi = (pr[:, ok] * e_phi).sum(0)
    c2, s2 = cchi**2 - schi**2, 2 * schi * cchi
    Q_lab = st[0][ok] * c2 - st[1][ok] * s2
    U_lab = st[0][ok] * s2 + st[1][ok] * c2
    p_ens = np.sqrt(Q_lab.mean()**2 + U_lab.mean()**2 + st[2][ok].mean()**2)
    purity = np.sqrt((st**2).sum(0)).mean()
    rows = np.array(meas.data, dtype=float)
    ens.append((k_scat, p_ens, purity, rows[-1, 4]))
    print(f"after {k_scat:2d} scatters: ensemble P = {p_ens:.4f}   "
          f"<photon purity> = {purity:.5f}   local <Q> = {rows[-1, 4]:+.3f}")

ks, ps, _, _ = zip(*ens)
plt.figure(figsize=(5.5, 3.2))
plt.semilogy(ks, ps, "o-", label="meridian-frame ensemble P")
plt.axhline(1.0, color="k", lw=0.8, ls=":", label="per-photon purity (exact)")
plt.xlabel("number of scatters"); plt.ylabel("polarization")
plt.legend(); plt.tight_layout()
plt.savefig("polarized_depol.png", dpi=110)
'''


CELL4 = '''\
# THE classic polarized-RT benchmark: Chandrasekhar's Milne problem.
# Radiation diffusing out of a semi-infinite conservative Rayleigh-
# scattering atmosphere emerges polarized PARALLEL TO THE LIMB, with
# degree of polarization exactly 11.71% at grazing emergence (mu = 0),
# falling to 0 at normal emergence (Chandrasekhar 1950, Table XXIV).
# No closed-form elementary expression exists — the 0.117 limit comes
# from his H-function integral equations — which makes it a genuine
# multiple-scattering test: every piece (phase matrix, frame rotations,
# azimuth conditional, renormalization) must be right for the emergent
# ensemble to land on it.
#
# Setup: photons start deep (tau = 12) with isotropic directions, random
# -walk through conservative polarized Rayleigh scattering (pcoll = 0.25
# per step => mean free path = 4 steps; the Bernoulli-step collision
# model converges to continuous exponential transport as pcoll -> 0, and
# 0.25 keeps the discretization bias below the 2e6-photon noise floor),
# and die at the surface (z > 0, escape) or the deep floor (lost).
# Emergent photons are binned by mu = d_z with meridian-frame Stokes.
# The whole pipeline (kinematics, absorbing boundary, polarized scatter)
# runs as ONE fused Pallas kernel — the Stokes and frame triples ride
# writable packed state planes.
#
# STEP ORDER MATTERS: the absorbing boundary must run BEFORE the scatter
# step. Kinematics can carry a photon across the surface mid-iteration;
# if the scatter step ran first, that photon would scatter once more at
# z > 0 — OUTSIDE the medium — and the tally would record the direction
# and Stokes vector of an unphysical vacuum scatter. That contamination
# inflates the limb polarization ~2.5x (grazing bins fill with photons
# "last-scattered" above the surface, which are strongly limb-parallel
# polarized). Boundary-first freezes each escaper at its true emergent
# direction. A quick check the ordering is right: escaper counts per mu
# bin should follow the Milne emergent flux mu*I(mu) ~ mu*(mu + 0.71)
# (Hopf limb darkening) — a ~43x ratio between the mu=1 and mu=0 bins.
step = float(light.c) * 0.001
tau_source, tau_floor, pcoll = 12.0, 24.0, 0.25
Nd = 30_000 if os.environ.get("PHYSICL_NB_SMALL") == "1" else 2_000_000
rng = np.random.default_rng(5)
mu0 = rng.uniform(-1, 1, Nd)
ph0 = rng.uniform(0, 2 * np.pi, Nd)
st0 = np.sqrt(1 - mu0**2)
v0 = np.stack([st0 * np.cos(ph0), st0 * np.sin(ph0), mu0]) * float(light.c)
r0 = np.zeros((3, Nd)); r0[2] = -(tau_source / pcoll) * step

# auto_shrink=False: arena compaction would move/recycle dead photons'
# slots mid-run; stable slots keep every photon's death-time direction,
# Stokes vector, and frame readable afterwards (v is frozen at death:
# only alive photons scatter)
s = phys.Simulation(exit="extinction", seed=10, auto_shrink=False)
s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
s.add_step(1, phys.newton.NewtonianKinematicsStep())
s.add_step(2, physicl_tpu.newton.AbsorbingBoundaryStep(
    np.array([[-1e12, 1e12], [-1e12, 1e12],
              [-(tau_floor / pcoll) * step, 0.0]])))
s.add_step(3, pol.ScatterPolarizedRayleighStep(A=pcoll / step, n=1.0))
s.add_photons(pol.polarized_photon_state(Nd, E=1.0, v=v0, r=r0))
s.start(); s.join()

v = np.asarray(s.sim_state.v, np.float64)[:, :Nd]
st = np.asarray(s.sim_state.extras["stokes"], np.float64)[:, :Nd]
pr = np.asarray(s.sim_state.extras["pol_ref"], np.float64)[:, :Nd]
# every photon died at the surface (moving up) or the floor (moving down)
esc = v[2] > 0
print(f"escaped the surface: {esc.sum()} / {Nd} ({esc.mean():.1%}); "
      f"lost to the floor: {(~esc).sum()}")
d = v[:, esc] / np.linalg.norm(v[:, esc], axis=0)
mu = d[2]

# meridian-frame rotation (z-hat polar axis)
zx = np.cross(np.broadcast_to([0.0, 0.0, 1.0], d.T.shape), d.T).T
nz = np.linalg.norm(zx, axis=0); ok = nz > 1e-9
e_phi = zx[:, ok] / nz[ok]
e_th = np.cross(e_phi.T, d[:, ok].T).T
prm = pr[:, esc][:, ok]; stm = st[:, esc][:, ok]
cchi = (prm * e_th).sum(0); schi = (prm * e_phi).sum(0)
c2, s2 = cchi**2 - schi**2, 2 * schi * cchi
Q_lab = stm[0] * c2 - stm[1] * s2
mu = mu[ok]

edges = np.linspace(0, 1, 11)
mid = 0.5 * (edges[1:] + edges[:-1])
cnt = np.array([((mu >= a) & (mu < b)).sum()
                for a, b in zip(edges[:-1], edges[1:])])
P_mu = np.array([-Q_lab[(mu >= a) & (mu < b)].mean()
                 for a, b in zip(edges[:-1], edges[1:])])
# ordering sanity check first: emergent flux follows Hopf limb darkening
# mu*(mu + q), q ~ 0.71 -> the counts, normalized per bin, should match
hopf = mid * (mid + 0.7104); hopf /= hopf.sum()
print("escaper counts per bin:", cnt)
print("Hopf-darkening prediction:", np.round(hopf * cnt.sum()).astype(int))
print("P(mu) per bin:", np.round(P_mu, 4))
print(f"limb bin P = {P_mu[0]:.4f} +- {0.7/np.sqrt(cnt[0]):.4f}  "
      f"(Chandrasekhar mu->0 limit: 0.1171; the [0, 0.1] bin AVERAGE of "
      f"his Table XXIV curve is ~0.105)")
print(f"normal bin P = {P_mu[-1]:.4f}  (exact 0 at mu = 1)")
print("sign convention: +P = E-field parallel to the limb "
      "(perpendicular to the meridian plane)")
if os.environ.get("PHYSICL_NB_SMALL") != "1":  # 2e6: noise ~0.009 at limb
    assert 0.08 < P_mu[0] < 0.13, "limb polarization off"
    assert abs(P_mu[-1]) < 0.02, "normal-emergence P should vanish"
    assert (np.diff(P_mu[:6]) < 0.02).all(), "P should fall away from limb"

plt.figure(figsize=(5.5, 3.4))
plt.plot(mid, P_mu, "o-", label="transport (meridian-frame ensemble)")
plt.axhline(0.1171, color="k", ls=":", lw=1,
            label="Chandrasekhar limit 11.71% at mu=0")
plt.xlabel(r"$\\mu = \\cos\\vartheta$ (emergence)")
plt.ylabel("degree of polarization (limb-parallel)")
plt.title("Milne problem: emergent polarization")
plt.legend(); plt.tight_layout(); plt.savefig("polarized_milne.png", dpi=110)
'''


def main():
    nb = nbf.v4.new_notebook()
    nb.cells = [nbf.v4.new_code_cell(c)
                for c in (CELL0, CELL1, CELL2, CELL3, CELL4)]
    ep = ExecutePreprocessor(timeout=2400)
    ep.preprocess(nb, {"metadata": {"path": HERE}})
    out = os.path.join(HERE, "polarized_sky.ipynb")
    from _nbbuild import write_executed
    write_executed(nb, out)


if __name__ == "__main__":
    sys.exit(main())
