"""Build + execute examples/xray_polarimetry.ipynb (polarized Compton
transport: modulation curves, the polarimetry figure of merit, and
Compton depolarization — physicl_tpu.polarization.ScatterPolarizedComptonStep).

Run: python examples/make_polarimetry_nb.py  (executes on the current JAX
backend; PHYSICL_NB_SMALL=1 shrinks photon counts for a CPU smoke run).
"""

import os
import sys

import nbformat as nbf
from nbconvert.preprocessors import ExecutePreprocessor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

CELL0 = '''\
# X-ray polarimetry with polarized Compton transport — extension.
#
# Compton polarimeters (IXPE-class instruments) measure linear
# polarization through the AZIMUTHAL MODULATION of scattered photons:
# for a 100%-polarized beam the azimuth about the incident direction,
# measured from the polarization axis, is distributed as
#
#     p(phi | theta)  =  (1 + a(theta) cos 2phi) / 2pi,
#     a(theta)        =  -sin^2(theta) / (kappa - sin^2(theta)),
#     kappa           =  eta + 1/eta,   eta = 1 + alpha (1 - cos theta)
#
# (the Fano phase matrix's intensity row). |a| is the MODULATION FACTOR
# mu — the instrument's polarization sensitivity. At Thomson energies
# (alpha -> 0, kappa = 2) mu = 1 at 90 degrees: scattered photons avoid
# the polarization plane completely. At finite alpha the kappa - 2
# recoil excess dilutes the modulation — the physical reason Compton
# polarimeters lose sensitivity at high energy. This cell measures
# mu(theta) from transport at three energies against the analytic curve.
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
import matplotlib
import matplotlib.pyplot as plt

N = 30_000 if os.environ.get("PHYSICL_NB_SMALL") == "1" else 2_000_000
A = np.sqrt(2.0 / (float(light.c) * 0.001))   # pcoll = 2: forced scatter


def one_scatter(alpha, stokes, seed):
    """One forced polarized-Compton scatter of a +x beam (pol_ref = z).
    Returns unit outgoing directions, Stokes planes, and E'."""
    s = phys.Simulation(until_t=0.001, seed=seed)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, pol.ScatterPolarizedComptonStep(
        A=np.double(A), n=np.double(A), mec2=1.0 / alpha))
    s.add_photons(pol.polarized_photon_state(N, E=1.0, stokes=stokes))
    s.start(); s.join()
    assert s.used_fused, s.explain_plan()
    v = np.asarray(s.sim_state.v, np.float64)[:, :N]
    st = np.asarray(s.sim_state.extras["stokes"], np.float64)[:, :N]
    E = np.asarray(s.sim_state.E, np.float64)[:N]
    d = v / np.linalg.norm(v, axis=0)
    return d, st, E


plt.figure(figsize=(6.4, 3.8))
colors = {0.01: "#1f77b4", 1.0: "#d62728", 4.0: "#7a4fa3"}
for alpha in (0.01, 1.0, 4.0):
    d, st, E = one_scatter(alpha, (1.0, 0.0, 0.0), seed=29)
    ct = d[0]                       # incident +x
    sin_t = np.sqrt(np.maximum(1 - ct**2, 1e-12))
    # azimuth from the polarization axis (e1 = z, e2 = d x e1 = -y)
    cphi, sphi = d[2] / sin_t, -d[1] / sin_t
    cos2phi = cphi**2 - sphi**2
    edges = np.linspace(-1, 1, 13)
    mid = 0.5 * (edges[1:] + edges[:-1])
    mu_meas, mu_pred = [], []
    for a_, b_ in zip(edges[:-1], edges[1:]):
        m = (ct >= a_) & (ct < b_) & (E < 1 - 1e-9)
        # p ~ 1 + a cos2phi  =>  E[cos 2phi] = a/2  =>  mu = |2 <cos2phi>|
        mu_meas.append(abs(2 * cos2phi[m].mean()))
        eta = 1.0 / E[m]            # E0 = 1: eta = 1/E'
        kap = eta + 1.0 / eta
        s2 = 1 - ct[m]**2
        mu_pred.append((s2 / (kap - s2)).mean())
    lab = "Thomson" if alpha == 0.01 else f"alpha = {alpha:g}"
    plt.plot(np.degrees(np.arccos(mid)), mu_meas, "o",
             color=colors[alpha], ms=4, label=f"transport, {lab}")
    plt.plot(np.degrees(np.arccos(mid)), mu_pred, "-",
             color=colors[alpha], lw=1)
    dev = np.abs(np.array(mu_meas) - np.array(mu_pred)).max()
    print(f"alpha {alpha:>5}: max |mu_meas - mu_analytic| = {dev:.4f}")
plt.xlabel("scattering angle theta (deg)")
plt.ylabel("modulation factor mu(theta)")
plt.title("Compton-polarimeter modulation curves (solid: Fano analytic)")
plt.legend(fontsize=8); plt.tight_layout()
plt.savefig("xray_modulation.png", dpi=110)
'''

CELL1 = '''\
# The energy-integrated modulation factor mu100 (the polarimetry figure
# of merit: the modulation a perfect instrument would see for a 100%-
# polarized source, integrating over the Klein-Nishina theta
# distribution) versus photon energy. Transport measurement: the
# Fourier cos-2phi amplitude over ALL single-scattered photons.
alphas = np.array([0.01, 0.05, 0.2, 0.5, 1.0, 2.0, 4.0, 8.0])
mu100 = []
for i, alpha in enumerate(alphas):
    d, st, E = one_scatter(float(alpha), (1.0, 0.0, 0.0), seed=31 + i)
    ct = d[0]
    sc = E < 1 - 1e-9
    sin_t = np.sqrt(np.maximum(1 - ct**2, 1e-12))
    cphi, sphi = d[2] / sin_t, -d[1] / sin_t
    cos2phi = (cphi**2 - sphi**2)[sc]
    mu100.append(abs(2 * cos2phi.mean()))
    print(f"alpha {float(alpha):>5}: mu100 = {mu100[-1]:.4f}")

# independent numeric prediction: < a(theta) > over the KN angular law
mu_pred = []
for alpha in alphas:
    c_ = np.linspace(-1, 1, 20001)
    eta = 1 + alpha * (1 - c_)
    kap = eta + 1 / eta
    s2 = 1 - c_**2
    w = (kap - s2) / eta**2          # unpolarized KN dsigma/dOmega
    mu_pred.append(np.trapezoid(w * s2 / (kap - s2), c_)
                   / np.trapezoid(w, c_))
mu_pred = np.array(mu_pred)
dev = np.abs(np.array(mu100) - mu_pred).max()
print(f"max |transport - KN-integral| = {dev:.4f}")
assert dev < 0.02

plt.figure(figsize=(5.8, 3.4))
plt.semilogx(alphas, mu100, "o", label="transport (2<cos 2phi>)")
plt.semilogx(alphas, mu_pred, "-", lw=1,
             label="KN-weighted Fano integral")
plt.xlabel(r"$\\alpha = E / m_e c^2$")
plt.ylabel(r"$\\mu_{100}$")
plt.title("Polarimeter figure of merit vs energy")
plt.legend(); plt.tight_layout(); plt.savefig("xray_mu100.png", dpi=110)
'''

CELL2 = '''\
# Compton DEPOLARIZATION: multiple scattering of a pure state. Rayleigh/
# Thomson scattering keeps every photon's purity exactly 1 (the dipole
# matrix maps pure states to pure states — depolarization there is an
# ensemble effect). At finite alpha the Fano matrix's kappa - 2 excess
# makes single photons genuinely depolarize: mean purity decays with
# every scatter, faster at higher energy.
def purity_history(alpha, k_iters, seed):
    s = phys.Simulation(until_t=k_iters * 0.001, seed=seed)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, phys.newton.NewtonianKinematicsStep())
    s.add_step(2, pol.ScatterPolarizedComptonStep(
        A=np.double(A), n=np.double(A), mec2=1.0 / alpha))
    sm = pol.StokesMeasureStep(None, local_qu=False)
    s.add_step(3, sm)
    s.add_photons(pol.polarized_photon_state(
        N // 4, E=1.0, stokes=(1.0, 0.0, 0.0)))
    s.start(); s.join()
    rows = np.array(sm.data, dtype=float)     # [t, n, p_mean, V_mean]
    return rows[:, 2]

plt.figure(figsize=(5.8, 3.4))
for alpha, c_ in ((0.01, "#1f77b4"), (0.5, "#2a9d5c"), (2.0, "#d62728")):
    p = purity_history(alpha, 12, seed=37)
    lab = "Thomson (purity conserved)" if alpha == 0.01 \\
        else f"alpha = {alpha:g}"
    plt.plot(np.arange(1, 13), p, "o-", color=c_, ms=4, label=lab)
    print(f"alpha {alpha:>4}: <p> after 12 scatters = {p[-1]:.4f}")
assert purity_history(0.01, 3, seed=41)[-1] > 0.999
plt.xlabel("scatter number"); plt.ylabel("mean photon purity <p>")
plt.title("Compton depolarization of a pure state")
plt.ylim(0, 1.05); plt.legend(fontsize=8)
plt.tight_layout(); plt.savefig("xray_depolarization.png", dpi=110)
'''


def main():
    nb = nbf.v4.new_notebook()
    nb.cells = [nbf.v4.new_code_cell(c) for c in (CELL0, CELL1, CELL2)]
    ep = ExecutePreprocessor(timeout=2400)
    ep.preprocess(nb, {"metadata": {"path": HERE}})
    out = os.path.join(HERE, "xray_polarimetry.ipynb")
    from _nbbuild import write_executed
    write_executed(nb, out)


if __name__ == "__main__":
    main()
