"""On-chip physics validation: run on the GPU (no pytest, no CPU
emulation — this exercises the fused chunk end to end on the card).

    python3 scripts/validate_chip.py      # also phase 4 of chip_smoke.py

Checks the reference's statistical invariants plus kernel-specific ones:

1. absorption decay rate per step == 1 - pcoll (uniformity of the draws);
2. reference acceptance test: survival proportional to e^-1 at x = 1/(nA);
3. isotropy relaxation follows 0.5 + 0.5*(1 - pcoll)^k analytically;
4. scatter directions: |v| = c exactly, theta recovered from vz uniform
   (the reference's angle-uniform distribution), sign balance at 50%.

Prints PASS/FAIL per check; exits nonzero on any failure.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np

import physicl_tpu as phys
import physicl_tpu.newton
import physicl_tpu.light as light

FAILURES = []


def check(name, ok, detail):
    print(f"{'PASS' if ok else 'FAIL'}  {name}: {detail}")
    if not ok:
        FAILURES.append(name)


def main():
    N = 1_000_000
    n = A = 0.001
    pcoll = n * A * float(light.c) * 0.001

    # 1+2: absorption
    s = phys.Simulation(seed=3)
    s.exit = lambda x: len(x.objects) == 0
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterDeleteStep(np.double(n), np.double(A)))
    meas = light.ScatterMeasureStep(None, True, [[1 / (n * A), np.nan, np.nan]])
    s.add_step(3, meas)
    s.add_photons(light.generate_photon_state(N, E=1.0))
    s.start(); s.join()
    decays = np.array([meas.data[i + 1][1] / meas.data[i][1] for i in range(5)])
    check("absorption decay/step", np.allclose(decays, 1 - pcoll, atol=0.01),
          f"measured {decays.mean():.5f} vs {1 - pcoll:.5f}")
    # the reference's own acceptance formula (test_light.py:62: a whole data
    # row summed — t + n_alive + count; kept verbatim for parity)
    N_x = sum(meas.data[2])
    err = (np.e ** -1 - N_x / N) / np.e ** -1
    check("e^-1 survival (reference acceptance formula)", abs(err) < 0.10,
          f"error {err:+.3%} (tolerance 10%)")
    # the physically-sharp version: total plane crossings vs the exact
    # discrete-step expectation (1 - pcoll)^ceil(x/(c dt))
    crossed = sum(int(r[2]) for r in meas.data)
    steps_to_plane = int(np.ceil((1 / (n * A)) / (float(light.c) * 0.001)))
    expect = (1 - pcoll) ** steps_to_plane
    cerr = (expect - crossed / N) / expect
    check("crossing count vs discrete expectation", abs(cerr) < 0.05,
          f"survival {crossed / N:.4f} vs {expect:.4f} (err {cerr:+.3%})")

    # 3: isotropy relaxation
    s = phys.Simulation(exit=lambda c: c.t >= 0.030, seed=7)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterIsotropicStep(A=np.double(A), n=np.double(n)))
    sign = light.ScatterSignMeasureStep(None, True)
    s.add_step(3, sign)
    s.add_photons(light.generate_photon_state(N, E=1.0))
    s.start(); s.join()
    shares = np.array([r[2] / r[1] for r in sign.data])
    expect = 0.5 + 0.5 * (1 - pcoll) ** np.arange(1, len(shares) + 1)
    dev = np.abs(shares - expect).max()
    check("isotropy relaxation", dev < 0.01, f"max deviation {dev:.4f}")

    # 4: direction distribution after forced scatter
    s = phys.Simulation(exit=lambda c: c.t >= 0.001, seed=5)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterIsotropicStep(A=1.0, n=1.0))
    s.add_photons(light.generate_photon_state(N, E=1.0))
    s.start(); s.join()
    v = np.asarray(s.sim_state.v)[:, :N] / float(light.c)
    speed_dev = np.abs(np.linalg.norm(v, axis=0) - 1).max()
    check("|v| = c after scatter", speed_dev < 1e-5, f"max dev {speed_dev:.2e}")
    p_half = (np.abs(v[2]) < np.cos(np.pi / 4)).mean()
    check("angle-uniform theta (P(|vz|<cos pi/4) = 0.5)",
          abs(p_half - 0.5) < 0.01, f"measured {p_half:.4f}")
    th = np.arccos(np.clip(v[2], -1, 1))
    hist, _ = np.histogram(th, bins=10, range=(0, np.pi), density=True)
    check("theta histogram uniform at 1/pi",
          np.abs(hist - 1 / np.pi).max() < 0.01,
          f"max dev {np.abs(hist - 1 / np.pi).max():.4f}")
    signs = [(v[d] > 0).mean() for d in range(3)]
    check("sign balance", max(abs(x - 0.5) for x in signs) < 0.01,
          f"shares {[round(x, 4) for x in signs]}")

    # 5 (round 2): in-kernel Planck-sampled emitter spectrum
    T = 5778.0
    kT = float(light.kB.value()) * T
    a, b = 0.1 * kT, 12 * kT
    sampler = light.PlanckSampler(a, b, T, bins=2000)
    s = phys.Simulation(exit=lambda c: c.t >= 0.064, seed=0, capacity=2 ** 20)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, light.PhotonEmitterStep(10_000, E=sampler))
    s.add_step(2, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_photons(light.generate_photon_state(128, E=1.0))
    s.start(); s.join()
    check("sampled-E emitter stays fused", s.used_fused, f"{s.used_fused}")
    E = np.asarray(s.sim_state.E)
    alive = np.asarray(s.sim_state.alive)
    sampled = E[alive][128:]
    hist, edges = np.histogram(sampled, bins=40, range=(a, b), density=True)
    centers = 0.5 * (edges[1:] + edges[:-1])
    analytic = np.array([float(light.planck_distribution(x, T).value())
                         for x in centers])
    analytic /= np.trapezoid(analytic, centers)
    mask = analytic > 0.10 * analytic.max()
    rel = np.abs(hist[mask] - analytic[mask]) / analytic[mask]
    check("in-kernel Planck spectrum parity", rel.max() < 0.08,
          f"{len(sampled)} photons, max rel dev {rel.max():.3%}")

    # 6 (round 2): device-resident trace — per-step traveled distance
    s = phys.Simulation(exit=lambda c: c.t >= 0.016, seed=11)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterIsotropicStep(A=np.double(A), n=np.double(n)))
    tr = light.TracePathMeasureStep(None, trace_dv=True)
    s.add_step(3, tr)
    s.add_photons(light.generate_photon_state(100_000, E=1.0))
    s.start(); s.join()
    check("trace pipeline stays fused", s.used_fused, f"{s.used_fused}")
    ts, pos, al, freq = tr.as_arrays()
    seg = np.linalg.norm(np.diff(pos[:, :, :100_000], axis=0), axis=1)
    dev = np.abs(seg - float(light.c) * 1e-3).max() / (float(light.c) * 1e-3)
    check("trace segment lengths = c*dt", dev < 5e-3,
          f"max rel dev {dev:.2e} over {seg.size} segments")
    rate = freq[:100_000].sum() / (100_000 * len(ts))
    check("trace scatter frequency = pcoll", abs(rate - pcoll) / pcoll < 0.05,
          f"{rate:.5f} vs {pcoll:.5f}")

    # 7 (round 2): reflecting boundary keeps every photon inside the box
    L = float(light.c) * 0.0023
    s = phys.Simulation(exit=lambda c: c.t >= 0.010, seed=2)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_step(2, physicl_tpu.newton.ReflectingBoundaryStep(
        np.array([[-L, L], [-L, L], [-L, L]])))
    s.add_step(3, light.ScatterIsotropicStep(A=np.double(A), n=np.double(n)))
    s.add_photons(light.generate_photon_state(100_000, E=1.0))
    s.start(); s.join()
    check("boundary pipeline stays fused", s.used_fused, f"{s.used_fused}")
    r = np.asarray(s.sim_state.r)[:, :100_000]
    out_frac = (np.abs(r) > L * (1 + 1e-5)).mean()
    check("reflecting box containment", out_frac == 0.0,
          f"fraction outside {out_frac:.2e}")

    # 8 (round 3): Henyey-Greenstein anisotropy — <cos theta> == g and
    # exact speed preservation through the frame rotation
    for g in (0.7, -0.3):
        s = phys.Simulation(until_t=0.001, seed=4)
        s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
        s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
        s.add_step(2, light.ScatterHenyeyGreensteinStep(A=1.0, n=1.0, g=g))
        s.add_photons(light.generate_photon_state(100_000, E=1.0))
        s.start(); s.join()
        check(f"HG pipeline stays fused (g={g})", s.used_fused,
              f"{s.used_fused}")
        v = np.asarray(s.sim_state.v)[:, :100_000]
        dv = np.asarray(s.sim_state.dv)[:, :100_000]
        scat = np.any(dv != 0, axis=0)
        cos_t = v[0, scat] / float(light.c)
        check(f"HG mean cosine == g (g={g})",
              abs(cos_t.mean() - g) < 0.015,
              f"<cos> {cos_t.mean():+.4f} over {int(scat.sum())} events")
        spd = np.sqrt((v[:, scat] ** 2).sum(axis=0)) / float(light.c)
        check(f"HG speed preserved (g={g})",
              np.abs(spd - 1).max() < 3e-5,
              f"max |v|/c deviation {np.abs(spd - 1).max():.2e}")

    # 9 (round 3, late): Rayleigh dipole phase — <cos^2 theta> == 2/5
    # (isotropic would give 1/3) and exact speed preservation
    s = phys.Simulation(until_t=0.001, seed=5)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterRayleighStep(A=1.0, n=1.0))
    s.add_photons(light.generate_photon_state(100_000, E=1.0))
    s.start(); s.join()
    check("Rayleigh pipeline stays fused", s.used_fused, f"{s.used_fused}")
    v = np.asarray(s.sim_state.v)[:, :100_000]
    dv = np.asarray(s.sim_state.dv)[:, :100_000]
    scat = np.any(dv != 0, axis=0)
    cos_t = v[0, scat] / float(light.c)
    m2 = float((cos_t ** 2).mean())
    check("Rayleigh <cos^2> == 2/5", abs(m2 - 0.4) < 0.01,
          f"<cos^2> {m2:.4f} over {int(scat.sum())} events")
    check("Rayleigh <cos> == 0", abs(float(cos_t.mean())) < 0.01,
          f"<cos> {float(cos_t.mean()):+.4f}")
    spd = np.sqrt((v[:, scat] ** 2).sum(axis=0)) / float(light.c)
    check("Rayleigh speed preserved", np.abs(spd - 1).max() < 3e-5,
          f"max |v|/c deviation {np.abs(spd - 1).max():.2e}")

    # 10 (round 3, late): Compton — exact Klein-Nishina kinematics at
    # alpha = 1 (511 keV): the stored E' must satisfy the recoil relation
    # against the ACTUAL outgoing direction, the Compton edge must bound
    # the spectrum at 1/(1+2a), and speed stays c
    s = phys.Simulation(until_t=0.001, seed=6)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterComptonStep(A=1.0, n=1.0, mec2=1.0))
    s.add_photons(light.generate_photon_state(100_000, E=1.0))
    s.start(); s.join()
    check("Compton pipeline stays fused", s.used_fused, f"{s.used_fused}")
    v = np.asarray(s.sim_state.v)[:, :100_000]
    E = np.asarray(s.sim_state.E)[:100_000]
    cos_t = v[0] / float(light.c)
    scat = E != np.float32(1.0)
    pred = 1.0 / (1.0 + (1.0 - cos_t[scat]))
    kerr = np.abs(E[scat] - pred).max()
    check("Compton E'-angle relation exact", kerr < 3e-5,
          f"max |E' - 1/(1+a(1-cos))| {kerr:.2e} over {int(scat.sum())}")
    check("Compton edge respected",
          E.min() >= 1.0 / 3.0 - 1e-6 and E.max() <= 1.0 + 1e-6,
          f"min E'/E {E.min():.4f} (edge 1/3)")
    spd = np.sqrt((v[:, scat] ** 2).sum(axis=0)) / float(light.c)
    check("Compton speed preserved", np.abs(spd - 1).max() < 3e-5,
          f"max |v|/c deviation {np.abs(spd - 1).max():.2e}")

    # 11 (round 3, late): thermal Comptonization — the Kompaneets drift
    # <dE/E> = 4 theta_e for soft photons through hot Maxwell electrons
    # (collision probability UNSATURATED so the flux factor can reweight)
    theta_e, p = 0.01, 0.3
    s = phys.Simulation(until_t=0.001, seed=8)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterComptonStep(
        A=p / (float(light.c) * 0.001), n=1.0, mec2=1e9, theta_e=theta_e))
    s.add_photons(light.generate_photon_state(300_000, E=1.0))
    s.start(); s.join()
    check("thermal Compton pipeline stays fused", s.used_fused,
          f"{s.used_fused}")
    E = np.asarray(s.sim_state.E)[:300_000]
    scat = E != np.float32(1.0)
    gain = float(E[scat].mean()) - 1.0
    check("Kompaneets drift == 4 theta_e",
          abs(gain - 4 * theta_e) < 0.005,
          f"<dE/E> {gain:+.5f} vs 4 theta_e {4 * theta_e:+.5f} over "
          f"{int(scat.sum())} scatters")
    v = np.asarray(s.sim_state.v)[:, :300_000]
    spd = np.sqrt((v[:, scat] ** 2).sum(axis=0)) / float(light.c)
    check("thermal Compton speed preserved", np.abs(spd - 1).max() < 3e-5,
          f"max |v|/c deviation {np.abs(spd - 1).max():.2e}")

    # --- charged-particle fused path (round-3 late: Boris pusher) ---
    B0, qm, v0, k_b = 200.0, 1.0, 7.0, 500
    s = phys.Simulation(until_t=1e-3 * k_b * 0.9999, seed=0)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(1e-3)))
    s.add_step(1, physicl_tpu.newton.LorentzForceStep(
        B_field=(0, 0, B0), q_over_m=qm))
    s.add_step(2, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_particles(physicl_tpu.newton.generate_particle_state(
        100_000, v=(v0, 0.0, 0.0)))
    s.start(); s.join()
    check("charged (Boris) pipeline stays fused", s.used_fused,
          f"{s.used_fused}")
    v = np.asarray(s.sim_state.v)[:, :100_000]
    spd = np.linalg.norm(v, axis=0)
    check("Boris |v| exactly conserved over 500 steps",
          float(np.abs(spd - v0).max()) < 3e-5 * v0,
          f"max |v| drift {np.abs(spd - v0).max():.2e}")
    theta = 2.0 * np.arctan(0.5 * qm * B0 * 1e-3)
    got = float(np.arctan2(v[1, 0], v[0, 0]))
    err = abs(np.exp(1j * got) - np.exp(-1j * k_b * theta))
    check("gyro phase == 2 atan(h|B|) per step", err < 2e-4,
          f"phase error {err:.2e} after {k_b} steps")

    # --- mixed photon+charged population in ONE kernel (otype plane) ---
    p_abs, k_m = 0.015, 200
    s = phys.Simulation(until_t=1e-3 * k_m * 0.9999, seed=11)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(1e-3)))
    s.add_step(1, physicl_tpu.newton.LorentzForceStep(
        B_field=(0, 0, 120.0), q_over_m=2.0))
    s.add_step(2, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_step(3, light.ScatterDeleteStep(
        np.double(p_abs / (float(light.c) * 1e-3)), np.double(1.0)))
    s.add_photons(light.generate_photon_state(100_000, E=1.0))
    s.add_particles(physicl_tpu.newton.generate_particle_state(
        8192, v=(2.0, 0.0, 0.0)))
    s.start(); s.join()
    check("mixed-species pipeline stays fused", s.used_fused,
          f"{s.used_fused}")
    n_tot = 100_000 + 8192
    otype = np.asarray(s.sim_state.otype)[:n_tot]
    alive = np.asarray(s.sim_state.alive)[:n_tot]
    v = np.asarray(s.sim_state.v)[:, :n_tot]
    surv = alive[otype == 1].sum() / 100_000
    expect = (1 - p_abs) ** k_m
    check("mixed: photon Beer-Lambert",
          abs(surv - expect) < 6 * np.sqrt(expect * 1e5) / 1e5 + 1e-3,
          f"survival {surv:.4f} vs (1-p)^k {expect:.4f}")
    sp = np.linalg.norm(v[:, otype != 1], axis=0)
    check("mixed: charged immortal + speed exact",
          int(alive[otype != 1].sum()) == 8192
          and float(np.abs(sp - 2.0).max()) < 3e-5 * 2.0,
          f"alive {int(alive[otype != 1].sum())}/8192, "
          f"max |v| drift {np.abs(sp - 2.0).max():.2e}")

    # --- exponential transform (round-3 cont.): biased kill + likelihood
    # ratio weights, on the hardware PRNG (mu = 1 beam => both population
    # and weight laws are closed-form)
    n0, kk, pp, bb = 1_000_000, 60, 0.1, 0.8
    s = phys.Simulation(until_t=1e-3 * kk * 0.9999, seed=21)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(1e-3)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterDeleteStep(
        np.double(1.0), np.double(pp / (float(light.c) * 1e-3)),
        stretch=bb))
    s.add_photons(light.generate_photon_state(n0, E=1.0))
    s.start(); s.join()
    check("exponential transform stays fused", s.used_fused,
          f"{s.used_fused}")
    w = np.asarray(s.sim_state.w, np.float64)
    alive = np.asarray(s.sim_state.alive)
    wsum, n_alive = w[alive].sum(), int(alive.sum())
    exp_w = n0 * (1 - pp) ** kk
    exp_n = n0 * (1 - pp * (1 - bb)) ** kk
    check("transform: E[sum w] == N(1-p)^k",
          abs(wsum - exp_w) / exp_w < 0.03,
          f"{wsum:.1f} vs {exp_w:.1f} ({abs(wsum - exp_w) / exp_w:.1%})")
    check("transform: biased population == N(1-p(1-b))^k",
          abs(n_alive - exp_n) / exp_n < 0.02,
          f"{n_alive} vs {exp_n:.0f} (x{n_alive / max(exp_w, 1):.0f} "
          f"deeper than analog)")
    w_exact = ((1 - pp) / (1 - pp * (1 - bb))) ** kk
    werr = float(np.abs(w[alive] - w_exact).max()) / w_exact
    check("transform: per-photon weight exactly ((1-p)/(1-p'))^k",
          werr < 1e-4, f"max rel err {werr:.1e}")

    # --- user phase function (tabulated): forward-peaked exp(3 mu) has
    # the Langevin mean <cos theta> = coth(3) - 1/3 (hardware PRNG)
    mu_g = np.linspace(-1, 1, 501)
    s = phys.Simulation(until_t=1e-3 * 0.9999, seed=4)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(1e-3)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterPhaseFunctionStep(
        A=np.double(1.0 / (float(light.c) * 1e-3)), n=np.double(1.0),
        phase_table=(mu_g, np.exp(3.0 * mu_g)), table_bins=128))
    s.add_photons(light.generate_photon_state(200_000, E=1.0))
    s.start(); s.join()
    check("tabulated phase function stays fused", s.used_fused,
          f"{s.used_fused}")
    v = np.asarray(s.sim_state.v, np.float64)[:, :200_000]
    m = float((v[0] / np.linalg.norm(v, axis=0)).mean())
    expect_m = 1.0 / np.tanh(3.0) - 1.0 / 3.0
    check("phase table: <cos theta> == coth(3) - 1/3",
          abs(m - expect_m) < 0.006, f"{m:.4f} vs {expect_m:.4f}")
    spd = np.linalg.norm(v, axis=0) / float(light.c)
    check("phase table: |v| = c exact",
          float(np.abs(spd - 1).max()) < 3e-5,
          f"max |v|/c deviation {np.abs(spd - 1).max():.2e}")

    # --- spherical geometry: every photon of a ballistic burst crosses
    # the shell exactly once, then dies at the escape sphere
    c_v = float(light.c)
    Rs = 4.5 * c_v * 1e-3
    s = phys.Simulation(until_t=0.008 * 0.9999, seed=6)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(1e-3)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    shell = light.SphericalShellMeasureStep(None, radius=np.double(Rs))
    s.add_step(2, shell)
    s.add_step(3, physicl_tpu.newton.AbsorbingSphereStep(
        np.double(1.2 * Rs)))
    s.add_photons(light.generate_photon_state(200_000, E=1.0))
    s.start(); s.join()
    check("sphere pipeline stays fused", s.used_fused, f"{s.used_fused}")
    rows = np.array(shell.data, dtype=float)
    check("shell tally: one crossing per photon at the ballistic step",
          int(rows[:, 2].sum()) == 200_000 and int(rows[4, 2]) == 200_000,
          f"total {int(rows[:, 2].sum())}, step5 {int(rows[4, 2])}")
    check("escape sphere: everything absorbed",
          int(np.asarray(s.sim_state.alive).sum()) == 0,
          f"alive {int(np.asarray(s.sim_state.alive).sum())}")

    # --- chunk-boundary splitting: fused transport + boundary population
    # control (ImportanceSplitStep(at="chunk"))
    import jax.numpy as jnp
    Kc = 32
    s = phys.Simulation(until_t=4 * Kc * 1e-3 * 0.9999, seed=23,
                        capacity=131072, chunk_steps=Kc)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(1e-3)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    step_len = float(light.c) * 1e-3
    s.add_step(2, light.ImportanceSplitStep(
        lambda x, y, z: 2.0 ** jnp.floor(x / (Kc * step_len) + 0.5),
        roulette=False, at="chunk"))
    s.add_photons(light.generate_photon_state(4096, E=1.0))
    s.start(); s.join()
    check("chunk-boundary split keeps fused", s.used_fused,
          f"{s.used_fused}")
    w = np.asarray(s.sim_state.w, np.float64)
    alive = np.asarray(s.sim_state.alive)
    check("chunk-boundary split: population doubles per boundary",
          int(alive.sum()) == 4096 * 2 ** 3,
          f"{int(alive.sum())} vs {4096 * 2 ** 3}")
    check("chunk-boundary split: total weight exact",
          abs(w[alive].sum() - 4096.0) < 0.5,
          f"{w[alive].sum():.2f} vs 4096")

    # --- mesh tally: track-length estimator in a scattering slab conserves
    # total path (every alive photon deposits exactly c*dt per iteration
    # somewhere; with under/overflow capture the cells sum to N_alive*c*dt)
    c_dt = float(light.c) * 1e-3
    iters = 8
    s = phys.Simulation(until_t=iters * 1e-3 * 0.9999, seed=31)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(1e-3)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_step(2, light.ScatterIsotropicStep(n=np.double(1e-3),
                                             A=np.double(1e-3)))
    tal = light.MeshTallyStep(None, axis="x",
                              edges=np.linspace(0, 6 * c_dt, 61),
                              value="pathlength", measure_n=True,
                              underflow=True, overflow=True)
    s.add_step(3, tal)
    # start half a cell in so the f32 front never straddles a bin edge
    s.add_photons(light.generate_photon_state(
        1_000_000, E=1.0, r=np.array([0.05 * c_dt, 0.0, 0.0])))
    s.start(); s.join()
    check("mesh tally pipeline stays fused", s.used_fused, f"{s.used_fused}")
    rows = np.array(tal.data, dtype=float)
    per_iter = rows[:, 2:].sum(axis=1) / (rows[:, 1] * c_dt)
    check("mesh tally: track length conserved (sum cells = n*c*dt)",
          np.allclose(per_iter, 1.0, atol=1e-3),
          f"max |sum/(n c dt) - 1| = {np.abs(per_iter - 1).max():.2e}")
    # ballistic front: at iteration 1 every photon sits mid-cell 10
    # (x = 1.05*c_dt, 10 cells per c*dt)
    k0 = int(np.argmax(rows[0, 2:]))
    check("mesh tally: ballistic front in the right cell",
          k0 == 10, f"iteration-1 peak cell {k0} (expect 10)")

    # --- polarized Rayleigh (FUSED Pallas op "pol" on the chip — the
    # Stokes/frame triples ride writable packed extras planes): one forced
    # scatter of an unpolarized beam acquires EXACTLY Q = (c^2-1)/(1+c^2)
    # per photon; purity of a pure state is conserved
    import physicl_tpu.polarization as pol
    Ap = np.sqrt(2.0 / (float(light.c) * 1e-3))
    s = phys.Simulation(until_t=1e-3 * 0.9999, seed=41)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(1e-3)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_step(2, pol.ScatterPolarizedRayleighStep(
        A=np.double(Ap), n=np.double(Ap)))
    s.add_photons(pol.polarized_photon_state(200_000, E=1.0))
    s.start(); s.join()
    check("polarized pipeline runs FUSED (pol op, 21-plane state)",
          s.used_fused, f"used_fused={s.used_fused}")
    st = np.asarray(s.sim_state.extras["stokes"], np.float64)
    v = np.asarray(s.sim_state.v, np.float64)
    alive = np.asarray(s.sim_state.alive)
    cmu = v[0, alive] / np.linalg.norm(v[:, alive], axis=0)
    dev = np.abs(st[0, alive] - (cmu ** 2 - 1) / (1 + cmu ** 2)).max()
    check("polarized Rayleigh: single-scatter Q law exact",
          dev < 5e-5, f"max |Q - (c^2-1)/(1+c^2)| = {dev:.2e}")
    dev_uv = max(np.abs(st[1, alive]).max(), np.abs(st[2, alive]).max())
    check("polarized Rayleigh: U = V = 0 for unpolarized input",
          dev_uv < 5e-5, f"max |U|,|V| = {dev_uv:.2e}")

    # fused multi-scatter + in-kernel Stokes summary (polmeas op): the
    # local-frame <Q> fixed point is -1/2 from the first scatter on
    # (E[Q'] = ∫(c^2-1)dc / ∫(1+c^2)dc), purity of pure states stays 1,
    # and the Q=1 azimuth anisotropy matches the 1e7-sample numpy oracle
    # E[cos 2phi] = E[r(theta)/2 ...] ≈ -0.17348
    s = phys.Simulation(until_t=8e-3 * 0.9999, seed=43)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(1e-3)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    s.add_step(2, pol.ScatterPolarizedRayleighStep(
        A=np.double(Ap), n=np.double(Ap)))
    sm = pol.StokesMeasureStep(None)
    s.add_step(3, sm)
    s.add_photons(pol.polarized_photon_state(200_000, E=1.0,
                                             stokes=(1.0, 0.0, 0.0)))
    s.start(); s.join()
    check("polarized + Stokes summary stays fused", s.used_fused,
          f"used_fused={s.used_fused}")
    rows = np.array(sm.data, dtype=float)  # [t, n, p, V, Q, U]
    check("polmeas: purity of pure states == 1 over 8 scatters",
          np.abs(rows[:, 2] - 1.0).max() < 5e-4,
          f"max |<p>-1| = {np.abs(rows[:, 2] - 1.0).max():.2e}")
    check("polmeas: local-frame <Q> at the -1/2 fixed point",
          np.abs(rows[:, 4] + 0.5).max() < 0.01,
          f"max |<Q>+0.5| = {np.abs(rows[:, 4] + 0.5).max():.3f}")
    v1 = np.asarray(s.sim_state.v, np.float64)
    spd = np.linalg.norm(v1[:, :200_000], axis=0) / float(light.c)
    check("polarized: |v| = c preserved over 8 fused scatters",
          np.abs(spd - 1).max() < 3e-6,
          f"max | |v|/c - 1 | = {np.abs(spd - 1).max():.2e}")

    # --- polarized Compton (fused op "polc": Fano/McMaster matrix +
    # Klein-Nishina angles + recoil): one forced scatter at alpha = 1 —
    # the exact per-photon Q' = -s^2/(kappa - s^2) polarimetry law, the
    # eta-angle relation, and the heating tally
    s = phys.Simulation(until_t=1e-3 * 0.9999, seed=47)
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(1e-3)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    pc = pol.ScatterPolarizedComptonStep(
        A=np.double(Ap), n=np.double(Ap), mec2=1.0,
        measure_deposition=True)
    s.add_step(2, pc)
    s.add_photons(pol.polarized_photon_state(200_000, E=1.0))
    s.start(); s.join()
    check("polarized Compton pipeline runs FUSED", s.used_fused,
          f"used_fused={s.used_fused}")
    st = np.asarray(s.sim_state.extras["stokes"], np.float64)[:, :200_000]
    v = np.asarray(s.sim_state.v, np.float64)[:, :200_000]
    E = np.asarray(s.sim_state.E, np.float64)[:200_000]
    cm = v[0] / np.linalg.norm(v, axis=0)
    sc = E < 1.0 - 1e-9
    eta = 1.0 / E[sc]
    dev = np.abs(eta - (1.0 + (1.0 - cm[sc]))).max()
    check("polarized Compton: eta = 1 + alpha(1-cos) exact",
          dev < 1e-5, f"max dev = {dev:.2e}")
    kap = eta + 1.0 / eta
    s2 = 1.0 - cm[sc] ** 2
    dev = np.abs(st[0][sc] + s2 / (kap - s2)).max()
    check("polarized Compton: Q' = -s^2/(kappa - s^2) exact",
          dev < 1e-5, f"max dev = {dev:.2e}")
    rows = np.array(pc.data, dtype=float)
    dep_dev = abs(rows[0, 1] - (1.0 - E[sc]).sum()) / max(
        (1.0 - E[sc]).sum(), 1e-30)
    check("polarized Compton: heating tally == sum w(E - E')",
          dep_dev < 1e-3, f"rel dev = {dep_dev:.2e}")

    # --- fluorescent re-emission: two-state decay + exact energy budget
    # (module-level `import physicl_tpu as phys` is already in scope; a
    # local re-import here shadowed it for the WHOLE function and broke
    # every earlier check with UnboundLocalError — r4 on-chip run)
    Nf, pf, Yf, kf, E0f = 262144, 0.1, 0.6, 20, 2.0
    s = phys.Simulation(until_t=kf * 1e-3, seed=11, fuse="auto")
    s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
    s.add_step(1, physicl_tpu.newton.NewtonianKinematicsStep())
    dele = light.ScatterDeleteStep(
        np.double(1.0), np.double(pf / (float(light.c) * 1e-3)),
        fluorescence=(Yf, 1.0), fluorescence_edge=1.5,
        measure_deposition=True)
    s.add_step(2, dele)
    s.add_photons(light.generate_photon_state(Nf, E=E0f))
    s.start(); s.join()
    check("fluorescence pipeline stays fused", s.used_fused,
          f"{s.used_fused}")
    st = s.sim_state
    alive = np.asarray(st.alive)
    E = np.asarray(st.E, np.float64)
    n_src = int((alive & (E == E0f)).sum())
    n_line = int((alive & (E == 1.0)).sum())
    exp_src = Nf * (1 - pf) ** kf
    exp_line = Nf * Yf * pf * kf * (1 - pf) ** (kf - 1)
    check("fluorescence: source line drains at (1-p)^k",
          abs(n_src - exp_src) / exp_src < 0.03,
          f"{n_src} vs {exp_src:.0f}")
    check("fluorescence: line population = N*Y*p*k*(1-p)^(k-1)",
          abs(n_line - exp_line) / exp_line < 0.03,
          f"{n_line} vs {exp_line:.0f}")
    inflight = float(E[alive].sum())
    deposited = float(np.array(dele.data, dtype=float)[:, 1].sum())
    e_dev = abs(inflight + deposited - Nf * E0f) / (Nf * E0f)
    check("fluorescence: exact energy budget (in-flight + deposited)",
          e_dev < 1e-4, f"rel dev = {e_dev:.2e}")
    vline = np.asarray(st.v, np.float64)[:, alive & (E == 1.0)]
    cos_line = vline[2] / np.sqrt((vline ** 2).sum(axis=0))
    check("fluorescence: re-emission true-isotropic (<cos>~0, P(|c|<.5)=.5)",
          abs(cos_line.mean()) < 0.02
          and abs((np.abs(cos_line) < 0.5).mean() - 0.5) < 0.02,
          f"<cos> {cos_line.mean():+.4f}, "
          f"P {np.mean(np.abs(cos_line) < 0.5):.4f}")

    print()
    if FAILURES:
        print(f"{len(FAILURES)} FAILED: {FAILURES}")
        raise SystemExit(1)
    print("all on-chip validations passed")


if __name__ == "__main__":
    main()
