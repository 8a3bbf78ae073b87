"""Hardware-utilization accounting for fused transport chunks.

The reference ships no performance model at all (BASELINE.md: every number
is reverse-engineered from notebook wall-clocks); "matching or beating" a
machine needs a ceiling to measure against, not just a baseline. This
module derives an ops+bytes model for one fused-chunk iteration by TRACING
the chunk's own op pipeline (``ops.fused._emit_iteration`` — the same code
the Triton kernel and the XLA chunk execute) to a jaxpr and counting
primitive work, then positions a measured photon-steps/s rate against the
device's compute and memory roofs.

The count is a *model*, documented conservative choices:

* element-wise primitives cost 1 op per output element; divides/sqrts 4
  (reciprocal-iteration expansions); true transcendentals
  (exp/log/sin/cos/...) 8 — the fused op bodies mostly avoid them
  (fast_trig polynomials), so this term is usually small;
* random draws are the counter-based hash of ``ops.fused._Rng``, traced
  like any other op body code and counted as its integer ops (about 20 per
  element per draw); ``prng_draw_elems`` tallies the draws;
* pure data movement (broadcast/reshape/slice/select-index bookkeeping)
  counts 0 — register-resident relayouts overlap ALU work;
* table gathers (voxel media) cost 2 ops per element.

Device-memory bytes per chunk are exact for the Triton kernel: the packed
state crosses device memory once each way per chunk, plus record rows and
stream planes. (The XLA chunk moves the state every iteration instead.)

Peaks (``PEAKS``) are per device kind: (f32 ops/s, memory bytes/s). The
table is empty until a benchmark adds measured GPU entries keyed by
``device_kind`` with their source; until then every device reports
utilizations as None rather than against a guessed roof.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["PEAKS", "iteration_cost", "roofline_report"]

# device_kind -> (f32 ops/s, memory bytes/s), each entry with its source
PEAKS: dict = {}

_ELEMENTWISE_1 = {
    "add", "sub", "mul", "max", "min", "and", "or", "xor", "not", "neg",
    "abs", "sign", "floor", "ceil", "round", "eq", "ne", "lt", "le", "gt",
    "ge", "select_n", "convert_element_type", "shift_left",
    "shift_right_logical", "shift_right_arithmetic", "clamp",
    "integer_pow", "is_finite", "rem", "nextafter", "population_count",
}
_EXPENSIVE_4 = {"div", "sqrt", "rsqrt"}
_TRANSCENDENTAL_8 = {"exp", "log", "log1p", "expm1", "sin", "cos", "tan",
                     "atan2", "pow", "erf", "erf_inv", "logistic", "tanh",
                     "cbrt", "asin", "acos", "atan", "sinh", "cosh"}
_FREE = {"broadcast_in_dim", "reshape", "squeeze", "transpose", "slice",
         "concatenate", "iota", "copy", "stop_gradient", "bitcast_convert_type",
         "dynamic_slice", "dynamic_update_slice", "pad", "rev",
         "expand_dims"}

def _size(aval) -> int:
    return int(np.prod(aval.shape)) if aval.shape else 1


def _count_jaxpr(jaxpr) -> dict:
    """Walk a (closed) jaxpr counting modeled ALU ops. Control-flow
    bodies (while/scan/cond) are counted ONCE — their trip count is not
    statically recoverable — so ``uncounted_loop_bodies`` flags any such
    body: callers must treat utilizations as unreliable when it is
    nonzero (the fused iteration bodies are loop-free by design; the
    r4b on-chip runs showed loop forms are slower anyway)."""
    c = {"vpu_ops": 0.0, "transcendentals": 0.0, "gather_elems": 0.0,
         "reduce_elems": 0.0, "uncounted_loop_bodies": 0.0}
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        out_sz = max((_size(v.aval) for v in eqn.outvars), default=1)
        in_sz = max((_size(v.aval) for v in eqn.invars
                     if hasattr(v, "aval")), default=1)
        if prim in _FREE:
            continue
        if prim in _ELEMENTWISE_1:
            c["vpu_ops"] += out_sz
        elif prim in _EXPENSIVE_4:
            c["vpu_ops"] += 4 * out_sz
        elif prim in _TRANSCENDENTAL_8:
            c["vpu_ops"] += 8 * out_sz
            c["transcendentals"] += out_sz
        elif prim in ("reduce_sum", "reduce_max", "reduce_min", "reduce_and",
                      "reduce_or", "argmax", "argmin", "reduce_precision"):
            c["vpu_ops"] += in_sz
            c["reduce_elems"] += in_sz
        elif prim in ("gather", "take_along_axis", "dynamic_gather"):
            c["vpu_ops"] += 2 * out_sz
            c["gather_elems"] += out_sz
        elif prim in ("scan", "while", "cond", "custom_jvp_call",
                      "custom_vjp_call", "pjit", "closed_call",
                      "remat", "checkpoint"):
            if prim in ("scan", "while"):
                c["uncounted_loop_bodies"] += 1
            for sub in eqn.params.values():
                sub_jaxprs = []
                if hasattr(sub, "jaxpr"):
                    sub_jaxprs = [sub.jaxpr]
                elif isinstance(sub, (list, tuple)):
                    sub_jaxprs = [s.jaxpr for s in sub if hasattr(s, "jaxpr")]
                for sj in sub_jaxprs:
                    inner = _count_jaxpr(sj)
                    for k in c:
                        c[k] += inner[k]
        else:
            # unknown primitive: assume element-wise cost so the model
            # fails toward OVERstating work (never inflates utilization)
            c["vpu_ops"] += out_sz
    return c


def _counting_rng(seed, k):
    """The chunk's own hash stream, tallying draw elements."""
    from physicl_tpu.ops import fused as F

    class _CountingRng(F._Rng):
        draw_elems = 0

        def bits(self, shape, salt=None):
            _CountingRng.draw_elems += int(np.prod(shape))
            return super().bits(shape, salt)

    return _CountingRng(seed, k)


def iteration_cost(plan, capacity: int) -> dict:
    """Modeled per-iteration cost of one fused chunk iteration over the
    WHOLE population: ALU ops, transcendental count, PRNG draw elements,
    and the per-chunk device-memory byte traffic."""
    from physicl_tpu.ops import fused as F

    rows = capacity // F._LANE
    nf = F._NF + len(plan.extras)
    rng = _counting_rng(jnp.int32(0), jnp.int32(0))
    gidx = jnp.zeros((rows, F._LANE), jnp.int32)
    emit_ref = jnp.zeros((max(1, sum(1 for op in plan.ops
                                     if op.kind == "emit")),
                          plan.chunk), jnp.int32)

    def one(fields_flat, k, dt, t0, t1, t2, t3):
        fields = list(fields_flat)
        fields, row, row_f, stream = F._emit_iteration(
            plan, k, dt, fields, rng, emit_ref, gidx, t=(t0, t1, t2, t3))
        return tuple(fields), row, row_f, tuple(stream or ())

    fields0 = tuple(jnp.zeros((rows, F._LANE), jnp.float32)
                    for _ in range(nf))
    jaxpr = jax.make_jaxpr(one)(
        fields0, jnp.int32(0), jnp.float32(1e-3), jnp.float32(0.0),
        jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0))
    counts = _count_jaxpr(jaxpr.jaxpr)
    counts["prng_draw_elems"] = type(rng).draw_elems
    n = capacity
    counts["vpu_ops_per_particle"] = counts["vpu_ops"] / n

    # HBM bytes per CHUNK (state crosses once each way; records + streams)
    state_bytes = 2 * nf * capacity * 4
    rec_bytes = 2 * plan.chunk * F._MAX_REC_COLS * 4 * 2  # int + float rows
    s_every = max(1, int(plan.stream_every))
    stream_itemsize = 2 if plan.stream_dtype == "bfloat16" else 4
    stream_bytes = ((-(-plan.chunk // s_every)) * plan.n_stream
                    * capacity * stream_itemsize if plan.n_stream else 0)
    counts["hbm_bytes_per_chunk"] = state_bytes + rec_bytes + stream_bytes
    counts["chunk"] = plan.chunk
    counts["capacity"] = capacity
    return counts


def device_peaks(device=None) -> Optional[tuple]:
    """(vpu_f32_ops/s, hbm_bytes/s) for the attached chip, or None."""
    if device is None:
        try:
            device = jax.devices()[0]
        except Exception:
            return None
    kind = getattr(device, "device_kind", "")
    for key, peaks in PEAKS.items():
        if kind.startswith(key):
            return peaks
    return None


def roofline_report(plan, capacity: int, photon_steps_per_s: float,
                    device=None) -> dict:
    """Position a measured rate against the chip roofs.

    Returns ``vpu_util`` / ``hbm_util`` in [0, ~1] (None when the device
    kind has no table entry) plus the model terms, for bench.py's JSON
    and RESULTS.md."""
    cost = iteration_cost(plan, capacity)
    iters_per_s = photon_steps_per_s / capacity
    vpu_ops_per_s = cost["vpu_ops"] * iters_per_s
    hbm_bytes_per_s = (cost["hbm_bytes_per_chunk"] / cost["chunk"]
                       * iters_per_s)
    peaks = device_peaks(device)
    out = {
        "flops_per_photon_step": round(cost["vpu_ops_per_particle"], 2),
        "prng_draws_per_photon_step": round(
            cost["prng_draw_elems"] / capacity, 2),
        "model_vpu_ops_per_s": vpu_ops_per_s,
        "model_hbm_bytes_per_s": hbm_bytes_per_s,
    }
    if cost["uncounted_loop_bodies"]:
        # a lax while/scan inside the iteration body: its trip count is
        # invisible to the jaxpr walk, so the op count is a lower bound —
        # refuse to publish a utilization built on it
        out["vpu_util"] = None
        out["hbm_util"] = None
        out["uncounted_loop_bodies"] = int(cost["uncounted_loop_bodies"])
    elif peaks is not None:
        vpu_peak, hbm_peak = peaks
        out["vpu_util"] = round(vpu_ops_per_s / vpu_peak, 4)
        out["hbm_util"] = round(hbm_bytes_per_s / hbm_peak, 4)
        out["vpu_peak_ops_per_s"] = vpu_peak
        out["hbm_peak_bytes_per_s"] = hbm_peak
    else:
        out["vpu_util"] = None
        out["hbm_util"] = None
    return out
