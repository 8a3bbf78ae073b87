"""Code-units system: ``Measurement`` — an ``np.ndarray`` carrying SI-derived units.

Capability parity with the reference units layer (``/root/reference/physicl/__init__.py:18-291``):

* unit-string grammar ``"kg**1 m**1 s**-2"`` (also ``^`` as the power operator),
* recursive reduction of derived units (N, J, eV, au, min, ...) to the 7 SI base
  dimensions T/L/M/I/Th/N/J,
* a process-global *code scale* per base unit (``set_code_scale``/``reset_code_scale``)
  applied at construction, so all stored values live in *code units*,
* full ufunc algebra: add/sub coerce to the first operand's units; mul/div combine
  unit dicts and scales; power/square/sqrt scale unit exponents; every other ufunc
  (including comparisons) adopts the first operand's units.

Design differences from the reference (deliberate, documented):

* Fractional unit powers parse correctly (the reference regex at
  ``physicl/__init__.py:95`` silently truncates ``au**0.5`` to power 0, which makes
  its own ``test_units_6`` sqrt assertion fail — verified by running the reference).
* ``Ohm`` reduces to V·A**-1 (physically correct), not the reference's V·A.
* ``__array_finalize__`` propagates unit metadata on views/slices instead of the
  reference's broken ``self.scale(...)`` call (quirk list in SURVEY.md).

In the engine, units never reach the compiled hot loop: ``Measurement`` stores
values already converted to code units, and the engine extracts the raw stored
array (``raw_code_value``) at the trace boundary, so unit bookkeeping is
host-construction-time only and compiles away entirely.
"""

from __future__ import annotations

import copy
import numbers
import re

import numpy as np

__all__ = [
    "Measurement",
    "MeasurementError",
    "set_code_scale",
    "reset_code_scale",
    "raw_code_value",
]


class MeasurementError(ArithmeticError):
    """Raised on irreconcilable unit usage (kept for API parity)."""


# The 7 SI base dimensions, keyed by the symbols the reference uses
# (physicl/__init__.py:25-32): s->T, m->L, kg->M, A->I, K->Th, mol->N, cd->J.
_BASE_DIM = {
    "s": "T",
    "m": "L",
    "kg": "M",
    "A": "I",
    "K": "Th",
    "mol": "N",
    "cd": "J",
}

# Derived units reduced one level; reduction recurses until base symbols remain.
# Mirrors the capability of the reference table (physicl/__init__.py:34-93).
_DERIVED = {
    "N": (1.0, (("kg", 1), ("m", 1), ("s", -2))),
    "Pa": (1.0, (("kg", 1), ("m", -1), ("s", -2))),
    "J": (1.0, (("N", 1), ("m", 1))),
    "W": (1.0, (("kg", 1), ("m", 2), ("s", -3))),
    "C": (1.0, (("A", 1), ("s", 1))),
    "V": (1.0, (("W", 1), ("A", -1))),
    "F": (1.0, (("C", 1), ("V", -1))),
    "Ohm": (1.0, (("V", 1), ("A", -1))),
    "Wb": (1.0, (("V", 1), ("s", 1))),
    "T": (1.0, (("Wb", 1), ("m", -2))),
    "H": (1.0, (("Wb", 1), ("A", -1))),
    "lm": (1.0, (("cd", 1),)),
    "Bq": (1.0, (("s", -1),)),
    "Gy": (1.0, (("m", 2), ("s", -2))),
    "Sv": (1.0, (("m", 2), ("s", -2))),
    "kat": (1.0, (("mol", 1), ("s", -1))),
    # Non-SI units accepted for use with SI.
    "min": (60.0, (("s", 1),)),
    "h": (3600.0, (("s", 1),)),
    "d": (86400.0, (("s", 1),)),
    "au": (149597870700.0, (("m", 1),)),
    "ha": (1e4, (("m", 2),)),
    "L": (1e-3, (("m", 3),)),
    "t": (1e3, (("kg", 1),)),
    "Da": (1.6605390666050e-27, (("kg", 1),)),
    "eV": (1.602176634e-19, (("J", 1),)),
}

# Accepts integer and fractional powers, with ** or ^ (reference grammar plus
# fractional powers; see module docstring).
_UNIT_RE = re.compile(r"(?P<u>[a-zA-Z]+)\s*(?:\*\*|\^)\s*(?P<p>-?\d+(?:\.\d+)?)")

# Process-global code scale: base SI symbol -> multiplicative factor applied per
# dimension power at construction (reference: Measurement.code_scale,
# physicl/__init__.py:25-32,125-130).
_code_scale = {sym: 1.0 for sym in _BASE_DIM}


def set_code_scale(base_unit: str, new_scale: float) -> None:
    """Set the global code-unit scale for one SI base unit symbol (e.g. ``"m"``)."""
    if base_unit not in _code_scale:
        raise MeasurementError(f"{base_unit!r} is not an SI base unit symbol")
    _code_scale[base_unit] = float(new_scale)


def reset_code_scale(base_unit: str) -> None:
    """Reset the code-unit scale of one SI base unit symbol back to 1."""
    set_code_scale(base_unit, 1.0)


def _reduce_to_base(unit: str, power) -> tuple:
    """Reduce ``unit**power`` to (si_factor, {base_symbol: power})."""
    if unit in _BASE_DIM:
        return 1.0, {unit: power}
    if unit not in _DERIVED:
        raise MeasurementError(f"Unknown unit symbol {unit!r}")
    factor, parts = _DERIVED[unit]
    total = float(factor) ** power
    dims: dict = {}
    for sub, p in parts:
        f, d = _reduce_to_base(sub, p * power)
        total *= f
        for k, v in d.items():
            dims[k] = dims.get(k, 0) + v
    return total, dims


def _parse_units(units: str) -> tuple:
    """Parse a unit string -> (scale, dims, original_units).

    ``scale`` includes both derived-unit SI factors and the global code scale;
    ``dims`` maps base-dimension names (T/L/M/...) to powers; ``original_units``
    maps the symbols as written to powers.
    """
    scale = 1.0
    dims: dict = {}
    original: dict = {}
    for m in _UNIT_RE.finditer(units or ""):
        sym = m.group("u")
        p_raw = float(m.group("p"))
        power = int(p_raw) if p_raw == int(p_raw) else p_raw
        factor, base = _reduce_to_base(sym, power)
        scale *= factor
        original[sym] = original.get(sym, 0) + power
        for base_sym, bp in base.items():
            scale *= _code_scale[base_sym] ** bp
            dim = _BASE_DIM[base_sym]
            dims[dim] = dims.get(dim, 0) + bp
    return scale, dims, original


def _as_si(x):
    """Return the SI-unit value of x (Measurement -> unscaled; else unchanged)."""
    if isinstance(x, Measurement):
        return x.__unscaled__()
    return x


def raw_code_value(x):
    """Raw stored (code-unit) ndarray of a Measurement, or ``np.asarray(x)``.

    This is the trace-boundary extractor: the engine consumes raw code-unit
    arrays so unit metadata never enters jit-compiled code.
    """
    if isinstance(x, Measurement):
        return np.asarray(x.view(np.ndarray))
    return np.asarray(x)


_MULDIV = {"multiply": 1, "divide": -1, "true_divide": -1, "floor_divide": -1}


class Measurement(np.ndarray):
    """``np.ndarray`` subclass storing values in code units with unit metadata.

    ``Measurement(raw, "kg**1 m**1 s**-2")`` converts ``raw`` (given in the stated
    units) into code units at construction. ``value()`` converts back.
    """

    # -- construction ---------------------------------------------------------

    def __new__(cls, raw_value, units: str = ""):
        if isinstance(raw_value, (list, tuple)):
            raw_value = [
                _as_si(x) if isinstance(x, Measurement) else x for x in raw_value
            ]
        arr = np.asarray(raw_value, dtype=np.double).view(cls)
        scale, dims, original = _parse_units(units)
        if scale != 1.0:
            arr = np.asarray(arr.view(np.ndarray) * scale).view(cls)
        arr.scale = np.double(scale)
        arr.units = dims
        arr.original_units = original
        return arr

    @staticmethod
    def _wrap(raw, scale, units, original_units):
        res = np.asarray(raw).view(Measurement)
        res.scale = np.double(scale)
        res.units = dict(units)
        res.original_units = dict(original_units)
        return res

    @staticmethod
    def from_code(raw, units: str = "") -> "Measurement":
        """Wrap a value that is ALREADY in code units (device readback path).

        ``Measurement(raw, units)`` treats ``raw`` as being in the stated
        units and multiplies the global code scale in; device state is already
        code-scaled, so host readbacks must use this constructor instead or
        every value comes back wrong by the scale factor under a non-unit
        ``set_code_scale``.
        """
        scale, dims, original = _parse_units(units)
        return Measurement._wrap(raw, scale, dims, original)

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.scale = getattr(obj, "scale", np.double(1))
        self.units = dict(getattr(obj, "units", {}))
        self.original_units = dict(getattr(obj, "original_units", {}))

    # -- code-scale management (API parity) -----------------------------------

    set_code_scale = staticmethod(set_code_scale)
    reset_code_scale = staticmethod(reset_code_scale)

    # -- accessors -------------------------------------------------------------

    def __unscaled__(self):
        return np.asarray(self.view(np.ndarray) / self.scale)

    def value(self):
        """The value in the units this Measurement was constructed with."""
        return self.__unscaled__()

    def unitstr(self) -> str:
        try:
            return " ".join(f"{k}**{v}" for k, v in self.original_units.items())
        except AttributeError:
            return ""

    def fstr(self) -> str:
        return str(float(self))

    def valstr(self) -> str:
        return str(self.value())

    def __repr__(self):
        return f"{self.value()} {self.unitstr()}"

    def __deepcopy__(self, memo):
        return Measurement._wrap(
            np.copy(self.view(np.ndarray)),
            self.scale,
            copy.deepcopy(self.units, memo),
            copy.deepcopy(self.original_units, memo),
        )

    # -- unit algebra -----------------------------------------------------------

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        # Coerce plain operands using the first Measurement operand's unit string
        # (reference semantics: physicl/__init__.py:213-230).
        first = next(
            (x for x in inputs if isinstance(x, Measurement) and hasattr(x, "units")),
            None,
        )
        conv = []
        for item in inputs:
            if isinstance(item, Measurement) and hasattr(item, "units"):
                conv.append(item)
            elif first is not None:
                conv.append(Measurement(item, first.unitstr()))
            else:
                conv.append(Measurement(item, ""))
        raw_inputs = [np.asarray(x.view(np.ndarray)) for x in conv]
        out = kwargs.pop("out", None)
        if out is not None:
            kwargs["out"] = tuple(
                o.view(np.ndarray) if isinstance(o, np.ndarray) else o for o in out
            )

        name = ufunc.__name__
        raw = getattr(ufunc, method)(*raw_inputs, **kwargs)

        if name in ("add", "subtract"):
            res = Measurement._wrap(
                raw, conv[0].scale, conv[0].units, conv[0].original_units
            )
        elif name in _MULDIV:
            sign = _MULDIV[name]
            units = dict(conv[0].units)
            for u, p in conv[1].units.items():
                units[u] = units.get(u, 0) + p * sign
            original = dict(conv[0].original_units)
            for u, p in conv[1].original_units.items():
                original[u] = original.get(u, 0) + p * sign
            res = Measurement._wrap(
                raw, conv[0].scale * conv[1].scale ** sign, units, original
            )
        elif name in ("power", "square", "sqrt"):
            if name == "power":
                power = raw_inputs[1]
            elif name == "square":
                power = 2
            else:
                power = 0.5
            units = {u: p * power for u, p in conv[0].units.items()}
            original = {u: p * power for u, p in conv[0].original_units.items()}
            res = Measurement._wrap(raw, conv[0].scale ** power, units, original)
        else:
            res = Measurement._wrap(
                raw, conv[0].scale, conv[0].units, conv[0].original_units
            )

        if out is not None:
            for o in out:
                if isinstance(o, np.ndarray):
                    ov = o.view(Measurement)
                    ov.units = res.units
                    ov.scale = res.scale
                    ov.original_units = res.original_units
        return res

    def rescale(self):
        """Declared-but-unimplemented in the reference
        (physicl/__init__.py:289-291); kept for API parity."""

