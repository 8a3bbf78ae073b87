"""Generate the API reference from docstrings (no external deps).

The reference ships Sphinx-built HTML API docs
(/root/reference/docs/_build/phys.html); this repo's counterpart is
generated markdown under ``docs/api_reference/`` — one page per public
module, every public class/function with its signature and full docstring,
plus an index. Built in CI (see .github/workflows/ci.yml) and locally via
``make apidocs``; the pages are committed so the reference is browsable
without running anything.

Usage: python scripts/gen_api_docs.py [--check]
  --check: exit nonzero if the committed pages are stale (CI mode).
"""

from __future__ import annotations

import importlib
import inspect
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

OUT_DIR = os.path.join(ROOT, "docs", "api_reference")

MODULES = [
    "physicl_tpu",
    "physicl_tpu.units",
    "physicl_tpu.engine",
    "physicl_tpu.state",
    "physicl_tpu.kernels",
    "physicl_tpu.light",
    "physicl_tpu.polarization",
    "physicl_tpu.newton",
    "physicl_tpu.functional",
    "physicl_tpu.population",
    "physicl_tpu.ops.fused",
    "physicl_tpu.ops.families",
    "physicl_tpu.ops.pipeline",
    "physicl_tpu.ops.compaction",
    "physicl_tpu.parallel.sharding",
    "physicl_tpu.parallel.distributed",
    "physicl_tpu.utils.io",
    "physicl_tpu.utils.cache",
    "physicl_tpu.utils.checkpoint",
    "physicl_tpu.utils.profiling",
    "physicl_tpu.utils.roofline",
]


def _signature(obj) -> str:
    try:
        sig = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    # default-value reprs may embed memory addresses; docs must be stable
    return re.sub(r" at 0x[0-9a-fA-F]+", "", sig)


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d.strip() if d else "*(undocumented)*"


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def _own_members(mod):
    """(classes, functions) defined in (or re-exported by) this module."""
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if _is_public(n)]
    classes, functions = [], []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None:
            continue
        if inspect.isclass(obj):
            classes.append((n, obj))
        elif inspect.isfunction(obj) or inspect.isbuiltin(obj):
            functions.append((n, obj))
    return classes, functions


def _class_section(name: str, cls) -> str:
    out = [f"### class `{name}{_signature(cls)}`", "", _doc(cls), ""]
    for mname, m in sorted(vars(cls).items()):
        if not _is_public(mname):
            continue
        if isinstance(m, (staticmethod, classmethod)):
            m = m.__func__
        if inspect.isfunction(m):
            out += [f"#### `{name}.{mname}{_signature(m)}`", "", _doc(m), ""]
        elif isinstance(m, property):
            out += [f"#### property `{name}.{mname}`", "", _doc(m), ""]
    return "\n".join(out)


def render_module(modname: str) -> str:
    mod = importlib.import_module(modname)
    classes, functions = _own_members(mod)
    out = [f"# `{modname}`", "", _doc(mod), ""]
    for n, f in functions:
        out += [f"### `{n}{_signature(f)}`", "", _doc(f), ""]
    for n, c in classes:
        out.append(_class_section(n, c))
    return "\n".join(out).rstrip() + "\n"


def main() -> int:
    check = "--check" in sys.argv
    pages = {}
    index = ["# physicl_tpu API reference", "",
             "Generated from docstrings by `scripts/gen_api_docs.py` "
             "(`make apidocs`). Do not edit by hand.", ""]
    for modname in MODULES:
        fname = modname.replace(".", "_") + ".md"
        pages[fname] = render_module(modname)
        mod = importlib.import_module(modname)
        first = (inspect.getdoc(mod) or "").strip().split("\n")[0]
        index.append(f"- [`{modname}`]({fname}) — {first}")
    pages["index.md"] = "\n".join(index) + "\n"

    if check:
        stale = []
        for fname, content in pages.items():
            path = os.path.join(OUT_DIR, fname)
            on_disk = open(path).read() if os.path.exists(path) else None
            if on_disk != content:
                stale.append(fname)
        if stale:
            print(f"STALE API docs ({len(stale)} pages): {stale[:5]} — "
                  "run `make apidocs` and commit", file=sys.stderr)
            return 1
        print(f"API docs up to date ({len(pages)} pages)")
        return 0

    os.makedirs(OUT_DIR, exist_ok=True)
    for fname, content in pages.items():
        with open(os.path.join(OUT_DIR, fname), "w") as f:
            f.write(content)
    total = sum(len(p) for p in pages.values())
    print(f"wrote {len(pages)} pages ({total} bytes) to {OUT_DIR}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
