#!/usr/bin/env python
"""Generate docs/api_torch.md, the API reference of the PyTorch / CUDA port
(``gym_anm_tpu_torch``), by introspection on the CPU.

One markdown section per public module of the package (every module whose
name has no leading underscore, in package order), listing its public
classes (with their public methods and properties) and functions, each with
its signature and the first paragraph of its docstring.  It imports only
the port (and, for its Gymnasium adapters, Gymnasium); run from the repo
root:

    python scripts/gen_api_docs_torch.py [--check]

``--check`` writes nothing and exits 1 if docs/api_torch.md is out of date.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import os
import pkgutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PACKAGE = "gym_anm_tpu_torch"
OUT = os.path.join(ROOT, "docs", "api_torch.md")


def modules():
    """The package's public modules, the package first, then depth-first."""
    pkg = importlib.import_module(PACKAGE)
    names = [PACKAGE]
    for info in pkgutil.walk_packages(pkg.__path__, PACKAGE + "."):
        if not any(part.startswith("_") for part in info.name.split(".")):
            names.append(info.name)
    return sorted(names, key=lambda n: n.split("."))


def summary(obj) -> str:
    """The first paragraph of the docstring, on one line."""
    doc = inspect.getdoc(obj) or ""
    return " ".join(line.strip() for line in doc.split("\n\n")[0].splitlines())


def sig_of(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def public_members(mod):
    """(classes, functions) that the module defines, or lists in ``__all__``."""
    names = getattr(mod, "__all__", None)
    exported = names is not None
    if not exported:
        names = [n for n in vars(mod) if not n.startswith("_")]
    classes, funcs = [], []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or (not exported and getattr(obj, "__module__", None) != mod.__name__):
            continue
        if inspect.isclass(obj):
            classes.append((n, obj))
        elif inspect.isfunction(obj):
            funcs.append((n, obj))
    return classes, funcs


def class_section(name, cls):
    out = ["### class `%s%s`" % (name, sig_of(cls)), ""]
    if summary(cls):
        out += [summary(cls), ""]
    rows = []
    for mname, m in inspect.getmembers(cls, inspect.isfunction):
        if not mname.startswith("_") and m.__qualname__.split(".")[0] == cls.__name__:
            rows.append("- `%s%s` — %s" % (mname, sig_of(m), summary(m) or "no docstring"))
    for pname, p in inspect.getmembers(cls, lambda o: isinstance(o, property)):
        if not pname.startswith("_") and p.fget is not None and p.fget.__qualname__.split(".")[0] == cls.__name__:
            rows.append("- `%s` (property) — %s" % (pname, summary(p.fget) or "no docstring"))
    return out + rows + ([""] if rows else [])


def render() -> str:
    lines = [
        "# API reference: the PyTorch / CUDA port",
        "",
        "Generated from the docstrings of `%s` by `scripts/gen_api_docs_torch.py`" % PACKAGE,
        "(re-run it when a public signature changes). Each entry shows the public",
        "signature and the first paragraph of the docstring; the source holds the",
        "rest. The JAX package's reference is `docs/api.md`.",
        "",
    ]
    for name in modules():
        mod = importlib.import_module(name)
        lines += ["## `%s`" % name, ""]
        if summary(mod):
            lines += [summary(mod), ""]
        classes, funcs = public_members(mod)
        for n, c in classes:
            lines += class_section(n, c)
        for n, f in funcs:
            lines += ["### `%s%s`" % (n, sig_of(f)), ""] + ([summary(f), ""] if summary(f) else [])
    return "\n".join(lines).rstrip() + "\n"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true", help="exit 1 if docs/api_torch.md is out of date")
    args = ap.parse_args()
    text = render()
    if args.check:
        current = open(OUT).read() if os.path.exists(OUT) else ""
        print("%s is %s" % (os.path.relpath(OUT, ROOT), "up to date" if current == text else "out of date"))
        return 0 if current == text else 1
    with open(OUT, "w") as fh:
        fh.write(text)
    print("wrote %s (%d lines)" % (os.path.relpath(OUT, ROOT), text.count("\n")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
